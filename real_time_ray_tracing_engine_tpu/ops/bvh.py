"""Flat BVH: host-side SAH build + vectorized stackful traversal.

The reference builds a pointer BVH with SAH (16 sampled splits/axis, leaf <= 4,
traverse/intersect costs 1.0/2.0, BVHNode.cpp:215-254, BVHNode.hpp:167-170)
and flattens it into a depth-first FlatNode array traversed iteratively with a
64-entry stack and near-child-first ordering by ray sign (BVHNode.cpp:385-446).
That flattened form — not the CUDA side's device recursion (BVHNode.cu:9-31) —
is the model here: the build happens on host in numpy at scene-compile time,
and traversal is a `lax.while_loop` over a per-ray-lane stack so a whole ray
batch walks the tree in lockstep with masking.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.vecmath import dot, BIG, T_MIN
from ..scene.flat import FlatScene
from .intersect import HitRecord, shade_prim

MAX_LEAF = 4          # reference BVHNode.hpp:167
SAH_SAMPLES = 16      # reference BVHNode.hpp:168
COST_TRAVERSE = 1.0   # reference BVHNode.hpp:169
COST_INTERSECT = 2.0  # reference BVHNode.hpp:170
STACK_DEPTH = 64      # reference BVHNode.cpp:398
BBOX_PAD = 1e-4       # reference AABB.cpp:167-176 pad_to_minimums


def _prim_bboxes(scene: FlatScene):
    """World-space AABBs for the *active* unified prims (numpy, host)."""
    sc = np.asarray(scene.sph_center, np.float64)
    sd = np.asarray(scene.sph_cdelta, np.float64)
    sr = np.asarray(scene.sph_radius, np.float64)[:, None]
    s_min = np.minimum(sc - sr, sc + sd - sr)
    s_max = np.maximum(sc + sr, sc + sd + sr)

    qc = np.asarray(scene.quad_corner, np.float64)
    qu = np.asarray(scene.quad_u, np.float64)
    qv = np.asarray(scene.quad_v, np.float64)
    corners = np.stack([qc, qc + qu, qc + qv, qc + qu + qv], axis=1)
    q_min = corners.min(axis=1)
    q_max = corners.max(axis=1)

    bb_min = np.concatenate([s_min, q_min], axis=0)
    bb_max = np.concatenate([s_max, q_max], axis=0)
    # pad thin boxes (axis-aligned quads have zero extent on one axis)
    thin = (bb_max - bb_min) < BBOX_PAD
    bb_min = np.where(thin, bb_min - BBOX_PAD / 2, bb_min)
    bb_max = np.where(thin, bb_max + BBOX_PAD / 2, bb_max)

    active = np.concatenate([np.asarray(scene.sph_active),
                             np.asarray(scene.quad_active)])
    return bb_min, bb_max, active


def _sah_split(ids, bb_min, bb_max, centroids):
    """Best (axis, threshold) by sampled SAH, or None (BVHNode.cpp:168-254)."""
    c = centroids[ids]
    c_lo, c_hi = c.min(axis=0), c.max(axis=0)
    span = bb_max[ids].max(axis=0) - bb_min[ids].min(axis=0)
    area = 2.0 * (span[0] * span[1] + span[1] * span[2] + span[2] * span[0])
    if area <= 0.0:
        return None
    best = (None, np.inf)
    n = len(ids)
    for axis in range(3):
        if c_hi[axis] - c_lo[axis] < 1e-12:
            continue
        for k in range(1, SAH_SAMPLES + 1):
            thr = c_lo[axis] + (c_hi[axis] - c_lo[axis]) * k / (SAH_SAMPLES + 1)
            left = c[:, axis] < thr
            nl = int(left.sum())
            if nl == 0 or nl == n:
                continue
            l_ids, r_ids = ids[left], ids[~left]

            def _area(sel):
                lo = bb_min[sel].min(axis=0)
                hi = bb_max[sel].max(axis=0)
                e = hi - lo
                return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

            cost = (COST_TRAVERSE
                    + _area(l_ids) / area * nl * COST_INTERSECT
                    + _area(r_ids) / area * (n - nl) * COST_INTERSECT)
            if cost < best[1]:
                best = ((axis, thr), cost)
    if best[0] is not None and best[1] < n * COST_INTERSECT:
        return best[0]
    return None


def _build_native(bb_min, bb_max, active):
    """SAH build via the C++ library (native/bvh_builder.cpp); None if the
    shared library is not built."""
    from ..native import load_bvh_lib
    import ctypes
    lib = load_bvh_lib()
    if lib is None:
        return None
    n = bb_min.shape[0]
    max_nodes = max(2 * n + 1, 8)
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros(max_nodes, np.int32)
    right = np.zeros(max_nodes, np.int32)
    axis = np.zeros(max_nodes, np.int32)
    leaf = np.zeros(max_nodes, np.uint8)
    prims = np.zeros(max(n, 1), np.int32)
    n_prims_out = ctypes.c_int32(0)
    n_nodes = lib.rtx_build_bvh(
        np.ascontiguousarray(bb_min, np.float32),
        np.ascontiguousarray(bb_max, np.float32),
        np.ascontiguousarray(active, np.uint8), n,
        node_min, node_max, left, right, axis, leaf, prims,
        ctypes.byref(n_prims_out), max_nodes)
    if n_nodes < 0:
        return None
    k = int(n_nodes)
    order = prims[:max(int(n_prims_out.value), 1)]
    return (node_min[:k], node_max[:k], left[:k], right[:k], axis[:k],
            leaf[:k].astype(bool), order)


def _skip_links(left, right, leaf):
    """Stackless DFS skip links for per-lane traversal (hit = left child for
    inner nodes; miss = next sibling up the continuation chain; B = done).
    The classic GPU "escape pointer" layout: each ray walks its own chain
    without a stack."""
    n = left.shape[0]
    hit = np.zeros(n, np.int32)
    miss = np.zeros(n, np.int32)
    stack = [(0, n)]
    while stack:
        i, cont = stack.pop()
        miss[i] = cont
        if leaf[i]:
            hit[i] = cont
        else:
            hit[i] = left[i]
            stack.append((left[i], right[i]))   # left's continuation = right
            stack.append((right[i], cont))
    return hit, miss


def _segregate_leaves(n_sph, left, right, leaf, prims):
    """Reorder each leaf's prim run spheres-first (in place) and return the
    per-node sphere count (`bvh_leaf_sph`), so a leaf's prims split into a
    sphere run and a quad run."""
    leaf_sph = np.zeros(left.shape[0], np.int32)
    for i in np.nonzero(leaf)[0]:
        off, cnt = int(left[i]), int(right[i])
        run = prims[off:off + cnt]
        sph = run[run < n_sph]
        prims[off:off + cnt] = np.concatenate([sph, run[run >= n_sph]])
        leaf_sph[i] = len(sph)
    return leaf_sph


def build_bvh(scene: FlatScene) -> FlatScene:
    """Build the flat BVH over active prims; returns scene with use_bvh=True.

    Prefers the native C++ builder; falls back to the numpy implementation
    below (same SAH constants and semantics)."""
    bb_min, bb_max, active = _prim_bboxes(scene)
    n_sph = scene.sph_center.shape[0]

    nat = _build_native(bb_min.astype(np.float32), bb_max.astype(np.float32),
                        active)
    if nat is not None:
        n_min, n_max, left, right, axis, leaf, prims = nat
        prims = np.ascontiguousarray(prims)
        leaf_sph = _segregate_leaves(n_sph, left, right, leaf, prims)
        hit, miss = _skip_links(left, right, leaf)
        return scene.replace(
            bvh_bbox_min=jnp.asarray(n_min), bvh_bbox_max=jnp.asarray(n_max),
            bvh_left=jnp.asarray(left), bvh_right=jnp.asarray(right),
            bvh_axis=jnp.asarray(axis), bvh_leaf=jnp.asarray(leaf),
            bvh_prims=jnp.asarray(prims),
            bvh_leaf_sph=jnp.asarray(leaf_sph),
            bvh_hit=jnp.asarray(hit), bvh_miss=jnp.asarray(miss),
            use_bvh=True)

    centroids = 0.5 * (bb_min + bb_max)
    all_ids = np.nonzero(active)[0].astype(np.int64)

    nodes = []   # rows [bmin(3), bmax(3), left, right, axis, leaf]
    order = []

    def rec(ids) -> int:
        node_id = len(nodes)
        nodes.append(None)
        lo = bb_min[ids].min(axis=0) if len(ids) else np.zeros(3)
        hi = bb_max[ids].max(axis=0) if len(ids) else np.zeros(3)
        if len(ids) <= MAX_LEAF:
            off = len(order)
            order.extend(ids.tolist())
            nodes[node_id] = (lo, hi, off, len(ids), 0, True)
            return node_id
        split = _sah_split(ids, bb_min, bb_max, centroids)
        if split is None:
            # spatial-median fallback on the longest axis (BVHNode.cpp:60-77)
            axis = int(np.argmax(hi - lo))
            srt = ids[np.argsort(centroids[ids, axis], kind="stable")]
            l_ids, r_ids = srt[: len(srt) // 2], srt[len(srt) // 2:]
        else:
            axis, thr = split
            left = centroids[ids, axis] < thr
            l_ids, r_ids = ids[left], ids[~left]
        li = rec(l_ids)
        ri = rec(r_ids)
        nodes[node_id] = (lo, hi, li, ri, axis, False)
        return node_id

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(all_ids)
    finally:
        sys.setrecursionlimit(old)

    n = len(nodes)
    n_min = np.stack([x[0] for x in nodes]).astype(np.float32)
    n_max = np.stack([x[1] for x in nodes]).astype(np.float32)
    left = np.array([x[2] for x in nodes], np.int32)
    right = np.array([x[3] for x in nodes], np.int32)
    axis = np.array([x[4] for x in nodes], np.int32)
    leaf = np.array([x[5] for x in nodes], bool)
    prims = np.array(order if order else [0], np.int32)
    leaf_sph = _segregate_leaves(n_sph, left, right, leaf, prims)
    hit, miss = _skip_links(left, right, leaf)

    return scene.replace(
        bvh_bbox_min=jnp.asarray(n_min), bvh_bbox_max=jnp.asarray(n_max),
        bvh_left=jnp.asarray(left), bvh_right=jnp.asarray(right),
        bvh_axis=jnp.asarray(axis), bvh_leaf=jnp.asarray(leaf),
        bvh_prims=jnp.asarray(prims),
        bvh_leaf_sph=jnp.asarray(leaf_sph),
        bvh_hit=jnp.asarray(hit), bvh_miss=jnp.asarray(miss),
        use_bvh=True)


# ------------------------------------------------------------- traversal
def _prim_t(scene: FlatScene, prim, org, dr, tm, t_max):
    """t for a single gathered prim per ray (N,); BIG when missed."""
    S = scene.sph_center.shape[0]
    is_sph = prim < S
    si = jnp.clip(prim, 0, S - 1)
    qi = jnp.clip(prim - S, 0, scene.quad_corner.shape[0] - 1)

    # sphere (gathered, per-ray scalar form of intersect.sphere_ts)
    c_t = scene.sph_center[si] + tm[:, None] * scene.sph_cdelta[si]
    oc = c_t - org
    a = dot(dr, dr)
    h = dot(dr, oc)
    c = dot(oc, oc) - scene.sph_radius[si] ** 2
    disc = h * h - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    r0 = (h - sq) / a
    r1 = (h + sq) / a
    in0 = (r0 > T_MIN) & (r0 < t_max)
    in1 = (r1 > T_MIN) & (r1 < t_max)
    t_s = jnp.where((disc > 0.0) & (in0 | in1), jnp.where(in0, r0, r1), BIG)

    # quad (gathered, per-ray scalar form of intersect.quad_ts)
    nrm = scene.quad_normal[qi]
    denom = dot(dr, nrm)
    par = jnp.abs(denom) < 1e-8
    t_q = (scene.quad_d[qi] - dot(org, nrm)) / jnp.where(par, 1.0, denom)
    p = org + t_q[:, None] * dr
    planar = p - scene.quad_corner[qi]
    w = scene.quad_w[qi]
    alpha = dot(w, jnp.cross(planar, scene.quad_v[qi]))
    beta = dot(w, jnp.cross(scene.quad_u[qi], planar))
    ok_q = (~par & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1)
            & (t_q > T_MIN) & (t_q < t_max))
    t_q = jnp.where(ok_q, t_q, BIG)

    return jnp.where(is_sph, t_s, t_q)


def closest_hit_bvh(scene: FlatScene, org, dr, tm, t_min=T_MIN,
                    t_max=BIG) -> HitRecord:
    """Iterative stack traversal, vectorized over the ray batch
    (model: hit_flattened BVHNode.cpp:385-446).

    The traversal only selects the winning primitive. It runs on values
    without tangents, since reverse mode cannot pass a while_loop; the
    winner's t is then recomputed from the differentiable inputs, as
    closest_hit's min over its t table is."""
    scene_in, org_in, dr_in, tm_in = scene, org, dr, tm
    scene, org, dr, tm = jax.lax.stop_gradient((scene, org, dr, tm))
    n = org.shape[0]
    inv_dr = 1.0 / jnp.where(jnp.abs(dr) < 1e-12,
                             jnp.where(dr < 0, -1e-12, 1e-12), dr)

    stack = jnp.zeros((n, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)          # root pushed
    best_t = jnp.full((n,), t_max)
    best_p = jnp.zeros((n,), jnp.int32)
    found = jnp.zeros((n,), bool)

    def cond(carry):
        return jnp.any(carry[1] > 0)

    def step(carry):
        stack, sp, best_t, best_p, found = carry
        live = sp > 0
        sp_pop = jnp.maximum(sp - 1, 0)
        node = stack[jnp.arange(n), sp_pop]

        # slab test against node bbox (AABB.cpp:62-165)
        lo = scene.bvh_bbox_min[node]
        hi = scene.bvh_bbox_max[node]
        t0 = (lo - org) * inv_dr
        t1 = (hi - org) * inv_dr
        tn = jnp.minimum(t0, t1)
        tf = jnp.maximum(t0, t1)
        t_near = jnp.maximum(jnp.max(tn, axis=-1), t_min)
        t_far = jnp.minimum(jnp.min(tf, axis=-1), best_t)
        bbox_hit = live & (t_near <= t_far)

        leaf = scene.bvh_leaf[node]
        # --- leaf: test up to MAX_LEAF prims
        off = scene.bvh_left[node]
        cnt = scene.bvh_right[node]
        for k in range(MAX_LEAF):
            pk = scene.bvh_prims[jnp.clip(off + k, 0,
                                          scene.bvh_prims.shape[0] - 1)]
            tk = _prim_t(scene, pk, org, dr, tm, best_t)
            take = bbox_hit & leaf & (k < cnt) & (tk < best_t)
            best_t = jnp.where(take, tk, best_t)
            best_p = jnp.where(take, pk, best_p)
            found = found | take

        # --- inner: push children, near child (by ray sign on split axis) last
        axis = scene.bvh_axis[node]
        go_left_first = jnp.take_along_axis(dr, axis[:, None],
                                            axis=1)[:, 0] >= 0.0
        near = jnp.where(go_left_first, scene.bvh_left[node],
                         scene.bvh_right[node])
        far = jnp.where(go_left_first, scene.bvh_right[node],
                        scene.bvh_left[node])
        push = bbox_hit & ~leaf
        # far first so near is popped first
        stack = stack.at[jnp.arange(n), sp_pop].set(
            jnp.where(push, far, stack[jnp.arange(n), sp_pop]))
        sp1 = jnp.where(push, sp_pop + 1, sp_pop)
        idx2 = jnp.minimum(sp1, STACK_DEPTH - 1)
        stack = stack.at[jnp.arange(n), idx2].set(
            jnp.where(push, near, stack[jnp.arange(n), idx2]))
        sp2 = jnp.where(push, sp1 + 1, sp1)

        sp_new = jnp.where(live, sp2, sp)
        return stack, sp_new, best_t, best_p, found

    stack, sp, best_t, best_p, found = jax.lax.while_loop(
        cond, step, (stack, sp, best_t, best_p, found))

    t = _prim_t(scene_in, best_p, org_in, dr_in, tm_in, BIG)
    ts_safe = jnp.where(found, jnp.where(t < BIG * 0.5, t, best_t), 1.0)
    point, normal, front, uu, vv, mat = shade_prim(
        scene_in, best_p, org_in, dr_in, tm_in, ts_safe)
    return HitRecord(hit=found, t=jnp.where(found, ts_safe, BIG), point=point,
                     normal=normal, front_face=front, mat=mat, u=uu, v=vv)
