"""Vectorized ray-primitive intersection.

Batched replacement for the reference's virtual Hittable::hit dispatch
(Sphere.cpp:32-143, Plane.cpp:25-113, HittableList.cpp:26-42,
ConstantMedium.cpp:25-96): every ray in a lane-batch tests every primitive
table row with masked arithmetic (no branches), then a single argmin picks the
closest hit and a gather-based shade phase reconstructs the full hit record
for the winning primitive only.

Shapes: rays are (N, 3) batches; per-primitive results are (N, P).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import pytree
from ..utils.vecmath import dot, cross, normalize, safe_sqrt, T_MIN, BIG
from ..scene.flat import FlatScene


@pytree.dataclass
class HitRecord:
    """Vectorized hit record (reference: HitRecord, Hittable.hpp)."""
    hit: jnp.ndarray          # (N,) bool
    t: jnp.ndarray            # (N,)
    point: jnp.ndarray        # (N, 3)
    normal: jnp.ndarray       # (N, 3) faces against the ray
    front_face: jnp.ndarray   # (N,) bool
    mat: jnp.ndarray          # (N,) int32
    u: jnp.ndarray            # (N,)
    v: jnp.ndarray            # (N,)


# --------------------------------------------------------------- spheres
#
# All (rays x prims) math below is written in COMPONENT form: (N, S) planes
# built from (N, 1) x (1, S) broadcasts, never (N, S, 3) tensors or einsum
# contractions. With the scene tables as traced jit arguments, XLA would
# materialize (N, S, 3) dot_general operands to device memory, and float32
# FMA chains are exact where a contraction may drop to reduced precision
# (see vecmath.edot).
def _sphere_quadratic(center, cdelta, radius, org, dr, tm):
    """h, c, a for the sphere quadratic, all (N, S) / (N, 1) planes."""
    tmn = tm[:, None]
    cx = center[None, :, 0] + tmn * cdelta[None, :, 0]
    cy = center[None, :, 1] + tmn * cdelta[None, :, 1]
    cz = center[None, :, 2] + tmn * cdelta[None, :, 2]
    ocx = cx - org[:, 0:1]
    ocy = cy - org[:, 1:2]
    ocz = cz - org[:, 2:3]
    a = dot(dr, dr)[:, None]
    h = dr[:, 0:1] * ocx + dr[:, 1:2] * ocy + dr[:, 2:3] * ocz
    c = (ocx * ocx + ocy * ocy + ocz * ocz
         - (radius * radius)[None, :])
    return h, c, a


def sphere_ts(center, cdelta, radius, active, org, dr, tm, t_min=T_MIN,
              t_max=BIG):
    """Nearest valid quadratic root per (ray, sphere) (Sphere.cpp:32-143).

    center/cdelta: (S, 3); radius/active: (S,); org/dr: (N, 3); tm: (N,).
    Returns t: (N, S) with BIG where no hit.
    """
    h, c, a = _sphere_quadratic(center, cdelta, radius, org, dr, tm)
    disc = h * h - a * c
    ok = (disc > 0.0) & active[None, :] & (radius > 0.0)[None, :]
    sq = safe_sqrt(disc)
    r0 = (h - sq) / a
    r1 = (h + sq) / a
    in0 = (r0 > t_min) & (r0 < t_max)
    in1 = (r1 > t_min) & (r1 < t_max)
    t = jnp.where(in0, r0, jnp.where(in1, r1, BIG))
    return jnp.where(ok & (in0 | in1), t, BIG)


def sphere_both_ts(center, radius, org, dr, tm, cdelta=None):
    """Both roots over (-inf, inf) — for medium boundary crossings
    (ConstantMedium.cpp:36-43 uses the UNIVERSE interval).
    Returns (t0, t1): each (N, S); BIG where no intersection."""
    if cdelta is None:
        cdelta = jnp.zeros_like(center)
    h, c, a = _sphere_quadratic(center, cdelta, radius, org, dr, tm)
    disc = h * h - a * c
    ok = (disc > 0.0) & (radius > 0.0)[None, :]
    sq = safe_sqrt(disc)
    return (jnp.where(ok, (h - sq) / a, BIG),
            jnp.where(ok, (h + sq) / a, BIG))


def sphere_shade(center, cdelta, radius, org, dr, tm, t):
    """Geometry at parameter t for gathered sphere params (all (N,...))."""
    p = org + t[:, None] * dr
    c_t = center + tm[:, None] * cdelta
    outward = (p - c_t) / jnp.maximum(radius, 1e-12)[:, None]
    front = dot(dr, outward) < 0.0
    n = jnp.where(front[:, None], outward, -outward)
    # spherical UV on the outward normal (Sphere.cpp:136-141). UVs feed only
    # texture lookups (which are spatial in p here), and arccos/arctan2 have
    # unbounded gradients at the poles that would NaN-poison masked lanes —
    # detach them from the autodiff graph.
    ow = jax.lax.stop_gradient(outward)
    theta = jnp.arccos(jnp.clip(-ow[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(-ow[:, 2], ow[:, 0]) + jnp.pi
    return p, n, front, phi / (2.0 * jnp.pi), theta / jnp.pi


# ----------------------------------------------------------------- quads
def quad_ts(corner, u, v, normal, d, w, active, org, dr, t_min=T_MIN,
            t_max=BIG, eps=1e-8):
    """Plane-equation hit + parallelogram inside test (Plane.cpp:25-113).

    corner/u/v/normal/w: (Q, 3); d: (Q,); org/dr: (N, 3).
    Returns t: (N, Q) with BIG where no hit. Component form — see the
    sphere-section comment on why no (N, Q, 3) intermediates.
    """
    nxq, nyq, nzq = normal[None, :, 0], normal[None, :, 1], normal[None, :, 2]
    denom = dr[:, 0:1] * nxq + dr[:, 1:2] * nyq + dr[:, 2:3] * nzq
    parallel = jnp.abs(denom) < eps
    o_dot_n = org[:, 0:1] * nxq + org[:, 1:2] * nyq + org[:, 2:3] * nzq
    t = (d[None, :] - o_dot_n) / jnp.where(parallel, 1.0, denom)
    # planar hit vector components (N, Q)
    plx = org[:, 0:1] + t * dr[:, 0:1] - corner[None, :, 0]
    ply = org[:, 1:2] + t * dr[:, 1:2] - corner[None, :, 1]
    plz = org[:, 2:3] + t * dr[:, 2:3] - corner[None, :, 2]
    vxq, vyq, vzq = v[None, :, 0], v[None, :, 1], v[None, :, 2]
    uxq, uyq, uzq = u[None, :, 0], u[None, :, 1], u[None, :, 2]
    wxq, wyq, wzq = w[None, :, 0], w[None, :, 1], w[None, :, 2]
    # alpha = w . (planar x v); beta = w . (u x planar)
    alpha = (wxq * (ply * vzq - plz * vyq)
             + wyq * (plz * vxq - plx * vzq)
             + wzq * (plx * vyq - ply * vxq))
    beta = (wxq * (uyq * plz - uzq * ply)
            + wyq * (uzq * plx - uxq * plz)
            + wzq * (uxq * ply - uyq * plx))
    inside = ((alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))
    ok = (~parallel) & inside & (t > t_min) & (t < t_max) & active[None, :]
    return jnp.where(ok, t, BIG)


def quad_shade(corner, u, v, normal, w, org, dr, t):
    """Geometry at t for gathered quad params (all (N,...))."""
    p = org + t[:, None] * dr
    planar = p - corner
    alpha = dot(w, cross(planar, v))
    beta = dot(w, cross(u, planar))
    front = dot(dr, normal) < 0.0
    n = jnp.where(front[:, None], normal, -normal)
    return p, n, front, alpha, beta


# ----------------------------------------------------- closest hit (world)
def all_prim_ts(scene: FlatScene, org, dr, tm, t_min=T_MIN, t_max=BIG):
    """(N, S+Q) t table over the unified primitive space (brute force)."""
    ts_s = sphere_ts(scene.sph_center, scene.sph_cdelta, scene.sph_radius,
                     scene.sph_active, org, dr, tm, t_min, t_max)
    ts_q = quad_ts(scene.quad_corner, scene.quad_u, scene.quad_v,
                   scene.quad_normal, scene.quad_d, scene.quad_w,
                   scene.quad_active, org, dr, t_min, t_max)
    return jnp.concatenate([ts_s, ts_q], axis=1)


def shade_prim(scene: FlatScene, prim, org, dr, tm, t):
    """Reconstruct the hit record for winning unified prim ids (N,)."""
    S = scene.sph_center.shape[0]
    is_sph = prim < S
    si = jnp.clip(prim, 0, S - 1)
    qi = jnp.clip(prim - S, 0, scene.quad_corner.shape[0] - 1)

    sp, sn, sf, su, sv = sphere_shade(
        scene.sph_center[si], scene.sph_cdelta[si], scene.sph_radius[si],
        org, dr, tm, t)
    qp, qn, qf, qu, qv = quad_shade(
        scene.quad_corner[qi], scene.quad_u[qi], scene.quad_v[qi],
        scene.quad_normal[qi], scene.quad_w[qi], org, dr, t)

    m = is_sph[:, None]
    point = jnp.where(m, sp, qp)
    normal = jnp.where(m, sn, qn)
    front = jnp.where(is_sph, sf, qf)
    uu = jnp.where(is_sph, su, qu)
    vv = jnp.where(is_sph, sv, qv)
    mat = jnp.where(is_sph, scene.sph_mat[si], scene.quad_mat[qi])
    return point, normal, front, uu, vv, mat


def closest_hit(scene: FlatScene, org, dr, tm, t_min=T_MIN,
                t_max=BIG) -> HitRecord:
    """Brute-force closest hit over all active primitives."""
    ts = all_prim_ts(scene, org, dr, tm, t_min, t_max)
    prim = jnp.argmin(ts, axis=1).astype(jnp.int32)
    t = jnp.min(ts, axis=1)
    hit = t < BIG * 0.5
    ts_safe = jnp.where(hit, t, 1.0)
    point, normal, front, uu, vv, mat = shade_prim(scene, prim, org, dr, tm,
                                                   ts_safe)
    return HitRecord(hit=hit, t=jnp.where(hit, t, BIG), point=point,
                     normal=normal, front_face=front, mat=mat, u=uu, v=vv)


# ------------------------------------------------------- constant mediums
def medium_scatter(scene: FlatScene, org, dr, tm, t_surf, u_med,
                   t_min=T_MIN):
    """Exponential free-flight scattering inside convex medium boundaries
    (reference: ConstantMedium.cpp:25-96 — entry/exit boundary hits over the
    UNIVERSE interval, clamped to [t_min, t_surf], then
    hit_distance = neg_inv_density * log(U)).

    u_med: (N, M) uniforms, one per medium per bounce.
    Returns (t_med (N,), mat (N,), valid (N,)).
    """
    M = scene.med_neg_inv_density.shape[0]
    MS = scene.med_sph_center.shape[1]
    raylen = jnp.sqrt(dot(dr, dr))                        # (N,)

    # boundary crossing ts for every medium: MS spheres (2 roots each) +
    # MQ quads; the medium span is the first two crossings of the union
    # (ConstantMedium.cpp:25-96 double-hit semantics)
    s0, s1 = sphere_both_ts(scene.med_sph_center.reshape(-1, 3),
                            scene.med_sph_radius.reshape(-1),
                            org, dr, tm)                   # (N, M*MS) each
    n = org.shape[0]
    ts_s = jnp.stack([s0, s1], axis=2).reshape(n, M, 2 * MS)
    qc = scene.med_quad_corner.reshape(-1, 3)
    ts_q = quad_ts(qc, scene.med_quad_u.reshape(-1, 3),
                   scene.med_quad_v.reshape(-1, 3),
                   scene.med_quad_normal.reshape(-1, 3),
                   scene.med_quad_d.reshape(-1),
                   scene.med_quad_w.reshape(-1, 3),
                   scene.med_quad_active.reshape(-1),
                   org, dr, t_min=-BIG, t_max=BIG)         # (N, M*MQ)
    ts_q = ts_q.reshape(n, M, -1)
    ts = jnp.concatenate([ts_s, ts_q], axis=2)       # (N, M, 2*MS+MQ)

    entry = jnp.min(ts, axis=2)
    after = jnp.where(ts > entry[..., None] + 1e-4, ts, BIG)
    exit_ = jnp.min(after, axis=2)
    crossed = (entry < BIG * 0.5) & (exit_ < BIG * 0.5)

    t1 = jnp.maximum(entry, t_min)
    t2 = jnp.minimum(exit_, t_surf[:, None])
    span_ok = crossed & (t1 < t2) & scene.med_active[None, :]

    # double-where: t2 is BIG in non-crossing lanes; keep fwd/bwd finite
    t2_safe = jnp.where(span_ok, t2, t1 + 1.0)
    dist_inside = (t2_safe - t1) * raylen[:, None]
    hit_dist = scene.med_neg_inv_density[None, :] * jnp.log(
        jnp.maximum(u_med, 1e-12))
    scatters = span_ok & (hit_dist < dist_inside)
    t_med = jnp.where(scatters, t1 + hit_dist / raylen[:, None], BIG)

    best = jnp.argmin(t_med, axis=1).astype(jnp.int32)
    t_best = jnp.min(t_med, axis=1)
    valid = t_best < BIG * 0.5
    mat = scene.med_mat[best]
    return t_best, mat, valid
