"""Wavefront path-tracing integrator.

Wavefront re-design of the reference's recursive `ray_color`
(Camera.cpp:232-309 / ray_color_cuda CameraKernels.cu:106-202): recursion over
bounce depth becomes a `lax.fori_loop` carrying SoA ray state
(origin, direction, throughput, radiance, alive-mask) for a whole lane-batch
of rays. The estimator contract is identical:

  1. miss -> background color                          (Camera.cpp:242-243)
  2. radiance += throughput * emitted (front-face emitters)       (:246-254)
  3. no scatter -> path terminates                                (:253-254)
  4. specular (skip_pdf): throughput *= attenuation               (:260-262)
  5. else MIS: dir ~ 0.5*HittablePDF(lights) + 0.5*material PDF
     throughput *= attenuation * scattering_pdf(dir) / mixture_pdf(dir)
     with the CUDA guard pdf > 1e-8             (:269-304, CameraKernels:192)

Constant mediums compete with the closest surface hit each bounce
(ConstantMedium.cpp semantics), replacing the reference's boundary-wrapper
Hittable with a dedicated masked free-flight pass.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.vecmath import dot, normalize, where3, T_MIN, BIG
from ..utils import rng
from ..scene.flat import FlatScene
from . import materials as mat_ops
from .intersect import closest_hit, medium_scatter
from .bvh import closest_hit_bvh
from .lights import light_pdf_value, light_sample


def sky_color(dr):
    """RTiOW gradient sky: lerp white -> light blue on unit dir y."""
    a = 0.5 * (dr[..., 1] + 1.0)
    white = jnp.ones(3, dr.dtype)
    blue = jnp.asarray([0.5, 0.7, 1.0], dr.dtype)
    return (1.0 - a)[..., None] * white + a[..., None] * blue


def _resolve_hit(scene: FlatScene, org, dr, tm, u_med):
    """Closest surface hit, then let mediums preempt it (N-ray batch)."""
    if scene.use_bvh:
        rec = closest_hit_bvh(scene, org, dr, tm)
    else:
        rec = closest_hit(scene, org, dr, tm)
    if scene.n_mediums == 0:
        return rec
    t_surf = jnp.where(rec.hit, rec.t, BIG)
    t_med, med_mat, med_valid = medium_scatter(scene, org, dr, tm, t_surf,
                                               u_med)
    # t_med is BIG where no medium scatters; keep the masked lane finite
    t_med_safe = jnp.where(med_valid, t_med, 1.0)
    point_m = org + t_med_safe[:, None] * dr
    arb_n = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], dr.dtype),
                             dr.shape)
    return rec.replace(
        hit=rec.hit | med_valid,
        t=jnp.where(med_valid, t_med, rec.t),
        point=where3(med_valid, point_m, rec.point),
        normal=where3(med_valid, arb_n, rec.normal),
        front_face=jnp.where(med_valid, True, rec.front_face),
        mat=jnp.where(med_valid, med_mat, rec.mat),
        u=jnp.where(med_valid, 0.0, rec.u),
        v=jnp.where(med_valid, 0.0, rec.v),
    )


@partial(jax.jit, static_argnames=("max_depth", "sky_gradient"))
def trace(scene: FlatScene, org, dr, tm, keys, background, *,
          max_depth: int = 50, sky_gradient: bool = False):
    """Estimate radiance for N rays.

    org/dr: (N, 3) (dr need not be unit — it is normalized here);
    tm: (N,) ray times; keys: (N,) PRNG keys; background: (3,).
    Returns (N, 3) linear radiance.

    The bounce body is rematerialized under reverse mode: the backward keeps
    only the per-bounce carry (12 floats and a flag per ray) and recomputes
    each bounce's intersection tables and shading, instead of storing the
    dense (rays x prims) residuals of every bounce.
    """
    n = org.shape[0]
    dtype = org.dtype
    has_lights = scene.n_lights > 0

    # Initial carries are derived from `org` and `tm` (not fresh constants) so
    # that under shard_map they carry the same varying-mesh-axes type as the
    # loop body's outputs — fori_loop rejects unvarying-init/varying-out
    # carries. tm folds in the sample-axis dependence (via the RNG keys).
    zeros3 = org * 0.0 + tm[:, None] * 0.0
    state = dict(
        org=org,
        dr=normalize(dr),
        throughput=zeros3 + 1.0,
        radiance=zeros3,
        alive=zeros3[:, 0] == 0.0,
    )

    def body(bounce, st):
        u = rng.bounce_uniforms(keys, bounce)
        m_pad = scene.med_neg_inv_density.shape[0]
        u_med = (rng.uniforms(keys, 1_000_000 + bounce, (m_pad,))
                 if scene.n_mediums else jnp.zeros((n, m_pad), dtype))

        rec = _resolve_hit(scene, st["org"], st["dr"], tm, u_med)

        # 1. miss -> background
        bg = sky_color(st["dr"]) if sky_gradient else jnp.broadcast_to(
            background, (n, 3))
        miss = st["alive"] & ~rec.hit
        radiance = st["radiance"] + jnp.where(miss[:, None],
                                              st["throughput"] * bg, 0.0)

        # 2. emitted
        emit = mat_ops.emitted(scene, rec.mat, rec.u, rec.v, rec.point,
                               rec.front_face)
        live_hit = st["alive"] & rec.hit
        radiance = radiance + jnp.where(live_hit[:, None],
                                        st["throughput"] * emit, 0.0)

        # 3-5. scatter
        sc = mat_ops.scatter(scene, rec.mat, st["dr"], rec.normal,
                             rec.front_face, rec.u, rec.v, rec.point,
                             u[:, rng.D_FUZZ_U], u[:, rng.D_FUZZ_V],
                             u[:, rng.D_REFL])

        mat_dir = mat_ops.material_pdf_sample(rec.normal, sc.is_isotropic,
                                              u[:, rng.D_MAT_U],
                                              u[:, rng.D_MAT_V])
        if has_lights:
            l_dir = light_sample(scene, rec.point, tm, u[:, rng.D_LIGHT_SEL],
                                 u[:, rng.D_LIGHT_U], u[:, rng.D_LIGHT_V])
            pick_light = u[:, rng.D_PICK] < 0.5
            mis_dir = where3(pick_light, l_dir, mat_dir)
            pdf_val = 0.5 * light_pdf_value(scene, rec.point, mis_dir, tm) \
                + 0.5 * mat_ops.material_pdf_value(rec.normal,
                                                   sc.is_isotropic, mis_dir)
        else:
            mis_dir = mat_dir
            pdf_val = mat_ops.material_pdf_value(rec.normal, sc.is_isotropic,
                                                 mis_dir)

        spdf = mat_ops.scattering_pdf(rec.normal, sc.is_isotropic, mis_dir)
        pdf_ok = pdf_val > 1e-8
        mis_factor = spdf / jnp.where(pdf_ok, pdf_val, 1.0)

        factor = jnp.where(sc.skip_pdf, 1.0, mis_factor)
        new_dir = where3(sc.skip_pdf, sc.skip_dir, mis_dir)
        throughput = jnp.where(live_hit[:, None],
                               st["throughput"] * sc.attenuation
                               * factor[:, None],
                               st["throughput"])

        alive = live_hit & sc.scatters & (sc.skip_pdf | pdf_ok)
        org_new = where3(live_hit, rec.point, st["org"])
        dr_new = where3(live_hit, new_dir, st["dr"])
        return dict(org=org_new, dr=dr_new, throughput=throughput,
                    radiance=radiance, alive=alive)

    out = jax.lax.fori_loop(0, max_depth, jax.checkpoint(body), state)
    # paths still alive after max_depth contribute black (Camera.cpp:236-237)
    return out["radiance"]
