"""Material shading over the flattened material table.

Replaces the reference's Material virtual hierarchy / CudaMaterial tagged
union (Material.hpp:21-42, Material.cuh:204-266): all five material families
are evaluated with masked arithmetic per ray batch and selected by type code.

Outputs follow the reference ScatterRecord contract:
  - emitted: nonzero only for DiffuseLight on front faces
    (DiffuseLightMaterial.cpp:12-23)
  - skip_pdf materials (metal MetalMaterial.cpp:10-62, dielectric
    DielectricMaterial.cpp:11-86) produce a deterministic specular direction
  - pdf materials (lambertian LambertianMaterial.cpp:15-58, isotropic
    IsotropicMaterial.cpp:12-31) expose sample/value/scattering_pdf for the
    MIS mixture
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import pytree
from ..utils.vecmath import (dot, normalize, reflect, refract, onb_from_w,
                             onb_local, safe_sqrt, where3)
from ..utils.rng import unit_vector_from_uv, cosine_direction_from_uv
from ..scene.flat import (FlatScene, MAT_LAMBERTIAN, MAT_METAL,
                          MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC)
from .textures import texture_value

INV_4PI = 1.0 / (4.0 * jnp.pi)


@pytree.dataclass
class ScatterInfo:
    attenuation: jnp.ndarray   # (N, 3)
    scatters: jnp.ndarray      # (N,) bool — False = absorbed/emitter
    skip_pdf: jnp.ndarray      # (N,) bool — specular, bypass MIS
    skip_dir: jnp.ndarray      # (N, 3) unit specular direction
    is_isotropic: jnp.ndarray  # (N,) bool — material-pdf family selector


def emitted(scene: FlatScene, mat, u, v, p, front_face):
    """Emission term (Camera.cpp:246-254 path)."""
    is_light = scene.mat_type[mat] == MAT_DIFFUSE_LIGHT
    color = texture_value(scene, scene.mat_tex[mat], u, v, p)
    on = is_light & front_face
    return jnp.where(on[:, None], color, 0.0)


def _schlick(cosine, ri):
    """Schlick reflectance approximation (DielectricMaterial.cpp:75-81)."""
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(scene: FlatScene, mat, in_dir, normal, front_face, u, v, p,
            u_fuzz1, u_fuzz2, u_refl) -> ScatterInfo:
    """Evaluate scatter behavior for all rays. in_dir unit."""
    mtype = scene.mat_type[mat]
    tex = texture_value(scene, scene.mat_tex[mat], u, v, p)

    is_lam = mtype == MAT_LAMBERTIAN
    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    is_iso = mtype == MAT_ISOTROPIC
    is_light = mtype == MAT_DIFFUSE_LIGHT

    # --- metal: mirror + fuzz jitter; absorbed if scattered below surface
    fuzz = scene.mat_fuzz[mat]
    refl = normalize(reflect(in_dir, normal))
    jitter = unit_vector_from_uv(u_fuzz1, u_fuzz2)
    metal_dir = normalize(refl + fuzz[:, None] * jitter)
    metal_ok = dot(metal_dir, normal) > 0.0

    # --- dielectric: refract unless TIR or Schlick says reflect
    ior = scene.mat_ior[mat]
    ri = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(dot(-in_dir, normal), 1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot = ri * sin_theta > 1.0
    do_reflect = cannot | (_schlick(cos_theta, ri) > u_refl)
    diel_dir = where3(do_reflect, normalize(reflect(in_dir, normal)),
                      normalize(refract(in_dir, normal, ri)))

    attenuation = jnp.where(is_diel[:, None], 1.0, tex)
    scatters = ~is_light & ~(is_metal & ~metal_ok)
    skip_pdf = is_metal | is_diel
    skip_dir = where3(is_metal, metal_dir, diel_dir)
    del is_lam
    return ScatterInfo(attenuation=attenuation, scatters=scatters,
                       skip_pdf=skip_pdf, skip_dir=skip_dir,
                       is_isotropic=is_iso)


def material_pdf_sample(normal, is_isotropic, u1, u2):
    """Sample the material's own PDF: cosine hemisphere for lambertian
    (CosinePDF PDF.hpp:53-82), uniform sphere for isotropic (SpherePDF)."""
    bu, bv, bw = onb_from_w(normal)
    cos_dir = onb_local(bu, bv, bw, cosine_direction_from_uv(u1, u2))
    sph_dir = unit_vector_from_uv(u1, u2)
    return where3(is_isotropic, sph_dir, normalize(cos_dir))


def material_pdf_value(normal, is_isotropic, out_dir):
    """PDF of the material's own sampler in direction out_dir (unit)."""
    cosv = jnp.maximum(0.0, dot(out_dir, normal)) / jnp.pi
    return jnp.where(is_isotropic, INV_4PI, cosv)


def scattering_pdf(normal, is_isotropic, out_dir):
    """BSDF directional density (LambertianMaterial.cpp:34-58 cos/pi;
    IsotropicMaterial.cpp:24-31 1/4pi)."""
    cosv = jnp.maximum(0.0, dot(out_dir, normal)) / jnp.pi
    return jnp.where(is_isotropic, INV_4PI, cosv)
