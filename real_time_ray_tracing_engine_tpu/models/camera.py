"""Camera: viewport derivation and stratified ray generation.

Replaces the reference Camera (src/core/camera/Camera.cpp:31-73 initialize,
:152-216 get_ray/sample_square_stratified, :226-230 defocus_disk_sample):
camera state is a tiny pytree of derived vectors; ray generation is a pure
vectorized function of (pixel id, sample id) with counter-based jitter, DOF
and motion-blur time sampling.
"""
from __future__ import annotations

import math

import jax.numpy as jnp

from ..utils import pytree
from ..scene.schema import CameraConfig
from ..utils.vecmath import normalize, cross
from ..utils import rng

# camera consumes one 5-uniform block per ray, tagged away from bounce draws
CAMERA_DRAW_TAG = 0x0CA4


@pytree.dataclass
class CameraState:
    center: jnp.ndarray       # (3,)
    pixel00: jnp.ndarray      # (3,)
    pixel_du: jnp.ndarray     # (3,)
    pixel_dv: jnp.ndarray     # (3,)
    defocus_u: jnp.ndarray    # (3,) defocus disk basis * radius
    defocus_v: jnp.ndarray    # (3,)
    defocus_on: jnp.ndarray   # () bool as float mask
    background: jnp.ndarray   # (3,)


def image_size(cfg: CameraConfig) -> tuple[int, int]:
    h = max(1, int(cfg.image_width / cfg.aspect_ratio))
    return cfg.image_width, h


def sqrt_spp(cfg: CameraConfig) -> int:
    # actual samples = sqrt_spp^2 (Camera.cpp:209)
    return max(1, int(math.sqrt(cfg.samples_per_pixel)))


def derive(cfg: CameraConfig) -> CameraState:
    w_px, h_px = image_size(cfg)
    lookfrom = jnp.asarray(cfg.lookfrom, jnp.float32)
    lookat = jnp.asarray(cfg.lookat, jnp.float32)
    vup = jnp.asarray(cfg.vup, jnp.float32)

    theta = math.radians(cfg.vfov)
    h = math.tan(theta / 2.0)
    viewport_h = 2.0 * h * cfg.focus_dist
    viewport_w = viewport_h * (w_px / h_px)

    w = normalize(lookfrom - lookat)
    u = normalize(cross(vup, w))
    v = cross(w, u)

    viewport_u = viewport_w * u
    viewport_v = viewport_h * (-v)
    pixel_du = viewport_u / w_px
    pixel_dv = viewport_v / h_px
    upper_left = (lookfrom - cfg.focus_dist * w - viewport_u / 2
                  - viewport_v / 2)
    pixel00 = upper_left + 0.5 * (pixel_du + pixel_dv)

    defocus_radius = cfg.focus_dist * math.tan(
        math.radians(cfg.defocus_angle / 2.0))
    return CameraState(
        center=lookfrom, pixel00=pixel00, pixel_du=pixel_du,
        pixel_dv=pixel_dv, defocus_u=u * defocus_radius,
        defocus_v=v * defocus_radius,
        defocus_on=jnp.asarray(1.0 if cfg.defocus_angle > 0 else 0.0,
                               jnp.float32),
        background=jnp.asarray(cfg.background, jnp.float32))


def generate_rays(cam: CameraState, width: int, pixel_ids, sample_id,
                  n_strata: int, keys):
    """Rays for pixel_ids (N,) at stratified sample index sample_id.

    sample_id in [0, n_strata^2); stratum = (s % n, s // n)
    (Camera.cpp:208-216). keys: per-(pixel,sample) PRNG keys.
    Returns (org (N,3), dir (N,3), time (N,)).
    """
    u = rng.uniforms(keys, CAMERA_DRAW_TAG, (5,))      # (N, 5)
    i = (pixel_ids % width).astype(jnp.float32)
    j = (pixel_ids // width).astype(jnp.float32)
    s_i = (sample_id % n_strata).astype(jnp.float32)
    s_j = (sample_id // n_strata).astype(jnp.float32)

    inv = 1.0 / n_strata
    off_x = (s_i + u[:, 0]) * inv - 0.5
    off_y = (s_j + u[:, 1]) * inv - 0.5
    pixel_sample = (cam.pixel00[None, :]
                    + (i + off_x)[:, None] * cam.pixel_du[None, :]
                    + (j + off_y)[:, None] * cam.pixel_dv[None, :])

    disk = rng.in_unit_disk_from_uv(u[:, 2], u[:, 3])   # (N, 2)
    offset = (disk[:, 0:1] * cam.defocus_u[None, :]
              + disk[:, 1:2] * cam.defocus_v[None, :]) * cam.defocus_on
    org = cam.center[None, :] + offset
    dr = pixel_sample - org
    tm = u[:, 4]                                        # time in [0,1)
    return org, dr, tm
