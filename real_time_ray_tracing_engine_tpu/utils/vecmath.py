"""Vector math on stacked (..., 3) JAX arrays.

Array replacement for the reference's Vec3/Vec3Utility/ONB/Interval
(reference: src/utils/math/Vec3.hpp, Vec3Utility.hpp, ONB.hpp, Interval.hpp).
Instead of a 4-double aligned Vec3 class, every quantity is a float32 array
whose last axis is xyz; all helpers broadcast over leading (ray-lane) axes so
XLA vectorizes them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-8
# Shadow-ray epsilon; the reference uses 0.001 (src/core/camera/Camera.cpp:242).
T_MIN = 1e-3
BIG = 1e30


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def edot(subscripts, a, b):
    """einsum pinned to fp32-accurate precision.

    On the GPU, XLA may run float32 contractions in TF32 (about three
    decimal digits); with world coordinates of magnitude ~500 (Cornell box)
    the resulting ~1-unit error destroys plane-equation intersection tests.
    All geometry contractions must go through this helper.
    """
    return jnp.einsum(subscripts, a, b, precision=jax.lax.Precision.HIGHEST)


def cross(a, b):
    return jnp.cross(a, b)


def safe_sqrt(x, eps=1e-12):
    """sqrt with a finite gradient at 0.

    sqrt(max(x, 0)) has an infinite derivative at x=0, and masked-out lanes
    (jnp.where) still evaluate the backward pass — inf * 0 = NaN poisons
    every gradient in the batch. All sqrt on possibly-nonpositive values in
    differentiated code must use this.
    """
    return jnp.sqrt(jnp.maximum(x, eps))


def length_squared(a):
    return jnp.sum(a * a, axis=-1)


def length(a):
    return jnp.sqrt(length_squared(a))


def normalize(a):
    return a / jnp.maximum(length(a), EPS)[..., None]


def near_zero(a):
    """True where all components are ~0 (reference: Vec3.hpp near_zero)."""
    return jnp.all(jnp.abs(a) < 1e-8, axis=-1)


def reflect(v, n):
    """Mirror reflection (reference: Vec3Utility.hpp reflect)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit vector uv about unit normal n
    (reference: Vec3Utility.hpp refract)."""
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -safe_sqrt(jnp.abs(1.0 - length_squared(r_out_perp)))[..., None] * n
    )
    return r_out_perp + r_out_parallel


def onb_from_w(w):
    """Build an orthonormal basis (u, v, w) from unit vector w
    (reference: src/utils/math/ONB.hpp:19-65)."""
    w = normalize(w)
    a = jnp.where(jnp.abs(w[..., 0:1]) > 0.9,
                  jnp.array([0.0, 1.0, 0.0], w.dtype),
                  jnp.array([1.0, 0.0, 0.0], w.dtype))
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_local(u, v, w, a):
    """Transform local-space vector a into the (u,v,w) world basis."""
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w


def where3(mask, a, b):
    """Select (...,3) vectors by a (...,) mask."""
    return jnp.where(mask[..., None], a, b)
