"""Counter-based, sharding-invariant RNG for the path tracer.

The reference uses thread-local mt19937 on CPU (src/utils/math/Utility.hpp:16-37)
and per-pixel curandState on GPU (src/core/camera/CameraKernels.cu:15-25) — both
non-reproducible. Here every draw is a pure function of
(seed, pixel_id, sample_id, tag, lane) through the PCG4D hash (Jarzynski &
Olano, "Hash Functions for GPU Rendering", JCGT 2020 — the standard stateless
RNG family in GPU path tracers): renders are deterministic and invariant to
the device-mesh layout (a pixel gets the same sample stream no matter which
device owns it), and the whole generator is ~20 u32 ops per 4 draws — pure
elementwise arithmetic with no cross-lane state, unlike jax.random's
threefry path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Draw-slot labels within one bounce of the integrator. Each slot consumes a
# fixed lane out of one per-(ray,bounce) uniform block. (Medium free-flight
# draws use their own tag stream, 1_000_000 + bounce — see ops.integrator.)
N_DRAWS = 9
(D_PICK, D_LIGHT_SEL, D_LIGHT_U, D_LIGHT_V, D_MAT_U, D_MAT_V,
 D_FUZZ_U, D_FUZZ_V, D_REFL) = range(N_DRAWS)

_GOLDEN = 0x9E3779B9


def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def _pcg4d(a, b, c, d):
    """PCG4D mixing of four u32 streams -> four decorrelated u32 outputs."""
    m = jnp.uint32(1664525)
    add = jnp.uint32(1013904223)
    a = a * m + add
    b = b * m + add
    c = c * m + add
    d = d * m + add
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> jnp.uint32(16))
    b = b ^ (b >> jnp.uint32(16))
    c = c ^ (c >> jnp.uint32(16))
    d = d ^ (d >> jnp.uint32(16))
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _to_unit(u):
    """u32 -> float32 in [0, 1) using the top 24 bits.

    Routed through an int32 bitcast: after >>8 the sign bit is clear, so the
    reinterpretation is value-preserving.
    """
    i = jax.lax.bitcast_convert_type(u >> jnp.uint32(8), jnp.int32)
    return i.astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def ray_keys(seed, pixel_ids, sample_ids):
    """Per-ray counter state (N, 3) u32: [pixel, sample, mixed seed].

    Accepts an int/traced scalar seed (legacy jax PRNG keys are not used)."""
    if hasattr(seed, "dtype") and jax.dtypes.issubdtype(seed.dtype,
                                                        jax.dtypes.prng_key):
        seed = jax.random.key_data(seed)[..., -1]
    seed = _u32(seed) * jnp.uint32(_GOLDEN) + jnp.uint32(0x85EBCA6B)
    pixel_ids = _u32(pixel_ids)
    sample_ids = jnp.broadcast_to(_u32(sample_ids), pixel_ids.shape)
    return jnp.stack(
        [pixel_ids, sample_ids,
         jnp.broadcast_to(seed, pixel_ids.shape)], axis=-1)


def uniforms(keys, tag, shape_suffix=()):
    """(N, *suffix) U[0,1) draws for an integer tag (bounce id, camera id...).

    keys: (N, 3) u32 from ray_keys. tag may be a python int or traced scalar.
    """
    (n,) = shape_suffix if shape_suffix else (1,)
    n_blocks = -(-n // 4)
    tag = _u32(tag)
    outs = []
    for blk in range(n_blocks):
        ctr = tag * jnp.uint32(0x0000193) + jnp.uint32(blk)
        a, b, c, d = _pcg4d(keys[..., 0], keys[..., 1], keys[..., 2], ctr)
        outs += [_to_unit(a), _to_unit(b), _to_unit(c), _to_unit(d)]
    out = jnp.stack(outs[:n], axis=-1)
    if not shape_suffix:
        return out[..., 0]
    return out


def bounce_uniforms(keys, bounce, n=N_DRAWS):
    """One (N, n) block of U[0,1) draws for a bounce; keys: (N, 3) u32."""
    return uniforms(keys, jnp.uint32(0x4000000) + _u32(bounce), (n,))


def unit_vector_from_uv(u1, u2):
    """Uniform point on the unit sphere from two uniforms
    (replaces reference random_unit_vector, Vec3Utility.hpp:53-62)."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(1e-12, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def cosine_direction_from_uv(u1, u2):
    """Cosine-weighted hemisphere direction in local (z-up) frame
    (reference: Vec3Utility.hpp:94-104 random_cosine_direction)."""
    phi = 2.0 * jnp.pi * u1
    sq2 = jnp.sqrt(jnp.maximum(u2, 1e-12))
    z = jnp.sqrt(jnp.maximum(1e-12, 1.0 - u2))
    return jnp.stack([jnp.cos(phi) * sq2, jnp.sin(phi) * sq2, z], axis=-1)


def in_unit_disk_from_uv(u1, u2):
    """Uniform point in the unit disk (for defocus sampling;
    reference: Vec3Utility.hpp random_in_unit_disk)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)
