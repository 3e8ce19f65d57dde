"""Perlin-style gradient noise, hash-based (table-free redesign).

Reference: src/core/PerlinNoise.hpp:43-79,140-205 — 256 random unit gradient
vectors addressed by xor of three permutation tables, Hermite-faded trilinear
interpolation, 7-octave |noise| turbulence, with per-lattice-corner TABLE
GATHERS.

This redesign derives each lattice corner's gradient ARITHMETICALLY — a
counter-based PCG4D hash of the integer corner coordinates (the same hash the
renderer's RNG uses, utils/rng.py) mapped to a normalized vector in [-1,1]^3.
That is distribution-identical to the reference's tables (which cache 256
samples of exactly this distribution, PerlinNoise.hpp:19-26, and are randomly
seeded per run, so parity with the reference was always distributional — see
SURVEY.md §7 hard part 6), removes the tables from the scene state, and runs
elementwise on ray batches of any shape.

All functions take component arrays (px, py, pz) of any common shape.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .rng import _pcg4d, _to_unit

TURB_DEPTH = 7          # reference PerlinNoise.hpp:67-79


def _i2u(v):
    return jax.lax.bitcast_convert_type(v, jnp.uint32)


def _corner_gradient(ix, iy, iz, seed):
    """Unit-ish gradient at integer lattice corner (ix, iy, iz) (int32).

    PCG4D(corner, seed) -> 3 uniforms in [-1, 1] -> normalize: the same
    cube-sample-then-normalize distribution as the reference's table entries
    (PerlinNoise.hpp:19-26)."""
    a, b, c, _ = _pcg4d(_i2u(ix), _i2u(iy), _i2u(iz), seed)
    gx = 2.0 * _to_unit(a) - 1.0
    gy = 2.0 * _to_unit(b) - 1.0
    gz = 2.0 * _to_unit(c) - 1.0
    inv = jax.lax.rsqrt(jnp.maximum(gx * gx + gy * gy + gz * gz, 1e-12))
    return gx * inv, gy * inv, gz * inv


def noise3(px, py, pz, seed):
    """Gradient noise in [-1, 1]; Hermite-faded trilinear interpolation of
    hashed corner gradients (structure of PerlinNoise.hpp:140-205)."""
    seed = jnp.uint32(seed) if not hasattr(seed, "dtype") else seed
    fx, fy, fz = jnp.floor(px), jnp.floor(py), jnp.floor(pz)
    ix, iy, iz = (fx.astype(jnp.int32), fy.astype(jnp.int32),
                  fz.astype(jnp.int32))
    u, v, w = px - fx, py - fy, pz - fz
    su = u * u * (3.0 - 2.0 * u)
    sv = v * v * (3.0 - 2.0 * v)
    sw = w * w * (3.0 - 2.0 * w)

    acc = jnp.zeros_like(u)
    for di in (0, 1):
        wu = su if di else 1.0 - su
        for dj in (0, 1):
            wv = sv if dj else 1.0 - sv
            for dk in (0, 1):
                ww = sw if dk else 1.0 - sw
                gx, gy, gz = _corner_gradient(ix + di, iy + dj, iz + dk,
                                              seed)
                d = (gx * (u - di) + gy * (v - dj) + gz * (w - dk))
                acc = acc + (wu * wv * ww) * d
    return acc


def turbulence3(px, py, pz, seed, depth: int = TURB_DEPTH):
    """Sum of |noise| octaves (reference PerlinNoise.hpp:67-79); each octave
    hashes with a decorrelated seed so doubled lattices do not alias."""
    seed = jnp.uint32(seed) if not hasattr(seed, "dtype") else seed
    acc = jnp.zeros_like(px)
    weight = 1.0
    qx, qy, qz = px, py, pz
    for o in range(depth):
        s_o = seed + jnp.uint32((o * 0x9E3779B9) & 0xFFFFFFFF)
        acc = acc + weight * jnp.abs(noise3(qx, qy, qz, s_o))
        weight = weight * 0.5
        qx, qy, qz = qx * 2.0, qy * 2.0, qz * 2.0
    return acc


def noise(p, seed=0):
    """(..., 3) point-array convenience wrapper."""
    return noise3(p[..., 0], p[..., 1], p[..., 2], seed)


def turbulence(p, seed=0, depth: int = TURB_DEPTH):
    return turbulence3(p[..., 0], p[..., 1], p[..., 2], seed, depth)
