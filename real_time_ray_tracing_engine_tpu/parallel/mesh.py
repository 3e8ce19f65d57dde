"""Multi-device rendering and differentiable training over a device mesh.

The reference's only parallel layer is a single-host work-stealing thread pool
over pixel rows (ThreadPool.hpp, SURVEY.md §2.8). Here the same data-parallel
structure spans a 2D device mesh instead:

  axis "tile"   — pixel row-blocks of the image (each device owns rows)
  axis "sample" — stratified sample batches (each device owns a sample range)

The scene/BVH pytree is replicated per device; the only cross-device
communication is one `psum` over the "sample" axis to merge partial
accumulations (replacing the reference GPU path's atomicAdd accumulation,
CameraKernels.cu:233-235), plus the implicit gradient `psum` inserted by
shard_map's transpose in the training step. Counter-based RNG keyed on
(pixel, sample) makes results invariant to the mesh layout.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..scene.flat import FlatScene
from ..scene.schema import CameraConfig, Scene
from ..scene.compile import compile_scene
from ..utils import rng
from ..ops.integrator import trace
from ..models import camera as cam_mod


def make_render_mesh(n_tile: int | None = None, n_sample: int | None = None,
                     devices=None) -> Mesh:
    """Build a ("tile", "sample") mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_tile is None and n_sample is None:
        n_sample = 2 if n % 2 == 0 and n > 1 else 1
        n_tile = n // n_sample
    elif n_tile is None:
        n_tile = n // n_sample
    elif n_sample is None:
        n_sample = n // n_tile
    assert n_tile * n_sample == n, (n_tile, n_sample, n)
    dev_grid = np.asarray(devices).reshape(n_tile, n_sample)
    return Mesh(dev_grid, ("tile", "sample"))


def _tile_sample_render(flat: FlatScene, cam, seed, *, width, height_local,
                        row0, n_strata, spp_local, sample0, max_depth,
                        sky_gradient):
    """Render rows [row0, row0+height_local) with spp_local samples starting
    at stratum sample0. Pure function of its arguments — used per-shard.

    The sample body is rematerialized under reverse mode, so the backward
    stores one accumulator per sample and re-traces one sample at a time
    (whose bounces are rematerialized in turn, see integrator.trace)."""
    rows = row0 + jnp.arange(height_local)
    pix = (rows[:, None] * width + jnp.arange(width)[None, :]).reshape(-1)

    @jax.checkpoint
    def body(acc, k):
        s = sample0 + k
        keys = rng.ray_keys(seed, pix, jnp.broadcast_to(s, pix.shape))
        org, dr, tm = cam_mod.generate_rays(cam, width, pix, s, n_strata, keys)
        rad = trace(flat, org, dr, tm, keys, cam.background,
                    max_depth=max_depth, sky_gradient=sky_gradient)
        return acc + rad, None

    # init derived from (pix, sample0) so its varying-mesh-axes type matches
    # the body outputs under shard_map (see integrator.trace for the same)
    acc0 = (pix.astype(jnp.float32)[:, None]
            + jnp.asarray(sample0, jnp.float32)) * 0.0 \
        + jnp.zeros((height_local * width, 3), jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(spp_local))
    return acc.reshape(height_local, width, 3)


@partial(jax.jit, static_argnames=("mesh", "width", "height", "n_strata",
                                   "max_depth", "sky_gradient"))
def render_sharded(flat: FlatScene, cam, seed, *, mesh: Mesh, width: int,
                   height: int, n_strata: int, max_depth: int,
                   sky_gradient: bool):
    """Full image, sharded (rows over "tile") x (samples over "sample").

    Returns the averaged (height, width, 3) image, sharded over rows.
    Absolute pixel ids (row offset per shard) keep the image
    mesh-layout-invariant; this is also the differentiable path used by
    parallel/train.py.
    """
    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    total_spp = n_strata * n_strata
    assert height % n_tile == 0, (height, n_tile)
    assert total_spp % n_sample == 0, (total_spp, n_sample)
    h_local = height // n_tile
    spp_local = total_spp // n_sample

    def shard_fn(flat, cam, seed):
        t = jax.lax.axis_index("tile")
        s = jax.lax.axis_index("sample")
        acc = _tile_sample_render(
            flat, cam, seed, width=width, height_local=h_local,
            row0=t * h_local, n_strata=n_strata, spp_local=spp_local,
            sample0=s * spp_local, max_depth=max_depth,
            sky_gradient=sky_gradient)
        # merge sample partials (the atomicAdd analogue) and average
        return jax.lax.psum(acc, "sample") / total_spp

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P("tile"), check_vma=False)(flat, cam, seed)


def render_on_mesh(scene: Scene | FlatScene, cfg: CameraConfig | None = None,
                   *, mesh: Mesh | None = None, seed: int = 0,
                   use_bvh: bool = False):
    """Convenience wrapper: compile scene, pad height to the mesh, render."""
    if isinstance(scene, Scene):
        cfg = cfg or scene.camera
        flat = compile_scene(scene, use_bvh=use_bvh)
    else:
        assert cfg is not None
        flat = scene
    mesh = mesh or make_render_mesh()
    width, height = cam_mod.image_size(cfg)
    n_tile = mesh.shape["tile"]
    hp = -(-height // n_tile) * n_tile
    n_strata = cam_mod.sqrt_spp(cfg)
    # pad total spp to a multiple of the sample axis by raising n_strata
    while (n_strata * n_strata) % mesh.shape["sample"] != 0:
        n_strata += 1
    img = render_sharded(flat, cam_mod.derive(cfg), seed, mesh=mesh,
                         width=width, height=hp, n_strata=n_strata,
                         max_depth=cfg.max_depth,
                         sky_gradient=cfg.sky_gradient)
    return img[:height]
