"""Render drivers: batch (static) and progressive accumulation.

Replaces the reference StaticCamera (StaticCamera.cpp:25-131 scanline loop,
one ThreadPool job per pixel) and the progressive accumulation core of
DynamicCamera (DynamicCamera.cpp:105-175: one stratum (s_i, s_j) per frame
until sqrt_spp^2 samples taken). Here the image is rendered in jit-compiled
row-tile passes: rays for a whole tile are traced as one wavefront batch, and
samples accumulate either inside one jit scan (batch render) or one stratum
per `step()` (progressive), with the accumulation buffer + sample counter as
the resumable checkpoint state.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..scene.schema import CameraConfig, Scene
from ..scene.flat import FlatScene
from ..scene.compile import compile_scene
from ..utils import rng
from ..ops.integrator import trace
from . import camera as cam_mod


def default_tile_rows(width: int, height: int, n_prims: int) -> int:
    """Bound the (rays x prims) intersection table to ~32M entries."""
    budget = 32 * 1024 * 1024
    rows = max(1, budget // max(1, width * max(n_prims, 1)))
    return int(min(rows, height))


# Scene-baked pass cache: the scene tables are closed over as compile-time
# CONSTANTS, so XLA can fold their gathers and selects. Rendering recompiles
# per scene — the analogue of the reference's scene-to-device compile pass
# (CudaSceneInitialization.cuh:249). Keyed by object identity + statics; the
# cache holds the FlatScene alive so ids cannot be reused, and is bounded
# (LRU) so a scene-per-request service does not leak host+device memory.
_BAKED_CACHE: "dict" = {}
_BAKED_CACHE_MAX = 8


def baked_render_pass(flat: FlatScene, **statics):
    """jitted (cam, seed, sample_start) -> radiance-sum image with `flat`
    closed over as constants. statics = _render_pass's keyword args."""
    key = (id(flat), tuple(sorted(statics.items())))
    hit = _BAKED_CACHE.pop(key, None)
    if hit is not None:
        _BAKED_CACHE[key] = hit          # reinsert: most-recently-used
        return hit[1]

    @jax.jit
    def fn(cam, seed, sample_start):
        return _render_pass(flat, cam, seed, sample_start, **statics)

    while len(_BAKED_CACHE) >= _BAKED_CACHE_MAX:
        _BAKED_CACHE.pop(next(iter(_BAKED_CACHE)))   # evict LRU
    _BAKED_CACHE[key] = (flat, fn)
    return fn


@partial(jax.jit, static_argnames=("width", "height", "tile_rows",
                                   "n_strata", "max_depth", "sky_gradient",
                                   "n_samples"))
def _render_pass(scene: FlatScene, cam: cam_mod.CameraState, seed,
                 sample_start, *, width: int, height: int, tile_rows: int,
                 n_strata: int, max_depth: int, sky_gradient: bool,
                 n_samples: int):
    """Sum of `n_samples` consecutive stratified samples for the full image.

    Returns (height, width, 3) radiance sum (not averaged).
    """
    n_tiles = -(-height // tile_rows)

    def tile_fn(tile_idx):
        rows = tile_idx * tile_rows + jnp.arange(tile_rows)
        pix = (rows[:, None] * width + jnp.arange(width)[None, :]).reshape(-1)
        # rows beyond the image render pixel 0's rays and are cropped later
        pixc = jnp.minimum(pix, width * height - 1)

        def sample_body(acc, k):
            s = sample_start + k
            keys = rng.ray_keys(seed, pixc, jnp.broadcast_to(s, pixc.shape))
            org, dr, tm = cam_mod.generate_rays(cam, width, pixc, s,
                                                n_strata, keys)
            rad = trace(scene, org, dr, tm, keys, cam.background,
                        max_depth=max_depth, sky_gradient=sky_gradient)
            return acc + rad, None

        acc0 = jnp.zeros((tile_rows * width, 3), jnp.float32)
        acc, _ = jax.lax.scan(sample_body, acc0, jnp.arange(n_samples))
        return acc.reshape(tile_rows, width, 3)

    tiles = jax.lax.map(tile_fn, jnp.arange(n_tiles))
    img = tiles.reshape(n_tiles * tile_rows, width, 3)
    return img[:height]


def render(scene: Scene | FlatScene, cfg: CameraConfig | None = None, *,
           seed: int = 0, use_bvh: bool = False, tile_rows: int | None = None,
           samples_per_batch: int = 4, spp: int | None = None,
           progress=None) -> jnp.ndarray:
    """Render a full image; returns (H, W, 3) linear float32.

    Accepts either a schema Scene (compiled here) or a prebuilt FlatScene +
    explicit CameraConfig. Samples are taken `samples_per_batch` per jitted
    pass; `progress(done, total)` is called after each pass.
    """
    if isinstance(scene, Scene):
        cfg = cfg or scene.camera
        flat = compile_scene(scene, use_bvh=use_bvh)
    else:
        assert cfg is not None, "FlatScene input needs an explicit CameraConfig"
        flat = scene

    width, height = cam_mod.image_size(cfg)
    n_strata = cam_mod.sqrt_spp(
        cfg if spp is None else
        CameraConfig(**{**cfg.__dict__, "samples_per_pixel": spp}))
    total = n_strata * n_strata
    cam = cam_mod.derive(cfg)
    tr = tile_rows or default_tile_rows(width, height, flat.n_prims)

    acc = jnp.zeros((height, width, 3), jnp.float32)
    s = 0
    while s < total:
        k = min(samples_per_batch, total - s)
        pass_fn = baked_render_pass(
            flat, width=width, height=height, tile_rows=tr,
            n_strata=n_strata, max_depth=cfg.max_depth,
            sky_gradient=cfg.sky_gradient, n_samples=k)
        acc = acc + pass_fn(cam, seed, s)
        s += k
        if progress is not None:
            progress(s, total)
    return acc / total


@partial(jax.jit, static_argnames=("cols", "rows"))
def _preview_bytes(acc, n_samples_f, cols: int, rows: int):
    """(H, W, 3) accumulation -> (rows, cols, 3) uint8 preview on device
    (nearest-neighbor select, then the reference gamma/clamp byte rule)."""
    from ..utils.color import to_bytes
    h, w, _ = acc.shape
    yi = jnp.minimum((jnp.arange(rows) * h) // rows, h - 1)
    xi = jnp.minimum((jnp.arange(cols) * w) // cols, w - 1)
    return to_bytes(acc[yi[:, None], xi[None, :]] / n_samples_f)


class ProgressiveRenderer:
    """Progressive accumulation with camera motion and checkpointing.

    Mirrors DynamicCamera's loop state: accumulation buffer + samples_taken,
    one stratum per step (DynamicCamera.cpp:105-175), reset on camera move
    (:271-277). The (buffer, counter, seed) triple is the checkpoint — unlike
    the reference, whose progressive state dies with the process, `save`/`load`
    make re-renders resumable (SURVEY.md §5 checkpoint/resume).
    """

    def __init__(self, scene: Scene, *, use_bvh: bool = False, seed: int = 0,
                 tile_rows: int | None = None):
        self.scene_schema = scene
        self.cfg = scene.camera
        self.flat = compile_scene(scene, use_bvh=use_bvh)
        self.seed = seed
        self.width, self.height = cam_mod.image_size(self.cfg)
        self.n_strata = cam_mod.sqrt_spp(self.cfg)
        self.tile_rows = tile_rows or default_tile_rows(
            self.width, self.height, self.flat.n_prims)
        self.cam = cam_mod.derive(self.cfg)
        self.reset()

    # ------------------------------------------------------------ state
    def reset(self):
        self.acc = jnp.zeros((self.height, self.width, 3), jnp.float32)
        self.samples_taken = 0

    @property
    def converged(self) -> bool:
        return self.samples_taken >= self.n_strata * self.n_strata

    def step(self, k: int = 1) -> bool:
        """Accumulate k strata (clamped to what remains); True if work done.

        k > 1 renders multiple samples in ONE fused pass — the adaptive
        viewer raises it when the frame rate allows, the analogue of the
        reference's FPS-keyed tile resizing (DynamicCamera.cpp:190-193)."""
        if self.converged:
            return False
        k = max(1, min(k, self.n_strata * self.n_strata
                       - self.samples_taken))
        pass_fn = baked_render_pass(
            self.flat, width=self.width, height=self.height,
            tile_rows=self.tile_rows, n_strata=self.n_strata,
            max_depth=self.cfg.max_depth,
            sky_gradient=self.cfg.sky_gradient, n_samples=k)
        self.acc = self.acc + pass_fn(self.cam, self.seed,
                                      self.samples_taken)
        self.samples_taken += k
        return True

    def image(self) -> jnp.ndarray:
        return self.acc / max(1, self.samples_taken)

    def preview(self, cols: int, rows: int) -> np.ndarray:
        """Terminal-resolution gamma-byte frame, downsampled ON DEVICE.

        The interactive viewer only displays ~cols x rows cells, so the
        nearest-neighbor select + gamma run on device and only rows*cols*3
        bytes cross to the host instead of the full float image. Selection
        commutes with the per-pixel gamma/clamp, so the frame equals
        _downsample(to_bytes(image()))."""
        return np.asarray(_preview_bytes(
            self.acc,
            jnp.asarray(max(1, self.samples_taken), jnp.float32),
            cols, rows))

    # ----------------------------------------------------- camera motion
    def move_camera(self, delta):
        """Translate lookfrom/lookat (DynamicCamera WASD handling,
        DynamicCamera.cpp:204-278) and reset accumulation."""
        d = tuple(float(x) for x in delta)
        c = self.cfg
        self.cfg = CameraConfig(**{
            **c.__dict__,
            "lookfrom": tuple(a + b for a, b in zip(c.lookfrom, d)),
            "lookat": tuple(a + b for a, b in zip(c.lookat, d))})
        self.cam = cam_mod.derive(self.cfg)
        self.reset()

    def set_spp(self, spp: int):
        """+/- samples control (DynamicCamera.cpp:239-252)."""
        self.cfg = CameraConfig(**{**self.cfg.__dict__,
                                   "samples_per_pixel": spp})
        self.n_strata = cam_mod.sqrt_spp(self.cfg)
        self.reset()

    # ------------------------------------------------------- checkpoint
    def save(self, path: str):
        np.savez(path, acc=np.asarray(self.acc),
                 samples_taken=self.samples_taken, seed=self.seed,
                 n_strata=self.n_strata)

    def load(self, path: str):
        d = np.load(path)
        assert int(d["n_strata"]) == self.n_strata, "spp mismatch"
        self.acc = jnp.asarray(d["acc"])
        self.samples_taken = int(d["samples_taken"])
        self.seed = int(d["seed"])
