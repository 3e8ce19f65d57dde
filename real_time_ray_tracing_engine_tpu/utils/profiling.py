"""Profiling: rays/s meter, jax.profiler traces, and a roofline estimate.

The reference's only instrumentation is a per-scanline progress log
(StaticCamera.cpp:63-65) and a once-per-second FPS overlay that doubles as
the adaptive-tile control signal (DynamicCamera.cpp:182-194). SURVEY.md §5
asks for more: jax.profiler traces plus a rays/s meter derived
from (W*H*spp*avg_depth)/wall and a roofline comparison.
"""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time

import jax

# Published peaks per device, keyed by jax `device_kind`: float32 FLOP/s
# outside the tensor cores (path tracing is float32 vector work) and device
# memory bytes/s. Source: NVIDIA H100 data sheet, SXM part (dense rates, at
# the 700 W power limit).
PEAK_RATES = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peak_rates(kind: str) -> dict:
    """Published peaks for a device kind; an unknown device is an error."""
    try:
        return PEAK_RATES[kind]
    except KeyError:
        raise KeyError(f"no published peak rates for device kind {kind!r}; "
                       f"known: {sorted(PEAK_RATES)}") from None


# Fallback cost of one wavefront bounce per ray lane, in float32 op equivalents
# (intersection over ~24 Cornell prims + MIS shading + RNG). Prefer
# measured_ops_per_bounce(), which derives the number from XLA's compiled
# cost analysis of the oracle integrator instead of this hand-tuned anchor.
DEFAULT_OPS_PER_BOUNCE = 1200.0


def measured_ops_per_bounce(flat, cam_cfg, *, width=64, max_depth=8,
                            seed=0) -> float | None:
    """Compiler-measured arithmetic ops per wavefront bounce iteration.

    XLA's `compiled.cost_analysis()["flops"]` for the jitted integrator, per
    (ray x bounce) since its fori_loop runs every ray for exactly max_depth
    iterations. This replaces the hand-tuned DEFAULT_OPS_PER_BOUNCE
    roofline anchor with a compiler-derived count. Returns None when the
    backend reports no cost model."""
    import jax.numpy as jnp
    from ..models import camera as cam_mod
    from ..ops.integrator import trace
    from . import rng as rtrng

    cam = cam_mod.derive(cam_cfg)
    w, h = cam_mod.image_size(cam_cfg)
    pix = jax.numpy.arange(w * h, dtype=jnp.int32)
    keys = rtrng.ray_keys(seed, pix, jnp.zeros_like(pix))
    org, dr, tm = cam_mod.generate_rays(cam, w, pix,
                                        jnp.asarray(0, jnp.int32), 1, keys)

    def f(flat, org, dr, tm, keys):
        return trace(flat, org, dr, tm, keys, cam.background,
                     max_depth=max_depth,
                     sky_gradient=getattr(cam_cfg, "sky_gradient", False))

    comp = jax.jit(f).lower(flat, org, dr, tm, keys).compile()
    try:
        cost = comp.cost_analysis()
        if isinstance(cost, list):          # some backends return [dict]
            cost = cost[0]
        flops = float(cost["flops"])
    except (TypeError, KeyError, IndexError):
        return None
    return flops / (w * h * max_depth)


@dataclasses.dataclass
class RenderStats:
    """Throughput report for one render (or bench rep)."""
    width: int
    height: int
    spp: int
    wall_s: float
    avg_depth: float = 6.0          # mean path length, not max_depth
    device_kind: str = ""

    @property
    def paths(self) -> int:
        return self.width * self.height * self.spp

    @property
    def paths_per_s(self) -> float:
        return self.paths / self.wall_s

    @property
    def rays_per_s(self) -> float:
        """Bounce rays per second: paths * average bounce count / wall."""
        return self.paths * self.avg_depth / self.wall_s

    def roofline_fraction(self,
                          ops_per_bounce: float = DEFAULT_OPS_PER_BOUNCE
                          ) -> float:
        """Fraction of the device's float32 peak this render achieved, given
        the per-bounce op cost model. Raises KeyError for an unknown
        device."""
        peak = peak_rates(self.device_kind)["f32_flops"]
        return self.rays_per_s * ops_per_bounce / peak

    def report(self) -> str:
        lines = [
            f"{self.width}x{self.height} @ {self.spp}spp in "
            f"{self.wall_s:.3f}s",
            f"  {self.paths_per_s / 1e6:.2f} Mpaths/s, "
            f"{self.rays_per_s / 1e6:.2f} Mrays/s "
            f"(avg depth {self.avg_depth:.1f})",
        ]
        if self.device_kind in PEAK_RATES:
            lines.append(f"  ~{100 * self.roofline_fraction():.1f}% of "
                         f"{self.device_kind} float32 peak")
        return "\n".join(lines)


def gpu_name_and_power_limit() -> str:
    """The cards' names and power limits, one line per card, as nvidia-smi
    reports them. A card may be set below its maximum power and then runs
    slower under load, so every device number is reported beside this."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def device_kind() -> str:
    try:
        return jax.devices()[0].device_kind
    except Exception:
        return ""


@contextlib.contextmanager
def timed(stats_kwargs: dict):
    """Context manager yielding a RenderStats filled with wall time:

        with timed(dict(width=w, height=h, spp=s)) as get:
            render(...)
        print(get().report())
    """
    box = {}
    t0 = time.perf_counter()

    def get() -> RenderStats:
        return box["stats"]

    yield get
    box["stats"] = RenderStats(wall_s=time.perf_counter() - t0,
                               device_kind=device_kind(), **stats_kwargs)


@contextlib.contextmanager
def profiler_trace(log_dir: str = "logs/jax_trace"):
    """jax.profiler trace around a render — open in TensorBoard/XProf.

    The analogue of the reference's (absent) per-phase profiling
    (SURVEY.md §5 item 1)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
