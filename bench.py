"""Benchmark: path-tracing throughput on the GPU, through the plain JAX path.

Prints ONE JSON line. The headline is fwd+bwd Mpaths/s: a differentiable
Cornell render at 1920x1080, 64 spp, depth 50, one full loss -> gradient ->
adam step over ALL trainable parameter families (BASELINE.json north star).
Paths are counted once, so the value compares with forward-only numbers.
The same line carries two more workloads:
  forward_*  — Cornell 600x600, 16 spp, depth 50 (the reference's default
               scene and depth, CLI.hpp:11-13), forward only;
  bouncing_* — bouncing_spheres (485 prims) 400x225, 9 spp, depth 50,
               fwd+bwd over every family (4,236 trainable scalars).
Each workload is compiled and run once untimed, then timed over REPS runs
that end in block_until_ready; compile time is reported as set-up.

Exits non-zero unless JAX's first device is a GPU: a number taken on
another backend is not a number for this card.
"""
import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax

REPS = 3


def _timed(fn, reps=REPS):
    """(first-call seconds incl. compile, mean seconds of `reps` calls)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / reps, out


def bench_forward(width=600, spp=16, depth=50):
    import real_time_ray_tracing_engine_tpu as rt

    scene = rt.builders.cornell_box()
    scene.camera.image_width = width
    scene.camera.samples_per_pixel = spp
    scene.camera.max_depth = depth
    flat = rt.compile_scene(scene)
    w, h = rt.camera.image_size(scene.camera)
    first, dt, img = _timed(lambda: rt.render(flat, scene.camera,
                                              samples_per_batch=spp))
    assert np.isfinite(np.asarray(img)).all(), "non-finite radiance"
    return {"metric": f"cornell_{w}x{h}_spp{spp}_d{depth}_forward",
            "value": w * h * spp / dt / 1e6, "compile_s": first - dt}


def bench_fwd_bwd(scene, width, height, n_strata, depth):
    import real_time_ray_tracing_engine_tpu as rt
    from real_time_ray_tracing_engine_tpu.parallel import train
    from real_time_ray_tracing_engine_tpu.parallel.mesh import \
        make_render_mesh

    scene.camera.image_width = width
    scene.camera.aspect_ratio = width / height
    flat = rt.compile_scene(scene)
    cam = rt.camera.derive(scene.camera)
    w, h = rt.camera.image_size(scene.camera)
    opt = optax.adam(1e-3)
    step = train.make_train_step(
        opt, mesh=make_render_mesh(1, 1, devices=jax.devices()[:1]),
        width=w, height=h, n_strata=n_strata, max_depth=depth, flat=flat)
    params = train.get_params(flat)          # ALL trainable families
    state = opt.init(params)
    target = jnp.zeros((h, w, 3), jnp.float32)
    first, dt, (_, _, loss) = _timed(
        lambda: step(params, state, None, cam, 0, target), reps=2)
    assert np.isfinite(float(loss)), "non-finite loss"
    n_params = sum(int(np.size(v)) for v in params.values())
    spp = n_strata * n_strata
    return {"metric": f"{scene.name}_{w}x{h}_spp{spp}_d{depth}_fwd_bwd_"
                      f"{n_params}_params",
            "value": w * h * spp / dt / 1e6, "compile_s": first - dt}


def main() -> int:
    import real_time_ray_tracing_engine_tpu as rt
    from real_time_ray_tracing_engine_tpu.utils.profiling import \
        gpu_name_and_power_limit

    dev = jax.devices()
    if dev[0].platform != "gpu":
        print(f"bench.py: no GPU (JAX found {dev[0].platform!r})",
              file=sys.stderr)
        return 2
    card = gpu_name_and_power_limit()
    head = bench_fwd_bwd(rt.builders.cornell_box(), 1920, 1080, 8, 50)
    fwd = bench_forward()
    bounce = bench_fwd_bwd(rt.builders.bouncing_spheres(), 400, 225, 3, 50)
    line = {"metric": head["metric"], "value": head["value"],
            "unit": "Mpaths/s", "compile_s": head["compile_s"],
            "forward_metric": fwd["metric"], "forward_value": fwd["value"],
            "forward_compile_s": fwd["compile_s"],
            "bouncing_metric": bounce["metric"],
            "bouncing_value": bounce["value"],
            "bouncing_compile_s": bounce["compile_s"],
            "device": {"platform": dev[0].platform,
                       "kind": dev[0].device_kind, "count": len(dev)},
            "card": card}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
