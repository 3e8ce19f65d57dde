"""Smoke test of the path tracer's main path on one GPU (or four).

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # the sharded render and trainer only

Drives the normal entry points (`rt.render`, the CLI, `ProgressiveRenderer`,
`make_train_step`, `render_on_mesh`) at the reference's default model: the
Cornell box, 600 px, depth 50 (reference CLI.hpp:11-13), with all five
trainable parameter families. Each phase prints its figures on its own line
and raises on failure. The last line of standard output is one JSON object,
`{"ok": true, "device": {...}}`, printed only when every phase passed.

Everything runs in this one process: a JAX process reserves most of the
card's memory, so no second one is started. The CPU backend of the same
process is the oracle for phases 3 and 5.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the CPU backend serves as the oracle beside the GPU
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import real_time_ray_tracing_engine_tpu as rt  # noqa: E402
from real_time_ray_tracing_engine_tpu.models import camera as cam_mod  # noqa
from real_time_ray_tracing_engine_tpu.models.render import (  # noqa: E402
    baked_render_pass)
from real_time_ray_tracing_engine_tpu.parallel import train  # noqa: E402
from real_time_ray_tracing_engine_tpu.parallel.mesh import (  # noqa: E402
    make_render_mesh, render_on_mesh, render_sharded)
from real_time_ray_tracing_engine_tpu.utils import (  # noqa: E402
    cli, profiling, refimage)
from real_time_ray_tracing_engine_tpu.utils.color import to_bytes  # noqa

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens", "reference")


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(tag, **figures):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in figures.items()),
          flush=True)


def cornell(width, spp, depth):
    s = rt.builders.cornell_box()
    s.camera.image_width = width
    s.camera.samples_per_pixel = spp
    s.camera.max_depth = depth
    return s


def relative_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ phases
def phase_device(require_gpu: bool = True) -> dict:
    """1. The device JAX found; refuses anything but a GPU."""
    dev = jax.devices()
    info = {"platform": dev[0].platform, "kind": dev[0].device_kind,
            "count": len(dev)}
    log("device", jax=jax.__version__, **info)
    if require_gpu and info["platform"] != "gpu":
        raise PhaseError(f"no GPU: JAX found {info['platform']!r} devices")
    return info


def phase_reference(names=tuple(refimage.SCENES)) -> dict:
    """2. Forward vs the independent C++ reference renderer's images."""
    out = {}
    for name in names:
        spp = refimage.SCENES[name][0]
        gold, meta, scene = refimage.load_golden(GOLDEN_DIR, name)
        img = rt.render(scene, spp=spp, seed=11, use_bvh=meta["use_bvh"],
                        samples_per_batch=spp)
        st = refimage.compare(np.asarray(to_bytes(img)), gold)
        log("reference", scene=name, spp=spp, use_bvh=meta["use_bvh"],
            mean_diff=f"{st['mean_diff']:.5f}", p99=f"{st['p99']:.5f}",
            rate=f"{st['rate']:.4f}", limits=refimage.SCENES[name][1:])
        check(refimage.passes(name, st), f"{name} off the reference: {st}")
        out[name] = st
    return out


# Relative size of the camera nudge that calibrates phases 3 and 5b: a few
# float32 ulps of the camera center.
NUDGE = 2e-7


def _sample_passes(scene, seed, device, nudge=0.0):
    """(spp, H, W, 3): each stratified sample's radiance, one pass each."""
    with jax.default_device(device):
        flat = rt.compile_scene(scene)
        cam = cam_mod.derive(scene.camera)
        cam = cam.replace(center=cam.center * (1.0 + nudge))
        w, h = cam_mod.image_size(scene.camera)
        ns = cam_mod.sqrt_spp(scene.camera)
        one = baked_render_pass(flat, width=w, height=h, tile_rows=h,
                                n_strata=ns, max_depth=scene.camera.max_depth,
                                sky_gradient=scene.camera.sky_gradient,
                                n_samples=1)
        return np.stack([np.asarray(one(cam, seed, k))
                         for k in range(ns * ns)])


def _agreement(a, b):
    """(share of paths, share of pixels) within atol 1e-3 of each other."""
    paths = float((np.abs(a - b).max(axis=-1) <= 1e-3).mean())
    pixels = float((np.abs(a.mean(0) - b.mean(0)).max(axis=-1)
                    <= 1e-3).mean())
    return paths, pixels


def phase_cpu_oracle(width=150, spp=16, depth=20, seed=11) -> dict:
    """3. The same render on the default device and on the CPU backend.

    The counter RNG gives both the same sample streams, but float32 paths
    are chaotic: an ulp of difference (FMA contraction, reassociation, the
    libraries' sin/cos/sqrt) sends a few paths elsewhere after bounces in
    the glass sphere, and each pixel averages spp paths. So the bound is on
    paths, and the pixel share is printed beside the CPU's own pixel share
    under a NUDGE of the camera center, which measures that chaos."""
    s = cornell(width, spp, depth)
    img = np.asarray(rt.render(s, seed=seed, samples_per_batch=spp))
    with jax.default_device(jax.devices("cpu")[0]):
        host = np.asarray(rt.render(cornell(width, spp, depth), seed=seed,
                                    samples_per_batch=spp))
    check(np.isfinite(img).all(), "non-finite radiance")
    rel_mean = abs(img.mean() - host.mean()) / host.mean()
    cpu = jax.devices("cpu")[0]
    dev_s = _sample_passes(s, seed, jax.devices()[0])
    cpu_s = _sample_passes(s, seed, cpu)
    paths, pixels = _agreement(dev_s, cpu_s)
    _, cpu_pixels = _agreement(cpu_s, _sample_passes(s, seed, cpu, NUDGE))
    log("cpu_oracle", width=width, spp=spp, depth=depth,
        mean=f"{img.mean():.6f}", cpu_mean=f"{host.mean():.6f}",
        rel_mean_diff=f"{rel_mean:.3e}", paths_within_atol=f"{paths:.5f}",
        pixels_within_atol=f"{pixels:.5f}",
        cpu_nudged_pixels_within_atol=f"{cpu_pixels:.5f}",
        limits="rel_mean<=0.005 paths_within_1e-3>=0.99")
    check(rel_mean <= 5e-3, f"mean radiance off by {rel_mean:.3e}")
    check(paths >= 0.99, f"only {paths:.4f} of paths within 1e-3")
    return dict(rel_mean=rel_mean, paths=paths, pixels=pixels,
                cpu_pixels=cpu_pixels)


def _finite_not_black(img, what):
    img = np.asarray(img)
    check(np.isfinite(img).all(), f"{what}: non-finite values")
    check(img.mean() > 1e-3, f"{what}: black image (mean {img.mean()})")


def phase_forward(width=600, spp=16, depth=50, steps=3) -> dict:
    """4. The CLI's static render and a ProgressiveRenderer session."""
    t0 = time.perf_counter()
    rc = cli.main(["--camera", "static", "--scene", "cornell_box",
                   "--width", str(width), "--samples", str(spp),
                   "--depth", str(depth), "--output", "chip_smoke_static"])
    t_cli = time.perf_counter() - t0
    check(rc == 0, f"CLI exit code {rc}")
    img = rt.read_ppm(os.path.join("output", "chip_smoke_static.ppm"))
    check(img.shape == (width, width, 3), f"CLI image shape {img.shape}")
    check(img.mean() > 1.0, "CLI image is black")

    prog = rt.ProgressiveRenderer(cornell(width, spp, depth))
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        prog.step()
        prog.acc.block_until_ready()
        times.append(time.perf_counter() - t0)
    _finite_not_black(prog.image(), "progressive")
    prog.move_camera((1.0, 0.0, 0.0))
    check(prog.samples_taken == 0, "camera move did not reset")
    prog.step()
    frame = prog.preview(80, 44)
    check(frame.shape == (44, 80, 3) and frame.mean() > 1.0,
          "preview frame is empty")
    log("forward", width=width, spp=spp, depth=depth,
        cli_wall_s_incl_compile=f"{t_cli:.3f}",
        progressive_first_step_s_incl_compile=f"{times[0]:.3f}",
        progressive_steady_step_s=f"{min(times[1:] or times):.4f}",
        cli_mean_byte=f"{img.mean():.3f}")
    return dict(cli_s=t_cli, step_s=times)


def _scene_params(width, spp, depth):
    s = cornell(width, spp, depth)
    flat = rt.compile_scene(s)
    w, h = cam_mod.image_size(s.camera)
    return s, flat, cam_mod.derive(s.camera), w, h, cam_mod.sqrt_spp(s.camera)


def phase_training(width=600, spp=16, depth=50, steps=3) -> dict:
    """5a. make_train_step with adam against a perturbed-tex_color target."""
    s, flat, cam, w, h, ns = _scene_params(width, spp, depth)
    mesh = make_render_mesh(1, 1, devices=jax.devices()[:1])
    kw = dict(mesh=mesh, width=w, height=h, n_strata=ns, max_depth=depth)
    params = train.get_params(flat)
    target_flat = flat.replace(tex_color=flat.tex_color * 0.8)
    target = render_sharded(target_flat, cam, 0, sky_gradient=False, **kw)
    opt = optax.adam(1e-2)
    step = train.make_train_step(opt, flat=flat, **kw)
    state = opt.init(params)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(params, state, None, cam, 0, target)
        losses.append(float(loss))
    wall = time.perf_counter() - t0
    finite = all(bool(np.isfinite(np.asarray(v)).all())
                 for v in params.values())
    log("train", width=w, height=h, spp=ns * ns, depth=depth,
        losses=[f"{x:.6g}" for x in losses], params_finite=finite,
        wall_s_incl_compile=f"{wall:.3f}")
    check(finite, "non-finite parameters after adam (non-finite gradient)")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return dict(losses=losses)


def _loss_grad(flat, cam, target, device, w, h, ns, depth):
    mesh = make_render_mesh(1, 1, devices=[device])
    put = lambda t: jax.device_put(t, device)  # noqa: E731
    return train.render_loss_grad(
        put(flat), put(cam), 0, put(target), mesh=mesh, width=w, height=h,
        n_strata=ns, max_depth=depth)


def phase_gradients(width=64, spp=4, depth=8) -> dict:
    """5b. Each family's gradient on the default device vs the CPU backend,
    and a tex_color central difference on the default device."""
    s, flat, cam, w, h, ns = _scene_params(width, spp, depth)
    target = jnp.zeros((h, w, 3), jnp.float32)
    _, g_dev = _loss_grad(flat, cam, target, jax.devices()[0], w, h, ns,
                          depth)
    cpu = jax.devices("cpu")[0]
    _, g_cpu = _loss_grad(flat, cam, target, cpu, w, h, ns, depth)
    nudged = cam.replace(center=cam.center * (1.0 + NUDGE))
    _, g_nudge = _loss_grad(flat, nudged, target, cpu, w, h, ns, depth)
    figures, failures = {}, []
    for f in train.TRAINABLE_FIELDS:
        a, b = np.asarray(g_dev[f]), np.asarray(g_cpu[f])
        if not np.isfinite(a).all():
            failures.append(f"non-finite {f} gradient")
        if not np.abs(b).any():          # family absent (Cornell: no metal)
            figures[f] = "zero_on_cpu"
            if np.abs(a).any():
                failures.append(f"{f}: zero on the CPU, not on the device")
            continue
        rel = relative_l2(a, b)
        # bounded by the CPU's own spread under the nudge (see phase 3)
        limit = max(1e-2, 4 * relative_l2(np.asarray(g_nudge[f]), b))
        figures[f] = f"{rel:.3e}(limit:{limit:.3e})"
        if rel > limit:
            failures.append(f"{f} gradient off the CPU by {rel:.3e}")
    log("grad_vs_cpu", width=w, spp=ns * ns, depth=depth, **figures)
    check(not failures, "; ".join(failures))
    out = dict(figures)

    # tex_color: the loss is a polynomial in the albedos and no sampling
    # decision depends on them, so a central difference is near-exact
    ti = int(np.argmax(np.abs(np.asarray(g_dev["tex_color"])[:, 0])))
    eps = 1e-3
    mesh = make_render_mesh(1, 1, devices=jax.devices()[:1])

    def loss_at(v):
        f2 = flat.replace(tex_color=flat.tex_color.at[ti, 0].set(v))
        img = render_sharded(f2, cam, 0, mesh=mesh, width=w, height=h,
                             n_strata=ns, max_depth=depth,
                             sky_gradient=False)
        return float(np.mean(np.asarray(img, np.float64) ** 2))

    v0 = np.asarray(flat.tex_color)[ti, 0]
    vp, vm = np.float32(v0 + eps), np.float32(v0 - eps)
    fd = (loss_at(vp) - loss_at(vm)) / (float(vp) - float(vm))
    ad = float(np.asarray(g_dev["tex_color"])[ti, 0])
    rel = abs(ad - fd) / abs(fd)
    log("grad_fd", row=ti, autodiff=f"{ad:.6g}", central_diff=f"{fd:.6g}",
        rel_diff=f"{rel:.3e}", limit="rel<=5e-3")
    check(rel <= 5e-3, f"tex_color autodiff {ad} vs central diff {fd}")
    out["fd_rel"] = rel
    return out


def phase_train_memory(width=1920, height=1080, spp=64, depth=50) -> dict:
    """5c. The train step at the fwd+bwd shape: compile, print its
    memory_analysis, run one step."""
    s = cornell(width, spp, depth)
    s.camera.aspect_ratio = width / height
    flat = rt.compile_scene(s)
    cam = cam_mod.derive(s.camera)
    w, h = cam_mod.image_size(s.camera)
    ns = cam_mod.sqrt_spp(s.camera)
    mesh = make_render_mesh(1, 1, devices=jax.devices()[:1])
    opt = optax.adam(1e-2)
    step = train.make_train_step(opt, mesh=mesh, width=w, height=h,
                                 n_strata=ns, max_depth=depth, flat=flat)
    params = train.get_params(flat)
    state = opt.init(params)
    target = jnp.zeros((h, w, 3), jnp.float32)
    t0 = time.perf_counter()
    compiled = step.lower(params, state, None, cam, 0, target).compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    figures = {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if mem is not None and hasattr(mem, k)}
    log("train_memory", width=w, height=h, spp=ns * ns, depth=depth,
        compile_s=f"{t_compile:.3f}", **figures)
    t0 = time.perf_counter()
    params, state, loss = compiled(params, state, None, cam, 0, target)
    loss = float(loss)
    t_step = time.perf_counter() - t0
    peak = jax.devices()[0].memory_stats() or {}
    log("train_step", loss=f"{loss:.6g}", step_s=f"{t_step:.3f}",
        mpaths_per_s=f"{w * h * ns * ns / t_step / 1e6:.4f}",
        peak_bytes_in_use=peak.get("peak_bytes_in_use", "n/a"))
    check(np.isfinite(loss), f"non-finite loss {loss}")
    return dict(compile_s=t_compile, step_s=t_step, memory=figures)


# An optimizer that leaves the parameters alone and keeps the step's
# gradient as its state: the trainer's exact gradient, with no update
# arithmetic in between.
_KEEP_GRADS = optax.GradientTransformation(
    init=lambda params: jax.tree.map(jnp.zeros_like, params),
    update=lambda grads, state, params=None: (
        jax.tree.map(jnp.zeros_like, grads), grads))


def phase_four_cards(width=600, spp=16, depth=50, devices=None) -> dict:
    """6. Sharded render and train step on a 2x2 ("tile", "sample") mesh vs
    a 1x1 mesh in the same process."""
    devices = devices if devices is not None else jax.devices()[:4]
    check(len(devices) == 4, f"needs 4 devices, found {len(devices)}")
    mesh4 = make_render_mesh(2, 2, devices=devices)
    mesh1 = make_render_mesh(1, 1, devices=devices[:1])
    s = cornell(width, spp, depth)
    img4 = np.asarray(render_on_mesh(s, mesh=mesh4))
    img1 = np.asarray(render_on_mesh(s, mesh=mesh1))
    check(np.isfinite(img4).all(), "non-finite sharded image")
    img_rel = float(np.max(np.abs(img4 - img1) / np.maximum(np.abs(img1),
                                                            1e-6)))
    img_ok = bool(np.allclose(img4, img1, rtol=1e-5, atol=1e-6))

    _, flat, cam, w, h, ns = _scene_params(width, spp, depth)
    params = train.get_params(flat)
    target = jnp.zeros((h, w, 3), jnp.float32)
    nudged = cam.replace(center=cam.center * (1.0 + NUDGE))
    grads, losses = {}, {}
    for name, mesh, c in (("2x2", mesh4, cam), ("1x1", mesh1, cam),
                          ("1x1_nudged", mesh1, nudged)):
        step = train.make_train_step(_KEEP_GRADS, mesh=mesh, width=w,
                                     height=h, n_strata=ns, max_depth=depth,
                                     flat=flat)
        _, kept, loss = step(params, _KEEP_GRADS.init(params), None, c, 0,
                             target)
        grads[name] = {f: np.asarray(kept[f]) for f in params}
        losses[name] = float(loss)
    ref = grads["1x1"]
    for f in ("tex_color", "mat_ior", "sph_center", "sph_radius"):
        check(np.abs(ref[f]).any(), f"no {f} gradient signal")
    # The backward recomputes each bounce inside programs shaped by the
    # mesh, so an ulp can differ, and float32 paths through the glass
    # sphere are chaotic (phase 3): the bound is the 1x1 gradient's own
    # spread under a NUDGE of the camera, and at least 1e-4.
    g_rel, limits = {}, {}
    for f in train.TRAINABLE_FIELDS:
        if not np.abs(ref[f]).any():
            g_rel[f] = float(np.abs(grads["2x2"][f]).max())
            limits[f] = 0.0
            continue
        g_rel[f] = relative_l2(grads["2x2"][f], ref[f])
        limits[f] = max(1e-4,
                        4 * relative_l2(grads["1x1_nudged"][f], ref[f]))
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    log("four_cards", mesh="2x2 vs 1x1", width=width, spp=spp, depth=depth,
        image_max_rel_diff=f"{img_rel:.3e}", image_allclose=img_ok,
        loss_2x2=losses["2x2"], loss_1x1=losses["1x1"],
        **{f"grad_rel_l2_{f}": f"{v:.3e}(limit:{limits[f]:.3e})"
           for f, v in g_rel.items()},
        peak_bytes_in_use=peaks)
    check(img_ok, f"sharded image off the single-card image ({img_rel})")
    for f, v in g_rel.items():
        check(v <= limits[f], f"sharded {f} gradient off by {v:.3e}")
    if devices[0].platform == "gpu":
        check(all(p and p > 0 for p in peaks), f"idle card: {peaks}")
    return dict(img_rel=img_rel, grad_rel=g_rel, peaks=peaks)


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded render/trainer on 4 cards")
    args = ap.parse_args(argv)
    try:
        info = phase_device()
        print(profiling.gpu_name_and_power_limit(), flush=True)
        phases = ([phase_four_cards] if args.four_cards else
                  [phase_reference, phase_cpu_oracle, phase_forward,
                   phase_training, phase_gradients, phase_train_memory])
        for phase in phases:
            t0 = time.perf_counter()
            phase()
            log("wall", phase=phase.__name__,
                seconds=f"{time.perf_counter() - t0:.3f}")
        count = 4 if args.four_cards else 1
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
