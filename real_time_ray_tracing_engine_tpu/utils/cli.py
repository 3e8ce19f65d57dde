"""CLI mirroring the reference raytracer's flags (src/input/CLI.cpp:4-126).

Reference flags -> equivalents here:
  --camera static|dynamic   static PPM render | progressive accumulation loop
  --output <name>           output/<name>.ppm
  -p/--parallel             shard the render over all devices (mesh DP),
                            replacing the reference's ThreadPool
  -b/--bvh                  wrap the scene in the flat SAH BVH
  -g/--gpu                  kept for parity: accelerator is the default here;
                            --cpu forces the host backend instead
  -d/--debug                dump flattened-scene golden JSON to logs/
                            (analogue of cpu_world_debug.json, Camera.cpp:75)
  --width/--samples/--depth workload overrides (defaults 600/100/50,
                            CLI.hpp:11-13)
plus --scene: builtin scene name or path to a scene JSON file.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="real_time_ray_tracing_engine_tpu",
        description="Differentiable Monte-Carlo path tracer in JAX")
    p.add_argument("--camera", choices=["static", "dynamic"], default="static",
                   help="static: render to PPM; dynamic: progressive loop")
    p.add_argument("--output", default="output_image",
                   help="output file stem (written to output/<name>.ppm)")
    p.add_argument("--scene", default="cornell_box",
                   help="builtin scene name or scene JSON path")
    p.add_argument("-p", "--parallel", action="store_true",
                   help="shard over all visible devices (device-mesh DP)")
    p.add_argument("-b", "--bvh", action="store_true",
                   help="use the flat SAH BVH acceleration structure")
    p.add_argument("-g", "--gpu", action="store_true",
                   help="accepted for reference parity (accelerator is "
                        "already the default backend)")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("-d", "--debug", action="store_true",
                   help="dump flattened scene golden JSON to logs/")
    p.add_argument("--width", type=int, default=None,
                   help="image width (default: scene's, reference default 600)")
    p.add_argument("--samples", type=int, default=None,
                   help="samples per pixel (reference default 100)")
    p.add_argument("--depth", type=int, default=None,
                   help="max bounce depth (reference default 50)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--checkpoint", default=None,
                   help="dynamic mode: save/resume accumulation state (.npz)")
    p.add_argument("--frames", type=int, default=None,
                   help="dynamic mode: max strata to accumulate this run")
    p.add_argument("--view", action="store_true",
                   help="dynamic mode: live ANSI terminal display with WASD "
                        "camera movement (the SDL-window analogue)")
    return p


def load_scene_arg(name: str):
    from ..scene import builders
    from ..scene.schema import load_scene
    if name in builders.BUILTIN_SCENES:
        return builders.BUILTIN_SCENES[name]()
    if os.path.exists(name):
        return load_scene(name)
    raise SystemExit(
        f"unknown scene {name!r}; builtins: "
        f"{', '.join(sorted(builders.BUILTIN_SCENES))}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    scene = load_scene_arg(args.scene)
    if args.width:
        scene.camera.image_width = args.width
    if args.samples:
        scene.camera.samples_per_pixel = args.samples
    if args.depth:
        scene.camera.max_depth = args.depth

    import numpy as np
    import real_time_ray_tracing_engine_tpu as rt
    from ..utils.color import write_ppm

    os.makedirs("output", exist_ok=True)
    out_path = os.path.join("output", args.output + ".ppm")

    if args.debug:
        os.makedirs("logs", exist_ok=True)
        from ..scene.compile import compile_scene, golden_json
        from ..scene.analyze import dump_report
        flat = compile_scene(scene, use_bvh=args.bvh)
        with open("logs/flat_scene_debug.json", "w") as f:
            f.write(golden_json(flat))
        dump_report(scene, flat, "logs/scene_complexity_debug.txt")
        print("[DEBUG] wrote logs/flat_scene_debug.json and "
              "logs/scene_complexity_debug.txt", file=sys.stderr)

    t0 = time.time()
    if args.camera == "static":
        if args.parallel:
            from ..parallel.mesh import render_on_mesh
            img = render_on_mesh(scene, use_bvh=args.bvh, seed=args.seed)
        else:
            img = rt.render(scene, use_bvh=args.bvh, seed=args.seed,
                            progress=lambda s, t: print(
                                f"\r[INFO] sample {s}/{t}", end="",
                                file=sys.stderr))
            print(file=sys.stderr)
        write_ppm(out_path, img)
    elif args.view:
        from ..models.viewer import run_viewer
        prog = run_viewer(scene, use_bvh=args.bvh, seed=args.seed,
                          max_frames=args.frames, checkpoint=args.checkpoint)
        write_ppm(out_path, prog.image())
    else:
        prog = rt.ProgressiveRenderer(scene, use_bvh=args.bvh, seed=args.seed)
        if args.checkpoint and os.path.exists(args.checkpoint):
            prog.load(args.checkpoint)
            print(f"[INFO] resumed at {prog.samples_taken} samples",
                  file=sys.stderr)
        frames = 0
        t_frame = time.time()
        while prog.step():
            frames += 1
            now = time.time()
            fps = 1.0 / max(now - t_frame, 1e-9)
            t_frame = now
            conv = " [Converged]" if prog.converged else ""
            print(f"\r[INFO] stratum {prog.samples_taken}/"
                  f"{prog.n_strata ** 2} {fps:5.1f} fps{conv}", end="",
                  file=sys.stderr)
            if args.frames and frames >= args.frames:
                break
        print(file=sys.stderr)
        if args.checkpoint:
            prog.save(args.checkpoint)
        write_ppm(out_path, prog.image())

    dt = time.time() - t0
    w, h, _ = np.asarray(rt.read_ppm(out_path)).shape
    print(f"[INFO] wrote {out_path} in {dt:.1f}s", file=sys.stderr)
    return 0
