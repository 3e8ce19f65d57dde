import os
import subprocess
import sys

import numpy as np
import pytest

import real_time_ray_tracing_engine_tpu as rt


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run_cli(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "real_time_ray_tracing_engine_tpu", *args],
        cwd=cwd, env=_cli_env(), capture_output=True, text=True, timeout=420)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cliwork")
    os.symlink(os.path.join(REPO, "real_time_ray_tracing_engine_tpu"),
               d / "real_time_ray_tracing_engine_tpu")
    return d


def test_cli_static_render(workdir):
    r = _run_cli(["--camera", "static", "--scene", "simple_sphere",
                  "--width", "64", "--samples", "4", "--depth", "4",
                  "--output", "t_static"], workdir)
    assert r.returncode == 0, r.stderr[-2000:]
    img = rt.read_ppm(str(workdir / "output" / "t_static.ppm"))
    assert img.shape == (36, 64, 3)
    assert img.mean() > 10  # not black


def test_cli_debug_dump_and_bvh(workdir):
    r = _run_cli(["--scene", "cornell_box", "--width", "32", "--samples", "1",
                  "--depth", "2", "-b", "-d", "--output", "t_bvh"], workdir)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (workdir / "logs" / "flat_scene_debug.json").exists()


def test_cli_dynamic_with_checkpoint(workdir):
    ckpt = str(workdir / "state.npz")
    r = _run_cli(["--camera", "dynamic", "--scene", "simple_sphere",
                  "--width", "48", "--samples", "9", "--depth", "3",
                  "--frames", "2", "--checkpoint", ckpt,
                  "--output", "t_dyn"], workdir)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(ckpt)
    # resume and converge
    r2 = _run_cli(["--camera", "dynamic", "--scene", "simple_sphere",
                   "--width", "48", "--samples", "9", "--depth", "3",
                   "--checkpoint", ckpt, "--output", "t_dyn2"], workdir)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed at 2 samples" in r2.stderr
    assert "Converged" in r2.stderr


def test_cli_scene_json_file(workdir):
    scene_path = str(workdir / "scene.json")
    s = rt.builders.three_spheres()
    s.camera.image_width = 40
    s.camera.samples_per_pixel = 4
    s.camera.max_depth = 3
    rt.save_scene(s, scene_path)
    r = _run_cli(["--scene", scene_path, "--output", "t_json"], workdir)
    assert r.returncode == 0, r.stderr[-2000:]
    img = rt.read_ppm(str(workdir / "output" / "t_json.ppm"))
    assert img.shape[1] == 40


def test_cli_unknown_scene_errors(workdir):
    r = _run_cli(["--scene", "nope"], workdir)
    assert r.returncode != 0
    assert "unknown scene" in r.stderr


def test_progressive_renderer_api():
    s = rt.builders.simple_sphere()
    s.camera.image_width = 32
    s.camera.samples_per_pixel = 4
    s.camera.max_depth = 3
    p = rt.ProgressiveRenderer(s)
    assert p.step() and p.samples_taken == 1
    img1 = np.asarray(p.image())
    assert img1.shape == (18, 32, 3)
    p.move_camera((0.5, 0, 0))
    assert p.samples_taken == 0  # camera move resets accumulation
    while p.step():
        pass
    assert p.converged and p.samples_taken == 4
    p.set_spp(9)
    assert p.samples_taken == 0 and p.n_strata == 3
