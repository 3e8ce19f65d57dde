"""Terminal viewer: frame encoding + non-interactive loop + CLI --view.

Covers the DynamicCamera-window replacement (models/viewer.py): ANSI
half-block frame generation, the progressive loop stepping/converging with a
non-TTY stdin, and checkpoint save on exit.
"""
import io
import os

import numpy as np

from real_time_ray_tracing_engine_tpu.models.viewer import (frame_to_ansi,
                                                            run_viewer)
from real_time_ray_tracing_engine_tpu.scene import builders


def test_frame_to_ansi_shapes_and_colors():
    img = np.zeros((8, 8, 3), np.uint8)
    img[:4] = [255, 0, 0]        # top half red
    img[4:] = [0, 0, 255]        # bottom half blue
    text = frame_to_ansi(img, cols=4, rows=2)
    lines = text.split("\n")
    assert len(lines) == 2
    assert "38;2;255;0;0" in lines[0]        # red foreground upper pixels
    assert "48;2;0;0;255" in lines[1]        # blue background lower pixels
    assert lines[0].count("▀") == 4


def test_run_viewer_non_interactive(tmp_path):
    scene = builders.cornell_box()
    scene.camera.image_width = 16
    scene.camera.samples_per_pixel = 4       # 2x2 strata
    scene.camera.max_depth = 2
    ckpt = str(tmp_path / "view.npz")
    buf = io.StringIO()
    prog = run_viewer(scene, max_frames=2, checkpoint=ckpt, out=buf,
                      adaptive=False)
    assert prog.samples_taken == 2
    assert os.path.exists(ckpt)
    text = buf.getvalue()
    assert "fps" in text and "▀" in text
    # resume from the checkpoint and converge
    buf2 = io.StringIO()
    prog2 = run_viewer(scene, checkpoint=ckpt, out=buf2)
    assert prog2.converged and prog2.samples_taken == 4
    assert "Converged" in buf2.getvalue()
    img = np.asarray(prog2.image())
    assert np.isfinite(img).all() and img.mean() > 0


def test_adaptive_work_controller_converges():
    """AdaptiveWork (the reference's FPS-keyed tile-resize analogue,
    DynamicCamera.cpp:190-193): fed a fake frame clock where each sample
    costs a fixed wall time, the controller must settle inside the
    [FPS_LO, FPS_HI] band — doubling work when fast, halving when slow —
    and respect its [1, cap] clamp."""
    from real_time_ray_tracing_engine_tpu.models.viewer import AdaptiveWork

    ctrl = AdaptiveWork(cap=16)
    sample_cost = 0.008           # 8 ms per stratum -> 125 fps at k=1
    ks = []
    for _ in range(12):
        fps = 1.0 / (ctrl.k * sample_cost)
        ks.append(ctrl.update(fps))
    # settles at k=4 (31 fps) oscillating with k=8 (16 fps) — inside band
    assert max(ks) <= 16 and min(ks) >= 1
    tail = ks[-6:]
    assert all(1.0 / (k * sample_cost) >= AdaptiveWork.FPS_LO for k in tail)
    assert set(tail) <= {4, 8}

    slow = AdaptiveWork(cap=16)
    slow.k = 16
    for _ in range(8):
        slow.update(1.0 / (slow.k * 0.2))      # 200 ms per stratum
    assert slow.k == 1                         # halves to the floor

    fast = AdaptiveWork(cap=8)
    for _ in range(8):
        fast.update(1000.0)
    assert fast.k == 8                         # clamped at cap


def test_progressive_step_k():
    """ProgressiveRenderer.step(k) renders k strata in one fused pass and
    matches k single steps (regeneration keeps per-sample streams intact)."""
    from real_time_ray_tracing_engine_tpu.models.render import \
        ProgressiveRenderer
    scene = builders.cornell_box()
    scene.camera.image_width = 16
    scene.camera.samples_per_pixel = 4
    scene.camera.max_depth = 2
    a = ProgressiveRenderer(scene)
    a.step(3)
    a.step(3)                     # clamped to the 1 remaining stratum
    assert a.converged and a.samples_taken == 4
    b = ProgressiveRenderer(scene)
    while b.step():
        pass
    np.testing.assert_allclose(np.asarray(a.image()), np.asarray(b.image()),
                               rtol=1e-5, atol=1e-6)


def test_preview_matches_host_downsample(rt):
    """ProgressiveRenderer.preview (device-side downsample+gamma fetch)
    must equal the host path byte-for-byte:
    nearest-neighbor selection commutes with the per-pixel gamma/clamp."""
    import numpy as np
    from real_time_ray_tracing_engine_tpu.models.render import \
        ProgressiveRenderer
    from real_time_ray_tracing_engine_tpu.models.viewer import _downsample
    from real_time_ray_tracing_engine_tpu.utils.color import to_bytes

    s = rt.builders.simple_sphere()
    s.camera.image_width = 48
    prog = ProgressiveRenderer(s)
    prog.step(2)
    got = prog.preview(20, 14)
    want = _downsample(np.asarray(to_bytes(prog.image())), 20, 14)
    np.testing.assert_array_equal(got, want)
