"""Image validation against the ACTUAL reference renderer.

The goldens, the pooled-cell metric and the per-scene thresholds are
documented in real_time_ray_tracing_engine_tpu/utils/refimage.py.
"""
import os

import numpy as np
import pytest

import real_time_ray_tracing_engine_tpu as rt
from real_time_ray_tracing_engine_tpu.utils import refimage
from real_time_ray_tracing_engine_tpu.utils.color import to_bytes

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens", "reference")


@pytest.mark.parametrize("name", list(refimage.SCENES))
def test_matches_reference_render(name):
    spp, mean_tol, min_rate = refimage.SCENES[name]
    gold, meta, scene = refimage.load_golden(GOLDEN_DIR, name)
    ours = np.asarray(to_bytes(rt.render(scene, spp=spp, seed=11)))
    st = refimage.compare(ours, gold)
    print(f"[ref-image] {name}: cell mean |diff|={st['mean_diff']:.4f} "
          f"p99={st['p99']:.4f} allclose rate={st['rate']:.3f}")
    assert st["mean_diff"] < mean_tol, (name, st)
    assert st["rate"] >= min_rate, (name, st)


def test_textured_marble_distributional():
    """The Perlin marble sphere can't match pointwise (reference tables are
    random); check its projected region matches in mean reflectance."""
    gold, meta, scene = refimage.load_golden(GOLDEN_DIR, "textured_spheres")
    ours = np.asarray(to_bytes(rt.render(scene, spp=25, seed=11)))
    # marble sphere at (0, 2.5, 2) r=1 projects to the upper-center of the
    # 200x112 frame; locate it by the region bounds under this camera
    region = np.s_[8:38, 88:124]
    g = gold[region].astype(np.float32).mean() / 255.0
    o = ours[region].astype(np.float32).mean() / 255.0
    assert abs(g - o) < 0.08, (g, o)
