"""Comparison of a render against an image of the reference renderer.

The goldens (tests/goldens/reference/*.npz) are PPM renders produced by the
unmodified reference engine's CPU path (StaticCamera::render_cpu ->
Camera::ray_color, reference src/core/camera/StaticCamera.cpp:32-131,
Camera.cpp:232-309), compiled by scripts/build_reference.sh and driven over
this repo's JSON scenes by scripts/ref_driver.cpp;
scripts/gen_reference_goldens.py records the exact scene JSON and metadata
next to each golden.

Both images are Monte-Carlo estimates of the same integral, and the
reference's mt19937 streams are not reproducible (Utility.hpp:16-37), so
per-pixel equality is meaningless at any finite spp. Both images are pooled
into CELL x CELL blocks in gamma-2 byte space (what the reference PPM
stores), which averages noise down by ~CELL while keeping structure; the
checks are the cell-mean absolute difference and the fraction of cells
within ALLCLOSE_TOL. Tolerance budget per cell: reference-side noise
(spp >= 576 -> sigma_cell < ~0.001), our-side noise at the spp of SCENES
(sigma_cell ~ 0.004 on the noisiest scene), byte quantization (+-0.002) and
float32-vs-float64 integrator drift.

textured_spheres holds a Perlin marble sphere whose noise tables are random
in the reference (PerlinNoise.hpp:19-26), so parity there is distributional
(SURVEY.md hard part 6): its rate threshold is lower.
"""
from __future__ import annotations

import json
import os

import numpy as np

CELL = 10
ALLCLOSE_TOL = 0.04          # per-cell gamma-space tolerance (~10/255 bytes)

#            our_spp, mean_tol, min allclose rate
SCENES = {
    "simple_sphere": (36, 0.010, 0.97),
    "three_spheres": (36, 0.012, 0.97),
    "cornell_box": (36, 0.015, 0.95),
    "cornell_smoke": (36, 0.015, 0.95),
    "bouncing_spheres": (25, 0.015, 0.93),
    "textured_spheres": (25, 0.020, 0.85),
}


def pool(img: np.ndarray, cell: int = CELL) -> np.ndarray:
    h, w, _ = img.shape
    hc, wc = h // cell * cell, w // cell * cell
    x = img[:hc, :wc].reshape(hc // cell, cell, wc // cell, cell, 3)
    return x.mean(axis=(1, 3))


def load_golden(golden_dir: str, name: str):
    """(golden uint8 image, metadata dict, schema Scene) of one golden."""
    from ..scene.schema import load_scene
    gold = np.load(os.path.join(golden_dir, f"{name}.npz"))["image"]
    with open(os.path.join(golden_dir, f"{name}.json")) as f:
        meta = json.load(f)
    scene = load_scene(os.path.join(golden_dir, f"{name}_scene.json"))
    scene.camera.image_width = meta["width"]
    scene.camera.max_depth = meta["depth"]
    return gold, meta, scene


def compare(ours: np.ndarray, gold: np.ndarray) -> dict:
    """Pooled-cell statistics of two uint8 (H, W, 3) images."""
    if ours.shape != gold.shape:
        raise ValueError(f"shape {ours.shape} != golden {gold.shape}")
    a = pool(gold.astype(np.float32) / 255.0)
    b = pool(ours.astype(np.float32) / 255.0)
    diff = np.abs(a - b).mean(axis=-1)
    return dict(mean_diff=float(diff.mean()),
                p99=float(np.percentile(diff, 99)),
                rate=float((diff < ALLCLOSE_TOL).mean()))


def passes(name: str, stats: dict) -> bool:
    _, mean_tol, min_rate = SCENES[name]
    return stats["mean_diff"] < mean_tol and stats["rate"] >= min_rate
