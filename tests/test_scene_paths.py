"""Render-path equivalences on scenes covering each structural case (media,
textures, every material, many lights, hundreds of prims): the BVH path
equals brute force, the image does not depend on the row tiling, and
progressive strata equal batch samples."""
import numpy as np
import pytest

import real_time_ray_tracing_engine_tpu as rt

import _scenes

NAMES = list(_scenes.STRUCTURE_SCENES)


def _assert_same_estimate(a, b, frac_tol=0.01):
    """Identical sample streams: every pixel agrees except a small share of
    discrete branch flips (t-comparison ties on last-ulp differences)."""
    assert np.isfinite(a).all() and np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=-1)
    assert (diff > 1e-3).mean() < frac_tol, (diff.max(), (diff > 1e-3).mean())
    assert abs(a.mean() - b.mean()) < 2e-3


@pytest.mark.parametrize("name", NAMES)
def test_bvh_matches_brute_force(name):
    scene = _scenes.STRUCTURE_SCENES[name]()
    brute = np.asarray(rt.render(scene, seed=5))
    bvh = np.asarray(rt.render(scene, seed=5, use_bvh=True))
    assert brute.mean() > 1e-3                  # the scene is lit
    _assert_same_estimate(bvh, brute)


@pytest.mark.parametrize("name", NAMES)
def test_image_invariant_to_tile_rows(name):
    scene = _scenes.STRUCTURE_SCENES[name]()
    w, h = rt.camera.image_size(scene.camera)
    whole = np.asarray(rt.render(scene, seed=2, tile_rows=h))
    # 5 rows: more than one tile, and a last tile padded past the image
    tiled = np.asarray(rt.render(scene, seed=2, tile_rows=5))
    np.testing.assert_allclose(tiled, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["cornell", "cornell_smoke"])
def test_progressive_stratum_equals_batch_sample(name):
    """k single-stratum steps, one k-stratum step and the batch render take
    the same per-(pixel, sample) streams."""
    scene = (_scenes.cornell(24) if name == "cornell"
             else _scenes.cornell_smoke(24))
    singles = rt.ProgressiveRenderer(scene, seed=4)
    while singles.step(1):
        pass
    fused = rt.ProgressiveRenderer(scene, seed=4)
    assert fused.step(2) and fused.samples_taken == 2
    assert fused.step(2) and fused.converged
    batch = np.asarray(rt.render(scene, seed=4, samples_per_batch=4))
    np.testing.assert_allclose(np.asarray(fused.image()),
                               np.asarray(singles.image()),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(singles.image()), batch,
                               rtol=1e-5, atol=1e-5)
