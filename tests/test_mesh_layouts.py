"""Mesh-layout invariance on the 8-device CPU mesh: the sharded render and
the trainer's gradients must not depend on how the ("tile", "sample") mesh
splits rows and samples. The counter RNG keys every (pixel, sample) pair,
so only the order of the psum over shards differs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from real_time_ray_tracing_engine_tpu.models import camera as cam_mod
from real_time_ray_tracing_engine_tpu.parallel import train
from real_time_ray_tracing_engine_tpu.parallel.mesh import (make_render_mesh,
                                                            render_sharded)
from real_time_ray_tracing_engine_tpu.scene.compile import compile_scene

import _scenes

LAYOUTS = [(1, 8), (2, 4), (4, 2), (8, 1)]


@pytest.fixture(scope="module")
def setup():
    scene = _scenes.all_families(16)
    scene.camera.samples_per_pixel = 16       # divisible by every sample axis
    flat = compile_scene(scene)
    cam = cam_mod.derive(scene.camera)
    w, h = cam_mod.image_size(scene.camera)
    kw = dict(width=w, height=h, n_strata=4, max_depth=4)
    target = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (h, w, 3)),
                         jnp.float32)
    one = make_render_mesh(1, 1, devices=jax.devices()[:1])
    img = np.asarray(render_sharded(flat, cam, 0, mesh=one,
                                    sky_gradient=False, **kw))
    _, grads = train.render_loss_grad(flat, cam, 0, target, mesh=one, **kw)
    return flat, cam, kw, target, img, grads


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_render_equals_single_device(setup, layout):
    flat, cam, kw, _, ref, _ = setup
    mesh = make_render_mesh(*layout)
    img = render_sharded(flat, cam, 0, mesh=mesh, sky_gradient=False, **kw)
    assert len(img.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(img), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gradients_invariant_to_layout(setup, layout):
    flat, cam, kw, target, _, ref = setup
    _, grads = train.render_loss_grad(flat, cam, 0, target,
                                      mesh=make_render_mesh(*layout), **kw)
    for f in train.TRAINABLE_FIELDS:
        a, b = np.asarray(grads[f]), np.asarray(ref[f])
        assert np.abs(b).max() > 0, f
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= 1e-4, (f, rel)
