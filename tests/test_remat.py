"""The rematerialized backward (per sample and per bounce) is the same
function as the plain reverse mode that stores every residual."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from real_time_ray_tracing_engine_tpu.models import camera as cam_mod
from real_time_ray_tracing_engine_tpu.parallel import train
from real_time_ray_tracing_engine_tpu.parallel.mesh import _tile_sample_render
from real_time_ray_tracing_engine_tpu.scene.compile import compile_scene

import _scenes


def _vjp(flat, cam, w, h, g):
    def render(p):
        return _tile_sample_render(
            train.set_params(flat, p), cam, jnp.uint32(3), width=w,
            height_local=h, row0=jnp.int32(0), n_strata=2, spp_local=4,
            sample0=jnp.int32(0), max_depth=4, sky_gradient=False)

    _, vjp = jax.vjp(render, train.get_params(flat))
    return jax.tree.map(np.asarray, vjp(g)[0])


@pytest.fixture(scope="module")
def both():
    scene = _scenes.all_families(16)
    flat = compile_scene(scene)
    cam = cam_mod.derive(scene.camera)
    w, h = cam_mod.image_size(scene.camera)
    g = jnp.asarray(np.random.default_rng(2).normal(size=(h, w, 3)),
                    jnp.float32)
    remat = _vjp(flat, cam, w, h, g)
    # the plain reverse mode: every jax.checkpoint becomes the identity
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "checkpoint", lambda f, *a, **k: f)
        jax.clear_caches()
        plain = _vjp(flat, cam, w, h, g)
    jax.clear_caches()
    return remat, plain


@pytest.mark.parametrize("field", train.TRAINABLE_FIELDS)
def test_remat_backward_equals_plain_vjp(both, field):
    remat, plain = both
    assert np.abs(plain[field]).max() > 0
    np.testing.assert_allclose(remat[field], plain[field], rtol=1e-5,
                               atol=1e-6 * np.abs(plain[field]).max())


def test_backward_is_rematerialized():
    """Both the sample scan and the bounce loop carry a checkpoint."""
    scene = _scenes.cornell(8)
    flat = compile_scene(scene)
    cam = cam_mod.derive(scene.camera)

    def loss(p):
        return _tile_sample_render(
            train.set_params(flat, p), cam, jnp.uint32(0), width=8,
            height_local=8, row0=jnp.int32(0), n_strata=1, spp_local=2,
            sample0=jnp.int32(0), max_depth=2, sky_gradient=False).sum()

    text = str(jax.make_jaxpr(jax.grad(loss))(train.get_params(flat)))
    assert text.count("checkpoint[") + text.count("remat") >= 2, text[:2000]
