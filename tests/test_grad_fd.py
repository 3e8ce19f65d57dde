"""Gradients through the trainer entry points vs central differences.

Each case takes one trainable family on one scene, gets the loss gradient
through `make_train_step` (plain SGD at rate 1, so the update is minus the
gradient) or `render_loss_grad`, and checks the entry with the largest
magnitude against a central difference of the same loss. The counter RNG
makes the sample streams independent of the parameters, so common random
numbers keep the difference free of Monte-Carlo noise. Geometry, fuzz and
IOR also move visibility edges, which the detached estimator does not
differentiate; their steps are small so that no sample crosses an edge.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from real_time_ray_tracing_engine_tpu.models import camera as cam_mod
from real_time_ray_tracing_engine_tpu.parallel import train
from real_time_ray_tracing_engine_tpu.parallel.mesh import (make_render_mesh,
                                                            render_sharded)
from real_time_ray_tracing_engine_tpu.scene.compile import compile_scene

import _scenes

# id, scene, field, use_bvh[, index, step]: without an index the entry with
# the largest gradient is checked. Where that entry sits on a visibility
# edge, a fixed entry on the continuous branch is named instead; on the
# marble sphere the turbulence octaves alias at steps above ~3e-4.
CASES = [
    ("cornell-tex", _scenes.cornell, "tex_color", False),
    ("all_families-tex", _scenes.all_families, "tex_color", False),
    ("all_families-fuzz", _scenes.all_families, "mat_fuzz", False),
    ("all_families-ior", _scenes.all_families, "mat_ior", False),
    ("all_families-center", _scenes.all_families, "sph_center", False),
    ("all_families-radius", _scenes.all_families, "sph_radius", False),
    ("cornell_smoke-tex", _scenes.cornell_smoke, "tex_color", False),
    ("spheres80-tex", _scenes.spheres80, "tex_color", False),
    ("spheres40_textures-tex", _scenes.spheres40_textures, "tex_color",
     False),
    ("bouncing-tex", _scenes.bouncing, "tex_color", False),
    ("spheres78-fuzz", _scenes.spheres78_families, "mat_fuzz", False),
    ("spheres78-ior", _scenes.spheres78_families, "mat_ior", False),
    ("spheres78-center", _scenes.spheres78_families, "sph_center", False,
     (7, 1), 1e-3),
    ("spheres78-radius", _scenes.spheres78_families, "sph_radius", False,
     (7,), 1e-3),
    ("mixed_bvh-tex", _scenes.mixed_bvh, "tex_color", True),
    ("lambertian78-center", _scenes.spheres78_lambertian, "sph_center",
     False, (0, 1), 1e-3),
    ("checker_noise-tex", _scenes.checker_noise, "tex_color", False),
    ("checker_noise-center", _scenes.checker_noise, "sph_center", False,
     (1, 1), 2.5e-4),
    ("box_city-tex", _scenes.box_city, "tex_color", False),
    ("box_city-fuzz", _scenes.box_city, "mat_fuzz", False),
    ("box_city-center", _scenes.box_city, "sph_center", False, (0, 1),
     1e-3),
    ("box_city-radius", _scenes.box_city, "sph_radius", False, (0,), 1e-3),
]

STEP = {"tex_color": 1e-3, "mat_fuzz": 1e-4, "mat_ior": 1e-4,
        "sph_center": 1e-4, "sph_radius": 1e-4}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gradient_matches_central_difference(case):
    cid, scene_fn, field, use_bvh = case[:4]
    scene = scene_fn()
    flat = compile_scene(scene, use_bvh=use_bvh)
    cam = cam_mod.derive(scene.camera)
    w, h = cam_mod.image_size(scene.camera)
    kw = dict(mesh=make_render_mesh(1, 1, devices=jax.devices()[:1]),
              width=w, height=h, n_strata=cam_mod.sqrt_spp(scene.camera),
              max_depth=scene.camera.max_depth)
    sky = scene.camera.sky_gradient
    target = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (h, w, 3)),
                         jnp.float32)
    params = train.get_params(flat)
    # alternate the two trainer entry points over the cases
    if CASES.index(case) % 2 == 0:
        opt = optax.sgd(1.0)
        step = train.make_train_step(opt, flat=flat, sky_gradient=sky, **kw)
        new, _, _ = step(params, opt.init(params), None, cam, 0, target)
        grad = np.asarray(params[field]) - np.asarray(new[field])
    else:
        _, grads = train.render_loss_grad(flat, cam, 0, target,
                                          sky_gradient=sky, **kw)
        grad = np.asarray(grads[field])
    assert np.isfinite(grad).all()
    idx, eps = (case[4:] if len(case) > 4 else
                (np.unravel_index(np.argmax(np.abs(grad)), grad.shape),
                 STEP[field]))
    assert abs(grad[idx]) > 1e-5, (cid, "no signal")

    arr = np.asarray(getattr(flat, field))
    vp, vm = np.float32(arr[idx] + eps), np.float32(arr[idx] - eps)

    def loss_at(v):
        a = arr.copy()
        a[idx] = v
        img = render_sharded(flat.replace(**{field: jnp.asarray(a)}), cam, 0,
                             sky_gradient=sky, **kw)
        return np.mean((np.asarray(img, np.float64)
                        - np.asarray(target, np.float64)) ** 2)

    fd = (loss_at(vp) - loss_at(vm)) / (float(vp) - float(vm))
    np.testing.assert_allclose(grad[idx], fd, rtol=2e-2,
                               atol=1e-3 * abs(fd), err_msg=f"{cid} {idx}")
