"""Differentiable rendering: optimize scene parameters against target images.

This is the capability the reference cannot have (C++/CUDA, no autodiff) and
the north star of this build (BASELINE.json): the whole estimator —
camera rays, intersection, MIS shading, accumulation — is traced JAX, so
`jax.grad` flows from pixel loss back to continuous scene parameters
(material albedo/textures via `tex_color`, metal fuzz, dielectric IOR,
emission, sphere centers/radii). Sampling decisions (which light, which
stratum) use counter-based draws whose *probabilities* are parameter-free, so
the estimator is differentiable in the detached-sampling sense: gradients are
unbiased for continuous shading terms and reparameterized through
intersection t(theta) for geometry.

Across a mesh the loss is computed on row-shards; shard_map's transpose
inserts the gradient psum over devices automatically — the "all-reduce
gradients overlapped with backward" of the north star.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from ..scene.flat import FlatScene
from .mesh import render_sharded

# Continuous, safely-differentiable scene parameters.
TRAINABLE_FIELDS = ("tex_color", "mat_fuzz", "mat_ior", "sph_center",
                    "sph_radius")


def get_params(flat: FlatScene) -> dict:
    return {k: getattr(flat, k) for k in TRAINABLE_FIELDS}


def set_params(flat: FlatScene, params: dict) -> FlatScene:
    return flat.replace(**params)


def make_train_step(optimizer: optax.GradientTransformation, *, mesh, width,
                    height, n_strata, max_depth, sky_gradient=False,
                    flat: FlatScene | None = None):
    """Build a jitted SGD step: params -> rendered image -> L2 loss -> update.

    The returned step has signature
      step(params, opt_state, flat, cam, seed, target) ->
          (params, opt_state, loss)

    Pass `flat` at build time to bake the NON-trainable scene tables in as
    compile-time constants (see models.render.baked_render_pass); trainable
    params stay traced. The per-step flat argument is then ignored (pass
    None). The backward rematerializes per sample and per bounce
    (mesh._tile_sample_render, integrator.trace), so its memory is one
    bounce carry per bounce of one sample, not every residual of the scan.
    """
    baked = flat

    def loss_fn(params, flat, cam, seed, target):
        base = baked if baked is not None else flat
        img = render_sharded(
            set_params(base, params), cam, seed, mesh=mesh, width=width,
            height=height, n_strata=n_strata, max_depth=max_depth,
            sky_gradient=sky_gradient)
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(params, opt_state, flat, cam, seed, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, flat, cam, seed,
                                                  target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def render_loss_grad(flat: FlatScene, cam, seed, target, *, mesh, width,
                     height, n_strata, max_depth, sky_gradient=False):
    """One-shot loss + parameter gradients (no optimizer state)."""

    def loss_fn(params):
        img = render_sharded(
            set_params(flat, params), cam, seed, mesh=mesh, width=width,
            height=height, n_strata=n_strata, max_depth=max_depth,
            sky_gradient=sky_gradient)
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(get_params(flat))
