"""Differentiable Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
`prabhask5/real-time-ray-tracing-engine` (C++/CUDA): MIS path tracing,
five material families, procedural textures, constant-density volumes,
SAH BVH, progressive rendering, and multi-device scaling via jax.sharding.
"""
import os as _os

import jax as _jax

# Persistent compilation cache: the render/train graphs (depth-50 scan +
# fori_loop bodies) are XLA-compile-bound; caching makes repeat CLI/bench
# invocations start in seconds instead of minutes. Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself; otherwise the cache
# lives at one fixed path inside the checkout (the path is part of the
# cache's key, so it must not move between runs).
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_compile_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .scene.schema import (Scene, CameraConfig, Sphere, Quad, Box, Translate,
                           RotateY, Group, ConstantMedium, Lambertian, Metal,
                           Dielectric, DiffuseLight, Isotropic, SolidColor,
                           Checker, Noise, load_scene, save_scene,
                           scene_to_json, scene_from_json)
from .scene.compile import compile_scene, golden_json
from .scene.flat import FlatScene
from .scene import builders
from .models.render import render, ProgressiveRenderer
from .models import camera
from .ops.integrator import trace
from .utils.color import write_ppm, read_ppm, to_bytes

__version__ = "0.1.0"
