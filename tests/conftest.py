"""Test configuration: force a real CPU backend with 8 virtual devices so
sharding tests run without accelerator hardware (SURVEY.md §4: jax.make_mesh
on CPU).

Every test here runs on the CPU. Tests that need the GPU carry the `gpu`
marker and the `gpu` fixture below, which skips them when JAX finds no GPU;
`python chip_smoke.py` and `python bench.py` are what run on the card.

The persistent compilation cache follows the package's rule
(real_time_ray_tracing_engine_tpu/__init__.py): JAX_COMPILATION_CACHE_DIR if
set, else one fixed directory inside the checkout.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402
import numpy as np  # noqa: E402

import real_time_ray_tracing_engine_tpu  # noqa: E402,F401  (cache rule)


@pytest.fixture(scope="session")
def rt():
    import real_time_ray_tracing_engine_tpu as rt
    return rt


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX finds none (decided here,
    at run time, never while a module is imported)."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU; run on the card")
    return devices
