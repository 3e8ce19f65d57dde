"""Support code: the pytree dataclass helper, the compile-cache rule and the
device peak table."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from real_time_ray_tracing_engine_tpu.utils import profiling, pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytree.dataclass
class _Rec:
    a: jnp.ndarray
    b: jnp.ndarray = None
    n: int = pytree.static_field(default=3)


def test_dataclass_flatten_unflatten_roundtrip():
    r = _Rec(a=jnp.arange(3.0), b=jnp.ones(2), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(r)
    assert len(leaves) == 2
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, _Rec) and back.n == 5
    np.testing.assert_array_equal(back.a, r.a)
    doubled = jax.tree.map(lambda x: 2 * x, r)
    np.testing.assert_array_equal(doubled.b, 2 * r.b)


def test_dataclass_static_fields_live_in_treedef():
    r3, r4 = _Rec(a=jnp.zeros(2), n=3), _Rec(a=jnp.zeros(2), n=4)
    assert (jax.tree_util.tree_structure(r3)
            != jax.tree_util.tree_structure(r4))
    traces = []

    @jax.jit
    def f(r):
        traces.append(r.n)                  # runs only while tracing
        return r.a + r.n

    np.testing.assert_array_equal(f(r3), [3.0, 3.0])
    np.testing.assert_array_equal(f(r4), [4.0, 4.0])
    f(r3)
    assert traces == [3, 4]                 # a static value is a cache key


def test_dataclass_replace_and_frozen():
    r = _Rec(a=jnp.zeros(2))
    r2 = r.replace(n=7, b=jnp.ones(1))
    assert (r.n, r.b) == (3, None)
    assert r2.n == 7 and r2.b.shape == (1,)
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.n = 1


def _cache_dir_in_subprocess(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", "import real_time_ray_tracing_engine_tpu, jax;"
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd="/", capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_fixed_path_in_checkout():
    assert (_cache_dir_in_subprocess({})
            == os.path.join(REPO, ".jax_compile_cache"))


def test_compile_cache_honours_env(tmp_path):
    d = str(tmp_path / "cache")
    assert _cache_dir_in_subprocess({"JAX_COMPILATION_CACHE_DIR": d}) == d


def test_peak_rates_h100():
    peaks = profiling.peak_rates("NVIDIA H100 80GB HBM3")
    assert peaks == {"f32_flops": 67e12, "hbm_bytes": 3.35e12}
    st = profiling.RenderStats(width=100, height=100, spp=10, wall_s=1.0,
                               avg_depth=5.0,
                               device_kind="NVIDIA H100 80GB HBM3")
    assert st.roofline_fraction(ops_per_bounce=1000.0) == pytest.approx(
        1e5 * 5.0 * 1000.0 / 67e12)
    assert "float32 peak" in st.report()


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB"])
def test_peak_rates_unknown_device_is_error(kind):
    with pytest.raises(KeyError, match="no published peak"):
        profiling.peak_rates(kind)
    st = profiling.RenderStats(width=1, height=1, spp=1, wall_s=1.0,
                               device_kind=kind)
    with pytest.raises(KeyError):
        st.roofline_fraction()
    assert "peak" not in st.report()
