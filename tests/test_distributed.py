"""Multi-host scaffolding (parallel/distributed.py) on the 8-device CPU mesh.

The real multi-controller bring-up needs N processes; what IS testable
single-process — and what these tests pin — is every code path around it:
no-op initialize, global mesh construction, pytree replication, per-host
checkpoint shards, and the scaling-efficiency harness (SURVEY.md §4
multi-host-without-a-cluster strategy)."""
import numpy as np
import jax
import jax.numpy as jnp

from real_time_ray_tracing_engine_tpu.parallel import distributed as dist


def test_initialize_is_noop_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert dist.initialize() is False
    # explicit single-process is also a no-op
    assert dist.initialize("host:1234", num_processes=1) is False


def test_make_global_mesh_single_process():
    mesh = dist.make_global_mesh()
    assert set(mesh.axis_names) == {"tile", "sample"}
    assert mesh.shape["tile"] * mesh.shape["sample"] == len(jax.devices())


def test_replicate_puts_on_every_device():
    mesh = dist.make_global_mesh()
    tree = {"a": np.arange(6.0).reshape(2, 3)}
    rep = dist.replicate(tree, mesh)
    assert rep["a"].sharding.is_fully_replicated
    np.testing.assert_array_equal(np.asarray(rep["a"]), tree["a"])


def test_checkpoint_shard_roundtrip(tmp_path):
    acc = np.random.default_rng(0).normal(size=(4, 8, 3)).astype(np.float32)
    p = dist.save_progressive_shard(str(tmp_path), acc, 7, 123,
                                    process_index=0)
    assert p.endswith("shard_00000.npz")
    got = dist.load_progressive_shard(str(tmp_path), process_index=0)
    assert got is not None
    a2, st, seed = got
    np.testing.assert_array_equal(a2, acc)
    assert (st, seed) == (7, 123)
    assert dist.load_progressive_shard(str(tmp_path), process_index=3) is None


def test_scaling_report_structure():
    rows = dist.scaling_report(width=32, n_strata=2, max_depth=2,
                               device_counts=[1, 2], reps=1)
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite(r["mpaths_s"]) and r["mpaths_s"] > 0
        assert np.isfinite(r["efficiency"])
    assert rows[0]["efficiency"] == 1.0
