"""Multi-process (multi-controller) scaling scaffolding.

The reference has no distributed story at all — its "cluster" is an ssh/scp
dev loop (build.sh:24-46, SURVEY.md §5 comm backend). This module is the
jax.distributed counterpart of that layer, written so the SAME code runs on
a virtual CPU mesh (tests, dryrun_multichip), on the cards of one host, and
across processes:

  - `initialize()`      — multi-controller bring-up (jax.distributed),
                          driven by env vars or explicit args; no-op when
                          single-process so local runs need no ceremony.
  - `make_global_mesh()`— ("tile", "sample") mesh over every process's
                          devices. The mapping follows the algorithm: "tile"
                          (pixel row-blocks) carries no collective while
                          rendering, "sample" carries the one psum. In one
                          process (e.g. four cards of one host, each reaching
                          every other over NVLink) it is make_render_mesh.
  - `replicate()`       — put a host-local pytree (scene, camera) on every
                          device of the mesh as a fully-replicated global
                          array, the multi-controller analogue of "scene/BVH
                          replicated per host" (SURVEY.md §7).
  - checkpoint shards   — each host persists only its own row-block of the
                          progressive accumulation; any host subset can
                          restart from its shard (elastic re-render).
  - `scaling_report()`  — throughput vs device count on the same workload.
"""
from __future__ import annotations

import os
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_render_mesh, render_sharded
from ..models import camera as cam_mod


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Bring up the JAX multi-controller runtime; returns True if distributed.

    Arguments fall back to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). Single-process launches (nothing
    set, or
    num_processes == 1) are a no-op so every entry point can call this
    unconditionally.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None or (num_processes or 1) <= 1:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_global_mesh(devices=None) -> Mesh:
    """("tile", "sample") mesh over every device of every process.

    Processes are mapped whole onto the "tile" axis and the devices within
    each process onto "sample": the per-pass psum over "sample" stays inside
    a process, and the "tile" axis — which crosses processes — carries no
    collective at all during rendering (row blocks are independent; they
    meet only at image assembly / checkpoint time). With one process this
    is make_render_mesh.
    """
    devices = devices if devices is not None else jax.devices()
    n_proc = max(p.process_index for p in devices) + 1 \
        if devices else 1
    per_host = len(devices) // n_proc
    if n_proc == 1:
        return make_render_mesh(devices=devices)
    order = sorted(devices, key=lambda d: (d.process_index, d.id))
    grid = np.asarray(order).reshape(n_proc, per_host)
    return Mesh(grid, ("tile", "sample"))


def replicate(tree, mesh: Mesh):
    """Fully-replicate a host-local pytree onto every device of the mesh."""
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), sh), tree)


# ------------------------------------------------------ sharded checkpoints
def save_progressive_shard(ckpt_dir: str, acc_local: np.ndarray,
                           samples_taken: int, seed: int,
                           process_index: int | None = None) -> str:
    """Persist this host's row-block of the progressive accumulation.

    The accumulation buffer + sample counter + RNG seed IS the render state
    (counter RNG: resuming reproduces exactly the samples not yet taken —
    the persistent analogue of DynamicCamera's in-memory m_samples_taken,
    DynamicCamera.cpp:271-277)."""
    pi = jax.process_index() if process_index is None else process_index
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"shard_{pi:05d}.npz")
    tmp = path + ".tmp.npz"                # savez keeps an .npz suffix as-is
    np.savez(tmp, acc=np.asarray(acc_local),
             samples_taken=np.asarray(samples_taken),
             seed=np.asarray(seed))
    os.replace(tmp, path)                  # atomic: no torn shards on crash
    return path


def load_progressive_shard(ckpt_dir: str, process_index: int | None = None):
    """(acc, samples_taken, seed) for this host, or None if absent."""
    pi = jax.process_index() if process_index is None else process_index
    path = os.path.join(ckpt_dir, f"shard_{pi:05d}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["acc"], int(z["samples_taken"]), int(z["seed"])


# --------------------------------------------------------- scaling harness
def scaling_report(scene=None, *, width: int = 128, n_strata: int = 2,
                   max_depth: int = 4, device_counts=None,
                   reps: int = 2) -> list[dict]:
    """Throughput vs device count on one workload.

    Runs on whatever devices exist — the 8-device virtual CPU mesh in tests,
    the cards of a host in production (same code). Returns
    [{devices, mpaths_s, efficiency}], efficiency relative to linear scaling
    from the smallest count.
    """
    import real_time_ray_tracing_engine_tpu as rt
    from ..scene.compile import compile_scene

    scene = scene or rt.builders.cornell_box()
    scene.camera.image_width = width
    flat = compile_scene(scene)
    cam = cam_mod.derive(scene.camera)
    w, h = cam_mod.image_size(scene.camera)
    all_dev = jax.devices()
    if device_counts is None:
        device_counts, d = [], 1
        while d <= len(all_dev):
            device_counts.append(d)
            d *= 2
    spp = n_strata * n_strata
    rows = []
    for nd in device_counts:
        mesh = make_global_mesh(all_dev[:nd]) if nd > 1 \
            else make_render_mesh(devices=all_dev[:1])
        hp = -(-h // mesh.shape["tile"]) * mesh.shape["tile"]
        ns = n_strata
        while (ns * ns) % mesh.shape["sample"]:
            ns += 1
        args = dict(mesh=mesh, width=w, height=hp, n_strata=ns,
                    max_depth=max_depth, sky_gradient=False)
        img = render_sharded(flat, cam, jnp.uint32(0), **args)
        np.asarray(img)                       # compile + fetch
        t0 = time.perf_counter()
        for r in range(reps):
            img = render_sharded(flat, cam, jnp.uint32(r + 1), **args)
        np.asarray(img)
        dt = (time.perf_counter() - t0) / reps
        rows.append({"devices": nd,
                     "mpaths_s": w * hp * ns * ns / dt / 1e6})
    base = rows[0]
    for r in rows:
        r["efficiency"] = (r["mpaths_s"] / base["mpaths_s"]
                           * base["devices"] / r["devices"])
    return rows
