"""Multi-host runtime: process bootstrap + global meshes + global columns.

The reference is a single-process single-GPU library (SURVEY §2.8 — CUDA
IPC is its only cross-process story).  Here a deployment is a *job*: one
JAX process per host, each driving its local GPUs; the GPUs of one host
are joined all to all by NVLink, hosts by the data-center network.  This
module is the bootstrap:

    runtime.init_runtime()                     # one call per process
    mesh = runtime.global_mesh()               # every chip in the job
    sc   = runtime.shard_global(rows, mesh)    # rows -> global sharded col
    values, n = sc.categorize()                # SPMD collective ops

Design notes
- `init_runtime` wraps jax.distributed.initialize and reads the standard
  env (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) so launchers can
  stay generic; single-process callers may skip it entirely.
- `hybrid_mesh` orders axes (hosts, local devices): the *inner* axis maps
  to the devices of one process, so collectives along it stay on the
  host's NVLink; only reductions over the outer axis cross hosts.  Within
  one host every device reaches every other at the same rate, so no
  device ordering is needed.
- On CPU (tests / the multi-process simulation harness in
  tests/multihost/) collectives use the gloo backend; on GPUs XLA hands
  them to NCCL; the program text is the same.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


_initialized = False


def init_runtime(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join (or create) the distributed job.  No-op when single-process.

    Resolution order: explicit args > COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID env > single-process (returns False).
    Safe to call twice (idempotent)."""
    global _initialized
    if _initialized:
        return True
    # already joined (e.g. the launcher initialized before importing this
    # package — required, since importing custrings touches the
    # backend): adopt the existing client
    from jax._src import distributed as _dist_state

    if getattr(_dist_state.global_state, "client", None) is not None:
        _initialized = True
        return True
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or not num_processes:
        return False
    # NB: must not touch the backend (jax.devices()/default_backend())
    # before initialize(); read the *configured* platform instead
    if "cpu" in (jax.config.jax_platforms or ""):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator, num_processes=num_processes, process_id=process_id
    )
    _initialized = True
    return True


def is_initialized() -> bool:
    return _initialized


def shutdown():
    global _initialized
    if _initialized:
        jax.distributed.shutdown()
        _initialized = False


def global_mesh(axis: str = "data") -> Mesh:
    """One flat mesh axis over every device in the job."""
    return Mesh(np.array(jax.devices()), (axis,))


def hybrid_mesh(dcn_axis: str = "hosts", ici_axis: str = "data") -> Mesh:
    """[processes, devices-per-process] mesh: the inner axis is host-local.

    Shardings that keep their collectives on `ici_axis` never leave the
    host; put the all_to_all/all_gather-heavy dimension there."""
    local = len(jax.local_devices())
    n_proc = jax.process_count()
    devs = np.empty((n_proc, local), dtype=object)
    for d in jax.devices():
        devs[d.process_index][_local_index(d)] = d
    return Mesh(devs, (dcn_axis, ici_axis))


def _local_index(d) -> int:
    locs = jax.local_devices(process_index=d.process_index)
    for i, ld in enumerate(locs):
        if ld.id == d.id:
            return i
    raise ValueError(f"device {d} not in its process's local list")


def shard_global(strs, mesh: Mesh, axis: str = "data"):
    """Build a globally-sharded column from host rows (replicated input).

    Every process passes the SAME full row list; each contributes the
    stacked-shard slice its local devices own via
    jax.make_array_from_process_local_data.  Shards are flattened from
    host row slices and go straight to their devices: the whole column
    never sits on one device, and only each shard must stay below 2^31
    bytes.  Returns a ShardedStringColumn whose ops run SPMD across the
    whole job."""
    from . import dist
    from .sharded import ShardedStringColumn

    S = int(np.prod(mesh.devices.shape))
    d, o, v, a = dist.shard_rows(strs, S)
    if jax.process_count() == 1:
        # one shard per mesh device (not the whole stack on the default
        # device)
        sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        arrs = tuple(jax.device_put(x, sh) for x in (d, o, v, a))
    else:
        per = S // jax.process_count()
        lo = jax.process_index() * per
        arrs = tuple(
            jax.make_array_from_process_local_data(
                NamedSharding(mesh, P(mesh.axis_names[0])),
                x[lo : lo + per],
            )
            for x in (d, o, v, a)
        )
    return ShardedStringColumn(
        *arrs, mesh, mesh.axis_names[0], nrows=len(strs)
    )
