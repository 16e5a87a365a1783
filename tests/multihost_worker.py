"""Worker process for the multi-host simulation harness (SURVEY §4).

Each worker is one simulated "host": its own JAX process with 4 virtual
CPU devices, joined to the job through jax.distributed + gloo.  Run by
tests/test_multihost.py; takes (process_id, num_processes, out_path).
"""

import json
import os
import sys


def main():
    pid, nproc, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["COORDINATOR_ADDRESS"] = os.environ.get(
        "CUSTRINGS_MH_COORD", "localhost:9811"
    )
    os.environ["NUM_PROCESSES"] = str(nproc)
    os.environ["PROCESS_ID"] = str(pid)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    # initialize BEFORE importing custrings: the package import wires
    # tracing into ops, which touches the backend
    jax.distributed.initialize(
        os.environ["COORDINATOR_ADDRESS"],
        num_processes=nproc,
        process_id=pid,
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from custrings.parallel import runtime

    assert runtime.init_runtime(), "distributed init failed"
    assert jax.process_count() == nproc
    mesh = runtime.global_mesh()
    assert int(len(jax.devices())) == 4 * nproc

    strs = (
        ["the cat sat", "dog", None, "", "the end", "cat"] * 8
        + ["zebra", "the cat sat"]
    )
    sc = runtime.shard_global(strs, mesh)
    values, n_keys = sc.categorize()
    mask, total = sc.contains_re(r"\bcat\b")

    # hybrid (hosts, local devices) mesh builds too
    hm = runtime.hybrid_mesh()
    assert hm.devices.shape == (nproc, 4)

    # global arrays span non-addressable devices; gather to every process
    from jax.experimental import multihost_utils as mhu
    import numpy as np

    values_np = np.asarray(mhu.process_allgather(values, tiled=True))
    alive_np = np.asarray(mhu.process_allgather(sc.alive, tiled=True))
    if pid == 0:
        flat = values_np.reshape(-1)
        alive = alive_np.reshape(-1)
        out = {
            "values": flat[alive].tolist(),
            "n_keys": int(jax.device_get(n_keys)),
            "total_matches": int(jax.device_get(total)),
            "n_global_devices": len(jax.devices()),
        }
        with open(out_path, "w") as f:
            json.dump(out, f)
    runtime.shutdown()


if __name__ == "__main__":
    main()
