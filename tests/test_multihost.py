"""Multi-process simulation harness (SURVEY §4; VERDICT r1 missing item 4).

Spawns N real OS processes, each a JAX "host" with 4 virtual CPU devices,
joined via jax.distributed + gloo collectives — the same code path a GPU
pod job uses (minus the fabric).  Verifies the collective dictionary
build and regex count produce single-chip-identical results across the
process boundary.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest


WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


@pytest.mark.parametrize("nproc", [2])
def test_multiprocess_collectives(tmp_path, nproc):
    out = tmp_path / "p0.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["CUSTRINGS_MH_COORD"] = "localhost:9833"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(p), str(nproc), str(out)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for p in range(nproc)
    ]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    got = json.loads(out.read_text())
    assert got["n_global_devices"] == 4 * nproc

    # oracle: single-process dictionary encode on the same corpus
    strs = (
        ["the cat sat", "dog", None, "", "the end", "cat"] * 8
        + ["zebra", "the cat sat"]
    )
    import jax

    from custrings import column
    from custrings.ops.unique import dictionary_encode

    col = column.from_host_strings(strs)
    keys, values = dictionary_encode(col)
    assert got["n_keys"] == keys.size
    assert got["values"] == np.asarray(jax.device_get(values)).tolist()
    exp_matches = sum(
        bool(re.search(r"\bcat\b", s)) for s in strs if s is not None
    )
    assert got["total_matches"] == exp_matches
