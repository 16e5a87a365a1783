"""Fuzz the monotone movers (compaction and expansion) against numpy."""

import numpy as np
import jax.numpy as jnp

from custrings.ops import shift_compact as sc


def test_compact_fuzz():
    rng = np.random.default_rng(7)
    for trial in range(60):
        n = int(rng.integers(1, 700))
        keep = rng.random(n) < rng.random()  # varying densities
        data = rng.integers(0, 256, n).astype(np.uint8)
        aux = rng.integers(-1000, 1000, n).astype(np.int32)
        (got_d, got_a), k0 = sc.compact_arrays(
            jnp.asarray(keep), [jnp.asarray(data), jnp.asarray(aux)]
        )
        exp_d = data[keep]
        exp_a = aux[keep]
        m = exp_d.shape[0]
        assert np.array_equal(np.asarray(got_d)[:m], exp_d), trial
        assert np.array_equal(np.asarray(got_a)[:m], exp_a), trial
        assert np.all(np.asarray(got_d)[m:] == 0)
        assert int(k0[-1]) == m


def test_compact_max_dist():
    rng = np.random.default_rng(8)
    n = 257
    keep = rng.random(n) < 0.9
    data = rng.integers(0, 256, n).astype(np.uint8)
    (got,), _ = sc.compact_arrays(jnp.asarray(keep), [jnp.asarray(data)])
    assert np.array_equal(np.asarray(got)[: keep.sum()], data[keep])


def test_expand_fuzz():
    rng = np.random.default_rng(9)
    for trial in range(60):
        n = int(rng.integers(2, 500))
        m = int(rng.integers(0, n))
        # strictly increasing targets in [0, n)
        targets = np.sort(rng.choice(n, size=m, replace=False))
        vals = rng.integers(1, 256, n).astype(np.uint8)  # nonzero payloads
        live = np.zeros(n, bool)
        live[:m] = True
        dist = np.zeros(n, np.int32)
        dist[:m] = targets - np.arange(m)
        assert (dist[:m] >= 0).all() and (np.diff(dist[:m]) >= 0).all()
        (got,), placed = sc.expand_arrays(
            jnp.asarray(live), jnp.asarray(dist), [jnp.asarray(vals)]
        )
        exp = np.zeros(n, np.uint8)
        exp[targets] = vals[:m]
        expp = np.zeros(n, bool)
        expp[targets] = True
        assert np.array_equal(np.asarray(got), exp), trial
        assert np.array_equal(np.asarray(placed), expp), trial
