"""Unit tests for the gather-free segment primitives (ops/segments.py) —
the byte-domain building blocks every hot op now rides on."""

import numpy as np

import jax.numpy as jnp

from custrings.ops import segments


def _random_offsets(rng, n_rows, cap):
    cuts = np.sort(rng.integers(0, cap + 1, n_rows - 1))
    return np.concatenate([[0], cuts, [cap]]).astype(np.int32)


def test_broadcast_rows_to_bytes_random():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 40))
        cap = int(rng.integers(0, 300))
        offs = _random_offsets(rng, n, cap)
        vals = rng.integers(-50, 50, n).astype(np.int32)
        got = np.asarray(
            segments.broadcast_rows_to_bytes(
                jnp.asarray(vals), jnp.asarray(offs), cap
            )
        )
        # oracle: last row whose start <= j (empty rows own no bytes)
        exp = np.zeros(cap, np.int32)
        for j in range(cap):
            r = np.searchsorted(offs[1:], j, side="right")
            exp[j] = vals[min(r, n - 1)]
        assert (got == exp).all()


def test_row_start_end_positions():
    rng = np.random.default_rng(1)
    for _ in range(10):
        n = int(rng.integers(1, 30))
        cap = int(rng.integers(1, 200))
        offs = _random_offsets(rng, n, cap)
        rs = np.asarray(
            segments.row_start_positions(jnp.asarray(offs), cap)
        )
        re_ = np.asarray(segments.row_end_positions(jnp.asarray(offs), cap))
        for j in range(cap):
            r = np.searchsorted(offs[1:], j, side="right")
            assert rs[j] == offs[r], (j, r)
            assert re_[j] == offs[r + 1], (j, r)


def test_per_row_of_prefix():
    rng = np.random.default_rng(2)
    n, cap = 17, 230
    offs = _random_offsets(rng, n, cap)
    mask = rng.random(cap) < 0.3
    pre = np.concatenate([[0], np.cumsum(mask)]).astype(np.int32)
    got = np.asarray(
        segments.per_row_of_prefix(jnp.asarray(pre), jnp.asarray(offs))
    )
    exp = np.array(
        [mask[offs[r] : offs[r + 1]].sum() for r in range(n)], np.int32
    )
    assert (got == exp).all()


# Prefix scans (segments.cumsum / cummax): the parity cases the removed
# linear-pass scan kernel was held to, now on the XLA scans.

import pytest  # noqa: E402


@pytest.mark.parametrize("n", [1, 7, 128, 1024, 4096, 5000])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.bool_])
def test_cumsum_matches_numpy(n, dtype):
    rng = np.random.default_rng(n)
    if dtype == np.bool_:
        x = rng.integers(0, 2, n).astype(np.bool_)
    elif dtype == np.uint8:
        x = rng.integers(0, 256, n).astype(np.uint8)
    else:
        x = rng.integers(-100000, 100000, n).astype(np.int32)
    got = segments.cumsum(jnp.asarray(x))
    want = np.cumsum(x.astype(np.int64)).astype(np.int32)
    assert got.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("n", [1, 7, 128, 1024, 4096, 5000])
def test_cummax_matches_numpy(n):
    rng = np.random.default_rng(n + 17)
    x = rng.integers(-(2**30), 2**30, n).astype(np.int32)
    got = segments.cummax(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), np.maximum.accumulate(x))


def test_cumsum_large_values():
    # prefix totals near the int32 range stay exact
    x = np.full(4096, 500_000, np.int32)
    x[::7] = -250_000
    got = segments.cumsum(jnp.asarray(x))
    want = np.cumsum(x.astype(np.int64)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_small_scans():
    x = jnp.arange(100, dtype=jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(segments.cumsum(x)), np.cumsum(np.arange(100))
    )
    np.testing.assert_array_equal(
        np.asarray(segments.cummax(x)), np.arange(100)
    )
