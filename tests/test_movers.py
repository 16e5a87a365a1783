"""Parity of the monotone movers (ops/shift_compact.py): compact /
expand against a numpy oracle, and the span helpers built on them."""

import jax.numpy as jnp
import numpy as np
import pytest

from custrings.ops import shift_compact as sc


def _compact(keep, arrays):
    return sc.compact_arrays(
        jnp.asarray(keep), [jnp.asarray(a) for a in arrays]
    )


def _expand(live, dist, arrays, out_cap):
    return sc.expand_to(
        jnp.asarray(live), jnp.asarray(dist),
        [jnp.asarray(a) for a in arrays], out_cap,
    )


@pytest.mark.parametrize("n", [256, 500, 5000, 40000])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_compact_stream(n, density):
    rng = np.random.default_rng(n + int(density * 7))
    keep = rng.random(n) < density
    data = rng.integers(0, 256, n).astype(np.uint8)
    v32 = rng.integers(-(2**30), 2**30, n).astype(np.int32)
    (g8, g32), k0 = _compact(keep, [data, v32])
    kept = np.nonzero(keep)[0]
    w8 = np.zeros(n, np.uint8)
    w32 = np.zeros(n, np.int32)
    w8[: kept.size] = data[kept]
    w32[: kept.size] = v32[kept]
    np.testing.assert_array_equal(np.asarray(g8), w8)
    np.testing.assert_array_equal(np.asarray(g32), w32)
    np.testing.assert_array_equal(
        np.asarray(k0), np.concatenate([[0], np.cumsum(keep)])
    )


@pytest.mark.parametrize("n", [256, 500, 5000, 40000])
@pytest.mark.parametrize("step", [0, 2, 40])
def test_expand_stream(n, step):
    rng = np.random.default_rng(n + step)
    live = rng.random(n) < 0.5
    dist = np.maximum.accumulate(
        rng.integers(0, step + 1, n)
    ).astype(np.int32)
    live = live & ((np.arange(n) + dist) < n)
    vals = rng.integers(0, 256, n).astype(np.uint8)
    v32 = rng.integers(-999, 999, n).astype(np.int32)
    (got, g32), placed = _expand(live, dist, [vals, v32], n)
    want = np.zeros(n, np.uint8)
    w32 = np.zeros(n, np.int32)
    wpl = np.zeros(n, bool)
    jj = np.nonzero(live)[0]
    tt = jj + dist[jj]
    want[tt] = vals[jj]
    w32[tt] = v32[jj]
    wpl[tt] = True
    np.testing.assert_array_equal(np.asarray(placed), wpl)
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(g32), w32)


def test_expand_stream_out_cap():
    # out_cap > n: elements may land past the input length
    n = 600
    rng = np.random.default_rng(3)
    live = np.ones(n, bool)
    dist = np.full(n, 700, np.int32)
    vals = rng.integers(0, 256, n).astype(np.uint8)
    (got,), placed = _expand(live, dist, [vals], n + 768)
    want = np.zeros(n + 768, np.uint8)
    want[700 : 700 + n] = vals
    np.testing.assert_array_equal(np.asarray(got), want)
    assert np.asarray(placed).sum() == n


def test_expand_arrays_is_expand_to_at_input_size():
    rng = np.random.default_rng(5)
    n = 3000
    data = rng.integers(0, 256, n).astype(np.uint8)
    live = rng.random(n) < 0.5
    dist = np.maximum.accumulate(rng.integers(0, 3, n)).astype(np.int32)
    live &= np.arange(n) + dist < n
    jj = np.nonzero(live)[0]
    want = np.zeros(n, np.uint8)
    want[jj + dist[jj]] = data[jj]
    (got,), placed = sc.expand_arrays(
        jnp.asarray(live), jnp.asarray(dist), [jnp.asarray(data)]
    )
    np.testing.assert_array_equal(np.asarray(got), want)
    assert int(np.asarray(placed).sum()) == jj.size


def test_compact_stream_fuzz_ragged_tiles():
    rng = np.random.default_rng(99)
    for _ in range(5):
        n = int(rng.integers(200, 3000))
        keep = rng.random(n) < rng.random()
        data = rng.integers(0, 256, n).astype(np.uint8)
        (g8,), _ = _compact(keep, [data])
        kept = np.nonzero(keep)[0]
        w8 = np.zeros(n, np.uint8)
        w8[: kept.size] = data[kept]
        np.testing.assert_array_equal(np.asarray(g8), w8)


def test_stream_padded_view_parity():
    from custrings import column
    from custrings.ops import layout

    rng = np.random.default_rng(3)
    strs = [
        "".join(chr(rng.integers(97, 123)) for _ in range(rng.integers(0, 30)))
        for _ in range(300)
    ]
    strs += ["héllo wörld \U0001f389", "", "x" * 31]
    col = column.from_host_strings(strs)
    W = layout.max_row_bytes(col)
    pv = np.asarray(layout.padded_view(col, W))
    bs = [s.encode() for s in strs]
    want = np.zeros((len(bs), W), np.uint8)
    for i, b in enumerate(bs):
        want[i, : len(b)] = np.frombuffer(b, np.uint8)
    np.testing.assert_array_equal(pv, want)
    mat, nch = layout.char_matrix(col, W)
    mat = np.asarray(mat)
    for i, s in enumerate(strs):
        cps = [ord(c) for c in s]
        np.testing.assert_array_equal(mat[i, : len(cps)], cps)
        assert int(np.asarray(nch)[i]) == len(cps)


def test_cover_spans():
    bb = np.array([[0, 5, 9], [12, 20, 20]], np.int32)
    ee = np.array([[3, 7, 9], [15, 26, 20]], np.int32)
    ok = np.array([[True, True, True], [True, False, True]])
    got = np.asarray(
        sc.cover_spans(jnp.asarray(bb), jnp.asarray(ee), jnp.asarray(ok), 30)
    )
    want = np.zeros(30, bool)
    for b, e, o in zip(bb.ravel(), ee.ravel(), ok.ravel()):
        if o:
            want[b:e] = True
    np.testing.assert_array_equal(got, want)


def test_stream_expand_spans():
    rng = np.random.default_rng(4)
    sizes = np.array([3, 0, 2, 4, 1], np.int32)
    okf = np.array([True, True, False, True, True])
    starts = np.array([1, 6, 6, 8, 14], np.int32)
    live_sizes = np.where(okf, sizes, 0)
    total = int(live_sizes.sum())
    stream = np.zeros(16, np.uint8)
    stream[:total] = rng.integers(1, 256, total)
    got = np.asarray(sc.stream_expand_spans(
        jnp.asarray(stream), total, jnp.asarray(starts),
        jnp.asarray(sizes), jnp.asarray(okf), 20,
    ))
    want = np.zeros(20, np.uint8)
    pos = 0
    for st, sz, o in zip(starts, sizes, okf):
        if o and sz:
            want[st : st + sz] = stream[pos : pos + sz]
            pos += sz
    np.testing.assert_array_equal(got, want)
