"""On-card parity of the compiled kernels and the large-size movers.

Marked `gpu`: they skip on the CPU and run on the card from
chip_smoke.py's last phase.  References are the XLA engines and numpy.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.corpus import tweets

pytestmark = pytest.mark.gpu

PATTERNS = [r"#\w+", r"\bthe\b", "the|that", r"(\w+)@(\w+)", r"\w+$"]


@pytest.fixture(scope="module")
def mats():
    from custrings import column
    from custrings.ops import layout

    lines = tweets(20000, 7)
    col = column.from_host_strings(lines)
    chars, nch = layout.char_matrix(col)
    return lines, col, chars, nch


@pytest.mark.parametrize("pattern", PATTERNS)
def test_bit_nfa_kernel_vs_xla(gpu, mats, pattern):
    from custrings.regex.ops import get_bit_nfa, get_program

    _, _, chars, nch = mats
    dp = get_program(pattern)
    for anchored in (False, True):
        want = np.asarray(dp.nfa_matches(chars, nch, anchored))
        got = np.asarray(get_bit_nfa(pattern).matches(chars, nch, anchored))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern", [r"#\w+", r"(\w+)@(\w+)", "the|that"])
def test_span_kernels_vs_xla(gpu, mats, pattern):
    from custrings.regex.ops import get_program

    _, _, chars, nch = mats
    dp = get_program(pattern)
    sp = jnp.zeros(chars.shape[0], jnp.int32)
    got = dp._span_bits().single(chars, nch, sp)
    if dp.prog.longest_safe:
        want = dp.nfa_spans(chars, nch, sp)
    else:
        m, b, e = dp.spans_exec(
            chars, nch, sp, jnp.full(chars.shape[0], -1, jnp.int32), 0
        )
        want = (m > 0, b, e)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_contains_public_op_on_card(gpu, mats):
    from custrings import nvstrings

    lines = mats[0]
    got = nvstrings.to_device(lines).contains(r"#\w+")
    rx = re.compile(r"#\w+")
    assert got == [None if s is None else bool(rx.search(s)) for s in lines]


@pytest.mark.parametrize("n", [(1 << 21) + 12345, 50_000_000])
def test_scatter_movers_on_card(gpu, n):
    from custrings.ops import shift_compact as sc

    rng = np.random.default_rng(n)
    keep = rng.random(n) < 0.7
    data = rng.integers(0, 256, n).astype(np.uint8)
    (a,), _ = sc.compact_arrays(jnp.asarray(keep), [jnp.asarray(data)])
    want = np.zeros(n, np.uint8)
    want[: keep.sum()] = data[keep]
    np.testing.assert_array_equal(np.asarray(a), want)
    live = rng.random(n) < 0.5
    dist = np.maximum.accumulate(rng.integers(0, 3, n)).astype(np.int32)
    live &= np.arange(n) + dist < n
    (x,), px = sc.expand_arrays(
        jnp.asarray(live), jnp.asarray(dist), [jnp.asarray(data)]
    )
    jj = np.nonzero(live)[0]
    want = np.zeros(n, np.uint8)
    want[jj + dist[jj]] = data[jj]
    np.testing.assert_array_equal(np.asarray(x), want)
    assert int(np.asarray(px).sum()) == jj.size
