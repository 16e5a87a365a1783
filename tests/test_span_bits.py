"""Parity of the bit-parallel span kernels (regex/pallas_spans.py) vs the
min-plus and ordered engines, in Pallas interpret mode on CPU.

The bit path is the spans executor on the kernel route (GPU) for
certified programs (longest_safe / end_unique); these tests pin its
exactness against the engines it stands beside, including window
starts, empty matches, and EOS anchors.  tests/test_gpu.py re-checks the
compiled kernels on the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from custrings.regex.ops import get_program


def _mat(texts):
    L = max((len(t) for t in texts), default=1) or 1
    N = len(texts)
    chars = np.zeros((N, L), np.int32)
    lens = np.zeros(N, np.int32)
    for i, t in enumerate(texts):
        lens[i] = len(t)
        for j, c in enumerate(t):
            chars[i, j] = ord(c)
    return jnp.asarray(chars), jnp.asarray(lens)


CORPUS = [
    "", "a", "the", "that", "ththat", "thethat", "a@b", "a@b@c",
    "user@host tail", " x@y ", "aaa", "no match here!", "@", "a@",
    "@b", "the end", "end the", "that that", "a b@c the",
    "ém@oji café",
]


@pytest.mark.parametrize(
    "pattern", [r"(\w+)@(\w+)", "the|that", r"#\w+", r"\w+", "a+b", r"\w+$"]
)
@pytest.mark.parametrize("start", [0, 2])
def test_span_bits_parity(pattern, start):
    dp = get_program(pattern)
    sb = dp._span_bits()
    assert sb is not None, "certified pattern must route to the bit path"
    chars, lens = _mat(CORPUS)
    N = chars.shape[0]
    sp = jnp.full(N, start, jnp.int32)
    m1, b1, e1 = sb.single(chars, lens, sp, False, True)
    if dp.prog.longest_safe:
        m2, b2, e2 = dp.nfa_spans(chars, lens, sp)
    else:
        m2i, b2, e2 = dp.spans_exec(
            chars, lens, sp, jnp.full(N, -1, jnp.int32), 0
        )
        m2 = m2i > 0
    assert np.array_equal(np.asarray(m1), np.asarray(m2))
    assert np.array_equal(np.asarray(b1), np.asarray(b2))
    assert np.array_equal(np.asarray(e1), np.asarray(e2))


def test_uncertified_patterns_stay_off_bits():
    # 'a|ab' is prefix-ambiguous: priority picks 'a', longest picks 'ab'
    dp = get_program("a|ab")
    assert not dp.prog.end_unique and not dp.prog.longest_safe
    assert dp._span_bits() is None
    chars, lens = _mat(["xab"])
    m, b, e = dp.spans_single(chars, lens, jnp.zeros(1, jnp.int32))
    # reference priority semantics: 'a' wins at [1, 2)
    assert bool(m[0]) and int(b[0]) == 1 and int(e[0]) == 2


@pytest.fixture
def kernel_route_interpreted(monkeypatch):
    """The kernel route, with the kernels run by the Pallas interpreter
    (the compiled Triton kernels need a GPU)."""
    from custrings import config
    from custrings.regex.pallas_nfa import BitNFA
    from custrings.regex.pallas_spans import SpanBits

    calls = []
    single, matches = SpanBits.single, BitNFA.matches

    def spy_single(self, chars, lengths, start_pos, ascii=False,
                   interpret=False):
        calls.append("spans")
        return single(self, chars, lengths, start_pos, ascii, True)

    def spy_matches(self, chars, lengths, anchored, ascii=False,
                    interpret=False):
        calls.append("matches")
        return matches(self, chars, lengths, anchored, ascii, True)

    monkeypatch.setattr(config, "kernel_route", lambda platform=None: "kernel")
    monkeypatch.setattr(SpanBits, "single", spy_single)
    monkeypatch.setattr(BitNFA, "matches", spy_matches)
    return calls


def test_findall_rides_bits_router(kernel_route_interpreted):
    """Multi-match ops through all_spans' round loop with the kernel route
    on (kernels interpreted): parity vs Python re, and the router really
    took the bit span kernels."""
    import re as pyre

    import jax

    from custrings.column import from_host_strings, to_host_strings
    from custrings.regex import ops as rx

    lines = [
        "a@b c@d", "the that ththat", "", "x@y@z w@v", "no match",
        "user@host and other@site!", "thethe", None, "a@b",
    ]
    col = from_host_strings(lines)
    for pat in (r"(\w+)@(\w+)", "the|that"):
        fa = rx.findall_record(col, pat)
        toks = to_host_strings(fa.tokens)
        ro = jax.device_get(fa.row_offsets)
        got = [
            toks[ro[i]:ro[i + 1]] if lines[i] is not None else None
            for i in range(len(lines))
        ]
        exp = [
            [m.group(0) for m in pyre.finditer(pat, s)]
            if s is not None
            else None
            for s in lines
        ]
        assert got == exp, (pat, got, exp)
    assert "spans" in kernel_route_interpreted


def test_contains_takes_bit_kernel_on_kernel_route(kernel_route_interpreted):
    import re as pyre

    from custrings.column import from_host_strings
    from custrings.regex import ops as rx

    lines = ["#tag here", "none", None, "x #y_z", ""]
    got = np.asarray(rx.contains_re(from_host_strings(lines), r"#\w+"))
    want = [s is not None and bool(pyre.search(r"#\w+", s)) for s in lines]
    assert got.tolist() == want
    assert "matches" in kernel_route_interpreted


def test_xla_route_keeps_kernels_off(monkeypatch):
    """On the CPU (XLA route) the span router takes min-plus, never the
    bit kernels."""
    from custrings.regex.pallas_spans import SpanBits

    def boom(*a, **k):
        raise AssertionError("bit kernel on the XLA route")

    monkeypatch.setattr(SpanBits, "single", boom)
    dp = get_program(r"#\w+")
    chars, lens = _mat(["a #b", "#", "x"])
    m, b, e = dp.spans_single(chars, lens, jnp.zeros(3, jnp.int32))
    assert np.asarray(m).tolist() == [True, False, False]
