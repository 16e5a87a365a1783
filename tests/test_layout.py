"""Padded views and char matrices (ops/layout.py): the XLA row-window
gather, the ASCII-dominant hybrid char matrix, and split parity at
several drop densities."""

import jax.numpy as jnp
import numpy as np
import pytest

from custrings import column as colmod
from custrings.ops import layout

STRINGS = [
    "hello world",
    "",
    "a",
    "tschüß éé",  # two-byte sequences
    "日本語のテキスト",  # three-byte sequences
    "x" * 300,
    "mixed ascii & 中文 tail",
    None,
    "🎉 four-byte emoji 🎉",
]


def test_padded_view_windows_random():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 3000, dtype=np.uint8)
    offs = np.concatenate(
        [[0], np.sort(rng.integers(0, 3000, 63)), [3000]]
    ).astype(np.int32)
    out = np.asarray(
        layout._padded_view(jnp.asarray(data), jnp.asarray(offs), 100)
    )
    for r in range(64):
        row = data[offs[r] : offs[r + 1]][:100]
        np.testing.assert_array_equal(out[r, : row.size], row)
        assert not out[r, row.size :].any()


def test_padded_view_parity():
    col = colmod.from_host_strings(STRINGS)
    w = layout.max_row_bytes(col)
    got = np.asarray(layout.padded_view(col, w))
    for r, s in enumerate(STRINGS):
        b = np.frombuffer((s or "").encode(), np.uint8)[:w]
        np.testing.assert_array_equal(got[r, : b.size], b)
        assert not got[r, b.size :].any()


def test_char_matrix_hybrid_parity():
    col = colmod.from_host_strings(STRINGS)
    w = layout.max_row_bytes(col)
    na = layout.row_nonascii_ids(col)
    assert na is not None and len(na) >= 3
    mat, nch = layout._char_matrix_hybrid(
        col.data, col.offsets, col.lengths(), jnp.asarray(na, jnp.int32), w
    )
    m, nc = np.asarray(mat), np.asarray(nch)
    for r, s in enumerate(STRINGS):
        cps = [ord(c) for c in (s or "")][:w]
        assert nc[r] == len(s or ""), r
        np.testing.assert_array_equal(m[r, : len(cps)], cps)


def test_mostly_ascii_column_uses_hybrid():
    strs = ["plain %d" % i for i in range(64)] + ["ünïcode"]
    col = colmod.from_host_strings(strs)
    mat, nch = layout.char_matrix(col)
    assert int(nch[-1]) == 7
    got = "".join(chr(c) for c in np.asarray(mat[-1])[: int(nch[-1])])
    assert got == "ünïcode"


def test_utf8_byte_at_matches_encoder():
    """The cummax-fill writer's per-byte encoder vs encode_codepoints."""
    rng = np.random.default_rng(3)
    cps = np.concatenate(
        [
            rng.integers(1, 0x80, 100),
            rng.integers(0x80, 0x800, 100),
            rng.integers(0x800, 0x10000, 100),
            rng.integers(0x10000, 0x110000, 100),
        ]
    ).astype(np.int32)
    from custrings.ops.charwise import _utf8_byte_at
    from custrings.ops.layout import encode_codepoints

    j = jnp.asarray(cps)
    bts, w = encode_codepoints(j)
    for t in range(4):
        got = np.asarray(_utf8_byte_at(j, jnp.full(j.shape, t, jnp.int32)))
        mask = np.asarray(w) > t
        assert (got[mask] == np.asarray(bts[:, t])[mask]).all()


@pytest.mark.parametrize("density", [0.15, 0.95, 0.0])
def test_split_drop_density(density):
    """split_record vs str.split where a `density` share of the bytes are
    delimiters (the compaction drops them)."""
    from custrings.ops import split as sp

    rng = np.random.default_rng(int(density * 100))
    strs = []
    for _ in range(200):
        n = int(rng.integers(0, 40))
        strs.append("".join(
            " " if rng.random() < density else chr(rng.integers(97, 123))
            for _ in range(n)
        ))
    strs[3] = None
    col = colmod.from_host_strings(strs)
    tc = sp.split_record(col, " ")
    toks = colmod.to_host_strings(tc.tokens)
    exp = [t for s in strs if s is not None for t in s.split(" ")]
    assert toks == exp


def test_split_mixed_delimiter_runs():
    from custrings.ops import split as sp

    strs = ["a b  c", "", None, "xx yy", " lead", "trail ", "no-delims"] * 40
    col = colmod.from_host_strings(strs)
    tc = sp.split_record(col, " ")
    toks = colmod.to_host_strings(tc.tokens)
    exp = [t for s in strs if s is not None for t in s.split(" ")]
    assert toks == exp
