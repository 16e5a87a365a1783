"""Split family parity tests, mirroring the reference's test matrix
(python/tests/test_split.py) with pandas as oracle where the reference cites
pandas semantics (split.cu:89-123, :225-260)."""

import pandas as pd
import pytest

from custrings import column
from custrings.ops import split

S = ["héllo", None, "a_bc_déf", "a__bc", "_ab_cd", "ab_cd_", "", " a b ",
     " a  bbb   c"]


def dev(strs):
    return column.from_host_strings(strs)


def host(col):
    return column.to_host_strings(col)


def record_lists(tc: split.TokenColumn):
    toks = host(tc.tokens)
    offs = list(tc.row_offsets)
    val = list(tc.row_validity)
    out = []
    for i in range(tc.nrows):
        if not val[i]:
            out.append(None)
        else:
            out.append(toks[offs[i] : offs[i + 1]])
    return out


@pytest.mark.parametrize("n", [-1, 1, 2])
def test_split_record_delim(n):
    got = record_lists(split.split_record(dev(S), "_", n))
    exp = list(pd.Series(S).str.split("_", n=n))
    exp = [None if e is None or e != e else e for e in exp]
    # reference deviation: "" -> [""] (split_size returns 1, custring_view.inl)
    exp = [[""] if e == [] else e for e in exp]
    assert got == exp


@pytest.mark.parametrize("n", [-1, 1, 2])
def test_rsplit_record_delim(n):
    got = record_lists(split.rsplit_record(dev(S), "_", n))
    exp = list(pd.Series(S).str.rsplit("_", n=n))
    exp = [None if e is None or e != e else e for e in exp]
    exp = [[""] if e == [] else e for e in exp]
    assert got == exp


@pytest.mark.parametrize("n", [-1, 1, 2])
def test_split_record_ws(n):
    got = record_lists(split.split_record(dev(S), None, n))
    exp = list(pd.Series(S).str.split(n=n))
    exp = [None if e is None or e != e else e for e in exp]
    exp = [[""] if e == [] else e for e in exp]
    assert got == exp


@pytest.mark.parametrize("n", [-1, 1, 2])
def test_rsplit_record_ws(n):
    got = record_lists(split.rsplit_record(dev(S), None, n))
    exp = list(pd.Series(S).str.rsplit(n=n))
    exp = [None if e is None or e != e else e for e in exp]
    exp = [[""] if e == [] else e for e in exp]
    assert got == exp


def test_split_columns():
    # expectations from the reference's own test (test_split.py:29-53)
    got = [host(c) for c in split.split_columns(dev(S), "_")]
    assert got[0] == ["héllo", None, "a", "a", "", "ab", "", " a b ",
                      " a  bbb   c"]
    assert got[1] == [None, None, "bc", "", "ab", "cd", None, None, None]
    assert got[2] == [None, None, "déf", "bc", "cd", "", None, None, None]


def test_rsplit_columns():
    got = [host(c) for c in split.rsplit_columns(dev(S), "_")]
    assert got[0] == ["héllo", None, "a", "a", "", "ab", "", " a b ",
                      " a  bbb   c"]
    assert got[1] == [None, None, "bc", "", "ab", "cd", None, None, None]
    assert got[2] == [None, None, "déf", "bc", "cd", "", None, None, None]


def test_partition():
    got = [host(c) for c in split.partition(dev(S), "_")]
    rows = list(zip(*got))
    assert rows[0] == ("héllo", "", "")
    assert rows[1] == (None, None, None)
    assert rows[2] == ("a", "_", "bc_déf")
    assert rows[3] == ("a", "_", "_bc")
    assert rows[4] == ("", "_", "ab_cd")
    assert rows[5] == ("ab", "_", "cd_")
    assert rows[6] == ("", "", "")
    assert rows[7] == (" a b ", "", "")


def test_rpartition():
    got = [host(c) for c in split.rpartition(dev(S), "_")]
    rows = list(zip(*got))
    assert rows[0] == ("", "", "héllo")
    assert rows[1] == (None, None, None)
    assert rows[2] == ("a_bc", "_", "déf")
    assert rows[3] == ("a_", "_", "bc")
    assert rows[4] == ("_ab", "_", "cd")
    assert rows[5] == ("ab_cd", "_", "")
    assert rows[6] == ("", "", "")


def test_split_bordered_delim():
    # self-overlapping delimiter: greedy left-to-right
    got = record_lists(split.split_record(dev(["aaaa", "aaa"]), "aa"))
    exp = [s.split("aa") for s in ["aaaa", "aaa"]]
    assert got == exp


def test_rsplit_bordered_delim():
    got = record_lists(split.rsplit_record(dev(["aaaa", "aaa"]), "aa"))
    exp = [s.rsplit("aa") for s in ["aaaa", "aaa"]]
    assert got == exp


def test_delim_extents_stream_parity():
    """The streaming extents body (over-threshold split path) against
    the byte-domain body, all maxsplit/from_right variants + multi-byte
    delimiters."""
    import numpy as np

    from custrings import column
    from custrings.ops import split as sp

    rng = np.random.default_rng(5)
    strs = [
        "::".join(
            "".join(rng.choice(list("abc:"), rng.integers(0, 6)))
            for _ in range(rng.integers(0, 5))
        )
        for _ in range(200)
    ]
    strs += ["", None, "::::", "a::b::c", "::lead", "trail::"]
    col = column.from_host_strings(strs)
    T = 4096
    for delim in (",", "::"):
        for ms, fr in ((-1, False), (1, False), (2, True), (-1, True)):
            c1, s1, e1 = [
                np.asarray(x) for x in sp._delim_body(col, T, delim, ms, fr)
            ]
            c2, s2, e2 = [
                np.asarray(x)
                for x in sp._delim_extents_stream(col, T, delim, ms, fr)
            ]
            np.testing.assert_array_equal(c1, c2)
            tok_off = np.concatenate([[0], np.cumsum(c1)])
            live = np.zeros(T, bool)
            for r in range(len(strs)):
                live[tok_off[r]:tok_off[r + 1]] = True
            assert not ((s1 != s2) & live).any(), (delim, ms, fr)
            assert not ((e1 != e2) & live).any(), (delim, ms, fr)


def test_split_null_row_owning_bytes():
    """A null row that still OWNS bytes (offsets advance across it) must
    contribute no tokens and must not corrupt neighbors' slots — its
    delimiter bytes previously scattered into the next valid row's token
    slots (ADVICE r4: _delim_body ignored row validity)."""
    import jax.numpy as jnp
    import numpy as np

    from custrings.column import StringColumn, to_host_strings
    from custrings.ops import split as sp

    raw = b"a b|x, ,y|c d"
    offsets = jnp.asarray(np.array([0, 3, 9, 13], np.int32))
    validity = jnp.asarray(np.array([True, False, True]))
    col = StringColumn(jnp.asarray(np.frombuffer(raw, np.uint8)), offsets, validity)
    tc = sp.split_record(col, " ")
    toks = to_host_strings(tc.tokens)
    ro = np.asarray(tc.row_offsets)
    got = [toks[ro[i]:ro[i + 1]] for i in range(3)]
    assert got[0] == ["a", "b"]
    assert got[1] == []
    assert got[2] == ["|c", "d"]


def test_tail_plane_semantics():
    import numpy as np

    import jax.numpy as jnp
    from custrings.column import StringColumn
    from custrings.ops import layout

    raw = b"abcXXdef"
    offsets = jnp.asarray(np.array([0, 3, 5, 8], np.int32))
    validity = jnp.asarray(np.array([True, False, True]))
    col = StringColumn(jnp.asarray(np.frombuffer(raw, np.uint8)), offsets, validity)
    t = np.asarray(layout.tail_plane(col))
    assert list(t) == [3, 2, 1, 0, 0, 3, 2, 1]
