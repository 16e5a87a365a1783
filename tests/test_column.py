"""M0 parity tests: ingest/egress/offsets/lengths.

Modeled on the reference's python/tests/test_offsets.py, test_length.py,
test_allnulls.py oracle style: literal lists with None/""/UTF-8, byte-exact
round-trips.
"""

import numpy as np
import pytest

from custrings import column
from custrings.ops import attrs, layout

CORPUS = ["apple", "", None, "pear", "siamésé", "日本語テスト", "a b"]


def test_roundtrip():
    col = column.from_host_strings(CORPUS)
    assert column.to_host_strings(col) == CORPUS
    assert col.size == len(CORPUS)


def test_roundtrip_empty():
    col = column.from_host_strings([])
    assert column.to_host_strings(col) == []
    assert col.size == 0


def test_all_nulls():
    col = column.from_host_strings([None, None, None])
    assert column.to_host_strings(col) == [None, None, None]
    assert column.null_count(col) == 3


def test_from_offsets():
    values = np.array([97, 112, 112, 108, 101], dtype=np.int8)
    offsets = np.array([0, 1, 2, 3, 4, 5], dtype=np.int32)
    col = column.from_offsets_np(values, offsets, 5)
    assert column.to_host_strings(col) == ["a", "p", "p", "l", "e"]


def test_from_offsets_empty_mid():
    values = np.frombuffer(b"applepear", dtype=np.int8)
    offsets = np.array([0, 5, 5, 9], dtype=np.int32)
    col = column.from_offsets_np(values, offsets, 3)
    assert column.to_host_strings(col) == ["apple", "", "pear"]


def test_from_offsets_with_bitmask():
    values = np.array([97, 112, 112, 108, 101], dtype=np.int8)
    offsets = np.array([0, 1, 2, 3, 4, 5], dtype=np.int32)
    bitmask = np.array([29], dtype=np.int8)
    col = column.from_offsets_np(values, offsets, 5, bitmask)
    assert column.to_host_strings(col) == ["a", None, "p", "l", "e"]


def test_to_offsets():
    col = column.from_host_strings(["a", "p", "p", "l", "e"])
    data, offsets, nbuf = column.to_offsets_np(col)
    assert data.tobytes() == b"apple"
    assert list(offsets) == [0, 1, 2, 3, 4, 5]
    assert list(nbuf) == [31]


def test_len_chars():
    col = column.from_host_strings(CORPUS)
    expected = [len(s) if s is not None else -1 for s in CORPUS]
    assert list(attrs.len_chars(col)) == expected


def test_byte_count():
    col = column.from_host_strings(CORPUS)
    expected = [
        len(s.encode("utf-8")) if s is not None else -1 for s in CORPUS
    ]
    assert list(attrs.byte_count(col)) == expected


def test_null_count_emptyisnull():
    col = column.from_host_strings(["a", "", None])
    assert column.null_count(col) == 1
    assert column.null_count(col, emptyisnull=True) == 2


@pytest.mark.parametrize(
    "name,pyfn",
    [
        ("isalnum", str.isalnum),
        ("isalpha", str.isalpha),
        ("isdigit", str.isdigit),
        ("isspace", str.isspace),
        ("isdecimal", str.isdecimal),
        ("isnumeric", str.isnumeric),
    ],
)
def test_predicates_vs_python(name, pyfn):
    corpus = ["abc", "ABC123", "123", "½", "  \t", "", None, "siamésé", "a b"]
    col = column.from_host_strings(corpus)
    got = list(getattr(attrs, name)(col))
    expected = [bool(pyfn(s)) if s else False for s in corpus]
    assert got == expected, f"{name}: {got} != {expected}"


def test_case_predicates():
    # Reference semantics: non-alpha chars don't disqualify (attrs.cu).
    corpus = ["abc", "ABC", "aBc", "123", "ab1", "AB1", "", None]
    col = column.from_host_strings(corpus)
    assert list(attrs.isupper(col)) == [
        False, True, False, True, False, True, False, False,
    ]
    assert list(attrs.islower(col)) == [
        True, False, False, True, True, False, False, False,
    ]


def test_is_empty():
    col = column.from_host_strings(["", "x", None])
    assert list(attrs.is_empty(col)) == [True, False, True]


def test_char_map_utf8():
    col = column.from_host_strings(["héllo", "日本"])
    cm = layout.char_map(col)
    assert list(cm.nchars()) == [5, 2]
    cps = np.asarray(layout.codepoints(col))
    assert [chr(c) for c in cps[:7]] == ["h", "é", "l", "l", "o", "日", "本"]


def test_encode_codepoints_roundtrip():
    import jax.numpy as jnp

    text = "aé日😀"
    cps = jnp.asarray([ord(c) for c in text])
    bts, w = layout.encode_codepoints(cps)
    bts, w = np.asarray(bts), np.asarray(w)
    for i, ch in enumerate(text):
        assert bytes(bts[i][: w[i]]) == ch.encode("utf-8")


def test_isalnum_reference_corpus():
    # python/tests/test_convert.py::test_isalnum (includes non-ASCII
    # numerics like 7-one-quarter and superscripts)
    corpus = ["1234567890", "de", "1.75", "-34", "+9.8", "7¼", "x³", "2³",
              "12⅝", "", "\t\r\n "]
    col = column.from_host_strings(corpus)
    assert [bool(b) for b in attrs.isalnum(col)] == [
        True, True, False, False, False, True, True, True, True, False,
        False,
    ]
