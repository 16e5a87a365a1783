"""M1/M2 op parity tests vs Python str as oracle (reference test style:
python/tests/test_case.py, test_pad.py, test_strip.py, test_substr.py,
test_replace, test_url.py...)."""

import numpy as np
import pytest

from custrings import column
from custrings.ops import (
    array,
    case,
    combine,
    find,
    modify,
    pad,
    strip,
    substr,
    urlencode,
)


def dev(strs):
    return column.from_host_strings(strs)


def host(col):
    return column.to_host_strings(col)


CORPUS = ["hello", "there", None, "world", "accéntéd", "", "quick brown fox"]


# ------------------------- find family -------------------------


def test_find():
    col = dev(CORPUS)
    got = list(find.find(col, "o"))
    exp = [s.find("o") if s is not None else -2 for s in CORPUS]
    assert got == exp


def test_find_range():
    col = dev(["hello", "oooo", None])
    assert list(find.find(col, "o", 2, 4)) == [-1, 2, -2]
    assert list(find.rfind(col, "o")) == [4, 3, -2]


def test_find_utf8_positions():
    col = dev(["héllo wörld"])
    # char positions, not byte positions
    assert list(find.find(col, "wörld")) == ["héllo wörld".find("wörld")]
    assert list(find.rfind(col, "ö")) == ["héllo wörld".rfind("ö")]


def test_contains_startswith_endswith():
    col = dev(CORPUS)
    assert list(find.contains(col, "o")) == [
        ("o" in s) if s is not None else False for s in CORPUS
    ]
    assert list(find.startswith(col, "he")) == [
        s.startswith("he") if s is not None else False for s in CORPUS
    ]
    assert list(find.endswith(col, "d")) == [
        s.endswith("d") if s is not None else False for s in CORPUS
    ]


def test_compare():
    col = dev(["aaa", "aab", "aa", "aaaa", None, "b"])
    got = np.sign(np.asarray(find.compare(col, "aaa")))
    assert list(got) == [0, 1, -1, 1, -1, 1]


def test_match_strings():
    a = dev(["abc", "def", None, "gh"])
    b = dev(["abc", "xef", None, "ghi"])
    assert list(find.match_strings(a, b)) == [True, False, True, False]


def test_find_multiple():
    col = dev(["hello", "goodbye", None])
    got = np.asarray(find.find_multiple(col, dev(["o", "bye"])))
    assert got.tolist() == [[4, -1], [1, 4], [-2, -2]]


# ------------------------- array ops -------------------------


def test_gather():
    col = dev(CORPUS)
    got = host(array.gather(col, [0, 3, 2, 0]))
    assert got == ["hello", "world", None, "hello"]


def test_gather_negative():
    col = dev(["a", "b", "c"])
    assert host(array.gather(col, [-1, 0])) == ["c", "a"]


def test_gather_mask():
    col = dev(["a", "b", "c", "d"])
    assert host(array.gather_mask(col, [True, False, False, True])) == ["a", "d"]


def test_append():
    got = host(array.append([dev(["a", None]), dev(["b"]), dev([])]))
    assert got == ["a", None, "b"]


def test_scatter():
    col = dev(["a", "b", "c", "d"])
    got = host(array.scatter(col, dev(["X", "Y"]), [1, 3]))
    assert got == ["a", "X", "c", "Y"]


def test_remove_strings():
    col = dev(["a", "b", "c", "d"])
    assert host(array.remove_strings(col, [1, 2])) == ["a", "d"]


def test_sort_order():
    strs = ["pear", "apple", None, "fig", "apple"]
    col = dev(strs)
    assert host(array.sort(col)) == [None, "apple", "apple", "fig", "pear"]
    assert host(array.sort(col, asc=False, nullfirst=False)) == [
        "pear", "fig", "apple", "apple", None,
    ]
    idx = list(array.order(col))
    assert [strs[i] for i in idx] == [None, "apple", "apple", "fig", "pear"]


def test_sort_length():
    col = dev(["ccc", "a", "bb"])
    assert host(array.sort(col, stype=array.SORT_LENGTH)) == ["a", "bb", "ccc"]


# ------------------------- combine -------------------------


def test_cat():
    s1 = dev(["hello", None, "goodbye"])
    s2 = dev(["world", "globe", None])
    assert host(combine.cat(s1, s2, sep=":", na_rep="_")) == [
        "hello:world", "_:globe", "goodbye:_",
    ]
    assert host(combine.cat(s1, s2, sep=":")) == ["hello:world", None, None]
    assert host(combine.cat(s1, s2)) == ["helloworld", None, None]


def test_join():
    col = dev(["hello", "goodbye"])
    assert host(combine.join(col, ":")) == ["hello:goodbye"]
    assert host(combine.join(dev(["a", None, "b"]), "-")) == ["a-b"]
    assert host(combine.join(dev(["x"]), ":")) == ["x"]


# ------------------------- case -------------------------


@pytest.mark.parametrize(
    "opname,pyfn",
    [
        ("lower", str.lower),
        ("upper", str.upper),
        ("swapcase", str.swapcase),
        ("capitalize", str.capitalize),
    ],
)
def test_case_ops(opname, pyfn):
    corpus = ["Hello", "WORLD", None, "aBcD", "ñÑ", "", "álpha BETA"]
    col = dev(corpus)
    got = host(getattr(case, opname)(col))
    exp = [pyfn(s) if s is not None else None for s in corpus]
    assert got == exp


def test_title():
    corpus = ["hello world", "a-b c", None, "ABC def"]
    col = dev(corpus)
    got = host(case.title(col))
    exp = [s.title() if s is not None else None for s in corpus]
    assert got == exp


# ------------------------- substr -------------------------


def test_slice():
    corpus = ["hello", "there", None, "accéntéd", ""]
    col = dev(corpus)
    got = host(substr.slice_chars(col, 1, 4))
    assert got == [s[1:4] if s is not None else None for s in corpus]


def test_slice_step():
    corpus = ["hello world", "accéntéd", None]
    col = dev(corpus)
    got = host(substr.slice_chars(col, 0, None, 2))
    assert got == [s[0::2] if s is not None else None for s in corpus]


def test_slice_from():
    col = dev(["hello", "there"])
    got = host(substr.slice_from(col, [1, 2], [3, -1]))
    assert got == ["el", "ere"]


def test_get():
    col = dev(["hello", "", None])
    assert host(substr.get_char(col, 1)) == ["e", "", None]


# ------------------------- strip -------------------------


def test_strip():
    corpus = ["  hello  ", "\tthere\n", None, "   ", "oreo"]
    col = dev(corpus)
    assert host(strip.strip(col)) == [
        s.strip(" \n\t") if s is not None else None for s in corpus
    ]
    assert host(strip.lstrip(col)) == [
        s.lstrip(" \n\t") if s is not None else None for s in corpus
    ]
    assert host(strip.rstrip(col)) == [
        s.rstrip(" \n\t") if s is not None else None for s in corpus
    ]
    assert host(strip.strip(col, "o")) == [
        s.strip("o") if s is not None else None for s in corpus
    ]


# ------------------------- pad -------------------------


def test_pad_family():
    corpus = ["abc", "abcdefgh", None, ""]
    col = dev(corpus)
    assert host(pad.ljust(col, 6)) == [
        s.ljust(6) if s is not None else None for s in corpus
    ]
    assert host(pad.rjust(col, 6)) == [
        s.rjust(6) if s is not None else None for s in corpus
    ]
    assert host(pad.center(col, 6)) == [
        s.center(6) if s is not None else None for s in corpus
    ]


def test_zfill():
    corpus = ["42", "-42", "+3", "text", None, ""]
    col = dev(corpus)
    assert host(pad.zfill(col, 5)) == [
        s.zfill(5) if s is not None else None for s in corpus
    ]


def test_repeat():
    col = dev(["ab", None, ""])
    assert host(pad.repeat(col, 3)) == ["ababab", None, ""]


def test_wrap():
    col = dev(["hello there how are you", None])
    got = host(pad.wrap(col, 5))
    # greedy: break at last space once line exceeds width
    assert got[1] is None
    assert got[0].replace("\n", " ") == "hello there how are you"
    assert "\n" in got[0]


# ------------------------- modify -------------------------


def test_replace_literal():
    corpus = ["hello", "goodbye", None, "oo", "ooo"]
    col = dev(corpus)
    got = host(modify.replace_literal(col, "o", "0"))
    assert got == [s.replace("o", "0") if s is not None else None for s in corpus]


def test_replace_longer():
    corpus = ["a-b-c", "abc", None]
    col = dev(corpus)
    got = host(modify.replace_literal(col, "-", "::"))
    assert got == [s.replace("-", "::") if s is not None else None for s in corpus]


def test_replace_remove():
    col = dev(["a-b-c"])
    assert host(modify.replace_literal(col, "-", "")) == ["abc"]


def test_replace_overlapping_pattern():
    # bordered pattern "aa": greedy left-to-right non-overlap
    corpus = ["aaaa", "aaa", "baab"]
    col = dev(corpus)
    got = host(modify.replace_literal(col, "aa", "x"))
    assert got == [s.replace("aa", "x") for s in corpus]


def test_replace_limited():
    col = dev(["o o o o"])
    got = host(modify.replace_literal(col, "o", "X", n=2))
    assert got == ["X X o o"]


def test_fillna():
    col = dev(["a", None, "c"])
    assert host(modify.fillna_scalar(col, "z")) == ["a", "z", "c"]
    assert host(modify.fillna_column(col, dev(["1", "2", "3"]))) == ["a", "2", "c"]


def test_insert():
    col = dev(["hello", "", None])
    assert host(modify.insert(col, 2, "__")) == ["he__llo", "__", None]
    assert host(modify.insert(col, -1, "__")) == ["hello__", "__", None]


def test_slice_replace():
    corpus = ["hello", "ab", None]
    col = dev(corpus)
    got = host(modify.slice_replace(col, 1, 3, "XY"))
    assert got == ["hXYlo", "aXY", None]


def test_translate():
    col = dev(["hello world", None])
    table = {"l": "L", "o": None}
    got = host(modify.translate(col, table))
    assert got == ["heLL wrLd", None]


# ------------------------- url -------------------------


def test_url_encode():
    import urllib.parse

    corpus = ["hello world", "a/b?c=d", "héllo", None, "ok._~-"]
    col = dev(corpus)
    got = host(urlencode.url_encode(col))
    exp = [
        urllib.parse.quote(s, safe="") if s is not None else None
        for s in corpus
    ]
    assert got == exp


def test_url_decode():
    corpus = ["hello%20world", "a%2Fb", "h%C3%A9llo", None, "100%"]
    col = dev(corpus)
    got = host(urlencode.url_decode(col))
    import urllib.parse

    exp = [
        urllib.parse.unquote(s) if s is not None else None for s in corpus
    ]
    assert got == exp


def _murmur3_32(data: bytes, seed: int = 31) -> int:
    """Pure-Python MurmurHash3_x86_32 (the reference's hash)."""
    c1, c2, m32 = 0xCC9E2D51, 0x1B873593, 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m32

    h = seed
    nb = len(data) // 4
    for i in range(nb):
        k = int.from_bytes(data[4 * i : 4 * i + 4], "little")
        k = rotl((k * c1) & m32, 15) * c2 & m32
        h = (rotl(h ^ k, 13) * 5 + 0xE6546B64) & m32
    tail = data[4 * nb :]
    k = 0
    for i, b in enumerate(tail):
        k |= b << (8 * i)
    if tail:
        k = rotl((k * c1) & m32, 15) * c2 & m32
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m32
    return h ^ (h >> 16)


def test_pallas_hash_matches_jnp():
    """nvstrings.hash (ops/convert.hash_mm3) vs a pure-Python MurmurHash3."""
    from custrings import nvstrings
    from custrings.ops.convert import hash_mm3

    corpus = ["hello", "", None, "a", "abc", "x" * 300, "héllo wörld" * 10]
    col = dev(corpus)
    got = np.asarray(hash_mm3(col)).tolist()
    for g, s in zip(got, corpus):
        if s is not None:
            assert g == _murmur3_32(s.encode()), s
    via_api = nvstrings.to_device(corpus).hash()
    assert via_api == [
        None if s is None else _murmur3_32(s.encode()) for s in corpus
    ]


def test_wrap_vs_pandas():
    import pandas as pd

    s = ["quick brown fox jumped over lazy brown dog", None,
         "hello there, accéntéd world", ""]
    col = dev(s)
    for width in (10, 20, 50):
        got = host(pad.wrap(col, width))
        exp = [
            None if x is None else e
            for x, e in zip(s, pd.Series(s).str.wrap(width))
        ]
        assert got == exp, (width, got, exp)


def test_translate_ordinal_tables():
    import string

    corpus = ["hello", "there", "world", "accéntéd", None, "",
              "Equations: 3+3=6; 3/4 < 1 and > 0"]
    col = dev(corpus)
    for table in (
        {},
        str.maketrans("e", "a"),
        str.maketrans("elh", "ELH"),
        str.maketrans("", "", string.punctuation),
        str.maketrans(string.punctuation, " " * len(string.punctuation)),
    ):
        got = host(modify.translate(col, table))
        exp = [x.translate(table) if x is not None else None for x in corpus]
        assert got == exp


def test_url_reference_corpus():
    import urllib.parse

    urls1 = ["http://www.hellow.com", "/home/nvidia/nfs", "123.45 ~ABCDEF"]
    got = host(urlencode.url_encode(dev(urls1)))
    assert got == [urllib.parse.quote(u, safe="~") for u in urls1]
    urls2 = [
        "http://www.hellow.com?k1=acc%C3%A9nted&k2=a%2F/b.c",
        "%2Fhome%2fnfs",
        "987%20ZYX",
    ]
    got = host(urlencode.url_decode(dev(urls2)))
    assert got == [urllib.parse.unquote(u) for u in urls2]


def test_slice_from_negative_reference():
    # negative start casts unsigned -> empty (test_substr.py:12-20)
    col = dev(["hello world", "holy accéntéd", "batman", None, ""])
    got = host(substr.slice_from(col, [2, 3, -1, -1, -1]))
    assert got == ["llo world", "y accéntéd", "", None, ""]


SORT_CORPUS = ["abc", "defghi", None, "jkl", "mno", "pqr", "stu",
               "dog and cat", "accénted", ""]


def test_sort_reference_expectations():
    col = dev(SORT_CORPUS)
    assert host(array.sort(col, 1)) == [
        None, "", "abc", "jkl", "mno", "pqr", "stu", "defghi", "accénted",
        "dog and cat",
    ]
    assert host(array.sort(col, 2)) == [
        None, "", "abc", "accénted", "defghi", "dog and cat", "jkl", "mno",
        "pqr", "stu",
    ]
    assert host(array.sort(col, 3)) == [
        None, "", "abc", "jkl", "mno", "pqr", "stu", "defghi", "accénted",
        "dog and cat",
    ]
    assert list(array.order(col, 1)) == [2, 9, 0, 3, 4, 5, 6, 1, 8, 7]
    assert list(array.order(col, 2)) == [2, 9, 0, 8, 1, 7, 3, 4, 5, 6]
    assert list(array.order(col, 3)) == [2, 9, 0, 3, 4, 5, 6, 1, 8, 7]


def test_case_multicodepoint_first_char_rule():
    # the reference's 16-bit charcases[] maps multi-codepoint casings to
    # the FIRST codepoint of the full casing (charcases.h: 0xDF -> 'S',
    # 0x149 -> 0x2BC, 0x390 -> 0x399); mirrored here
    from custrings import nvstrings as nvs

    got = nvs.to_device(["ß", "ŉo", "ΐ", "straße"]).upper().to_host()
    assert got == ["S", "ʼO", "Ι", "STRASE"]


def test_replace_growth_variants():
    """Size-changing literal replace across writers: grow stream
    (unbordered, growth 1 and >1), shrink in-place compaction, quota,
    and bordered patterns (general plan route)."""
    import numpy as np

    from custrings.column import from_host_strings, to_host_strings
    from custrings.ops import modify

    rng = np.random.default_rng(9)
    al = list("ab the x,aa")
    lines = [
        "".join(rng.choice(al, size=rng.integers(0, 28)))
        for _ in range(120)
    ] + ["", "thethethe", "the", None, "ththe the", "theth", "aaaa"]
    col = from_host_strings(lines)
    cases = [
        ("the", "THEE", -1),    # grow stream, growth 1
        ("the", "THEEEE", -1),  # grow stream, growth 3 (cummax gap fill)
        ("the", "T", -1),       # shrink in-place
        ("the", "", -1),        # delete
        ("the", "THEE", 1),     # quota -> general plan route
        ("aa", "XXX", -1),      # bordered pattern -> general plan route
    ]
    for pat, rep, n in cases:
        got = to_host_strings(modify.replace_literal(col, pat, rep, n))
        exp = [
            s.replace(pat, rep, n if n >= 0 else -1)
            if s is not None
            else None
            for s in lines
        ]
        assert got == exp, (pat, rep, n,
                            [x for x in zip(got, exp) if x[0] != x[1]][:3])
