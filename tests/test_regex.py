"""Regex engine parity tests.

Oracle = Python `re` (the reference's own tests compare against pandas
Series.str, which wraps Python re: python/tests/test_regex.py:4,64).
Corpus mirrors the reference's 16-pattern x 30-string matrix plus extra
span/greediness/anchor cases.
"""

import re

import numpy as np
import pytest

from custrings import column
from custrings.regex import ops as rx

S30 = [
    "5", "hej", "\t \n", "12345", "\\", "d", "c:\\Tools", "+27", "1c2",
    "1C2", "0:00:0", "0:0:00", "00:0:0", "00:00:0", "00:0:00", "0:00:00",
    "00:00:00", "Hello world !", "Hello world!   ", "Hello worldcup  !",
    "0123456789", "1C2", "Xaa", "abcdefghxxx", "ABCDEFGH", "abcdefgh",
    "abc def", "abc\ndef", "aa\r\nbb\r\ncc\r\n\r\n", "abcabc",
]

PATTERNS = [
    "\\d",
    "\\w+",
    "\\s",
    "\\S",
    "^.*\\\\.*$",
    "[1-5]+",
    "[a-h]+",
    "[A-H]+",
    "\n",
    "b.\\s*\n",
    ".*c",
    "\\d\\d:\\d\\d:\\d\\d",
    "\\d\\d?:\\d\\d?:\\d\\d?",
    "[Hh]ello [Ww]orld",
    "\\bworld\\b",
]


def dev(strs):
    return column.from_host_strings(strs)


def host(c):
    return column.to_host_strings(c)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_contains(pattern):
    col = dev(S30)
    got = list(np.asarray(rx.contains_re(col, pattern)))
    exp = [bool(re.search(pattern, s)) for s in S30]
    assert got == exp, f"{pattern}: {got} vs {exp}"


@pytest.mark.parametrize("pattern", ["[hH]", "[bB][aA]", "h.*o", "\\d+"])
def test_match(pattern):
    s = ["hello", "and héllo", None, "", "42x"]
    col = dev(s)
    got = list(np.asarray(rx.match_re(col, pattern)))
    exp = [bool(re.match(pattern, x)) if x is not None else False for x in s]
    assert got == exp


@pytest.mark.parametrize("pattern", ["a", "[aA]", "a+", "x*"])
def test_count(pattern):
    s = ["hello", "and héllo", "this was empty", "", "aaa bab"]
    col = dev(s)
    got = list(np.asarray(rx.count_re(col, pattern)))
    exp = [len(re.findall(pattern, x)) for x in s]
    assert got == exp


SPAN_CASES = [
    ("\\d+", ["abc123def45", "no digits", "9", ""]),
    ("a*", ["aaa", "baaab", ""]),
    ("a+?", ["aaa", "baaab"]),
    ("h.*o", ["hello world ho", "h o h o"]),
    ("h.*?o", ["hello world ho", "h o h o"]),
    ("[aeiou]{2,3}", ["queueing", "aeiou", "xyz"]),
    ("ab|abc", ["abcd", "xabc"]),
    ("abc|ab", ["abcd", "xabc"]),
    ("^ab", ["abab", "xab"]),
    ("ab$", ["abab", "abx"]),
    ("\\bw\\w+", ["hello world wide", "nowhere"]),
    ("x?y", ["xy", "y", "xxy"]),
    ("(a|b)+", ["ababc", "ccc"]),
]


@pytest.mark.parametrize("pattern,strs", SPAN_CASES)
def test_find_spans_vs_python(pattern, strs):
    """First-match span parity with re.search (leftmost-first)."""
    col = dev(strs)
    dp = rx.get_program(pattern)
    from custrings.ops import layout

    chars, nch = layout.char_matrix(col)
    import jax.numpy as jnp

    n = col.size
    m, b, e = dp.run_spans(
        chars, nch, jnp.zeros(n, jnp.int32), jnp.full(n, -1, jnp.int32), 0
    )
    for i, s in enumerate(strs):
        mm = re.search(pattern, s)
        if mm is None:
            assert int(m[i]) == 0, f"{pattern} on {s!r}: spurious match"
        else:
            assert int(m[i]) == 1, f"{pattern} on {s!r}: missed match"
            assert (int(b[i]), int(e[i])) == (mm.start(), mm.end()), (
                f"{pattern} on {s!r}: got ({int(b[i])},{int(e[i])}) "
                f"want {(mm.start(), mm.end())}"
            )


@pytest.mark.parametrize(
    "find,repl",
    [("@\\S+", "***"), ("@\\S+", ""), ("(?:@|https?://)\\S+", "***"),
     ("(?:@|https?://)\\S+", "")],
)
def test_replace_re(find, repl):
    s = [
        "hello @abc @def world",
        "The quick brown @fox jumps",
        "over the",
        "lazy @dog",
        "hello http://www.world.com I'm here @home",
    ]
    col = dev(s)
    got = host(rx.replace_re(col, find, repl))
    exp = [re.sub(find, repl, x) for x in s]
    assert got == exp


def test_replace_no_match_anywhere():
    # zero matches across the whole column: replace is the identity
    # (regression: _splice indexed an empty span array, round-3 verify)
    s = ["hello world", "over the", "lazy dog"]
    col = dev(s)
    assert host(rx.replace_re(col, r"(\w+)@(\w+)", "X")) == s


def test_replace_word_boundary():
    s = [
        "xxx 1281151 xxxxxx xxxxxxx xxxx xxxx - xxxxx xxxx xx 24",
        "2-xxxx xxxxxxxxxxx xxxxxxxxxx xxx26x4xxx xxxxxxxxxxxx xxxxx xxxxx",
    ]
    col = dev(s)
    got = host(rx.replace_re(col, r"\b\d+\b", "*****"))
    exp = [re.sub(r"\b\d+\b", "*****", x) for x in s]
    assert got == exp


def test_replace_re_limit():
    col = dev(["a1b2c3"])
    got = host(rx.replace_re(col, "\\d", "#", n=2))
    assert got == ["a#b#c3"]


def test_findall_columns():
    col = dev(["hello", "and héllo", "this was empty", ""])
    cols = rx.findall_columns(col, "[aA]")
    assert host(cols[0]) == [None, "a", "a", None]


def test_findall_record():
    col = dev(["hello", "and héllo", "this was empty", "", "another"])
    tc = rx.findall_record(col, "[aA]")
    toks = host(tc.tokens)
    offs = list(tc.row_offsets)
    got = [toks[offs[i] : offs[i + 1]] for i in range(tc.nrows)]
    assert got == [[], ["a"], ["a"], [], ["a"]]


def test_extract():
    pattern = r"Flight:([A-Z]+)(\d+)"
    s = [
        "ALA-PEK Flight:HU7934",
        "HKT-PEK Flight:CA822",
        "FRA-PEK Flight:LA8769",
        "FRA-PEK Flight:LH7332",
        "",
        None,
        "Flight:ZZ",
    ]
    col = dev(s)
    got = rx.extract(col, pattern)
    assert host(got[0]) == ["HU", "CA", "LA", "LH", None, None, None]
    assert host(got[1]) == ["7934", "822", "8769", "7332", None, None, None]


def test_backrefs():
    col = dev(["hello-world", "sep-arated", "nodash"])
    got = host(
        rx.replace_with_backrefs(col, r"(\w+)-(\w+)", r"\2_\1")
    )
    exp = [re.sub(r"(\w+)-(\w+)", r"\2_\1", s) for s in
           ["hello-world", "sep-arated", "nodash"]]
    assert got == exp


def test_counted_repeat_expansion():
    col = dev(["aaa", "aaaa", "aa", "b"])
    got = list(np.asarray(rx.contains_re(col, "a{3}")))
    assert got == [True, True, False, False]
    got = list(np.asarray(rx.contains_re(col, "^a{2,3}$")))
    assert got == [True, False, True, False]


def test_anchors_multiline_dollar():
    # reference semantics: '$' matches before any '\n' (regexec.inl:315)
    col = dev(["abc\ndef", "abc"])
    got = list(np.asarray(rx.contains_re(col, "abc$")))
    assert got == [True, True]


def test_octal_and_hex_escape():
    col = dev(["@", "A", "\x07"])
    assert list(np.asarray(rx.contains_re(col, "\\100"))) == [
        True, False, False,
    ]
    assert list(np.asarray(rx.contains_re(col, "\\x41"))) == [
        False, True, False,
    ]


def test_extract_record_api():
    from custrings import nvstrings as nvs

    pattern = r"Flight:([A-Z]+)(\d+)"
    s = ["ALA-PEK Flight:HU7934", "", None, "Flight:ZZ"]
    got = nvs.to_device(s).extract_record(pattern)
    assert got[0].to_host() == ["HU", "7934"]
    assert got[1].to_host() == [None, None]
    assert got[2].to_host() == [None, None]
    assert got[3].to_host() == [None, None]


def test_replace_multi_single_pass():
    # single-pass: replacements are not re-scanned by later patterns, and
    # at a position tie the lower-index pattern wins
    col = dev(["a1 b2 c3"])
    got = host(rx.replace_multi_re(col, [r"a\d", r"b\d"], ["b9", "X"]))
    # "a1" -> "b9" must NOT then match "b\d"
    assert got == ["b9 X c3"]


def test_replace_multi_tie():
    col = dev(["abc"])
    got = host(rx.replace_multi_re(col, [r"ab", r"abc"], ["1", "2"]))
    assert got == ["1c"]  # earliest position, first pattern listed wins


@pytest.mark.parametrize("pattern", [
    "\\d", "\\w+", "[Hh]ello [Ww]orld", "\\bworld\\b", ".*c",
    # >32-inst programs: multi-word membership planes (round 2)
    "\\w{10,40}", "(\\d+[a-c]{3,9}){2,4}", "[a-h]{30,70}",
    "[^o]{3,40}\\b\\w+",  # NCCLASS lanes past word 0
])
def test_pallas_nfa_matches_xla(pattern):
    """Bit-parallel matcher kernel (interpret mode) vs the XLA engine for
    programs of at most 32 instructions; longer programs stay on the XLA
    engine on every route."""
    from custrings.ops import layout
    from custrings.regex.pallas_nfa import BitNFA, bit_supported

    col = dev(S30)
    chars, nch = layout.char_matrix(col)
    dp = rx.get_program(pattern)
    if not bit_supported(dp):
        assert not rx.use_bit_kernel(pattern)
        with pytest.raises(ValueError):
            BitNFA(dp)
        return
    nfa = BitNFA(dp)
    for anchored in (False, True):
        ref = np.asarray(dp.nfa_matches(chars, nch, anchored))
        for ascii in (False, True) if all(
            s is None or s.isascii() for s in S30
        ) else (False,):
            got = np.asarray(nfa.matches(chars, nch, anchored, ascii, True))
            assert ref.tolist() == got.tolist(), (pattern, anchored, ascii)


def test_non_bmp_class_ranges():
    # Explicit class ranges compare at FULL codepoint width (regexec.inl
    # dreclass::is_match range loop precedes the 16-bit gate); builtin
    # shorthands stay 16-bit-limited and NCCLASS inverts the no-match.
    col = dev(["a\U0001F600b", "ab", "\U0001F64Fxx", "\U0001F700", None])
    got = np.asarray(rx.contains_re(col, "[\U0001F600-\U0001F64F]")).tolist()
    assert got == [True, False, True, False, False]
    # builtins do not reach past the BMP (docs/source/unicode.md model)
    assert np.asarray(rx.contains_re(dev(["\U0001F600"]), "\\w")).tolist() == [False]
    # ...but a negated class over a no-match is a match
    assert np.asarray(rx.contains_re(dev(["\U0001F600"]), "[^a]")).tolist() == [True]
    # extract through a full-width range
    got = rx.extract(dev(["x\U0001F600\U0001F601y"]), "([\U0001F600-\U0001F64F]+)")
    assert host(got[0]) == ["\U0001F600\U0001F601"]


def test_priority_nullable_quantifier_chains():
    # two engine-selection/priority regressions found by fuzzing:
    # 1. r"\d?(\d.c*)*": leftmost-FIRST (priority) != leftmost-longest,
    #    so the min-plus fast path must not claim it (longest_safe gate)
    # 2. r"(c*)+([^a]*a?)?": the exact executor's eps-expansion must be
    #    DFS (regexec.inl addthread order) — BFS rounds invert priority
    #    around empty-quantifier loops
    import re

    def ref_replace(rx, c):
        parts, cur, i = [], 0, 0
        while i <= len(c):
            m = rx.search(c, i)
            if not m:
                break
            parts.append(c[cur:m.start()])
            parts.append("#")
            cur = max(cur, m.end())
            i = m.end() if m.end() > m.start() else i + 1
        parts.append(c[cur:])
        return "".join(parts)

    corpus = ["1 ", "0b0", "1cac b", "0aa0b", "c b", "0ac0bb1", "b", ""]
    for pat in [r"\d?(\d.c*)*", r"(c*)+([^a]*a?)?", r"(c*)+(b*a?)?"]:
        rx = re.compile(pat)
        from custrings.regex.ops import replace_re

        got = host(replace_re(dev(corpus), pat, "#"))
        assert got == [ref_replace(rx, c) for c in corpus], (pat, got)


def test_longest_safe_gate():
    from custrings.regex.ops import get_program

    assert get_program(r"#\w+").prog.longest_safe        # fast path kept
    assert get_program(r"\w*").prog.longest_safe          # trailing * ok
    assert not get_program(r"\d?(\d.c*)*").prog.longest_safe
    assert not get_program(r"a?b").prog.longest_safe


def test_length_buckets_parity():
    # VERDICT r1 item 7: a single 4KB outlier must not force max-width work
    # on every row; results must be identical either way.
    import os

    from custrings.ops import layout

    corpus = (["short %d x" % i for i in range(300)]
              + ["the quick brown fox #tag jumps"] * 100
              + ["z" * 2000 + " end42 #deep", None])
    col = dev(corpus)
    bks = layout.length_buckets(col)
    assert bks is not None and len(bks) >= 2
    assert sum(b.nv for b in bks) == len(corpus)
    assert max(b.width for b in bks) >= 2000
    assert min(b.width for b in bks) < 256

    os.environ["CUSTRINGS_LENGTH_BUCKETS"] = "0"
    try:
        flat_contains = np.asarray(rx.contains_re(dev(corpus), r"#\w+"))
        flat_counts = np.asarray(rx.count_re(dev(corpus), r"\d+"))
        flat_repl = host(rx.replace_re(dev(corpus), r"\d+", "N"))
    finally:
        del os.environ["CUSTRINGS_LENGTH_BUCKETS"]
    got_contains = np.asarray(rx.contains_re(col, r"#\w+"))
    got_counts = np.asarray(rx.count_re(col, r"\d+"))
    got_repl = host(rx.replace_re(col, r"\d+", "N"))
    assert got_contains.tolist() == flat_contains.tolist()
    assert got_counts.tolist() == flat_counts.tolist()
    assert got_repl == flat_repl
    # oracle spot-check on the outlier + a short row
    import re as pyre

    assert bool(got_contains[-2]) is True
    assert int(got_counts[0]) == len(pyre.findall(r"\d+", corpus[0]))
    assert got_repl[-2] == pyre.sub(r"\d+", "N", corpus[-2])


def test_sentinel_injection_gate():
    # starts must not inject past EOS: padded sentinel slots see prev=0
    # and would otherwise satisfy \B$ (regexec walks only 0..len)
    corpus = ["ab", "x" * 40, "", "word "]
    for pat in [r"\B$", r"\b$", r"$", r"\B"]:
        got = np.asarray(rx.contains_re(dev(corpus), pat)).tolist()
        exp = [bool(re.search(pat, s)) for s in corpus]
        if r"\B" in pat:
            # Python re quirk: \B never matches "" ; the reference computes
            # NBOW as alnum(prev)!=alnum(cur) (regexec.inl:323-329), which
            # holds at the sole position of an empty string -> match
            exp[2] = True
        assert got == exp, (pat, got, exp)


@pytest.mark.parametrize("pattern", PATTERNS + [r"\bworld\b", r"^x", r"o$"])
def test_chunked_matches_parity(pattern):
    # chunked transfer-matrix engine == vector engine == Python re,
    # across chunk sizes that do and don't divide the padded width
    from custrings.ops import layout
    from custrings.regex.ops import get_program

    corpus = S30 + ["x" * 100 + "Hello world !" + "y" * 80, "world" * 40]
    col = dev(corpus)
    chars, nch = layout.char_matrix(col)
    dp = get_program(pattern)
    for anchored in (False, True):
        ref = np.asarray(dp.nfa_matches(chars, nch, anchored))
        for G in (16, 64, 100):
            got = np.asarray(
                dp.nfa_matches_chunked(chars, nch, anchored, G)
            )
            assert got.tolist() == ref.tolist(), (pattern, anchored, G)
        exp = [
            bool((re.match if anchored else re.search)(pattern, s))
            for s in corpus
        ]
        assert ref.tolist() == exp, (pattern, anchored, "vector-vs-re")
