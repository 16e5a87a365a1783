"""ordered_spans (vectorized priority-closure engine) vs run_spans (the
per-row DFS reference executor) — span-exact equivalence across the
ambiguous-pattern space the DFS previously owned: alternation, lazy
quantifiers, captures, anchors, word boundaries, counted repeats."""

import numpy as np
import pytest

from custrings import column
from custrings.regex.ops import get_program
from custrings.ops import layout

CORPUS = [
    "5", "hej", "\t \n", "12345", "\\", "d", "c:\\Tools", "+27", "1c2",
    "0:00:0", "00:00:00", "Hello world !", "Hello world!   ",
    "0123456789", "Xaa", "abcdefghxxx", "ABCDEFGH", "abc def",
    "abc\ndef", "aa\r\nbb\r\ncc\r\n\r\n", "abcabc", "", "aaa",
    "user@mail.example", "x+y=z", "ab", "ba", "abba", "aabbaabb",
    "the the the", "cat hat bat", "aaaa", "abab", "a|b literal",
]

AMBIGUOUS = [
    r"a|b",
    r"ab|ba",
    r"a+?",
    r"a*?b",
    r"(a|ab)(c|bcd)",
    r"(\w+)@(\w+)",
    r"(a+)(b+)?",
    r"a{2,4}",
    r"(ab)+",
    r"th(e|at)",
    r".*?b",
    r"^(a|ab)",
    r"(a|b)*c",
    r"\b(\w)",
    r"(h.t)|(b.t)",
    r"x?y?z?",
    r"a$|^b",
]


def _mats(col):
    w = max(layout.max_row_bytes(col), 2)
    chars, nch = layout.char_matrix(col, w)
    return chars, nch


@pytest.mark.parametrize("pattern", AMBIGUOUS)
def test_spans_equivalence(pattern):
    col = column.from_host_strings(CORPUS)
    dp = get_program(pattern)
    chars, nch = _mats(col)
    n = col.size
    zeros = np.zeros(n, np.int32)
    none = np.full(n, -1, np.int32)
    for g in range(0, dp.groups_count + 1):
        m1, b1, e1 = [
            np.asarray(x)
            for x in dp.run_spans(chars, nch, zeros, none, g)
        ]
        m2, b2, e2 = [
            np.asarray(x)
            for x in dp.ordered_spans(chars, nch, zeros, none, g)
        ]
        bad = [
            (CORPUS[i], g, (m1[i], b1[i], e1[i]), (m2[i], b2[i], e2[i]))
            for i in range(n)
            if (m1[i] > 0) != (m2[i] > 0)
            or (m1[i] > 0 and (b1[i], e1[i]) != (b2[i], e2[i]))
        ]
        assert not bad, f"{pattern} g{g}: {bad[:4]}"


@pytest.mark.parametrize("pattern", [r"a|b", r"(ab)+", r"(\w+)@(\w+)"])
def test_spans_equivalence_windows(pattern):
    """Non-zero begins and closed ends windows (extract's usage)."""
    col = column.from_host_strings(CORPUS)
    dp = get_program(pattern)
    chars, nch = _mats(col)
    n = col.size
    rng = np.random.default_rng(5)
    begins = rng.integers(0, 4, n).astype(np.int32)
    ends = np.where(rng.random(n) < 0.5, -1, begins + 2).astype(np.int32)
    m1, b1, e1 = [
        np.asarray(x) for x in dp.run_spans(chars, nch, begins, ends, 0)
    ]
    m2, b2, e2 = [
        np.asarray(x)
        for x in dp.ordered_spans(chars, nch, begins, ends, 0)
    ]
    bad = [
        (CORPUS[i], begins[i], ends[i], (m1[i], b1[i], e1[i]),
         (m2[i], b2[i], e2[i]))
        for i in range(n)
        if (m1[i] > 0) != (m2[i] > 0)
        or (m1[i] > 0 and (b1[i], e1[i]) != (b2[i], e2[i]))
    ]
    assert not bad, f"{pattern}: {bad[:4]}"


def test_random_pattern_fuzz():
    """Random small patterns over a random a/b corpus: both engines agree."""
    rng = np.random.default_rng(17)
    atoms = ["a", "b", "ab", "a|b", "a+", "b*", "a+?", "(a|b)", "a{1,2}",
             "(ab|a)", "b?"]
    rows = [
        "".join(rng.choice(list("ab "), size=rng.integers(0, 9)))
        for _ in range(40)
    ]
    col = column.from_host_strings(rows)
    chars, nch = _mats(col)
    n = col.size
    zeros = np.zeros(n, np.int32)
    none = np.full(n, -1, np.int32)
    for trial in range(25):
        pat = "".join(rng.choice(atoms, size=rng.integers(1, 4)))
        try:
            dp = get_program(pat)
        except Exception:
            continue
        m1, b1, e1 = [
            np.asarray(x) for x in dp.run_spans(chars, nch, zeros, none, 0)
        ]
        m2, b2, e2 = [
            np.asarray(x)
            for x in dp.ordered_spans(chars, nch, zeros, none, 0)
        ]
        bad = [
            (rows[i], (m1[i], b1[i], e1[i]), (m2[i], b2[i], e2[i]))
            for i in range(n)
            if (m1[i] > 0) != (m2[i] > 0)
            or (m1[i] > 0 and (b1[i], e1[i]) != (b2[i], e2[i]))
        ]
        assert not bad, f"{pat}: {bad[:4]}"
