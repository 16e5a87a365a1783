"""Fixed-seed property fuzz: random corpora/patterns vs Python oracles.

Compact versions of the sweeps that found the last-token scatter bug,
the regex priority bugs, and the ß casing rule — kept as regressions.
"""

import random
import re

import numpy as np

import custrings.nvstrings as nvs

ALPH = ["a", "b", "Z", "é", "中", "\U0001F389", " ", "0", "_", "\x00"]


def _corpus(rng, k=25):
    out = []
    for _ in range(k):
        r = rng.random()
        if r < 0.12:
            out.append(None)
        else:
            out.append(
                "".join(
                    rng.choice(ALPH) for _ in range(rng.randint(0, 10))
                )
            )
    return out


def test_fuzz_strings_ops_vs_python():
    rng = random.Random(42)
    for _ in range(4):
        corpus = _corpus(rng)
        s = nvs.to_device(corpus)
        assert s.lower().to_host() == [
            None if c is None else c.lower() for c in corpus
        ]
        assert s.strip().to_host() == [
            None if c is None else c.strip(" \n\t") for c in corpus
        ]
        assert s.slice(1, 3).to_host() == [
            None if c is None else c[1:3] for c in corpus
        ]
        assert s.replace("a", "XY", regex=False).to_host() == [
            None if c is None else c.replace("a", "XY") for c in corpus
        ]
        assert s.len() == [None if c is None else len(c) for c in corpus]


def _ref_spans(rx, c):
    out, i = [], 0
    while i <= len(c):
        m = rx.search(c, i)
        if not m:
            break
        out.append((m.start(), m.end()))
        i = m.end() if m.end() > m.start() else i + 1
    return out


def test_fuzz_regex_replace_vs_re():
    rng = random.Random(99)
    atoms = ["a", "b", "c", r"\d", r"\w", "[abc]", "[^a]", "."]
    quant = ["", "*", "+", "?"]

    def rnd_pat(depth=0):
        parts = []
        for _ in range(rng.randint(1, 3)):
            if depth < 1 and rng.random() < 0.3:
                parts.append("(" + rnd_pat(depth + 1) + ")" + rng.choice(quant))
            else:
                parts.append(rng.choice(atoms) + rng.choice(quant))
        return "".join(parts)

    alph = "abc 01"
    trials = 0
    for _ in range(30):
        if trials >= 8:
            break
        pat = rnd_pat()
        try:
            rx = re.compile(pat)
        except re.error:
            continue
        trials += 1
        corpus = [
            "".join(rng.choice(alph) for _ in range(rng.randint(0, 8)))
            for _ in range(10)
        ] + [None, ""]
        got = nvs.to_device(corpus).replace(pat, "#").to_host()
        exp = []
        for c in corpus:
            if c is None:
                exp.append(None)
                continue
            parts, cur = [], 0
            for (b, e) in _ref_spans(rx, c):
                parts.append(c[cur:b])
                parts.append("#")
                cur = max(cur, e)
            parts.append(c[cur:])
            exp.append("".join(parts))
        assert got == exp, (pat, got, exp)


def test_fuzz_convert_roundtrips():
    rng = random.Random(3)
    vals = [0, 1, -1, 2**31 - 1, -(2**31)] + [
        rng.randint(-(10**9), 10**9) for _ in range(15)
    ]
    assert nvs.itos(np.asarray(vals, np.int32)).stoi() == vals
    ips = [0, 2**32 - 1] + [rng.randint(0, 2**32 - 1) for _ in range(10)]
    assert nvs.int2ip(np.asarray(ips, np.uint32)).ip2int() == ips
    strs = [
        "".join(rng.choice("az09 -._~%+é中") for _ in range(rng.randint(0, 12)))
        for _ in range(20)
    ]
    assert nvs.to_device(strs).url_encode().url_decode().to_host() == strs


def test_fuzz_sort_bytewise():
    rng = random.Random(21)
    for _ in range(3):
        corpus = []
        for _ in range(rng.randint(2, 20)):
            r = rng.random()
            if r < 0.1:
                corpus.append(None)
            else:
                corpus.append(
                    "".join(
                        rng.choice("abAB0é中")
                        for _ in range(rng.randint(0, 5))
                    )
                )
        got = nvs.to_device(corpus).sort(2).to_host()
        exp = [None] * sum(1 for c in corpus if c is None) + sorted(
            (c for c in corpus if c is not None),
            key=lambda s: s.encode("utf-8"),
        )
        assert got == exp, (corpus, got, exp)
