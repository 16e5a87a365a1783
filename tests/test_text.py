"""nvtext parity tests (reference: python/tests/test_text.py style)."""

import numpy as np

from custrings import column
from custrings.ops import unique
from custrings.text import distance, ngram, token


def dev(strs):
    return column.from_host_strings(strs)


def host(col):
    return column.to_host_strings(col)


CORPUS = ["the quick fox jumped over the lazy dog",
          "the siamésé cat jumped under the sofa", None, ""]


def test_tokenize():
    got = host(token.tokenize(dev(CORPUS)))
    exp = []
    for s in CORPUS:
        if s:
            exp.extend(s.split())
    assert got == exp


def test_tokenize_multi_delim():
    got = host(token.tokenize(dev(["a,b;c", "x,,y"]), ",;"))
    assert got == ["a", "b", "c", "x", "y"]


def test_token_count():
    got = list(token.token_count(dev(CORPUS), " "))
    assert got == [8, 7, 0, 0]


def test_unique_tokens():
    got = host(token.unique_tokens(dev(CORPUS), " "))
    exp = sorted(
        set(
            t
            for s in CORPUS
            if s
            for t in s.split()
        )
    )
    assert got == exp


def test_normalize_spaces():
    corpus = ["  the\t quick  brown   fox ", "hello", None, "", "   "]
    got = host(token.normalize_spaces(dev(corpus)))
    exp = [
        " ".join(s.split()) if s is not None else None for s in corpus
    ]
    assert got == exp


def test_replace_tokens():
    corpus = ["the quick fox", "fox the", None, "foxx"]
    got = host(
        token.replace_tokens(
            dev(corpus), dev(["fox", "the"]), dev(["bear", "a"])
        )
    )
    assert got == ["a quick bear", "bear a", None, "foxx"]


def test_tokens_counts():
    got = np.asarray(
        token.tokens_counts(dev(["a b a", "b b", None]), dev(["a", "b"]))
    )
    assert got.tolist() == [[2, 1], [0, 2], [0, 0]]


def test_contains_strings():
    got = np.asarray(
        token.contains_strings(dev(["hello", "goodbye", None]), dev(["ell", "oo"]))
    )
    assert got.tolist() == [[True, False], [False, True], [False, False]]


def test_strings_counts():
    got = np.asarray(
        token.strings_counts(dev(["banana", "nana", None]), dev(["na", "an"]))
    )
    assert got.tolist() == [[2, 2], [2, 1], [0, 0]]


def test_scatter_count():
    got = host(token.scatter_count(dev(["a", "b", "c"]), [2, 0, 3]))
    assert got == ["a", "a", "c", "c", "c"]


def test_edit_distance_scalar():
    corpus = ["kitten", "sitting", "", None, "puffy"]
    got = list(distance.edit_distance_scalar(dev(corpus), "puppy"))
    try:
        import Levenshtein  # noqa

        have = True
    except ImportError:
        have = False
    exp = [_lev(s, "puppy") if s is not None else 0 for s in corpus]
    assert got == exp


def test_edit_distance_pairwise():
    a = ["kitten", "flaw", None]
    b = ["sitting", "lawn", "x"]
    got = list(distance.edit_distance_pairwise(dev(a), dev(b)))
    exp = [_lev(a[i], b[i]) if a[i] is not None else 0 for i in range(3)]
    assert got == exp


def _lev(a, b):
    dp = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev = dp[0]
        dp[0] = i
        for j, cb in enumerate(b, 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (ca != cb))
            prev = cur
    return dp[-1]


def test_ngrams():
    col = dev(["this", "is", "my", "favorite", "book"])
    got = host(ngram.create_ngrams(col, 2, "_"))
    assert got == ["this_is", "is_my", "my_favorite", "favorite_book"]


def test_ngrams_with_nulls():
    col = dev(["a", None, "", "b", "c"])
    got = host(ngram.create_ngrams(col, 2, "-"))
    assert got == ["a-b", "b-c"]


def test_porter_measure():
    # classic examples: tr=1? known measures: "tree"->0 is false; standard:
    # m("tr")=0, m("ee")=0, m("tree")=0, m("trouble")=1, m("oats")=1,
    # m("trees")=1, m("ivy")=1, m("troubles")=2, m("private")=2
    corpus = ["tr", "ee", "tree", "trouble", "oats", "trees", "ivy",
              "troubles", "private", None]
    got = list(distance.porter_stemmer_measure(dev(corpus)))
    assert got == [0, 0, 0, 1, 1, 1, 1, 2, 2, 0]


def test_dictionary_encode():
    col = dev(["eee", "aaa", "eee", "ddd", "ccc", "ccc", "ccc", "eee", "aaa"])
    keys, values = unique.dictionary_encode(col)
    assert host(keys) == ["aaa", "ccc", "ddd", "eee"]
    assert list(values) == [3, 0, 3, 2, 1, 1, 1, 3, 0]


def test_dictionary_encode_nulls():
    col = dev(["b", None, "a", None, "b"])
    keys, values = unique.dictionary_encode(col)
    assert host(keys) == [None, "a", "b"]
    assert list(values) == [2, 0, 1, 0, 2]


def test_searchsorted_keys():
    keys, _ = unique.dictionary_encode(dev(["b", "a", "c", "a"]))
    q = unique.searchsorted_keys(keys, dev(["a", "c", "zz", "b", None]))
    assert list(q) == [0, 2, -1, 1, -1]


def test_tokenize_multi_string_delims():
    # reference semantics (tokens.cu tokenize(strs, delims)): first listed
    # delimiter wins at a position; its length is skipped; empties dropped
    def oracle(s, delims):
        out, cur, i = [], "", 0
        while i < len(s):
            for d in delims:
                if d and s.startswith(d, i):
                    out.append(cur)
                    cur = ""
                    i += len(d)
                    break
            else:
                cur += s[i]
                i += 1
        out.append(cur)
        return [t for t in out if t]

    corpus = ["a--b-c", "x<>y--z", "--", "plain", None, "a<>--b"]
    delims = ["<>", "--", "-"]
    col = dev(corpus)
    got = host(token.tokenize_strings(col, dev(delims)))
    exp = []
    for s in corpus:
        if s is not None:
            exp.extend(oracle(s, delims))
    assert got == exp, (got, exp)


def test_edit_distance_scalar_bucketed():
    # bucketed DP (length buckets active at >=256 rows) must match the oracle
    def lev(a, b):
        import numpy as _np
        d = _np.arange(len(b) + 1)
        for i, ca in enumerate(a):
            prev = d.copy()
            d[0] = i + 1
            for j, cb in enumerate(b):
                d[j + 1] = min(prev[j + 1] + 1, d[j] + 1, prev[j] + (ca != cb))
        return d[-1]

    corpus = ["word%d" % i for i in range(300)] + ["x" * 1500 + "puppy"]
    from custrings.ops import layout

    col = dev(corpus)
    assert layout.length_buckets(col) is not None
    got = list(distance.edit_distance_scalar(col, "puppy"))
    exp = [lev(s, "puppy") for s in corpus]
    assert [int(x) for x in got] == exp
