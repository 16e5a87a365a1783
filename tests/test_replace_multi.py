"""Reference replace_multi parity (python/tests/test_replace_multi.py)."""

import custrings.nvstrings as nvs
import custrings.nvtext as nvt

HSTRS = [
    "the quick brown fox jumps over the lazy dog",
    "the fat cat lays next to the other accénted cat",
    "a slow moving turtlé cannot catch the bird",
    "",
    None,
]

STOP_WORDS = (
    "i me my myself we our ours ourselves you your yours yourself "
    "yourselves he him his himself she her hers herself it its itself "
    "they them their theirs themselves what which who whom this that "
    "these those am is are was were be been being have has had having "
    "do does did doing a an the and but if or because as until while of "
    "at by for with about against between into through during before "
    "after above below to from up down in out on off over under again "
    "further then once here there when where why how all any both each "
    "few more most other some such no nor not only own same so than too "
    "very s t can will just don should now uses use using used one also"
).split()

STOPPED = [
    " quick brown fox jumps   lazy dog",
    " fat cat lays next    accénted cat",
    " slow moving turtlé cannot catch  bird",
    "",
    None,
]


def test_replace_multi_literal_scalar_repl():
    strs = nvs.to_device(HSTRS)
    got = strs.replace_multi(
        nvs.to_device(["the ", "a ", "in "]), " ", regex=False
    )
    assert got.to_host() == [
        " quick brown fox jumps over  lazy dog",
        " fat cat lays next to  other accénted cat",
        " slow moving turtlé cannot catch  bird",
        "",
        None,
    ]


def test_replace_multi_literal_pairs():
    strs = nvs.to_device(HSTRS)
    got = strs.replace_multi(
        nvs.to_device([" dog", " cat", " bird"]),
        nvs.to_device([" DOG", " CAT", " BIRD"]),
        regex=False,
    )
    assert got.to_host() == [
        "the quick brown fox jumps over the lazy DOG",
        "the fat CAT lays next to the other accénted CAT",
        "a slow moving turtlé cannot CATch the BIRD",
        "",
        None,
    ]


def test_replace_multi_re_recycled_repl():
    # 130 \b-anchored patterns, ONE repl recycled across all of them
    strs = nvs.to_device(HSTRS)
    pats = ["\\b" + w + "\\b" for w in STOP_WORDS]
    assert strs.replace_multi(pats, [""]).to_host() == STOPPED


def test_replace_tokens_scalar_repl():
    strs = nvs.to_device(HSTRS)
    got = nvt.replace_tokens(strs, nvs.to_device(STOP_WORDS), "")
    assert got.to_host() == STOPPED


def test_replace_tokens_last_token_of_column():
    # regression: masked scatters used the last valid token slot as the
    # dump index, clobbering the final token's extents
    strs = nvs.to_device(["the dog and the cat"])
    got = nvt.replace_tokens(strs, nvs.to_device(["dog", "cat"]), "Y")
    assert got.to_host() == ["the Y and the Y"]
    got = nvt.replace_tokens(
        nvs.to_device(["cat"]), nvs.to_device(["cat"]), "LONGER"
    )
    assert got.to_host() == ["LONGER"]
