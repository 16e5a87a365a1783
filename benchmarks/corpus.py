"""Seeded tweet-shaped corpus generator (no downloads).

Shape, after public tweet collections:
  - words drawn from a Zipf(1.1) vocabulary of 50k lowercase words whose
    head is common English ("the", "that", ...);
  - hashtags (#tag), @mentions and t.co-style URLs mixed into the stream;
  - heavy-tailed row lengths capped at 280 characters, with the spike
    near the cap that tweet length histograms show;
  - ~5% of rows with 2-, 3- or 4-byte UTF-8 words (accented Latin, CJK,
    emoji);
  - ~1% empty rows and ~1% nulls.

Rows are cut from one token stream at heavy-tailed byte targets, so the
generator is a few vectorized draws plus one join per row.
"""

from __future__ import annotations

import numpy as np

MAX_CHARS = 280

_HEAD = (
    "the to a and i of in is you that it for on my me be this with have "
    "so just at not are was but all your we like can get out what do up "
    "love no one now new good day know will time go from how if they "
    "there their then them these those other"
).split()

_NON_ASCII = (
    "café naïve über señor déjà façade crème jalapeño björk smörgåsbord "
    "müller garçon résumé zoë ångström "
    "日本 東京 こんにちは 中文 漢字 北京 大阪 ありがとう 한국어 서울 "
    "🎉 😀 🔥 👍 🚀 ❤️‍🔥 🤖 🌍"
).split()

_ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8,
)


def _random_words(rng, n, lo, hi, alphabet):
    lens = rng.integers(lo, hi + 1, n)
    flat = alphabet[rng.integers(0, len(alphabet), int(lens.sum()))]
    ends = np.cumsum(lens)
    buf = flat.tobytes().decode("ascii")
    return [buf[e - k : e] for e, k in zip(ends.tolist(), lens.tolist())]


def _zipf_p(n, s=1.1):
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


def vocabulary(rng):
    """(tokens list[str], kind-wise index ranges) of the generator."""
    lower = _ALNUM[:26]
    words = list(dict.fromkeys(
        _HEAD + _random_words(rng, 60_000, 2, 11, lower)
    ))[:50_000]
    tags = ["#" + w for w in words[40:2040]] + [
        "#" + w for w in _random_words(rng, 3000, 3, 14, _ALNUM)
    ]
    users = ["@" + w for w in _random_words(rng, 20_000, 3, 15, _ALNUM)]
    urls = [
        "https://t.co/" + w for w in _random_words(rng, 50_000, 10, 10, _ALNUM)
    ]
    return words, tags, users, urls, list(_NON_ASCII)


#: rows per independently drawn chunk (the vocabulary is shared)
CHUNK = 1 << 20


def tweets(n_rows: int, seed: int = 0, workers: int = 1) -> list:
    """n_rows tweet-shaped rows (str, "" or None), deterministic in seed
    (and independent of `workers`, which only spreads the chunks over
    spawned worker processes)."""
    chunks = [
        (seed, c, min(CHUNK, n_rows - c * CHUNK))
        for c in range(-(-n_rows // CHUNK))
    ]
    if workers > 1 and len(chunks) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(chunks)),
                                 mp_context=ctx) as ex:
            parts = list(ex.map(_chunk, chunks))
    else:
        parts = [_chunk(c) for c in chunks]
    return [r for p in parts for r in p]


def _chunk(args) -> list:
    seed, c, n_rows = args
    words, tags, users, urls, uni = vocabulary(np.random.default_rng(seed))
    rng = np.random.default_rng((seed, c))
    # per-row byte targets: 60% lognormal body, 40% near the 280 cap;
    # targets stop short of the cap so the token that crosses a row
    # boundary cannot push a row past it
    body = np.minimum(rng.lognormal(np.log(110.0), 0.6, n_rows), 250.0)
    near_cap = rng.uniform(215.0, 250.0, n_rows)
    target = np.where(rng.random(n_rows) < 0.6, body, near_cap)
    target = np.maximum(target, 1.0)
    n_tok = int(target.sum() / 5.0) + 64
    # token kinds: word, hashtag, mention, URL, non-ASCII word
    kind = rng.choice(5, n_tok, p=[0.893, 0.05, 0.04, 0.015, 0.002])
    pools = (words, tags, users, urls, uni)
    pick = np.empty(n_tok, np.int64)
    for k, pool in enumerate(pools):
        sel = np.nonzero(kind == k)[0]
        if k == 3:  # URLs are near-unique
            pick[sel] = rng.integers(0, len(pool), sel.size)
        else:
            pick[sel] = rng.choice(len(pool), sel.size, p=_zipf_p(len(pool)))
    base = np.cumsum([0] + [len(p) for p in pools])
    table = [t for p in pools for t in p]
    tok_ids = pick + base[kind]
    tok_bytes = np.asarray([len(t.encode()) + 1 for t in table])[tok_ids]
    ends = np.cumsum(tok_bytes)
    cuts = np.searchsorted(ends, np.cumsum(target), side="right")
    cuts = np.minimum(cuts, n_tok)
    starts = np.concatenate([[0], cuts[:-1]])
    toks = [table[i] for i in tok_ids.tolist()]
    rows = []
    for a, b in zip(starts.tolist(), cuts.tolist()):
        s = " ".join(toks[a:b])
        while len(s) > MAX_CHARS:
            s = s[: s.rindex(" ")]
        rows.append(s)
    special = rng.random(n_rows)
    for i in np.nonzero(special < 0.01)[0].tolist():
        rows[i] = None
    for i in np.nonzero((special >= 0.01) & (special < 0.02))[0].tolist():
        rows[i] = ""
    return rows
