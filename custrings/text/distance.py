"""Levenshtein edit distance + Porter stemmer measure.

Array re-design of cpp/src/text/edit_distance.cu (anti-diagonal 3-line
DP, :33-117) and stemmer.cu (:29-104).  The DP runs as a lax.scan over
columns of the padded char matrices with all rows in parallel — a row-
vectorized Wagner-Fischer (two-row formulation) rather than per-pair threads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..column import StringColumn
from ..ops import layout


def _char_matrix(col: StringColumn, width: int):
    """int32[rows, width] codepoint matrix, -1 padded, plus char counts."""
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    ncap = cps.shape[0]
    nch = cm.nchars()
    j = jnp.arange(width, dtype=jnp.int32)[None, :]
    g = jnp.clip(cm.char_offsets[:-1][:, None] + j, 0, max(ncap - 1, 0))
    mat = jnp.where(j < nch[:, None], cps[g], -1)
    return mat, nch


def _ed_scalar_mat(mat, nch, validity, tgt, tlen: int) -> jax.Array:
    """Distance-to-target DP on a padded char matrix (core of the scalar
    variant; runs once per length bucket)."""
    n, w = mat.shape
    # DP over target prefix: state = current row of the DP table, one entry
    # per column position 0..w ; iterate over target chars
    j = jnp.arange(w + 1, dtype=jnp.int32)[None, :]
    init = jnp.broadcast_to(j, (n, w + 1)).astype(jnp.int32)

    def step(prev, ti):
        tc = tgt[jnp.minimum(ti, max(tlen - 1, 0))]
        sub_cost = (mat != tc).astype(jnp.int32)  # [n, w]
        # cur[0] = ti+1 ; cur[k] = min(prev[k]+1, cur[k-1]+1,
        #                              prev[k-1]+sub(k-1))
        # the cur[k-1] dependency is a running min-scan:
        # cur[k] = min_{p<=k}( seed[p] + (k-p) ) with
        # seed[k]=min(prev[k]+1, prev[k-1]+sub) and seed[0]=ti+1
        seed = jnp.minimum(
            prev[:, 1:] + 1, prev[:, :-1] + sub_cost
        )  # [n, w] for k=1..w
        seed = jnp.concatenate(
            [jnp.full((n, 1), ti + 1, jnp.int32), seed], axis=1
        )
        shifted = seed - j  # min-scan of (seed[k]-k) then add k back
        runmin = jax.lax.cummin(shifted, axis=1)
        cur = runmin + j
        return cur, None

    final, _ = jax.lax.scan(step, init, jnp.arange(max(tlen, 1)))
    if tlen == 0:
        final = init
    d = jnp.take_along_axis(final, jnp.minimum(nch, w)[:, None], axis=1)[:, 0]
    return jnp.where(validity, d, 0)


def edit_distance_scalar(col: StringColumn, target: str) -> jax.Array:
    """Levenshtein distance of each row to `target` (edit_distance.cu:119).

    Length-bucketed (VERDICT r1 item 7): the O(rows * width * |target|) DP
    runs per length class so one long outlier row does not widen every
    row's DP table."""
    tgt = jnp.asarray([ord(c) for c in target] or [0], jnp.int32)
    tlen = len(target)
    bks = layout.length_buckets(col)
    if bks is None:
        w = max(layout.max_row_bytes(col), 1)
        mat, nch = _char_matrix(col, w)
        return _ed_scalar_mat(mat, nch, col.validity, tgt, tlen)
    out = jnp.zeros(col.size + 1, jnp.int32)
    for bk in bks:
        mat, nch = layout.char_matrix_rows(col, bk)
        d = _ed_scalar_mat(mat, nch, bk.vmask, tgt, tlen)
        out = out.at[bk.idx_s].set(d)
    return out[: col.size]


def edit_distance_pairwise(col: StringColumn, other: StringColumn) -> jax.Array:
    """Row-wise distance between two columns (edit_distance.cu:172)."""
    w1 = max(layout.max_row_bytes(col), 1)
    w2 = max(layout.max_row_bytes(other), 1)
    a, alen = _char_matrix(col, w1)
    b, blen = _char_matrix(other, w2)
    n = col.size
    j = jnp.arange(w1 + 1, dtype=jnp.int32)[None, :]
    init = jnp.broadcast_to(j, (n, w1 + 1)).astype(jnp.int32)

    def step(prev, ti):
        tc = b[:, ti][:, None]  # per-row target char
        active = (ti < blen)[:, None]  # rows still in their target
        sub_cost = (a != tc).astype(jnp.int32)
        seed = jnp.minimum(prev[:, 1:] + 1, prev[:, :-1] + sub_cost)
        seed = jnp.concatenate(
            [jnp.full((n, 1), ti + 1, jnp.int32), seed], axis=1
        )
        shifted = seed - j
        runmin = jax.lax.cummin(shifted, axis=1)
        cur = runmin + j
        cur = jnp.where(active, cur, prev)
        return cur, None

    final, _ = jax.lax.scan(step, init, jnp.arange(w2))
    d = jnp.take_along_axis(final, alen[:, None], axis=1)[:, 0]
    return jnp.where(col.validity & other.validity, d, 0)


def porter_stemmer_measure(
    col: StringColumn, vowels: str = "aeiou", y_char: str = "y"
) -> jax.Array:
    """VC-sequence count with y-after-consonant-as-vowel handling
    (stemmer.cu:29-104)."""
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    ncap = cps.shape[0]
    c = jnp.arange(ncap, dtype=jnp.int32)
    cvalid = c < cm.cs0[-1]
    crows = layout.row_ids_from_offsets(cm.char_offsets, ncap)
    row_first = jnp.zeros(ncap, jnp.bool_).at[
        jnp.minimum(cm.char_offsets[:-1], max(ncap - 1, 0))
    ].set(True)
    is_vowel_plain = jnp.zeros(ncap, jnp.bool_)
    for v in set(vowels):
        is_vowel_plain = is_vowel_plain | (cps == ord(v))
    is_y = cps == ord(y_char)
    # consonant rule (stemmer.cu:36-45): vowels -> vowel; y at row start ->
    # consonant; otherwise y is consonant iff the previous char is a vowel,
    # i.e. within a y-run consonant-ness alternates.  Resolve runs without a
    # sequential scan: find each char's nearest previous "determined" char
    # (non-y, vowel, or row-first) with a running max, then XOR by parity of
    # the distance.
    determined = is_vowel_plain | ~is_y | row_first
    idx = jnp.arange(ncap, dtype=jnp.int32)
    det_idx = jax.lax.associative_scan(
        jnp.maximum, jnp.where(determined, idx, -1)
    )
    det_cons = jnp.where(is_vowel_plain, False, True)  # at determined chars
    base = det_cons[jnp.clip(det_idx, 0, None)]
    dist = idx - det_idx
    cons = jnp.where(determined, det_cons, base ^ (dist % 2 == 1))
    n = col.size
    vowel = ~cons & cvalid
    prev_vowel = jnp.roll(vowel, 1).at[0].set(False) & ~row_first
    vc = cons & cvalid & prev_vowel
    # count VC transitions per row: consonant preceded by vowel run
    counts = jnp.zeros(n, jnp.int32).at[crows].add(vc.astype(jnp.int32))
    return jnp.where(col.validity, counts, 0)
