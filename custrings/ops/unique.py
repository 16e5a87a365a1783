"""Sort-unique / dictionary-encode core.

Array re-design of NVCategoryImpl_init (cpp/src/category/
NVCategory.cu:220-304): sort_by_key -> adjacent-neq flags -> inclusive scan
(dense ranks) -> inverse-permutation scatter -> unique keys.  The pointer
comparator sort becomes a lexicographic jax.lax.sort over packed big-endian
uint32 key words (ops/array.py); everything else is the same algorithm in
array form.  Null sorts first and forms its own key (NVCategory.cu:250-255).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from .segments import cumsum as _cumsum

from ..column import StringColumn
from . import array, layout, segments

#: rows at or above this take the hash-grouped encode (below, the radix
#: path's single fused program wins on fixed overheads)
HASHED_MIN = 1 << 18


@partial(jax.jit, static_argnums=(1, 2))
def _encode_sorted(col: StringColumn, width: int, full_width: int):
    n = col.size
    ord_ = array._order_impl(col, width, array.SORT_NAME, True, True)
    words = array._key_words(col, width)  # [n, W] (possibly truncated)
    sw = words[ord_]  # sorted key words
    slen = col.lengths()[ord_]
    sval = col.validity[ord_]
    neq = jnp.zeros(n, jnp.bool_)
    ambiguous = jnp.zeros((), jnp.bool_)
    if n > 1:
        row_neq = (
            jnp.any(sw[1:] != sw[:-1], axis=1)
            | (slen[1:] != slen[:-1])
            | (sval[1:] != sval[:-1])
        )
        # two nulls are equal regardless of (zero-length) payload
        both_null = (~sval[1:]) & (~sval[:-1])
        neq = neq.at[1:].set(row_neq & ~both_null)
        if width < full_width:
            # Truncated-word tie between rows extending past the width: the
            # sort resolved it by LENGTH.  That order is correct iff the
            # rows agree on the compared region past the prefix (equal up
            # to min(len): duplicates, or prefix-extensions — shorter
            # sorts first, which IS lexicographic).  Compare the tails
            # exactly on device; only genuinely differing tails escalate.
            # (Round-2 perf fix: duplicates of >width rows — the common
            # dictionary-encode case — no longer force a full-width sort.)
            words_eq = ~jnp.any(sw[1:] != sw[:-1], axis=1)
            overflow = (slen[1:] > width) | (slen[:-1] > width)
            tied = words_eq & overflow & ~both_null
            tail_w = full_width - width
            starts_s = col.offsets[:-1][ord_]
            cap = col.data.shape[0]
            # compare tails in 64-byte blocks (a single [n, tail_w]
            # index matrix is ~2 GB at 1M rows x 500-byte tails)
            BLK = min(64, tail_w)
            k = jnp.arange(BLK, dtype=jnp.int32)[None, :]

            def tail(i0, base):  # bytes [base, base+BLK) per row
                idx = jnp.minimum(
                    starts_s[i0][:, None] + base + k, cap - 1
                )
                live = (base + k) < slen[i0][:, None]
                return jnp.where(live, col.data[idx], jnp.uint8(0)), live

            def block(c, diff):
                base = width + c * BLK
                a, la = tail(slice(0, n - 1), base)
                b, lb = tail(slice(1, n), base)
                return diff | jnp.any((a != b) & la & lb, axis=1)

            diff = jax.lax.fori_loop(
                0, -(-tail_w // BLK), block,
                jnp.zeros(n - 1, jnp.bool_),
            )
            ambiguous = jnp.any(tied & diff)
    ranks = _cumsum(neq.astype(jnp.int32))
    values = jnp.zeros(n, jnp.int32).at[ord_].set(ranks)
    # first-occurrence (in sorted order) positions -> key gather indexes
    first = jnp.concatenate([jnp.ones(1, jnp.bool_), neq[1:]]) if n else neq
    return ord_, ranks, values, first, ambiguous


def dictionary_encode(col: StringColumn):
    """Return (keys: StringColumn sorted unique, values: int32[rows]).

    values[i] = rank of col[i] in the sorted unique keyset, the exact
    contract of nvcategory (python/tests/test_category.py:31-40).

    Perf: the variadic lax.sort degrades with operand count, so keys start
    as a 64-byte prefix; an exact ambiguity check (truncated tie but full
    rows differ) escalates the width until the ordering is provably the
    full lexicographic one.
    """
    n = col.size
    if n == 0:
        from ..column import empty_column

        return empty_column(0), jnp.zeros(0, jnp.int32)
    full_width = -(-layout.max_row_bytes(col) // 4) * 4
    width = min(full_width, 64)
    import numpy as np

    # hash-grouped encode above HASHED_MIN rows — one single-key sort
    # over rows plus the full lexicographic machinery on group
    # representatives only (see _encode_hashed; the host fetch shrinks
    # from [n] permutation planes to the [u] key rows).  Small columns keep the radix path
    # (the two-phase overhead costs more than it saves there).
    if n >= HASHED_MIN:
        while True:
            values, key_rows, nkeys, ambiguous, _, _ = _encode_hashed(
                col, width, full_width
            )
            if width >= full_width or not bool(
                jax.device_get(ambiguous)
            ):
                break
            width = min(width * 4, full_width)
        nk = int(jax.device_get(nkeys))
        key_idx = np.asarray(
            jax.device_get(key_rows[:nk])
        ).astype(np.int64)
    else:
        while True:
            ord_, ranks, values, first, ambiguous = _encode_sorted(
                col, width, full_width
            )
            amb_np, first_np, ord_np = jax.device_get(
                (ambiguous, first, ord_)
            )
            if width >= full_width or not bool(amb_np):
                break
            width = min(width * 4, full_width)
        key_idx = ord_np[np.nonzero(first_np)[0]]
    # unique row indices: gathered bytes bounded by the source capacity
    from ..column import BOUND_SYNC_THRESHOLD
    from .array import _gather_impl

    if col.capacity <= BOUND_SYNC_THRESHOLD:
        keys = _gather_impl(
            col, jnp.asarray(key_idx, jnp.int32), col.capacity
        )
    else:
        keys = array.gather(col, key_idx.astype(jnp.int32))
    return keys, values


def unique_strings(col: StringColumn) -> StringColumn:
    keys, _ = dictionary_encode(col)
    return keys


def searchsorted_keys(keys: StringColumn, queries: StringColumn) -> jax.Array:
    """For each query row, the index of the equal key or -1.

    Used by value(str), add/remove/set_keys remapping (NVCategory.cu:766).
    Nulls match the null key if present.
    """
    kw_width = max(
        layout.max_row_bytes(keys), layout.max_row_bytes(queries)
    )
    kw_width = -(-kw_width // 4) * 4
    kw = array._key_words(keys, kw_width)  # [K, W]
    qw = array._key_words(queries, kw_width)  # [Q, W]
    klen, qlen = keys.lengths(), queries.lengths()
    kval, qval = keys.validity, queries.validity
    # lexicographic searchsorted via vectorized binary search
    K = keys.size

    def less(qi, ki):
        # is key ki < query qi ?
        # null < non-null
        kn, qn = ~kval[ki], ~qval[qi]
        a, b = kw[ki], qw[qi]
        neq = a != b
        first = jnp.argmax(neq)  # first differing word
        words_less = jnp.where(
            jnp.any(neq), a[first] < b[first], klen[ki] < qlen[qi]
        )
        return jnp.where(kn | qn, kn & ~qn, words_less)

    def eq(qi, ki):
        kn, qn = ~kval[ki], ~qval[qi]
        same = jnp.all(kw[ki] == qw[qi]) & (klen[ki] == qlen[qi])
        return jnp.where(kn | qn, kn & qn, same)

    def find_one(qi):
        def body(state):
            lo, hi = state
            mid = (lo + hi) // 2
            l = less(qi, mid)
            return (jnp.where(l, mid + 1, lo), jnp.where(l, hi, mid))

        def cond(state):
            lo, hi = state
            return lo < hi

        lo, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.int32(K))
        )
        hit = jnp.where((lo < K) & eq(qi, jnp.minimum(lo, K - 1)), lo, -1)
        return hit

    return jax.vmap(find_one)(jnp.arange(queries.size, dtype=jnp.int32))


def first_not_less(keys: StringColumn, query: StringColumn) -> jax.Array:
    """Scalar: first position p with NOT (keys[p] < query[0]), K if none.

    Vectorized over the whole keyset (exact for ANY key order — it is the
    device replacement for the host linear walk in get_value_bounds;
    reference: NVCategory.cu get_value_bounds:795).  Ordering is
    custr::compare's: null first, then bytewise lexicographic."""
    kw_width = max(layout.max_row_bytes(keys), layout.max_row_bytes(query))
    kw_width = -(-max(kw_width, 4) // 4) * 4
    kw = array._key_words(keys, kw_width)  # [K, W]
    qw = array._key_words(query, kw_width)[0]  # [W]
    klen, qlen = keys.lengths(), query.lengths()[0]
    kval, qval = keys.validity, query.validity[0]
    neq = kw != qw[None, :]
    first = jnp.argmax(neq, axis=1)
    fk = jnp.take_along_axis(kw, first[:, None], axis=1)[:, 0]
    fq = qw[first]
    words_less = jnp.where(jnp.any(neq, axis=1), fk < fq, klen < qlen)
    less = jnp.where(~kval | ~qval, ~kval & qval, words_less)
    # first False in `less` (NOT the count: exact parity with the linear
    # walk even on unsorted keysets from merge_category)
    return jnp.where(
        jnp.any(~less), jnp.argmax(~less).astype(jnp.int32), keys.size
    )


# ---------------------------------------------------------------------------
# hash-grouped dictionary encode
# ---------------------------------------------------------------------------
#
# The LSD radix over 18 key columns pays two row gathers in each of its
# 18 stable passes, while ONE single-key stable sort is cheap.
# Dictionary data has few unique keys, so: group rows by a 32-bit hash of
# the key prefix (one single-key sort + EXACT neighbor compares — hash
# collisions can only SPLIT groups, never merge different keys), then run
# the full lexicographic machinery on the group REPRESENTATIVES only
# (u rows instead of n; split groups re-merge there because equal reps
# sort adjacent).  Exactness does not depend on hash quality anywhere.
# Reference analogue: the sort in NVCategoryImpl_init is over all rows
# (NVCategory.cu:220-304) — this is the array-form refactor of the same
# contract.


def _fmix32(h):
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_rows(words, lens, validity):
    n = words.shape[0]
    h = jnp.full((n,), 0x811C9DC5, jnp.uint32)
    for i in range(words.shape[1]):
        h = (h ^ words[:, i]) * jnp.uint32(0x01000193)
    h = (h ^ lens.astype(jnp.uint32)) * jnp.uint32(0x01000193)
    h = _fmix32(h)
    return jnp.where(validity, h, jnp.uint32(0))


@partial(jax.jit, static_argnums=(1, 2))
def _hash_group_phase(col: StringColumn, width: int, full_width: int):
    """Group rows by hash + exact compare.  Returns (values_g int32[n]
    candidate-group id per original row, rep_full int32[n] group
    representative row ids compacted to the front, u groups, words,
    amb_a: in-group truncation ambiguity)."""
    from . import shift_compact

    n = col.size
    words = array._key_words(col, width)
    lens = col.lengths()
    val = col.validity
    h = _hash_rows(words, lens, val)
    rows = jnp.arange(n, dtype=jnp.int32)
    _, perm = jax.lax.sort((h, rows), num_keys=1, is_stable=True)
    sw = words[perm]
    slen = lens[perm]
    sval = val[perm]
    amb_a = jnp.zeros((), jnp.bool_)
    if n > 1:
        row_neq = (
            jnp.any(sw[1:] != sw[:-1], axis=1)
            | (slen[1:] != slen[:-1])
            | (sval[1:] != sval[:-1])
        )
        both_null = (~sval[1:]) & (~sval[:-1])
        neq = jnp.zeros(n, jnp.bool_).at[1:].set(row_neq & ~both_null)
    else:
        neq = jnp.zeros(n, jnp.bool_)
    gid_h = _cumsum(neq.astype(jnp.int32))  # 0-based group id
    values_g = jnp.zeros(n, jnp.int32).at[perm].set(gid_h)
    first = (
        jnp.concatenate([jnp.ones(1, jnp.bool_), neq[1:]])
        if n
        else neq
    )
    (rep_full,), k0 = shift_compact.compact_arrays(first, [perm])
    u = k0[-1]
    if width < full_width and n > 1:
        # in-group ambiguity: a member whose tail differs from its
        # group representative was merged only because of truncation
        # (group key = truncated words + len + val, so members share
        # length; len > width means both rows overflow).  One window
        # gather of every row's tail in hash order + one row gather of
        # the rep's tail (dead when ambiguity is not consumed — XLA
        # DCEs this whole subtree in the resident bench loop).
        pos = jnp.arange(n, dtype=jnp.int32)
        repp = segments.cummax(jnp.where(first, pos, 0))
        tied_m = (~first) & sval & (slen > width)
        tail_w = full_width - width
        starts_h = col.offsets[:-1][perm]
        diff = _tail_diff_vs(
            col, starts_h, slen, repp, width, tail_w
        )
        amb_a = jnp.any(tied_m & diff)
    return values_g, rep_full, u, words, amb_a


def _tail_diff_vs(col, starts_h, slen, other_idx, width, tail_w):
    """bool[n]: does row i (h-order) differ from row other_idx[i] in the
    byte range [width, width+tail_w), over bytes live in both rows?"""
    n = starts_h.shape[0]
    cap = col.data.shape[0]
    BLK = min(64, tail_w)
    k = jnp.arange(BLK, dtype=jnp.int32)[None, :]

    def tail(sel_starts, sel_len, base):
        idx = jnp.minimum(sel_starts[:, None] + base + k, cap - 1)
        live = (base + k) < sel_len[:, None]
        return jnp.where(live, col.data[idx], jnp.uint8(0)), live

    def block(c, diff):
        base = width + c * BLK
        a, la = tail(starts_h, slen, base)
        b, lb = tail(starts_h[other_idx], slen[other_idx], base)
        return diff | jnp.any((a != b) & la & lb, axis=1)

    return jax.lax.fori_loop(
        0, -(-tail_w // BLK), block, jnp.zeros(n, jnp.bool_)
    )


@partial(jax.jit, static_argnums=(5, 6, 7))
def _rep_rank_phase(
    col, words, values_g, rep_full, u, ucap: int, width: int,
    full_width: int
):
    """Lexicographic ranks over the u group representatives.

    words: the [n, W] key words from _hash_group_phase (recomputing them
    here would repeat a row-window gather over every row).
    Returns (values int32[n] final lex ranks, key_rows int32[ucap]
    unique source rows in lex order, nkeys, amb_b)."""
    from . import shift_compact

    lens = col.lengths()
    val = col.validity
    if rep_full.shape[0] < ucap:  # tiny columns: ucap floor is 8
        rep_full = jnp.pad(rep_full, (0, ucap - rep_full.shape[0]))
    rep = rep_full[:ucap]
    iv = jnp.arange(ucap, dtype=jnp.int32)
    live = iv < u
    rwords = words[rep]  # [ucap, W] row gather (u is small)
    rlen = jnp.where(live, lens[rep], 0)
    rval = jnp.where(live, val[rep], False)
    # keys: dead-last, then null-first, then words, then length
    keys = [jnp.where(live, 0, 1).astype(jnp.uint32)]
    keys.append(rval.astype(jnp.uint32))
    for i in range(rwords.shape[1]):
        keys.append(jnp.where(live, rwords[:, i], 0))
    keys.append(rlen.astype(jnp.uint32))
    if ucap >= array._LSD_ROWS and len(keys) > 6:
        rperm = array.lsd_order(keys)
    else:
        out = jax.lax.sort(tuple(keys) + (iv,), num_keys=len(keys))
        rperm = out[-1]
    ssw = rwords[rperm]
    sslen = rlen[rperm]
    ssval = rval[rperm]
    sslive = live[rperm]
    if ucap > 1:
        words_eq = ~jnp.any(ssw[1:] != ssw[:-1], axis=1)
        rep_neq = (
            ~words_eq
            | (sslen[1:] != sslen[:-1])
            | (ssval[1:] != ssval[:-1])
        )
        both_null = (~ssval[1:]) & (~ssval[:-1]) & sslive[1:] & sslive[:-1]
        rneq = jnp.zeros(ucap, jnp.bool_).at[1:].set(
            (rep_neq & ~both_null) & sslive[1:]
        )
    else:
        rneq = jnp.zeros(ucap, jnp.bool_)
        words_eq = jnp.zeros(max(ucap - 1, 1), jnp.bool_)
    dedup = jnp.cumsum(rneq.astype(jnp.int32))  # rank among sorted uniques
    table = jnp.zeros(ucap, jnp.int32).at[rperm].set(dedup)
    values = table[jnp.minimum(values_g, ucap - 1)]
    first_r = (
        jnp.concatenate([jnp.ones(1, jnp.bool_), rneq[1:]]) & sslive
        if ucap
        else rneq
    )
    (key_rows,), kk0 = shift_compact.compact_arrays(
        first_r, [rep[rperm]]
    )
    nkeys = kk0[-1]
    amb_b = jnp.zeros((), jnp.bool_)
    if width < full_width and ucap > 1:
        overflow = (sslen[1:] > width) | (sslen[:-1] > width)
        tied = (
            words_eq & overflow & sslive[1:] & sslive[:-1]
            & ssval[1:] & ssval[:-1]
        )
        tail_w = full_width - width
        rstarts = jnp.where(live, col.offsets[:-1][rep], 0)[rperm]
        prev = jnp.concatenate([jnp.zeros(1, jnp.int32), iv[:-1]])
        diff = _tail_diff_vs(col, rstarts, sslen, prev, width, tail_w)
        amb_b = jnp.any(tied & diff[1:])
    return values, key_rows, nkeys, amb_b


def _encode_hashed(col: StringColumn, width: int, full_width: int,
                   ucap: int | None = None):
    """Full hash-grouped encode.  Returns (values, key_rows, nkeys,
    ambiguous, u, ucap).  Syncs the group count once when ucap is None
    (jit-free callers); pass a pre-learned ucap to stay sync-free."""
    values_g, rep_full, u, words, amb_a = _hash_group_phase(
        col, width, full_width
    )
    if ucap is None:
        uu = int(jax.device_get(u))
        ucap = max(8, 1 << max(uu - 1, 1).bit_length())
        ucap = min(ucap, max(col.size, 8))
    values, key_rows, nkeys, amb_b = _rep_rank_phase(
        col, words, values_g, rep_full, u, ucap, width, full_width
    )
    return values, key_rows, nkeys, amb_a | amb_b, u, ucap
