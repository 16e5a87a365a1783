"""Literal search ops: find/rfind/contains/startswith/endswith/compare.

Array re-design of cpp/src/strings/find.cu (compare:36, find:75,
find_from:123, rfind:163, find_multiple:202, contains:237, match_strings:276,
startswith:316, endswith:353).  Instead of one thread scanning one string, the
whole column's flat byte buffer is matched against the pattern at every byte
position at once (m rolled compares), then per-row results come from
segment min/max reductions.  All positions are CHARACTER indexes, as in the
reference (custring_view::find returns char_offset, custring_view.inl:481-514).

Conventions (find.cu): result -1 = no match, -2 = null row.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from .segments import cumsum as _cumsum
import numpy as np

from ..column import StringColumn
from . import layout

_BIG = np.int32(2**30)  # np: a module-level jnp constant would init the backend at import


from functools import lru_cache


@lru_cache(maxsize=4096)
def _pat_array_cached(b: bytes) -> jax.Array:
    # constant uploads through the device transport are NOT free in this
    # environment (relay round trip per host->device transfer); cache them.
    # ensure_compile_time_eval: first call may happen inside a jit trace
    with jax.ensure_compile_time_eval():
        return jnp.asarray(np.frombuffer(b, dtype=np.uint8))


def _pat_array(pat: str | bytes) -> jax.Array:
    b = pat.encode("utf-8") if isinstance(pat, str) else bytes(pat)
    return _pat_array_cached(b)


def _match_mask(data: jax.Array, pat: jax.Array) -> jax.Array:
    """bool[capacity]: pattern matches starting at byte j (ignoring rows)."""
    m = pat.shape[0]
    acc = jnp.ones(data.shape[0], dtype=jnp.bool_)
    for t in range(m):
        acc = acc & (jnp.roll(data, -t) == pat[t])
    return acc


@partial(jax.jit, static_argnums=(3, 4))
def _find_impl(col: StringColumn, pat, starts_ends, reverse: bool, use_ranges: bool):
    cm = layout.char_map(col)
    nrows = col.size
    data = col.data
    m = pat.shape[0]
    j = jnp.arange(col.capacity, dtype=jnp.int32)
    rows = layout.row_ids_from_offsets(col.offsets, col.capacity)
    nch = cm.nchars()

    if use_ranges:
        starts, ends = starts_ends
        starts = jnp.maximum(starts.astype(jnp.int32), 0)
        # end < 0 or beyond -> nchars (custring_view.inl:487-492)
        ends = ends.astype(jnp.int32)
        ends = jnp.where((ends < 0) | (ends > nch), nch, ends)
    else:
        starts = jnp.zeros(nrows, jnp.int32)
        ends = nch

    # byte window per row from char positions
    total_chars = cm.cs0[-1]
    co = cm.char_offsets[:-1]
    gstart = jnp.minimum(co + jnp.minimum(starts, nch), total_chars)
    gend = jnp.minimum(co + ends, total_chars)
    spos = jnp.where(
        gstart >= total_chars, col.offsets[-1], cm.char_pos[jnp.minimum(gstart, col.capacity - 1)]
    )
    epos = jnp.where(
        gend >= total_chars, col.offsets[-1], cm.char_pos[jnp.minimum(gend, col.capacity - 1)]
    )
    # clamp window inside the row (char_pos of one-past may jump to next row)
    spos = jnp.clip(spos, col.offsets[:-1], col.offsets[1:])
    epos = jnp.clip(epos, col.offsets[:-1], col.offsets[1:])

    from . import segments

    match = _match_mask(data, pat)
    ok = (
        match
        & (j >= segments.broadcast_rows_to_bytes(spos, col.offsets, col.capacity))
        & (j + m <= segments.broadcast_rows_to_bytes(epos, col.offsets, col.capacity))
        & layout.valid_byte_mask(col)
    )
    # first/last ok byte per row WITHOUT a capacity-sized segment reduce:
    # prefix-count the hits, then binary-search the k-th hit position for
    # each row (rows-count-sized work)
    okc = _cumsum(ok.astype(jnp.int32))  # inclusive
    okc0 = jnp.concatenate([jnp.zeros(1, jnp.int32), okc])
    t0 = okc0[col.offsets[:-1]]
    t1 = okc0[col.offsets[1:]]
    has = t1 > t0
    k = t1 if reverse else t0 + 1
    jpos = jnp.searchsorted(okc, k, side="left").astype(jnp.int32)
    jpos = jnp.clip(jpos, 0, col.capacity - 1)
    best = jnp.where(has, cm.cs0[jpos] - co, -1)
    if m == 0:
        best = jnp.full(nrows, -1, jnp.int32)  # find.cu: empty target -> -1
    return jnp.where(col.validity, best, -2)


def find(col: StringColumn, pat, start=0, end=None) -> jax.Array:
    """Char position of first occurrence within [start, end) chars."""
    n = col.size
    starts = jnp.full(n, int(start), jnp.int32)
    ends = jnp.full(n, -1 if end is None else int(end), jnp.int32)
    return _find_impl(col, _pat_array(pat), (starts, ends), False, True)


def rfind(col: StringColumn, pat, start=0, end=None) -> jax.Array:
    n = col.size
    starts = jnp.full(n, int(start), jnp.int32)
    ends = jnp.full(n, -1 if end is None else int(end), jnp.int32)
    return _find_impl(col, _pat_array(pat), (starts, ends), True, True)


def find_from(col: StringColumn, pat, starts=None, ends=None) -> jax.Array:
    """Per-row start/end char positions (find.cu find_from:123)."""
    n = col.size
    starts = (
        jnp.zeros(n, jnp.int32) if starts is None else jnp.asarray(starts)
    )
    ends = jnp.full(n, -1, jnp.int32) if ends is None else jnp.asarray(ends)
    return _find_impl(col, _pat_array(pat), (starts, ends), False, True)


def contains(col: StringColumn, pat) -> jax.Array:
    """bool[rows]; null rows -> False (find.cu contains:237 sets null->false,
    callers test via nulls separately)."""
    pos = find(col, pat)
    return pos >= 0


@partial(jax.jit, static_argnums=(2,))
def _prefix_suffix(col: StringColumn, pat, suffix: bool):
    m = pat.shape[0]
    lens = col.lengths()
    start = col.offsets[:-1] if not suffix else col.offsets[1:] - m
    acc = jnp.ones(col.size, dtype=jnp.bool_)
    cap = col.capacity - 1
    for t in range(m):
        b = col.data[jnp.clip(start + t, 0, cap)]
        acc = acc & (b == pat[t])
    return acc & (lens >= m) & col.validity


def startswith(col: StringColumn, pat) -> jax.Array:
    return _prefix_suffix(col, _pat_array(pat), False)


def endswith(col: StringColumn, pat) -> jax.Array:
    return _prefix_suffix(col, _pat_array(pat), True)


@jax.jit
def _compare_impl(col: StringColumn, p) -> jax.Array:
    """Byte-wise compare vs scalar string; 0 equal, <0 less, >0 greater.

    Null rows -> -1 (find.cu:59: null vs non-empty str).  Mirrors
    custring_view::compare semantics (byte difference or length difference).
    """
    m = p.shape[0]
    lens = col.lengths()
    starts = col.offsets[:-1]
    cap = col.capacity - 1
    result = jnp.zeros(col.size, jnp.int32)
    decided = jnp.zeros(col.size, jnp.bool_)
    for t in range(m):
        b = col.data[jnp.clip(starts + t, 0, cap)].astype(jnp.int32)
        in_row = t < lens
        # row exhausted before pattern: shorter sorts first, result -1
        # (custr::compare, custring.inl: prefix-equal -> +-1)
        exh = (~in_row) & (~decided)
        result = jnp.where(exh, -1, result)
        decided = decided | exh
        pt = p[t].astype(jnp.int32)
        diff = b - pt
        hit = (~decided) & (diff != 0)
        result = jnp.where(hit, diff, result)
        decided = decided | hit
    # pattern exhausted: longer row wins
    result = jnp.where(~decided & (lens > m), 1, result)
    return jnp.where(col.validity, result, -1)


def compare(col: StringColumn, pat) -> jax.Array:
    return _compare_impl(col, _pat_array(pat))


def match_strings(col: StringColumn, other: StringColumn) -> jax.Array:
    """Elementwise equality of two columns (find.cu match_strings:276);
    two nulls match each other."""
    w = max(layout.max_row_bytes(col), layout.max_row_bytes(other))
    a = layout.padded_view(col, w)
    b = layout.padded_view(other, w)
    eq = jnp.all(a == b, axis=1) & (col.lengths() == other.lengths())
    both_null = (~col.validity) & (~other.validity)
    return jnp.where(
        col.validity & other.validity, eq, both_null
    )


def find_multiple(col: StringColumn, targets: StringColumn) -> jax.Array:
    """int32[rows, n_targets]: first char position of each target
    (find.cu find_multiple:202; null row -> -2, miss -> -1)."""
    from ..column import to_host_strings

    tgt_host = [t if t is not None else "" for t in to_host_strings(targets)]
    cols = [find(col, t) for t in tgt_host]
    return jnp.stack(cols, axis=1)


def count_literal(col: StringColumn, pat) -> jax.Array:
    """Number of (possibly overlapping) occurrences per row; 0 for null.

    Used by nvtext strings_counts (cpp/src/text/NVText.cu:77-123).
    """
    p = _pat_array(pat)
    if p.shape[0] == 0:
        return jnp.zeros(col.size, jnp.int32)
    return _count_literal_impl(col, p)


@jax.jit
def _count_literal_impl(col: StringColumn, p) -> jax.Array:
    from . import segments

    m = p.shape[0]
    j = jnp.arange(col.capacity, dtype=jnp.int32)
    ok = (
        _match_mask(col.data, p)
        & (j + m <= segments.row_end_positions(col.offsets, col.capacity))
        & layout.valid_byte_mask(col)
    )
    ok0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(ok.astype(jnp.int32))]
    )
    cnt = segments.per_row_of_prefix(ok0, col.offsets)
    return jnp.where(col.validity, cnt, 0)
