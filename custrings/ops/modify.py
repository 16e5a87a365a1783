"""Modify ops: literal replace, slice_replace, insert, fillna, translate.

Array re-design of cpp/src/strings/modify.cu (slice_replace:35,
replace:109, translate:302, fillna:395/444, insert:494).

Literal replace is the interesting one: the reference scans left-to-right
per thread taking non-overlapping matches greedily.  Vectorized: raw match
positions come from rolled compares; greedy non-overlap selection is exact
for patterns with no self-overlap (no proper border — checked on host), and
otherwise runs an associative function-composition scan over the cover state.
The quota `n` then keeps the first n selected matches per row (the greedy
pick sequence is prefix-stable in n).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from .segments import cumsum as _cumsum
import numpy as np

from ..column import StringColumn, build_column, cumsum0
from ..config import bucket_bytes
from . import charwise, layout, segments, substr
from .find import _match_mask, _pat_array


def _has_border(pat: bytes) -> bool:
    """True if some proper prefix equals a suffix (matches can overlap)."""
    for k in range(1, len(pat)):
        if pat[:k] == pat[-k:]:
            return True
    return False


def _greedy_select(match: jax.Array, m: int, bordered: bool) -> jax.Array:
    """Select non-overlapping matches left-to-right (within whole buffer;
    match[] is already row-fenced so matches never span rows)."""
    if m <= 1 or not bordered:
        return match
    # cover-state scan: s = remaining covered bytes; pick iff s==0 and match.
    # Represent each byte's transition on s in {0..m-1} as a vector and
    # compose with associative_scan (gather composition).
    B = match.shape[0]
    dom = jnp.arange(m, dtype=jnp.int32)  # possible incoming states

    # transition for byte j: if s==0 and match[j] -> m-1 else max(s-1,0)
    def trans(mj):
        dec = jnp.maximum(dom - 1, 0)
        t0 = jnp.where((dom == 0) & mj, m - 1, dec)
        return t0

    T = jax.vmap(trans)(match)  # [B, m]

    def compose(a, b):
        # apply a then b: (b o a)[s] = b[a[s]]
        return jnp.take_along_axis(b, a, axis=1)

    from .segments import compose_scan

    comp = compose_scan(T)  # comp[j] = T_j o ... o T_0
    # incoming state at byte j = comp[j-1][0]
    s_in = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), comp[:-1, 0].astype(jnp.int32)]
    )
    return match & (s_in == 0)


@partial(jax.jit, static_argnums=(3, 4, 5))
def _replace_plan(col: StringColumn, rbounds, p, m: int, bordered: bool, n: int):
    """All per-byte row attributes come from segment scans, not
    capacity-sized gathers/scatters (see ops/segments.py); the row-bound
    planes arrive precomputed (layout.row_bounds_planes) so repeated ops
    on one column pay the two scans once."""
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    if rbounds is None:  # over-budget column: planes fuse into this jit
        rbounds = layout.row_bounds_planes(col)
    row_start, row_end = rbounds
    match = (
        _match_mask(col.data, p)
        & (j + m <= row_end)
        & layout.valid_byte_mask(col)
    )
    picked = _greedy_select(match, m, bordered)
    if n >= 0:
        pk0 = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), _cumsum(picked.astype(jnp.int32))]
        )
        base = segments.broadcast_rows_to_bytes(
            pk0[col.offsets[:-1]], col.offsets, cap
        )
        rank = pk0[:cap] - base  # 0-based rank at pick positions
        picked = picked & (rank < n)

    # covered[j]: j lies inside a picked match (matches are row-fenced, so
    # the window test never crosses a row boundary)
    last_start = segments.cummax(jnp.where(picked, j, -1))
    inside = (last_start >= 0) & (j - last_start < m)

    picks_before0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(picked.astype(jnp.int32))]
    )
    covered_before0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(inside.astype(jnp.int32))]
    )
    picks_in_row = picks_before0[:cap] - segments.broadcast_rows_to_bytes(
        picks_before0[col.offsets[:-1]], col.offsets, cap
    )
    covered_in_row = covered_before0[:cap] - segments.broadcast_rows_to_bytes(
        covered_before0[col.offsets[:-1]], col.offsets, cap
    )
    picks_per_row = segments.per_row_of_prefix(picks_before0, col.offsets)
    return picked, inside, picks_in_row, covered_in_row, picks_per_row, row_start


@partial(jax.jit, static_argnums=(3, 4, 5))
def _replace_write(col: StringColumn, plan, r, m: int, rl: int, bcap: int):
    picked, inside, picks_in_row, covered_in_row, picks_per_row, row_start = plan
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    lens = col.lengths()
    sizes = lens + picks_per_row * (rl - m)
    out_offsets = cumsum0(sizes)
    out_pos = (
        segments.broadcast_rows_to_bytes(out_offsets[:-1], col.offsets, cap)
        + (j - row_start)
        - covered_in_row
        + picks_in_row * rl
    )
    keep = (~inside) & layout.valid_byte_mask(col)
    data = jnp.zeros(bcap + max(rl, 1), jnp.uint8)
    data = data.at[jnp.where(keep, out_pos, bcap)].set(
        jnp.where(keep, col.data, jnp.uint8(0))
    )
    # replacement bytes in one scatter: picked j covers out positions
    # [out_pos, out_pos+rl); scatter the start byte then propagate the
    # remaining rl-1 bytes elementwise from the start-distance.
    if rl:
        start_mark = jnp.full(bcap + max(rl, 1), -1, jnp.int32).at[
            jnp.where(picked, out_pos, bcap)
        ].max(jnp.where(picked, out_pos, -1))
        q = jnp.arange(bcap, dtype=jnp.int32)
        last_out_start = segments.cummax(start_mark[:bcap])
        doff = q - last_out_start
        in_rep = (last_out_start >= 0) & (doff < rl)
        rep = _small_lookup(r, doff, rl)
        data = jnp.where(
            jnp.concatenate(
                [in_rep, jnp.zeros(max(rl, 1), jnp.bool_)]
            ),
            jnp.concatenate([rep, jnp.zeros(max(rl, 1), jnp.uint8)]),
            data,
        )
    return data[:bcap], out_offsets


@partial(jax.jit, static_argnums=(3, 4, 5))
def _replace_write_route(col: StringColumn, plan, r, m: int, rl: int, bcap: int):
    """Size-changing write as ONE monotone move pass.

    shrink (rl <= m): the replacement fits INSIDE the match's byte span
    — overwrite the first rl match bytes in place, mark them kept, drop
    the rest: a rank-compaction of the augmented plane IS the output.
    grow (rl > m): kept bytes move RIGHT by out_pos - j (nondecreasing
    over kept lanes since every row only grows); the unplaced output
    gaps are then exactly the rl-byte replacement zones, filled with a
    cummax off the placed mask.  Ref: the reference's write phase is the
    same single byte pass, cpp/src/strings/replace.cu:79-130."""
    from . import shift_compact

    picked, inside, picks_in_row, covered_in_row, picks_per_row, row_start = plan
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    lens = col.lengths()
    sizes = lens + picks_per_row * (rl - m)
    out_offsets = cumsum0(sizes)
    keep = (~inside) & layout.valid_byte_mask(col)
    if rl <= m:
        last_start = segments.cummax(jnp.where(picked, j, -1))
        doff = j - last_start
        rep_zone = inside & (last_start >= 0) & (doff < rl)
        aug = (
            jnp.where(rep_zone, _small_lookup(r, doff, rl), col.data)
            if rl
            else col.data
        )
        (data,), _ = shift_compact.compact_arrays(keep | rep_zone, [aug])
        if cap >= bcap:
            data = data[:bcap]
        else:
            data = jnp.pad(data, (0, bcap - cap))
        return data, out_offsets
    out_pos = (
        segments.broadcast_rows_to_bytes(out_offsets[:-1], col.offsets, cap)
        + (j - row_start)
        - covered_in_row
        + picks_in_row * rl
    )
    dist = jnp.maximum(out_pos - j, 0)
    (moved,), placed = shift_compact.expand_to(keep, dist, [col.data], bcap)
    q = jnp.arange(bcap, dtype=jnp.int32)
    last_placed = segments.cummax(jnp.where(placed, q, -1))
    # gaps are k adjacent rl-byte replacement zones: index mod rl
    doff = (q - last_placed - 1) % rl
    in_rep = (~placed) & (q < out_offsets[-1])
    rep = _small_lookup(r, doff, rl)
    data = jnp.where(in_rep, rep, jnp.where(placed, moved, jnp.uint8(0)))
    return data, out_offsets


@partial(jax.jit, static_argnums=(4, 5, 6))
def _replace_grow_stream(col, tail, p, r, m: int, rl: int, bcap: int):
    """Growth writer for unbordered small patterns without quota: ONE
    int32 plane + one monotone expansion.

    The plan-based route materializes ~7 int32[capacity] planes
    (picks/covered prefixes, in-row ranks, out positions), about 28 bytes
    of temporaries per input byte.  Here the augmented
    stream substitutes the first m replacement bytes IN PLACE (matches
    cannot overlap: m-way rolled select), EVERY in-bounds byte is kept,
    and kept byte j moves right by growth * picks-strictly-before-its-
    match — monotone on ALL lanes, so the expansion needs no
    forward-fill pass.  The unplaced output gaps are the (rl-m)-byte
    replacement tails: a CONSTANT byte when growth == 1 (the common
    case), an in-gap cummax otherwise.
    Ref: replace.cu:79-130 (the same single write pass per byte)."""
    from . import shift_compact

    g = rl - m
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    if tail is None:
        tail = layout.tail_plane(col)
    picked = _match_mask(col.data, p) & (tail >= m)
    # non-overlapping (unbordered): the covering pick is an exact m-way
    # rolled select (same trick as _replace_same_len)
    off = jnp.full(cap, m, jnp.int32)
    for k in range(m):
        pkk = jnp.roll(picked, k) & (j >= k) if k else picked
        off = jnp.where(pkk, k, off)
    inside = off < m
    aug = jnp.where(
        inside, _small_lookup(r, jnp.minimum(off, m - 1), m), col.data
    )
    keep = tail > 0
    pk0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(picked)]
    )
    dist = g * (pk0[1:] - inside.astype(jnp.int32))
    (moved,), placed = shift_compact.expand_to(keep, dist, [aug], bcap)
    lens = col.lengths()
    ppr = segments.per_row_of_prefix(pk0, col.offsets)
    out_offsets = cumsum0(lens + ppr * g)
    q = jnp.arange(bcap, dtype=jnp.int32)
    in_gap = (~placed) & (q < out_offsets[-1])
    if g == 1:
        rep = jnp.broadcast_to(r[rl - 1], (bcap,))
    else:
        last_placed = segments.cummax(jnp.where(placed, q, -1))
        doff = (q - last_placed - 1) % g
        rep = _small_lookup(r, m + doff, rl)
    data = jnp.where(in_gap, rep, jnp.where(placed, moved, jnp.uint8(0)))
    return data, out_offsets


@partial(jax.jit, static_argnums=(3, 4, 5))
def _replace_write_gather(col: StringColumn, plan, r, m: int, rl: int, bcap: int):
    """Gather-based write: every output byte computes its source via the
    inverse of the piecewise copy/insert map — no dense scatter-set (XLA
    one gather per output byte)."""
    picked, inside, picks_in_row, covered_in_row, picks_per_row, row_start = plan
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    rows_in = layout.row_ids_from_offsets(col.offsets, cap)
    lens = col.lengths()
    sizes = lens + picks_per_row * (rl - m)
    out_offsets = cumsum0(sizes)
    # output position of each input byte (replacement start for picked j)
    out_pos = (
        out_offsets[:-1][rows_in]
        + (j - row_start)
        - covered_in_row
        + picks_in_row * rl
    )
    bq = jnp.arange(bcap, dtype=jnp.int32)
    rows_out = layout.row_ids_from_offsets(out_offsets, bcap)
    startq = jnp.where(picked, jnp.minimum(out_pos, bcap), bcap)
    # t(q): replacement-starts at output positions <= q (sparse scatter-add)
    A = jnp.zeros(bcap + 1, jnp.int32).at[startq].add(1)
    A0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(A[:bcap])]
    )
    out_row_start = out_offsets[:-1][rows_out]
    # starts from EARLIER rows can collide positionally with this row's
    # start (empty-output rows); subtract the per-row pick prefix instead
    pr0 = cumsum0(picks_per_row)
    t = A0[bq + 1] - pr0[rows_out]
    # last replacement start at or before q (sparse scatter-max + cummax)
    mark = jnp.full(bcap + 1, -1, jnp.int32).at[startq].max(
        jnp.where(picked, out_pos, -1)
    )
    last_start = segments.cummax(mark[:bcap])
    in_repl = (last_start >= 0) & (bq - last_start < rl) if rl else jnp.zeros(
        bcap, jnp.bool_
    )
    in_row_start = col.offsets[:-1][rows_out]
    # copied byte: all counted starts are fully before q
    t_cop = jnp.where(in_repl, t - 1, t)
    src_j = bq - out_row_start + in_row_start + t_cop * (m - rl)
    src = layout.gather_bytes(col.data, src_j)
    if rl:
        rep = r[jnp.clip(bq - last_start, 0, rl - 1)]
    else:
        rep = jnp.uint8(0)
    data = jnp.where(in_repl, rep, src)
    data = jnp.where(bq < out_offsets[-1], data, jnp.uint8(0))
    return data, out_offsets


def _small_lookup(r, off, rl: int):
    """r[off] for a tiny (<=8 byte) table without a capacity-sized gather:
    a select ladder is pure elementwise work."""
    if rl > 8:
        return r[jnp.clip(off, 0, rl - 1)]
    out = jnp.broadcast_to(r[rl - 1], off.shape)
    for t in range(rl - 2, -1, -1):
        out = jnp.where(off <= t, r[t], out)
    return out


@partial(jax.jit, static_argnums=(4, 5, 6))
def _replace_same_len(col, tail, p, r, m: int, bordered: bool, n: int):
    """rl == m: offsets are unchanged and the write is pure elementwise
    substitution — no scatter, no gather, no new offsets.

    With the precomputed tail plane (layout.tail_plane: u8 bytes-left-
    in-row, validity folded in) and a small pattern (m <= 8), the whole
    op is ONE fused elementwise pass: picked matches cannot overlap
    (greedy selection / border-free property), so the covering-match
    offset is an exact m-way rolled select instead of a running-max scan
    (the two linear scans of the general path are the entire cost
    there)."""
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    if m > 255:  # tail plane saturates at 255: use the int32 fence
        row_end = layout.row_bounds_planes(col)[1]
        match = (
            _match_mask(col.data, p)
            & (j + m <= row_end)
            & layout.valid_byte_mask(col)
        )
    else:
        if tail is None:  # traced/uncached column: fuses into this jit
            tail = layout.tail_plane(col)
        match = _match_mask(col.data, p) & (tail >= m)
    picked = _greedy_select(match, m, bordered)
    if n >= 0:
        pk0 = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), _cumsum(picked.astype(jnp.int32))]
        )
        base = segments.broadcast_rows_to_bytes(
            pk0[col.offsets[:-1]], col.offsets, cap
        )
        picked = picked & (pk0[:cap] - base < n)
    if m <= 8:
        # picked matches never overlap: at most one k in [0, m) has
        # picked[j-k], so nested rolled selects find it exactly
        off = jnp.full(cap, m, jnp.int32)
        for k in range(m):
            pk = jnp.roll(picked, k) & (j >= k) if k else picked
            off = jnp.where(pk, k, off)
        inside = off < m
        rep = _small_lookup(r, jnp.minimum(off, m - 1), m)
    else:
        last_start = segments.cummax(jnp.where(picked, j, -1))
        inside = (last_start >= 0) & (j - last_start < m)
        rep = _small_lookup(r, j - last_start, m)
    return jnp.where(inside, rep, col.data), col.offsets


@partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _replace_full(
    col, rbounds, p, r, m: int, rl: int, bordered: bool, n: int, bcap: int
):
    """Single fused program: plan + write (keeps all intermediates inside
    one XLA program — cross-program buffers are costly on the relay)."""
    if rl == m and bcap == col.capacity:
        return _replace_same_len(col, None, p, r, m, bordered, n)
    if rl > m and not bordered and m <= 8 and n < 0:
        tail = (
            layout.tail_plane(col)
            if not isinstance(col.data, jax.core.Tracer)
            else None
        )
        return _replace_grow_stream(col, tail, p, r, m, rl, bcap)
    plan = _replace_plan(col, rbounds, p, m, bordered, n)
    return _replace_write_route(col, plan, r, m, rl, bcap)


@partial(jax.jit, static_argnums=(3, 4, 5))
def _replace_count(col, rbounds, p, m: int, bordered: bool, n: int):
    plan = _replace_plan(col, rbounds, p, m, bordered, n)
    return col.offsets[-1] + jnp.sum(plan[4])


def replace_literal(
    col: StringColumn, pat, repl, n: int = -1
) -> StringColumn:
    pat_b = pat.encode("utf-8") if isinstance(pat, str) else bytes(pat)
    repl_b = (repl or "").encode("utf-8") if not isinstance(repl, bytes) else repl
    m, rl = len(pat_b), len(repl_b)
    if m == 0 or col.size == 0:
        return col
    p = _pat_array(pat_b)
    r = _pat_array(repl_b) if rl else _pat_array(b"\x00")[:0]
    bordered = _has_border(pat_b)
    from ..column import BOUND_SYNC_THRESHOLD

    if rl == m:
        # same length: ONE fused elementwise pass off the memoized u8
        # tail plane (cacheable at any capacity)
        tail = layout.tail_plane(col) if m <= 255 else None
        data, offs = _replace_same_len(col, tail, p, r, m, bordered, n)
        return StringColumn(data, offs, col.validity)
    # over PLANE_CACHE_BUDGET the planes are not materialized host-side;
    # the jitted programs compute them inline (they fuse and die there)
    rbounds = (
        layout.row_bounds_planes(col) if layout.planes_cacheable(col) else None
    )
    if rl < m and col.capacity <= BOUND_SYNC_THRESHOLD:
        # same length: the size CANNOT change (elementwise fast path at
        # any scale); shrink-only under the sync threshold: allocate at
        # input capacity and skip the sync
        bcap = col.capacity
    else:
        # size program returns nbytes + npicks folded to one scalar bound
        est = int(_replace_count(col, rbounds, p, m, bordered, n))
        # est = nbytes + npicks; reconstruct exact total bound
        nbytes = int(col.offsets[-1])
        npicks = est - nbytes
        bcap = bucket_bytes(nbytes + npicks * max(rl - m, 0) + 1)
    data, out_offsets = _replace_full(col, rbounds, p, r, m, rl, bordered, n, bcap)
    return StringColumn(data, out_offsets, col.validity)


def fillna_scalar(col: StringColumn, repl: str) -> StringColumn:
    """Null rows become `repl` (modify.cu fillna:395)."""
    b = repl.encode("utf-8")
    rb = _pat_array(b) if b else jnp.zeros(0, jnp.uint8)
    lens = col.lengths()
    sizes = jnp.where(col.validity, lens, len(b))
    starts = col.offsets[:-1]

    def produce(rows, k, valid, bcast):
        src = layout.gather_bytes(col.data, bcast(starts) + k)
        if len(b):
            rbyte = rb[jnp.clip(k, 0, len(b) - 1)]
        else:
            rbyte = jnp.uint8(0)
        return jnp.where(bcast(col.validity.astype(jnp.int32)) == 1, src, rbyte)

    return build_column(sizes, jnp.ones(col.size, jnp.bool_), produce)


def fillna_column(col: StringColumn, repl: StringColumn) -> StringColumn:
    """Null rows take the corresponding row of `repl` (modify.cu fillna:444)."""
    lens = col.lengths()
    rlens = repl.lengths()
    use_repl = ~col.validity
    sizes = jnp.where(use_repl, rlens, lens)
    validity = jnp.where(use_repl, repl.validity, col.validity)
    starts, rstarts = col.offsets[:-1], repl.offsets[:-1]

    def produce(rows, k, valid, bcast):
        a = layout.gather_bytes(col.data, bcast(starts) + k)
        b = layout.gather_bytes(repl.data, bcast(rstarts) + k)
        return jnp.where(bcast(use_repl.astype(jnp.int32)) == 1, b, a)

    return build_column(sizes, validity, produce)


def insert(col: StringColumn, start: int, repl: str) -> StringColumn:
    """Insert `repl` at char position `start` (modify.cu insert:494);
    start=-1 means append at end."""
    return slice_replace(col, start, start, repl, insert_mode=True)


def slice_replace(
    col: StringColumn, start, stop, repl: str | None, insert_mode: bool = False
) -> StringColumn:
    """Replace chars [start, stop) with repl (modify.cu slice_replace:35)."""
    b = (repl or "").encode("utf-8")
    rb = _pat_array(b) if b else jnp.zeros(0, jnp.uint8)
    rl = len(b)
    n = col.size
    nch = layout.char_counts(col)
    s_arr = jnp.full(n, int(start if start is not None else 0), jnp.int32)
    if insert_mode:
        s_arr = jnp.where(s_arr < 0, nch, jnp.minimum(s_arr, nch))
        e_arr = s_arr
    else:
        e_arr = jnp.full(n, -1 if stop is None else int(stop), jnp.int32)
        e_arr = jnp.where(e_arr < 0, nch, jnp.minimum(e_arr, nch))
        s_arr = jnp.minimum(jnp.maximum(s_arr, 0), nch)
        e_arr = jnp.maximum(e_arr, s_arr)
    cm, s, e, sb, eb = substr._char_window(col, s_arr, e_arr, raw=True)
    # raw window clamps e>=s? _char_window raw clamps to [0, nch]
    lens = col.lengths()
    head = sb - col.offsets[:-1]
    tail = col.offsets[1:] - eb
    sizes = head + rl + tail
    starts = col.offsets[:-1]

    def produce(rows, k, valid, bcast):
        h = bcast(head)
        in_head = k < h
        in_repl = (k >= h) & (k < h + rl)
        head_b = layout.gather_bytes(col.data, bcast(starts) + k)
        rep_b = rb[jnp.clip(k - h, 0, max(rl - 1, 0))] if rl else jnp.uint8(0)
        tail_b = layout.gather_bytes(col.data, bcast(eb) + jnp.clip(k - h - rl, 0, None))
        return jnp.where(in_head, head_b, jnp.where(in_repl, rep_b, tail_b))

    return build_column(sizes, col.validity, produce)


def translate(col: StringColumn, table) -> StringColumn:
    """Map chars through a codepoint table (modify.cu translate:302).

    `table` is a dict {ord/char: ord/char/None} or list of pairs; None
    deletes the character (matches str.translate semantics; the reference
    maps to the given values only).
    """
    if col.size == 0:
        return col
    if isinstance(table, dict):
        items = table.items()
    else:
        items = table
    src, dst = [], []
    for k, v in items:
        kk = ord(k) if isinstance(k, str) else int(k)
        if v is None:
            vv = -1
        else:
            vv = ord(v) if isinstance(v, str) else int(v)
        src.append(kk)
        dst.append(vv)
    src_a = jnp.asarray(src or [0], jnp.int32)
    dst_a = jnp.asarray(dst or [0], jnp.int32)

    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    ncap = cps.shape[0]
    mapped = cps
    for i in range(len(src)):
        mapped = jnp.where(cps == src_a[i], dst_a[i], mapped)
    deleted = mapped < 0
    kept = ~deleted
    # per-row kept counts
    c = jnp.arange(ncap, dtype=jnp.int32)
    crows = layout.row_ids_from_offsets(cm.char_offsets, ncap)
    cvalid = c < cm.cs0[-1]
    kv = kept & cvalid
    # compact mapping: out char index -> in char index
    kpos0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(kv.astype(jnp.int32))]
    )
    counts = segments.per_row_of_prefix(kpos0, cm.char_offsets)
    in_for_out = jnp.zeros(ncap + 1, jnp.int32).at[
        jnp.where(kv, kpos0[:-1], ncap)
    ].set(c)[:ncap]
    base_rows = kpos0[cm.char_offsets[:-1]]

    def cp_fn(rows, oc, valid, bcast):
        # oc-th kept char of row = global kept index kpos0[char_offsets[row]] + oc
        g = in_for_out[jnp.clip(bcast(base_rows) + oc, 0, ncap - 1)]
        return mapped[jnp.clip(g, 0, ncap - 1)]

    return charwise.build_charwise(col, counts, cp_fn)
