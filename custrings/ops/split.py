"""Split family: split/rsplit (record + column), partition, rpartition.

Array re-design of cpp/src/strings/split.cu (split_record:125,
whitespace:270, rsplit_record:435/537, column split:734/863/960/1055,
partition:1165, rpartition:1268).  Pandas semantics are documented in the
reference (split.cu:89-123, whitespace :225-260) and reproduced here:
  - delimiter split of "" -> [""] (one empty token); null -> no tokens
  - whitespace split collapses runs, drops leading/trailing ws; with
    maxsplit, the tail token keeps the rest of the string verbatim
  - rsplit applies the limit from the right

The ragged result is one flattened token StringColumn plus an int32[rows+1]
row->token-range offsets array (TokenColumn): an Arrow "list of strings"
column.  Delimiter occurrences come from the vectorized greedy matcher shared
with replace; token extents are scattered by (row, token-rank) — no host
ping-pong until the caller materializes per-row objects.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from .segments import cumsum as _cumsum

from ..column import (
    StringColumn,
    build_column,
    cumsum0,
    row_ids_from_offsets,
)
from ..config import bucket_bytes
from . import layout, segments
from .find import _match_mask, _pat_array
from .modify import _greedy_select, _has_border

_INF = 1 << 28


@dataclasses.dataclass(frozen=True)
class TokenColumn:
    """Ragged split result: flattened tokens + per-input-row token ranges."""

    tokens: StringColumn
    row_offsets: jax.Array  # int32[rows+1]
    row_validity: jax.Array  # bool[rows]

    @property
    def nrows(self) -> int:
        return self.row_offsets.shape[0] - 1

    def counts(self) -> jax.Array:
        return self.row_offsets[1:] - self.row_offsets[:-1]


def _tokens_from_extents(col, tok_off, starts, ends, total_tokens):
    """Build the flattened token column from byte extents (all tokens valid)."""
    tcap = starts.shape[0]
    tvalid = jnp.arange(tcap, dtype=jnp.int32) < total_tokens
    sizes = jnp.where(tvalid, ends - starts, 0)

    def produce(trows, k, valid, bcast):
        return layout.gather_bytes(col.data, bcast(starts) + k)

    tokens = build_column(sizes, tvalid, produce)
    tokens = StringColumn(
        tokens.data,
        tokens.offsets[: total_tokens + 1],
        tokens.validity[:total_tokens],
    )
    return TokenColumn(tokens, tok_off, col.validity)


# ---------------------------------------------------------------------------
# Three-phase jitted ragged driver: one compiled program per phase, two
# scalar syncs (token total, byte total) — the XLA shape of the reference's
# count -> scan -> write pattern (split.cu:143-220).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(1, 2))
def _ragged_counts(col, body_fn, static_args, *args):
    counts = body_fn(col, None, *static_args, *args)
    return jnp.sum(counts.astype(jnp.int32))


@partial(jax.jit, static_argnums=(1, 2, 3))
def _ragged_extents(col, body_fn, static_args, tcap, *args):
    counts, starts, ends = body_fn(col, tcap, *static_args, *args)
    tok_off = cumsum0(counts)
    tvalid = jnp.arange(tcap, dtype=jnp.int32) < tok_off[-1]
    sizes = jnp.where(tvalid, ends - starts, 0)
    byte_off = cumsum0(sizes)
    return tok_off, starts, byte_off


@partial(jax.jit, static_argnums=(3,))
def _ragged_write(col, starts, byte_off, bcap):
    return _ragged_write_body(col, starts, byte_off, bcap)


def _ragged_write_body(col, starts, byte_off, bcap):
    """Materialize token bytes.  Every run_ragged body emits tokens in
    source order with disjoint spans, so the write is a pure monotone
    re-layout: cover-compact the token bytes out of the source (the
    compacted cover stream IS the output, since byte_off =
    cumsum(sizes))."""
    from . import shift_compact

    cap = col.capacity
    sizes = byte_off[1:] - byte_off[:-1]
    keep = shift_compact.cover_spans(starts, starts + sizes, sizes > 0, cap)
    (stream,), _ = shift_compact.compact_arrays(keep, [col.data])
    if cap >= bcap:
        return stream[:bcap]
    return jnp.pad(stream, (0, bcap - cap))


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _ragged_extents_write(col, body_fn, static_args, tcap, bcap, *args):
    """Fused extents + routing write for the over-threshold path: token
    bytes are bounded by input bytes, so bcap = capacity is a STATIC
    bound and the byte-total sync between the phases disappears (one
    program instead of two, one sync for the whole split)."""
    counts, starts, ends = body_fn(col, tcap, *static_args, *args)
    tok_off = cumsum0(counts)
    tvalid = jnp.arange(tcap, dtype=jnp.int32) < tok_off[-1]
    sizes = jnp.where(tvalid, ends - starts, 0)
    byte_off = cumsum0(sizes)
    data = _ragged_write_body(col, starts, byte_off, bcap)
    return data, tok_off, byte_off


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _ragged_full(col, body_fn, static_args, tcap, bcap, *args):
    """Fused extents + write: ONE program, intermediates stay internal
    (cross-program buffers are costly on the relay transport)."""
    counts, starts, ends = body_fn(col, tcap, *static_args, *args)
    tok_off = cumsum0(counts)
    tvalid = jnp.arange(tcap, dtype=jnp.int32) < tok_off[-1]
    sizes = jnp.where(tvalid, ends - starts, 0)
    byte_off = cumsum0(sizes)
    from ..column import materialize_bytes

    def produce(trows, k, valid, bcast):
        return layout.gather_bytes(col.data, bcast(starts) + k)

    data = materialize_bytes(byte_off, bcap, produce)
    return data, tok_off, byte_off


def run_ragged(body_fn, col, *args, static_args=()) -> TokenColumn:
    from ..column import BOUND_SYNC_THRESHOLD

    if col.size == 0:
        from ..column import empty_column
        import jax.numpy as _jnp

        return TokenColumn(
            empty_column(0),
            _jnp.zeros((1,), _jnp.int32),
            _jnp.zeros((0,), bool),
        )

    # token count is bounded by bytes + rows (every token needs either a
    # byte or an empty row); token bytes are bounded by input bytes.  Under
    # the threshold, skip BOTH size syncs, allocate the bounds, and run
    # extents + write as ONE fused program.
    tok_bound = col.capacity + col.size
    if (
        tok_bound * 8 <= BOUND_SYNC_THRESHOLD
        and col.capacity <= BOUND_SYNC_THRESHOLD
    ):
        tcap = bucket_bytes(tok_bound)
        bcap = col.capacity
        data, tok_off, byte_off = _ragged_full(
            col, body_fn, static_args, tcap, bcap, *args
        )
        total_tokens = int(tok_off[-1])  # one sync for logical slicing
    else:
        if body_fn is _delim_body:
            # over-threshold capacities: the byte-domain extents body
            # plans ~6 int32[capacity] planes; the streaming variant
            # (same signature/contract) keeps slot math in [tcap]
            body_fn = _delim_extents_stream
        total_tokens = int(_ragged_counts(col, body_fn, static_args, *args))
        tcap = bucket_bytes(total_tokens)
        # token bytes <= input bytes: bcap = capacity is a static bound,
        # so extents + write fuse into one program (one total size sync)
        bcap = bucket_bytes(col.capacity)
        data, tok_off, byte_off = _ragged_extents_write(
            col, body_fn, static_args, tcap, bcap, *args
        )
    tokens = StringColumn(
        data,
        byte_off[: total_tokens + 1],
        jnp.ones(total_tokens, jnp.bool_),
    )
    return TokenColumn(tokens, tok_off, col.validity)


def _row_fenced_match(col, p, m: int, tail):
    """Delimiter-match mask with the row fence, valid-byte test, and row
    VALIDITY folded in (null rows may still own bytes: their delimiters
    must not reach the slot scatters — counts give them zero slots, so a
    null row's token base aliases the next valid row's first slot).  One
    u8 compare off the tail plane (layout.tail_plane) for m <= 255."""
    if m <= 255:
        if tail is None:
            tail = layout.tail_plane(col)
        return _match_mask(col.data, p) & (tail >= m)
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    row_end = segments.row_end_positions(col.offsets, cap)
    vb = (
        segments.broadcast_rows_to_bytes(
            col.validity.astype(jnp.int32), col.offsets, cap
        )
        == 1
    )
    return (
        _match_mask(col.data, p)
        & (j + m <= row_end)
        & layout.valid_byte_mask(col)
        & vb
    )


def _delim_body(
    col: StringColumn,
    tcap,
    delim: str,
    maxsplit: int,
    from_right: bool,
    tail=None,
):
    pat_b = delim.encode("utf-8")
    m = len(pat_b)
    p = jnp.asarray(list(pat_b), jnp.uint8)
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    match = _row_fenced_match(col, p, m, tail)
    bordered = _has_border(pat_b)
    if from_right and bordered:
        # greedy right-to-left: mirror buffer so the cover-scan runs l-to-r
        revm = jnp.roll(jnp.flip(match), -(m - 1))
        picked_rev = _greedy_select(revm, m, True)
        picked = jnp.roll(jnp.flip(picked_rev), -(m - 1))
    else:
        picked = _greedy_select(match, m, bordered)

    pk0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(picked.astype(jnp.int32))]
    )
    delims_per_row = segments.per_row_of_prefix(pk0, col.offsets)
    allowed = maxsplit if maxsplit > 0 else _INF
    used = jnp.minimum(delims_per_row, allowed)
    counts = jnp.where(col.validity, used + 1, 0)
    if tcap is None:
        return counts

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, col.offsets, cap)

    rank = pk0[:cap] - bcast(pk0[col.offsets[:-1]])
    if from_right:
        used_rank = rank - bcast(delims_per_row - used)
    else:
        used_rank = rank
    if maxsplit > 0 or from_right:
        dused = picked & (used_rank >= 0) & (used_rank < bcast(used))
    else:
        dused = picked  # no quota: every picked delimiter is used

    tok_off = cumsum0(counts)
    starts = jnp.zeros(tcap + 1, jnp.int32)
    ends = jnp.zeros(tcap + 1, jnp.int32)
    first_tok = jnp.where(col.validity, tok_off[:-1], tcap)
    starts = starts.at[first_tok].set(col.offsets[:-1])
    tbase = bcast(tok_off[:-1])
    starts = starts.at[jnp.where(dused, tbase + used_rank + 1, tcap)].set(j + m)
    ends = ends.at[jnp.where(dused, tbase + used_rank, tcap)].set(j)
    last_tok = jnp.where(col.validity, tok_off[1:] - 1, tcap)
    ends = ends.at[last_tok].set(col.offsets[1:])
    return counts, starts[:tcap], ends[:tcap]


def _delim_extents_stream(
    col: StringColumn,
    tcap,
    delim: str,
    maxsplit: int,
    from_right: bool,
    tail=None,
):
    """_delim_body's (counts, starts, ends) contract with NO capacity-
    sized int32 planes past the delimiter compaction.

    The round-4 4M-row tier showed _delim_body's extents planning ~6
    int32[capacity] planes (~22 GB at an 800 MB corpus) — the compile
    helper rejects the program outright.  Here the picked-delimiter
    positions compact into the TOKEN domain first (one linear kernel
    pass; the only capacity-sized transients are the bool masks, one
    validity broadcast, and the compaction's position payload), and all
    slot arithmetic runs on [tcap] arrays: delimiter q of valid row r is
    token boundary k_q = q - dof[r], its token slots follow tok_off[r],
    and the slot maps are monotone in q — expansions, not scatters.
    Ref: the same two-pass shape as split.cu:143-220.
    """
    from ..column import row_ids_from_offsets
    from . import shift_compact

    pat_b = delim.encode("utf-8")
    m = len(pat_b)
    p = jnp.asarray(list(pat_b), jnp.uint8)
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    match = _row_fenced_match(col, p, m, tail)
    bordered = _has_border(pat_b)
    if from_right and bordered:
        revm = jnp.roll(jnp.flip(match), -(m - 1))
        picked_rev = _greedy_select(revm, m, True)
        picked = jnp.roll(jnp.flip(picked_rev), -(m - 1))
    else:
        picked = _greedy_select(match, m, bordered)
    k0d = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(picked.astype(jnp.int32))]
    )
    dpr = k0d[col.offsets[1:]] - k0d[col.offsets[:-1]]
    allowed = maxsplit if maxsplit > 0 else _INF
    used = jnp.minimum(dpr, allowed)
    counts = jnp.where(col.validity, used + 1, 0)
    if tcap is None:
        # counts need only the picked prefix — skip the position
        # compaction (a full linear routing pass) in this phase
        return counts

    (dpos_full,), _ = shift_compact.compact_arrays(picked, [j])
    dpos = dpos_full[:tcap] if cap >= tcap else jnp.pad(
        dpos_full, (0, tcap - cap)
    )
    tok_off = cumsum0(counts)
    dof = cumsum0(dpr)
    q = jnp.arange(tcap, dtype=jnp.int32)
    # row values broadcast over the delimiter domain as segment
    # broadcasts (delta scatter + linear prefix) — X[r_q] element
    # gathers cost ~1.2 s each per 140M tokens at the 4M tier
    def dbcast(v):
        return segments.broadcast_rows_to_bytes(v, dof, tcap)

    dof_b = dbcast(dof[:-1])
    k_q = q - dof_b
    if from_right:
        # quota consumes the RIGHTMOST delimiters
        u_rank = k_q - dbcast(dpr - used)
    else:
        u_rank = k_q
    live = (q < dof[-1]) & (u_rank >= 0) & (u_rank < dbcast(used))
    t_end = dbcast(tok_off[:-1]) + u_rank  # slot whose token ends here
    # compact the USED delimiters first: with maxsplit quotas the dropped
    # delimiters make t_end - q non-monotone; over consecutive ranks the
    # expand distance t_end - rank is nondecreasing unconditionally
    (cd, ct), k0l = shift_compact.compact_arrays(live, [dpos, t_end])
    live2 = q < k0l[-1]
    dist = jnp.where(live2, ct - q, 0)

    (ends0, starts0), _ = shift_compact.expand_to(
        live2, dist, [cd, cd + m], tcap + 1
    )
    # NOTE: starts0 holds the value for slot t_end; the token STARTING
    # after this delimiter is slot t_end + 1 — shift by one slot.
    starts = jnp.zeros(tcap + 1, jnp.int32).at[1:].set(starts0[:tcap])
    ends = ends0
    first_tok = jnp.where(col.validity, tok_off[:-1], tcap)
    starts = starts.at[first_tok].set(col.offsets[:-1])
    last_tok = jnp.where(col.validity, tok_off[1:] - 1, tcap)
    ends = ends.at[last_tok].set(col.offsets[1:])
    return counts, starts[:tcap], ends[:tcap]


from functools import lru_cache


@lru_cache(maxsize=512)
def _delim_full_jit(tcap: int, bcap: int, delim: str, maxsplit: int,
                    from_right: bool):
    """One jitted closure PER static combo.  A single jitted function with
    six static_argnums variants hit a jax-0.9 executable-cache identity
    bug on CPU (a later call to an earlier-compiled variant raised
    'Execution supplied 3 buffers but compiled program expected 5');
    distinct function objects keep the cache entries apart."""

    def fn(col, tail=None):
        return _delim_full_bd(
            col, tcap, bcap, delim, maxsplit, from_right, tail
        )

    fn.__name__ = (
        f"_delim_full_{tcap}_{bcap}_{maxsplit}_{int(from_right)}"
    )
    return jax.jit(fn)


def _delim_full_fast(col, tcap: int, bcap: int, m: int, picked, tail):
    """No-quota left-split fast path (the common case): counts derive
    from the keep-compaction's own prefix (kept_r = m * delims dropped),
    so the picked-prefix cumsum disappears, and the delimiter->token
    compact carries ONE i32 payload (the slot distance is a per-row
    constant broadcast over the DELIMITER domain, ~1/10 the lanes).
    The general body also recomputes the tail plane, broadcasts
    validity, takes the picked cumsum and carries a second compact
    payload — all structural, none needed here."""
    from . import shift_compact

    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    if tail is None:
        tail = layout.tail_plane(col)
    if m == 1:
        inside = picked
    else:
        last_d = segments.cummax(jnp.where(picked, j, -1))
        inside = (last_d >= 0) & (j - last_d < m)
    keep = (tail > 0) & ~inside
    (data, ), k0 = shift_compact.compact_arrays(keep, [col.data])
    if cap >= bcap:
        data = data[:bcap]
    else:
        data = jnp.pad(data, (0, bcap - cap))
    # per-row delimiter count from kept lengths: every used delimiter
    # drops exactly m bytes of a valid row
    kept_r = k0[col.offsets[1:]] - k0[col.offsets[:-1]]
    lens = col.offsets[1:] - col.offsets[:-1]
    dpr = jnp.where(col.validity, (lens - kept_r) // m, 0)
    counts = jnp.where(col.validity, dpr + 1, 0)
    tok_off = cumsum0(counts)
    # delimiter domain: kept-prefix value at each used delimiter = the
    # byte offset (in the output stream) where its token ends
    (dk,), d0 = shift_compact.compact_arrays(picked, [k0[:cap]])
    ndel = d0[-1]
    if cap >= tcap:
        dk = dk[:tcap]
    else:
        dk = jnp.pad(dk, (0, tcap - cap))
    dof = cumsum0(dpr)
    q = jnp.arange(tcap, dtype=jnp.int32)
    # slot of delimiter q = q + (tok_off[row_q] - dof[row_q]): a row
    # value broadcast over the DELIMITER domain (tcap lanes, not cap)
    ddist = segments.broadcast_rows_to_bytes(
        tok_off[:-1] - dof[:-1], dof, tcap
    )
    live = q < ndel
    (T0,), _ = shift_compact.expand_arrays(live, ddist, [dk])
    ends_last = k0[col.offsets[1:]]
    T = (
        jnp.concatenate([T0, jnp.zeros(1, jnp.int32)])
        .at[jnp.where(col.validity, tok_off[1:] - 1, tcap)]
        .set(ends_last)[:tcap]
    )
    byte_off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), segments.cummax(T)]
    )
    return data, tok_off, byte_off


def _delim_full_bd(
    col: StringColumn, tcap: int, bcap: int, delim: str, maxsplit: int,
    from_right: bool, tail=None,
):
    """Fused byte-domain delimiter split: ONE program -> (data, tok_off,
    byte_off) with NO capacity-sized scatter or gather.

    Both data movement phases are monotone moves (ops/shift_compact.py)
    — output bytes = compaction of kept bytes; token-end offsets =
    compaction of the per-delimiter kept-byte counts followed by an
    expansion into token slots.

    Matches split.cu:125-220 semantics (empty string -> one empty token,
    null -> none, maxsplit keeps unused delimiters inside the tail token).
    """
    pat_b = delim.encode("utf-8")
    m = len(pat_b)
    p = jnp.asarray(list(pat_b), jnp.uint8)
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    match = _row_fenced_match(col, p, m, tail)
    bordered = _has_border(pat_b)
    if from_right and bordered:
        revm = jnp.roll(jnp.flip(match), -(m - 1))
        picked = jnp.roll(jnp.flip(_greedy_select(revm, m, True)), -(m - 1))
    else:
        picked = _greedy_select(match, m, bordered)

    if maxsplit <= 0 and not from_right and m <= 255:
        return _delim_full_fast(col, tcap, bcap, m, picked, tail)

    pk0 = cumsum0(picked)
    delims_per_row = segments.per_row_of_prefix(pk0, col.offsets)
    allowed = maxsplit if maxsplit > 0 else _INF
    used = jnp.minimum(delims_per_row, allowed)
    counts = jnp.where(col.validity, used + 1, 0)
    tok_off = cumsum0(counts)

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, col.offsets, cap)

    if maxsplit > 0 or from_right:
        rank = pk0[:cap] - bcast(pk0[col.offsets[:-1]])
        if from_right:
            rank = rank - bcast(delims_per_row - used)
        dused = picked & (rank >= 0) & (rank < bcast(used))
    else:
        dused = picked  # no quota: every picked delimiter is used

    vb = bcast(col.validity.astype(jnp.int32)) == 1
    if m == 1:
        inside = dused
    else:
        last_d = segments.cummax(jnp.where(dused, j, -1))
        inside = (last_d >= 0) & (j - last_d < m)
    # null rows may still own bytes in the buffer but contribute no tokens
    keep = layout.valid_byte_mask(col) & ~inside & vb

    from . import shift_compact

    # output bytes: monotone routing compaction of kept bytes
    (data,), k0 = shift_compact.compact_arrays(keep, [col.data])
    if cap >= bcap:
        data = data[:bcap]
    else:
        data = jnp.pad(data, (0, bcap - cap))

    # token-end offsets.  The q-th used delimiter (valid rows only) ends
    # token slot q + (tok_off[row] - base[row]); each valid row's LAST
    # token ends at k0[row_end].  Compact (end value, slot distance) by
    # the delimiter mask, expand into token slots, patch last tokens with
    # a rows-sized scatter.
    dused_v = dused & vb
    base = cumsum0(jnp.where(col.validity, used, 0))
    pre_dist = bcast(tok_off[:-1] - base[:-1])
    (dvals, ddist), u0 = shift_compact.compact_arrays(
        dused_v, [k0[:cap], pre_dist]
    )
    total_d = u0[-1]
    if cap >= tcap:
        dvals, ddist = dvals[:tcap], ddist[:tcap]
    else:
        dvals = jnp.pad(dvals, (0, tcap - cap))
        ddist = jnp.pad(ddist, (0, tcap - cap))
    live = jnp.arange(tcap, dtype=jnp.int32) < total_d
    (T0,), placed = shift_compact.expand_arrays(live, ddist, [dvals])
    ends_last = k0[col.offsets[1:]]
    T = (
        jnp.concatenate([T0, jnp.zeros(1, jnp.int32)])
        .at[jnp.where(col.validity, tok_off[1:] - 1, tcap)]
        .set(ends_last)[:tcap]
    )
    byte_off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), segments.cummax(T)]
    )
    return data, tok_off, byte_off


def _delim_split(
    col: StringColumn, delim: str, maxsplit: int, from_right: bool
) -> TokenColumn:
    if len(delim) == 0:
        raise ValueError("empty delimiter")
    from ..column import BOUND_SYNC_THRESHOLD

    # each delimiter occurrence consumes m bytes: tokens <= bytes/m + rows.
    # The routing writer's transient peak is ~16 bytes per input byte and
    # ~12 per token slot, so the fused path is safe whenever both domains
    # stay under the sync threshold (the old *8 factor priced the
    # starts/ends extent arrays of the scatter writer).
    m = len(delim.encode("utf-8"))
    tok_bound = col.capacity // m + col.size
    if (
        col.size
        and tok_bound <= BOUND_SYNC_THRESHOLD
        and col.capacity <= BOUND_SYNC_THRESHOLD
    ):
        tcap = bucket_bytes(tok_bound)
        bcap = col.capacity
        from ..utils.jitguard import call_resilient

        data, tok_off, byte_off = call_resilient(
            _delim_full_jit(tcap, bcap, delim, maxsplit, from_right),
            col,
            layout.tail_plane(col) if m <= 255 else None,
        )
        total_tokens = int(tok_off[-1])
        tokens = StringColumn(
            data,
            byte_off[: total_tokens + 1],
            jnp.ones(total_tokens, jnp.bool_),
        )
        return TokenColumn(tokens, tok_off, col.validity)
    # over-threshold (round 5): one cheap counts program (prefix only —
    # no routing pass) syncs the exact token total, then the SAME fused
    # byte-domain body as the under-threshold path runs with tcap from
    # the sync and the static byte bound bcap = capacity (token bytes
    # are a subset of input bytes).  The former run_ragged driver spent
    # ~60% of the op in the generic cover/expand machinery that the
    # delimiter body does not need.
    tail = layout.tail_plane(col) if m <= 255 else None
    from ..utils.jitguard import call_resilient

    total_tokens = int(
        _ragged_counts(
            col, _delim_extents_stream, (delim, maxsplit, from_right), tail
        )
    )
    tcap = bucket_bytes(max(total_tokens, 1))
    bcap = bucket_bytes(col.capacity)
    data, tok_off, byte_off = call_resilient(
        _delim_full_jit(tcap, bcap, delim, maxsplit, from_right), col, tail
    )
    tokens = StringColumn(
        data,
        byte_off[: total_tokens + 1],
        jnp.ones(total_tokens, jnp.bool_),
    )
    return TokenColumn(tokens, tok_off, col.validity)


def _ws_body(col: StringColumn, tcap, maxsplit: int, from_right: bool):
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    ncap = cps.shape[0]
    c = jnp.arange(ncap, dtype=jnp.int32)
    crows = row_ids_from_offsets(cm.char_offsets, ncap)
    cvalid = c < cm.cs0[-1]
    non_ws = (cps > ord(" ")) & cvalid
    row_first = jnp.zeros(ncap, jnp.bool_).at[
        jnp.minimum(cm.char_offsets[:-1], max(ncap - 1, 0))
    ].set(True)
    prev_non_ws = jnp.roll(non_ws, 1).at[0].set(False)
    wstart = non_ws & (row_first | ~prev_non_ws)
    next_non_ws = jnp.roll(non_ws, -1).at[ncap - 1].set(False)
    next_row_first = jnp.roll(row_first, -1).at[ncap - 1].set(True)
    wend = non_ws & (next_row_first | ~next_non_ws)

    n = col.size
    ws0_pre = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(wstart.astype(jnp.int32))]
    )
    words = segments.per_row_of_prefix(ws0_pre, cm.char_offsets)
    T = maxsplit + 1 if maxsplit > 0 else _INF
    counts = jnp.where(col.validity, jnp.minimum(jnp.maximum(words, 1), T), 0)
    if tcap is None:
        return counts
    # tail token absorbs the rest of the string (incl. trailing/leading ws)
    # exactly when the limit is reached: ' a b '.split(None,1) -> ['a','b ']
    # (split.cu:225-260 examples)
    over = words >= T

    def bcast(v):
        return segments.broadcast_rows_to_bytes(v, cm.char_offsets, ncap)

    ws0 = ws0_pre
    we0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(wend.astype(jnp.int32))]
    )
    ws_rank = ws0[:ncap] - bcast(ws0[cm.char_offsets[:-1]])
    we_rank = we0[:ncap] - bcast(we0[cm.char_offsets[:-1]])

    cpos = cm.char_pos
    cw = layout.char_width_from_lead(
        col.data[jnp.clip(cpos, 0, max(col.capacity - 1, 0))]
    )

    tok_off = cumsum0(counts)
    starts = jnp.zeros(tcap + 1, jnp.int32)
    ends = jnp.zeros(tcap + 1, jnp.int32)
    tbase = bcast(tok_off[:-1])
    counts_b = bcast(counts)
    over_b = bcast(over.astype(jnp.int32)) == 1

    if not from_right:
        ti_s = ws_rank
        sel_s = wstart & (ti_s < counts_b)
        starts = starts.at[jnp.where(sel_s, tbase + ti_s, tcap)].set(cpos[c])
        ti_e = we_rank
        sel_e = wend & (ti_e < counts_b - 1)
        ends = ends.at[jnp.where(sel_e, tbase + ti_e, tcap)].set(
            cpos[c] + cw[c]
        )
        sel_last = wend & (ti_e == counts_b - 1) & ~over_b
        ends = ends.at[jnp.where(sel_last, tbase + ti_e, tcap)].set(
            cpos[c] + cw[c]
        )
        sel_or = col.validity & over
        ends = ends.at[jnp.where(sel_or, tok_off[1:] - 1, tcap)].set(
            col.offsets[1:]
        )
    else:
        shift = bcast(words) - counts_b
        ti_s = ws_rank - shift
        sel_s = wstart & (ti_s >= jnp.where(over_b, 1, 0)) & (
            ti_s < counts_b
        )
        starts = starts.at[jnp.where(sel_s, tbase + ti_s, tcap)].set(cpos[c])
        ti_e = we_rank - shift
        sel_e = wend & (ti_e >= 0) & (ti_e < counts_b)
        ends = ends.at[jnp.where(sel_e, tbase + ti_e, tcap)].set(
            cpos[c] + cw[c]
        )
        sel_os = col.validity & over
        starts = starts.at[jnp.where(sel_os, tok_off[:-1], tcap)].set(
            col.offsets[:-1]
        )
    # wordless rows: single empty token at row start
    sel_empty = col.validity & (words == 0)
    starts = starts.at[jnp.where(sel_empty, tok_off[:-1], tcap)].set(
        col.offsets[:-1]
    )
    ends = ends.at[jnp.where(sel_empty, tok_off[:-1], tcap)].set(
        col.offsets[:-1]
    )
    return counts, starts[:tcap], ends[:tcap]


def _ws_split(col: StringColumn, maxsplit: int, from_right: bool) -> TokenColumn:
    return run_ragged(_ws_body, col, static_args=(maxsplit, from_right))


def split_record(col: StringColumn, delimiter=None, n=-1) -> TokenColumn:
    if delimiter is None:
        return _ws_split(col, n, False)
    return _delim_split(col, delimiter, n, False)


def rsplit_record(col: StringColumn, delimiter=None, n=-1) -> TokenColumn:
    if delimiter is None:
        return _ws_split(col, n, True)
    return _delim_split(col, delimiter, n, True)


def token_column_to_columns(tc: TokenColumn) -> list[StringColumn]:
    """Column-major view: result[i] holds token i of each row, null-padded
    (split.cu column split:734 — shorter rows pad with nulls)."""
    from .array import gather

    counts = tc.counts()
    ncols = int(jnp.max(counts)) if tc.nrows else 0
    out = []
    nrows = tc.nrows
    for i in range(ncols):
        idx = jnp.minimum(tc.row_offsets[:-1] + i, max(tc.tokens.size - 1, 0))
        colm = gather(tc.tokens, idx)
        valid = tc.row_validity & (i < counts)
        # null rows: zero length
        lens = jnp.where(valid, colm.lengths(), 0)
        colm = _mask_column(colm, valid)
        out.append(colm)
    return out


def _mask_column(col: StringColumn, valid: jax.Array) -> StringColumn:
    """Null out rows where ~valid (their bytes become empty)."""
    sizes = jnp.where(valid, col.lengths(), 0)
    starts = col.offsets[:-1]

    def produce(rows, k, vmask, bcast):
        return layout.gather_bytes(col.data, bcast(starts) + k)

    return build_column(sizes, col.validity & valid, produce)


def split_columns(col: StringColumn, delimiter=None, n=-1) -> list[StringColumn]:
    return token_column_to_columns(split_record(col, delimiter, n))


def rsplit_columns(col: StringColumn, delimiter=None, n=-1) -> list[StringColumn]:
    return token_column_to_columns(rsplit_record(col, delimiter, n))


def partition(col: StringColumn, delimiter: str) -> list[StringColumn]:
    """3 columns: [before, delim, after] on FIRST occurrence; rows without
    the delimiter -> [row, "", ""]; null rows stay null
    (split.cu partition:1165, python/tests/test_split.py:99)."""
    return _partition_impl(col, delimiter, False)


def rpartition(col: StringColumn, delimiter: str) -> list[StringColumn]:
    """3 columns on LAST occurrence; no-delimiter rows -> ["", "", row]."""
    return _partition_impl(col, delimiter, True)


def _partition_body(col: StringColumn, delim: str, from_right: bool, part: int):
    """part: 0=before, 1=delimiter, 2=after."""
    from .find import _find_impl, _pat_array

    d = delim.encode("utf-8")
    m = len(d)
    n = col.size
    starts0 = jnp.zeros(n, jnp.int32)
    ends0 = jnp.full(n, -1, jnp.int32)
    pos = _find_impl(col, _pat_array(d), (starts0, ends0), from_right, True)
    cm = layout.char_map(col)
    nch = cm.nchars()
    found = pos >= 0
    co = cm.char_offsets[:-1]
    total_chars = cm.cs0[-1]

    g = jnp.minimum(co + jnp.clip(jnp.where(found, pos, 0), 0, nch), total_chars)
    dstart = jnp.where(
        g >= total_chars,
        col.offsets[-1],
        cm.char_pos[jnp.minimum(g, max(col.capacity - 1, 0))],
    )
    dstart = jnp.clip(dstart, col.offsets[:-1], col.offsets[1:])
    dend = jnp.where(found, dstart + m, dstart)

    if from_right:
        pre_s = col.offsets[:-1]
        pre_e = jnp.where(found, dstart, col.offsets[:-1])
        post_s = jnp.where(found, dend, col.offsets[:-1])
        post_e = col.offsets[1:]
    else:
        pre_s = col.offsets[:-1]
        pre_e = jnp.where(found, dstart, col.offsets[1:])
        post_s = jnp.where(found, dend, col.offsets[1:])
        post_e = col.offsets[1:]

    darr = jnp.asarray(list(d), jnp.uint8) if m else jnp.zeros(1, jnp.uint8)
    if part == 0:
        start, sizes = pre_s, jnp.where(col.validity, pre_e - pre_s, 0)
    elif part == 2:
        start, sizes = post_s, jnp.where(col.validity, post_e - post_s, 0)
    else:
        start = col.offsets[:-1]
        sizes = jnp.where(col.validity & found, m, 0)

    def produce(rows, k, valid, bcast):
        if part == 1:
            return darr[jnp.clip(k, 0, max(m - 1, 0))]
        return layout.gather_bytes(col.data, bcast(start) + k)

    return sizes, col.validity, produce


from ..column import jit_materialize

_partition_op = jit_materialize(_partition_body, static_argnums=(1, 2, 3))


def _partition_impl(col, delimiter, from_right):
    return [
        _partition_op(col, delimiter, from_right, part) for part in range(3)
    ]
