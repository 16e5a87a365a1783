"""Tokenizer core and token ops (nvtext).

Array re-design of cpp/src/text/tokens.cu: base_tokenator (:41-76)
treats a RUN of delimiter chars as one separator (unlike split) and emits no
empty tokens; default delimiter set = all chars <= ' '.  An explicit
delimiter string is a SET of characters (is_delimiter does a char find,
tokens.cu:46-50).

The vectorized formulation marks token-start/end chars with shifted masks and
scatters byte extents by (row, token-rank) — same machinery as whitespace
split but with a parameterized delimiter set.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from ..ops.segments import cumsum as _cumsum

from ..column import (
    StringColumn,
    build_column,
    cumsum0,
    row_ids_from_offsets,
)
from ..config import bucket_bytes
from ..ops import layout
from ..ops.split import TokenColumn, _tokens_from_extents, run_ragged


def _is_delim(cps, delimiter: str | None):
    if delimiter is None or delimiter == "":
        return cps <= ord(" ")
    m = jnp.zeros(cps.shape, jnp.bool_)
    for ch in set(delimiter):
        m = m | (cps == ord(ch))
    return m


def token_extents(col: StringColumn, delimiter: str | None = None):
    """Per-token byte extents: returns dict with flat scatter-ready masks."""
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    ncap = cps.shape[0]
    c = jnp.arange(ncap, dtype=jnp.int32)
    crows = row_ids_from_offsets(cm.char_offsets, ncap)
    cvalid = c < cm.cs0[-1]
    tok_char = (~_is_delim(cps, delimiter)) & cvalid
    row_first = jnp.zeros(ncap, jnp.bool_).at[
        jnp.minimum(cm.char_offsets[:-1], max(ncap - 1, 0))
    ].set(True)
    prev_tok = jnp.roll(tok_char, 1).at[0].set(False)
    tstart = tok_char & (row_first | ~prev_tok)
    next_tok = jnp.roll(tok_char, -1).at[ncap - 1].set(False)
    next_row_first = jnp.roll(row_first, -1).at[ncap - 1].set(True)
    tend = tok_char & (next_row_first | ~next_tok)

    from ..ops import segments

    n = col.size
    ts0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(tstart.astype(jnp.int32))]
    )
    te0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(tend.astype(jnp.int32))]
    )
    counts = segments.per_row_of_prefix(ts0, cm.char_offsets)
    counts = jnp.where(col.validity, counts, 0)

    def cbcast(v):
        return segments.broadcast_rows_to_bytes(v, cm.char_offsets, ncap)

    ts_rank = ts0[:ncap] - cbcast(ts0[cm.char_offsets[:-1]])
    te_rank = te0[:ncap] - cbcast(te0[cm.char_offsets[:-1]])
    cpos = cm.char_pos
    cw = layout.char_width_from_lead(
        col.data[jnp.clip(cpos, 0, max(col.capacity - 1, 0))]
    )
    return {
        "counts": counts,
        "tstart": tstart,
        "tend": tend,
        "ts_rank": ts_rank,
        "te_rank": te_rank,
        "crows": crows,
        "c": c,
        "cpos": cpos,
        "cw": cw,
    }


def _tokenize_body(col: StringColumn, tcap, delimiter):
    E = token_extents(col, delimiter)
    counts = E["counts"]
    if tcap is None:
        return counts
    from ..ops import segments

    cm = layout.char_map(col)
    tok_off = cumsum0(counts)
    starts = jnp.zeros(tcap + 1, jnp.int32)
    ends = jnp.zeros(tcap + 1, jnp.int32)
    tbase = segments.broadcast_rows_to_bytes(
        tok_off[:-1], cm.char_offsets, E["c"].shape[0]
    )
    starts = starts.at[
        jnp.where(E["tstart"], tbase + E["ts_rank"], tcap)
    ].set(E["cpos"][E["c"]])
    ends = ends.at[jnp.where(E["tend"], tbase + E["te_rank"], tcap)].set(
        E["cpos"][E["c"]] + E["cw"][E["c"]]
    )
    return counts, starts[:tcap], ends[:tcap]


def tokenize_record(col: StringColumn, delimiter: str | None = None) -> TokenColumn:
    """All tokens per row as a ragged TokenColumn."""
    return run_ragged(_tokenize_body, col, static_args=(delimiter,))


def tokenize(col: StringColumn, delimiter: str | None = None) -> StringColumn:
    """Flattened token list (NVText::tokenize, tokens.cu:123)."""
    return tokenize_record(col, delimiter).tokens


def tokenize_strings(col: StringColumn, delims: StringColumn) -> StringColumn:
    """Multi-STRING-delimiter tokenize (NVText::tokenize(strs, delims),
    tokens.cu:158): sequential scan takes the first listed delimiter
    matching at each position and skips its length; empty tokens are
    dropped from the flattened result."""
    from ..column import to_host_strings
    from ..ops.find import _match_mask, _pat_array
    from ..ops.array import gather_mask

    dstrs = [d for d in to_host_strings(delims) if d]
    if not dstrs:
        return tokenize(col)
    from ..ops import segments

    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    row_end = segments.row_end_positions(col.offsets, cap)
    valid_byte = j < col.offsets[-1]
    first_id = jnp.full(cap, -1, jnp.int32)
    dlen = jnp.zeros(cap, jnp.int32)
    for i, d in enumerate(dstrs):
        db = d.encode("utf-8")
        m = (
            _match_mask(col.data, _pat_array(db))
            & (j + len(db) <= row_end)
            & valid_byte
        )
        hit = m & (first_id < 0)
        first_id = jnp.where(hit, i, first_id)
        dlen = jnp.where(hit, len(db), dlen)
    # greedy sequential skip with variable lengths: cover-state scan
    maxd = max(len(d.encode("utf-8")) for d in dstrs)
    if maxd == 1:
        picked = first_id >= 0
    else:
        dom = jnp.arange(maxd, dtype=jnp.int32)
        T = jnp.where(
            (dom[None, :] == 0) & (first_id >= 0)[:, None],
            jnp.maximum(dlen - 1, 0)[:, None],
            jnp.maximum(dom - 1, 0)[None, :],
        )
        comp = segments.compose_scan(T)
        s_in = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), comp[:-1, 0].astype(jnp.int32)]
        )
        picked = (first_id >= 0) & (s_in == 0)

    n = col.size
    pk0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(picked.astype(jnp.int32))]
    )
    picks_per_row = segments.per_row_of_prefix(pk0, col.offsets)
    counts = jnp.where(col.validity, picks_per_row + 1, 0)
    tok_off = cumsum0(counts)
    total = int(tok_off[-1])
    from ..config import bucket_bytes as _bb

    tcap = _bb(total)
    rank = pk0[:cap] - segments.broadcast_rows_to_bytes(
        pk0[col.offsets[:-1]], col.offsets, cap
    )
    tbase = segments.broadcast_rows_to_bytes(tok_off[:-1], col.offsets, cap)
    starts = jnp.zeros(tcap + 1, jnp.int32)
    ends = jnp.zeros(tcap + 1, jnp.int32)
    first_tok = jnp.where(col.validity, tok_off[:-1], tcap)
    starts = starts.at[first_tok].set(col.offsets[:-1])
    starts = starts.at[jnp.where(picked, tbase + rank + 1, tcap)].set(j + dlen)
    ends = ends.at[jnp.where(picked, tbase + rank, tcap)].set(j)
    last_tok = jnp.where(col.validity, tok_off[1:] - 1, tcap)
    ends = ends.at[last_tok].set(col.offsets[1:])
    tc = _tokens_from_extents(col, tok_off, starts[:tcap], ends[:tcap], total)
    toks = tc.tokens
    # drop empty tokens (tokens.cu:remove_if w.second==0)
    return gather_mask(toks, toks.lengths() > 0)


def token_count(col: StringColumn, delimiter: str | None = " ") -> jax.Array:
    """Tokens per row (tokens.cu token_count:337); null rows -> 0."""
    if col.size == 0:
        return jnp.zeros((0,), jnp.int32)
    return token_extents(col, delimiter)["counts"]


def unique_tokens(col: StringColumn, delimiter: str | None = " ") -> StringColumn:
    """Sorted unique tokens (tokens.cu unique_tokens:262)."""
    from ..ops.unique import unique_strings

    return unique_strings(tokenize(col, delimiter))


def normalize_spaces(col: StringColumn) -> StringColumn:
    """Collapse whitespace runs to single spaces, trim ends
    (tokens.cu normalize_spaces:679)."""
    tc = tokenize_record(col, None)
    toks = tc.tokens
    tok_lens = toks.lengths()
    n = col.size
    counts = tc.counts()
    # sizes = sum(token bytes) + (count-1) spaces
    tl0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(tok_lens.astype(jnp.int32))]
    )
    tok_bytes_per_row = tl0[tc.row_offsets[1:]] - tl0[tc.row_offsets[:-1]]
    sizes = tok_bytes_per_row + jnp.maximum(counts - 1, 0)

    # piece layout per row: token 0, ' '+token 1, ' '+token 2, ...
    piece_sizes = tok_lens + 1  # leading space for every token
    first_tok_mask = jnp.zeros(toks.size, jnp.bool_).at[
        jnp.minimum(tc.row_offsets[:-1], max(toks.size - 1, 0))
    ].max(counts > 0)
    piece_sizes = jnp.where(first_tok_mask, tok_lens, piece_sizes)
    piece_off = cumsum0(piece_sizes)  # aligns with flat output bytes per row
    tok_starts = toks.offsets[:-1]

    # materialize over output bytes directly with global piece ids
    out_offsets = cumsum0(sizes)
    total = int(out_offsets[-1])
    bcap = bucket_bytes(total)
    j = jnp.arange(bcap, dtype=jnp.int32)
    pid = row_ids_from_offsets(piece_off, bcap)
    within = j - piece_off[pid]
    is_space = (~first_tok_mask[pid]) & (within == 0)
    src = layout.gather_bytes(
        toks.data,
        tok_starts[pid] + jnp.where(first_tok_mask[pid], within, within - 1),
    )
    data = jnp.where(
        j < total, jnp.where(is_space, jnp.uint8(ord(" ")), src), jnp.uint8(0)
    )
    return StringColumn(data, out_offsets, col.validity)


def replace_tokens(
    col: StringColumn,
    targets: StringColumn,
    repls: StringColumn,
    delimiter: str | None = None,
) -> StringColumn:
    """Replace whole tokens equal to targets[i] with repls[i]
    (tokens.cu replace_tokens:565)."""
    if repls.size == 1 and targets.size > 1:
        # one repl recycles across all targets (tokens.cu replace_tokens
        # accepts a single-string repl list)
        from ..ops.array import gather

        repls = gather(
            repls, jnp.zeros((targets.size,), jnp.int32)
        )
    tc = tokenize_record(col, delimiter)
    toks = tc.tokens
    # match each token against targets
    tid = _equal_ids(toks, targets)  # int32[T]: target idx or -1
    repl_lens = repls.lengths()
    matched = tid >= 0
    new_tok_lens = jnp.where(matched, repl_lens[jnp.clip(tid, 0, None)], toks.lengths())

    # rebuild rows: alternate gap/token pieces.  Piece table (global):
    # for row r with t tokens: gap0, tok0, gap1, tok1, ..., gap_t
    n = col.size
    counts = tc.counts()
    pieces_per_row = 2 * counts + 1
    p_off = cumsum0(pieces_per_row)
    P = int(p_off[-1])
    pcap = bucket_bytes(P)
    # piece start/end in INPUT bytes; token pieces may be replaced
    p_start = jnp.zeros(pcap + 1, jnp.int32)
    p_end = jnp.zeros(pcap + 1, jnp.int32)
    p_tok = jnp.full(pcap + 1, -1, jnp.int32)  # global token id or -1
    # token k of row r is piece 2k+1; gap k is piece 2k
    tok_rank = jnp.arange(toks.size, dtype=jnp.int32) - tc.row_offsets[:-1][
        _tok_rows(tc)
    ]
    trows = _tok_rows(tc)
    tok_piece = p_off[:-1][trows] + 2 * tok_rank + 1
    # token byte extents within col: recompute from tokenize scatter
    # (tokens were materialized, so recover extents from token sizes and
    # gap structure): we need original extents; recompute via token_extents
    E = token_extents(col, delimiter)
    tstart_pos = E["cpos"][E["c"]]
    tend_pos = E["cpos"][E["c"]] + E["cw"][E["c"]]
    tbase = tc.row_offsets[:-1][E["crows"]]
    # masked scatters dump to slot toks.size (a real extra slot — using
    # the last valid slot instead clobbers the final token's extents)
    tok_s = jnp.zeros(toks.size + 1, jnp.int32).at[
        jnp.where(E["tstart"], tbase + E["ts_rank"], toks.size)
    ].set(jnp.where(E["tstart"], tstart_pos, 0))[: toks.size]
    tok_e = jnp.zeros(toks.size + 1, jnp.int32).at[
        jnp.where(E["tend"], tbase + E["te_rank"], toks.size)
    ].set(jnp.where(E["tend"], tend_pos, 0))[: toks.size]

    p_start = p_start.at[jnp.minimum(tok_piece, pcap)].set(tok_s[: toks.size])
    p_end = p_end.at[jnp.minimum(tok_piece, pcap)].set(tok_e[: toks.size])
    p_tok = p_tok.at[jnp.minimum(tok_piece, pcap)].set(
        jnp.arange(toks.size, dtype=jnp.int32)
    )
    # gap pieces: gap k spans [prev token end, next token start)
    # gap 0 starts at row start; gap t ends at row end.  Fill via scatter:
    gap_piece_after = p_off[:-1][trows] + 2 * tok_rank + 2
    p_start = p_start.at[jnp.minimum(gap_piece_after, pcap)].set(
        tok_e[: toks.size]
    )
    p_end_default = p_end
    # gap before token k ends at token k start
    gap_piece_before = p_off[:-1][trows] + 2 * tok_rank
    p_end = p_end.at[jnp.minimum(gap_piece_before, pcap)].set(
        tok_s[: toks.size]
    )
    # first gap of each row starts at row start; last gap ends at row end
    first_gap = jnp.where(col.validity, p_off[:-1], pcap)
    p_start = p_start.at[first_gap].set(col.offsets[:-1])
    last_gap = jnp.where(col.validity, p_off[1:] - 1, pcap)
    p_end = p_end.at[last_gap].set(col.offsets[1:])

    p_start, p_end, p_tok = p_start[:pcap], p_end[:pcap], p_tok[:pcap]
    p_is_tok = p_tok >= 0
    safe_tid = jnp.clip(jnp.where(p_is_tok, tid[jnp.clip(p_tok, 0, None)], -1), -1, None)
    p_replaced = p_is_tok & (safe_tid >= 0)
    p_sizes = jnp.where(
        p_replaced,
        repl_lens[jnp.clip(safe_tid, 0, None)],
        p_end - p_start,
    )
    pvalid = jnp.arange(pcap, dtype=jnp.int32) < P
    p_sizes = jnp.where(pvalid, p_sizes, 0)

    # output offsets per row = piece offsets at row boundaries
    pb0 = jnp.zeros(pcap + 1, jnp.int32).at[1:].set(_cumsum(p_sizes))
    out_offsets = pb0[jnp.minimum(p_off, pcap)]
    total = int(out_offsets[-1])
    bcap = bucket_bytes(total)
    j = jnp.arange(bcap, dtype=jnp.int32)
    pj = row_ids_from_offsets(pb0, bcap)
    within = j - pb0[pj]
    src_col = layout.gather_bytes(col.data, p_start[pj] + within)
    rstarts = repls.offsets[:-1]
    src_rep = layout.gather_bytes(
        repls.data,
        rstarts[jnp.clip(safe_tid[pj], 0, None)] + within,
    )
    data = jnp.where(
        j < total,
        jnp.where(p_replaced[pj], src_rep, src_col),
        jnp.uint8(0),
    )
    return StringColumn(data, out_offsets, col.validity)


def _tok_rows(tc: TokenColumn) -> jax.Array:
    """Row id of each flattened token."""
    return row_ids_from_offsets(tc.row_offsets, max(tc.tokens.size, 1))[
        : tc.tokens.size
    ]


def _equal_ids(toks: StringColumn, targets: StringColumn) -> jax.Array:
    """For each token, index of equal target or -1 (exact match)."""
    w = max(layout.max_row_bytes(toks), layout.max_row_bytes(targets), 4)
    w = -(-w // 4) * 4
    from ..ops.array import _key_words

    tw = _key_words(toks, w)  # [T, W]
    gw = _key_words(targets, w)  # [G, W]
    eq = jnp.all(tw[:, None, :] == gw[None, :, :], axis=-1) & (
        toks.lengths()[:, None] == targets.lengths()[None, :]
    )
    any_eq = jnp.any(eq, axis=1)
    first = jnp.argmax(eq, axis=1).astype(jnp.int32)
    return jnp.where(any_eq, first, -1)


def tokens_counts(
    col: StringColumn, targets: StringColumn, delimiter: str | None = " "
) -> jax.Array:
    """[rows, n_targets] matrix: count of tokens equal to each target
    (tokens.cu tokens_counts:440)."""
    tc = tokenize_record(col, delimiter)
    toks = tc.tokens
    if toks.size == 0:
        return jnp.zeros((col.size, targets.size), jnp.int32)
    w = max(layout.max_row_bytes(toks), layout.max_row_bytes(targets), 4)
    w = -(-w // 4) * 4
    from ..ops.array import _key_words

    tw = _key_words(toks, w)
    gw = _key_words(targets, w)
    eq = (
        jnp.all(tw[:, None, :] == gw[None, :, :], axis=-1)
        & (toks.lengths()[:, None] == targets.lengths()[None, :])
    ).astype(jnp.int32)
    trows = _tok_rows(tc)
    out = jnp.zeros((col.size, targets.size), jnp.int32).at[trows].add(eq)
    return out


def contains_strings(col: StringColumn, targets) -> jax.Array:
    """[rows, n_targets] bool matrix of substring containment
    (cpp/src/text/NVText.cu:32-68)."""
    from ..column import to_host_strings
    from ..ops.find import contains

    tgt = [t or "" for t in to_host_strings(targets)]
    return jnp.stack([contains(col, t) for t in tgt], axis=1)


def strings_counts(col: StringColumn, targets) -> jax.Array:
    """[rows, n_targets] substring occurrence counts (NVText.cu:77-123)."""
    from ..column import to_host_strings
    from ..ops.find import count_literal

    tgt = [t or "" for t in to_host_strings(targets)]
    return jnp.stack([count_literal(col, t) for t in tgt], axis=1)


def scatter_count(col: StringColumn, counts) -> StringColumn:
    """Repeat row i counts[i] times (NVText.cu scatter_count:126)."""
    from ..ops.array import gather

    counts = jnp.asarray(counts, jnp.int32)
    off = cumsum0(jnp.maximum(counts, 0))
    total = int(off[-1])
    idx = row_ids_from_offsets(off, max(total, 1))[:total]
    return gather(col, idx)
