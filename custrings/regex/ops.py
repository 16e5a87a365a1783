"""Column-level regex operations.

Array re-design of the regex op files (cpp/src/strings/count.cu,
findall*.cu, extract*.cu, replace.cu, replace_multi.cu,
replace_backref.cu).  Patterns compile on host once per process
(lru-cached); execution batches the whole column.
"""

from __future__ import annotations

import re as _pyre
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..column import StringColumn, build_column, cumsum0
from ..ops import layout, substr
from .compiler import compile_pattern
from .device import DeviceProgram


@lru_cache(maxsize=256)
def get_program(pattern: str) -> DeviceProgram:
    # program tables must stay concrete even when the first use of a
    # pattern happens inside a jit trace (closure_tensor runs jnp ops)
    with jax.ensure_compile_time_eval():
        return DeviceProgram(compile_pattern(pattern))


@lru_cache(maxsize=256)
def get_bit_nfa(pattern: str):
    from .pallas_nfa import BitNFA

    with jax.ensure_compile_time_eval():
        return BitNFA(get_program(pattern))


def use_bit_kernel(pattern: str) -> bool:
    """The bit-parallel matcher kernel runs on the kernel route for
    programs of at most 32 instructions; the XLA engine otherwise."""
    from ..config import kernel_route
    from .pallas_nfa import bit_supported

    return kernel_route() == "kernel" and bit_supported(get_program(pattern))


def _mats(col: StringColumn):
    return layout.char_matrix(col)


def _buckets(col: StringColumn):
    """Length buckets when beneficial (VERDICT r1 item 7), else None."""
    import os

    if os.environ.get("CUSTRINGS_LENGTH_BUCKETS") == "0":
        return None
    return layout.length_buckets(col)


def _chunk_size(width: int) -> int:
    """Chunk G ~ sqrt(width) rounded to a power of two (depth G + log C)."""
    g = 64
    while g * g < width:
        g *= 2
    return g


def _chunk_threshold() -> int:
    import os

    return int(os.environ.get("CUSTRINGS_CHUNK_THRESHOLD", "2048"))


def _matches(col: StringColumn, pattern: str, anchored: bool) -> jax.Array:
    """Bucketed boolean-match driver: each length class runs the engine at
    its own padded width; results scatter back by row id.  Length classes
    past the chunk threshold use the chunked transfer-matrix engine
    (device.py nfa_matches_chunked) so one huge row stops serializing.

    ASCII-dominant columns run the whole engine with packed-bit LUT
    predicates (no 64K-table gathers) and re-run only the non-ASCII rows
    through the general engine."""
    bits = get_bit_nfa(pattern) if use_bit_kernel(pattern) else None
    xdp = get_program(pattern)
    thresh = _chunk_threshold()

    def engine(chars, nch, ascii=False):
        width = int(chars.shape[1])
        if width >= thresh:
            return xdp.nfa_matches_chunked(
                chars, nch, anchored, _chunk_size(width), ascii
            )
        if bits is not None:
            return bits.matches(chars, nch, anchored, ascii)
        return xdp.nfa_matches(chars, nch, anchored, ascii)

    bks = _buckets(col)
    if bks is None:
        chars, nch = _mats(col)
        na = layout.row_nonascii_ids(col)
        if na is not None and len(na) * 8 <= max(col.size, 1):
            m = engine(chars, nch, ascii=True)
            if len(na):
                nad = jnp.asarray(na, jnp.int32)
                m = m.at[nad].set(engine(chars[nad], nch[nad]))
            return m & col.validity
        return engine(chars, nch) & col.validity
    out = jnp.zeros(col.size + 1, jnp.bool_)
    for bk in bks:
        chars, nch = layout.char_matrix_rows(col, bk)
        m = engine(chars, nch) & bk.vmask
        out = out.at[bk.idx_s].set(m)
    return out[: col.size]


def contains_re(col: StringColumn, pattern: str) -> jax.Array:
    """bool[rows] (count.cu contains_re:59); null rows -> False."""
    return _matches(col, pattern, False)


def match_re(col: StringColumn, pattern: str) -> jax.Array:
    """Anchored-at-0 match (count.cu match:113)."""
    return _matches(col, pattern, True)


def _all_spans_device(col: StringColumn, pattern: str):
    """One-dispatch all-matches (device.py all_spans).  Returns device
    arrays (counts int32[n], B int32[n, Rcap], E int32[n, Rcap]).

    ASCII-dominant columns take the packed-bit predicate path and re-run
    only the non-ASCII rows through the general engine."""
    dp = get_program(pattern)
    chars, nch = _mats(col)
    fast = dp.prog.longest_safe and dp.I <= 128
    Rcap = int(chars.shape[1]) + 2
    if col.size * Rcap > (1 << 24):
        # [n, Rcap] planes would be GBs at the 1M tier: bound the round
        # count with a counts-only pass + one scalar sync first
        Rcap = max(int(jax.device_get(jnp.max(count_re(col, pattern)))), 1)
    na = layout.row_nonascii_ids(col)
    if na is not None and len(na) * 8 <= max(col.size, 1):
        counts, B, E = dp.all_spans(
            chars, nch, col.validity, Rcap, not fast, True
        )
        if len(na):
            nad = jnp.asarray(na, jnp.int32)
            c2, B2, E2 = dp.all_spans(
                chars[nad], nch[nad], col.validity[nad], Rcap, not fast
            )
            counts = counts.at[nad].set(c2)
            B = B.at[nad].set(B2)
            E = E.at[nad].set(E2)
        return counts, B, E
    return dp.all_spans(chars, nch, col.validity, Rcap, not fast)


def _all_spans_host(col: StringColumn, pattern: str):
    """(counts int32[n], B int64[n, rounds], E int64[n, rounds]) numpy.

    Bucketed: each length class runs its own all_spans at its own width
    and round cap; per-bucket results assemble on host (rounds = observed
    max match count, usually far below any width-derived cap)."""
    dp = get_program(pattern)
    fast = dp.prog.longest_safe and dp.I <= 128
    bks = _buckets(col)
    if bks is None:
        counts, B, E = _all_spans_device(col, pattern)
        counts_np, B_np, E_np = jax.device_get((counts, B, E))
        return (
            np.asarray(counts_np),
            np.asarray(B_np).astype(np.int64),
            np.asarray(E_np).astype(np.int64),
        )
    n = col.size
    parts = []
    for bk in bks:
        chars, nch = layout.char_matrix_rows(col, bk)
        parts.append(
            dp.all_spans(chars, nch, bk.vmask, bk.width + 2, not fast)
        )
    fetched = jax.device_get(parts)
    counts = np.zeros(n, np.int32)
    for bk, (c_b, _, _) in zip(bks, fetched):
        counts[bk.idx_np] = np.asarray(c_b)[: bk.nv]
    rounds = int(counts.max(initial=0))
    B = np.full((n, max(rounds, 1)), -1, np.int64)
    E = np.full((n, max(rounds, 1)), -1, np.int64)
    for bk, (_, b_b, e_b) in zip(bks, fetched):
        r_b = min(rounds, b_b.shape[1])
        B[bk.idx_np, :r_b] = np.asarray(b_b)[: bk.nv, :r_b]
        E[bk.idx_np, :r_b] = np.asarray(e_b)[: bk.nv, :r_b]
    return counts, B, E


def _iter_spans(col: StringColumn, pattern: str, max_iters: int | None = None):
    """Non-overlapping leftmost matches per row, reference advance rule
    (count.cu:178-190: begin = end if end>begin else begin+1).

    Round 2: ONE device dispatch + ONE host fetch per length bucket
    (all_spans); yields the same (hit np, begins np, ends np) per-round
    views the consumers were built against.
    """
    if col.size == 0:
        return
    counts_np, B_np, E_np = _all_spans_host(col, pattern)
    rounds = int(counts_np.max(initial=0))
    if max_iters is not None:
        rounds = min(rounds, max_iters)
    for r in range(rounds):
        hit = r < counts_np
        yield hit, B_np[:, r], E_np[:, r]


def count_re(col: StringColumn, pattern: str) -> jax.Array:
    """int32[rows] match counts, one dispatch per length bucket
    (count.cu:178-199)."""
    if col.size == 0:
        return jnp.zeros(0, jnp.int32)
    dp = get_program(pattern)
    fast = dp.prog.longest_safe and dp.I <= 128
    bks = _buckets(col)
    if bks is None:
        chars, nch = _mats(col)
        c, _, _ = dp.all_spans(
            chars, nch, col.validity, int(chars.shape[1]) + 2, not fast,
            counts_only=True,
        )
        return c
    out = jnp.zeros(col.size + 1, jnp.int32)
    for bk in bks:
        chars, nch = layout.char_matrix_rows(col, bk)
        c_b, _, _ = dp.all_spans(
            chars, nch, bk.vmask, bk.width + 2, not fast, counts_only=True
        )
        out = out.at[bk.idx_s].set(c_b)
    return out[: col.size]


def findall_spans(col: StringColumn, pattern: str):
    """list of per-iteration (hit, begin, end) numpy arrays."""
    return list(_iter_spans(col, pattern))


def findall_columns(col: StringColumn, pattern: str) -> list[StringColumn]:
    """Column-major findall (findall.cu:99): column i = i-th match."""
    out = []
    for hit, b, e in findall_spans(col, pattern):
        sub = substr.slice_from(
            col,
            jnp.asarray(np.where(hit, b, 0), jnp.int32),
            jnp.asarray(np.where(hit, np.maximum(e, 1), 0), jnp.int32),
        )
        # rows without a match this round -> null
        sub = _mask_rows(sub, jnp.asarray(hit))
        # empty matches must stay "" not full row: slice_from stop<=0 quirk
        out.append(_fix_empty(sub, b, e, hit))
    return out


def _mask_rows(c: StringColumn, valid) -> StringColumn:
    from ..ops.split import _mask_column

    return _mask_column(c, valid)


def _fix_empty(sub: StringColumn, b, e, hit) -> StringColumn:
    empty = hit & (e <= b)
    if not empty.any():
        return sub
    sizes = jnp.where(jnp.asarray(empty), 0, sub.lengths())
    starts = sub.offsets[:-1]

    def produce(rows, k, valid):
        return layout.gather_bytes(sub.data, starts[rows] + k)

    return build_column(sizes, sub.validity, produce)


def findall_record(col: StringColumn, pattern: str):
    """Per-row list of matches (findall_record.cu:97) as a TokenColumn.

    Fully vectorized assembly (VERDICT r2 item 6): the span matrix from
    _all_spans_host is indexed straight into token arrays — per-row hits
    along the round axis are a prefix (counts_np[r] rounds), so token k of
    row r is B[r, k - row_off[r]].  No Python per-row/per-match loops."""
    from ..ops.split import TokenColumn

    n = col.size
    if n == 0:
        from ..column import empty_column

        return TokenColumn(
            empty_column(0), jnp.zeros(1, jnp.int32), jnp.zeros(0, bool)
        )
    counts_np, B_np, E_np = _all_spans_host(col, pattern)
    counts = counts_np.astype(np.int64)
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_off[1:])
    total = int(row_off[-1])
    tok_rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    li = np.arange(total, dtype=np.int64) - row_off[tok_rows]
    starts = B_np[tok_rows, li] if total else np.zeros(0, np.int64)
    ends = E_np[tok_rows, li] if total else np.zeros(0, np.int64)
    toks = _substr_tokens(col, tok_rows, starts, ends)
    return TokenColumn(
        toks, jnp.asarray(row_off.astype(np.int32)), col.validity
    )


def _char_to_byte_np(col: StringColumn):
    """Host helper: vectorized char-position -> byte-position translator.

    Returns (offsets_np, to_byte(rows, chars)) where to_byte clips results
    into each row's byte range (the numpy mirror of layout.char_map)."""
    cm = layout.char_map(col)
    co = np.asarray(jax.device_get(cm.char_offsets))
    char_pos = np.asarray(jax.device_get(cm.char_pos))
    offsets = np.asarray(jax.device_get(col.offsets)).astype(np.int64)
    tc = int(jax.device_get(cm.cs0[-1]))

    def to_byte(rows, chars):
        g = co[rows] + np.asarray(chars, np.int64)
        safe = np.minimum(g, max(len(char_pos) - 1, 0)).astype(np.int64)
        pos = np.where(g >= tc, offsets[-1], char_pos[safe].astype(np.int64))
        return np.clip(pos, offsets[rows], offsets[rows + 1])

    return offsets, to_byte


def _substr_tokens(col, tok_rows, b_chars, e_chars) -> StringColumn:
    """Extract char ranges (possibly several per row) into a new column."""
    _, to_byte = _char_to_byte_np(col)
    n = len(tok_rows)
    tok_rows = np.asarray(tok_rows, np.int64)
    sb = to_byte(tok_rows, b_chars) if n else np.zeros(0, np.int64)
    eb = to_byte(tok_rows, e_chars) if n else np.zeros(0, np.int64)
    sizes = jnp.asarray(np.maximum(eb - sb, 0), jnp.int32)
    sb_j = jnp.asarray(sb, jnp.int32)

    def produce(rows, k, valid):
        return layout.gather_bytes(col.data, sb_j[rows] + k)

    return build_column(sizes, jnp.ones(n, jnp.bool_), produce)


def extract(col: StringColumn, pattern: str) -> list[StringColumn]:
    """Column per capture group from the first match (extract.cu:69)."""
    dp = get_program(pattern)
    groups = dp.groups_count
    if groups == 0:
        return []
    chars, nch = _mats(col)
    n = col.size
    zeros = jnp.zeros(n, jnp.int32)
    # first-match spans via the router (bit-parallel for certified
    # programs — the group extractions below stay on the capture-capable
    # ordered/DFS engine, anchored at the found begins)
    m0b, b0, e0 = dp.spans_single(chars, nch, zeros)
    m0_np = np.asarray(jax.device_get(m0b)).astype(bool)
    b0_np = np.asarray(jax.device_get(b0))
    out = []
    for g in range(1, groups + 1):
        mg, bg, eg = dp.spans_exec(
            chars,
            nch,
            jnp.asarray(np.where(m0_np, b0_np, 0), jnp.int32),
            jnp.asarray(np.where(m0_np, b0_np + 1, 0), jnp.int32),
            g,
        )
        ok = (
            jnp.asarray(m0_np)
            & (mg > 0)
            & (bg >= 0)
            & (eg >= bg)
            & col.validity
        )
        sub = substr.slice_from(
            col,
            jnp.where(ok, bg, 0),
            jnp.where(ok, jnp.maximum(eg, 1), 0),
        )
        sub = _mask_rows(sub, ok)
        e_np = np.asarray(jax.device_get(eg))
        b_np = np.asarray(jax.device_get(bg))
        out.append(
            _fix_empty(sub, b_np, e_np, np.asarray(jax.device_get(ok)))
        )
    return out


def extract_record(col: StringColumn, pattern: str) -> list[StringColumn]:
    """Row-major extract (extract_record.cu:96): one column of groups per
    row — returned as list of per-row columns at the API layer; the core
    returns the same group columns as extract()."""
    return extract(col, pattern)


def replace_re(
    col: StringColumn, pattern: str, repl: str = "", n: int = -1
) -> StringColumn:
    """Replace non-overlapping matches (replace.cu replace_re:110)."""
    spans = []
    limit = n if n >= 0 else None
    for i, (hit, b, e) in enumerate(_iter_spans(col, pattern)):
        if limit is not None and i >= limit:
            break
        spans.append((hit, b, e))
    return _splice(col, spans, repl)


def _splice(col: StringColumn, spans, repl) -> StringColumn:
    """Rebuild rows replacing char-span matches with repl bytes.

    `repl` is a single str, or a list of str indexed by the span's
    replacement id (spans then carry (hit, b, e, rid))."""
    if isinstance(repl, (list, tuple)):
        repl_tab = [r.encode("utf-8") if isinstance(r, str) else bytes(r) for r in repl]
    else:
        repl_tab = [
            repl.encode("utf-8") if isinstance(repl, str) else bytes(repl)
        ]
    n = col.size
    # token arrays from the per-round span views — vectorized (VERDICT r2
    # item 6): hits along the round axis are a per-row prefix, but the
    # scatter below is order-correct even when they are not.
    nr = len(spans)
    H = np.stack([np.asarray(s[0], bool) for s in spans]) if nr else np.zeros((0, n), bool)
    Bm = np.stack([np.asarray(s[1], np.int64) for s in spans]) if nr else np.zeros((0, n), np.int64)
    Em = np.stack([np.asarray(s[2], np.int64) for s in spans]) if nr else np.zeros((0, n), np.int64)
    RIDm = (
        np.stack(
            [
                np.asarray(s[3], np.int64)
                if len(s) == 4
                else np.zeros(n, np.int64)
                for s in spans
            ]
        )
        if nr
        else np.zeros((0, n), np.int64)
    )
    counts = H.sum(0).astype(np.int64)
    row_tok0 = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_tok0[1:])
    total_tok = int(row_tok0[-1])
    if total_tok == 0:  # no matches anywhere: replace is the identity
        return col
    # slot of hit (round i, row r) = row_tok0[r] + (#hits at rounds < i)
    li = H.cumsum(0) - 1
    slot = (row_tok0[None, :-1] + li)[H]
    tb = np.zeros(total_tok, np.int64)
    te = np.zeros(total_tok, np.int64)
    trid = np.zeros(total_tok, np.int64)
    tb[slot] = Bm[H]
    te[slot] = Em[H]
    trid[slot] = RIDm[H]

    offsets, to_byte = _char_to_byte_np(col)
    valid = np.asarray(jax.device_get(col.validity))
    tok_rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    sb = to_byte(tok_rows, tb) if total_tok else np.zeros(0, np.int64)
    eb = to_byte(tok_rows, te) if total_tok else np.zeros(0, np.int64)

    # flatten replacement table into one buffer
    rt_off = np.zeros(len(repl_tab) + 1, np.int64)
    np.cumsum([len(r) for r in repl_tab], out=rt_off[1:])
    rt_buf = b"".join(repl_tab)

    # piece model: for each valid row, alternating keep/replace segments
    # then one tail — (2*counts + 1) pieces; invalid rows contribute none.
    li_flat = np.arange(total_tok, dtype=np.int64) - row_tok0[tok_rows]
    # copied-up-to byte before token k: previous token's end (spans within
    # a row are sorted + non-overlapping) or the row start
    eb_shift = np.concatenate([np.zeros(1, np.int64), eb[:-1]])
    cur = np.where(li_flat > 0, eb_shift, offsets[tok_rows])
    cur = np.maximum(cur, offsets[tok_rows])

    row_piece_counts = np.where(valid, 2 * counts + 1, 0)
    row_p0 = np.zeros(n + 1, np.int64)
    np.cumsum(row_piece_counts, out=row_p0[1:])
    P = int(row_p0[-1])
    if P == 0:
        return col
    ps = np.zeros(P, np.int64)
    pe = np.zeros(P, np.int64)
    pr = np.zeros(P, np.bool_)
    tok_valid = valid[tok_rows]
    keep_idx = (row_p0[tok_rows] + 2 * li_flat)[tok_valid]
    ps[keep_idx] = cur[tok_valid]
    pe[keep_idx] = sb[tok_valid]
    ps[keep_idx + 1] = rt_off[trid[tok_valid]]
    pe[keep_idx + 1] = rt_off[trid[tok_valid] + 1]
    pr[keep_idx + 1] = True
    vrows = np.nonzero(valid)[0]
    tail_idx = row_p0[vrows] + 2 * counts[vrows]
    has_tok = counts[vrows] > 0
    last_eb = eb[np.maximum(row_tok0[vrows + 1] - 1, 0)]
    ps[tail_idx] = np.where(
        has_tok, np.maximum(last_eb, offsets[vrows]), offsets[vrows]
    )
    pe[tail_idx] = offsets[vrows + 1]
    plens = np.maximum(pe - ps, 0)
    pb0 = np.zeros(len(ps) + 1, np.int64)
    np.cumsum(plens, out=pb0[1:])
    # per-row output offsets
    out_offsets = pb0[row_p0].astype(np.int32)
    total = int(pb0[-1])

    from ..config import bucket_bytes
    from ..column import row_ids_from_offsets

    bcap = bucket_bytes(total)
    j = jnp.arange(bcap, dtype=jnp.int32)
    pb0_j = jnp.asarray(pb0.astype(np.int32))
    pid = row_ids_from_offsets(pb0_j, bcap)
    within = j - pb0_j[pid]
    ps_j = jnp.asarray(ps.astype(np.int32))
    pr_j = jnp.asarray(pr)
    src = layout.gather_bytes(col.data, ps_j[pid] + within)
    repl_a = (
        jnp.asarray(np.frombuffer(rt_buf, np.uint8))
        if rt_buf
        else jnp.zeros(1, jnp.uint8)
    )
    rep = repl_a[
        jnp.clip(ps_j[pid] + within, 0, max(len(rt_buf) - 1, 0))
    ]
    data = jnp.where(
        j < total, jnp.where(pr_j[pid], rep, src), jnp.uint8(0)
    )
    return StringColumn(data, jnp.asarray(out_offsets), col.validity)


@lru_cache(maxsize=64)
def _multi_spans_fn(patterns: tuple):
    """Jitted one-dispatch multi-pattern all-spans for a pattern tuple.

    Per round: every pattern's first-match span from the shared begins;
    earliest begin wins, ties to the lowest pattern index
    (replace_multi.cu:110).  Same device round loop as all_spans.
    """
    dps = [get_program(p) for p in patterns]
    BIG = jnp.int32(1 << 30)

    @partial(jax.jit, static_argnums=(3, 4))
    def fn(chars, lengths, validity, Rcap: int, counts_only: bool = False):
        N, _ = chars.shape
        W = 1 if counts_only else Rcap

        def cond(state):
            return (state[0] < Rcap) & jnp.any(state[2])

        def body(state):
            r, begins, active, counts, B, E, ID = state
            best_b = jnp.full((N,), BIG, jnp.int32)
            best_e = jnp.zeros((N,), jnp.int32)
            best_id = jnp.full((N,), -1, jnp.int32)
            for k, dp in enumerate(dps):
                # per-pattern router: bit-parallel when certified
                m, b, e = dp.spans_single(chars, lengths, begins)
                better = m & (b < best_b)
                best_b = jnp.where(better, b, best_b)
                best_e = jnp.where(better, e, best_e)
                best_id = jnp.where(better, k, best_id)
            hit = active & (best_id >= 0)
            counts = counts + hit.astype(jnp.int32)
            z = jnp.zeros((), r.dtype)  # same-dtype index pair under x64
            upd = lambda M, v: jax.lax.dynamic_update_slice(
                M, jnp.where(hit, v, -1).astype(jnp.int32)[:, None], (z, r)
            )
            if not counts_only:
                B, E, ID = upd(B, best_b), upd(E, best_e), upd(ID, best_id)
            begins = jnp.where(
                hit,
                jnp.where(best_e > best_b, best_e, begins + 1),
                begins,
            ).astype(jnp.int32)
            active = hit & (begins <= lengths)
            return r + 1, begins, active, counts, B, E, ID

        neg = jnp.full((N, W), -1, jnp.int32)
        state0 = (
            jnp.int32(0), jnp.zeros(N, jnp.int32), validity,
            jnp.zeros(N, jnp.int32), neg, neg, neg,
        )
        out = jax.lax.while_loop(cond, body, state0)
        return out[3], out[4], out[5], out[6]

    return fn


def replace_multi_re(
    col: StringColumn, patterns: list[str], repls
) -> StringColumn:
    """Apply N regexes in one pass (replace_multi.cu:110): at each step the
    earliest match wins; position ties resolve to the lowest pattern index.
    ONE device dispatch for all rounds of all patterns."""
    if isinstance(repls, (list, tuple)):
        rl = list(repls)
        if len(rl) == 1 and len(patterns) > 1:
            # one repl recycles across all patterns
            # (reference python/tests/test_replace_multi.py::test_replace_re)
            rl = rl * len(patterns)
    else:
        rl = [repls] * len(patterns)
    if len(rl) != len(patterns):
        raise ValueError("repls must have 1 or len(patterns) entries")
    if col.size == 0:
        return col
    import os

    if os.environ.get("CUSTRINGS_MULTI_HOST") == "1":
        chars, nch = _mats(col)
        Rcap = int(chars.shape[1]) + 2
        fn = _multi_spans_fn(tuple(patterns))
        counts, B, E, ID = jax.device_get(
            fn(chars, nch, col.validity, Rcap)
        )
        spans = []
        for r in range(int(counts.max(initial=0))):
            hit = r < counts
            spans.append(
                (
                    hit,
                    B[:, r].astype(np.int64),
                    E[:, r].astype(np.int64),
                    np.maximum(ID[:, r], 0).astype(np.int32),
                )
            )
        return _splice(col, spans, rl)
    return _replace_multi_device(col, tuple(patterns), rl)


def _replace_multi_device(col: StringColumn, patterns, rl) -> StringColumn:
    """Device assembly for multi-pattern replace (round 4, VERDICT r3
    weak #4): a counts-only pass bounds the round planes, one dispatch
    records every round's (begin, end, pattern id), and the output is
    stitched with the shared routing writers (_replace_frame +
    _stream_expand_spans) — no host round loop, two scalar syncs.
    Ref: replace_multi.cu:110-168."""
    from ..ops import shift_compact

    chars, nch = _mats(col)
    wcap = int(chars.shape[1]) + 2
    fn = _multi_spans_fn(patterns)
    cnt = fn(chars, nch, col.validity, wcap, True)[0]
    R = int(jax.device_get(jnp.max(cnt)))
    if R == 0:
        return _copy_column(col)
    counts, B, E, ID = fn(chars, nch, col.validity, R, False)

    cm = layout.char_map(col)
    c2b = _c2b_fn(col, cm, nch)
    Bb, Eb = c2b(B), c2b(E)
    hitm = B >= 0
    repl_tab = [
        r.encode("utf-8") if isinstance(r, str) else bytes(r) for r in rl
    ]
    lens_tab = jnp.asarray([len(r) for r in repl_tab], jnp.int32)
    IDc = jnp.clip(ID, 0, len(repl_tab) - 1)
    rep_sz = lens_tab[IDc]

    out_off, bcap, rep_start, out_data = _replace_frame(
        col, Bb, Eb, hitm, rep_sz
    )

    Lmax = max((len(r) for r in repl_tab), default=0)
    if Lmax:
        n, _ = hitm.shape
        nR = n * R
        # [P, Lmax] padded table; per-span byte values by row gather
        T = np.zeros((len(repl_tab), Lmax), np.uint8)
        for i, r in enumerate(repl_tab):
            T[i, : len(r)] = np.frombuffer(r, np.uint8)
        vals = jnp.take(jnp.asarray(T), IDc.reshape(-1), axis=0)
        bcol = jnp.arange(Lmax, dtype=jnp.int32)[None, :]
        live = hitm.reshape(-1)[:, None] & (
            bcol < rep_sz.reshape(-1)[:, None]
        )
        (stream,), k0s = shift_compact.compact_arrays(
            live.reshape(-1), [vals.reshape(-1)]
        )
        rplane = _stream_expand_spans(
            col, stream, k0s[-1],
            rep_start.reshape(-1),
            jnp.where(hitm, rep_sz, 0).reshape(-1),
            hitm.reshape(-1), bcap,
        )
        out_data = out_data + rplane

    return StringColumn(out_data.astype(jnp.uint8), out_off, col.validity)


def replace_with_backrefs(
    col: StringColumn, pattern: str, repl: str
) -> StringColumn:
    """Replacement template with \\1-style backrefs, applied to EVERY
    non-overlapping match (replace_backref.cu:122; template pre-parse
    mirrors backref.h:32-57).

    Round 4: assembled ON DEVICE — one all_spans dispatch records match +
    group spans for every round (device.py all_spans groups=...), and the
    output is stitched with the linear routing writers (gap bytes
    compact+expand, group substrings per template token, literals from a
    tiled constant).  The only host syncs are two scalars (max match
    count, total output bytes).  CUSTRINGS_BREF_HOST=1 keeps the round-3
    host splicer for comparison."""
    import os

    if os.environ.get("CUSTRINGS_BREF_HOST") != "1":
        return _replace_backrefs_device(col, pattern, repl)
    return _replace_backrefs_host(col, pattern, repl)


def _copy_column(col: StringColumn) -> StringColumn:
    return StringColumn(col.data, col.offsets, col.validity)


def _c2b_fn(col: StringColumn, cm, nch):
    """Vectorized char->byte coordinate conversion for [n, R] planes
    (-1 passes through; end-of-row maps to the row's end offset)."""
    cap = col.capacity
    co = cm.char_offsets[:-1][:, None]

    def c2b(P):
        base = jnp.clip(co + P, 0, max(cap - 1, 0))
        b = cm.char_pos[base]
        b = jnp.where(P >= nch[:, None], col.offsets[1:][:, None], b)
        return jnp.where(P < 0, -1, b).astype(jnp.int32)

    return c2b


def _cover_spans(col: StringColumn, bb, ee, okm):
    """Byte-domain cover mask of the [bb, ee) spans (disjoint, ordered;
    flat scatter + linear prefix)."""
    from ..ops.shift_compact import cover_spans

    return cover_spans(bb, ee, okm, col.capacity)


def _replace_frame(col: StringColumn, Bb, Eb, hitm, rep_sz):
    """Shared size calculus + gap-byte routing for span replacement.

    Given byte-coordinate match planes [n, R] and per-match replacement
    sizes, computes the output offsets and routes every byte OUTSIDE the
    matches to its output position (compact + expand, linear passes).
    Returns (out_off, bcap, rep_start, gap_plane).  Two scalar syncs
    total per op (R bound by the caller, total output bytes here) —
    matching the reference's size-pass/write-pass sync
    (replace_backref.cu:180).
    """
    from ..column import cumsum0
    from ..config import bucket_bytes
    from ..ops import segments, shift_compact

    cap = col.capacity
    off0 = col.offsets[:-1][:, None]
    msz = jnp.where(hitm, Eb - Bb, 0)
    rep_sz = jnp.where(hitm, rep_sz, 0)

    lens = col.offsets[1:] - col.offsets[:-1]
    out_lens = lens - msz.sum(axis=1) + rep_sz.sum(axis=1)
    out_off = cumsum0(out_lens)
    total = int(jax.device_get(out_off[-1]))  # scalar sync
    bcap = bucket_bytes(max(total, 1))

    rem_bef = jnp.cumsum(msz, axis=1) - msz
    ins_bef = jnp.cumsum(rep_sz, axis=1) - rep_sz
    rep_start = out_off[:-1, None] + (Bb - off0) - rem_bef + ins_bef

    j = jnp.arange(cap, dtype=jnp.int32)
    valid_byte = j < col.offsets[-1]
    inside_m = _cover_spans(col, Bb, Eb, hitm)
    keep_gap = valid_byte & ~inside_m

    # inserted-bytes-before-j plane: matches contribute at their END
    ins_plane = segments.cumsum(
        jnp.zeros(cap + 1, jnp.int32)
        .at[jnp.where(hitm, Eb, cap).reshape(-1)]
        .add(rep_sz.reshape(-1))[:cap]
    )
    (gdata, gins), k0g = shift_compact.compact_arrays(
        keep_gap, [col.data, ins_plane]
    )
    live_g = j < k0g[-1]
    (gap_plane,), _ = shift_compact.expand_to(live_g, gins, [gdata], bcap)
    return out_off, bcap, rep_start, gap_plane


def _stream_expand_spans(col, stream, total_live, starts, sizes, okf, bcap):
    """Expand a compacted byte stream into per-span output slots.

    stream: uint8[dom] — span bytes back to back (span order = flat
    [n*R] order of the ok mask).  starts/sizes/okf: flat [n*R] output
    start, byte size, and liveness per span.  The expand distance is
    per-span constant c_k = starts_k - rank_k (nondecreasing because
    output positions strictly increase); materialized over the stream
    domain with a telescoping delta scatter + one linear prefix.
    """
    from ..ops.shift_compact import stream_expand_spans

    return stream_expand_spans(stream, total_live, starts, sizes, okf, bcap)


def _replace_backrefs_device(
    col: StringColumn, pattern: str, repl: str
) -> StringColumn:
    from ..ops import shift_compact

    tokens = _pyre.split(r"\\(\d+)", repl)
    lits = [t.encode("utf-8") for t in tokens[::2]]  # P+1 literals
    gids = [int(t) for t in tokens[1::2]]  # P group refs between them
    dp = get_program(pattern)
    n = col.size
    if n == 0:
        return _copy_column(col)

    chars, nch = _mats(col)
    # one scalar sync bounds the round count (all_spans planes are
    # [n, R]: Rcap = width+2 would be GBs at the 1M tier).  Unbucketed
    # counts-only pass: ONE compile instead of count_re's per-bucket
    # programs (each compile costs seconds).
    fast0 = dp.prog.longest_safe and dp.I <= 128
    cnt0, _, _ = dp.all_spans(
        chars, nch, col.validity, int(chars.shape[1]) + 2, not fast0,
        counts_only=True,
    )
    R = int(jax.device_get(jnp.max(cnt0)))
    if R == 0:
        return _copy_column(col)
    fast = dp.prog.longest_safe and dp.I <= 128
    exec_gids = tuple(sorted({g for g in gids if g != 0}))
    if exec_gids:
        counts, B, E, GBE = dp.all_spans(
            chars, nch, col.validity, R, not fast, groups=exec_gids
        )
    else:
        counts, B, E = dp.all_spans(chars, nch, col.validity, R, not fast)
        GBE = []
    gplane = {g: GBE[i] for i, g in enumerate(exec_gids)}
    gplane[0] = (B, E)

    cm = layout.char_map(col)
    c2b = _c2b_fn(col, cm, nch)
    Bb, Eb = c2b(B), c2b(E)
    hitm = B >= 0  # [n, R]
    gB, gE = {}, {}
    for g in gplane:
        pb, pe = gplane[g]
        bb, ee = c2b(pb), c2b(pe)
        ok = hitm & (bb >= 0) & (ee >= bb)
        gB[g], gE[g] = jnp.where(ok, bb, 0), jnp.where(ok, ee, 0)
    tok_sz = [gE[g] - gB[g] for g in gids]  # per group token, [n, R]

    lit_total = sum(len(b) for b in lits)
    rep_sz = jnp.zeros_like(Bb) + lit_total
    for sz in tok_sz:
        rep_sz = rep_sz + sz

    out_off, bcap, rep_start, out_data = _replace_frame(
        col, Bb, Eb, hitm, rep_sz
    )

    # piece starts inside the replacement: lit_0 g_0 lit_1 g_1 ... lit_P
    P = len(gids)
    lit_starts = []  # [n, R] per literal piece
    tok_starts = []  # [n, R] per group token
    acc = rep_start
    for i in range(P + 1):
        lit_starts.append(acc)
        acc = acc + len(lits[i])
        if i < P:
            tok_starts.append(acc)
            acc = acc + tok_sz[i]

    # ---- group tokens: compact the span bytes, expand to their slots --
    nR = n * R
    for ti, g in enumerate(gids):
        okt = hitm & (gE[g] > gB[g])
        inside_t = _cover_spans(col, gB[g], gE[g], okt) & (
            jnp.arange(col.capacity, dtype=jnp.int32) < col.offsets[-1]
        )
        (tdata,), k0t = shift_compact.compact_arrays(inside_t, [col.data])
        tplane = _stream_expand_spans(
            col, tdata, k0t[-1],
            tok_starts[ti].reshape(-1),
            tok_sz[ti].reshape(-1),
            okt.reshape(-1), bcap,
        )
        out_data = out_data + tplane

    # ---- literals: tiled constant expanded to per-match positions -----
    # Work in MATCH-RANK order so every live lane precedes every dead
    # lane (dist must be >= 0 and monotone over live): lane (m, b) holds
    # byte b of the LT literal block for the m-th VALID match.
    if lit_total:
        lit_cat = jnp.asarray(np.frombuffer(b"".join(lits), np.uint8))
        # static maps: byte b of the LT block -> (piece index, offset)
        pmap, omap = [], []
        for i, lb in enumerate(lits):
            pmap += [i] * len(lb)
            omap += list(range(len(lb)))
        pmap = jnp.asarray(pmap, jnp.int32)
        omap = jnp.asarray(omap, jnp.int32)
        piece_start = jnp.stack(lit_starts, axis=2)  # [n, R, P+1]
        hitf = hitm.reshape(-1)
        vpos = jnp.cumsum(hitf.astype(jnp.int32)) - 1
        nv = jnp.sum(hitf.astype(jnp.int32))
        # row m of vps = piece starts of the m-th valid match
        vps = jnp.zeros((nR, P + 1), jnp.int32).at[
            jnp.where(hitf, vpos, nR - 1)
        ].set(
            jnp.where(hitf[:, None], piece_start.reshape(nR, P + 1), 0)
        )
        iv = jnp.arange(nR, dtype=jnp.int32)
        out_pos = jnp.take(vps, pmap, axis=1) + omap[None, :]  # [nR, LT]
        fi = iv[:, None] * lit_total + jnp.arange(
            lit_total, dtype=jnp.int32
        )[None, :]
        live_l = (iv[:, None] < nv) & jnp.ones((1, lit_total), bool)
        dist_l = jnp.where(live_l, out_pos - fi, 0).reshape(-1)
        src = jnp.tile(lit_cat, nR)
        (lplane,), _ = shift_compact.expand_to(
            live_l.reshape(-1), dist_l, [src], bcap
        )
        out_data = out_data + lplane

    return StringColumn(out_data.astype(jnp.uint8), out_off, col.validity)



def _replace_backrefs_host(
    col: StringColumn, pattern: str, repl: str
) -> StringColumn:
    """Round-3 host splicer (kept for CUSTRINGS_BREF_HOST=1 comparison)."""
    # parse template into alternating literal, group-id tokens
    tokens = _pyre.split(r"\\(\d+)", repl)
    dp = get_program(pattern)
    chars, nch = _mats(col)
    n = col.size
    nch_np = np.asarray(jax.device_get(nch))
    host = _to_host_np(col)
    pieces = [[] for _ in range(n)]
    cur = np.zeros(n, np.int64)  # copied-up-to char position per row
    begins = np.zeros(n, np.int64)
    active = np.asarray(jax.device_get(col.validity)).copy()
    while active.any():
        m, b, e = dp.spans_exec(
            chars, nch, jnp.asarray(begins, jnp.int32),
            jnp.full(n, -1, jnp.int32), 0,
        )
        m_np = np.asarray(jax.device_get(m)) > 0
        b_np = np.asarray(jax.device_get(b)).astype(np.int64)
        e_np = np.asarray(jax.device_get(e)).astype(np.int64)
        hit = active & m_np
        if not hit.any():
            break
        gspans = {}
        for g in range(1, dp.groups_count + 1):
            mg, bg, eg = dp.spans_exec(
                chars, nch,
                jnp.asarray(np.where(hit, b_np, 0), jnp.int32),
                jnp.asarray(np.where(hit, b_np + 1, 0), jnp.int32),
                g,
            )
            gspans[g] = (
                np.asarray(jax.device_get(mg)) > 0,
                np.asarray(jax.device_get(bg)),
                np.asarray(jax.device_get(eg)),
            )
        for r in np.nonzero(hit)[0]:
            s_r = host[r]
            rep = ""
            for i, tkn in enumerate(tokens):
                if i % 2 == 0:
                    rep += tkn
                else:
                    g = int(tkn)
                    if g in gspans and gspans[g][0][r]:
                        gb, ge = int(gspans[g][1][r]), int(gspans[g][2][r])
                        if 0 <= gb <= ge:
                            rep += s_r[gb:ge]
            pieces[r].append(s_r[int(cur[r]) : int(b_np[r])])
            pieces[r].append(rep)
            cur[r] = e_np[r]
        begins = np.where(
            hit, np.where(e_np > b_np, e_np, begins + 1), begins
        )
        active = hit & (begins <= nch_np)
    out = []
    for r in range(n):
        s_r = host[r]
        if s_r is None:
            out.append(None)
        else:
            out.append("".join(pieces[r]) + s_r[int(cur[r]) :])
    from ..column import from_host_strings

    return from_host_strings(out)


def _to_host_np(col: StringColumn):
    from ..column import to_host_strings

    return to_host_strings(col)
