"""N-grams over the rows of a column.

Array re-design of cpp/src/text/ngram.cu (create_ngrams:32): rows are
treated as tokens; null/empty rows are removed first; output row i joins
rows [i, i+N) with the separator.  count <= N falls back to a full join
(ngram.cu:52-54).
"""

from __future__ import annotations

import jax.numpy as jnp
from ..ops.segments import cumsum as _cumsum

from ..column import StringColumn, build_column
from ..ops import array, combine, layout


def create_ngrams(
    col: StringColumn, n: int = 2, separator: str = "_"
) -> StringColumn:
    n = max(int(n), 1)
    # remove nulls/empties (host compaction like gather_mask)
    mask = col.validity & (col.lengths() > 0)
    toks = array.gather_mask(col, mask)
    count = toks.size
    if count <= n:
        return combine.join(toks, separator)
    if n == 1:
        return toks
    sep_b = separator.encode("utf-8")
    sl = len(sep_b)
    sep_a = jnp.asarray(list(sep_b), jnp.uint8) if sl else jnp.zeros(0, jnp.uint8)
    out_n = count - n + 1
    lens = toks.lengths()
    # sizes[i] = sum lens[i:i+n] + (n-1)*sl   (windowed sum via cumsum)
    l0 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), _cumsum(lens.astype(jnp.int32))]
    )
    sizes = l0[n:] - l0[:-n] + (n - 1) * sl
    starts = toks.offsets[:-1]

    # piece offsets within each output row: piece t = token i+t (+sep)
    # pc[i, t] = start byte of piece t within out row i
    t_idx = jnp.arange(n, dtype=jnp.int32)
    piece_len = lens[jnp.arange(out_n)[:, None] + t_idx[None, :]] + sl
    pc = jnp.concatenate(
        [jnp.zeros((out_n, 1), jnp.int32), jnp.cumsum(piece_len, axis=1)],
        axis=1,
    )  # [out_n, n+1]

    def produce(rows, k, valid, bcast):
        # find piece t: number of pc[row, 1..n-1] <= k  (per-row columns
        # of pc broadcast to byte positions, no capacity-sized gathers)
        t = jnp.zeros_like(k)
        pcb = [bcast(pc[:, tt]) for tt in range(n + 1)]
        for tt in range(1, n):
            t = t + (k >= pcb[tt]).astype(jnp.int32)
        pct = pcb[0]
        for tt in range(1, n + 1):
            pct = jnp.where(t == tt, pcb[tt], pct)
        within = k - pct
        tok = rows + t
        # token attrs: t is data-dependent per byte, so these two stay
        # gathers — over the TOKEN axis, bounded by bcast alternatives
        body = lens[tok]
        in_body = within < body
        src = layout.gather_bytes(toks.data, starts[tok] + within)
        sep_byte = (
            sep_a[jnp.clip(within - body, 0, max(sl - 1, 0))]
            if sl
            else jnp.uint8(0)
        )
        return jnp.where(in_body, src, sep_byte)

    validity = jnp.ones(out_n, jnp.bool_)
    return build_column(sizes, validity, produce)
