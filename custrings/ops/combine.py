"""Concatenation ops: elementwise cat and full-column join.

Array re-design of cpp/src/strings/combine.cu (cat:31, join:291).
Null parity: cat -> null when either side is null and no na_rep
(combine.cu:66-69); join skips null rows (and their delimiter) unless na_rep
(combine.cu:320-345); no trailing delimiter.
"""

from __future__ import annotations

import jax.numpy as jnp
from .segments import cumsum as _cumsum
import numpy as np

from ..column import StringColumn, build_column, jit_materialize
from . import layout


from functools import lru_cache


@lru_cache(maxsize=1024)
def _bytes_arr_cached(b: bytes):
    import jax

    with jax.ensure_compile_time_eval():
        return (
            jnp.asarray(np.frombuffer(b, dtype=np.uint8))
            if b
            else jnp.zeros(0, jnp.uint8)
        )


def _bytes_arr(s: str | None):
    b = (s or "").encode("utf-8")
    return _bytes_arr_cached(b), len(b)


def cat(
    col: StringColumn,
    others: StringColumn,
    sep: str | None = None,
    na_rep: str | None = None,
) -> StringColumn:
    if others.size != col.size:
        raise ValueError("nvstrings.cat sizes do not match")
    sep_a, sep_n = _bytes_arr(sep)
    nar_a, nar_n = _bytes_arr(na_rep)
    return _cat_op(
        col, others, sep_a, nar_a, sep_n, nar_n, na_rep is not None
    )


def _cat_body(
    col: StringColumn,
    others: StringColumn,
    sep_a,
    nar_a,
    sep_n: int,
    nar_n: int,
    have_nar: bool,
):
    llen, rlen = col.lengths(), others.lengths()
    lval, rval = col.validity, others.validity
    out_null = (~lval | ~rval) & (not have_nar)
    lsz = jnp.where(lval, llen, nar_n if have_nar else 0)
    rsz = jnp.where(rval, rlen, nar_n if have_nar else 0)
    sizes = jnp.where(out_null, 0, lsz + sep_n + rsz)
    validity = ~out_null

    lstart, rstart = col.offsets[:-1], others.offsets[:-1]

    def produce(rows, k, valid, bcast):
        ls, rs = bcast(lsz), bcast(rsz)
        lv = bcast(lval.astype(jnp.int32)) == 1
        rv = bcast(rval.astype(jnp.int32)) == 1
        # regions: [0,ls) left, [ls,ls+sep_n) sep, [ls+sep_n, ...) right
        in_left = k < ls
        in_sep = (k >= ls) & (k < ls + sep_n)
        kl = jnp.clip(k, 0, None)
        left_b = jnp.where(
            lv,
            layout.gather_bytes(col.data, bcast(lstart) + kl),
            nar_a[jnp.clip(kl, 0, max(nar_n - 1, 0))] if nar_n else jnp.uint8(0),
        )
        ks = jnp.clip(k - ls, 0, max(sep_n - 1, 0))
        sep_b = sep_a[ks] if sep_n else jnp.uint8(0)
        kr = jnp.clip(k - ls - sep_n, 0, None)
        right_b = jnp.where(
            rv,
            layout.gather_bytes(others.data, bcast(rstart) + kr),
            nar_a[jnp.clip(kr, 0, max(nar_n - 1, 0))] if nar_n else jnp.uint8(0),
        )
        return jnp.where(in_left, left_b, jnp.where(in_sep, sep_b, right_b))

    return sizes, validity, produce


_cat_op = jit_materialize(_cat_body, static_argnums=(4, 5, 6))


def join(col: StringColumn, sep: str = "", na_rep: str | None = None) -> StringColumn:
    """Reduce the whole column to a single-row column (combine.cu join:291)."""
    sep_a, sep_n = _bytes_arr(sep)
    nar_a, nar_n = _bytes_arr(na_rep)
    return _join_op(col, sep_a, nar_a, sep_n, nar_n, na_rep is not None)


def _join_body(
    col: StringColumn, sep_a, nar_a, sep_n: int, nar_n: int, have_nar: bool
):
    n = col.size
    lens = col.lengths()
    body = jnp.where(col.validity, lens, nar_n if have_nar else 0)
    counted = col.validity | have_nar
    # delimiter after every counted row except the last counted one
    idx = jnp.arange(n, dtype=jnp.int32)
    last_counted = jnp.max(jnp.where(counted, idx, -1)) if n else jnp.int32(-1)
    dsz = jnp.where(counted & (idx != last_counted), sep_n, 0)
    piece = body + dsz
    # one output row: its size is the sum
    sizes = jnp.sum(piece, keepdims=True).astype(jnp.int32)
    validity = jnp.ones(1, jnp.bool_)

    piece_off = jnp.zeros(n + 1, jnp.int32).at[1:].set(_cumsum(piece))
    starts = col.offsets[:-1]

    def produce(rows, k, valid):
        # k is position within the single giant row; the source piece per
        # output byte comes from the piece-offset segment structure
        # (rows-sized scatter + cumsum), not a capacity-sized searchsorted
        from . import segments

        cap_out = k.shape[0]
        pstart = segments.row_start_positions(piece_off, cap_out)
        kk = jnp.arange(cap_out, dtype=jnp.int32) - pstart
        b = segments.broadcast_rows_to_bytes(body, piece_off, cap_out)
        vsrc = segments.broadcast_rows_to_bytes(
            col.validity.astype(jnp.int32), piece_off, cap_out
        ) == 1
        sstart = segments.broadcast_rows_to_bytes(starts, piece_off, cap_out)
        in_body = kk < b
        str_b = jnp.where(
            vsrc,
            layout.gather_bytes(col.data, sstart + jnp.clip(kk, 0, None)),
            nar_a[jnp.clip(kk, 0, max(nar_n - 1, 0))] if nar_n else jnp.uint8(0),
        )
        kd = jnp.clip(kk - b, 0, max(sep_n - 1, 0))
        sep_b = sep_a[kd] if sep_n else jnp.uint8(0)
        return jnp.where(in_body, str_b, sep_b)

    return sizes, validity, produce


_join_op = jit_materialize(_join_body, static_argnums=(3, 4, 5))
