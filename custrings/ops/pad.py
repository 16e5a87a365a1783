"""Padding ops: repeat/pad/ljust/center/rjust/zfill/wrap.

Array re-design of cpp/src/strings/pad.cu (repeat:31, pad:87, ljust:98,
center:160, rjust:228, zfill:290, wrap:361).  Widths are in characters; the
fill character may be multi-byte.  wrap's sequential greedy line-breaking is a
lax.scan over the padded char matrix (rows stay fully parallel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..column import StringColumn, build_column, jit_materialize
from . import layout


def _repeat_body(col: StringColumn, reps):
    lens = col.lengths()
    sizes = lens * reps
    starts = col.offsets[:-1]

    def produce(rows, k, valid, bcast):
        src = bcast(starts) + k % jnp.maximum(bcast(lens), 1)
        return layout.gather_bytes(col.data, src)

    return sizes, col.validity, produce


_repeat_op = jit_materialize(_repeat_body)


def repeat(col: StringColumn, reps: int) -> StringColumn:
    return _repeat_op(col, jnp.int32(max(int(reps), 1)))


from functools import lru_cache


@lru_cache(maxsize=256)
def _fill_info(fillchar: str | None):
    ch = fillchar if fillchar else " "
    b = ch.encode("utf-8")
    with jax.ensure_compile_time_eval():
        return jnp.asarray(list(b), jnp.uint8), len(b)


def _pad_body(col: StringColumn, width, fill, fb: int, side: str):
    nch = layout.char_counts(col)
    lens = col.lengths()
    pad = jnp.maximum(width - nch, 0)
    if side == "l":
        lpad = jnp.zeros_like(pad)
    elif side == "r":
        lpad = pad
    else:
        lpad = pad // 2
    sizes = lens + pad * fb
    starts = col.offsets[:-1]

    def produce(rows, k, valid, bcast):
        lp = bcast(lpad) * fb
        body = bcast(lens)
        in_body = (k >= lp) & (k < lp + body)
        fill_b = fill[k % fb]
        src = layout.gather_bytes(
            col.data, bcast(starts) + jnp.clip(k - lp, 0, None)
        )
        return jnp.where(in_body, src, fill_b)

    return sizes, col.validity, produce


_pad_op = jit_materialize(_pad_body, static_argnums=(3, 4))


def _pad_impl(col: StringColumn, width: int, fillchar, side: str) -> StringColumn:
    fill, fb = _fill_info(fillchar)
    return _pad_op(col, jnp.int32(width), fill, fb, side)


def ljust(col, width, fillchar=None):
    return _pad_impl(col, width, fillchar, "l")


def rjust(col, width, fillchar=None):
    return _pad_impl(col, width, fillchar, "r")


def center(col, width, fillchar=None):
    return _pad_impl(col, width, fillchar, "c")


def pad(col, width, side="left", fillchar=None):
    if side == "right":
        return ljust(col, width, fillchar)
    if side == "both":
        return center(col, width, fillchar)
    return rjust(col, width, fillchar)


def _zfill_body(col: StringColumn, width):
    lens = col.lengths()
    nch = layout.char_counts(col)
    pad_n = jnp.maximum(width - nch, 0)
    sizes = lens + pad_n
    starts = col.offsets[:-1]
    first = layout.gather_bytes(col.data, starts)
    has_sign = ((first == ord("+")) | (first == ord("-"))) & (lens > 0)

    def produce(rows, k, valid, bcast):
        sign = bcast(has_sign.astype(jnp.int32)) == 1
        p = bcast(pad_n)
        # regions: [0, sign) sign byte, [sign, sign+p) zeros, then rest
        sgn_b = layout.gather_bytes(col.data, bcast(starts))
        in_sign = sign & (k == 0)
        zero_end = jnp.where(sign, 1, 0) + p
        in_zero = (~in_sign) & (k < zero_end)
        src_k = k - p
        src = layout.gather_bytes(col.data, bcast(starts) + jnp.clip(src_k, 0, None))
        return jnp.where(
            in_sign, sgn_b, jnp.where(in_zero, jnp.uint8(ord("0")), src)
        )

    return sizes, col.validity, produce


_zfill_op = jit_materialize(_zfill_body)


def zfill(col: StringColumn, width: int) -> StringColumn:
    """Left-pad with '0' after any leading sign (pad.cu zfill:290)."""
    return _zfill_op(col, jnp.int32(width))


def wrap(col: StringColumn, width: int) -> StringColumn:
    """Greedy line-wrap: whitespace -> ' ', break at last space once a line
    exceeds `width` chars (pad.cu wrap:361).  Size-preserving."""
    if col.size == 0:
        return col
    w = layout.max_row_bytes(col)
    cm = layout.char_map(col)
    cps = layout.codepoints(col)
    ncap = cps.shape[0]
    n = col.size
    max_chars = w  # chars <= bytes
    co = cm.char_offsets[:-1]
    nch = cm.nchars()

    # char matrix [n, max_chars]
    j = jnp.arange(max_chars, dtype=jnp.int32)[None, :]
    g = jnp.clip(co[:, None] + j, 0, ncap - 1)
    cmat = jnp.where(j < nch[:, None], cps[g], -1)
    is_ws = (cmat >= 0) & (cmat <= ord(" "))
    in_row = j < nch[:, None]  # pad.cu wrap loops pos < nchars only

    def step(state, x):
        spos, last_space = state
        pos, ws, alive = x
        last_space = jnp.where(ws, pos, last_space)
        brk = ((pos - spos) >= width) & (last_space >= 0) & alive
        newline_at = jnp.where(brk, last_space, -1)
        spos = jnp.where(brk, last_space, spos)
        last_space = jnp.where(brk, -1, last_space)
        return (spos, last_space), newline_at

    init = (jnp.zeros(n, jnp.int32), jnp.full(n, -1, jnp.int32))
    pos_seq = jnp.arange(max_chars, dtype=jnp.int32)
    _, newline_marks = jax.lax.scan(
        step, init, (pos_seq, is_ws.T, in_row.T)
    )  # [max_chars, n]
    valid_marks = newline_marks >= 0
    rowsb = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[None, :], newline_marks.shape
    )
    nl = jnp.zeros((n, max_chars), jnp.bool_).at[
        rowsb.ravel(), jnp.clip(newline_marks, 0, max_chars - 1).ravel()
    ].max(valid_marks.ravel())

    out_cmat = jnp.where(is_ws, ord(" "), cmat)
    out_cmat = jnp.where(nl, ord("\n"), out_cmat)

    from . import charwise

    def cp_fn(rows, oc, valid):
        return out_cmat[rows, jnp.clip(oc, 0, max_chars - 1)]

    return charwise.build_charwise(col, nch, cp_fn)
