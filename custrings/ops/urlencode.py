"""URL percent-encoding ops.

Array re-design of cpp/src/strings/urlencode.cu (url_encode:130,
url_decode:243).  Unreserved set is [0-9A-Za-z._~-] (urlencode.cu:80-85);
every other byte (including each byte of multi-byte UTF-8 chars) becomes
%XX with uppercase hex.  Decode converts '%' + 2 bytes whenever 2 bytes
remain in the row, like the reference.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from .segments import cumsum as _cumsum

from ..column import StringColumn, cumsum0
from ..config import bucket_bytes
from . import layout


def _unreserved(b):
    return (
        ((b >= ord("0")) & (b <= ord("9")))
        | ((b >= ord("A")) & (b <= ord("Z")))
        | ((b >= ord("a")) & (b <= ord("z")))
        | (b == ord("."))
        | (b == ord("_"))
        | (b == ord("~"))
        | (b == ord("-"))
    )


def _hex_char(v):
    return jnp.where(v < 10, ord("0") + v, ord("A") + v - 10).astype(jnp.uint8)


def _encode_plan(col: StringColumn):
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    rows = layout.row_ids_from_offsets(col.offsets, cap)
    real = layout.valid_byte_mask(col)
    b = col.data.astype(jnp.int32)
    # a byte is kept verbatim iff it's an ASCII unreserved char; every other
    # byte (incl. continuation bytes) expands to %XX
    keep = _unreserved(b) & real
    w = jnp.where(real, jnp.where(keep, 1, 3), 0).astype(jnp.int32)
    # output offsets at byte granularity
    ob0 = jnp.zeros(cap + 1, jnp.int32).at[1:].set(_cumsum(w))
    out_offsets = ob0[col.offsets]
    return real, keep, b, w, ob0, out_offsets


_encode_plan_j = jax.jit(_encode_plan)


@partial(jax.jit, static_argnums=(1,))
def _encode_write(col: StringColumn, bcap: int):
    """One input-start scatter + cummax fill (in place of three
    capacity-sized scatters)."""
    from .segments import cummax

    real, keep, b, w, ob0, out_offsets = _encode_plan(col)
    cap = col.capacity
    c = jnp.arange(cap, dtype=jnp.int32)
    mark = jnp.full(bcap + 1, -1, jnp.int32).at[
        jnp.where(real, ob0[:-1], bcap)
    ].max(jnp.where(real, c, -1))
    src = cummax(mark[:bcap])
    q = jnp.arange(bcap, dtype=jnp.int32)
    qstart = cummax(jnp.where(mark[:bcap] >= 0, q, -1))
    t = q - qstart
    safe = jnp.clip(src, 0, max(cap - 1, 0))
    b_q = col.data[safe].astype(jnp.int32)
    keep_q = keep[safe]
    byte = jnp.where(
        t == 0,
        jnp.where(keep_q, col.data[safe], jnp.uint8(ord("%"))),
        jnp.where(
            t == 1, _hex_char(b_q >> 4), _hex_char(b_q & 0xF)
        ).astype(jnp.uint8),
    )
    data = jnp.where(
        (src >= 0) & (q < out_offsets[-1]), byte, jnp.uint8(0)
    )
    return data, out_offsets


def url_encode(col: StringColumn) -> StringColumn:
    out_offsets = _encode_plan_j(col)[-1]
    bcap = bucket_bytes(int(out_offsets[-1]))
    data, out_offsets = _encode_write(col, bcap)
    return StringColumn(data, out_offsets, col.validity)


def _hex_val(c):
    return jnp.where(
        (c >= ord("0")) & (c <= ord("9")),
        c - ord("0"),
        jnp.where(
            (c >= ord("A")) & (c <= ord("F")),
            c - ord("A") + 10,
            jnp.where(
                (c >= ord("a")) & (c <= ord("f")), c - ord("a") + 10, 0
            ),
        ),
    )


def _decode_plan(col: StringColumn):
    cap = col.capacity
    j = jnp.arange(cap, dtype=jnp.int32)
    rows = layout.row_ids_from_offsets(col.offsets, cap)
    real = layout.valid_byte_mask(col)
    row_end = col.offsets[1:][rows]
    b = col.data.astype(jnp.int32)
    b1 = jnp.roll(b, -1)
    b2 = jnp.roll(b, -2)
    is_pct = (b == ord("%")) & (j + 2 < row_end) & real
    # bytes consumed by a % escape: mark the two following bytes as skipped.
    # A byte is skipped if byte j-1 or j-2 starts an escape; escapes cannot
    # overlap ('%' inside an escape is consumed), so resolve left-to-right:
    # since escape start requires the byte itself not be part of a previous
    # escape, run the small associative scan on state {0,1,2} (bytes left).
    m = 3
    import jax

    dom = jnp.arange(m, dtype=jnp.int32)

    def trans(pj):
        dec = jnp.maximum(dom - 1, 0)
        return jnp.where((dom == 0) & pj, 2, dec)

    T = jax.vmap(trans)(is_pct)

    def compose(a, bb):
        return jnp.take_along_axis(bb, a, axis=1)

    from .segments import compose_scan

    comp = compose_scan(T)  # comp[j] = T_j o ... o T_0
    s_in = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), comp[:-1, 0].astype(jnp.int32)]
    )
    start = is_pct & (s_in == 0)
    inside = (s_in > 0) | start  # every byte belonging to an escape
    skipped = inside & ~start
    emit = real & ~skipped
    out_b = jnp.where(
        start, (_hex_val(b1) * 16 + _hex_val(b2)).astype(jnp.uint8), col.data
    )
    w = emit.astype(jnp.int32)
    ob0 = jnp.zeros(cap + 1, jnp.int32).at[1:].set(_cumsum(w))
    out_offsets = ob0[col.offsets]
    return emit, out_b, ob0, out_offsets


_decode_plan_j = jax.jit(_decode_plan)


@partial(jax.jit, static_argnums=(1,))
def _decode_write(col: StringColumn, bcap: int):
    emit, out_b, ob0, out_offsets = _decode_plan(col)
    data = jnp.zeros(bcap + 1, jnp.uint8)
    idx = jnp.where(emit, ob0[:-1], bcap)
    data = data.at[idx].set(jnp.where(emit, out_b, jnp.uint8(0)))
    return data[:bcap], out_offsets


def url_decode(col: StringColumn) -> StringColumn:
    if col.size == 0:
        return col
    out_offsets = _decode_plan_j(col)[-1]
    bcap = bucket_bytes(int(out_offsets[-1]))
    data, out_offsets = _decode_write(col, bcap)
    return StringColumn(data, out_offsets, col.validity)
