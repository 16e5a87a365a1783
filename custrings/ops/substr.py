"""Substring ops: get/slice/slice_from.

Array re-design of cpp/src/strings/substr.cu (get:32, slice:39,
slice_from:85).  Positions are character indexes; step==1 is a pure byte-range
gather, step!=1 goes through the charwise engine.  Reference normalization:
stop<=0 (or None) means end-of-string (substr.cu:55).
"""

from __future__ import annotations

import jax.numpy as jnp

from functools import partial

import jax

from ..column import StringColumn, build_column, jit_materialize
from . import charwise, layout


def _char_window(col: StringColumn, starts, stops, raw: bool = False):
    """Clamp per-row char [start, stop) and return byte positions too.

    raw=False applies the reference's stop<=0 -> end-of-string rule
    (substr.cu:55); raw=True takes stops literally (used by strip).
    """
    cm = layout.char_map(col)
    nch = cm.nchars()
    s = starts.astype(jnp.int32)
    if not raw:
        # reference: negative start casts to huge unsigned and clamps to
        # end-of-string => empty result (substr.cu:55, test_substr.py:12-20)
        s = jnp.where(s < 0, nch, s)
    s = jnp.clip(s, 0, nch)
    e = stops.astype(jnp.int32)
    if not raw:
        e = jnp.where(e <= 0, nch, e)
    e = jnp.clip(e, 0, nch)
    e = jnp.maximum(e, s)
    total_chars = cm.cs0[-1]
    co = cm.char_offsets[:-1]
    cap = col.capacity

    def byte_of(charpos):
        g = co + charpos
        return jnp.where(
            g >= total_chars,
            col.offsets[-1],
            cm.char_pos[jnp.minimum(g, cap - 1)],
        )

    sb = jnp.clip(byte_of(s), col.offsets[:-1], col.offsets[1:])
    eb = jnp.clip(byte_of(e), col.offsets[:-1], col.offsets[1:])
    return cm, s, e, sb, eb


def slice_chars(
    col: StringColumn, start=0, stop=None, step=None
) -> StringColumn:
    step = 1 if step in (None, 0) else int(step)
    n = col.size
    starts = jnp.full(n, int(start or 0), jnp.int32)
    stops = jnp.full(n, -1 if stop is None else int(stop), jnp.int32)
    if step == 1:
        return _slice_bytes(col, starts, stops)
    # stepped: charwise gather of chars start, start+step, ...
    cm, s, e, sb, eb = _char_window(col, starts, stops)
    counts = jnp.maximum(0, -(-(e - s) // step))
    co = cm.char_offsets[:-1]
    cps = layout.codepoints(col)
    ncap = cps.shape[0]

    def cp_fn(rows, oc, valid, bcast):
        g = jnp.clip(bcast(co + s) + oc * step, 0, ncap - 1)
        return cps[g]

    return charwise.build_charwise(col, counts, cp_fn)


def _slice_body(col: StringColumn, starts, stops, raw: bool):
    cm, s, e, sb, eb = _char_window(col, starts, stops, raw)
    sizes = eb - sb

    def produce(rows, k, valid, bcast):
        return layout.gather_bytes(col.data, bcast(sb) + k)

    return sizes, col.validity, produce


_slice_op = jit_materialize(
    _slice_body, static_argnums=(3,), bound_fn=lambda col, *a: col.capacity
)


def _slice_bytes(col: StringColumn, starts, stops, raw: bool = False) -> StringColumn:
    return _slice_op(col, starts, stops, raw)


def slice_from(col: StringColumn, starts=None, stops=None) -> StringColumn:
    """Per-row start/stop char arrays (substr.cu slice_from:85)."""
    n = col.size
    starts = (
        jnp.zeros(n, jnp.int32)
        if starts is None
        else jnp.asarray(starts, jnp.int32)
    )
    stops = (
        jnp.full(n, -1, jnp.int32)
        if stops is None
        else jnp.asarray(stops, jnp.int32)
    )
    return _slice_bytes(col, starts, stops)


def get_char(col: StringColumn, i: int) -> StringColumn:
    """Single char at position i per row (substr.cu get:32)."""
    return slice_chars(col, i, i + 1, 1)
