"""Char-level materialization: build columns whose rows are defined as a
sequence of output *characters* (each mapped to a codepoint), handling
UTF-8 width changes vectorized.

This replaces the reference's per-thread char loops in case.cu / translate /
substr-with-step: the array formulation enumerates all output characters of the
column at once, encodes them, and lays out bytes with cumsums.

Execution = three compiled programs + two syncs (char total, byte total),
mirroring the reference's two-pass shape.  `body_fn` must be a MODULE-LEVEL
function (jit cache key) returning (counts, validity, cp_fn) when traced.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from .segments import cumsum as _cumsum

from ..column import StringColumn, cumsum0, row_ids_from_offsets
from ..config import bucket_bytes
from . import layout


def _call_cp_fn(cp_fn, crows, oc, cvalid, c, char_offsets, ccap):
    """Invoke cp_fn with the optional kwargs it accepts (cidx = global
    output char index; bcast = rows->chars broadcast) so bodies can avoid
    capacity-sized gathers."""
    import inspect

    from .segments import broadcast_rows_to_bytes

    params = inspect.signature(cp_fn).parameters
    kw = {}
    if "cidx" in params:
        kw["cidx"] = c
    if "bcast" in params:
        kw["bcast"] = lambda v: broadcast_rows_to_bytes(
            v, char_offsets, ccap
        )
    return cp_fn(crows, oc, cvalid, **kw)


@partial(jax.jit, static_argnums=(1, 2))
def _phase_counts(col, body_fn, static_args, *args):
    counts, validity, _ = body_fn(col, *static_args, *args)
    return jnp.sum(counts.astype(jnp.int32))


def _char_plan(col, body_fn, static_args, ccap, *args):
    from .segments import broadcast_rows_to_bytes

    counts, validity, cp_fn = body_fn(col, *static_args, *args)
    char_offsets = cumsum0(counts)
    c = jnp.arange(ccap, dtype=jnp.int32)
    crows = row_ids_from_offsets(char_offsets, ccap)
    oc = c - broadcast_rows_to_bytes(char_offsets[:-1], char_offsets, ccap)
    cvalid = c < char_offsets[-1]
    cps = _call_cp_fn(cp_fn, crows, oc, cvalid, c, char_offsets, ccap)
    bts, w = layout.encode_codepoints(cps)
    w = jnp.where(cvalid, w, 0)
    cb0 = jnp.zeros(ccap + 1, jnp.int32).at[1:].set(_cumsum(w))
    out_offsets = cb0[jnp.minimum(char_offsets, ccap)]
    return validity, cvalid, bts, w, cb0, out_offsets


@partial(jax.jit, static_argnums=(1, 2, 3))
def _phase_bytes(col, body_fn, static_args, ccap, *args):
    *_, out_offsets = _char_plan(col, body_fn, static_args, ccap, *args)
    return out_offsets[-1]


def _utf8_byte_at(cp: jax.Array, t: jax.Array) -> jax.Array:
    """Byte t (0..3) of cp's UTF-8 encoding, elementwise (garbage when
    t >= width; callers mask).  Mirrors custring_view Char_to_char."""
    cp = cp.astype(jnp.int32)
    w = jnp.select([cp < 0x80, cp < 0x800, cp < 0x10000], [1, 2, 3], 4)
    # shift of the 6-bit group that byte t carries: (w - 1 - t) * 6
    sh = jnp.maximum((w - 1 - t) * 6, 0)
    group = (cp >> sh) & jnp.where(t == 0, 0x7FFFFFFF, 0x3F)
    lead_mask = jnp.select(
        [w == 1, w == 2, w == 3], [0x00, 0xC0, 0xE0], 0xF0
    )
    lead_keep = jnp.select(
        [w == 1, w == 2, w == 3], [0x7F, 0x1F, 0x0F], 0x07
    )
    b0 = lead_mask | (group & lead_keep)
    bt = 0x80 | (group & 0x3F)
    return jnp.where(t == 0, b0, bt).astype(jnp.uint8)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _phase_write(col, body_fn, static_args, ccap, bcap, ascii_out, *args):
    """Byte layout via ONE char-start scatter + cummax + one cps gather
    (instead of four capacity-sized scatters).  ascii_out=True (caller guarantees every
    output codepoint < 128) skips even those: bytes == codepoints."""
    counts, validity, cp_fn = body_fn(col, *static_args, *args)
    char_offsets = cumsum0(counts)
    c = jnp.arange(ccap, dtype=jnp.int32)
    crows = row_ids_from_offsets(char_offsets, ccap)
    from .segments import broadcast_rows_to_bytes, cummax

    oc = c - broadcast_rows_to_bytes(char_offsets[:-1], char_offsets, ccap)
    cvalid = c < char_offsets[-1]
    cps = _call_cp_fn(cp_fn, crows, oc, cvalid, c, char_offsets, ccap)
    if ascii_out:
        # width-1 bytes: base[c] == c, offsets are the char offsets
        data = jnp.where(cvalid, cps, 0).astype(jnp.uint8)
        if bcap <= ccap:
            data = data[:bcap]
        else:
            data = jnp.pad(data, (0, bcap - ccap))
        return data, char_offsets, validity
    _, w = layout.encode_codepoints(cps)
    w = jnp.where(cvalid, w, 0)
    cb0 = jnp.zeros(ccap + 1, jnp.int32).at[1:].set(_cumsum(w))
    out_offsets = cb0[jnp.minimum(char_offsets, ccap)]
    # byte layout = monotone EXPANSION of the codepoints to their byte
    # offsets (ops/shift_compact.py) + a <=3-deep select fill for
    # continuation bytes — in place of the start-mark scatter + cummax +
    # capacity-sized cps gather.
    from .shift_compact import expand_arrays

    dist = cb0[:ccap] - c  # bytes inserted before char c; nondecreasing
    if bcap >= ccap:
        pad = (0, bcap - ccap)
        cps_p = jnp.pad(cps.astype(jnp.int32), pad)
        dist_p = jnp.pad(dist, pad)
        live_p = jnp.pad(cvalid, pad)
    else:
        cps_p = cps.astype(jnp.int32)[:bcap]
        dist_p = dist[:bcap]
        live_p = cvalid[:bcap]
    (cpb,), placed = expand_arrays(live_p, dist_p, [cps_p])

    def sh(a, k):
        out = jnp.roll(a, k)
        return out.at[:k].set(jnp.zeros((), a.dtype))

    p1, m1 = sh(cpb, 1), sh(placed, 1)
    p2, m2 = sh(cpb, 2), sh(placed, 2)
    p3 = sh(cpb, 3)
    cp_q = jnp.where(placed, cpb, jnp.where(m1, p1, jnp.where(m2, p2, p3)))
    t = jnp.where(placed, 0, jnp.where(m1, 1, jnp.where(m2, 2, 3)))
    byte = _utf8_byte_at(cp_q, t)
    q = jnp.arange(bcap, dtype=jnp.int32)
    data = jnp.where(q < out_offsets[-1], byte, jnp.uint8(0))
    return data, out_offsets, validity


def run_charwise(
    body_fn, col: StringColumn, *args, static_args: tuple = (),
    ascii_out: bool | None = None,
) -> StringColumn:
    """Drive a charwise op defined by module-level `body_fn`.

    body_fn(col, *static_args, *args); static_args must be hashable.
    ascii_out: caller's guarantee that every OUTPUT codepoint is < 128
    (e.g. case ops on an ASCII column) — skips the byte-count sync and
    all data-movement scatters.  None = derive from the input column
    (safe only when the op cannot widen codepoints; callers that can
    widen must pass False explicitly).
    """
    if col.size == 0:
        from ..column import empty_column

        return empty_column(0)
    total_chars = int(_phase_counts(col, body_fn, static_args, *args))
    ccap = bucket_bytes(total_chars)
    if ascii_out:
        total_bytes = total_chars
    else:
        total_bytes = int(
            _phase_bytes(col, body_fn, static_args, ccap, *args)
        )
    bcap = bucket_bytes(total_bytes)
    data, out_offsets, validity = _phase_write(
        col, body_fn, static_args, ccap, bcap, bool(ascii_out), *args
    )
    return StringColumn(data, out_offsets, validity)


def build_charwise(
    col: StringColumn,
    out_char_counts: jax.Array,
    cp_fn,
    validity: jax.Array | None = None,
) -> StringColumn:
    """Legacy eager-closure entry point (still used by ops whose plan is
    computed outside; prefer run_charwise for hot paths)."""
    if validity is None:
        validity = col.validity

    def body(c, counts, val):
        return counts, val, cp_fn

    # cannot jit (cp_fn closure); execute phases eagerly
    total_chars = int(jnp.sum(out_char_counts.astype(jnp.int32)))
    ccap = bucket_bytes(total_chars)
    validity2, cvalid, bts, w, cb0, out_offsets = _char_plan(
        col, lambda c, *a: (out_char_counts, validity, cp_fn), (), ccap
    )
    total_bytes = int(out_offsets[-1])
    bcap = bucket_bytes(total_bytes)
    from .segments import cummax

    ccap2 = w.shape[0]
    c = jnp.arange(ccap2, dtype=jnp.int32)
    base = cb0[:-1]
    mark = jnp.full(bcap + 1, -1, jnp.int32).at[
        jnp.where(cvalid, base, bcap)
    ].max(jnp.where(cvalid, c, -1))
    cid = cummax(mark[:bcap])
    q = jnp.arange(bcap, dtype=jnp.int32)
    qstart = cummax(jnp.where(mark[:bcap] >= 0, q, -1))
    t = q - qstart
    # recover codepoints from the encoded byte matrix's first bytes? no —
    # re-derive the byte directly from the per-char byte table
    cps_b = jnp.take_along_axis(
        bts[jnp.clip(cid, 0, ccap2 - 1)],
        jnp.clip(t, 0, 3)[:, None],
        axis=1,
    )[:, 0]
    data = jnp.where(
        (cid >= 0) & (q < out_offsets[-1]), cps_b, jnp.uint8(0)
    )
    return StringColumn(data, out_offsets, validity)


def input_codepoint_gather(col: StringColumn):
    """Helper returning fn(global_char_idx) -> codepoint for `col`."""
    if col.size == 0:
        from ..column import empty_column

        return empty_column(0)
    cps = layout.codepoints(col)

    def get(idx):
        return cps[jnp.clip(idx, 0, cps.shape[0] - 1)]

    return get
