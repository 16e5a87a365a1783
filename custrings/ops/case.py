"""Case-mapping ops: lower/upper/swapcase/capitalize/title.

Array re-design of cpp/src/strings/case.cu (lower:31, upper:100,
swapcase:169, capitalize:238, title:314): all chars of the column map through
the opposite-case table at once; position-dependent rules (first char, word
boundaries) come from shifted masks instead of per-thread sequential state.
UTF-8 widths may change, so output is built with the charwise engine.
Only BMP codepoints are mapped (reference's 16-bit table limitation,
docs/source/unicode.md).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..column import StringColumn
from ..unicode.tables import FLAG_ALPHA, FLAG_LOWER, FLAG_UPPER, device_tables
from . import charwise, layout


def _mapped(cps, want_flag):
    """Map codepoints having want_flag through the case table."""
    flags, cases = device_tables()
    safe = jnp.clip(cps, 0, flags.shape[0] - 1)
    fl = flags[safe].astype(jnp.int32)
    bmp = cps < flags.shape[0]
    hit = bmp & ((fl & want_flag) > 0)
    return jnp.where(hit, cases[safe], cps), fl


def _case_op(col: StringColumn, kind: str) -> StringColumn:
    # ASCII input => ASCII output for every case mapping (the Unicode
    # special casings that widen never start from ASCII codepoints)
    return charwise.run_charwise(
        _case_body, col, static_args=(kind,),
        ascii_out=layout.is_ascii(col),
    )


def _case_body(col: StringColumn, kind: str):
    cm = layout.char_map(col)
    in_cps = layout.codepoints(col)
    flags, cases = device_tables()
    safe = jnp.clip(in_cps, 0, flags.shape[0] - 1)
    fl = jnp.where(in_cps < flags.shape[0], flags[safe], 0).astype(jnp.int32)
    is_up = (fl & FLAG_UPPER) > 0
    is_lo = (fl & FLAG_LOWER) > 0
    is_al = (fl & FLAG_ALPHA) > 0
    swapped = jnp.where(
        (is_up | is_lo) & (in_cps < flags.shape[0]), cases[safe], in_cps
    )

    ncap = in_cps.shape[0]
    # char-position context (global char enumeration)
    gidx = jnp.arange(ncap, dtype=jnp.int32)
    row_start_of_char = jnp.zeros(ncap + 1, jnp.bool_).at[
        jnp.minimum(cm.char_offsets[:-1], ncap)
    ].set(True)[:ncap]
    prev_alpha = jnp.roll(is_al, 1).at[0].set(False)
    # first char of its row, or previous char (same row) non-alpha
    word_start = row_start_of_char | ~prev_alpha

    if kind == "lower":
        out = jnp.where(is_up, swapped, in_cps)
    elif kind == "upper":
        out = jnp.where(is_lo, swapped, in_cps)
    elif kind == "swapcase":
        out = swapped
    elif kind == "capitalize":
        first = row_start_of_char
        out = jnp.where(
            first & is_lo, swapped, jnp.where(~first & is_up, swapped, in_cps)
        )
    elif kind == "title":
        out = jnp.where(
            is_al & word_start & is_lo,
            swapped,
            jnp.where(is_al & ~word_start & is_up, swapped, in_cps),
        )
    else:  # pragma: no cover
        raise ValueError(kind)

    def cp_fn(rows, oc, valid, cidx):
        # counts == input nchars, so output char c IS input char c:
        # a plain slice/pad, no capacity-sized gather
        cc = cidx.shape[0]
        if cc <= ncap:
            return out[:cc]
        return jnp.pad(out, (0, cc - ncap))

    return cm.nchars(), col.validity, cp_fn


def lower(col):
    return _case_op(col, "lower")


def upper(col):
    return _case_op(col, "upper")


def swapcase(col):
    return _case_op(col, "swapcase")


def capitalize(col):
    return _case_op(col, "capitalize")


def title(col):
    return _case_op(col, "title")
