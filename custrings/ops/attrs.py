"""Row attribute ops: lengths and character-class predicates.

Array re-design of cpp/src/strings/attrs.cu (len:32, byte_count:72,
isalnum:115 ... is_empty:412): instead of one CUDA thread per string walking
its chars, we classify every character of the column at once via the flag
table and reduce per row with segment operations.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from .segments import cumsum as _cumsum

from ..column import StringColumn
from ..unicode.tables import (
    FLAG_ALPHA,
    FLAG_ALPHANUM,
    FLAG_DECIMAL,
    FLAG_DIGIT,
    FLAG_LOWER,
    FLAG_NUMERIC,
    FLAG_SPACE,
    FLAG_UPPER,
    device_tables,
)
from . import layout


@jax.jit
def len_chars(col: StringColumn) -> jax.Array:
    """Character count per row; -1 for nulls (python/nvstrings.py:538)."""
    n = layout.char_counts(col)
    return jnp.where(col.validity, n, -1)


@jax.jit
def byte_count(col: StringColumn) -> jax.Array:
    """Byte count per row; -1 for nulls (python/nvstrings.py:567)."""
    return jnp.where(col.validity, col.lengths(), -1)


def _char_flags(col: StringColumn) -> jax.Array:
    """uint8[capacity]: unicode flags of the c-th char (garbage past total)."""
    flags, _ = device_tables()
    cp = layout.codepoints(col)
    return flags[jnp.clip(cp, 0, flags.shape[0] - 1)]


@partial(jax.jit, static_argnums=(1,))
def _all_chars_match(col: StringColumn, flag_mask: int) -> jax.Array:
    """bool[rows]: non-empty and every char has one of flag_mask set.

    Matches attrs.cu semantics: empty or null rows -> False.
    """
    cm = layout.char_map(col)
    fl = _char_flags(col)
    ok = (fl.astype(jnp.int32) & flag_mask) > 0
    # Segment-and over chars of each row: count matching chars == nchars.
    cnt0 = jnp.zeros(fl.shape[0] + 1, jnp.int32).at[1:].set(
        _cumsum(ok.astype(jnp.int32))
    )
    per_row = cnt0[cm.char_offsets[1:]] - cnt0[cm.char_offsets[:-1]]
    nch = cm.nchars()
    return (nch > 0) & (per_row == nch) & col.validity


def isalnum(col):
    return _all_chars_match(col, FLAG_ALPHANUM)


def isalpha(col):
    return _all_chars_match(col, FLAG_ALPHA)


def isdigit(col):
    return _all_chars_match(col, FLAG_DIGIT)


def isspace(col):
    return _all_chars_match(col, FLAG_SPACE)


def isdecimal(col):
    return _all_chars_match(col, FLAG_DECIMAL)


def isnumeric(col):
    return _all_chars_match(col, FLAG_NUMERIC)


def islower(col: StringColumn) -> jax.Array:
    """Non-empty and every alpha char is lower-case: the reference accepts
    non-alpha chars (`!IS_ALPHA(flg) || IS_LOWER(flg)`, attrs.cu islower)."""
    return _case_predicate(col, want_upper=False)


def isupper(col: StringColumn) -> jax.Array:
    return _case_predicate(col, want_upper=True)


@partial(jax.jit, static_argnums=(1,))
def _case_predicate(col: StringColumn, want_upper: bool) -> jax.Array:
    cm = layout.char_map(col)
    fl = _char_flags(col).astype(jnp.int32)
    alpha = (fl & FLAG_ALPHA) > 0
    good_flag = FLAG_UPPER if want_upper else FLAG_LOWER
    bad = alpha & ((fl & good_flag) == 0)
    bad0 = jnp.zeros(fl.shape[0] + 1, jnp.int32).at[1:].set(
        _cumsum(bad.astype(jnp.int32))
    )
    bad_per_row = bad0[cm.char_offsets[1:]] - bad0[cm.char_offsets[:-1]]
    nch = cm.nchars()
    return (nch > 0) & (bad_per_row == 0) & col.validity


@jax.jit
def is_empty(col: StringColumn) -> jax.Array:
    """True for null or zero-length rows (attrs.cu is_empty:412: null->true)."""
    return (~col.validity) | (col.lengths() == 0)
