"""Strip ops: lstrip/strip/rstrip.

Array re-design of cpp/src/strings/strip.cu (lstrip:30, strip:87,
rstrip:144).  Default strip set is " \\n\\t" exactly as the reference
(custring_view::lstrip, custring_view.inl).  Leading/trailing run lengths are
computed with segment min/max over the "first/last non-member char" instead of
per-thread loops, then rows are byte-sliced.
"""

from __future__ import annotations

import jax.numpy as jnp
from .segments import cumsum as _cumsum

from functools import partial

import jax
import numpy as np

from ..column import StringColumn, build_column
from . import layout, substr

_BIG = np.int32(2**30)  # np: a module-level jnp constant would init the backend at import


def _member_mask(col: StringColumn, to_strip: str | None):
    chars = to_strip if to_strip is not None else " \n\t"
    cps = layout.codepoints(col)
    m = jnp.zeros(cps.shape[0], jnp.bool_)
    for ch in set(chars):
        m = m | (cps == ord(ch))
    return m


def _strip_impl(col: StringColumn, to_strip, left: bool, right: bool):
    if col.size == 0:
        return col
    starts, stops = _strip_window(col, to_strip, left, right)
    return substr._slice_bytes(col, starts, stops, raw=True)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _strip_window(col: StringColumn, to_strip, left: bool, right: bool):
    cm = layout.char_map(col)
    nch = cm.nchars()
    member = _member_mask(col, to_strip)
    ncap = member.shape[0]
    c = jnp.arange(ncap, dtype=jnp.int32)
    cvalid = c < cm.cs0[-1]
    non = (~member) & cvalid
    n = col.size
    # first/last non-member char per row via prefix-count binary search
    # (instead of a capacity-sized segment min/max scatter)
    nonc = _cumsum(non.astype(jnp.int32))
    nonc0 = jnp.concatenate([jnp.zeros(1, jnp.int32), nonc])
    t0 = nonc0[cm.char_offsets[:-1]]
    t1 = nonc0[cm.char_offsets[1:]]
    has = t1 > t0
    co = cm.char_offsets[:-1]
    cfirst = jnp.clip(
        jnp.searchsorted(nonc, t0 + 1, side="left").astype(jnp.int32),
        0,
        max(ncap - 1, 0),
    )
    clast = jnp.clip(
        jnp.searchsorted(nonc, t1, side="left").astype(jnp.int32),
        0,
        max(ncap - 1, 0),
    )
    first_non = jnp.where(has, cfirst - co, nch)
    last_non = jnp.where(has, clast - co, -1)
    starts = first_non if left else jnp.zeros(n, jnp.int32)
    stops = (last_non + 1) if right else nch
    # all-member rows: empty result
    stops = jnp.maximum(stops, starts)
    return starts, stops


def lstrip(col: StringColumn, to_strip=None) -> StringColumn:
    return _strip_impl(col, to_strip, True, False)


def rstrip(col: StringColumn, to_strip=None) -> StringColumn:
    return _strip_impl(col, to_strip, False, True)


def strip(col: StringColumn, to_strip=None) -> StringColumn:
    return _strip_impl(col, to_strip, True, True)
