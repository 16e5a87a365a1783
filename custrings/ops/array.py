"""Row rearrangement ops: gather/scatter/sort/order/append.

Array re-design of cpp/src/strings/array.cu: the reference shuffles
custring_view pointers; here row moves are offset arithmetic + one flat byte
gather (materialize).  Sorting variable-length strings uses packed big-endian
uint32 key words with jax.lax.sort's lexicographic multi-operand form instead
of a pointer comparator sort (array.cu:300-330).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..column import StringColumn, build_column, cumsum0
from ..config import bucket_bytes
from . import layout

SORT_LENGTH = 1
SORT_NAME = 2


@partial(jax.jit, static_argnums=(2,))
def _gather_impl(col: StringColumn, idx: jax.Array, capacity: int):
    starts = col.offsets[:-1][idx]
    sizes = (col.offsets[1:] - col.offsets[:-1])[idx]
    validity = col.validity[idx]
    out_offsets = cumsum0(sizes)

    def produce(rows, k, valid, bcast):
        return layout.gather_bytes(col.data, bcast(starts) + k)

    from ..column import materialize_bytes

    data = materialize_bytes(out_offsets, capacity, produce)
    return StringColumn(data, out_offsets, validity)


def gather(col: StringColumn, indexes) -> StringColumn:
    """New column of rows col[indexes[i]] (array.cu gather:73).

    Negative indexes wrap (python/nvstrings.py sublist docs).
    """
    idx = jnp.asarray(indexes, dtype=jnp.int32)
    if idx.shape[0] == 0 or col.size == 0:
        from ..column import empty_column

        return empty_column(int(idx.shape[0]), all_null=col.size == 0)
    idx = jnp.where(idx < 0, idx + col.size, idx)
    # The reference's gather reports out-of-range indexes (array.cu:96-101);
    # JAX clamp semantics would silently return the last row instead.  One
    # fetch covers both the bounds check and the size sync below.
    oob, total = jax.device_get(
        (
            jnp.any((idx < 0) | (idx >= col.size)),
            jnp.sum((col.offsets[1:] - col.offsets[:-1])[idx]),
        )
    )
    if bool(oob):
        raise IndexError(
            f"gather: index out of range for column of {col.size} rows"
        )
    total = int(total)
    return _gather_impl(col, idx, bucket_bytes(total))


def gather_mask(col: StringColumn, mask) -> StringColumn:
    """Boolean-mask gather (array.cu gather:117). Syncs to compact."""
    mask_np = np.asarray(jax.device_get(mask)).astype(bool)
    return gather(col, np.nonzero(mask_np)[0].astype(np.int32))


def append(cols: list[StringColumn]) -> StringColumn:
    """Concatenate columns row-wise (NVStrings::create_from_strings,
    cpp/src/strings/NVStrings.cu:113-135)."""
    datas, offs, vals = [], [], []
    shift = 0
    for c in cols:
        n = c.nbytes()
        datas.append(c.data[:n] if n else c.data[:0])
        offs.append(c.offsets[:-1] + shift if c.size else c.offsets[:0])
        vals.append(c.validity)
        shift += n
    total = shift
    pad = jnp.zeros(bucket_bytes(total) - total, jnp.uint8)
    data = jnp.concatenate(datas + [pad])
    offsets = jnp.concatenate(offs + [jnp.asarray([total], jnp.int32)])
    validity = (
        jnp.concatenate(vals) if vals else jnp.zeros(0, jnp.bool_)
    )
    return StringColumn(data, offsets.astype(jnp.int32), validity)


def scatter(col: StringColumn, strs: StringColumn, indexes) -> StringColumn:
    """Replace rows at `indexes` with rows of `strs` (array.cu scatter:149)."""
    idx = jnp.asarray(indexes, dtype=jnp.int32)
    idx = jnp.where(idx < 0, idx + col.size, idx)
    combined = append([col, strs])
    take = jnp.arange(col.size, dtype=jnp.int32)
    take = take.at[idx].set(col.size + jnp.arange(strs.size, dtype=jnp.int32))
    return gather(combined, take)


def scalar_scatter(col: StringColumn, one: StringColumn, indexes) -> StringColumn:
    """Replace rows at indexes with the single string in `one`
    (array.cu scatter:186)."""
    idx = jnp.asarray(indexes, dtype=jnp.int32)
    combined = append([col, one])
    take = jnp.arange(col.size, dtype=jnp.int32)
    take = take.at[idx].set(col.size)
    return gather(combined, take)


def remove_strings(col: StringColumn, indexes) -> StringColumn:
    """Drop rows at indexes (array.cu remove_strings:244). Host compaction."""
    idx = np.asarray(jax.device_get(jnp.asarray(indexes))).astype(np.int64)
    idx = np.where(idx < 0, idx + col.size, idx)
    keep = np.setdiff1d(np.arange(col.size), idx)
    return gather(col, keep.astype(np.int32))


# ---------------------------------------------------------------------------
# Sorting via packed key words.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(1,))
def _key_words(col: StringColumn, width: int) -> jax.Array:
    """uint32[rows, width//4] big-endian packed bytes; 0-padded.

    Byte-wise unsigned comparison of 0-padded rows == custring_view::compare
    (shorter prefix sorts first), except embedded NULs, which the length
    tie-break key resolves.  Packs the padded byte view with strided lane
    slices (no [n, W//4, 4] repack tensor)."""
    view = layout.padded_view(col, width).astype(jnp.uint32)
    return (
        (view[:, 0::4] << 24)
        | (view[:, 1::4] << 16)
        | (view[:, 2::4] << 8)
        | view[:, 3::4]
    )


def order(
    col: StringColumn,
    stype: int = SORT_NAME,
    asc: bool = True,
    nullfirst: bool = True,
) -> jax.Array:
    """Sorted row indices (array.cu order:330).

    Comparator parity: nulls always grouped by `nullfirst` regardless of
    direction; stype bit 1 = byte-length, bit 2 = name, length first when both.
    """
    if col.size == 0:
        return jnp.zeros((0,), jnp.int32)
    width = layout.max_row_bytes(col)
    width = -(-width // 4) * 4
    return _order_impl(col, width, int(stype), bool(asc), bool(nullfirst))


#: above this (rows, key-columns) size the variadic lexicographic sort is
#: replaced by scan-LSD: the compile cost of an 18-key comparator grows
#: with the key count, while one stable single-key sort compiles once
_LSD_ROWS = 1 << 17


def lsd_order(keys) -> jax.Array:
    """Row order sorting by the uint32 `keys` (most significant first),
    ties kept in row order.  LSD radix over key columns: one stable
    SINGLE-key sort per column (least significant first), compiled once
    via scan.  Equivalent to the variadic lexicographic sort for any key
    count, and the comparator stays trivial no matter how many keys."""
    rows = jnp.arange(keys[0].shape[0], dtype=jnp.int32)
    stacked = jnp.stack(keys[::-1])  # [P, n], least significant first

    def body(perm, krow):
        g = krow[perm]
        _, idx = jax.lax.sort((g, rows), num_keys=1, is_stable=True)
        return perm[idx], None

    perm, _ = jax.lax.scan(body, rows, stacked)
    return perm


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _order_impl(col, width, stype, asc, nullfirst):
    n = col.size
    keys = []
    null_key = col.validity.astype(jnp.uint32)
    keys.append(jnp.where(nullfirst, null_key, 1 - null_key))
    inv = jnp.uint32(0xFFFFFFFF)
    if stype & SORT_LENGTH:
        lk = col.lengths().astype(jnp.uint32)
        keys.append(lk if asc else inv - lk)
    if stype & SORT_NAME:
        words = _key_words(col, width)
        lk = col.lengths().astype(jnp.uint32)
        for i in range(words.shape[1]):
            w = words[:, i]
            keys.append(w if asc else inv ^ w)
        keys.append(lk if asc else inv - lk)
    if n >= _LSD_ROWS and len(keys) > 6:
        return lsd_order(keys)
    rows = jnp.arange(n, dtype=jnp.int32)
    out = jax.lax.sort(tuple(keys) + (rows,), num_keys=len(keys))
    return out[-1]


def sort(col, stype=SORT_NAME, asc=True, nullfirst=True) -> StringColumn:
    return gather(col, order(col, stype, asc, nullfirst))
