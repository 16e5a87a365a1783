"""String dictionary-encoding: the nvcategory core.

Array re-design of cpp/src/category/NVCategory.cu: a Category is
(keys: sorted-unique StringColumn, values: int32[rows]).  The build is the
sort/neq/scan/scatter pipeline in ops/unique.py (NVCategory.cu:220-304);
keyset algebra (add/remove/set/merge keys) is expressed as key-table set
operations via lexicographic searchsorted + gathers instead of the
reference's pointer stable-sort merges (NVCategory.cu:1223-1770).

Convention: value -1 marks a row whose key was removed (remove_keys);
to_strings maps -1 to null.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .column import StringColumn, empty_column, from_host_strings
from .ops import array as array_ops
from .ops.unique import dictionary_encode, searchsorted_keys, unique_strings


@dataclasses.dataclass(frozen=True)
class Category:
    keys: StringColumn
    values: jax.Array  # int32[rows]; -1 = unmapped
    # merge_category appends new keys AFTER the existing keyset
    # (NVCategory.cu:1223), so a keyset can be unsorted; lookups then go
    # through a sort permutation (the reference's get_value is a linear
    # scan, NVCategory.cu:766-793, so it never cared)
    sorted_keys: bool = True

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    @property
    def keys_size(self) -> int:
        return self.keys.size


def _lookup(keys: StringColumn, queries: StringColumn, keys_sorted: bool):
    """Index of each query in `keys` (-1 absent), ANY keyset order."""
    if keys_sorted:
        return searchsorted_keys(keys, queries)
    from .ops import layout

    width = max(-(-layout.max_row_bytes(keys) // 4) * 4, 4)
    order = array_ops._order_impl(
        keys, width, array_ops.SORT_NAME, True, True
    )
    skeys = array_ops.gather(keys, order)
    pos = searchsorted_keys(skeys, queries)
    order_j = jnp.asarray(order)
    return jnp.where(
        pos >= 0, order_j[jnp.clip(pos, 0, max(keys.size - 1, 0))], -1
    )


def from_strings(*cols: StringColumn) -> Category:
    col = cols[0] if len(cols) == 1 else array_ops.append(list(cols))
    keys, values = dictionary_encode(col)
    return Category(keys, values)


def from_value_array(keys: StringColumn, values) -> Category:
    return Category(keys, jnp.asarray(values, jnp.int32))


def to_strings(cat: Category) -> StringColumn:
    """Gather keys by value (NVCategory.cu to_strings:977); -1 -> null."""
    idx = jnp.clip(cat.values, 0, max(cat.keys_size - 1, 0))
    out = array_ops.gather(cat.keys, idx)
    valid = out.validity & (cat.values >= 0)
    from .ops.split import _mask_column

    return _mask_column(out, valid)


def gather_strings(cat: Category, indexes) -> StringColumn:
    idx = np.asarray(indexes)
    if idx.size and (idx.min() < 0 or idx.max() >= cat.keys_size):
        raise IndexError("gather_strings: index out of range")
    return array_ops.gather(cat.keys, jnp.asarray(idx, jnp.int32))


def gather(cat: Category, indexes) -> Category:
    """New category, same keyset, values = indexes (NVCategory.cu:1142)."""
    idx = np.asarray(indexes)
    if idx.size and (idx.min() < 0 or idx.max() >= cat.keys_size):
        raise IndexError("gather: index out of range")
    return Category(cat.keys, jnp.asarray(idx, jnp.int32), cat.sorted_keys)


def gather_and_remap(cat: Category, indexes) -> Category:
    """Gather then drop unused keys (NVCategory.cu gather_and_remap:1084)."""
    return remove_unused_keys(gather(cat, indexes))


def value_for_index(cat: Category, idx: int) -> int:
    return int(cat.values[idx])


def value_of(cat: Category, key: str | None) -> int:
    """Index of key in the keyset, -1 if absent (NVCategory.cu:766)."""
    q = from_host_strings([key])
    return int(_lookup(cat.keys, q, cat.sorted_keys)[0])


def get_value_bounds(cat: Category, key: str | None) -> tuple[int, int]:
    """(lower, upper) bound positions for merge planning
    (NVCategory.cu get_value_bounds:795): (v, v) when present, else the
    insertion gap (pos-1, pos) in the sorted keyset."""
    v = value_of(cat, key)
    if v >= 0:
        return (v, v)
    # device lower-bound over the packed key words (VERDICT r2 item 7 —
    # previously a host walk over to_host_strings; ref NVCategory.cu:795)
    from .ops.unique import first_not_less

    q = from_host_strings([key])
    pos = int(first_not_less(cat.keys, q))
    return (pos - 1, pos)


def indexes_for_key(cat: Category, key: str | None) -> jax.Array:
    v = value_of(cat, key)
    if v < 0:
        # Absent key: -1 would collide with the removed-key sentinel in
        # cat.values and return every unmapped row instead of none.
        return jnp.zeros(0, jnp.int32)
    idx = np.nonzero(np.asarray(jax.device_get(cat.values)) == v)[0]
    return jnp.asarray(idx, jnp.int32)


def add_strings(cat: Category, strs: StringColumn) -> Category:
    """Append rows and rebuild (NVCategory.cu add_strings:926)."""
    return from_strings(array_ops.append([to_strings(cat), strs]))


def remove_strings(cat: Category, strs: StringColumn) -> Category:
    """Drop rows equal to any of strs, rebuild (NVCategory.cu:942)."""
    rows = to_strings(cat)
    hit = searchsorted_keys(unique_strings(strs), rows) >= 0
    keep = np.nonzero(~np.asarray(jax.device_get(hit)))[0]
    return from_strings(array_ops.gather(rows, jnp.asarray(keep, jnp.int32)))


def _remap_values(
    cat: Category, new_keys: StringColumn, new_sorted: bool = True
) -> jax.Array:
    """values under a new keyset: old value -> old key -> new index/-1."""
    old_to_new = _lookup(new_keys, cat.keys, new_sorted)  # int32[K_old]
    safe = jnp.clip(cat.values, 0, max(cat.keys_size - 1, 0))
    remapped = old_to_new[safe]
    return jnp.where(cat.values >= 0, remapped, -1)


def add_keys(cat: Category, keys: StringColumn) -> Category:
    """(NVCategory.cu add_keys_and_remap:1375)"""
    new_keys = unique_strings(array_ops.append([cat.keys, keys]))
    return Category(new_keys, _remap_values(cat, new_keys))


def remove_keys(cat: Category, keys: StringColumn) -> Category:
    """(NVCategory.cu remove_keys_and_remap:1482); unmapped rows -> -1."""
    drop = searchsorted_keys(unique_strings(keys), cat.keys) >= 0
    keep = np.nonzero(~np.asarray(jax.device_get(drop)))[0]
    new_keys = array_ops.gather(cat.keys, jnp.asarray(keep, jnp.int32))
    return Category(
        new_keys,
        _remap_values(cat, new_keys, cat.sorted_keys),
        cat.sorted_keys,
    )


def remove_unused_keys(cat: Category) -> Category:
    """(NVCategory.cu remove_unused_keys_and_remap:1567)"""
    used = np.zeros(cat.keys_size, bool)
    vals = np.asarray(jax.device_get(cat.values))
    used[vals[vals >= 0]] = True
    keep = np.nonzero(used)[0]
    new_keys = array_ops.gather(cat.keys, jnp.asarray(keep, jnp.int32))
    return Category(
        new_keys,
        _remap_values(cat, new_keys, cat.sorted_keys),
        cat.sorted_keys,
    )


def set_keys(cat: Category, keys: StringColumn) -> Category:
    """(NVCategory.cu set_keys_and_remap:1708)"""
    new_keys = unique_strings(keys)
    return Category(new_keys, _remap_values(cat, new_keys))


def merge_and_remap(cat: Category, other: Category) -> Category:
    """Full re-sorted union of keysets (NVCategory.cu merge_and_remap:1339)."""
    new_keys = unique_strings(array_ops.append([cat.keys, other.keys]))
    v1 = _remap_values(cat, new_keys)
    v2 = _remap_values(other, new_keys)
    return Category(new_keys, jnp.concatenate([v1, v2]))


def merge_category(cat: Category, other: Category) -> Category:
    """Append-preserving merge (NVCategory.cu merge_category:1223): this
    keyset keeps its positions; other's new keys are appended (sorted among
    themselves) => keyset possibly unsorted overall."""
    in1 = _lookup(cat.keys, other.keys, cat.sorted_keys)
    in1_np = np.asarray(jax.device_get(in1))
    new_mask = in1_np < 0
    new_idx = np.nonzero(new_mask)[0]
    appended = array_ops.gather(other.keys, jnp.asarray(new_idx, jnp.int32))
    new_keys = array_ops.append([cat.keys, appended])
    # other key -> final index
    final = np.where(
        new_mask, cat.keys_size + np.cumsum(new_mask) - 1, in1_np
    ).astype(np.int32)
    o_vals = np.asarray(jax.device_get(other.values))
    safe = np.clip(o_vals, 0, max(other.keys_size - 1, 0))
    v2 = np.where(o_vals >= 0, final[safe], -1)
    return Category(
        new_keys,
        jnp.concatenate([cat.values, jnp.asarray(v2, jnp.int32)]),
        sorted_keys=cat.sorted_keys and len(new_idx) == 0,
    )
