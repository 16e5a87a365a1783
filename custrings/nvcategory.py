"""Public nvcategory API — mirrors the reference python/nvcategory.py."""

from __future__ import annotations

import jax
import numpy as np

from . import category as _cat
from . import column as _col
from . import numeric as _num
from .nvstrings import nvstrings


class nvcategory:
    def __init__(self, cat: _cat.Category):
        self._cat = cat

    def __repr__(self):
        return "<custrings.nvcategory keys={} size={}>".format(
            self.keys_size(), self.size()
        )

    def size(self):
        return self._cat.size

    def keys_size(self):
        return self._cat.keys_size

    def keys(self, narr=None):
        return nvstrings(self._cat.keys)

    def keys_type(self):
        return "str"

    def get_cpointer(self):
        """Reference C++ instance pointer (NVCategory.h) — compat stub."""
        return 0

    def values_cpointer(self):
        """Reference device values pointer — compat stub; use values()."""
        return 0

    def has_nulls(self):
        """True when the keyset contains the null key (NVCategory.h)."""
        import jax as _jax

        return bool((~np.asarray(_jax.device_get(self._cat.keys.validity))).any())

    def indexes_for_key(self, key, devptr=0):
        idx = np.asarray(jax.device_get(_cat.indexes_for_key(self._cat, key)))
        if isinstance(devptr, np.ndarray):
            devptr[: len(idx)] = idx
            return len(idx)
        return idx.tolist()

    def value_for_index(self, idx):
        return _cat.value_for_index(self._cat, idx)

    def value(self, str):
        return _cat.value_of(self._cat, str)

    def get_value_bounds(self, str):
        return _cat.get_value_bounds(self._cat, str)

    def values(self, devptr=0):
        out = np.asarray(jax.device_get(self._cat.values))
        if isinstance(devptr, np.ndarray):
            devptr[: len(out)] = out
            return devptr
        return out.tolist()

    def add_strings(self, nvs):
        return nvcategory(_cat.add_strings(self._cat, nvs._col))

    def remove_strings(self, nvs):
        return nvcategory(_cat.remove_strings(self._cat, nvs._col))

    def to_strings(self):
        return nvstrings(_cat.to_strings(self._cat))

    def gather_strings(self, indexes, count=0):
        return nvstrings(_cat.gather_strings(self._cat, indexes))

    def gather_and_remap(self, indexes, count=0):
        return nvcategory(_cat.gather_and_remap(self._cat, indexes))

    def gather(self, indexes, count=0):
        return nvcategory(_cat.gather(self._cat, indexes))

    def merge_category(self, cat2):
        return nvcategory(_cat.merge_category(self._cat, cat2._cat))

    def merge_and_remap(self, cat2):
        return nvcategory(_cat.merge_and_remap(self._cat, cat2._cat))

    def add_keys(self, keys, nulls=None):
        k = keys._col if isinstance(keys, nvstrings) else _col.from_host_strings(keys)
        return nvcategory(_cat.add_keys(self._cat, k))

    def remove_keys(self, keys, nulls=None):
        k = keys._col if isinstance(keys, nvstrings) else _col.from_host_strings(keys)
        return nvcategory(_cat.remove_keys(self._cat, k))

    def remove_unused_keys(self):
        return nvcategory(_cat.remove_unused_keys(self._cat))

    def set_keys(self, keys, nulls=None):
        k = keys._col if isinstance(keys, nvstrings) else _col.from_host_strings(keys)
        return nvcategory(_cat.set_keys(self._cat, k))


class numeric_category:
    """Numeric flavor (python numeric categories are a separate class in
    the reference binding, python/nvcategory.py from_numbers:131)."""

    def __init__(self, cat: _num.NumericCategory):
        self._cat = cat

    def size(self):
        return int(self._cat.values.shape[0])

    def keys_size(self):
        return int(self._cat.keys.shape[0])

    def keys(self, narr=None):
        out = np.asarray(jax.device_get(self._cat.keys))
        if isinstance(narr, np.ndarray):
            narr[: len(out)] = out
            return narr
        return out.tolist()

    def keys_type(self):
        return str(np.asarray(self._cat.keys).dtype)

    def values(self, devptr=0):
        out = np.asarray(jax.device_get(self._cat.values))
        if isinstance(devptr, np.ndarray):
            devptr[: len(out)] = out
            return devptr
        return out.tolist()

    def value_for_index(self, idx):
        return int(self._cat.values[idx])

    def value(self, key):
        return _num.value_of(self._cat, key)

    def indexes_for_key(self, key, idxs=None):
        out = np.asarray(jax.device_get(_num.indexes_for_key(self._cat, key)))
        if isinstance(idxs, np.ndarray):
            idxs[: len(out)] = out
        return len(out) if idxs is None or isinstance(idxs, np.ndarray) else out

    def to_numbers(self, narr=None, nulls=None):
        out = np.asarray(jax.device_get(_num.to_numbers(self._cat)))
        if isinstance(narr, np.ndarray):
            narr[: len(out)] = out
            return narr
        return out.tolist()

    def gather_numbers(self, indexes, narr=None, nulls=None):
        out = np.asarray(
            jax.device_get(_num.gather_numbers(self._cat, indexes))
        )
        if isinstance(narr, np.ndarray):
            narr[: len(out)] = out
            return narr
        return out.tolist()

    def add_keys(self, keys, nulls=None):
        return numeric_category(_num.add_keys(self._cat, keys, nulls))

    def remove_keys(self, keys, nulls=None):
        return numeric_category(_num.remove_keys(self._cat, keys, nulls))

    def remove_unused_keys(self):
        return numeric_category(_num.remove_unused_keys(self._cat))

    def set_keys(self, keys, nulls=None):
        return numeric_category(_num.set_keys(self._cat, keys, nulls))

    def gather(self, indexes, count=0):
        return numeric_category(_num.gather(self._cat, indexes))

    def gather_and_remap(self, indexes, count=0):
        return numeric_category(_num.gather_and_remap(self._cat, indexes))

    def merge_category(self, cat2):
        return numeric_category(_num.merge_category(self._cat, cat2._cat))

    def merge_and_remap(self, cat2):
        return numeric_category(_num.merge_and_remap(self._cat, cat2._cat))


# ---------------- module-level constructors ----------------


def to_device(strs):
    return from_strings_list([strs]) if strs and isinstance(strs[0], list) else nvcategory(
        _cat.from_strings(_col.from_host_strings(strs))
    )


def from_strings(*args):
    cols = [a._col for a in args]
    return nvcategory(_cat.from_strings(*cols))


def from_strings_list(list_):
    cols = [
        a._col if isinstance(a, nvstrings) else _col.from_host_strings(a)
        for a in list_
    ]
    return nvcategory(_cat.from_strings(*cols))


def from_offsets(sbuf, obuf, scount, nbuf=None, ncount=0, bdevmem=False):
    col = _col.from_offsets_np(sbuf, obuf, scount, nbuf)
    return nvcategory(_cat.from_strings(col))


def from_numbers(narr, nulls=None):
    arr = np.asarray(narr)
    if nulls is not None:
        bits = np.unpackbits(
            np.asarray(nulls).view(np.uint8).ravel(), bitorder="little"
        )[: len(arr)]
        isnull = ~bits.astype(bool)
    else:
        isnull = None
    return numeric_category(_num.from_numbers(arr, isnull))


def bind_cpointer(cptr, own=True):  # pragma: no cover
    raise NotImplementedError("raw device pointers are not exposed")
