"""Public nvstrings API — mirrors the reference python/nvstrings.py surface.

Same module-level constructors and ~95 instance methods with identical
signatures/semantics, so reference user code ports directly.  Each method
delegates to the functional column ops; results wrap back into `nvstrings`.
Ops returning per-row numbers accept the reference's optional `devptr`
argument but return arrays (there is no raw-pointer surface);
passing a numpy array as devptr fills it in place for compatibility.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import column as _col
from .ops import (
    array as _array,
    attrs as _attrs,
    case as _case,
    combine as _combine,
    find as _find,
    modify as _modify,
    pad as _pad,
    split as _split,
    strip as _strip,
    substr as _substr,
    urlencode as _url,
)
from .ops import convert as _convert
from .regex import ops as _rx


def _out(arr, devptr=0):
    """Return numpy result; optionally copy into a caller array."""
    host = np.asarray(jax.device_get(arr))
    if isinstance(devptr, np.ndarray):
        devptr[: len(host)] = host
        return devptr
    return host


class nvstrings:
    """Instance of strings on the device (python/nvstrings.py:373)."""

    def __init__(self, col: _col.StringColumn):
        self._col = col

    # ---------------- dunder ----------------

    def __str__(self):
        return str(self.to_host())

    def __repr__(self):
        return "<custrings.nvstrings count={}>".format(self.size())

    def __len__(self):
        return self._col.size

    def __iter__(self):
        return iter(self.to_host())

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.gather([int(key)])
        if isinstance(key, slice):
            idx = list(range(*key.indices(self.size())))
            return self.gather(idx)
        if isinstance(key, (list, np.ndarray)):
            return self.gather(list(key))
        raise TypeError("key must be integer, slice, or list of integers")

    # ---------------- export ----------------

    def to_host(self):
        return _col.to_host_strings(self._col)

    def to_offsets(self, sbuf=None, obuf=None, nbuf=0, bdevmem=False):
        data, offsets, nulls = _col.to_offsets_np(self._col)
        if isinstance(sbuf, np.ndarray):
            sbuf.view(np.uint8)[: len(data)] = data
        if isinstance(obuf, np.ndarray):
            obuf.view(np.int32)[: len(offsets)] = offsets
        if isinstance(nbuf, np.ndarray):
            nbuf.view(np.uint8)[: len(nulls)] = nulls
        return data, offsets, nulls

    def size(self):
        return self._col.size

    def memsize(self):
        return int(
            self._col.data.nbytes
            + self._col.offsets.nbytes
            + self._col.validity.nbytes
        )

    def device_memory(self):
        return self.memsize()

    def copy(self):
        return nvstrings(self._col)

    def get_cpointer(self):
        """Raw C++ instance pointer in the reference (NVStrings.h); there is
        no host pointer to a device column here -> 0 (compat stub)."""
        return 0

    def get_ipc_data(self):
        """Serialization-based stand-in for the reference's CUDA IPC
        handles (cpp/include/ipc_transfer.h): returns the Arrow host
        buffers (bytes, offsets, null bitmask, count) which any process
        can rebuild from via nvstrings.create_from_ipc."""
        data, offsets, nulls = _col.to_offsets_np(self._col)
        return (data.tobytes(), offsets.tobytes(), nulls.tobytes(),
                self.size())

    # ---------------- attrs ----------------

    def len(self, devptr=0):
        out = np.asarray(jax.device_get(_attrs.len_chars(self._col)))
        res = [int(v) if v >= 0 else None for v in out]
        if isinstance(devptr, np.ndarray):
            devptr[: len(out)] = out
            return devptr
        return res

    def byte_count(self, vals=0, bdevmem=False):
        """Returns the TOTAL byte count; per-row values only fill `vals`
        (reference python/nvstrings.py:567-596)."""
        out = np.asarray(jax.device_get(_attrs.byte_count(self._col)))
        if isinstance(vals, np.ndarray):
            vals[: len(out)] = out
        return int(np.maximum(out, 0).sum())

    def null_count(self, emptyisnull=False):
        return _col.null_count(self._col, emptyisnull)

    def get_nulls(self, emptyisnull=False):
        """Indexes of null rows (NVStrings::get_nulls, NVStrings.cu:547)."""
        nulls = ~np.asarray(jax.device_get(self._col.validity))
        if emptyisnull:
            lens = np.asarray(jax.device_get(self._col.lengths()))
            nulls = nulls | (lens == 0)
        return np.nonzero(nulls)[0].tolist()

    def set_null_bitmask(self, nbuf, bdevmem=False):
        bits = np.unpackbits(
            np.asarray(nbuf).view(np.uint8).ravel(), bitorder="little"
        )[: self.size()]
        validity = jnp.asarray(bits.astype(np.bool_))
        # null rows keep their bytes in the reference; we zero lengths only
        # when reading, so store the mask directly.
        self._col = _col.StringColumn(
            self._col.data, self._col.offsets, validity
        )
        return self

    def isalnum(self, devptr=0):
        return self._pred(_attrs.isalnum, devptr)

    def isalpha(self, devptr=0):
        return self._pred(_attrs.isalpha, devptr)

    def isdigit(self, devptr=0):
        return self._pred(_attrs.isdigit, devptr)

    def isspace(self, devptr=0):
        return self._pred(_attrs.isspace, devptr)

    def isdecimal(self, devptr=0):
        return self._pred(_attrs.isdecimal, devptr)

    def isnumeric(self, devptr=0):
        return self._pred(_attrs.isnumeric, devptr)

    def islower(self, devptr=0):
        return self._pred(_attrs.islower, devptr)

    def isupper(self, devptr=0):
        return self._pred(_attrs.isupper, devptr)

    def is_empty(self, devptr=0):
        return self._pred(_attrs.is_empty, devptr)

    def _pred(self, fn, devptr=0):
        out = _out(fn(self._col), devptr)
        if isinstance(devptr, np.ndarray):
            return out
        vals = np.asarray(jax.device_get(self._col.validity))
        # the reference binding maps null rows to None in host lists
        # (python/tests/test_convert.py::test_is_empty)
        return [bool(b) if v else None for b, v in zip(out, vals)]

    def _num(self, arr, devptr=0, cast=int):
        out = _out(arr, devptr)
        if isinstance(devptr, np.ndarray):
            return out
        vals = np.asarray(jax.device_get(self._col.validity))
        return [cast(x) if v else None for x, v in zip(out, vals)]

    # ---------------- compare/find ----------------

    def compare(self, str, devptr=0):
        out = _out(_find.compare(self._col, str), devptr)
        if isinstance(devptr, np.ndarray):
            return out
        vals = np.asarray(jax.device_get(self._col.validity))
        return [int(x) if v else None for x, v in zip(out, vals)]

    def _pos_list(self, out, devptr):
        if isinstance(devptr, np.ndarray):
            return out
        # null rows (-2 core convention) -> None in host lists
        return [None if x == -2 else int(x) for x in out]

    def find(self, sub, start=0, end=None, devptr=0):
        out = _out(_find.find(self._col, sub, start, end), devptr)
        return self._pos_list(out, devptr)

    def index(self, sub, start=0, end=None, devptr=0):
        out = self.find(sub, start, end, devptr)
        vals = out if not isinstance(out, np.ndarray) else out.tolist()
        if any(v == -1 for v in vals):
            raise ValueError("substring not found")
        return out

    def rindex(self, sub, start=0, end=None, devptr=0):
        out = self.rfind(sub, start, end, devptr)
        vals = out if not isinstance(out, np.ndarray) else out.tolist()
        if any(v == -1 for v in vals):
            raise ValueError("substring not found")
        return out

    def rfind(self, sub, start=0, end=None, devptr=0):
        out = _out(_find.rfind(self._col, sub, start, end), devptr)
        return self._pos_list(out, devptr)

    def find_from(self, sub, starts=0, ends=0, devptr=0):
        s = None if isinstance(starts, int) and starts == 0 else starts
        e = None if isinstance(ends, int) and ends == 0 else ends
        out = _out(_find.find_from(self._col, sub, s, e), devptr)
        return self._pos_list(out, devptr)

    def find_multiple(self, strs, devptr=0):
        other = strs._col if isinstance(strs, nvstrings) else to_device(strs)._col
        out = _out(_find.find_multiple(self._col, other), devptr)
        if isinstance(devptr, np.ndarray):
            return out
        return [
            [None if x == -2 else int(x) for x in row] for row in out
        ]

    def contains(self, pat, regex=True, devptr=0):
        if regex:
            res = _rx.contains_re(self._col, pat)
        else:
            res = _find.contains(self._col, pat)
        out = _out(res, devptr)
        if isinstance(devptr, np.ndarray):
            return out
        vals = np.asarray(jax.device_get(self._col.validity))
        return [bool(b) if v else None for b, v in zip(out, vals)]

    def match(self, pat, devptr=0):
        out = _out(_rx.match_re(self._col, pat), devptr)
        if isinstance(devptr, np.ndarray):
            return out
        vals = np.asarray(jax.device_get(self._col.validity))
        return [bool(b) if v else None for b, v in zip(out, vals)]

    def match_strings(self, strs, devptr=0):
        other = strs._col if isinstance(strs, nvstrings) else to_device(strs)._col
        out = _out(_find.match_strings(self._col, other), devptr)
        return out if isinstance(devptr, np.ndarray) else out.tolist()

    def count(self, pat, devptr=0):
        out = _out(_rx.count_re(self._col, pat), devptr)
        return out if isinstance(devptr, np.ndarray) else out.tolist()

    def startswith(self, pat, devptr=0):
        # null rows -> None (reference python tests test_compare.py:70-76)
        return self._pred(lambda c: _find.startswith(c, pat), devptr)

    def endswith(self, pat, devptr=0):
        return self._pred(lambda c: _find.endswith(c, pat), devptr)

    # ---------------- regex ----------------

    def findall(self, pat):
        return [nvstrings(c) for c in _rx.findall_columns(self._col, pat)]

    def findall_record(self, pat):
        tc = _rx.findall_record(self._col, pat)
        return _records(tc)

    def extract(self, pat):
        return [nvstrings(c) for c in _rx.extract(self._col, pat)]

    def extract_record(self, pat):
        """Per-row nvstrings of group matches (extract_record.cu:96)."""
        cols = _rx.extract(self._col, pat)
        if not cols:
            return []
        return _transpose_records(self, cols)

    def replace(self, pat, repl, n=-1, regex=True):
        if regex:
            return nvstrings(_rx.replace_re(self._col, pat, repl, n))
        return nvstrings(_modify.replace_literal(self._col, pat, repl, n))

    def replace_multi(self, pats, repls, regex=True):
        rep = repls.to_host() if isinstance(repls, nvstrings) else repls
        if regex:
            return nvstrings(_rx.replace_multi_re(self._col, pats, rep))
        cur = self._col
        rl = rep if isinstance(rep, (list, tuple)) else [rep] * len(pats)
        for p, r in zip(pats, rl):
            cur = _modify.replace_literal(cur, p, r)
        return nvstrings(cur)

    def replace_with_backrefs(self, pat, repl):
        return nvstrings(_rx.replace_with_backrefs(self._col, pat, repl))

    # ---------------- combine ----------------

    def cat(self, others=None, sep=None, na_rep=None):
        # others=None joins the whole column into one string
        # (reference python/tests/test_combine.py:7-23)
        if others is None:
            return nvstrings(
                _combine.join(self._col, sep or "", na_rep)
            )
        if isinstance(others, (list, tuple)):
            if all(o is None or isinstance(o, str) for o in others):
                # a list of plain strings IS one column, catted
                # elementwise (python/notebooks/test_combine.ipynb:
                # strs1.cat(["1","2","3","4","5"], sep=":"))
                others = to_device(list(others))
            else:
                cur = self
                for o in others:
                    cur = cur.cat(o, sep=sep, na_rep=na_rep)
                return cur
        other = others._col if isinstance(others, nvstrings) else to_device(others)._col
        return nvstrings(_combine.cat(self._col, other, sep, na_rep))

    def join(self, sep=""):
        return nvstrings(_combine.join(self._col, sep))

    # ---------------- split ----------------

    def split_record(self, delimiter=None, n=-1):
        return _records(_split.split_record(self._col, delimiter, n))

    def rsplit_record(self, delimiter=None, n=-1):
        return _records(_split.rsplit_record(self._col, delimiter, n))

    def split(self, delimiter=None, n=-1):
        return [
            nvstrings(c)
            for c in _split.split_columns(self._col, delimiter, n)
        ]

    def rsplit(self, delimiter=None, n=-1):
        return [
            nvstrings(c)
            for c in _split.rsplit_columns(self._col, delimiter, n)
        ]

    def partition(self, delimiter=" "):
        cols = _split.partition(self._col, delimiter)
        return _transpose_records(self, cols)

    def rpartition(self, delimiter=" "):
        cols = _split.rpartition(self._col, delimiter)
        return _transpose_records(self, cols)

    # ---------------- substr / modify ----------------

    def get(self, i):
        return nvstrings(_substr.get_char(self._col, i))

    def repeat(self, repeats):
        return nvstrings(_pad.repeat(self._col, repeats))

    def pad(self, width, side="left", fillchar=" "):
        return nvstrings(_pad.pad(self._col, width, side, fillchar))

    def ljust(self, width, fillchar=" "):
        return nvstrings(_pad.ljust(self._col, width, fillchar))

    def center(self, width, fillchar=" "):
        return nvstrings(_pad.center(self._col, width, fillchar))

    def rjust(self, width, fillchar=" "):
        return nvstrings(_pad.rjust(self._col, width, fillchar))

    def zfill(self, width):
        return nvstrings(_pad.zfill(self._col, width))

    def wrap(self, width):
        return nvstrings(_pad.wrap(self._col, width))

    def slice(self, start, stop=None, step=None):
        return nvstrings(_substr.slice_chars(self._col, start, stop, step))

    def slice_from(self, starts=0, stops=0):
        s = None if isinstance(starts, int) and starts == 0 else starts
        e = None if isinstance(stops, int) and stops == 0 else stops
        return nvstrings(_substr.slice_from(self._col, s, e))

    def slice_replace(self, start=None, stop=None, repl=None):
        return nvstrings(
            _modify.slice_replace(self._col, start or 0, stop, repl)
        )

    def insert(self, start=0, repl=None):
        return nvstrings(_modify.insert(self._col, start, repl or ""))

    def fillna(self, repl):
        if isinstance(repl, nvstrings):
            return nvstrings(_modify.fillna_column(self._col, repl._col))
        return nvstrings(_modify.fillna_scalar(self._col, repl))

    def lstrip(self, to_strip=None):
        return nvstrings(_strip.lstrip(self._col, to_strip))

    def strip(self, to_strip=None):
        return nvstrings(_strip.strip(self._col, to_strip))

    def rstrip(self, to_strip=None):
        return nvstrings(_strip.rstrip(self._col, to_strip))

    def lower(self):
        return nvstrings(_case.lower(self._col))

    def upper(self):
        return nvstrings(_case.upper(self._col))

    def capitalize(self):
        return nvstrings(_case.capitalize(self._col))

    def swapcase(self):
        return nvstrings(_case.swapcase(self._col))

    def title(self):
        return nvstrings(_case.title(self._col))

    def translate(self, table):
        return nvstrings(_modify.translate(self._col, table))

    def url_encode(self):
        return nvstrings(_url.url_encode(self._col))

    def url_decode(self):
        return nvstrings(_url.url_decode(self._col))

    # ---------------- array ----------------

    def sort(self, stype=2, asc=True, nullfirst=True):
        return nvstrings(_array.sort(self._col, stype, asc, nullfirst))

    def order(self, stype=2, asc=True, nullfirst=True, devptr=0):
        out = _out(_array.order(self._col, stype, asc, nullfirst), devptr)
        return out if isinstance(devptr, np.ndarray) else out.tolist()

    def sublist(self, indexes, count=0):
        return self.gather(indexes, count)

    def gather(self, indexes, count=0):
        if isinstance(indexes, (list, np.ndarray)) and len(indexes) and isinstance(
            np.asarray(indexes).ravel()[0].item(), bool
        ):
            return nvstrings(_array.gather_mask(self._col, np.asarray(indexes)))
        return nvstrings(_array.gather(self._col, np.asarray(indexes, np.int64)))

    def scatter(self, strs, indexes):
        other = strs._col if isinstance(strs, nvstrings) else to_device(strs)._col
        return nvstrings(_array.scatter(self._col, other, np.asarray(indexes)))

    def scalar_scatter(self, str, indexes, count=0):
        one = to_device([str])._col
        return nvstrings(
            _array.scalar_scatter(self._col, one, np.asarray(indexes))
        )

    def remove_strings(self, indexes, count=0):
        return nvstrings(_array.remove_strings(self._col, indexes))

    def add_strings(self, strs):
        items = strs if isinstance(strs, list) else [strs]
        cols = [self._col] + [
            s._col if isinstance(s, nvstrings) else to_device(s)._col
            for s in items
        ]
        return nvstrings(_array.append(cols))

    # ---------------- convert ----------------

    def hash(self, devptr=0):
        out = _out(_convert.hash_mm3(self._col), devptr)
        if isinstance(devptr, np.ndarray):
            return out
        vals = np.asarray(jax.device_get(self._col.validity))
        return [int(h) if v else None for h, v in zip(out, vals)]

    def stoi(self, devptr=0):
        return self._num(_convert.stoi(self._col), devptr, int)

    def stol(self, devptr=0):
        return self._num(_convert.stol(self._col), devptr, int)

    def stof(self, devptr=0):
        return self._num(_convert.stof(self._col), devptr, float)

    def stod(self, devptr=0):
        return self._num(_convert.stod(self._col), devptr, float)

    def htoi(self, devptr=0):
        return self._num(_convert.htoi(self._col), devptr, int)

    def ip2int(self, devptr=0):
        return self._num(_convert.ip2int(self._col), devptr, int)

    def to_booleans(self, true="True", devptr=0):
        out = _out(_convert.to_booleans(self._col, true), devptr)
        if isinstance(devptr, np.ndarray):
            return out
        vals = np.asarray(jax.device_get(self._col.validity))
        return [bool(b) if v else None for b, v in zip(out, vals)]

    def timestamp2int(self, format=None, units="s", devptr=0):
        from .ops import datetime_k

        out = _out(
            datetime_k.timestamp2int(self._col, format, units), devptr
        )
        return out if isinstance(devptr, np.ndarray) else out.tolist()

    def get_info(self):
        from .utils import stats

        return stats.compute_statistics(self._col)


def _records(tc):
    """TokenColumn -> list of per-row nvstrings (or None), reference
    split_record return shape (split.cu:163-196 materializes per-row
    instances in one pass).

    One batched D2H of the flattened TokenColumn; each row's nvstrings is
    then a host-resident numpy-backed StringColumn (pure host slicing, no
    per-row device dispatch).  Device ops on a row upload lazily via jnp
    coercion; `to_host()` never touches the device again."""
    toks = tc.tokens
    data, offs_t, val_t, row_off, row_val = jax.device_get(
        (toks.data, toks.offsets, toks.validity,
         tc.row_offsets, tc.row_validity)
    )
    data = np.asarray(data)
    offs_t = np.ascontiguousarray(offs_t, np.int32)
    val_t = np.asarray(val_t)
    out = []
    for i in range(tc.nrows):
        if not row_val[i]:
            out.append(None)
            continue
        a, b = int(row_off[i]), int(row_off[i + 1])
        o = offs_t[a : b + 1]
        sub = _col.StringColumn(
            np.ascontiguousarray(data[o[0] : o[-1]] if b > a else data[:0]),
            np.ascontiguousarray(o - o[0] if b > a else offs_t[:1] * 0),
            np.ascontiguousarray(val_t[a:b]),
        )
        out.append(nvstrings(sub))
    return out


def _transpose_records(src, cols):
    """Column-major results -> per-row nvstrings (partition/extract_record).

    One device concat + one batched D2H; per-row k-string instances are
    host-resident numpy-backed columns (see _records)."""
    n = src.size()
    k = len(cols)
    combined = _array.append([c for c in cols])
    data, offs, val = jax.device_get(
        (combined.data, combined.offsets, combined.validity)
    )
    data = np.asarray(data)
    offs = np.ascontiguousarray(offs, np.int32)
    val = np.asarray(val)
    out = []
    for i in range(n):
        idx = [j * n + i for j in range(k)]
        new_off = np.zeros(k + 1, np.int32)
        parts = []
        for j, jj in enumerate(idx):
            parts.append(data[offs[jj] : offs[jj + 1]])
            new_off[j + 1] = new_off[j] + (offs[jj + 1] - offs[jj])
        sub = _col.StringColumn(
            np.concatenate(parts) if parts else data[:0],
            new_off,
            val[np.asarray(idx, np.int64)],
        )
        out.append(nvstrings(sub))
    return out


# ---------------- module-level constructors ----------------


def to_device(strs):
    """Create nvstrings from a list of Python strings (nvstrings.py:4)."""
    return nvstrings(_col.from_host_strings(strs))


def from_strings(*args):
    """Concatenate nvstrings instances (nvstrings.py:27)."""
    cols = []
    for a in args:
        if isinstance(a, list):
            cols.extend(x._col for x in a)
        else:
            cols.append(a._col)
    return nvstrings(_array.append(cols))


def from_offsets(sbuf, obuf, scount, nbuf=None, ncount=0, bdevmem=False):
    return nvstrings(_col.from_offsets_np(sbuf, obuf, scount, nbuf))


def from_csv(csv, column, lines=0, flags=0):
    from .utils import csv as _csv

    return nvstrings(_csv.read_column(csv, column, lines))


def itos(values, count=0, nulls=None, bdevmem=False):
    return nvstrings(_convert.itos(np.asarray(values, np.int32), nulls))


def ltos(values, count=0, nulls=None, bdevmem=False):
    return nvstrings(_convert.itos(np.asarray(values, np.int64), nulls))


def ftos(values, count=0, nulls=None, bdevmem=False):
    return nvstrings(_convert.ftos(np.asarray(values, np.float32), nulls))


def dtos(values, count=0, nulls=None, bdevmem=False):
    return nvstrings(_convert.ftos(np.asarray(values, np.float64), nulls))


def int2ip(values, count=0, nulls=None, bdevmem=False):
    vals = [0 if v is None else int(v) for v in values]
    return nvstrings(_convert.int2ip(np.asarray(vals, np.uint32), nulls))


def from_booleans(values, true="True", false="False", nulls=None, bdevmem=False):
    return nvstrings(
        _convert.from_booleans(np.asarray(values), true, false, nulls)
    )


def int2timestamp(values, units="s", format=None, nulls=None, bdevmem=False):
    from .ops import datetime_k

    return nvstrings(
        datetime_k.int2timestamp(np.asarray(values, np.int64), units, format, nulls)
    )


def create_from_ipc(ipc_data):
    """Rebuild an nvstrings from get_ipc_data() output
    (python/nvstrings.py:348-362 equivalent; see get_ipc_data)."""
    data_b, offs_b, nulls_b, count = ipc_data
    return from_offsets(
        np.frombuffer(data_b, np.uint8),
        np.frombuffer(offs_b, np.int32),
        count,
        np.frombuffer(nulls_b, np.uint8),
    )


def free(dstrs):
    """No-op: memory is managed by JAX (nvstrings.py:363)."""


def bind_cpointer(cptr, own=True):  # pragma: no cover
    raise NotImplementedError("raw device pointers are not exposed")
