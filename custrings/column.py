"""Core columnar string representation.

The reference (cuStrings) stores one heap object per string on the GPU
(`custring_view`, cpp/src/custring_view.cuh:44-225) plus an array of device
pointers.  That representation is built around pointer-chasing; the layout
here is the Arrow layout the reference
already speaks at its boundaries (`NVStrings::create_from_offsets`,
cpp/include/NVStrings.h:116,207):

    data     : uint8[capacity]   flat UTF-8 bytes of all rows, padded to a
                                 bucketed capacity (config.bucket_bytes) so jit
                                 caches hit; only the first offsets[-1] bytes
                                 are meaningful.
    offsets  : int32[rows + 1]   byte offset of each row start; offsets[-1] is
                                 the true total byte count.
    validity : bool[rows]        True = valid; null rows have zero length.

All ops are pure functions producing new columns (the reference's instances
are likewise immutable, cpp/include/NVStrings.h:37-39).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import bucket_bytes


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StringColumn:
    data: jax.Array  # uint8[capacity]
    offsets: jax.Array  # int32[rows + 1]
    validity: jax.Array  # bool[rows]

    @property
    def size(self) -> int:
        """Number of rows (static)."""
        return self.offsets.shape[0] - 1

    @property
    def capacity(self) -> int:
        """Padded byte capacity (static)."""
        return self.data.shape[0]

    def nbytes(self) -> int:
        """True total byte count (device sync)."""
        return int(self.offsets[-1])

    def lengths(self) -> jax.Array:
        """Byte length of each row, int32[rows] (0 for nulls)."""
        return self.offsets[1:] - self.offsets[:-1]

    def __len__(self) -> int:
        return self.size


def _device_column(data_np, offsets_np, validity_np) -> StringColumn:
    cap = bucket_bytes(len(data_np))
    padded = np.zeros(cap, dtype=np.uint8)
    padded[: len(data_np)] = data_np
    return StringColumn(
        data=jnp.asarray(padded, dtype=jnp.uint8),
        offsets=jnp.asarray(offsets_np, dtype=jnp.int32),
        validity=jnp.asarray(validity_np, dtype=jnp.bool_),
    )


def flatten_host(strs):
    """Host (numpy) Arrow buffers of a list of Python str / None:
    (uint8 bytes, int32[rows + 1] offsets, bool[rows] validity).

    The native fastcolumn C extension flattens the list in one pass
    (pure-numpy fallback when no toolchain is present).  Raises
    OverflowError past 2^31 - 1 bytes."""
    from .native.build import load as _load_native

    native = _load_native()
    if native is not None:
        if not isinstance(strs, list):
            strs = list(strs)
        data_b, offs_b, valid_b = native.flatten(strs)
        data = np.frombuffer(data_b, dtype=np.uint8)
        offsets = np.frombuffer(offs_b, dtype=np.int32)
        validity = np.frombuffer(valid_b, dtype=np.uint8).astype(np.bool_)
        return data, offsets, validity
    enc = [b"" if s is None else s.encode("utf-8") for s in strs]
    lens = np.fromiter((len(e) for e in enc), dtype=np.int64, count=len(enc))
    if lens.sum() > np.iinfo(np.int32).max:
        raise OverflowError("column exceeds int32 bytes")
    offsets = np.zeros(len(enc) + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(b"".join(enc), dtype=np.uint8)
    validity = np.fromiter(
        (s is not None for s in strs), dtype=np.bool_, count=len(strs)
    )
    return data, offsets, validity


def from_host_strings(strs) -> StringColumn:
    """Build a device column from a list of Python str / None.

    Mirrors nvstrings.to_device (python/nvstrings.py:4-24).  Unlike the
    reference there is no host-side per-string placement loop
    (cpp/src/strings/NVStringsImpl.cu:126-195): `flatten_host` flattens
    the list in one pass and offsets + bytes upload directly.
    """
    return _device_column(*flatten_host(strs))


def from_offsets_np(sbuf, obuf, scount, nbuf=None) -> StringColumn:
    """Build a column from Arrow-style host buffers.

    Mirrors nvstrings.from_offsets (python/nvstrings.py:103-152): sbuf holds
    UTF-8 bytes, obuf holds scount+1 int32 offsets, nbuf is an optional Arrow
    little-endian null bitmask (bit set = valid).
    """
    if isinstance(obuf, int):
        # raw host pointers (numpy .ctypes.data ints), reference
        # python/tests/test_offsets.py::test_from_offsets_ctypes_data
        import ctypes

        obuf = np.ctypeslib.as_array(
            ctypes.cast(obuf, ctypes.POINTER(ctypes.c_int32)),
            shape=(scount + 1,),
        ).copy()
        total = int(obuf[-1]) if scount >= 0 else 0
        sbuf = np.ctypeslib.as_array(
            ctypes.cast(sbuf, ctypes.POINTER(ctypes.c_uint8)),
            shape=(max(total, 1),),
        )[:total].copy()
        if nbuf is not None and isinstance(nbuf, int) and nbuf:
            nbuf = np.ctypeslib.as_array(
                ctypes.cast(nbuf, ctypes.POINTER(ctypes.c_uint8)),
                shape=((scount + 7) // 8,),
            ).copy()
    sbuf = np.asarray(sbuf).view(np.uint8).ravel()
    obuf = np.asarray(obuf).view(np.int32).ravel()[: scount + 1]
    total = int(obuf[-1]) if len(obuf) else 0
    if nbuf is not None:
        bits = np.unpackbits(
            np.asarray(nbuf).view(np.uint8).ravel(), bitorder="little"
        )
        validity = bits[:scount].astype(np.bool_)
    else:
        validity = np.ones(scount, dtype=np.bool_)
    return _device_column(sbuf[:total], obuf, validity)


def to_host_strings(col: StringColumn):
    """Copy a column back to a list of Python str / None.

    Mirrors NVStrings::to_host (cpp/src/strings/NVStrings.cu:266-347):
    null rows -> None, empty rows -> "".
    """
    data, offsets, validity = jax.device_get(
        (col.data, col.offsets, col.validity)
    )
    from .native.build import load as _load_native

    native = _load_native()
    if native is not None:
        return native.unflatten(
            data.tobytes(),
            np.ascontiguousarray(offsets, np.int32).tobytes(),
            validity.astype(np.uint8).tobytes(),
            col.size,
        )
    buf = data.tobytes()
    out = []
    for i in range(col.size):
        if not validity[i]:
            out.append(None)
        else:
            out.append(buf[offsets[i] : offsets[i + 1]].decode("utf-8"))
    return out


def to_offsets_np(col: StringColumn):
    """Export (bytes, offsets, null-bitmask) host numpy arrays.

    Mirrors NVStrings::create_offsets (cpp/src/strings/NVStrings.cu:402-470);
    bitmask is Arrow little-endian, bit set = valid.
    """
    data, offsets, validity = jax.device_get(
        (col.data, col.offsets, col.validity)
    )
    total = int(offsets[-1])
    nbuf = np.packbits(validity.astype(np.uint8), bitorder="little")
    return data[:total].copy(), offsets.copy(), nbuf


def null_count(col: StringColumn, emptyisnull: bool = False) -> int:
    """Number of null rows (python/nvstrings.py:622-646)."""
    nulls = ~col.validity
    if emptyisnull:
        nulls = nulls | (col.lengths() == 0)
    return int(jnp.sum(nulls))


# ---------------------------------------------------------------------------
# Shared layout helpers used by every materializing op.
# ---------------------------------------------------------------------------


def cumsum0(sizes: jax.Array) -> jax.Array:
    """Exclusive-scan with appended total: int32[n] -> int32[n+1].

    The reference's thrust::exclusive_scan step in the canonical two-pass
    pattern (e.g. cpp/src/strings/split.cu:147-161).
    """
    from .ops.segments import cumsum

    out = jnp.zeros(sizes.shape[0] + 1, dtype=jnp.int32)
    return out.at[1:].set(cumsum(sizes))


# implementation selector: scatter-add+cumsum vs vectorized binary search
ROW_IDS_IMPL = "scatter"


def row_ids_from_offsets(offsets: jax.Array, capacity: int) -> jax.Array:
    """For each byte position j in [0, capacity), the row that owns it.

    Positions past offsets[-1] (bucket padding) clamp to the last row.
    """
    nrows = offsets.shape[0] - 1
    if ROW_IDS_IMPL == "searchsorted":
        j = jnp.arange(capacity, dtype=jnp.int32)
        ids = (
            jnp.searchsorted(offsets, j, side="right").astype(jnp.int32) - 1
        )
    else:
        from .ops.segments import cumsum

        starts = offsets[:-1]
        marks = jnp.zeros((capacity + 1,), jnp.int32).at[starts].add(1)
        ids = cumsum(marks[:capacity]) - 1
    return jnp.clip(ids, 0, max(nrows - 1, 0))


def materialize_bytes(out_offsets: jax.Array, capacity: int, produce):
    """Build the flat byte buffer of a new column.

    `produce(row, k, valid)` must return the k-th output byte of `row`
    vectorized over flat positions; `valid` masks bucket-padding positions.
    This is the gather-based replacement for the reference's pass-B write
    kernels: instead of each thread carving a sub-buffer, every output byte
    position independently computes its (row, k) coordinate and gathers its
    value — fully parallel, no host ping-pong.
    """
    from .ops.segments import broadcast_rows_to_bytes

    j = jnp.arange(capacity, dtype=jnp.int32)
    rows = row_ids_from_offsets(out_offsets, capacity)
    k = j - broadcast_rows_to_bytes(out_offsets[:-1], out_offsets, capacity)
    valid = j < out_offsets[-1]
    import inspect

    if "bcast" in inspect.signature(produce).parameters:
        vals = produce(
            rows, k, valid,
            bcast=lambda v: broadcast_rows_to_bytes(v, out_offsets, capacity),
        )
    else:
        vals = produce(rows, k, valid)
    return jnp.where(valid, vals, jnp.uint8(0))


def empty_column(nrows: int, all_null: bool = False) -> StringColumn:
    data = jnp.zeros(bucket_bytes(0), dtype=jnp.uint8)
    offsets = jnp.zeros(nrows + 1, dtype=jnp.int32)
    validity = jnp.full((nrows,), not all_null, dtype=jnp.bool_)
    return StringColumn(data, offsets, validity)


def build_column(
    sizes: jax.Array, validity: jax.Array, produce, capacity: int | None = None
) -> StringColumn:
    """Assemble a column given per-row byte sizes and a byte producer.

    Syncs once to read the total (the reference likewise synchronizes between
    its size pass and write pass, cpp/src/strings/split.cu:163).
    """
    if sizes.shape[0] == 0:
        return empty_column(0)
    out_offsets = cumsum0(sizes)
    if capacity is None:
        capacity = bucket_bytes(int(out_offsets[-1]))
    data = materialize_bytes(out_offsets, capacity, produce)
    return StringColumn(data, out_offsets, validity)


@partial(jax.jit, static_argnums=(1,))
def _pad_to(data: jax.Array, capacity: int) -> jax.Array:
    if data.shape[0] >= capacity:
        return data[:capacity]
    return jnp.zeros(capacity, jnp.uint8).at[: data.shape[0]].set(data)


# ops skip the exact-size sync and allocate the bound directly when the
# static output bound is below this many bytes (latency >> memory there)
BOUND_SYNC_THRESHOLD = 1 << 28


def jit_materialize(body_fn, static_argnums=(), bound_fn=None):
    """Compile a materializing op into exactly two XLA programs + one sync.

    body_fn(col, *args) must be pure-traceable and return
    (sizes, validity, produce).  The size pass and the write pass each run
    as ONE compiled program (the reference's two-pass pattern,
    cpp/src/strings/split.cu:143-220, with XLA fusion inside each pass);
    sizes are recomputed in the write pass — cheap next to the dispatch
    latency it saves.

    bound_fn(col, *args) -> static byte upper bound or None.  When it
    returns a bound under BOUND_SYNC_THRESHOLD the size pass and its
    device->host sync are skipped entirely: the buffer is allocated at the
    bound and offsets stay exact (ONE program, ZERO syncs).
    """
    body_static = tuple(static_argnums)

    @partial(jax.jit, static_argnums=body_static)
    def total_fn(col, *args):
        sizes, validity, produce = body_fn(col, *args)
        return jnp.sum(sizes.astype(jnp.int32))

    def make_full(capacity):
        @partial(jax.jit, static_argnums=body_static)
        def full_fn(col, *args):
            sizes, validity, produce = body_fn(col, *args)
            out_offsets = cumsum0(sizes)
            data = materialize_bytes(out_offsets, capacity, produce)
            return data, out_offsets, validity

        return full_fn

    full_cache: dict = {}

    def op(col, *args):
        if col.size == 0:
            return empty_column(0)
        capacity = None
        if bound_fn is not None:
            bound = bound_fn(col, *args)
            if bound is not None and bound <= BOUND_SYNC_THRESHOLD:
                capacity = bucket_bytes(bound)
        if capacity is None:
            total = int(total_fn(col, *args))
            capacity = bucket_bytes(total)
        if capacity not in full_cache:
            full_cache[capacity] = make_full(capacity)
        data, out_offsets, validity = full_cache[capacity](col, *args)
        return StringColumn(data, out_offsets, validity)

    return op
