"""UTF-8 layout machinery: the array replacement for the reference's L1 runtime.

The reference walks per-string 2-bit char-length tables with sequential loops
(`custring_view::offset_for_char_pos`, cpp/src/custring_view.inl:47-143).
Here the whole column's char structure is computed with vectorized masks,
cumsums and gathers:

    char_start[j] = (data[j] & 0xC0) != 0x80        (UTF-8 non-continuation)
    char index of byte j = cumsum(char_start)[j]
    byte position of char c = scatter-compact of start positions

Everything is O(total_bytes) data-parallel work; the ASCII fast path of the
reference (chars == bytes) falls out for free because the cumsum is identity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from .segments import cumsum as _cumsum
import numpy as np

from ..column import StringColumn, row_ids_from_offsets  # noqa: F401 (re-export)
from ..config import bucket_bytes


def _cache(col: StringColumn) -> dict:
    c = col.__dict__.get("_cache")
    if c is None:
        c = {}
        object.__setattr__(col, "_cache", c)
    return c


#: Capacity (bytes) above which the per-column byte planes (row bounds,
#: validity broadcast) are NOT memoized on the column: the two int32 +
#: one bool plane cost ~9 bytes of device memory per capacity byte, so a
#: memoized plane set would pin ~9x the column for the column's lifetime
#: while the ops that read it run more copies of the same size.  512 MB of
#: capacity (4.5 GB of planes) keeps a few memoized columns well inside
#: one 80 GB card.  Above the budget, consumers call the plane helpers
#: INSIDE their jitted programs (tracer path below), where the scans fuse
#: into the op and the planes live only as transients.
PLANE_CACHE_BUDGET = 1 << 29


def planes_cacheable(col: StringColumn) -> bool:
    """True when the column's capacity is under the plane-cache budget
    (callers outside jit should pass planes=None above it and let the
    jitted op compute them inline)."""
    return col.capacity <= PLANE_CACHE_BUDGET


def valid_byte_mask(col: StringColumn) -> jax.Array:
    """bool[capacity]: True for real (non-padding) byte positions."""
    j = jnp.arange(col.capacity, dtype=jnp.int32)
    return j < col.offsets[-1]


def set_ascii_hint(col: StringColumn, flag: bool) -> None:
    """Pin the column's ASCII-ness (for traced columns whose data cannot
    be inspected, e.g. inside a resident jitted loop)."""
    _cache(col)["is_ascii"] = bool(flag)


def is_ascii(col: StringColumn) -> bool:
    """True if every byte is < 0x80 (chars == bytes: the reference's ASCII
    fast path, custring_view.inl:47 `chars_in_string` shortcut).

    One cached device reduce + host sync per column; conservatively False
    for traced columns without an explicit hint (set_ascii_hint)."""
    c = _cache(col)
    if "is_ascii" not in c:
        if isinstance(col.data, jax.core.Tracer):
            return False
        c["is_ascii"] = bool(jax.device_get(jnp.max(col.data) < 0x80)) if (
            col.capacity
        ) else True
    return c["is_ascii"]


@partial(jax.jit, static_argnums=(1,))
def _row_planes_impl(offsets, capacity: int):
    from . import segments

    return (
        segments.row_start_positions(offsets, capacity),
        segments.row_end_positions(offsets, capacity),
    )


def row_bounds_planes(col: StringColumn):
    """(row_start, row_end) int32[capacity] planes, memoized per column.

    The reference precomputes a custring_view per string once per column
    (NVStringsImpl.cu) and every kernel reads it; the array analogue is the
    byte->row-bounds planes.  Computing them costs two linear scans
    — memoizing turns every later op on the same
    column into pure fused elementwise work.  Falls back to inline
    computation for traced columns (inside a caller's jit) and for
    columns over PLANE_CACHE_BUDGET (no memoization: the planes would
    otherwise pin ~8x capacity of HBM for the column's lifetime)."""
    if (
        isinstance(col.offsets, jax.core.Tracer)
        or isinstance(col.data, jax.core.Tracer)
        or not planes_cacheable(col)
    ):
        from . import segments

        return (
            segments.row_start_positions(col.offsets, col.capacity),
            segments.row_end_positions(col.offsets, col.capacity),
        )
    c = _cache(col)
    if "row_bounds" not in c:
        c["row_bounds"] = _row_planes_impl(col.offsets, col.capacity)
    return c["row_bounds"]


@partial(jax.jit, static_argnums=(2,))
def _valid_rows_plane_impl(validity, offsets, capacity: int):
    from . import segments

    return (
        segments.broadcast_rows_to_bytes(
            validity.astype(jnp.int32), offsets, capacity
        )
        == 1
    )


def valid_rows_plane(col: StringColumn):
    """bool[capacity]: byte j's ROW is valid — the per-column validity
    broadcast, memoized like row_bounds_planes (one linear scan; same
    PLANE_CACHE_BUDGET gate)."""
    if (
        isinstance(col.offsets, jax.core.Tracer)
        or isinstance(col.validity, jax.core.Tracer)
        or not planes_cacheable(col)
    ):
        from . import segments

        return (
            segments.broadcast_rows_to_bytes(
                col.validity.astype(jnp.int32), col.offsets, col.capacity
            )
            == 1
        )
    c = _cache(col)
    if "valid_rows" not in c:
        c["valid_rows"] = _valid_rows_plane_impl(
            col.validity, col.offsets, col.capacity
        )
    return c["valid_rows"]


@partial(jax.jit, static_argnums=(2,))
def _tail_plane_impl(offsets, validity, capacity: int):
    from . import segments

    j = jnp.arange(capacity, dtype=jnp.int32)
    row_end = segments.row_end_positions(offsets, capacity)
    vb = (
        segments.broadcast_rows_to_bytes(
            validity.astype(jnp.int32), offsets, capacity
        )
        == 1
    )
    rem = jnp.clip(row_end - j, 0, 255)
    return jnp.where(vb & (j < offsets[-1]), rem, 0).astype(jnp.uint8)


def tail_plane(col: StringColumn) -> jax.Array:
    """uint8[capacity]: bytes remaining in the byte's VALID row from this
    position (clipped at 255); 0 for padding bytes and null-row bytes.

    The one-plane custring_view analogue: for any pattern length m <=
    255, `tail >= m` fuses the row fence (j + m <= row_end), the
    valid-byte test, and the row-validity broadcast into ONE u8 compare
    — at 1/9 the HBM cost of the int32 row-bounds pair, so it stays
    memoized at ANY capacity (1 byte per capacity byte; the 4M tier
    pins 0.9 GB instead of 8.1 GB)."""
    if isinstance(col.offsets, jax.core.Tracer) or isinstance(
        col.validity, jax.core.Tracer
    ):
        return _tail_plane_impl(col.offsets, col.validity, col.capacity)
    c = _cache(col)
    if "tail" not in c:
        c["tail"] = _tail_plane_impl(
            col.offsets, col.validity, col.capacity
        )
    return c["tail"]


@dataclasses.dataclass(frozen=True)
class CharMap:
    """Column-wide character index structures (all shapes static).

    cs0          int32[capacity+1]  chars in bytes [0, j)
    char_offsets int32[rows+1]      char index of each row start
    char_pos     int32[capacity]    byte position of the c-th char
                                    (clamped for c >= total_chars)
    """

    cs0: jax.Array
    char_offsets: jax.Array
    char_pos: jax.Array

    def nchars(self) -> jax.Array:
        """Characters per row, int32[rows]."""
        return self.char_offsets[1:] - self.char_offsets[:-1]


@jax.jit
def _char_map(data, offsets):
    capacity = data.shape[0]
    j = jnp.arange(capacity, dtype=jnp.int32)
    real = j < offsets[-1]
    starts = ((data & 0xC0) != 0x80) & real
    cs0 = jnp.zeros(capacity + 1, jnp.int32).at[1:].set(
        _cumsum(starts.astype(jnp.int32))
    )
    char_offsets = cs0[offsets]
    # Compact: char_pos[cs0[j]] = j for start bytes (dummy slot for others).
    idx = jnp.where(starts, cs0[:-1], capacity)
    char_pos = (
        jnp.zeros(capacity + 1, jnp.int32).at[idx].set(j)[:capacity]
    )
    return cs0, char_offsets, char_pos


@jax.jit
def _char_map_ascii(offsets, capacity_arr):
    """ASCII columns: chars == bytes, so every structure is affine — no
    scatter, no gather."""
    capacity = capacity_arr.shape[0]
    j = jnp.arange(capacity + 1, dtype=jnp.int32)
    cs0 = jnp.minimum(j, offsets[-1])
    return cs0, offsets, j[:capacity]


def char_map(col: StringColumn) -> CharMap:
    c = _cache(col)
    if "char_map" not in c:
        if is_ascii(col):
            cs0, char_offsets, char_pos = _char_map_ascii(
                col.offsets, col.data
            )
        else:
            cs0, char_offsets, char_pos = _char_map(col.data, col.offsets)
        c["char_map"] = CharMap(cs0, char_offsets, char_pos)
    return c["char_map"]


def char_counts(col: StringColumn) -> jax.Array:
    """Characters per row (nvstrings.len semantics, before null masking)."""
    return char_map(col).nchars()


def char_width_from_lead(b: jax.Array) -> jax.Array:
    """UTF-8 sequence length from its first byte (1..4), int32.

    Mirrors custring_view bytes_in_char (cpp/src/custring_view.inl).
    """
    b = b.astype(jnp.int32)
    return (
        1
        + (b >= 0xC0).astype(jnp.int32)
        + (b >= 0xE0).astype(jnp.int32)
        + (b >= 0xF0).astype(jnp.int32)
    )


def _shift_left(x: jax.Array, k: int) -> jax.Array:
    """x shifted k positions toward index 0, zero-filled (elementwise copy,
    not a gather)."""
    if k == 0:
        return x
    if k >= x.shape[0]:
        return jnp.zeros_like(x)
    return jnp.concatenate([x[k:], jnp.zeros(k, x.dtype)])


@jax.jit
def _codepoints_at_bytes(data):
    """int32[capacity]: the codepoint whose UTF-8 sequence STARTS at byte j
    (garbage at continuation bytes).  Pure shifts — no gathers."""
    b0 = data.astype(jnp.int32)
    b1 = _shift_left(data, 1).astype(jnp.int32) & 0x3F
    b2 = _shift_left(data, 2).astype(jnp.int32) & 0x3F
    b3 = _shift_left(data, 3).astype(jnp.int32) & 0x3F
    w = char_width_from_lead(b0)
    cp1 = b0
    cp2 = ((b0 & 0x1F) << 6) | b1
    cp3 = ((b0 & 0x0F) << 12) | (b1 << 6) | b2
    cp4 = ((b0 & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3
    return jnp.select([w == 1, w == 2, w == 3], [cp1, cp2, cp3], cp4)


@jax.jit
def _codepoints(data, char_pos):
    """Decode codepoint for each char index c (garbage past total chars).

    Byte-position decode is pure shifts; ONE compaction gather moves it to
    char space."""
    return _codepoints_at_bytes(data)[char_pos]


def codepoints(col: StringColumn) -> jax.Array:
    """int32[capacity]: codepoint of the c-th character of the column.

    Only indices < total_chars are meaningful; the caller masks with the
    CharMap.  (chars <= bytes, so capacity bounds the char count — no sync.)
    """
    c = _cache(col)
    if "codepoints" not in c:
        if is_ascii(col):
            c["codepoints"] = col.data.astype(jnp.int32)
        else:
            cm = char_map(col)
            c["codepoints"] = _codepoints(col.data, cm.char_pos)
    return c["codepoints"]


def encode_codepoints(cp: jax.Array):
    """codepoint -> (bytes uint8[n,4], width int32[n]); inverse of decode.

    Mirrors custring_view Char_to_char (cpp/src/custring_view.inl).
    """
    cp = cp.astype(jnp.int32)
    w = jnp.select(
        [cp < 0x80, cp < 0x800, cp < 0x10000],
        [1, 2, 3],
        4,
    ).astype(jnp.int32)
    b1_1 = cp
    b1_2 = 0xC0 | (cp >> 6)
    b1_3 = 0xE0 | (cp >> 12)
    b1_4 = 0xF0 | (cp >> 18)
    byte0 = jnp.select([w == 1, w == 2, w == 3], [b1_1, b1_2, b1_3], b1_4)
    byte1 = jnp.select(
        [w == 2, w == 3],
        [0x80 | (cp & 0x3F), 0x80 | ((cp >> 6) & 0x3F)],
        0x80 | ((cp >> 12) & 0x3F),
    )
    byte2 = jnp.where(w == 3, 0x80 | (cp & 0x3F), 0x80 | ((cp >> 6) & 0x3F))
    byte3 = 0x80 | (cp & 0x3F)
    out = jnp.stack([byte0, byte1, byte2, byte3], axis=-1).astype(jnp.uint8)
    return out, w


def max_row_bytes(col: StringColumn) -> int:
    """Max row byte-length, bucketed for compile-cache stability (syncs)."""
    c = _cache(col)
    if "max_row_bytes" not in c:
        m = int(jnp.max(col.lengths())) if col.size else 0
        c["max_row_bytes"] = max(bucket_bytes(m), 8)
    return c["max_row_bytes"]


@partial(jax.jit, static_argnums=(2,))
def _padded_view(data, offsets, width):
    nrows = offsets.shape[0] - 1
    capacity = data.shape[0]
    starts = offsets[:-1][:, None]
    lens = (offsets[1:] - offsets[:-1])[:, None]
    k = jnp.arange(width, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(starts + k, capacity - 1)
    vals = data[idx]
    return jnp.where(k < lens, vals, jnp.uint8(0))


def padded_view(col: StringColumn, width: int | None = None) -> jax.Array:
    """uint8[rows, width] zero-padded row-major view.

    The reference reduced divergence by sorting strings by length
    (cpp/src/strings/NVStringsImpl.cu:255-270); the array analogue is this
    dense padded view, bucketed by max length, built by one XLA gather of
    row windows.
    """
    if width is None:
        width = max_row_bytes(col)
    c = _cache(col)
    key = ("padded", width)
    if key not in c:
        c[key] = _padded_view(col.data, col.offsets, width)
    return c[key]


@dataclasses.dataclass(frozen=True)
class LengthBucket:
    """One length class of a column's rows (static shapes throughout).

    idx_c   int32[capR] device — row ids to GATHER (padding slots repeat 0)
    idx_s   int32[capR] device — row ids to SCATTER (padding slots = nrows,
                                 landing in a dropped extra slot)
    idx_np  int64[nv]   host   — the real row ids, for host-side assembly
    vmask   bool[capR]  device — col.validity[idx] & real-slot
    width   int                — char width of this bucket's padded view
    nv      int                — number of real rows in the bucket
    """

    idx_c: jax.Array
    idx_s: jax.Array
    idx_np: np.ndarray
    vmask: jax.Array
    width: int
    nv: int


def _bucket_rows(n: int) -> int:
    """Row-count capacity bucket (8-row floor — Pallas row tile — instead
    of the 128-byte buffer floor, so a 1-row outlier bucket stays tiny)."""
    n = int(n)
    if n <= 8:
        return 8
    step = 1 << max((n - 1).bit_length() - 3, 0)
    return -(-n // step) * step


def _host_row_stats(col: StringColumn):
    """(nchars int64[N], validity bool[N]) on host — one cached D2H."""
    c = _cache(col)
    if "host_nchars" not in c:
        cm = char_map(col)
        nch, val = jax.device_get((cm.nchars(), col.validity))
        c["host_nchars"] = np.asarray(nch)
        c["host_validity"] = np.asarray(val)
    return c["host_nchars"], c["host_validity"]


def length_buckets(
    col: StringColumn,
    max_buckets: int = 4,
    gain: float = 0.6,
    min_rows: int = 256,
) -> list[LengthBucket] | None:
    """Partition rows by length so one long outlier stops taxing every row.

    SURVEY §7.0.1 / VERDICT r1 item 7.  The reference reduced divergence by
    sorting strings by length (NVStringsImpl.cu:255-270); the array analogue
    is running the width-sensitive engines once per length class, each at
    its own padded width, and scattering results back by row id.

    Buckets use a powers-of-4 width ladder below the global max; tiny
    buckets merge upward.  Returns None when bucketing would not cut the
    padded work to < `gain` of the single-width cost (then callers use the
    plain global-width path).
    """
    c = _cache(col)
    key = ("length_buckets", max_buckets, gain)
    if key in c:
        return c[key]
    if isinstance(col.data, jax.core.Tracer):
        return None  # host stats unavailable inside a traced program
    res = None
    n = col.size
    if n >= min_rows:
        nch, val = _host_row_stats(col)
        w_full = max(bucket_bytes(int(nch.max(initial=0))), 8)
        ladder = [w_full]
        while len(ladder) < max_buckets and ladder[-1] > 32:
            ladder.append(max(bucket_bytes(ladder[-1] // 4), 8))
        ladder = sorted(set(ladder))  # ascending widths
        # smallest ladder width >= row length
        asn = np.searchsorted(np.asarray(ladder), nch, side="left")
        counts = np.bincount(asn, minlength=len(ladder))
        # merge tiny buckets upward (into the next wider class)
        for b in range(len(ladder) - 1):
            if 0 < counts[b] < max(min_rows // 2, 64):
                asn[asn == b] = b + 1
                counts[b + 1] += counts[b]
                counts[b] = 0
        cost_flat = n * w_full
        cost_bk = sum(
            _bucket_rows(int(counts[b])) * ladder[b]
            for b in range(len(ladder))
            if counts[b]
        )
        if len(ladder) > 1 and counts[-1] < n and cost_bk < gain * cost_flat:
            out = []
            for b in range(len(ladder)):
                if not counts[b]:
                    continue
                idx = np.nonzero(asn == b)[0]
                nv = len(idx)
                cap = _bucket_rows(nv)
                idx_c = np.zeros(cap, np.int32)
                idx_c[:nv] = idx
                idx_s = np.full(cap, n, np.int32)
                idx_s[:nv] = idx
                vmask = np.zeros(cap, np.bool_)
                vmask[:nv] = val[idx]
                out.append(
                    LengthBucket(
                        jnp.asarray(idx_c),
                        jnp.asarray(idx_s),
                        idx,
                        jnp.asarray(vmask),
                        int(ladder[b]),
                        nv,
                    )
                )
            res = out
    c[key] = res
    return res


@partial(jax.jit, static_argnums=(3,))
def _char_matrix_rows(cps, char_offsets, idx, width):
    ncap = cps.shape[0]
    nch = char_offsets[idx + 1] - char_offsets[idx]
    j = jnp.arange(width, dtype=jnp.int32)[None, :]
    g = jnp.clip(char_offsets[idx][:, None] + j, 0, max(ncap - 1, 0))
    mat = jnp.where(j < nch[:, None], cps[g], 0)
    return mat, nch


def char_matrix_rows(col: StringColumn, bucket: LengthBucket):
    """char_matrix() restricted to one LengthBucket's rows at its width."""
    c = _cache(col)
    key = ("char_matrix_rows", bucket.width, bucket.nv)
    if key not in c:
        cm = char_map(col)
        c[key] = _char_matrix_rows(
            codepoints(col), cm.char_offsets, bucket.idx_c, bucket.width
        )
    return c[key]


def gather_bytes(data: jax.Array, idx: jax.Array) -> jax.Array:
    """Safe byte gather with clamped indices."""
    return data[jnp.clip(idx, 0, data.shape[0] - 1)]


def set_row_nonascii_hint(col: StringColumn, ids) -> None:
    """Pin the column's non-ASCII row-id list (for traced columns)."""
    _cache(col)["nonascii_rows"] = np.asarray(ids, np.int64)


@jax.jit
def _row_nonascii(data, offsets):
    hi0 = jnp.zeros(data.shape[0] + 1, jnp.int32).at[1:].set(
        _cumsum((data >= 0x80).astype(jnp.int32))
    )
    return (hi0[offsets[1:]] - hi0[offsets[:-1]]) > 0


def row_nonascii_ids(col: StringColumn):
    """Host int64[k]: ids of rows containing any non-ASCII byte; None when
    the column is traced and no hint was pinned."""
    c = _cache(col)
    if "nonascii_rows" not in c:
        if isinstance(col.data, jax.core.Tracer):
            return None
        if c.get("is_ascii"):
            c["nonascii_rows"] = np.zeros(0, np.int64)
        else:
            mask = jax.device_get(_row_nonascii(col.data, col.offsets))
            c["nonascii_rows"] = np.nonzero(np.asarray(mask))[0]
    return c["nonascii_rows"]


@partial(jax.jit, static_argnums=(2,))
def _char_matrix_rowwise(P, nbytes, width):
    """Char matrix for a small [rows, width] padded BYTE matrix: decode
    codepoints at every position via axis-1 shifts, then compact the
    char starts within each row (all work is O(rows x width))."""
    n = P.shape[0]
    k = jnp.arange(width, dtype=jnp.int32)[None, :]
    inrow = k < nbytes[:, None]

    def sh(x, t):
        return jnp.pad(x[:, t:], ((0, 0), (0, t))) if t else x

    b0 = P.astype(jnp.int32)
    b1 = sh(P, 1).astype(jnp.int32) & 0x3F
    b2 = sh(P, 2).astype(jnp.int32) & 0x3F
    b3 = sh(P, 3).astype(jnp.int32) & 0x3F
    w = char_width_from_lead(b0)
    cp = jnp.select(
        [w == 1, w == 2, w == 3],
        [b0, ((b0 & 0x1F) << 6) | b1, ((b0 & 0x0F) << 12) | (b1 << 6) | b2],
        ((b0 & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3,
    )
    starts = ((P & 0xC0) != 0x80) & inrow
    rank = jnp.cumsum(starts.astype(jnp.int32), axis=1) - 1
    ri = jnp.arange(n, dtype=jnp.int32)[:, None]
    tgt = jnp.where(starts, rank, width)
    out = jnp.zeros((n, width + 1), jnp.int32).at[ri, tgt].set(
        jnp.where(starts, cp, 0)
    )[:, :width]
    return out, starts.sum(axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnums=(4,))
def _char_matrix_hybrid(data, offsets, lens, na_rows, width: int):
    """ASCII-dominant columns: the padded byte view IS the char matrix for
    ASCII rows (codepoint == byte); only the non-ASCII rows re-run the
    decode+compact, then overwrite their rows (a rows-count-sized scatter).
    The general path instead builds the column-wide char map (a prefix
    sum and a compaction scatter over every byte) before its gather."""
    view = _padded_view(data, offsets, width)
    mat = view.astype(jnp.int32)
    nch = lens
    if na_rows.shape[0]:
        mat_na, nch_na = _char_matrix_rowwise(
            view[na_rows], lens[na_rows], width
        )
        mat = mat.at[na_rows].set(mat_na)
        nch = nch.at[na_rows].set(nch_na)
    return mat, nch


def char_matrix(col: StringColumn, width: int | None = None):
    """(int32[rows, width] codepoint matrix 0-padded, int32[rows] nchars).

    The dense char-major view consumed by the regex executors and DP
    kernels; cached per column+width."""
    if width is None:
        width = max_row_bytes(col)
    c = _cache(col)
    key = ("char_matrix", width)
    if (
        key not in c
        and not isinstance(col.data, jax.core.Tracer)
        and col.size * width * 4 > 2 * PLANE_CACHE_BUDGET
    ):
        # over-budget matrix (e.g. 4.3 GB at the 4M tier): build without
        # memoizing so the column does not pin it for its lifetime
        return _char_matrix_build(col, width)
    if key not in c:
        c[key] = _char_matrix_build(col, width)
    return c[key]


def _char_matrix_build(col: StringColumn, width: int):
    na = row_nonascii_ids(col)
    if na is not None and len(na) * 8 <= max(col.size, 1):
        return _char_matrix_hybrid(
            col.data,
            col.offsets,
            col.lengths(),
            jnp.asarray(na, jnp.int32),
            width,
        )
    cm = char_map(col)
    cps = codepoints(col)
    ncap = cps.shape[0]
    nch = cm.nchars()
    j = jnp.arange(width, dtype=jnp.int32)[None, :]
    g = jnp.clip(
        cm.char_offsets[:-1][:, None] + j, 0, max(ncap - 1, 0)
    )
    mat = jnp.where(j < nch[:, None], cps[g], 0)
    return mat, nch
