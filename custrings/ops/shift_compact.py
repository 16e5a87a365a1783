"""Monotone moves in plain XLA: stream compaction / expansion.

Both are one scatter of the live elements to their targets; the targets
of a stable compaction (rank among the kept) and of a monotone expansion
(j + dist[j], dist nondecreasing) are distinct, so each output slot is
written at most once.

Every capacity-sized byte mover in the package routes through here: the
split writer, charwise byte layout, literal and regex replace, the
char-position map.  Reference analogue: the two-pass size→scan→write
pattern (cpp/src/strings/split.cu:199-220).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import segments


def compact_arrays(keep: jax.Array, arrays):
    """Stably move kept elements to the front of each array.

    keep: bool[N]; arrays: list of 1-D arrays of length N sharing the mask.
    Returns (compacted list, k0) where k0 = int32[N+1] exclusive prefix
    count of keep; positions >= k0[-1] of each output are zero-filled."""
    N = keep.shape[0]
    k0 = jnp.concatenate([jnp.zeros(1, jnp.int32), segments.cumsum(keep)])
    idx = jnp.where(keep, k0[:N], N)
    out = [jnp.zeros(N, a.dtype).at[idx].set(a, mode="drop") for a in arrays]
    return out, k0


def expand_to(live, dist, arrays, out_cap: int):
    """Move live element j RIGHT to position j + dist[j] of an out_cap
    output.  dist must be >= 0 and nondecreasing over live elements;
    targets past out_cap are dropped.  Returns (moved list, placed mask);
    unplaced slots are zero-filled."""
    N = live.shape[0]
    j = jnp.arange(N, dtype=jnp.int32)
    idx = jnp.where(live, j + dist.astype(jnp.int32), out_cap)
    moved = [
        jnp.zeros(out_cap, a.dtype).at[idx].set(a, mode="drop")
        for a in arrays
    ]
    placed = jnp.zeros(out_cap, jnp.bool_).at[idx].set(True, mode="drop")
    return moved, placed


def expand_arrays(live: jax.Array, dist: jax.Array, arrays):
    """expand_to with the output the size of the input (the caller sizes
    the arrays to the output domain and pads the tail with dead lanes)."""
    return expand_to(live, dist, arrays, live.shape[0])


def cover_spans(bb, ee, okm, cap: int):
    """bool[cap] cover mask of the [bb, ee) spans (disjoint, ordered in
    flat order): +-1 boundary deltas scattered, then one prefix sum."""
    sb = jnp.where(okm, bb, cap).reshape(-1)
    se = jnp.where(okm, ee, cap).reshape(-1)
    okf = okm.reshape(-1) & (se > sb)
    A = (
        jnp.zeros(cap + 1, jnp.int32)
        .at[jnp.where(okf, sb, cap)].add(1)
        .at[jnp.where(okf, se, cap)].add(-1)
    )
    return segments.cumsum(A[:cap]) > 0


def stream_expand_spans(stream, total_live, starts, sizes, okf, out_cap):
    """Expand a compacted byte stream into per-span output slots.

    stream: uint8[dom] — span payload bytes back to back (span order =
    the flat order of okf).  starts/sizes/okf: flat output start, byte
    size, and liveness per span.  The expand distance is per-span
    constant c_k = starts_k - rank_k (nondecreasing because output
    positions strictly increase over spans); materialized over the
    stream domain with a telescoping delta scatter + one prefix sum.
    Returns uint8[out_cap] with zeros outside the spans.
    """
    dom = stream.shape[0]
    nS = okf.shape[0]
    # zero-size spans own no stream bytes
    okf = okf & (sizes > 0)
    sz_f = jnp.where(okf, sizes, 0)
    rank0 = segments.cumsum(sz_f) - sz_f  # rank of each span's 1st byte
    c = (starts - rank0).astype(jnp.int32)
    # valid spans' (c, rank0) in span order: a compaction, not a scatter
    (cc, rr), k0v = compact_arrays(okf, [c, rank0])
    nv = k0v[-1]
    iv = jnp.arange(nS, dtype=jnp.int32)
    dlt = jnp.where(iv < nv, cc - jnp.where(iv > 0, jnp.roll(cc, 1), 0), 0)
    okd = iv < nv
    dplane = jnp.zeros(dom + 1, jnp.int32).at[
        jnp.where(okd, jnp.minimum(rr, dom), dom)
    ].add(dlt)
    dist = segments.cumsum(dplane[:dom])
    live = jnp.arange(dom, dtype=jnp.int32) < total_live
    (plane,), _ = expand_to(live, dist, [stream], out_cap)
    return plane
