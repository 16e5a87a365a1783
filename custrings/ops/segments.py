"""Gather-free segment primitives for the flat byte domain.

Ops over the flat byte buffer derive per-byte row attributes from
boundary-sized (rows-count) scatters plus one cumsum instead of a
capacity-sized gather of `offsets[...][rows]`:

  broadcast_rows_to_bytes(v, offsets, cap)[j] == v[row_of(j)]
      by scattering per-row DELTAS (v[r] - v[r-1]) at the row-start
      positions and prefix-summing: a rows-sized scatter-add + one
      capacity-sized cumsum, instead of a capacity-sized gather.
      Works for arbitrary (non-monotone) int vectors; coincident starts
      from empty rows stack their deltas so the owning (last) row wins.

  row_start_positions / row_end_positions — offsets[:-1|1:][rows] without
      the gather (special cases of the broadcast).

  per_row_of_prefix — per-row totals of a byte-domain indicator from its
      prefix sum, differenced at the rows' boundary offsets (two
      rows-sized gathers instead of a capacity-sized scatter-add).

These replace the reference's per-thread pointer arithmetic
(cpp/src/custring_view.inl) with O(bytes) scan work.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "cumsum",
    "cummax",
    "broadcast_rows_to_bytes",
    "row_start_positions",
    "row_end_positions",
    "per_row_of_prefix",
]


def cumsum(x: jax.Array) -> jax.Array:
    """Inclusive int32 prefix sum of a bool / uint8 / int32 array.

    JAX lowers cumsum on every backend as one full-length reduce_window
    (window N, padding N-1); XLA's reduce-window rewriter turns that into
    a blocked scan of block sums rather than an O(N^2) window."""
    return jnp.cumsum(x.astype(jnp.int32))


def cummax(x: jax.Array) -> jax.Array:
    """Inclusive running maximum (lax.cummax: a reduce-window scan; the
    generic `associative_scan(jnp.maximum, ...)` form compiles to a much
    larger program)."""
    return jax.lax.cummax(x, axis=0)


def broadcast_rows_to_bytes(
    row_values: jax.Array, offsets: jax.Array, capacity: int
) -> jax.Array:
    """int32[capacity]: row_values[row_of(j)] for every byte position j.

    Equivalent to `row_values[row_ids_from_offsets(offsets, capacity)]`
    but with no capacity-sized gather.  Padding positions past offsets[-1]
    report the last row's value."""
    rv = row_values.astype(jnp.int32)
    deltas = jnp.concatenate([rv[:1], rv[1:] - rv[:-1]])
    acc = jnp.zeros(capacity + 1, jnp.int32).at[offsets[:-1]].add(deltas)
    return cumsum(acc[:capacity])


def row_start_positions(offsets: jax.Array, capacity: int) -> jax.Array:
    """int32[capacity]: byte position where j's row begins.

    Equivalent to offsets[:-1][row_ids] without the capacity-sized gather."""
    return broadcast_rows_to_bytes(offsets[:-1], offsets, capacity)


def row_end_positions(offsets: jax.Array, capacity: int) -> jax.Array:
    """int32[capacity]: byte position where j's row ends (exclusive).

    Equivalent to offsets[1:][row_ids] without the capacity-sized gather."""
    return broadcast_rows_to_bytes(offsets[1:], offsets, capacity)


def per_row_of_prefix(prefix0: jax.Array, offsets: jax.Array) -> jax.Array:
    """Per-row totals from a byte-domain prefix array.

    prefix0 is int32[capacity+1] with prefix0[j] = count in bytes [0, j).
    Returns prefix0[offsets[1:]] - prefix0[offsets[:-1]] — two rows-sized
    gathers instead of one capacity-sized scatter-add."""
    return prefix0[offsets[1:]] - prefix0[offsets[:-1]]


def compose_scan(T: jax.Array) -> jax.Array:
    """Inclusive scan of function composition: out[j] = T_j o ... o T_0.

    T is int32[B, m]: T[j] maps an incoming state s (< m) to T[j, s].
    Hillis-Steele doubling with take_along_axis — a manual loop instead of
    jax.lax.associative_scan, whose generated HLO intermittently
    segfaulted the CPU XLA compiler in long test processes."""
    B, m = T.shape
    comp = T
    ident = jnp.broadcast_to(jnp.arange(m, dtype=T.dtype), (1, m))
    s = 1
    while s < B:
        earlier = jnp.concatenate(
            [jnp.broadcast_to(ident, (min(s, B), m)), comp[:-s]], axis=0
        )[:B]
        # window ending at j = (earlier window) then (this window)
        comp = jnp.take_along_axis(comp, earlier, axis=1)
        s *= 2
    return comp
