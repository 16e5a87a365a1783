"""Pallas (Triton) kernels: bit-parallel span extraction (begins + ends).

The min-plus span engine (device.nfa_spans) carries an int32 min-begin
PER INSTRUCTION per row — [N, I] int32 state.  These kernels keep the
bit-NFA state of regex/pallas_nfa.py (one uint32 per row, one row per
lane) and split span extraction into two bit passes:

  backward pass   B_p = "injecting the start state at position p leads
                  to END somewhere in the suffix" — computed by running
                  the SAME program tables through the reversed
                  recurrence

                     t    = { i : next(i) ∩ B_{p+1} ≠ ∅ }
                     B_p  = { i : closure_ctx(p)(i) ∩ ((t ∧ pred(c_p))
                                                       ∨ END) ≠ ∅ }

                  so S[p] = start_bits ∩ B_p ≠ ∅ marks every position
                  where SOME match begins.  The leftmost begin b0 is
                  exact for ALL patterns (earlier starts always have
                  higher priority in the reference Pike VM,
                  regexec.inl:279-362).

  forward pass    inject only at p == b0; the LAST end fired is the
                  leftmost-longest end.

End selection by "last fire" equals the reference's priority semantics
exactly when the program is `longest_safe` (greedy-only: priority ==
longest) or `end_unique` (at most one end per begin, e.g. `the|that`) —
the compiler certifies both (compiler.py).  Other programs keep the
ordered/DFS engines.

Reference analogue: dreprog::find's single forward walk per string
(cpp/src/regex/regexec.inl:204-442); the backward pass has no reference
counterpart — it is what makes the begin search data-parallel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .pallas_nfa import (
    BitTables,
    bit_supported,
    close_forward,
    closure_row,
    consume_forward,
    pred_bits,
    row_call,
)


def _back_kernel(tabs, L: int):
    """Backward scan: b0 = leftmost begin >= w (-1 none)."""
    u32 = jnp.uint32

    def kernel(chars_ref, lens_ref, w_ref, memb_ref, *rest):
        uid_ref = rest[0] if tabs.U > 1 else None
        out_ref = rest[-1]
        lens_v = lens_ref[...]
        w_v = w_ref[...]

        def step(k, carry):
            Bn, b0 = carry  # Bn = B_{p+1}; b0 = min begin so far
            p = L - k
            pc = jnp.minimum(p, L - 1)
            cur = jnp.where(p < lens_v, chars_ref[pc, :], 0)
            # t: insts whose consume successors intersect B_{p+1}
            t = jnp.zeros_like(Bn)
            for i in range(tabs.I):
                if tabs.nrows[i]:
                    t = t | (
                        ((Bn & u32(tabs.nrows[i])) != 0).astype(u32) << i
                    )
            pred = pred_bits(u32, cur, memb_ref[pc, :], tabs)
            end_ok = (u32(0) - (p <= lens_v).astype(u32)) & u32(
                tabs.end_bits
            )
            t2 = (t & pred) | end_ok
            uidv = uid_ref[p, :] if uid_ref is not None else None
            B = jnp.zeros_like(Bn)
            for i in range(tabs.I):
                row = closure_row(u32, tabs, i, uidv, Bn)
                B = B | (((t2 & row) != 0).astype(u32) << i)
            sbit = (
                ((B & u32(tabs.start_bits)) != 0)
                & (p <= lens_v)
                & (p >= w_v)
            )
            return B, jnp.where(sbit, p, b0)

        B0 = jnp.zeros_like(lens_v).astype(u32)
        _, b0 = jax.lax.fori_loop(
            0, L + 1, step, (B0, jnp.full_like(lens_v, -1))
        )
        out_ref[...] = b0

    return kernel


def _fwd_end_kernel(tabs, L: int):
    """Forward scan injecting only at p == b0; records the LAST end
    fired (leftmost-longest end for certified programs)."""
    u32 = jnp.uint32

    def kernel(chars_ref, lens_ref, b0_ref, memb_ref, *rest):
        uid_ref = rest[0] if tabs.U > 1 else None
        out_ref = rest[-1]
        lens_v = lens_ref[...]
        b0_v = b0_ref[...]

        def step(p, carry):
            state, e0 = carry
            pc = jnp.minimum(p, L - 1)
            cur = jnp.where(p < lens_v, chars_ref[pc, :], 0)
            inj = p == b0_v  # b0 == -1 never injects
            state = state | (u32(tabs.start_bits) * inj.astype(u32))
            uidv = uid_ref[p, :] if uid_ref is not None else None
            closed = close_forward(u32, tabs, state, uidv)
            fired = (closed & u32(tabs.end_bits)) != 0
            e0 = jnp.where(fired, p, e0)
            fire = closed & pred_bits(u32, cur, memb_ref[pc, :], tabs)
            return consume_forward(u32, tabs, fire), e0

        s0 = jnp.zeros_like(lens_v).astype(u32)
        _, e0 = jax.lax.fori_loop(
            0, L + 1, step, (s0, jnp.full_like(lens_v, -1))
        )
        out_ref[...] = e0

    return kernel


class SpanBits:
    """Bit-parallel span executor for one certified program."""

    def __init__(self, dp):
        self.tabs = BitTables(dp)

    @partial(jax.jit, static_argnums=(0, 4, 5))
    def single(self, chars, lengths, start_pos, ascii: bool = False,
               interpret: bool = False):
        """Leftmost(-longest) first-match spans: the nfa_spans contract
        (matched bool[N], begin int32[N], end int32[N])."""
        N, L = chars.shape
        if N == 0:
            z = jnp.zeros((0,), jnp.int32)
            return jnp.zeros((0,), jnp.bool_), z, z
        start_pos = jnp.broadcast_to(jnp.asarray(start_pos, jnp.int32), (N,))
        tabs = self.tabs
        with jax.enable_x64(False):
            NP, chars_t, lens, (w,), memb_t, uid_t = tabs.padded_inputs(
                chars, lengths, [start_pos], ascii
            )
            uid = [uid_t] if uid_t is not None else []
            has_uid = uid_t is not None
            b0 = row_call(
                _back_kernel(tabs, L), NP, L, 2, has_uid, 1, jnp.int32,
                interpret,
            )(chars_t, lens, w, memb_t, *uid)
            e0 = row_call(
                _fwd_end_kernel(tabs, L), NP, L, 2, has_uid, 1, jnp.int32,
                interpret,
            )(chars_t, lens, b0, memb_t, *uid)
        b = b0[:N]
        e = e0[:N]
        matched = (b >= 0) & (e >= 0)
        return (
            matched,
            jnp.where(matched, b, -1),
            jnp.where(matched, e, -1),
        )


def span_bits_ok(dp) -> bool:
    """Programs the bit span kernels serve: priority end == last-fire end,
    and the state fits one uint32."""
    prog = dp.prog
    return bool(prog.longest_safe or prog.end_unique) and bit_supported(dp)
