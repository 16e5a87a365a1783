"""Pallas (Triton) kernel: the bit-parallel lockstep NFA (contains/match).

For programs of at most 32 instructions the whole NFA state of a row is
one uint32 bitmask.  One kernel lane owns one row and walks it position
by position: the reference's thread-per-string Pike-VM walk
(cpp/src/regex/regexec.inl, the Relist bitmask form).  Each program
instance takes BLOCK consecutive rows; the per-position inputs are laid
out position-major ([L, rows]) so that every step's loads of a block are
one contiguous, coalesced read.

Per (row, position) tables stay outside the kernel, computed by XLA:

    memb   uint32  bit i = char at p is in inst i's class (CCLASS/NCCLASS)
    uid    int32   closure-variant id of the position's context
                   (BOS, newline, EOS, word boundary), only when the
                   program has more than one closure variant

and every program table (closure rows, consume rows, start/end sets,
literal chars) is baked into the kernel as Python-int constants.  The
XLA engine (device.DeviceProgram.nfa_matches) runs the same recurrence as
one HLO loop step per position with the [rows, I] state in device memory;
it is the reference these kernels are tested against.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .compiler import ANY, ANYNL, CCLASS, CHAR, NCCLASS

#: rows per kernel program (one row per lane; a power of two for Triton)
BLOCK = 256
#: largest program whose state fits one uint32
MAX_BIT_INSTS = 32


def bit_supported(dp) -> bool:
    """Can this program run on the bit-parallel kernels?"""
    return dp.I <= MAX_BIT_INSTS


def pred_bits(u32, cur, memb, tabs):
    """Per-lane consume-predicate bitmask: class planes + baked literal,
    ANY and ANYNL tests; the 0 sentinel consumes nothing."""
    pred = memb
    for i, a in tabs.char_pairs:
        pred = pred | ((cur == a).astype(u32) << i)
    if tabs.any_bits:
        pred = pred | (
            (u32(0) - ((cur != 10) & (cur != 0)).astype(u32))
            & u32(tabs.any_bits)
        )
    if tabs.anynl_bits:
        pred = pred | (
            (u32(0) - (cur != 0).astype(u32)) & u32(tabs.anynl_bits)
        )
    return pred & (u32(0) - (cur != 0).astype(u32))


def closure_row(u32, tabs, i, uidv, like):
    """Closure row of inst i (bitmask of insts it reaches by epsilon
    moves), selected per lane by the context's closure variant."""
    if tabs.U == 1:
        return u32(tabs.crows[0][i])
    row = jnp.full_like(like, u32(tabs.crows[0][i]))
    for u in range(1, tabs.U):
        row = jnp.where(uidv == u, u32(tabs.crows[u][i]), row)
    return row


def close_forward(u32, tabs, state, uidv):
    """Epsilon closure of a state set: OR of the reach rows of its insts."""
    closed = jnp.zeros_like(state)
    for i in range(tabs.I):
        m = u32(0) - ((state >> i) & u32(1))
        closed = closed | (m & closure_row(u32, tabs, i, uidv, state))
    return closed


def consume_forward(u32, tabs, fire):
    """Successor set of the insts that consumed the current char."""
    nstate = jnp.zeros_like(fire)
    for i in range(tabs.I):
        m = u32(0) - ((fire >> i) & u32(1))
        nstate = nstate | (m & u32(tabs.nrows[i]))
    return nstate


class BitTables:
    """A DeviceProgram's tables as Python ints, for programs of at most
    32 instructions, plus the per-position table builder."""

    def __init__(self, dp):
        if not bit_supported(dp):
            raise ValueError(
                f"program has {dp.I} instructions; the bit kernels take "
                f"at most {MAX_BIT_INSTS}"
            )
        self.dp = dp
        prog = dp.prog
        I = self.I = dp.I
        cu = np.asarray(jax.device_get(dp.closure_unique)) > 0.5
        self.U = cu.shape[0]
        self.crows = tuple(
            tuple(
                sum(1 << j for j in range(I) if cu[u, i, j])
                for i in range(I)
            )
            for u in range(self.U)
        )
        nm = np.asarray(jax.device_get(dp.next_mat)) > 0.5
        self.nrows = tuple(
            sum(1 << j for j in range(I) if nm[i, j]) for i in range(I)
        )
        sv = np.asarray(jax.device_get(dp.start_vec)) > 0.5
        self.start_bits = sum(1 << i for i in range(I) if sv[i])
        ie = np.asarray(jax.device_get(dp.is_end)) > 0.5
        self.end_bits = sum(1 << i for i in range(I) if ie[i])
        self.char_pairs = tuple(
            (i, int(prog.args[i])) for i in range(I) if prog.types[i] == CHAR
        )
        self.any_bits = sum(1 << i for i in range(I) if prog.types[i] == ANY)
        self.anynl_bits = sum(
            1 << i for i in range(I) if prog.types[i] == ANYNL
        )
        # Affine bit-pack of per-inst class membership into one uint32:
        # memb_i = in_class[cls_of[i]] XOR is_ncc[i], so the word is
        # B + sum_c in_class_c * A[c] (mod 2^32) with per-bit-disjoint
        # coefficients (each bit belongs to one inst => no carries).
        n_cls = max(len(prog.classes), 1)
        A = [0] * n_cls
        B = 0
        for i in range(I):
            t = prog.types[i]
            if t not in (CCLASS, NCCLASS):
                continue
            c = int(prog.args[i])
            if t == NCCLASS:
                B += 1 << i
                A[c] -= 1 << i  # mod 2^32 below: +in_class*(-2^i)
            else:
                A[c] += 1 << i
        self.memb_A = jnp.asarray(np.asarray(A, np.int64) % (1 << 32),
                                  dtype=jnp.uint32)
        self.memb_B = jnp.asarray(np.uint32(B % (1 << 32)))
        self.ctx_map = dp.ctx_map.astype(jnp.int32)

    def pos_tables(self, chars, lengths, ascii: bool):
        """Position-major per-(position, row) tables for a [N, L] char
        matrix: (chars_t int32[L, N], memb_t uint32[L, N],
        uid_t int32[L+1, N] or None when the program has one closure
        variant).  Positions include the EOS sentinel in uid."""
        dp = self.dp
        N, L = chars.shape
        in_class = dp._class_membership(chars, ascii)  # [N, L, n_cls]
        memb = (
            jnp.tensordot(
                in_class.astype(jnp.uint32), self.memb_A, axes=([2], [0])
            )
            + self.memb_B
        )
        uid_t = None
        if self.U > 1:
            if ascii:
                alnum = (chars > 0) & dp._lut128_hit(chars, dp.alnum_ascii)
            else:
                from ..unicode.tables import FLAG_ALPHANUM, device_tables

                flags, _ = device_tables()
                safe = jnp.clip(chars, 0, flags.shape[0] - 1)
                alnum = (
                    (chars > 0)
                    & (chars < flags.shape[0])
                    & ((flags[safe].astype(jnp.int32) & FLAG_ALPHANUM) > 0)
                )
            alnum = alnum.astype(jnp.int32)
            pos = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
            lensE = lengths[:, None]
            curc = jnp.pad(chars, ((0, 0), (0, 1)))
            curc = jnp.where(pos < lensE, curc, 0)
            prevc = jnp.pad(chars, ((0, 0), (1, 0)))[:, : L + 1]
            prevc = jnp.where((pos > 0) & (pos - 1 < lensE), prevc, 0)
            al_cur = jnp.pad(alnum, ((0, 0), (0, 1)))
            al_cur = jnp.where(pos < lensE, al_cur, 0)
            al_prev = jnp.pad(alnum, ((0, 0), (1, 0)))[:, : L + 1]
            al_prev = jnp.where((pos > 0) & (pos - 1 < lensE), al_prev, 0)
            ctx = (
                (pos == 0).astype(jnp.int32) * 1
                + (prevc == 10).astype(jnp.int32) * 2
                + (curc == 0).astype(jnp.int32) * 4
                + (curc == 10).astype(jnp.int32) * 8
                + (al_cur != al_prev).astype(jnp.int32) * 16
            )
            uid_t = self.ctx_map[ctx].T
        return chars.astype(jnp.int32).T, memb.T, uid_t

    def padded_inputs(self, chars, lengths, extra, ascii: bool):
        """Pad rows to a BLOCK multiple and build the position-major
        tables.  extra: [N] int32 per-row planes (padded with -1)."""
        N = chars.shape[0]
        pad = -N % BLOCK
        if pad:
            chars = jnp.pad(chars, ((0, pad), (0, 0)))
            lengths = jnp.pad(lengths, (0, pad))
            extra = [jnp.pad(x, (0, pad), constant_values=-1) for x in extra]
        chars_t, memb_t, uid_t = self.pos_tables(chars, lengths, ascii)
        return (
            N + pad,
            chars_t,
            lengths.astype(jnp.int32),
            [x.astype(jnp.int32) for x in extra],
            memb_t,
            uid_t,
        )


def row_call(kernel, NP, L, n_row_in, has_uid, n_out, out_dtype, interpret):
    """pallas_call over row blocks: per-position planes [L(+1), NP] are
    blocked along rows, per-row vectors [NP] likewise."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    plane = pl.BlockSpec((L, BLOCK), lambda i: (0, i))
    vec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    in_specs = [plane] + [vec] * n_row_in + [plane]
    if has_uid:
        in_specs.append(pl.BlockSpec((L + 1, BLOCK), lambda i: (0, i)))
    out = jax.ShapeDtypeStruct((NP,), out_dtype)
    return pl.pallas_call(
        kernel,
        out_shape=[out] * n_out if n_out > 1 else out,
        grid=(NP // BLOCK,),
        in_specs=in_specs,
        out_specs=[vec] * n_out if n_out > 1 else vec,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
    )


def _match_kernel(tabs, L: int, anchored: bool):
    u32 = jnp.uint32

    def kernel(chars_ref, lens_ref, memb_ref, *rest):
        uid_ref = rest[0] if tabs.U > 1 else None
        out_ref = rest[-1]
        lens_v = lens_ref[...]

        def step(p, carry):
            state, matched = carry
            pc = jnp.minimum(p, L - 1)
            cur = jnp.where(p < lens_v, chars_ref[pc, :], 0)
            if anchored:
                inj = (p == 0) & (matched == 0)
            else:
                # starts only at positions 0..len (p = len is EOS)
                inj = (matched == 0) & (p <= lens_v)
            state = state | (u32(tabs.start_bits) * inj.astype(u32))
            uidv = uid_ref[p, :] if uid_ref is not None else None
            closed = close_forward(u32, tabs, state, uidv)
            matched = matched | ((closed & u32(tabs.end_bits)) != 0).astype(
                u32
            )
            fire = closed & pred_bits(u32, cur, memb_ref[pc, :], tabs)
            return consume_forward(u32, tabs, fire), matched

        zero = jnp.zeros_like(lens_v).astype(u32)
        _, matched = jax.lax.fori_loop(0, L + 1, step, (zero, zero))
        out_ref[...] = matched.astype(jnp.int32)

    return kernel


class BitNFA:
    """Bit-parallel boolean matcher for one program (<= 32 insts)."""

    def __init__(self, dp):
        self.tabs = BitTables(dp)

    @partial(jax.jit, static_argnums=(0, 3, 4, 5))
    def matches(self, chars, lengths, anchored: bool, ascii: bool = False,
                interpret: bool = False):
        """bool[N]: the DeviceProgram.nfa_matches contract."""
        N, L = chars.shape
        if N == 0:
            return jnp.zeros((0,), jnp.bool_)
        tabs = self.tabs
        with jax.enable_x64(False):
            NP, chars_t, lens, _, memb_t, uid_t = tabs.padded_inputs(
                chars, lengths, [], ascii
            )
            call = row_call(
                _match_kernel(tabs, L, anchored), NP, L, 1,
                uid_t is not None, 1, jnp.int32, interpret,
            )
            args = [chars_t, lens, memb_t] + (
                [uid_t] if uid_t is not None else []
            )
            out = call(*args)
        return out[:N] > 0
