"""Device-side regex executors.

Two array formulations of the reference's lockstep Pike-VM
(cpp/src/regex/regexec.inl:204-442):

1. `nfa_matches` — boolean/anchored matching (contains_re / match) as pure
   dense linear algebra: the active state set is a bool[rows, insts] matrix;
   the eps-closure for each anchor-context is PRECOMPUTED ON HOST into a
   [ctx, I, I] reachability tensor, so one char step is
   `state_closed = any(state & closure[ctx])` followed by per-inst char
   predicates and a next-pointer scatter.  No priorities are needed for a
   boolean result.  This path batches the whole column per char.

2. `run_spans` — the exact ordered-list executor (priority semantics,
   capture ranges, leftmost-first match) vmapped over rows; faithful to
   regexec.inl including list-order priority, first-activation dedup, and
   first-END-wins selection.

Both consume a padded codepoint matrix [rows, L] (+ lengths).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..unicode.tables import FLAG_ALPHANUM, device_tables, host_tables
from .compiler import (
    ANY,
    ANYNL,
    BOL,
    BOW,
    CCLASS,
    CHAR,
    END,
    EOL,
    LBRA,
    NBOW,
    NCCLASS,
    OR,
    Program,
    B_D,
    B_ND,
    B_NS,
    B_NW,
    B_S,
    B_W,
    RBRA,
)

# context bits for eps-edges
CTX_BOS = 1  # pos == 0
CTX_PREV_NL = 2  # prev char == '\n'
CTX_EOS = 4  # cur char == sentinel 0 (pos == len)
CTX_CUR_NL = 8  # cur char == '\n'
CTX_WB = 16  # word boundary (alnum(prev) != alnum(cur))


def _edge_active(ptype, parg, ctx):
    """Host: is the eps-edge of this inst active under ctx bits?"""
    if ptype in (LBRA, RBRA, OR):
        return True
    if ptype == BOL:
        if parg == ord("^"):
            return bool(ctx & (CTX_BOS | CTX_PREV_NL))
        return bool(ctx & CTX_BOS)
    if ptype == EOL:
        if parg == ord("$"):
            return bool(ctx & (CTX_EOS | CTX_CUR_NL))
        return bool(ctx & CTX_EOS)
    if ptype == BOW:
        return bool(ctx & CTX_WB)
    if ptype == NBOW:
        return not (ctx & CTX_WB)
    return False


def closure_tensor(prog: Program) -> np.ndarray:
    """bool[32, I, I]: closure[ctx, i, j] — starting AT inst i (including i
    itself), inst j is reachable via eps-edges under anchor context ctx and
    j is a consuming/END inst."""
    I = prog.n_insts
    out = np.zeros((32, I, I), np.bool_)
    consuming = np.isin(
        prog.types, (CHAR, ANY, ANYNL, CCLASS, NCCLASS, END)
    )
    for ctx in range(32):
        # adjacency under this context
        adj = np.zeros((I, I), np.bool_)
        for i in range(I):
            t = prog.types[i]
            if consuming[i]:
                continue
            if _edge_active(t, prog.args[i], ctx):
                adj[i, prog.next_ids[i]] = True
                if t == OR:
                    adj[i, prog.args[i]] = True
        # transitive closure (reflexive)
        reach = np.eye(I, dtype=np.bool_) | adj
        for _ in range(I.bit_length() + 1):
            nxt = reach | (reach @ reach)
            if (nxt == reach).all():
                break
            reach = nxt
        out[ctx] = reach & consuming[None, :]
    return out


def class_match_table(prog: Program) -> np.ndarray:
    """Host: bool[n_classes, 65536+1] membership incl. sentinel slot 65536
    treated as no-match; non-BMP handled on device via ranges only."""
    flags, _ = host_tables()
    n = len(prog.classes)
    cps = np.arange(65536, dtype=np.int64)
    fl = flags
    alnum = (fl & FLAG_ALPHANUM) > 0
    space = (fl & 16) > 0
    digit = (fl & 4) > 0
    tab = np.zeros((max(n, 1), 65536), np.bool_)
    for k, cls in enumerate(prog.classes):
        m = np.zeros(65536, np.bool_)
        r = cls.ranges
        for i in range(0, len(r), 2):
            lo, hi = r[i], min(r[i + 1], 65535)
            if lo < 65536:
                m[lo : hi + 1] = True
        b = cls.builtins
        if b & B_W:
            m |= alnum | (cps == ord("_"))
        if b & B_S:
            m |= space
        if b & B_D:
            m |= digit
        if b & B_NW:
            m |= (~alnum) & (cps != ord("_")) & (cps != ord("\n"))
        if b & B_NS:
            m |= ~space
        if b & B_ND:
            m |= (~digit) & (cps != ord("\n"))
        tab[k] = m
    return tab


class DeviceProgram:
    """Program tables uploaded once; executors close over them."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.I = prog.n_insts
        self.types = jnp.asarray(prog.types)
        self.next_ids = jnp.asarray(prog.next_ids)
        self.args = jnp.asarray(prog.args)
        self.start_ids = jnp.asarray(prog.start_ids)
        # dedupe the 32 context-closure matrices (patterns without anchors
        # have a single unique one) to avoid a [N, I, I] gather per char
        closure = closure_tensor(prog)
        uniq, ctx_map = [], np.zeros(32, np.int32)
        for ctx in range(32):
            for k, m in enumerate(uniq):
                if (m == closure[ctx]).all():
                    ctx_map[ctx] = k
                    break
            else:
                ctx_map[ctx] = len(uniq)
                uniq.append(closure[ctx])
        self.closure_unique = jnp.asarray(np.stack(uniq))
        self.ctx_map = jnp.asarray(ctx_map)
        self.class_tab = jnp.asarray(class_match_table(prog))
        # explicit class ranges at full codepoint width for non-BMP chars
        # (regexec.inl dreclass::is_match:128-133 compares ranges before the
        # 16-bit builtin-table gate; builtins return false above 0xFFFF)
        n_cls = max(len(prog.classes), 1)
        rmax = max(
            [len(c.ranges) // 2 for c in prog.classes] or [0]
        )
        lo = np.ones((n_cls, max(rmax, 1)), np.int32)
        hi = np.zeros((n_cls, max(rmax, 1)), np.int32)
        for k, cls in enumerate(prog.classes):
            r = cls.ranges
            for j in range(0, len(r), 2):
                lo[k, j // 2], hi[k, j // 2] = r[j], r[j + 1]
        self.cls_lo = jnp.asarray(lo)
        self.cls_hi = jnp.asarray(hi)
        # next-pointer matrix for the boolean path
        I = self.I
        nm = np.zeros((I, I), np.bool_)
        for i in range(I):
            if prog.types[i] in (CHAR, ANY, ANYNL, CCLASS, NCCLASS):
                nm[i, prog.next_ids[i]] = True
        self.next_mat = jnp.asarray(nm)
        self.is_end = jnp.asarray(prog.types == END)
        start = np.zeros(I, np.bool_)
        start[prog.start_ids] = True
        self.start_vec = jnp.asarray(start)
        self.groups_count = prog.groups_count
        # ASCII fast path: per-class membership over codepoints 0..127
        # packed into 4 uint32 words, evaluated with compares + shifts
        # instead of the 64K-table gather (the packed-bit test is
        # elementwise)
        tab128 = class_match_table(prog)[:, :128]
        packs = np.zeros((tab128.shape[0], 4), np.uint32)
        for w in range(4):
            for b in range(32):
                packs[:, w] |= tab128[:, w * 32 + b].astype(
                    np.uint32
                ) << np.uint32(b)
        self.cls_ascii = jnp.asarray(packs)
        flags_h, _ = host_tables()
        al128 = (flags_h[:128].astype(np.int64) & FLAG_ALPHANUM) > 0
        alp = np.zeros(4, np.uint32)
        for w in range(4):
            for b in range(32):
                alp[w] |= al128[w * 32 + b].astype(np.uint32) << np.uint32(b)
        self.alnum_ascii = jnp.asarray(alp)

    # ---------------- shared helpers ----------------

    @staticmethod
    def _lut128_hit(c, lut4):
        """bit c of a 128-bit set packed into 4 uint32 words; caller must
        guarantee 0 <= c < 128 (pure compares + shifts — no gather)."""
        sh = (c & 31).astype(jnp.uint32)
        word = jnp.where(
            c < 32,
            lut4[0],
            jnp.where(c < 64, lut4[1], jnp.where(c < 96, lut4[2], lut4[3])),
        )
        return ((word >> sh) & jnp.uint32(1)) > 0

    def _ctx_bits(self, prev_c, cur_c, is_bos, ascii: bool = False):
        if ascii:
            def alnum(c):
                return (c > 0) & self._lut128_hit(c, self.alnum_ascii)
        else:
            flags, _ = device_tables()

            def alnum(c):
                # word-boundary uses IS_ALPHANUM only (regexec.inl:323-329)
                safe = jnp.clip(c, 0, flags.shape[0] - 1)
                return (c > 0) & (c < flags.shape[0]) & (
                    (flags[safe].astype(jnp.int32) & FLAG_ALPHANUM) > 0
                )

        wb = alnum(prev_c) != alnum(cur_c)
        ctx = (
            is_bos.astype(jnp.int32) * CTX_BOS
            + (prev_c == ord("\n")).astype(jnp.int32) * CTX_PREV_NL
            + (cur_c == 0).astype(jnp.int32) * CTX_EOS
            + (cur_c == ord("\n")).astype(jnp.int32) * CTX_CUR_NL
            + wb.astype(jnp.int32) * CTX_WB
        )
        return ctx

    def _char_pred(self, c, ascii: bool = False):
        """bool[..., I]: does char c satisfy each consuming inst?"""
        types, args = self.types, self.args
        cE = c[..., None]
        is_char = types == CHAR
        is_any = types == ANY
        is_anynl = types == ANYNL
        is_cc = types == CCLASS
        is_ncc = types == NCCLASS
        in_class = self._class_membership(c, ascii)  # [..., n_classes]
        cls_id = jnp.clip(args, 0, self.class_tab.shape[0] - 1)
        cls_hit = in_class[..., cls_id]
        pred = (
            (is_char & (cE == args))
            | (is_any & (cE != ord("\n")) & (cE != 0))
            | (is_anynl & (cE != 0))
            | (is_cc & cls_hit)
            | (is_ncc & ~cls_hit)
        )
        # sentinel consumes nothing
        return pred & (cE != 0)

    def _class_membership(self, c, ascii: bool = False):
        """bool[..., n_classes] for char(s) c.

        BMP chars use the precomputed 64K table (ranges + builtins); chars
        >= 0x10000 compare against the explicit ranges at full codepoint
        width, builtins no-match — exactly dreclass::is_match
        (regexec.inl:127-154: range loop first, then `uni > 0xFFFF ->
        false` before any builtin test).

        ascii=True (caller guarantees every c < 128): packed-bit LUT test,
        no table gather."""
        if ascii:
            hits = [
                self._lut128_hit(c, self.cls_ascii[k])
                for k in range(self.cls_ascii.shape[0])
            ]
            return jnp.stack(hits, axis=-1)
        safe = jnp.clip(c, 0, 65535)
        hit = self.class_tab[:, safe]  # [n_classes, ...]
        hit = jnp.moveaxis(hit, 0, -1)
        cE = c[..., None, None]  # [..., 1, 1] vs [n_classes, rmax]
        hi_hit = jnp.any((cE >= self.cls_lo) & (cE <= self.cls_hi), axis=-1)
        return jnp.where(
            (c < 65536)[..., None],
            hit & (c >= 0)[..., None],
            hi_hit,
        )

    # ---------------- executor A: boolean ----------------

    @partial(jax.jit, static_argnums=(0, 3, 4))
    def nfa_matches(self, chars, lengths, anchored: bool, ascii: bool = False):
        """bool[rows]: does the pattern match anywhere (anchored: at 0)?

        chars: int32[rows, L] codepoints (0-padded); lengths int32[rows].
        ascii=True: caller guarantees every codepoint < 128; class and
        word-boundary predicates use packed-bit LUTs instead of table
        gathers (no capacity-sized table gathers).
        """
        N, L = chars.shape
        # derive all-False init from the inputs so the carry picks up any
        # varying manual axes when running inside shard_map
        never = lengths < 0
        state = jnp.zeros((N, self.I), jnp.bool_) ^ never[:, None]
        matched = never

        def step(p, carry):
            state, matched = carry
            cur = jnp.where(
                p < lengths, chars[:, jnp.minimum(p, L - 1)], 0
            )
            prev = jnp.where(
                (p > 0) & (p - 1 < lengths),
                chars[:, jnp.maximum(jnp.minimum(p - 1, L - 1), 0)],
                0,
            )
            if anchored:
                inject = (p == 0) & ~matched
            else:
                # starts exist only at positions 0..len (p=len is EOS);
                # padded sentinel slots past that must stay inert or
                # context insts (\B$) see a spurious prev=0 position
                inject = ~matched & (p <= lengths)
            state = state | (self.start_vec[None, :] & inject[:, None])
            ctx = self._ctx_bits(prev, cur, jnp.full(N, p == 0), ascii)
            uid = self.ctx_map[ctx]  # [N] unique-closure index
            # one matmul per UNIQUE closure matrix (usually 1), then select.
            # Precision of every 0/1 f32 matmul in this module: on the GPU
            # XLA may run f32 dots in TF32.  0 and 1 are exact in TF32 and
            # the products are summed in f32, so each sum (at most I terms,
            # I <= max_regex_insts = 1000, far below 2^11) is exact, and
            # callers only test it against 0: results are bit-exact.
            sf = state.astype(jnp.float32)
            closed = jnp.zeros_like(state)
            for k in range(self.closure_unique.shape[0]):
                ck = (
                    sf @ self.closure_unique[k].astype(jnp.float32)
                ) > 0
                closed = jnp.where((uid == k)[:, None], ck, closed)
            matched = matched | jnp.any(closed & self.is_end[None, :], axis=1)
            pred = self._char_pred(cur, ascii)  # [N, I]
            fire = (closed & pred).astype(jnp.float32)
            state = (fire @ self.next_mat.astype(jnp.float32)) > 0
            return state, matched

        state, matched = jax.lax.fori_loop(0, L + 1, step, (state, matched))
        return matched

    # ---------------- executor A1: chunked long-string matcher ----------

    @partial(jax.jit, static_argnums=(0, 3, 4, 5))
    def nfa_matches_chunked(self, chars, lengths, anchored: bool, G: int,
                            ascii: bool = False):
        """Long-string parallel matcher (SURVEY §5.7 "design fresh" item).

        The position loop of nfa_matches is a boolean-semiring linear
        recurrence, so a row can be cut into C chunks of G chars whose
        per-chunk transfer relations combine ASSOCIATIVELY: each chunk
        evolves, over its G positions,

          T [I, I]  entry state i -> state j at chunk end
          A [I]     entry state i reaches END inside the chunk
          S [I]     a start injected inside the chunk reaches state j
          M         a start injected inside the chunk reaches END inside

        and two segments compose as (∘ = boolean matmul)

          T = T1∘T2   A = A1 ∨ T1∘A2   S = S1∘T2 ∨ S2   M = M1 ∨ M2 ∨ S1·A2

        which is a monoid — chunks combine with lax.associative_scan in
        O(log C) depth.  Sequential depth falls from L to G + log2(C);
        work rises by a factor ≤ I (matrix vs vector evolution), spent in
        small matmuls.  No reference analogue (regexec.inl walks one thread
        per row); chunking is what makes one 1MB row tractable.

        Word-boundary/^/$ contexts stay exact: each chunk carries its
        preceding char, and the global BOS flag fires only at chunk 0,
        position 0.  Matches the vector engine bit-for-bit (parity fuzz in
        tests/test_regex.py::test_chunked_matches_parity).
        """
        N, L = chars.shape
        I = self.I
        C = max(-(-L // G), 1)
        Lp = C * G
        if Lp != L:
            chars = jnp.pad(chars, ((0, 0), (0, Lp - L)))
        goff = jnp.arange(C, dtype=jnp.int32)[None, :] * G  # [1, C]
        clen = jnp.clip(lengths[:, None] - goff, 0, G)  # [N, C]
        prev0 = jnp.where(
            (goff > 0) & (goff - 1 < lengths[:, None]),
            jnp.take_along_axis(chars, jnp.maximum(goff - 1, 0), axis=1),
            0,
        )  # [N, C] char before each chunk
        Nc = N * C
        ch = chars.reshape(Nc, G)
        clen_f = clen.reshape(Nc)
        prev0_f = prev0.reshape(Nc)
        cidx = jnp.arange(Nc, dtype=jnp.int32) % C
        glob0 = cidx == 0  # chunk 0 of row
        goff_f = cidx * G  # global position of chunk start
        len_f = jnp.broadcast_to(lengths[:, None], (N, C)).reshape(Nc)

        cu = self.closure_unique.astype(jnp.float32)  # [U, I, I]
        nm = self.next_mat.astype(jnp.float32)
        U = cu.shape[0]

        def select_close(x, uid, mat: bool):
            xf = x.astype(jnp.float32)
            out = None
            for k in range(U):
                ck = (xf @ cu[k]) > 0
                if out is None:
                    out = ck
                else:
                    cond = (uid == k)[:, None, None] if mat else (uid == k)[:, None]
                    out = jnp.where(cond, ck, out)
            return out

        def step(g, carry):
            T, A, S, M = carry
            cur = jnp.where(g < clen_f, ch[:, jnp.minimum(g, G - 1)], 0)
            prev = jnp.where(
                g == 0,
                prev0_f,
                jnp.where(
                    g - 1 < clen_f,
                    ch[:, jnp.maximum(jnp.minimum(g - 1, G - 1), 0)],
                    0,
                ),
            )
            bos = glob0 & (g == 0)
            ctx = self._ctx_bits(prev, cur, bos, ascii)
            uid = self.ctx_map[ctx]  # [Nc]
            inj = (goff_f + g) <= len_f  # no starts past EOS
            cS = select_close(
                S | (self.start_vec[None, :] & inj[:, None]), uid, False
            )
            cT = select_close(T, uid, True)
            M = M | jnp.any(cS & self.is_end[None, :], axis=1)
            A = A | jnp.any(cT & self.is_end[None, None, :], axis=2)
            pred = self._char_pred(cur, ascii)  # [Nc, I]
            S = ((cS & pred).astype(jnp.float32) @ nm) > 0
            T = ((cT & pred[:, None, :]).astype(jnp.float32) @ nm) > 0
            return T, A, S, M

        T0 = jnp.broadcast_to(jnp.eye(I, dtype=jnp.bool_), (Nc, I, I))
        A0 = jnp.zeros((Nc, I), jnp.bool_)
        M0 = jnp.zeros((Nc,), jnp.bool_)
        T, A, S, M = jax.lax.fori_loop(
            0, G, step, (T0, A0, jnp.zeros((Nc, I), jnp.bool_), M0)
        )

        T = T.reshape(N, C, I, I)
        A = A.reshape(N, C, I)
        S = S.reshape(N, C, I)
        M = M.reshape(N, C)

        def comb(x, y):
            T1, A1, S1, M1 = x
            T2, A2, S2, M2 = y
            bmm = lambda a, b: (
                a.astype(jnp.float32) @ b.astype(jnp.float32)
            ) > 0
            return (
                bmm(T1, T2),
                A1 | bmm(T1, A2[..., None])[..., 0],
                bmm(S1[..., None, :], T2)[..., 0, :] | S2,
                M1 | M2 | jnp.any(S1 & A2, axis=-1),
            )

        if C > 1:
            Tt, At, St, Mt = jax.lax.associative_scan(
                comb, (T, A, S, M), axis=1
            )
            T1, A1, S1, M1 = Tt[:, -1], At[:, -1], St[:, -1], Mt[:, -1]
        else:
            T1, A1, S1, M1 = T[:, 0], A[:, 0], S[:, 0], M[:, 0]

        sv = jnp.broadcast_to(self.start_vec, (N, I))
        if anchored:
            matched = jnp.any(sv & A1, axis=1)
            vend = (
                (sv.astype(jnp.float32)[:, None, :] @ T1.astype(jnp.float32))
                > 0
            )[:, 0, :]
        else:
            matched = M1
            # inject at the final EOS slot only for rows whose EOS IS there
            vend = S1 | (sv & (Lp <= lengths)[:, None])
        # final sentinel step at p = Lp (EOS context; consumes nothing)
        prevL = jnp.where(
            (Lp - 1 < lengths) & (Lp > 0), chars[:, Lp - 1], 0
        )
        ctx = self._ctx_bits(
            prevL, jnp.zeros(N, jnp.int32), jnp.full(N, Lp == 0), ascii
        )
        uid = self.ctx_map[ctx]
        vf = vend.astype(jnp.float32)
        closed = jnp.zeros_like(vend)
        for k in range(U):
            ck = (vf @ cu[k]) > 0
            closed = jnp.where((uid == k)[:, None], ck, closed)
        matched = matched | jnp.any(closed & self.is_end[None, :], axis=1)
        return matched

    # ---------------- executor A2: leftmost-longest spans ----------------

    def _closure_columns(self):
        """Static per-unique-closure incoming-column lists for the min-plus
        propagation (host side, cached)."""
        if not hasattr(self, "_ccols"):
            cu = np.asarray(jax.device_get(self.closure_unique))
            self._ccols = [
                [np.nonzero(cu[u][:, j])[0] for j in range(self.I)]
                for u in range(cu.shape[0])
            ]
            nm = np.zeros((self.I,), np.int64) - 1
            prog = self.prog
            self._next_cols = [[] for _ in range(self.I)]
            for i in range(self.I):
                if prog.types[i] in (CHAR, ANY, ANYNL, CCLASS, NCCLASS):
                    self._next_cols[prog.next_ids[i]].append(i)
            self._end_ids = np.nonzero(prog.types == END)[0]
        return self._ccols, self._next_cols, self._end_ids

    @partial(jax.jit, static_argnums=(0, 4))
    def nfa_spans(self, chars, lengths, start_pos, ascii: bool = False):
        """Leftmost-longest first-match spans for `longest_safe` programs.

        All begins are explored simultaneously: state = min begin per inst
        (INF inactive); candidates (begin, end=pos) reduce to (min begin,
        max end).  O(L) vectorized steps — the fast path replacing the
        ordered-list executor for unambiguous patterns.

        Returns (matched bool[N], begin int32[N], end int32[N]).
        """
        N, L = chars.shape
        INF = jnp.int32(1 << 28)
        ccols, next_cols, end_ids = self._closure_columns()
        U = len(ccols)

        def closure_minplus(beg, uid):
            outs = []
            for u in range(U):
                cols_out = []
                for j in range(self.I):
                    cols = ccols[u][j]
                    if len(cols) == 0:
                        cols_out.append(jnp.full((N,), INF))
                    elif len(cols) == 1:
                        cols_out.append(beg[:, cols[0]])
                    else:
                        cols_out.append(
                            jnp.min(beg[:, np.asarray(cols)], axis=1)
                        )
                outs.append(jnp.stack(cols_out, axis=1))
            if U == 1:
                return outs[0]
            res = outs[0]
            for u in range(1, U):
                res = jnp.where((uid == u)[:, None], outs[u], res)
            return res

        def step(p, carry):
            beg, best_b, best_e = carry
            cur = jnp.where(p < lengths, chars[:, jnp.minimum(p, L - 1)], 0)
            prev = jnp.where(
                (p > 0) & (p - 1 < lengths),
                chars[:, jnp.maximum(jnp.minimum(p - 1, L - 1), 0)],
                0,
            )
            # leftmost: min() prefers earlier begins; no starts past EOS
            inject = (p >= start_pos) & (p <= lengths)
            beg = beg.at[:, self.prog.start_ids].min(
                jnp.where(inject, p, INF)[:, None]
            )
            ctx = self._ctx_bits(prev, cur, jnp.full(N, p == 0), ascii)
            uid = self.ctx_map[ctx]
            closed = closure_minplus(beg, uid)
            # END candidates at this position
            if len(end_ids):
                b_end = jnp.min(closed[:, np.asarray(end_ids)], axis=1)
            else:
                b_end = jnp.full((N,), INF)
            better = b_end < best_b
            same = (b_end == best_b) & (b_end < INF)
            best_e = jnp.where(better | same, p, best_e)
            best_b = jnp.where(better, b_end, best_b)
            # consume
            pred = self._char_pred(cur, ascii)  # [N, I]
            fired = jnp.where(pred, closed, INF)
            nxt_out = []
            for j in range(self.I):
                cols = next_cols[j]
                if len(cols) == 0:
                    nxt_out.append(jnp.full((N,), INF))
                elif len(cols) == 1:
                    nxt_out.append(fired[:, cols[0]])
                else:
                    nxt_out.append(
                        jnp.min(fired[:, np.asarray(cols)], axis=1)
                    )
            beg = jnp.stack(nxt_out, axis=1)
            return beg, best_b, best_e

        beg0 = jnp.full((N, self.I), INF)
        bb0 = jnp.full((N,), INF)
        be0 = jnp.full((N,), -1, jnp.int32)
        beg, best_b, best_e = jax.lax.fori_loop(
            0, L + 1, step, (beg0, bb0, be0)
        )
        matched = best_b < INF
        return (
            matched,
            jnp.where(matched, best_b, -1).astype(jnp.int32),
            jnp.where(matched, best_e, -1).astype(jnp.int32),
        )

    def _span_bits(self):
        """Cached bit-parallel span executor for certified programs of at
        most 32 instructions, else None (host-side routing)."""
        if not hasattr(self, "_sbits"):
            from .pallas_spans import SpanBits, span_bits_ok

            self._sbits = None
            if span_bits_ok(self):
                # first use may happen inside a caller's jit trace:
                # table construction must stay concrete
                with jax.ensure_compile_time_eval():
                    self._sbits = SpanBits(self)
        return self._sbits

    def spans_single(self, chars, lengths, start_pos, ascii: bool = False):
        """First-match span router (returns matched bool, begin, end).

        On the kernel route, the bit-parallel two-pass kernels
        (pallas_spans) for certified programs; min-plus for the other
        longest-safe programs and on the XLA route; the ordered/DFS
        executors otherwise."""
        from ..config import kernel_route

        sb = self._span_bits()
        if sb is not None and kernel_route() == "kernel":
            return sb.single(chars, lengths, start_pos, ascii)
        if self.prog.longest_safe:
            return self.nfa_spans(chars, lengths, start_pos, ascii)
        N = chars.shape[0]
        begins = jnp.broadcast_to(
            jnp.asarray(start_pos, jnp.int32), (N,)
        )
        m, b, e = self.spans_exec(
            chars, lengths, begins, jnp.full((N,), -1, jnp.int32), 0, ascii
        )
        return m > 0, b, e

    def spans_exec(self, chars, lengths, begins, ends, group_id: int,
                   ascii: bool = False):
        """Exact-span executor selector: the vectorized ordered-closure
        engine for programs <= 128 insts (its packed claim key needs
        4*log2(I) bits), the per-row DFS beyond or when
        CUSTRINGS_ORDERED=0."""
        import os

        if self.I <= 128 and os.environ.get("CUSTRINGS_ORDERED") != "0":
            return self.ordered_spans(
                chars, lengths, begins, ends, group_id, ascii
            )
        return self.run_spans(chars, lengths, begins, ends, group_id, ascii)

    # -------- executor B2: ordered closure, vectorized over rows --------

    def _ordered_tables(self, group_id: int):
        """Host precompute for ordered_spans (cached per group).

        For each anchor context and each seed inst s, run the reference's
        addthread DFS (regexec.inl:279-362) standalone and record, for
        every consuming/END inst t it reaches: the visit RANK (list
        position), and whether the path crossed LBRA/RBRA of `group_id`.

        Why per-seed standalone DFS is exact: in the merged expansion the
        claimant of t is the lowest-priority-index seed whose closure
        contains t (if a higher seed's path to t passed through any node v
        of an earlier closure, then t would be in that earlier closure —
        reachability is transitive), and within that seed the first DFS
        path is unaffected by earlier seeds for the same reason.  So
        merged claim = lexicographic min over seeds of (seed priority,
        standalone rank), with the capture bits of that standalone path.
        """
        if not hasattr(self, "_otabs"):
            self._otabs = {}
        if group_id in self._otabs:
            return self._otabs[group_id]
        prog = self.prog
        I = self.I
        INFR = np.int32(1 << 20)
        consuming = (CHAR, ANY, ANYNL, CCLASS, NCCLASS, END)
        R = np.full((32, I, I), INFR, np.int32)
        SB = np.zeros((32, I, I), np.bool_)
        SE = np.zeros((32, I, I), np.bool_)
        for ctx in range(32):
            for s in range(I):
                stack = [(s, False, False)]
                visited = np.zeros(I, np.bool_)
                rank = 0
                while stack:
                    iid, sb, se = stack.pop()
                    if visited[iid]:
                        continue
                    visited[iid] = True
                    t = prog.types[iid]
                    if t in consuming:
                        R[ctx, s, iid] = rank
                        SB[ctx, s, iid] = sb
                        SE[ctx, s, iid] = se
                        rank += 1
                        continue
                    sb2 = sb or (t == LBRA and prog.args[iid] == group_id)
                    se2 = se or (t == RBRA and prog.args[iid] == group_id)
                    if t == OR:
                        # next = low priority (pushed first), args = high
                        stack.append((prog.next_ids[iid], sb2, se2))
                        stack.append((prog.args[iid], sb2, se2))
                    elif _edge_active(t, prog.args[iid], ctx):
                        stack.append((prog.next_ids[iid], sb2, se2))
        # dedupe contexts
        uniq, ctx_map = [], np.zeros(32, np.int32)
        for ctx in range(32):
            for k, (r0, b0, e0) in enumerate(uniq):
                if (
                    (r0 == R[ctx]).all()
                    and (b0 == SB[ctx]).all()
                    and (e0 == SE[ctx]).all()
                ):
                    ctx_map[ctx] = k
                    break
            else:
                ctx_map[ctx] = len(uniq)
                uniq.append((R[ctx], SB[ctx], SE[ctx]))
        # per-target static seed column lists (any finite rank in any ctx)
        anyfin = np.zeros((I, I), np.bool_)
        for r0, _, _ in uniq:
            anyfin |= r0 < INFR
        cols = [np.nonzero(anyfin[:, t])[0] for t in range(I)]
        tabs = (
            [u[0] for u in uniq],
            [u[1] for u in uniq],
            [u[2] for u in uniq],
            np.asarray(ctx_map),
            cols,
        )
        self._otabs[group_id] = tabs
        return tabs

    @partial(jax.jit, static_argnums=(0, 5, 6))
    def ordered_spans(self, chars, lengths, begins, ends, group_id: int,
                      ascii: bool = False):
        """run_spans semantics, vectorized over rows (VERDICT r2 item 3).

        Replaces the per-row DFS while-loop with per-position claim
        resolution over the precomputed standalone-DFS rank tables: each
        consuming inst's claim key is min over seed threads of
        (seed priority, DFS rank, seed id) packed into one int32.  A
        dense re-rank per position (two batched argsorts) keeps keys
        bounded.  Matches regexec.inl list semantics exactly (validated
        against run_spans on the fuzz corpus)."""
        N, L = chars.shape
        I = self.I
        Runi, SBuni, SEuni, ctx_map_o, cols = self._ordered_tables(group_id)
        U = len(Runi)
        INF = jnp.int32(1 << 30)
        INFR = 1 << 20
        start_ids = np.asarray(jax.device_get(self.start_ids))
        S = len(start_ids)
        types_np = self.prog.types
        next_np = self.prog.next_ids
        end_ids = np.nonzero(types_np == END)[0]
        is_cons_np = np.isin(
            types_np, (CHAR, ANY, ANYNL, CCLASS, NCCLASS)
        )
        # consume columns: for t', the consuming (non-END) insts i -> t'
        ccols = [
            np.nonzero(is_cons_np & (next_np == t))[0] for t in range(I)
        ]
        ctx_map_j = jnp.asarray(ctx_map_o)

        def sel_u(uid, table_list, s, t):
            """Per-row scalar select of table[u][s, t] over unique ctxs."""
            if U == 1:
                return jnp.full_like(uid, int(table_list[0][s, t]))
            out = jnp.full_like(uid, int(table_list[U - 1][s, t]))
            for u in range(U - 2, -1, -1):
                out = jnp.where(uid == u, int(table_list[u][s, t]), out)
            return out

        g0 = group_id == 0

        def step(p, carry):
            key, b, e, matched, mb, me = carry
            upd = p <= lengths  # freeze rows past their own end
            cur = jnp.where(upd, chars[:, jnp.minimum(p, L - 1)], 0)
            prev = jnp.where(
                (p > 0) & (p - 1 < lengths),
                chars[:, jnp.maximum(jnp.minimum(p - 1, L - 1), 0)],
                0,
            )
            # inject start threads (appended = lowest priority)
            can_inject = (
                upd & ~matched & (p >= begins) & ((ends < 0) | (p < ends))
            )
            for k, sid in enumerate(start_ids):
                take = can_inject & (key[:, sid] >= INF)
                key = key.at[:, sid].set(
                    jnp.where(take, jnp.int32(I + k), key[:, sid])
                )
                b = b.at[:, sid].set(
                    jnp.where(take, jnp.int32(p if g0 else -1), b[:, sid])
                )
                e = e.at[:, sid].set(
                    jnp.where(take, jnp.int32(-1), e[:, sid])
                )
            ctx = self._ctx_bits(prev, cur, jnp.full(N, p == 0), ascii)
            uid = ctx_map_j[ctx]
            # expand: claim each consuming/END inst
            ck_cols, cb_cols, ce_cols = [], [], []
            for t in range(I):
                bestk = jnp.full((N,), INF)
                bestb = jnp.zeros((N,), jnp.int32)
                beste = jnp.zeros((N,), jnp.int32)
                for s in cols[t]:
                    rnk = sel_u(uid, Runi, s, t)
                    cand = jnp.where(
                        (key[:, s] < INF) & (rnk < INFR),
                        key[:, s] * (I * I) + rnk * I + jnp.int32(s % I),
                        INF,
                    )
                    sb = sel_u(uid, SBuni, s, t) > 0
                    se = sel_u(uid, SEuni, s, t) > 0
                    cb = jnp.where(sb, p, b[:, s])
                    ce = jnp.where(se, p, e[:, s])
                    take = cand < bestk
                    bestk = jnp.where(take, cand, bestk)
                    bestb = jnp.where(take, cb, bestb)
                    beste = jnp.where(take, ce, beste)
                ck_cols.append(bestk)
                cb_cols.append(bestb)
                ce_cols.append(beste)
            ckey = jnp.stack(ck_cols, axis=1)  # [N, I]
            cb = jnp.stack(cb_cols, axis=1)
            ce = jnp.stack(ce_cols, axis=1)
            # END: highest-priority END thread matches; drop lower threads
            if len(end_ids):
                ek = jnp.full((N,), INF)
                eb = jnp.zeros((N,), jnp.int32)
                ee = jnp.zeros((N,), jnp.int32)
                for t in end_ids:
                    take = ckey[:, t] < ek
                    ek = jnp.where(take, ckey[:, t], ek)
                    eb = jnp.where(take, cb[:, t], eb)
                    ee = jnp.where(take, ce[:, t], ee)
                new_m = upd & (ek < INF)
                mb = jnp.where(new_m, eb, mb)
                me = jnp.where(new_m, jnp.int32(p) if g0 else ee, me)
                matched = matched | new_m
                ckey = jnp.where(ckey > ek[:, None], INF, ckey)
            # consume
            pred = self._char_pred(cur, ascii)  # [N, I]
            fired = jnp.where(
                pred & (ckey < INF) & upd[:, None], ckey, INF
            )
            nk_cols, nb_cols, ne_cols = [], [], []
            for t in range(I):
                bestk = jnp.full((N,), INF)
                bestb = jnp.zeros((N,), jnp.int32)
                beste = jnp.zeros((N,), jnp.int32)
                for i in ccols[t]:
                    take = fired[:, i] < bestk
                    bestk = jnp.where(take, fired[:, i], bestk)
                    bestb = jnp.where(take, cb[:, i], bestb)
                    beste = jnp.where(take, ce[:, i], beste)
                nk_cols.append(bestk)
                nb_cols.append(bestb)
                ne_cols.append(beste)
            nkey = jnp.stack(nk_cols, axis=1)
            nb = jnp.stack(nb_cols, axis=1)
            ne = jnp.stack(ne_cols, axis=1)
            # dense re-rank (keys stay < I after this; injection uses I+k)
            order = jnp.argsort(nkey, axis=1)
            rank = jnp.argsort(order, axis=1).astype(jnp.int32)
            nkey = jnp.where(nkey < INF, rank, INF)
            # frozen rows keep their previous state
            key = jnp.where(upd[:, None], nkey, key)
            b = jnp.where(upd[:, None], nb, b)
            e = jnp.where(upd[:, None], ne, e)
            return key, b, e, matched, mb, me

        key0 = jnp.full((N, I), INF)
        b0 = jnp.zeros((N, I), jnp.int32)
        e0 = jnp.zeros((N, I), jnp.int32)
        carry = (
            key0, b0, e0,
            jnp.zeros(N, jnp.bool_),
            jnp.full(N, -1, jnp.int32),
            jnp.full(N, -1, jnp.int32),
        )
        key, b, e, matched, mb, me = jax.lax.fori_loop(
            0, L + 1, step, carry
        )
        return (
            matched.astype(jnp.int32),
            jnp.where(matched, mb, -1),
            jnp.where(matched, me, -1),
        )

    # ---------------- executor B: spans/captures ----------------

    @partial(jax.jit, static_argnums=(0, 5, 6))
    def run_spans(self, chars, lengths, begins, ends, group_id: int,
                  ascii: bool = False):
        """Faithful regexec (regexec.inl:204-442) vmapped over rows.

        begins/ends: int32[rows] search window (ends<0 => open).
        Returns (matched int32, begin int32, end int32) per row.
        """

        types, next_ids, args = self.types, self.next_ids, self.args
        start_ids = self.start_ids
        I = self.I

        def one_row(row_chars, rlen, begin0, eos):
            L = row_chars.shape[0]

            def char_at(p):
                c = jnp.where(
                    (p >= 0) & (p < rlen),
                    row_chars[jnp.clip(p, 0, L - 1)],
                    0,
                )
                return c

            def alnum(c):
                flags, _ = device_tables()
                safe = jnp.clip(c, 0, flags.shape[0] - 1)
                return (
                    (c > 0)
                    & (c < flags.shape[0])
                    & ((flags[safe].astype(jnp.int32) & FLAG_ALPHANUM) > 0)
                )

            # list arrays: ids, (b,e) ranges, mask, size
            def empty_list():
                return (
                    jnp.zeros(I, jnp.int32),
                    jnp.zeros(I, jnp.int32),
                    jnp.zeros(I, jnp.int32),
                    jnp.zeros(I, jnp.bool_),
                    jnp.int32(0),
                )

            def activate(lst, iid, b, e):
                ids, bs, es, mask, size = lst
                fresh = ~mask[iid]
                ids = jnp.where(fresh, ids.at[size].set(iid), ids)
                bs = jnp.where(fresh, bs.at[size].set(b), bs)
                es = jnp.where(fresh, es.at[size].set(e), es)
                mask = mask.at[iid].set(True)
                size = size + fresh.astype(jnp.int32)
                return (ids, bs, es, mask, size)

            def expand_phase(l1, pos, c):
                """DFS addthread (regexec.inl): exact priority order.

                Explicit stack + visited set reproduce the reference's
                recursive thread insertion — a BFS-round formulation
                reorders priorities whenever an eps-loop (e.g. (c*)+)
                feeds the chain, which picks wrong spans.
                """
                ids, bs, es, _, size = l1
                SP = 3 * I + 4
                prev_c = char_at(pos - 1)
                wb = alnum(c) != alnum(prev_c)

                st_i = jnp.zeros(SP, jnp.int32)
                st_b = jnp.zeros(SP, jnp.int32)
                st_e = jnp.zeros(SP, jnp.int32)
                # push initial entries in reverse so entry 0 pops first
                k = jnp.arange(SP)
                src = size - 1 - k  # entry index for stack slot k
                ok0 = (src >= 0) & (src < size)
                src_c = jnp.clip(src, 0, I - 1)
                st_i = jnp.where(ok0, ids[src_c], st_i)
                st_b = jnp.where(ok0, bs[src_c], st_b)
                st_e = jnp.where(ok0, es[src_c], st_e)
                sp0 = size
                out0 = empty_list()
                visited0 = jnp.zeros(I, jnp.bool_)

                def cond(state):
                    return state[3] > 0

                def body(state):
                    st_i, st_b, st_e, sp, visited, out = state
                    top = sp - 1
                    iid = st_i[top]
                    b, e = st_b[top], st_e[top]
                    sp = top
                    fresh = ~visited[iid]
                    visited = visited.at[iid].set(True)
                    t = types[iid]
                    arg = args[iid]
                    nid = next_ids[iid]
                    is_consume = (
                        (t == CHAR) | (t == ANY) | (t == ANYNL)
                        | (t == CCLASS) | (t == NCCLASS) | (t == END)
                    )
                    b2 = jnp.where((t == LBRA) & (arg == group_id), pos, b)
                    e2 = jnp.where((t == RBRA) & (arg == group_id), pos, e)
                    bol_ok = (pos == 0) | (
                        (arg == ord("^")) & (prev_c == ord("\n"))
                    )
                    eol_ok = (c == 0) | ((arg == ord("$")) & (c == ord("\n")))
                    # single eps successor (everything except OR/consume)
                    step_ok = (
                        (t == LBRA) | (t == RBRA)
                        | ((t == BOL) & bol_ok) | ((t == EOL) & eol_ok)
                        | ((t == BOW) & wb) | ((t == NBOW) & ~wb)
                    )
                    # OR pushes next (low priority) first, args-branch last
                    push_low = fresh & (t == OR)
                    st_i = jnp.where(push_low, st_i.at[sp].set(nid), st_i)
                    st_b = jnp.where(push_low, st_b.at[sp].set(b2), st_b)
                    st_e = jnp.where(push_low, st_e.at[sp].set(e2), st_e)
                    sp = sp + push_low.astype(jnp.int32)
                    hi_id = jnp.where(t == OR, arg, nid)
                    push_hi = fresh & ((t == OR) | step_ok)
                    st_i = jnp.where(push_hi, st_i.at[sp].set(hi_id), st_i)
                    st_b = jnp.where(push_hi, st_b.at[sp].set(b2), st_b)
                    st_e = jnp.where(push_hi, st_e.at[sp].set(e2), st_e)
                    sp = sp + push_hi.astype(jnp.int32)
                    out = jax.tree_util.tree_map(
                        lambda new, old: jnp.where(
                            fresh & is_consume, new, old
                        ),
                        activate(out, iid, b2, e2),
                        out,
                    )
                    return (st_i, st_b, st_e, sp, visited, out)

                _, _, _, _, _, out = jax.lax.while_loop(
                    cond, body, (st_i, st_b, st_e, sp0, visited0, out0)
                )
                return out

            def consume_phase(l1, pos, c, match, mb, me):
                l2 = empty_list()
                pred = self._char_pred(c[None], ascii)[0]  # [I], once per char

                def entry(i, st):
                    l2, match, mb, me, stopped = st
                    ids, bs, es, mask, size = l1
                    valid = (i < size) & ~stopped
                    iid = ids[jnp.minimum(i, I - 1)]
                    b, e = bs[jnp.minimum(i, I - 1)], es[jnp.minimum(i, I - 1)]
                    t = types[iid]
                    ok = pred[iid]
                    is_end_i = t == END
                    new_match = valid & is_end_i
                    mb = jnp.where(new_match, b, mb)
                    me = jnp.where(
                        new_match,
                        jnp.where(group_id == 0, pos, e),
                        me,
                    )
                    match = match | new_match
                    stopped = stopped | new_match  # drop lower-priority rest

                    def do_act(l2):
                        return activate(l2, next_ids[iid], b, e)

                    l2 = jax.tree_util.tree_map(
                        lambda new, old: jnp.where(
                            valid & ok & ~is_end_i, new, old
                        ),
                        do_act(l2),
                        l2,
                    )
                    return (l2, match, mb, me, stopped)

                l2, match, mb, me, _ = jax.lax.fori_loop(
                    0, I, entry, (l2, match, mb, me, jnp.zeros((), jnp.bool_))
                )
                return l2, match, mb, me

            def loop_body(state):
                pos, l1, match, mb, me, done = state
                c = char_at(pos)
                # inject start states while no match yet and pos in window
                can_inject = ((eos < 0) | (pos < eos)) & (match == 0)

                def inject(l1):
                    def body(k, l1):
                        sid = start_ids[k]
                        return jax.tree_util.tree_map(
                            lambda new, old: jnp.where(can_inject, new, old),
                            activate(
                                l1,
                                sid,
                                jnp.where(group_id == 0, pos, -1),
                                jnp.int32(-1),
                            ),
                            l1,
                        )

                    return jax.lax.fori_loop(0, start_ids.shape[0], body, l1)

                l1 = inject(l1)
                l1 = expand_phase(l1, pos, c)
                l2, match2, mb, me = consume_phase(l1, pos, c, match, mb, me)
                size2 = l2[4]
                done = (c == 0) | ((size2 == 0) & (match2 > 0))
                return (pos + 1, l2, match2, mb, me, done)

            def loop_cond(state):
                return ~state[5]

            init = (
                begin0,
                empty_list(),
                jnp.zeros((), jnp.bool_),
                jnp.int32(-1),
                jnp.int32(-1),
                jnp.zeros((), jnp.bool_),
            )
            _, _, match, mb, me, _ = jax.lax.while_loop(
                loop_cond, loop_body, init
            )
            return match.astype(jnp.int32), mb, me

        return jax.vmap(one_row)(chars, lengths, begins, ends)

    # ---------------- executor C: all non-overlapping spans, one pass ----

    @partial(jax.jit, static_argnums=(0, 4, 5, 6, 7, 8))
    def all_spans(self, chars, lengths, validity, Rcap: int, exact: bool,
                  ascii: bool = False, groups: tuple = (),
                  counts_only: bool = False):
        """ALL non-overlapping leftmost matches per row in ONE dispatch.

        Device-resident round loop around the single-match engines
        (nfa_spans for longest-safe programs, run_spans otherwise) with the
        reference advance rule (count.cu:178-199: begin = end if end >
        begin else begin + 1).  Replaces round 1's host-driven match loop
        (one dispatch + D2H sync per round, regex/ops.py r1:66-103).

        Returns (counts int32[N], begins int32[N, Rcap], ends int32[N,
        Rcap]); match r of a row occupies column r (-1 past its count —
        rows deactivate permanently, so matches are left-contiguous).

        groups: optional capture-group ids; each adds a (GB, GE) pair of
        int32[N, Rcap] planes recorded per match round via match-anchored
        group executions — the device replacement for the per-round,
        per-group host dispatches of replace_with_backrefs
        (replace_backref.cu:122-207 extracts groups in the same pass).
        A group that does not participate in a match records -1/-1.
        """
        N, L = chars.shape
        G = len(groups)

        def cond(state):
            r, begins, active = state[0], state[1], state[2]
            return (r < Rcap) & jnp.any(active)

        def body(state):
            r, begins, active, counts, B, E, GBE = state
            # spans_single routes per program certification: bit-parallel
            # two-pass (certified), min-plus (longest-safe), ordered
            # otherwise — `exact` matches the prog-flag routing inside
            m, b, e = self.spans_single(chars, lengths, begins, ascii)
            hit = active & m
            counts = counts + hit.astype(jnp.int32)
            # index pair must be same-dtype even if another op enabled x64
            z = jnp.zeros((), r.dtype)

            def put(M, v):
                return jax.lax.dynamic_update_slice(
                    M, jnp.where(hit, v, -1).astype(jnp.int32)[:, None],
                    (z, r),
                )

            if not counts_only:
                B = put(B, b)
                E = put(E, e)
            GBE2 = []
            for gi, g in enumerate(groups):
                mg, bg, eg = self.spans_exec(
                    chars, lengths,
                    jnp.where(hit, b, 0).astype(jnp.int32),
                    jnp.where(hit, b + 1, 0).astype(jnp.int32),
                    g, ascii,
                )
                okg = hit & (mg > 0)
                GBE2.append(put(GBE[2 * gi], jnp.where(okg, bg, -1)))
                GBE2.append(put(GBE[2 * gi + 1], jnp.where(okg, eg, -1)))
            begins = jnp.where(
                hit, jnp.where(e > b, e, begins + 1), begins
            ).astype(jnp.int32)
            active = hit & (begins <= lengths)
            return r + 1, begins, active, counts, B, E, tuple(GBE2)

        neg = jnp.full((N, 1 if counts_only else Rcap), -1, jnp.int32)
        state0 = (
            jnp.int32(0),
            jnp.zeros(N, jnp.int32),
            validity,
            jnp.zeros(N, jnp.int32),
            neg,
            neg,
            tuple(neg for _ in range(2 * G)),
        )
        out = jax.lax.while_loop(cond, body, state0)
        if G:
            gbe = out[6]
            return out[3], out[4], out[5], [
                (gbe[2 * i], gbe[2 * i + 1]) for i in range(G)
            ]
        return out[3], out[4], out[5]
