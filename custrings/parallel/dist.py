"""Multi-chip distributed string ops over a jax.sharding.Mesh.

The reference is single-GPU (SURVEY §2.8: no NCCL/MPI; only CUDA IPC).
Here columns are row-sharded across a "data" mesh axis, elementwise ops
run shard-local, and the dictionary build becomes the collective
key-merge:

    local sort-unique (per shard, static key bound)
      -> all_gather candidate key words over the device interconnect
      -> replicated merge sort-unique -> global dense ranks
      -> local value remap

Everything inside is jit-pure (static shapes, no host syncs): the dynamic
key-count problem is solved with a fixed per-shard key capacity (bounded by
rows-per-shard) plus validity masks, instead of the host ping-pong the
single-chip path uses.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..column import StringColumn
from ..ops.array import lsd_order
from ..ops.segments import cumsum as _cumsum


def _stack_shards(parts, rows_per: int):
    """Stack per-shard host buffers [(data, offsets from 0, validity)] at
    one byte capacity and row count -> numpy (data[S, cap],
    offsets[S, R+1], validity[S, R], alive[S, R]).  Rows pad with trailing
    null rows; bytes pad with zeros."""
    S = len(parts)
    cap = max(max((len(p[0]) for p in parts), default=0), 1)
    cap = -(-cap // 128) * 128
    d = np.zeros((S, cap), np.uint8)
    o = np.zeros((S, rows_per + 1), np.int32)
    v = np.zeros((S, rows_per), np.bool_)
    a = np.zeros((S, rows_per), np.bool_)
    for s, (data, offsets, validity) in enumerate(parts):
        k = len(validity)
        d[s, : len(data)] = data
        o[s, : k + 1] = offsets
        o[s, k + 1 :] = len(data)
        v[s, :k] = validity
        a[s, :k] = True
    return d, o, v, a


def _row_slices(n: int, n_shards: int):
    rows_per = -(-n // n_shards)
    return rows_per, [
        (min(s * rows_per, n), min((s + 1) * rows_per, n))
        for s in range(n_shards)
    ]


def shard_column(col: StringColumn, n_shards: int):
    """Host-side: split rows into n_shards equal shards with equal byte
    capacities -> stacked arrays [S, ...] ready for a 'data' mesh axis.

    Returns (data[S, cap], offsets[S, R+1], validity[S, R], alive[S, R]).
    Rows pad with trailing null rows; bytes pad with zeros.
    """
    offsets, data, validity = (
        np.asarray(x)
        for x in jax.device_get((col.offsets, col.data, col.validity))
    )
    rows_per, slices = _row_slices(col.size, n_shards)
    parts = [
        (
            data[offsets[lo] : offsets[hi]],
            offsets[lo : hi + 1] - offsets[lo],
            validity[lo:hi],
        )
        for lo, hi in slices
    ]
    return tuple(jnp.asarray(x) for x in _stack_shards(parts, rows_per))


def shard_rows(strs, n_shards: int):
    """shard_column straight from host rows, as numpy arrays: each row
    slice is flattened on its own, so the rows may hold more than a
    column's 2^31 - 1 bytes as long as every shard stays below it."""
    from ..column import flatten_host

    rows_per, slices = _row_slices(len(strs), n_shards)
    parts = [flatten_host(strs[lo:hi]) for lo, hi in slices]
    return _stack_shards(parts, rows_per)


def _pack_words(data, offsets, width):
    """jit-pure packed big-endian uint32 key words [R, width//4]."""
    cap = data.shape[0]
    lens = offsets[1:] - offsets[:-1]
    k = jnp.arange(width, dtype=jnp.int32)[None, :]
    starts = offsets[:-1][:, None]
    idx = jnp.minimum(starts + k, cap - 1)
    view = jnp.where(
        k < lens[:, None], data[idx], jnp.uint8(0)
    ).astype(jnp.uint32)
    return (
        (view[:, 0::4] << 24)
        | (view[:, 1::4] << 16)
        | (view[:, 2::4] << 8)
        | view[:, 3::4]
    )


def _lex_order(keys):
    """Row order by uint32 `keys`, most significant first.  Wide keys
    (long rows) take the LSD scan: a variadic sort's comparator over
    dozens of key columns takes minutes to compile for the GPU."""
    if len(keys) > 6:
        return lsd_order(keys)
    rows = jnp.arange(keys[0].shape[0], dtype=jnp.int32)
    return jax.lax.sort(tuple(keys) + (rows,), num_keys=len(keys))[-1]


def _sort_unique_ranks(words, lens, valid, row_alive):
    """jit-pure dense-rank encode over [R, W] words.

    row_alive masks padding rows (they sort last, get rank -1).
    Returns (values int32[R], uniq_words uint32[R, W], uniq_lens, uniq_valid
    bool-ish arrays at fixed capacity R, uniq_alive bool[R]).
    """
    R, W = words.shape
    keys = [jnp.where(row_alive, 0, 1).astype(jnp.uint32)]
    keys.append(valid.astype(jnp.uint32))  # nulls first among alive
    for i in range(W):
        keys.append(words[:, i])
    keys.append(lens.astype(jnp.uint32))
    order = _lex_order(keys)
    sw = words[order]
    sl = lens[order]
    sv = valid[order]
    sa = row_alive[order]
    if R > 1:
        row_neq = (
            jnp.any(sw[1:] != sw[:-1], axis=1)
            | (sl[1:] != sl[:-1])
            | (sv[1:] != sv[:-1])
        )
        both_null = (~sv[1:]) & (~sv[:-1])
        row_neq = row_neq & ~both_null
        # padding rows must never merge with real keys
        row_neq = row_neq | (sa[1:] != sa[:-1])
        neq = jnp.concatenate([jnp.zeros(1, jnp.bool_), row_neq])
    else:
        neq = jnp.zeros(R, jnp.bool_)
    ranks = _cumsum(neq.astype(jnp.int32))
    values = jnp.zeros(R, jnp.int32).at[order].set(ranks)
    values = jnp.where(row_alive, values, -1)
    # unique table at fixed capacity R: scatter sorted rows by rank
    uniq_words = jnp.zeros((R, W), jnp.uint32).at[ranks].set(sw)
    uniq_lens = jnp.zeros(R, jnp.int32).at[ranks].set(sl)
    uniq_valid = jnp.zeros(R, jnp.bool_).at[ranks].set(sv)
    n_uniq = jnp.max(jnp.where(sa, ranks + 1, 0))
    uniq_alive = jnp.arange(R) < n_uniq
    return values, uniq_words, uniq_lens, uniq_valid, uniq_alive


_SENTINEL = np.uint32(0xFFFFFFFF)  # np: module-level jnp would init the backend at import


def _encode_local(data, offsets, validity, row_alive, width: int):
    """Local dense-rank encode -> canonical packed key matrix.

    Returns (lv int32[R] local values, K uint32[R, C] key matrix with
    columns (valid, word_0..word_{W-1}, len) in sort order, u = live unique
    count).  Null keys and dead slots are canonicalized to all-zero /
    sentinel so cross-shard equality is plain column equality."""
    words = _pack_words(data, offsets, width)
    lens = offsets[1:] - offsets[:-1]
    lv, uw, ul, uv, ua = _sort_unique_ranks(words, lens, validity, row_alive)
    # canonicalize: null key -> all-zero words/len (one global null key);
    # dead (beyond-unique-count) slots -> sentinel valid column
    live_null = ua & ~uv
    uw = jnp.where((uv & ua)[:, None], uw, 0)
    ul = jnp.where(uv & ua, ul, 0)
    vcol = jnp.where(ua, uv.astype(jnp.uint32), _SENTINEL)
    vcol = jnp.where(live_null, jnp.uint32(0), vcol)
    K = jnp.concatenate(
        [vcol[:, None], uw, ul.astype(jnp.uint32)[:, None]], axis=1
    )
    u = jnp.sum(ua.astype(jnp.int32))
    return lv, K, u


def _lex_lt(a, b):
    """Columnwise lexicographic a < b for uint32 matrices [..., C]."""
    C = a.shape[-1]
    lt = a[..., C - 1] < b[..., C - 1]
    for j in range(C - 2, -1, -1):
        lt = (a[..., j] < b[..., j]) | ((a[..., j] == b[..., j]) & lt)
    return lt


def _psrs_merge(lv, K, axis: str, S: int, cap: int):
    """Runs INSIDE shard_map: PSRS-partitioned key merge over the encoded
    key matrix (phase B of the two-phase collective categorize).

    Round 2 (VERDICT item 3): the round-1 merge re-sorted the full S*R
    gathered keyset on every shard, so per-shard merge work grew with the
    mesh.  This is a sample-sort exchange with flat per-shard work whose
    buffers are sized by the MEASURED dictionary size (u_max, via `cap`),
    not the row count — for categorical data (u << R) the merge cost is
    negligible next to the local encode sort:

      1. regular sampling: S local quantile keys, all_gather S^2 samples,
         identical splitter selection on every shard (tiny)
      2. partition my sorted unique keys by splitter range; dense
         all_to_all exchange at per-pair capacity cap ~ 2*u_max/S (comm
         ~2*u_max keys, flat in S; skew beyond capacity — e.g. shards
         holding disjoint pre-sorted key ranges — raises an overflow flag
         and the host falls back to the gathered merge)
      3. each shard owns one key RANGE: sort+dedup its received keys
         (S*cap ~ 2*u_max rows, flat in S), local dense ranks
      4. global rank = prefix sum of owned counts (all_gather of S
         scalars) + local rank; reverse all_to_all returns ranks to
         senders.

    Ranges are ordered, so ranks equal the rank in the globally sorted
    unique keyset — exact nvcategory parity (NVCategory.cu:1339 model).
    """
    R, C = K.shape
    live = K[:, 0] <= 1  # vcol: 0 null key, 1 valid key, sentinel dead
    u = jnp.sum(live.astype(jnp.int32))

    # --- 1. splitters from regular samples (identical on every shard)
    spos = jnp.clip(
        (jnp.arange(S, dtype=jnp.int32) + 1) * u // (S + 1), 0, R - 1
    )
    samples = K[spos]  # [S, C]
    gs = jax.lax.all_gather(samples, axis).reshape(S * S, C)
    gs_sorted = gs[_lex_order([gs[:, j] for j in range(C)])]
    splitters = gs_sorted[(jnp.arange(S - 1) + 1) * S]  # [S-1, C]

    # --- 2. partition my keys: part = #splitters <= key
    k_lt_spl = _lex_lt(K[:, None, :], splitters[None, :, :])  # [R, S-1]
    part = (S - 1) - jnp.sum(k_lt_spl.astype(jnp.int32), axis=1)
    part = jnp.where(live, part, S)  # dead slots drop out
    # keys are sorted so part is non-decreasing; slot = index within part
    starts = jnp.searchsorted(part, jnp.arange(S + 1, dtype=jnp.int32))
    counts = starts[1:] - starts[:-1]  # [S]
    overflow = jnp.any(counts > cap)
    slot = jnp.arange(R, dtype=jnp.int32) - starts[jnp.clip(part, 0, S - 1)]
    idx = jnp.where(live & (slot < cap), part * cap + slot, S * cap)
    send = jnp.full((S * cap, C), _SENTINEL).at[idx].set(K, mode="drop")
    recv = jax.lax.all_to_all(
        send.reshape(S, cap, C), axis, split_axis=0, concat_axis=0
    )

    # --- 3. owner-side merge of my key range
    flat = recv.reshape(S * cap, C)
    dead = (flat[:, 0] > 1).astype(jnp.uint32)  # sentinel valid column
    order = _lex_order([dead] + [flat[:, j] for j in range(C)])
    salive = dead[order] == 0
    scols = flat[order]
    isnew = salive & jnp.concatenate(
        [
            jnp.ones(1, jnp.bool_),
            jnp.any(scols[1:] != scols[:-1], axis=1),
        ]
    )
    ranks_sorted = _cumsum(isnew.astype(jnp.int32)) - 1
    owned = jnp.sum(isnew.astype(jnp.int32))
    ranks_at_slot = (
        jnp.full(S * cap, -1, jnp.int32)
        .at[order]
        .set(jnp.where(salive, ranks_sorted, -1))
    )

    # --- 4. global rank base + return ranks to senders
    # one gather carries (owned, overflow) so no separate psum/pmax barriers
    me = jax.lax.axis_index(axis)
    stats = jnp.stack([owned, overflow.astype(jnp.int32)])
    gstats = jax.lax.all_gather(stats, axis)  # [S, 2]
    gowned = gstats[:, 0]
    base = jnp.sum(jnp.where(jnp.arange(S) < me, gowned, 0))
    global_at_slot = jnp.where(
        ranks_at_slot >= 0, ranks_at_slot + base, -1
    ).reshape(S, cap)
    back = jax.lax.all_to_all(
        global_at_slot, axis, split_axis=0, concat_axis=0
    ).reshape(S * cap)
    my_rank = jnp.where(
        live & (slot < cap), back[jnp.clip(idx, 0, S * cap - 1)], -1
    )
    values = jnp.where(lv >= 0, my_rank[jnp.clip(lv, 0, R - 1)], -1)
    # scalar pmax proves replication to shard_map's check (values already
    # identical on every shard via the gather)
    n_global = jax.lax.pmax(jnp.sum(gowned), axis)
    any_overflow = jax.lax.pmax(jnp.any(gstats[:, 1] > 0), axis)
    return values, n_global, any_overflow


def _local_then_merge_gather(
    data, offsets, validity, row_alive, width: int, axis: str
):
    """Fallback collective merge (round-1 model): all_gather every shard's
    candidate keyset and re-sort the S*R table on each shard.  Per-shard
    work grows with S but there is no partition-capacity assumption, so
    this is the escape hatch when PSRS partitions overflow on adversarially
    skewed keysets."""
    words = _pack_words(data, offsets, width)
    lens = offsets[1:] - offsets[:-1]
    R = words.shape[0]
    lv, uw, ul, uv, ua = _sort_unique_ranks(words, lens, validity, row_alive)
    gw = jax.lax.all_gather(uw, axis)  # [S, R, W]
    gl = jax.lax.all_gather(ul, axis)
    gv = jax.lax.all_gather(uv, axis)
    ga = jax.lax.all_gather(ua, axis)
    S = gw.shape[0]
    flat_w = gw.reshape(S * R, -1)
    flat_l = gl.reshape(S * R)
    flat_v = gv.reshape(S * R)
    flat_a = ga.reshape(S * R)
    gvals, *_ = _sort_unique_ranks(flat_w, flat_l, flat_v, flat_a)
    grank = gvals.reshape(S, R)
    me = jax.lax.axis_index(axis)
    my_rank = grank[me]  # local key k -> global key id
    values = jnp.where(lv >= 0, my_rank[jnp.clip(lv, 0, R - 1)], -1)
    # pmax proves replication to shard_map's varying-manual-axes check
    n_global = jax.lax.pmax(jnp.max(gvals) + 1, axis)
    return values, n_global


_categorize_cache: dict = {}


def _encode_fn(mesh: Mesh, axis: str, width: int):
    """Phase A program: shard-local dense-rank encode.  Returns the jitted
    shard_map producing (lv [S,R], K [S,R,C], u [S]); cached per
    (mesh, axis, width) so repeat calls hit the compile cache instead of
    re-tracing a fresh closure (round-1 re-jitted every call, so its
    scaling bench measured retraces, not the merge)."""
    key = (id(mesh), axis, width, "encode")
    cached = _categorize_cache.get(key)
    if cached is not None:
        return cached
    from .compat import shard_map

    def body(d, o, v, a):
        lv, K, u = _encode_local(d[0], o[0], v[0], a[0], width)
        return lv[None], K[None], u[None]

    fn = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis)),
        )
    )
    _categorize_cache[key] = fn
    return fn


def _fused_fn(mesh: Mesh, axis: str, width: int, cap: int):
    """The steady-state collective categorize: ONE program fusing the
    shard-local encode and the PSRS merge, so there is no host sync (and
    no dispatch boundary) between the phases.  The exchange capacity is a
    static compile-time constant supplied by the driver's adaptive cap
    cache; overflow is returned as a flag the driver checks after the
    values are already computed."""
    key = (id(mesh), axis, width, cap, "fused")
    cached = _categorize_cache.get(key)
    if cached is not None:
        return cached
    from .compat import shard_map

    S = int(np.prod(mesh.devices.shape))

    def body(d, o, v, a):
        lv, K, u = _encode_local(d[0], o[0], v[0], a[0], width)
        values, n_global, overflow = _psrs_merge(lv, K, axis, S, cap)
        return values[None], n_global, overflow, u[None]

    fn = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(), P(), P(axis)),
        )
    )
    _categorize_cache[key] = fn
    return fn


def _gather_fn(mesh: Mesh, axis: str, width: int):
    """Fallback program: gathered merge (no partition-capacity assumption)."""
    key = (id(mesh), axis, width, "gather")
    cached = _categorize_cache.get(key)
    if cached is not None:
        return cached
    from .compat import shard_map

    def body(d, o, v, a):
        values, n_global = _local_then_merge_gather(
            d[0], o[0], v[0], a[0], width, axis
        )
        return values[None], n_global

    fn = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P()),
        )
    )
    _categorize_cache[key] = fn
    return fn


_cap_cache: dict = {}


def _bucket_cap(per_pair: int, R: int) -> int:
    cap = 16
    while cap < min(per_pair, R):
        cap *= 2
    return cap


def distributed_categorize(
    data_sh, offsets_sh, validity_sh, alive_sh, mesh: Mesh, axis: str = "data"
):
    """Collective dictionary build over row shards.

    Inputs are [S, ...] stacked shard arrays (shard_column).  Returns
    (values [S, R] global key ids, n_global_keys replicated scalar).

    Steady state is ONE fused program (encode + PSRS merge) with zero
    mid-pipeline host syncs: the PSRS exchange capacity is a static
    constant remembered from the previous call on this mesh (first call
    sizes it with a one-off encode pass).  The post-compute overflow flag
    is the only per-call sync; when a pathologically skewed keyset
    overflows the partition capacity the call transparently escalates to
    cap=u_max (guaranteed sufficient: no shard sends more than its own
    unique count to one partition) and ultimately to the gathered merge.
    """
    # key-word width = max row byte length (host sync at setup only)
    row_lens = offsets_sh[:, 1:] - offsets_sh[:, :-1]
    width = int(jnp.max(row_lens))
    width = max(-(-width // 4) * 4, 4)
    S = int(np.prod(mesh.devices.shape))
    enc = _encode_fn(mesh, axis, width)
    if S == 1:
        lv, K, u = enc(data_sh, offsets_sh, validity_sh, alive_sh)
        return lv, jnp.max(u)
    R = int(offsets_sh.shape[1]) - 1
    ckey = (id(mesh), axis)
    cap = _cap_cache.get(ckey)
    if cap is None:
        # first call on this mesh: size the exchange from a real encode
        _, _, u = enc(data_sh, offsets_sh, validity_sh, alive_sh)
        u_max = int(jax.device_get(jnp.max(u)))
        cap = _bucket_cap(-(-2 * u_max // S), R)
    values, n_global, overflow, u = _fused_fn(mesh, axis, width, cap)(
        data_sh, offsets_sh, validity_sh, alive_sh
    )
    if bool(overflow):  # post-compute sync; rare escalation path
        u_max = int(jax.device_get(jnp.max(u)))
        cap = _bucket_cap(u_max, R)
        values, n_global, overflow, u = _fused_fn(mesh, axis, width, cap)(
            data_sh, offsets_sh, validity_sh, alive_sh
        )
        if bool(overflow):
            _cap_cache.pop(ckey, None)
            return _gather_fn(mesh, axis, width)(
                data_sh, offsets_sh, validity_sh, alive_sh
            )
    _cap_cache[ckey] = cap
    return values, n_global


@partial(jax.jit, static_argnums=())
def _regex_count_local(matches):
    return jnp.sum(matches.astype(jnp.int32))


def distributed_unique_tokens(
    col: StringColumn, mesh: Mesh, delimiter=None, axis: str = "data"
):
    """Distributed nvtext.unique_tokens: tokenize per shard, collective
    key-merge for the global unique count (SURVEY §5.8 north star).

    Returns (global_token_ids [S, R] int32 per local token slot, -1 pad;
    n_unique replicated scalar).
    """
    n_shards = int(np.prod(mesh.devices.shape))
    from ..text.token import tokenize
    from ..column import to_host_strings

    # host-side fan-out: tokenize each row shard with the single-chip path,
    # then stack the token columns at a common capacity
    n = col.size
    rows_per = -(-n // n_shards)
    shards = []
    for s in range(n_shards):
        lo, hi = s * rows_per, min((s + 1) * rows_per, n)
        from ..ops.array import gather

        sub = gather(col, np.arange(lo, max(hi, lo), dtype=np.int64))
        shards.append(tokenize(sub, delimiter))
    max_tokens = max(max(t.size for t in shards), 1)
    import jax as _jax

    d_list, o_list, v_list, a_list = [], [], [], []
    cap = max(
        -(-max(int(_jax.device_get(t.offsets[-1])) for t in shards) // 128)
        * 128,
        128,
    )
    for t in shards:
        nb = int(_jax.device_get(t.offsets[-1]))
        d = np.zeros(cap, np.uint8)
        d[:nb] = np.asarray(_jax.device_get(t.data))[:nb]
        o = np.full(max_tokens + 1, nb, np.int32)
        o[: t.size + 1] = np.asarray(_jax.device_get(t.offsets))
        v = np.zeros(max_tokens, np.bool_)
        v[: t.size] = True
        a = np.zeros(max_tokens, np.bool_)
        a[: t.size] = True
        d_list.append(d)
        o_list.append(o)
        v_list.append(v)
        a_list.append(a)
    return distributed_categorize(
        jnp.asarray(np.stack(d_list)),
        jnp.asarray(np.stack(o_list)),
        jnp.asarray(np.stack(v_list)),
        jnp.asarray(np.stack(a_list)),
        mesh,
        axis,
    )


def _tok_fused_fn(
    mesh: Mesh, axis: str, width: int, tcap: int, bcap: int, cap: int,
    delimiter,
):
    """ONE program: shard-local tokenize -> local dense-rank encode ->
    PSRS collective key merge (round 2, VERDICT item 9: round 1 fanned the
    tokenize out on the host, one single-chip dispatch per shard)."""
    key = (id(mesh), axis, width, tcap, bcap, cap, delimiter, "tokfused")
    cached = _categorize_cache.get(key)
    if cached is not None:
        return cached
    from .compat import shard_map
    from ..ops.split import _ragged_full
    from ..text.token import _tokenize_body

    S = int(np.prod(mesh.devices.shape))

    def body(d, o, v, a):
        col = StringColumn(d[0], o[0], v[0])
        data_t, tok_off, byte_off = _ragged_full(
            col, _tokenize_body, (delimiter,), tcap, bcap
        )
        alive_t = jnp.arange(tcap, dtype=jnp.int32) < tok_off[-1]
        lv, K, u = _encode_local(data_t, byte_off, alive_t, alive_t, width)
        if S == 1:
            n = jnp.max(jnp.where(lv >= 0, lv, -1)) + 1
            return lv[None], n, jnp.zeros((), jnp.bool_), u[None]
        values, n_global, overflow = _psrs_merge(lv, K, axis, S, cap)
        return values[None], n_global, overflow, u[None]

    fn = jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis),) * 4,
            out_specs=(P(axis), P(), P(), P(axis)),
        )
    )
    _categorize_cache[key] = fn
    return fn


def distributed_unique_tokens_device(
    data_sh, offsets_sh, validity_sh, alive_sh, mesh: Mesh,
    axis: str = "data", delimiter=None,
):
    """Device-side distributed unique_tokens: tokenize + encode + merge in
    one fused shard_map program (no host fan-out).  Returns (token global
    ids [S, T] with -1 past each shard's count, n_unique scalar).  The
    delimiter (None = whitespace) is a static compile-time arg."""
    R = int(offsets_sh.shape[1]) - 1
    bcap = int(data_sh.shape[1])
    from ..config import bucket_bytes

    tcap = bucket_bytes(bcap + R)  # tokens <= bytes + rows
    row_lens = offsets_sh[:, 1:] - offsets_sh[:, :-1]
    width = int(jax.device_get(jnp.max(row_lens)))  # token <= row bytes
    width = max(-(-width // 4) * 4, 4)
    S = int(np.prod(mesh.devices.shape))
    ckey = (id(mesh), axis, "tok")
    cap = _cap_cache.get(ckey)
    if cap is None:
        cap = _bucket_cap(max(-(-2 * tcap // S), 64), tcap)
    values, n_global, overflow, u = _tok_fused_fn(
        mesh, axis, width, tcap, bcap, cap, delimiter
    )(data_sh, offsets_sh, validity_sh, alive_sh)
    if S > 1 and bool(overflow):
        u_max = int(jax.device_get(jnp.max(u)))
        cap = _bucket_cap(u_max, tcap)
        values, n_global, overflow, u = _tok_fused_fn(
            mesh, axis, width, tcap, bcap, cap, delimiter
        )(data_sh, offsets_sh, validity_sh, alive_sh)
    _cap_cache[ckey] = cap
    return values, n_global


def distributed_replace(
    data_sh, offsets_sh, validity_sh, mesh: Mesh, pat: str, repl: str,
    axis: str = "data",
):
    """Row-sharded literal replace (shrinking replacements): the fused
    sync-free replace program runs shard-local under shard_map — the
    'categorize + replace' pairing of BASELINE workload #5."""
    from ..ops.modify import _replace_full, _has_border
    from ..ops.find import _pat_array
    from .compat import shard_map
    from ..column import StringColumn

    pat_b, repl_b = pat.encode(), repl.encode()
    m, rl = len(pat_b), len(repl_b)
    if rl > m:
        raise ValueError("distributed_replace requires len(repl) <= len(pat)")
    p, r = _pat_array(pat_b), _pat_array(repl_b)
    bordered = _has_border(pat_b)
    bcap = int(data_sh.shape[1])

    def body(d, o, v):
        from ..ops import layout as _layout

        col = StringColumn(d[0], o[0], v[0])
        rb = _layout.row_bounds_planes(col)
        data, out_off = _replace_full(
            col, rb, p, r, m, rl, bordered, -1, bcap
        )
        return data[None], out_off[None]

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    return jax.jit(fn)(data_sh, offsets_sh, validity_sh)


def distributed_contains(chars_sh, lens_sh, pattern: str, mesh, axis="data"):
    """Row-sharded regex contains + global match count via psum."""
    from .compat import shard_map
    from ..regex.ops import get_program

    dp = get_program(pattern)

    def local(chars, lens):
        m = dp.nfa_matches(chars[0], lens[0], False)[None]
        total = jax.lax.psum(jnp.sum(m.astype(jnp.int32)), axis)
        return m, total

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P()),
    )
    return jax.jit(fn)(chars_sh, lens_sh)
