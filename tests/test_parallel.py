"""Multi-chip tests on the 8-device virtual CPU mesh: collective
dictionary build (the nvcategory key-merge) and row-sharded regex."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from custrings import column
from custrings.ops.unique import dictionary_encode
from custrings.parallel import dist


def make_mesh(n):
    devs = jax.devices()[:n]
    return Mesh(np.array(devs), ("data",))


CORPUS = (
    ["eee", "aaa", "eee", "ddd", "ccc"] * 5
    + ["zzz", "bbb", None, "", "aaa"] * 3
    + ["mmm"]
)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_distributed_categorize_matches_single_chip(n_dev):
    col = column.from_host_strings(CORPUS)
    keys, values = dictionary_encode(col)
    expected = np.asarray(jax.device_get(values))

    mesh = make_mesh(n_dev)
    d, o, v, a = dist.shard_column(col, n_dev)
    vals_sh, n_global = dist.distributed_categorize(d, o, v, a, mesh)
    flat = np.asarray(jax.device_get(vals_sh)).reshape(-1)
    alive = np.asarray(jax.device_get(a)).reshape(-1)
    got = flat[alive]
    assert int(n_global) == keys.size
    assert got.tolist() == expected.tolist()


def test_distributed_contains():
    strs = ["hello123", "no digits", None, "42", "x"] * 4
    col = column.from_host_strings(strs)
    n_dev = 4
    mesh = make_mesh(n_dev)
    from custrings.ops import layout

    chars, nch = layout.char_matrix(col)
    n = col.size
    per = n // n_dev
    chars_sh = jnp.asarray(np.asarray(chars).reshape(n_dev, per, -1))
    lens_sh = jnp.asarray(np.asarray(nch).reshape(n_dev, per))
    m, total = dist.distributed_contains(chars_sh, lens_sh, r"\d+", mesh)
    got = np.asarray(jax.device_get(m)).reshape(-1)
    import re

    exp = [bool(re.search(r"\d+", s)) if s else False for s in strs]
    assert got.tolist() == exp
    assert int(total) == sum(exp)


def test_distributed_unique_tokens():
    strs = ["the quick fox", "the lazy dog", None, "fox and dog run",
            "quick quick"] * 2
    col = column.from_host_strings(strs)
    mesh = make_mesh(2)
    ids, n_unique = dist.distributed_unique_tokens(col, mesh)
    from custrings.text.token import unique_tokens

    exp = unique_tokens(col, None)
    assert int(n_unique) == exp.size


def test_distributed_replace():
    strs = ["the quick the", "other theory", None, "no match here"] * 2
    col = column.from_host_strings(strs)
    mesh = make_mesh(4)
    d, o, v, a = dist.shard_column(col, 4)
    data_sh, off_sh = dist.distributed_replace(d, o, v, mesh, "the", "A")
    # rebuild shard rows and compare against single-chip op
    got = []
    for s in range(4):
        shard = column.StringColumn(data_sh[s], off_sh[s], v[s])
        h = column.to_host_strings(shard)
        alive = np.asarray(jax.device_get(a[s]))
        got.extend([x for x, al in zip(h, alive) if al])
    exp = [s.replace("the", "A") if s is not None else None for s in strs]
    assert got == exp


@pytest.mark.parametrize("n_dev", [4, 8])
def test_distributed_categorize_skewed_ranges(n_dev):
    # contiguous sorted shards => each shard's keys land in ONE owner
    # range, overflowing the per-pair PSRS capacity; the driver must
    # transparently fall back to the gathered merge with identical output
    corpus = [f"k{i:06d}" for i in range(n_dev * 24)]
    col = column.from_host_strings(corpus)
    keys, values = dictionary_encode(col)
    expected = np.asarray(jax.device_get(values))

    mesh = make_mesh(n_dev)
    d, o, v, a = dist.shard_column(col, n_dev)
    vals_sh, n_global = dist.distributed_categorize(d, o, v, a, mesh)
    flat = np.asarray(jax.device_get(vals_sh)).reshape(-1)
    alive = np.asarray(jax.device_get(a)).reshape(-1)
    assert int(n_global) == keys.size
    assert flat[alive].tolist() == expected.tolist()


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_column_end_to_end(n_dev):
    """BASELINE workload 5 through the public ShardedStringColumn API:
    replace (growing) + contains + categorize + unique_tokens."""
    import re

    from custrings.parallel.sharded import ShardedStringColumn

    strs = (
        ["the cat sat on the mat #tag", "no match here", None, ""] * 6
        + ["the end 42", "a the b the c"]
    )
    col = column.from_host_strings(strs)
    mesh = make_mesh(n_dev)
    sc = ShardedStringColumn.from_column(col, mesh)
    assert sc.size() == len(strs)

    # growing replace (rl > m was rejected in round 1)
    sc2 = sc.replace("the", "THEIR!")
    back = column.to_host_strings(sc2.to_column())
    exp = [s.replace("the", "THEIR!") if s is not None else None for s in strs]
    assert back == exp

    # contains + global count
    mask, total = sc.contains_re(r"#\w+")
    flat = np.asarray(jax.device_get(mask)).reshape(-1)
    alive = np.asarray(jax.device_get(sc.alive)).reshape(-1)
    expm = [bool(re.search(r"#\w+", s)) if s else False for s in strs]
    assert flat[alive].tolist() == expm
    assert int(total) == sum(expm)

    # categorize parity with single-chip
    values, n_keys = sc.categorize()
    _, exp_vals = dictionary_encode(col)
    gv = np.asarray(jax.device_get(values)).reshape(-1)[alive]
    assert gv.tolist() == np.asarray(jax.device_get(exp_vals)).tolist()

    # device-side unique tokens: global unique count parity
    ids, n_unique = sc.unique_tokens()
    exp_tokens = sorted(
        set(t for s in strs if s for t in s.split() if t)
    )
    assert int(n_unique) == len(exp_tokens)
    # ids cover exactly [0, n_unique)
    gi = np.asarray(jax.device_get(ids)).reshape(-1)
    assert set(gi[gi >= 0].tolist()) == set(range(len(exp_tokens)))


def test_sharded_unique_tokens_delimiter():
    from custrings.parallel.sharded import ShardedStringColumn

    strs = ["a,b,c", "b,c", None, "c,d,,e"] * 4
    col = column.from_host_strings(strs)
    mesh = make_mesh(4)
    sc = ShardedStringColumn.from_column(col, mesh)
    ids, n_unique = sc.unique_tokens(",")
    toks = set()
    for s in strs:
        if s:
            toks.update(t for t in s.split(",") if t)
    assert int(n_unique) == len(toks)


@pytest.mark.parametrize("n_shards", [1, 3, 8, 40])
def test_shard_rows_matches_shard_column(n_shards):
    # host-row shards equal the device-column shards, padding included
    # (40 shards over 31 rows leaves trailing all-padding shards)
    col = column.from_host_strings(CORPUS)
    want = [np.asarray(jax.device_get(x))
            for x in dist.shard_column(col, n_shards)]
    got = dist.shard_rows(CORPUS, n_shards)
    for w, g in zip(want, got):
        assert isinstance(g, np.ndarray)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_shard_global_one_shard_per_device():
    from custrings.parallel import runtime

    mesh = make_mesh(4)
    sc = runtime.shard_global(CORPUS, mesh)
    assert sc.size() == len(CORPUS)
    for x in (sc.data, sc.offsets, sc.validity, sc.alive):
        owners = sorted(
            (sh.index[0].start, [d.id for d in sh.data.devices()])
            for sh in x.addressable_shards
        )
        assert [o for _, o in owners] == [[d.id] for d in mesh.devices]
    assert column.to_host_strings(sc.to_column()) == CORPUS
