"""nvcategory parity tests, mirroring python/tests/test_category.py and
test_category_numeric.py expectations."""

import numpy as np

from custrings import category as C
from custrings import column
from custrings import numeric as NC


def dev(strs):
    return column.from_host_strings(strs)


def host(col):
    return column.to_host_strings(col)


S = ["eee", "aaa", "eee", "ddd", "ccc", "ccc", "ccc", "eee", "aaa"]


def test_basic():
    cat = C.from_strings(dev(S))
    assert cat.size == 9
    assert cat.keys_size == 4
    assert host(cat.keys) == ["aaa", "ccc", "ddd", "eee"]
    assert list(cat.values) == [3, 0, 3, 2, 1, 1, 1, 3, 0]


def test_value_lookup():
    cat = C.from_strings(dev(S))
    assert C.value_for_index(cat, 7) == 3
    assert C.value_of(cat, "ccc") == 1
    assert C.value_of(cat, "zzz") == -1
    assert list(C.indexes_for_key(cat, "ccc")) == [4, 5, 6]


def test_to_strings():
    cat = C.from_strings(dev(S))
    assert host(C.to_strings(cat)) == S


def test_from_strings_multi():
    s2 = ["ggg", "fff", "hhh", "aaa", "fff", "fff", "ggg", "hhh", "bbb"]
    cat = C.from_strings(dev(S), dev(s2))
    assert host(cat.keys) == ["aaa", "bbb", "ccc", "ddd", "eee", "fff",
                              "ggg", "hhh"]
    assert list(cat.values) == [4, 0, 4, 3, 2, 2, 2, 4, 0, 6, 5, 7, 0, 5,
                                5, 6, 7, 1]


def test_add_strings():
    cat = C.from_strings(dev(S))
    got = C.add_strings(cat, dev(S))
    assert host(got.keys) == ["aaa", "ccc", "ddd", "eee"]
    assert list(got.values) == [3, 0, 3, 2, 1, 1, 1, 3, 0] * 2


def test_remove_strings():
    cat = C.from_strings(dev(S))
    got = C.remove_strings(cat, dev(["ccc", "aaa", "bbb"]))
    assert host(got.keys) == ["ddd", "eee"]
    assert list(got.values) == [1, 1, 0, 1]


def test_gather_strings():
    cat = C.from_strings(dev(S))
    assert host(C.gather_strings(cat, [0, 2, 0])) == ["aaa", "ddd", "aaa"]


def test_gather_oob_raises():
    cat = C.from_strings(dev(S))
    import pytest

    for fn in (C.gather_strings, C.gather, C.gather_and_remap):
        with pytest.raises(Exception):
            fn(cat, [0, 2, 0, 4])


def test_add_keys():
    cat = C.from_strings(dev(["a", "b", "b", "f", "c", "f"]))
    got = C.add_keys(cat, dev(["a", "b", "c", "d"]))
    assert host(got.keys) == ["a", "b", "c", "d", "f"]
    assert list(got.values) == [0, 1, 1, 4, 2, 4]


def test_remove_keys():
    cat = C.from_strings(dev(["a", "b", "b", "f", "c", "f"]))
    got = C.remove_keys(cat, dev(["b", "d"]))
    assert host(got.keys) == ["a", "c", "f"]
    assert list(got.values) == [0, -1, -1, 2, 1, 2]


def test_set_keys():
    cat = C.from_strings(dev(["a", "b", "b", "f", "c", "f"]))
    got = C.set_keys(cat, dev(["b", "c", "e", "d"]))
    assert host(got.keys) == ["b", "c", "d", "e"]


def test_remove_unused_keys():
    cat = C.from_strings(dev(["a", "b", "b", "f", "c", "f"]))
    got = C.remove_unused_keys(C.set_keys(cat, dev(["b", "c", "e", "d"])))
    assert host(got.keys) == ["b", "c"]


def test_gather():
    cat = C.from_strings(dev(["a", "b", "b", "f", "c", "f"]))
    got = C.gather(cat, [1, 3, 2, 3, 1, 2])
    assert host(got.keys) == ["a", "b", "c", "f"]
    assert list(got.values) == [1, 3, 2, 3, 1, 2]


def test_gather_and_remap():
    cat = C.from_strings(dev(["a", "b", "b", "f", "c", "f"]))
    got = C.gather_and_remap(cat, [1, 3, 2, 3, 1, 2])
    assert host(got.keys) == ["b", "c", "f"]
    assert list(got.values) == [0, 2, 1, 2, 0, 1]


def test_merge_category():
    s2 = ["ggg", "fff", "hhh", "aaa", "fff", "fff", "ggg", "hhh", "bbb"]
    ncat = C.merge_category(C.from_strings(dev(S)), C.from_strings(dev(s2)))
    assert host(ncat.keys) == ["aaa", "ccc", "ddd", "eee", "bbb", "fff",
                               "ggg", "hhh"]
    assert list(ncat.values) == [3, 0, 3, 2, 1, 1, 1, 3, 0, 6, 5, 7, 0, 5,
                                 5, 6, 7, 4]


def test_merge_and_remap():
    s2 = ["ggg", "fff", "hhh", "aaa", "fff", "fff", "ggg", "hhh", "bbb"]
    ncat = C.merge_and_remap(C.from_strings(dev(S)), C.from_strings(dev(s2)))
    assert host(ncat.keys) == ["aaa", "bbb", "ccc", "ddd", "eee", "fff",
                               "ggg", "hhh"]
    assert list(ncat.values) == [4, 0, 4, 3, 2, 2, 2, 4, 0, 6, 5, 7, 0, 5,
                                 5, 6, 7, 1]


def test_category_with_nulls():
    cat = C.from_strings(dev(["b", None, "a", None, "b"]))
    assert host(cat.keys) == [None, "a", "b"]
    assert list(cat.values) == [2, 0, 1, 0, 2]
    assert host(C.to_strings(cat)) == ["b", None, "a", None, "b"]


# ----------------------- numeric -----------------------


def test_numeric_basic():
    cat = NC.from_numbers(np.array([4, 1, 2, 3, 2, 1, 4, 1, 1], np.int32))
    assert cat.keys.shape[0] == 4
    assert list(np.asarray(cat.keys)) == [1, 2, 3, 4]
    assert list(cat.values) == [3, 0, 1, 2, 1, 0, 3, 0, 0]


def test_numeric_float_keys():
    cat = NC.from_numbers(np.array([2, 1, 1.25, 1.5, 1, 1.25, 1, 1, 2]))
    assert list(np.asarray(cat.keys)) == [1.0, 1.25, 1.5, 2.0]


def test_numeric_to_numbers():
    arr = np.array([2, 1, 1.25, 1.5, 1, 1.25, 1, 1, 2])
    cat = NC.from_numbers(arr)
    assert list(np.asarray(NC.to_numbers(cat))) == arr.tolist()


def test_numeric_indexes_for_key():
    cat = NC.from_numbers(np.array([4, 1, 2, 3, 2, 1, 4, 1, 1]))
    assert list(NC.indexes_for_key(cat, 1)) == [1, 5, 7, 8]


def test_numeric_gather_numbers():
    cat = NC.from_numbers(np.array([1, 1.25, 1.5, 1, 1.25, 1, 1, 2]))
    got = NC.gather_numbers(cat, np.array([0, 2, 0], np.int32))
    assert list(np.asarray(got)) == [1.0, 1.5, 1.0]


def test_numeric_nulls():
    narr = np.array([4, 1, 2, 3, 2, 1, 4, 1, 1])
    nulls = np.array([False, False, True, False, True, False, False,
                      False, False])
    cat = NC.from_numbers(narr, nulls)
    assert list(cat.values) == [3, 1, 0, 2, 0, 1, 3, 1, 1]
    assert not bool(cat.keys_valid[0])


def test_numeric_algebra():
    cat = NC.from_numbers(np.array([4, 1, 2, 3, 2, 1, 4, 1, 1], np.int32))
    g = NC.add_keys(cat, np.array([5, 1], np.int32))
    assert list(np.asarray(g.keys)) == [1, 2, 3, 4, 5]
    r = NC.remove_keys(cat, np.array([2], np.int32))
    assert list(np.asarray(r.keys)) == [1, 3, 4]
    assert list(r.values) == [2, 0, -1, 1, -1, 0, 2, 0, 0]
    u = NC.remove_unused_keys(NC.gather(cat, [0, 0, 1]))
    assert list(np.asarray(u.keys)) == [1, 2]
    m = NC.merge_and_remap(
        NC.from_numbers(np.array([1, 3], np.int32)),
        NC.from_numbers(np.array([2, 3], np.int32)),
    )
    assert list(np.asarray(m.keys)) == [1, 2, 3]
    assert list(m.values) == [0, 2, 1, 2]


def test_get_value_bounds():
    cat = C.from_strings(dev(["b", "d", "f", "b"]))
    assert C.get_value_bounds(cat, "d") == (1, 1)
    assert C.get_value_bounds(cat, "c") == (0, 1)
    assert C.get_value_bounds(cat, "a") == (-1, 0)
    assert C.get_value_bounds(cat, "z") == (2, 3)


def test_truncated_prefix_escalation():
    # ADVICE r1 (high): rows sharing a 64B truncated prefix with different
    # lengths must be ordered by the first differing byte PAST the prefix,
    # not by length; the escalation check must fire for this shape.
    import custrings.nvcategory as nvcategory

    c = nvcategory.to_device(["x" * 64 + "b", "x" * 64 + "ac"])
    assert list(c.keys()) == ["x" * 64 + "ac", "x" * 64 + "b"]
    assert c.values() == [1, 0]
    assert c.value("x" * 64 + "ac") == 0
    assert c.value("x" * 64 + "b") == 1
    # long identical rows: escalates then settles, single key
    c2 = nvcategory.to_device(["y" * 100, "y" * 100, "y" * 99 + "z"])
    assert list(c2.keys()) == ["y" * 100, "y" * 99 + "z"]
    assert c2.values() == [0, 0, 1]


def test_indexes_for_key_absent():
    # ADVICE r1 (low): absent key must not alias the removed-key sentinel.
    import numpy as np

    import custrings.nvcategory as nvcategory

    c = nvcategory.to_device(["a", "b", "a"])
    assert len(np.asarray(c.indexes_for_key("zzz"))) == 0


def test_gather_out_of_range_raises():
    # ADVICE r1 (low): out-of-range gather raises instead of clamping.
    import pytest

    import custrings.nvstrings as nvstrings

    s = nvstrings.to_device(["a", "b", "c"])
    with pytest.raises(IndexError):
        s.gather([5])
    assert s.gather([-1]).to_host() == ["c"]


def test_merge_category_chained_unsorted_keyset():
    # After one merge the keyset is unsorted (new keys append,
    # NVCategory.cu:1223); a second merge and value lookups must still
    # find existing keys (round 2: searchsorted silently missed them and
    # appended duplicates).
    from custrings import category as catm
    from custrings import column

    c1 = catm.from_strings(column.from_host_strings(["a", "a", "d", "c", "c", "e"]))
    c2 = catm.from_strings(column.from_host_strings(["a", "b", "b", "f", "c", "f"]))
    c22 = catm.from_strings(column.from_host_strings(["b", "a", "a", "e", "g", "b"]))
    nc = catm.merge_category(c1, c2)
    assert not nc.sorted_keys
    nc2 = catm.merge_category(nc, c22)
    assert column.to_host_strings(nc2.keys) == ["a", "c", "d", "e", "b", "f", "g"]
    assert list(map(int, nc2.values))[12:] == [4, 0, 0, 3, 6, 4]
    # lookups on the unsorted keyset
    assert catm.value_of(nc2, "b") == 4
    assert catm.value_of(nc2, "g") == 6
    assert catm.value_of(nc2, "zzz") == -1
    assert list(catm.indexes_for_key(nc2, "b")) == [7, 8, 12, 17]
    # remove_keys keeps working on the unsorted keyset
    nc3 = catm.remove_keys(nc2, column.from_host_strings(["c"]))
    assert column.to_host_strings(nc3.keys) == ["a", "d", "e", "b", "f", "g"]
    assert catm.value_of(nc3, "b") == 3


def test_hashed_encode_matches_sorted_encode():
    """Round-4 hash-grouped encode vs the radix-sorted oracle."""
    import numpy as np

    from custrings import column
    from custrings.ops import unique as unique_mod

    rng = np.random.default_rng(77)
    pool = ["apple", "pear", "b" * 80, "b" * 80 + "x", "", "zz", None,
            "common prefix " + "q" * 70, "common prefix " + "q" * 70 + "t"]
    for trial in range(4):
        strs = [pool[i] for i in rng.integers(0, len(pool), 200)]
        col = column.from_host_strings(strs)
        full = -(-max((len((s or "").encode()) for s in strs), default=4) // 4) * 4
        full = max(full, 4)
        width = min(full, 16)
        ord_, ranks, values_s, first, amb_s = unique_mod._encode_sorted(
            col, width, full
        )
        values_h, key_rows, nkeys, amb_h, u, ucap = (
            unique_mod._encode_hashed(col, width, full)
        )
        if not bool(amb_s):
            np.testing.assert_array_equal(
                np.asarray(values_h), np.asarray(values_s)
            )
            # key rows agree as STRINGS (representative choice may differ)
            kidx_s = np.asarray(ord_)[np.nonzero(np.asarray(first))[0]]
            kidx_h = np.asarray(key_rows)[: int(nkeys)]
            ks = [strs[i] for i in kidx_s]
            kh = [strs[i] for i in kidx_h]
            assert ks == kh, (trial, ks, kh)
        assert bool(amb_h) == bool(amb_s), trial


def test_key_words_stream_parity():
    """Packed big-endian key words vs a numpy packing of each row."""
    import numpy as np

    from custrings import column
    from custrings.ops import array

    strs = ["alpha", "be", "", "x" * 37, "héllo🎉", "alpha"]
    col = column.from_host_strings(strs)
    w = 40
    got = np.asarray(array._key_words(col, w))
    for r, s in enumerate(strs):
        b = np.zeros(w, np.uint8)
        e = np.frombuffer(s.encode(), np.uint8)
        b[: e.size] = e
        want = b.reshape(-1, 4).astype(np.uint32)
        want = (want[:, 0] << 24) | (want[:, 1] << 16) | (want[:, 2] << 8) | want[:, 3]
        np.testing.assert_array_equal(got[r], want)
