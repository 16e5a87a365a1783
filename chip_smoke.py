"""On-card smoke test of the main path, at a size users call real.

    python chip_smoke.py              # 4M tweet-shaped rows on one GPU
    python chip_smoke.py --rows N     # another size
    python chip_smoke.py --four       # only the sharded phase, over
                                      # every GPU, 4M rows per GPU

Drives the public API (`nvstrings.to_device`, `nvcategory.from_strings`,
back to the host) through the 4-op pipeline the benchmark times —
contains_re(#\\w+), literal replace (same length and growing), split by
" ", dictionary encode — plus the span ops riding the regex span engines
(findall, extract, replace_re).  Every output is compared byte-exactly
with a plain host reference (Python str / re, sorted-unique for the
dictionary, a byte-level numpy split).  Each phase runs once to compile
and once timed.  The last phase runs the GPU-marked tests in this same
process.  The last line is a JSON object; it is printed only when every
phase matched and JAX's platform is "gpu".
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from benchmarks import common, corpus  # noqa: E402

HASHTAG = r"#\w+"
MENTION = r"@(\w+)"
ALT = "the|that"


# ----------------------------------------------------------------- phases
# Each phase takes (strs, lines): the uploaded nvstrings and the host rows
# it came from, returns the device result brought back to the host, and a
# `check_*` twin compares it with the host reference (raises on mismatch).


def _mismatch(name, got, want):
    if got == want:
        return
    n = len(want) if hasattr(want, "__len__") else 0
    first = next(
        (i for i in range(min(len(got), n)) if got[i] != want[i]), None
    )
    detail = (
        f"row {first}: got {got[first]!r} want {want[first]!r}"
        if first is not None
        else f"lengths {len(got)} vs {n}"
    )
    raise AssertionError(f"{name} mismatch at {detail}")


def phase_upload(strs, lines):
    return strs.to_host()


def check_upload(got, lines):
    _mismatch("upload", got, lines)


def phase_contains(strs, lines):
    return strs.contains(HASHTAG)


def check_contains(got, lines):
    rx = re.compile(HASHTAG)
    want = [None if s is None else rx.search(s) is not None for s in lines]
    _mismatch("contains", got, want)


def phase_replace(strs, lines):
    return strs.replace("the", "THE", regex=False).to_host()


def check_replace(got, lines):
    want = [None if s is None else s.replace("the", "THE") for s in lines]
    _mismatch("replace", got, want)


def phase_replace_grow(strs, lines):
    return strs.replace("the", "THEE", regex=False).to_host()


def check_replace_grow(got, lines):
    want = [None if s is None else s.replace("the", "THEE") for s in lines]
    _mismatch("replace_grow", got, want)


def phase_split(strs, lines):
    """split_record(" ") as flat host arrays: (token bytes, token byte
    lengths, tokens per row, row validity).  nvstrings.split_record
    returns this same TokenColumn sliced into one host object per row."""
    import jax

    from custrings.ops import split

    tc = split.split_record(strs._col, " ")
    data, toff, roff, rval = jax.device_get(
        (tc.tokens.data, tc.tokens.offsets, tc.row_offsets, tc.row_validity)
    )
    toff = np.asarray(toff, np.int64)
    return (
        np.asarray(data)[: toff[-1]],
        np.diff(toff),
        np.diff(np.asarray(roff, np.int64)),
        np.asarray(rval, bool),
    )


def check_split(got, lines):
    """Reference: Python bytes.split(b" ") of every valid row."""
    data, tlens, counts, valid = got
    _mismatch("split validity", valid.tolist(), [s is not None for s in lines])
    enc = [s.encode() for s in lines if s is not None]
    want_counts = np.asarray([e.count(b" ") + 1 for e in enc], np.int64)
    _mismatch("split counts", counts[valid].tolist(), want_counts.tolist())
    if counts[~valid].any():
        raise AssertionError("split: null rows own tokens")
    flat = np.frombuffer(b" ".join(enc), np.uint8)
    want_data = flat[flat != 0x20]
    if not np.array_equal(data, want_data):
        raise AssertionError("split token bytes mismatch")
    # token lengths: distances between consecutive separators, where the
    # row joins above add one separator per row boundary
    sep = np.flatnonzero(flat == 0x20)
    bounds = np.concatenate([[-1], sep, [flat.size]])
    want_lens = np.diff(bounds) - 1
    if not np.array_equal(tlens, want_lens):
        raise AssertionError("split token lengths mismatch")
    # sampled check against str.split itself
    step = max(len(lines) // 1000, 1)
    for i in range(0, len(lines), step):
        if lines[i] is None:
            continue
        a = int(np.sum(counts[:i]))
        lens_i = tlens[a : a + counts[i]]
        want_i = [len(t.encode()) for t in lines[i].split(" ")]
        _mismatch(f"split row {i}", lens_i.tolist(), want_i)


def phase_categorize(strs, lines):
    from custrings import nvcategory

    cat = nvcategory.from_strings(strs)
    return cat.keys().to_host(), cat.values()


def check_categorize(got, lines):
    keys, values = got
    uniq = sorted({s for s in lines if s is not None})
    want_keys = ([None] if any(s is None for s in lines) else []) + uniq
    _mismatch("categorize keys", keys, want_keys)
    index = {k: i for i, k in enumerate(want_keys)}
    _mismatch("categorize values", values, [index[s] for s in lines])


def phase_findall(strs, lines):
    return [c.to_host() for c in strs.findall(HASHTAG)]


def check_findall(got, lines):
    rx = re.compile(HASHTAG)
    found = [[] if s is None else rx.findall(s) for s in lines]
    ncol = max((len(f) for f in found), default=0)
    want = [
        [f[k] if len(f) > k else None for f in found] for k in range(ncol)
    ]
    _mismatch("findall columns", [len(got)], [ncol])
    for k in range(ncol):
        _mismatch(f"findall column {k}", got[k], want[k])


def phase_extract(strs, lines):
    return [c.to_host() for c in strs.extract(MENTION)]


def check_extract(got, lines):
    rx = re.compile(MENTION)
    want = []
    for s in lines:
        m = None if s is None else rx.search(s)
        want.append(m.group(1) if m else None)
    _mismatch("extract groups", [len(got)], [1])
    _mismatch("extract", got[0], want)


def phase_replace_re(strs, lines):
    return strs.replace(ALT, "X", regex=True).to_host()


def check_replace_re(got, lines):
    rx = re.compile(ALT)
    want = [None if s is None else rx.sub("X", s) for s in lines]
    _mismatch("replace_re", got, want)


PHASES = {
    name: (globals()[f"phase_{name}"], globals()[f"check_{name}"])
    for name in (
        "upload", "contains", "replace", "replace_grow", "split",
        "categorize", "findall", "extract", "replace_re",
    )
}


def run_phase(name, strs, lines, timed: bool = True):
    """Run one phase (compile + timed run when `timed`), check it, and
    return its record.  Raises AssertionError on a mismatch."""
    fn, check = PHASES[name]
    t0 = time.perf_counter()
    got = fn(strs, lines)
    first = time.perf_counter() - t0
    rec = {"phase": name, "first_s": first}
    if timed:
        t0 = time.perf_counter()
        got = fn(strs, lines)
        rec["warm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(got, lines)
    rec["reference_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------ four cards


def _check_ranks(name, values, n_keys, lines):
    """`values` are the ranks of `lines` in their sorted unique keyset
    (None first): walking the rows in value order, equal values hold
    equal strings and each next value a greater one (Python orders str
    by code point, which is UTF-8 byte order), and the values run
    densely from 0 to n_keys - 1."""
    order = np.argsort(values, kind="stable")
    sv = values[order]
    steps = np.diff(sv)
    if len(sv) and (sv[0] != 0 or sv[-1] != n_keys - 1 or
                    not np.isin(steps, (0, 1)).all()):
        raise AssertionError(f"{name}: values not dense in [0, {n_keys})")
    rows = [lines[i] for i in order.tolist()]
    for k, (a, b, same) in enumerate(zip(rows, rows[1:],
                                         (steps == 0).tolist())):
        ok = (a == b) if same else (
            (a is None and b is not None)
            or (a is not None and b is not None and a < b)
        )
        if not ok:
            i, j = int(order[k]), int(order[k + 1])
            raise AssertionError(
                f"{name}: rows {i} {a!r} and {j} {b!r} ranked "
                f"{sv[k]} and {sv[k + 1]}"
            )


def run_four(lines, out=print):
    """Sharded dictionary build, replace and contains over every device,
    compared with the host reference on all rows and with the one-device
    result shard by shard (the rows of all shards together may pass one
    column's 2^31 bytes)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from custrings import column, nvcategory, nvstrings
    from custrings.ops import layout
    from custrings.parallel import dist, runtime

    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("data",))
    S = len(devs)
    n = len(lines)
    t0 = time.perf_counter()
    sc = runtime.shard_global(lines, mesh)
    out(f"four: shard_global {time.perf_counter() - t0:.3f}s")
    for name in ("data", "offsets", "validity", "alive"):
        x = getattr(sc, name)
        owners = [sorted(dv.id for dv in sh.data.devices())
                  for sh in sorted(x.addressable_shards,
                                   key=lambda t: t.index[0].start)]
        out(f"four: {name} shards on devices {owners}")
        if owners != [[dv.id] for dv in devs]:
            raise AssertionError(f"four: {name} not one shard per device")
    for dv in devs:
        st = dv.memory_stats() or {}
        out(f"four: device {dv.id} bytes_in_use after sharding "
            f"{st.get('bytes_in_use')}")
    R = sc.R
    alive = np.asarray(jax.device_get(sc.alive)).reshape(-1)

    def shards(x):
        """Per-device arrays of a stacked [S, ...] array, in shard order."""
        return [sh.data[0] for sh in
                sorted(x.addressable_shards, key=lambda t: t.index[0].start)]

    def timed(label, fn):
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn())
        out(f"four: {label} first {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn())
        out(f"four: {label} warm {time.perf_counter() - t0:.3f}s")
        return res

    # categorize (dist.distributed_categorize) vs the host
    values, n_keys = timed("categorize", sc.categorize)
    cat = np.asarray(jax.device_get(values)).reshape(-1)[alive]
    want_keys = len({s for s in lines if s is not None}) + (None in lines)
    if int(n_keys) != want_keys:
        raise AssertionError(f"four: {int(n_keys)} keys, host {want_keys}")
    _check_ranks("four categorize vs host", cat, int(n_keys), lines)

    # same-length literal replace vs the host
    rd, ro = timed("replace", lambda: dist.distributed_replace(
        sc.data, sc.offsets, sc.validity, mesh, "the", "THE"))
    rep = []
    for d, o, v, k in zip(shards(rd), shards(ro), shards(sc.validity),
                          range(S)):
        rows = column.to_host_strings(column.StringColumn(d, o, v))
        rep += rows[: max(min(n - k * R, R), 0)]
    _mismatch("four replace vs host", rep,
              [None if t is None else t.replace("the", "THE")
               for t in lines])

    # contains vs the host: per-shard char matrices built on their own
    # devices at the widest shard's width, and the psum'd match count
    cols = [column.StringColumn(d, o, v) for d, o, v in
            zip(shards(sc.data), shards(sc.offsets), shards(sc.validity))]
    W = max(layout.max_row_bytes(c) for c in cols)
    mats = [layout.char_matrix(c, W) for c in cols]
    sh = NamedSharding(mesh, P("data"))
    chars = jax.make_array_from_single_device_arrays(
        (S, R, W), sh, [m[0][None] for m in mats])
    nch = jax.make_array_from_single_device_arrays(
        (S, R), sh, [m[1][None] for m in mats])
    del mats
    m, total = timed("contains", lambda: dist.distributed_contains(
        chars, nch, HASHTAG, mesh))
    del chars, nch
    m = np.asarray(jax.device_get(m)).reshape(-1)[alive]
    rx = re.compile(HASHTAG)
    con = [bool(x) for x in m.tolist()]
    _mismatch("four contains vs host", con,
              [t is not None and rx.search(t) is not None for t in lines])
    if int(total) != sum(con):
        raise AssertionError(f"four: psum total {int(total)}, "
                             f"host {sum(con)}")

    # one device, one shard's rows at a time: the same rows through the
    # single-device public API give the same contains and replace, and a
    # dictionary whose ranks the sharded ranks follow in the same order
    t0 = time.perf_counter()
    for a in range(0, n, R):
        part = nvstrings.to_device(lines[a:a + R])
        _mismatch(f"four contains vs one device, rows {a}:",
                  con[a:a + R], [bool(x) for x in part.contains(HASHTAG)])
        _mismatch(f"four replace vs one device, rows {a}:", rep[a:a + R],
                  part.replace("the", "THE", regex=False).to_host())
        one = np.asarray(nvcategory.from_strings(part).values())
        to_global = np.full(one.max() + 1, -1, np.int64)
        to_global[one] = cat[a:a + R]
        if not (np.array_equal(to_global[one], cat[a:a + R])
                and (np.diff(to_global) > 0).all()):
            raise AssertionError(
                f"four categorize vs one device, rows {a}: ranks differ")
    out(f"four: one-device comparison {time.perf_counter() - t0:.3f}s")
    return {"rows": n, "devices": S, "keys": want_keys,
            "matches": int(total)}


# ---------------------------------------------------------------- driver


def _largest_program_memory(strs, out):
    """memory_analysis() of the bit-NFA contains program at full width,
    and the per-device peak."""
    import jax

    from custrings.ops import layout
    from custrings.regex import ops as rx

    chars, nch = layout.char_matrix(strs._col)
    if rx.use_bit_kernel(HASHTAG):
        nfa = rx.get_bit_nfa(HASHTAG)
        lowered = type(nfa).matches.lower(nfa, chars, nch, False, True)
    else:
        dp = rx.get_program(HASHTAG)
        lowered = type(dp).nfa_matches.lower(dp, chars, nch, False, True)
    out(f"memory_analysis(contains program {tuple(chars.shape)}): "
        f"{lowered.compile().memory_analysis()}")
    for d in jax.devices():
        st = d.memory_stats() or {}
        out(f"device {d.id} peak_bytes_in_use {st.get('peak_bytes_in_use')}")


def run_gpu_tests(out):
    """The GPU-marked tests, in this process (the card stays with it)."""
    import pytest

    os.environ["CUSTRINGS_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests")]
    )
    out(f"gpu-marked tests exit code {int(rc)}")
    return int(rc) == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 22,
                    help="rows (per device with --four); default 4M")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="only the sharded phase, over every device")
    args = ap.parse_args(argv)

    def out(msg):
        print(msg, flush=True)

    import jax

    devices = jax.devices()
    rec = common.device_record()
    out(f"jax.devices(): {devices}")
    if rec["platform"] != "gpu":
        out(f"chip_smoke: needs a GPU, JAX found {rec['platform']!r}")
        return 1
    out(f"compile cache: {common.init_compile_cache()}")
    out(f"nvidia-smi: {common.gpu_name_and_power_limit()}")
    from custrings.native.build import load as load_native

    out(f"native ingest extension loaded: {load_native() is not None}")
    ok = True
    t0 = time.perf_counter()
    n_rows = args.rows * (len(devices) if args.four else 1)
    lines = corpus.tweets(n_rows, args.seed, workers=os.cpu_count() or 1)
    nbytes = sum(len(s.encode()) for s in lines if s is not None)
    out(f"corpus: {n_rows} rows, {nbytes} bytes, "
        f"{time.perf_counter() - t0:.1f}s")
    if args.four:
        try:
            out(f"four: {json.dumps(run_four(lines, out))}")
        except Exception as e:  # report the phase, then fail the run
            out(f"four: FAIL {type(e).__name__}: {e}")
            ok = False
    else:
        from custrings import nvstrings

        strs = nvstrings.to_device(lines)
        for name in PHASES:
            try:
                r = run_phase(name, strs, lines)
                out(f"phase {json.dumps(r)}")
            except Exception as e:  # report the phase, then fail the run
                out(f"phase {name}: FAIL {type(e).__name__}: {e}")
                ok = False
        try:
            _largest_program_memory(strs, out)
        except Exception as e:
            out(f"memory analysis: FAIL {type(e).__name__}: {e}")
            ok = False
        del strs
        ok = run_gpu_tests(out) and ok
    if not ok:
        out("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
