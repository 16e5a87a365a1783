"""Kernel-vs-XLA timings on the card.

    python benchmarks/kernels.py [rows ...]     (default 16384 1048576 4194304)

For each size, on one seeded tweet corpus (benchmarks/corpus.py):
  contains   public op rx.contains_re(#\\w+) on the kernel route (bit-NFA
             Triton kernel) and on the XLA route, plus the two engines
             alone on a prebuilt char matrix;
  spans      public op rx.findall_record(#\\w+) and the first-match
             engines alone (bit span kernels vs min-plus nfa_spans).
With --xla-paths it instead times the plain XLA paths that replaced
removed kernels: hash_mm3 (nvstrings.hash), the padded row-window view,
the inclusive cumsum over a capacity-sized plane, and the compaction
writer (`shift_compact.compact_arrays`).
Variants run in turns A B B A, each the median of 3 timed calls after a
warm-up call; times are wall clock around work that ends in
block_until_ready.  Prints one JSON line per measurement, and exits
non-zero when any variant failed (its record keeps the error text).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import common, corpus  # noqa: E402


def _time(fn, reps: int = 3) -> float:
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _abba(name, rows, a, b, fa, fb, extra=None, switch=None):
    """Run A B B A; print and return the record (or the error).

    switch(tag), when given, selects the variant before its turn and
    drops the jit caches (routes are read while tracing)."""
    out = {a: [], b: []}
    try:
        for tag, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
            if switch is not None:
                switch(tag)
                jax.clear_caches()
            out[tag].append(_time(fn))
    except Exception as e:  # keep measuring the other benches
        out["error"] = f"{type(e).__name__}: {str(e)[:300]}"
    rec = {"bench": name, "rows": rows, **out}
    if extra:
        rec.update(extra)
    if switch is not None:
        switch(None)
        jax.clear_caches()
    print(json.dumps(rec), flush=True)
    return rec


def run(rows: int, seed: int = 0):
    from custrings import column, config
    from custrings.ops import layout
    from custrings.regex import ops as rx

    lines = corpus.tweets(rows, seed, workers=os.cpu_count() or 1)
    col = column.from_host_strings(lines)
    real_route = config.kernel_route

    def set_route(tag):
        config.kernel_route = (
            real_route if tag is None else (lambda platform=None: tag)
        )

    def fresh_contains():
        c = column.StringColumn(col.data, col.offsets, col.validity)
        return rx.contains_re(c, r"#\w+")

    recs = [_abba("contains_op", rows, "kernel", "xla", fresh_contains,
                  fresh_contains, switch=set_route)]
    chars, nch = layout.char_matrix(col)
    dp = rx.get_program(r"#\w+")
    nfa = rx.get_bit_nfa(r"#\w+")
    recs.append(_abba("contains_engine", rows, "kernel", "xla",
                      lambda: nfa.matches(chars, nch, False, True),
                      lambda: dp.nfa_matches(chars, nch, False, True),
                      {"width": int(chars.shape[1])}))
    zeros = jnp.zeros(chars.shape[0], jnp.int32)
    sb = dp._span_bits()
    recs.append(_abba("spans_engine", rows, "kernel", "xla",
                      lambda: sb.single(chars, nch, zeros, True),
                      lambda: dp.nfa_spans(chars, nch, zeros, True)))
    del chars, nch

    def findall():
        c = column.StringColumn(col.data, col.offsets, col.validity)
        tc = rx.findall_record(c, r"#\w+")
        return tc.tokens.data

    recs.append(_abba("findall_op", rows, "kernel", "xla", findall,
                      findall, switch=set_route))
    return recs


def run_xla_paths(rows: int, seed: int = 0):
    from custrings import column
    from custrings.ops import convert, layout, segments, shift_compact

    lines = corpus.tweets(rows, seed, workers=os.cpu_count() or 1)
    col = column.from_host_strings(lines)
    width = layout.max_row_bytes(col)
    keep = col.data != 0x20
    cumsum = jax.jit(segments.cumsum)
    compact = jax.jit(lambda k, d: shift_compact.compact_arrays(k, [d]))
    cases = {
        "hash_mm3": lambda: convert.hash_mm3(col),
        "padded_view": lambda: layout._padded_view(
            col.data, col.offsets, width),
        "cumsum": lambda: cumsum(keep),
        "compact_arrays": lambda: compact(keep, col.data),
    }
    recs = []
    for name, fn in cases.items():
        rec = {"bench": name, "rows": rows, "capacity": col.capacity,
               "width": width}
        try:
            rec["xla_s"] = _time(fn)
        except Exception as e:  # keep measuring the other paths
            rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    xla_paths = "--xla-paths" in argv
    argv = [a for a in argv if a != "--xla-paths"]
    rec = common.device_record()
    if rec["platform"] != "gpu":
        print(f"kernels.py: needs a GPU, JAX found {rec['platform']!r}")
        return 1
    print(f"device {json.dumps(rec)}; {common.gpu_name_and_power_limit()}",
          flush=True)
    common.init_compile_cache()
    recs = []
    for rows in [int(a) for a in argv] or [1 << 14, 1 << 20, 1 << 22]:
        recs += (run_xla_paths if xla_paths else run)(rows)
    failed = [r["bench"] for r in recs if "error" in r]
    if failed:
        print(f"kernels.py: failed: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
