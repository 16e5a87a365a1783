"""Tracing / profiling utilities.

The reference ships only a GetTime() helper (cpp/src/Timing.h:25-45).
Here: per-op wall-time + bytes-moved counters and a jax.profiler bridge;
with a peak bandwidth (benchmarks/common.PEAK_HBM_BYTES_PER_SEC) the
report adds each op's roofline share.

Usage:
    from custrings.utils import tracing
    with tracing.enabled():
        ... run ops ...
    print(tracing.report())

    with tracing.device_trace("/tmp/jaxtrace"):   # XLA-level trace
        ... run ops ...
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_records: dict = defaultdict(lambda: [0, 0.0, 0])  # name -> [calls, secs, bytes]
_active = False


@contextlib.contextmanager
def enabled():
    global _active
    _active, prev = True, _active
    try:
        yield
    finally:
        _active = prev


@contextlib.contextmanager
def op(name: str, nbytes: int = 0):
    """Record one op invocation (wall time incl. dispatch + sync)."""
    if not _active:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        rec = _records[name]
        rec[0] += 1
        rec[1] += dt
        rec[2] += nbytes


def report(peak_bytes_per_sec: float | None = None) -> str:
    """Per-op table; the roofline column needs the device's peak
    bandwidth and reads n/a without it."""
    lines = ["op                         calls     total_s   GB/s    roofline%"]
    for name, (calls, secs, nbytes) in sorted(_records.items()):
        bw = (nbytes / secs / 1e9) if secs else 0.0
        if peak_bytes_per_sec and secs:
            roof = f"{100.0 * (nbytes / secs) / peak_bytes_per_sec:>8.2f}"
        else:
            roof = f"{'n/a':>8}"
        lines.append(
            f"{name:<26} {calls:>5}  {secs:>10.4f}  {bw:>6.2f}  {roof}"
        )
    return "\n".join(lines)


def reset():
    _records.clear()


def _payload_bytes(obj) -> int:
    """Sum of device-array byte sizes reachable from obj (pytree walk).

    Proxy for device-memory traffic: every op reads its input arrays and writes its
    output arrays at least once, so in+out payload is the roofline floor."""
    import jax

    total = 0
    for leaf in jax.tree_util.tree_leaves(obj):
        size = getattr(leaf, "nbytes", None)
        if isinstance(size, int):
            total += size
    return total


def traced(name: str):
    """Wrap a public op so each call records wall time + payload bytes.

    Inactive tracing costs one attribute check.  Active tracing blocks on
    the result (async dispatch would otherwise measure only the enqueue)."""
    import functools

    def deco(fn):
        from .jitguard import call_resilient

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _active:
                return call_resilient(lambda: fn(*args, **kwargs))
            import jax

            t0 = time.perf_counter()
            out = call_resilient(lambda: fn(*args, **kwargs))
            jax.block_until_ready(
                [
                    leaf
                    for leaf in jax.tree_util.tree_leaves(out)
                    if hasattr(leaf, "block_until_ready")
                ]
            )
            dt = time.perf_counter() - t0
            rec = _records[name]
            rec[0] += 1
            rec[1] += dt
            rec[2] += _payload_bytes((args, out))

            return out

        return wrapper

    return deco


def instrument_module(mod, prefix: str, names=None) -> None:
    """Wrap every public function defined in `mod` with traced().

    Called once at package import (custrings/__init__.py); underscore
    names (jitted internals) are left untouched so tracing measures whole
    ops, not program phases."""
    import inspect

    for n in names if names is not None else dir(mod):
        if n.startswith("_"):
            continue
        fn = getattr(mod, n, None)
        if (
            inspect.isfunction(fn)
            and fn.__module__ == mod.__name__
            and not getattr(fn, "_traced", False)
        ):
            wrapped = traced(f"{prefix}.{n}")(fn)
            wrapped._traced = True
            setattr(mod, n, wrapped)


@contextlib.contextmanager
def device_trace(logdir: str):
    """XLA-level profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
