"""Set-up shared by the entry scripts (bench.py, benchmarks/resident.py,
chip_smoke.py): the persistent compile cache, the device record and the
peak table."""

from __future__ import annotations

import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Peak device-memory bandwidth (bytes/s) by `device_kind`, from NVIDIA's
#: data sheets (SXM parts).  A device missing here gets no roofline.
PEAK_HBM_BYTES_PER_SEC = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def compile_cache_dir(root: str = ROOT) -> str:
    """Directory of JAX's persistent compile cache.

    JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it itself, and no
    other directory is set in code); otherwise a fixed `.jax_cache/` in
    the checkout, so that the path (part of the cache key) never moves."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        root, ".jax_cache"
    )


def init_compile_cache(root: str = ROOT) -> str:
    """Point JAX's persistent compile cache at compile_cache_dir()."""
    import jax

    path = compile_cache_dir(root)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def peak_hbm_bytes_per_sec(device_kind: str):
    """Peak bandwidth of this device kind, or None (no roofline)."""
    return PEAK_HBM_BYTES_PER_SEC.get(device_kind)


def device_record() -> dict:
    """platform / device_kind / count as JAX reports them."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output (one line per
    card), or the reason it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"
    return out.stdout.strip()
