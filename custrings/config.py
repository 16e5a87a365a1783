"""Global configuration for the columnar string engine.

The reference library (cuStrings) has no runtime config system — only
build-time CMake flags (SURVEY §5.6).  Here a small config object is
genuinely useful: XLA compiles one program per distinct shape, so dynamic
byte-counts are bucketed into a geometric series of capacities to keep the
jit cache small.  `kernel_route` is the one place that decides whether the
hand-written GPU kernels or the plain XLA paths run.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # Bytes buffers are padded up to a bucket capacity so that materializing
    # ops (split/replace/case/...) hit the XLA compile cache instead of
    # recompiling for every distinct output byte-count.  `bucket_bits` is the
    # number of significand bits kept: capacity = ceil(n / 2^k) * 2^k with
    # 2^k = 2^(floor(log2 n) - bucket_bits).  3 bits -> <= 12.5% padding.
    bucket_bits: int = 3
    # Minimum capacity of any byte buffer (keeps tiny test columns aligned).
    min_bucket: int = 128
    # Default maximum instruction count accepted by the regex compiler
    # (reference caps stack tiers at 1000 insts, cpp/src/regex/regex.cuh:80-88).
    max_regex_insts: int = 1000


CONFIG = Config()


def bucket_bytes(n: int, cfg: Config = CONFIG) -> int:
    """Round byte-count n up to a bucketed capacity (geometric series)."""
    n = int(n)
    if n <= cfg.min_bucket:
        return cfg.min_bucket
    step = 1 << max((n - 1).bit_length() - cfg.bucket_bits, 0)
    return -(-n // step) * step


def kernel_route(platform: str | None = None) -> str:
    """Which implementation the kernel-backed ops run on `platform`
    (default: JAX's default backend).

    "kernel" on a GPU: the compiled Pallas (Triton) kernels.
    "xla" on the CPU: the plain XLA paths, which are also the kernels'
    reference.  Any other platform is refused rather than silently
    falling back.  Interpret mode is never chosen here: tests reach it
    through the kernels' explicit `interpret` argument."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(
        f"custrings runs on 'gpu' or 'cpu'; the {platform!r} backend is "
        "not supported"
    )
