"""The route choice (config.kernel_route), the compile-cache directory
rule, and chip_smoke.py's phases at tiny size on the CPU."""

import json
import os
import sys

import pytest

from custrings import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,route", [("cpu", "xla"), ("gpu", "kernel")]
)
def test_kernel_route(platform, route):
    assert config.kernel_route(platform) == route


@pytest.mark.parametrize("platform", ["tpu", "METAL", "rocm"])
def test_kernel_route_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError):
        config.kernel_route(platform)


def test_kernel_route_default_backend_here():
    assert config.kernel_route() == "xla"


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    from benchmarks import common

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert common.compile_cache_dir("/any/checkout") == str(tmp_path / "c")


def test_compile_cache_dir_env_unset(monkeypatch):
    from benchmarks import common

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert common.compile_cache_dir("/co") == os.path.join("/co", ".jax_cache")
    # fixed: no content hash in the path
    assert common.compile_cache_dir(ROOT) == common.compile_cache_dir(ROOT)
    assert common.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_peak_table_unknown_device_has_no_roofline():
    from benchmarks import common

    assert common.peak_hbm_bytes_per_sec("NVIDIA H100 80GB HBM3") == 3.35e12
    assert common.peak_hbm_bytes_per_sec("cpu") is None


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    from benchmarks.corpus import tweets
    from custrings import nvstrings

    lines = tweets(600, 3)
    return chip_smoke, nvstrings.to_device(lines), lines


@pytest.mark.parametrize(
    "phase",
    ["upload", "contains", "replace", "replace_grow", "split",
     "categorize", "findall", "extract", "replace_re"],
)
def test_chip_smoke_phase_cpu(smoke, phase):
    chip_smoke, strs, lines = smoke
    rec = chip_smoke.run_phase(phase, strs, lines, timed=False)
    assert rec["phase"] == phase


def test_chip_smoke_check_catches_mismatch(smoke):
    chip_smoke, strs, lines = smoke
    got = chip_smoke.phase_contains(strs, lines)
    i = next(k for k, s in enumerate(lines) if s is not None)
    got[i] = not got[i]
    with pytest.raises(AssertionError):
        chip_smoke.check_contains(got, lines)


def test_chip_smoke_refuses_cpu(smoke, capsys):
    chip_smoke = smoke[0]
    assert chip_smoke.main(["--rows", "16"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")


@pytest.mark.parametrize("n_rows", [3, 401])
def test_chip_smoke_four_cpu(smoke, n_rows):
    # the sharded phase over the 8 virtual CPU devices; 3 rows leave
    # all-padding shards
    from benchmarks.corpus import tweets

    lines = tweets(n_rows, 7)
    rec = smoke[0].run_four(lines, out=lambda msg: None)
    assert rec["rows"] == n_rows and rec["devices"] == 8
    assert rec["keys"] == len(set(lines))


def test_chip_smoke_rank_check_catches_misorder(smoke):
    import numpy as np

    chip_smoke = smoke[0]
    lines = ["b", None, "a", "b", "c"]
    good = np.array([2, 0, 1, 2, 3])
    chip_smoke._check_ranks("ok", good, 4, lines)
    for bad, n_keys in (
        ([1, 0, 2, 1, 3], 4),  # "a" and "b" swapped
        ([2, 0, 1, 3, 4], 5),  # equal rows split
        ([2, 0, 1, 2, 4], 4),  # not dense
    ):
        with pytest.raises(AssertionError):
            chip_smoke._check_ranks("bad", np.array(bad), n_keys, lines)
