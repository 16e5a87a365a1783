"""Device-side formatting constructors vs the round-1 host oracles.

VERDICT r1 item 4: itos/ftos/int2ip/from_booleans/int2timestamp must run
on device (convert.cu:257-921, datetime.cu:639) with byte-identical
output.  The old host-loop formatters (_float_to_string, _format_one)
remain in-tree purely as oracles for these tests.
"""

import numpy as np
import pytest

from custrings.column import to_host_strings
from custrings.ops import convert, datetime_k


def test_itos_device_exact():
    rng = np.random.default_rng(0)
    ints = np.concatenate(
        [
            rng.integers(-(10**18), 10**18, 400),
            np.array([0, -1, 1, 9, 10, -10, 2**63 - 1, -(2**63)]),
        ]
    )
    assert to_host_strings(convert.itos(ints)) == [str(int(v)) for v in ints]


def test_int2ip_device_exact():
    rng = np.random.default_rng(1)
    ips = np.concatenate(
        [rng.integers(0, 2**32, 400), np.array([0, 2**32 - 1, 1, 16909060])]
    )
    exp = [
        f"{(v >> 24) & 255}.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}"
        for v in (int(x) for x in ips)
    ]
    assert to_host_strings(convert.int2ip(ips)) == exp


def test_from_booleans_device():
    vals = np.array([True, False, True])
    assert to_host_strings(convert.from_booleans(vals, "Yes", "Nope")) == [
        "Yes",
        "Nope",
        "Yes",
    ]


def test_ftos_device_exact_vs_oracle():
    rng = np.random.default_rng(2)
    vals = np.concatenate(
        [
            rng.normal(0, 1e3, 250),
            rng.normal(0, 1e-6, 80),
            rng.normal(0, 1e20, 80),
            np.array(
                [
                    0.0, -0.0, 1.0, -1.0, 3.14159, 1e9, 1e9 + 1, 1e-4,
                    9.9999999995, 1234567890.123, 1e-300, 1e300,
                    float("nan"), float("inf"), float("-inf"),
                ]
            ),
        ]
    ).astype(np.float64)
    got = to_host_strings(convert.ftos(vals))
    exp = [convert._float_to_string(float(v)) for v in vals]
    assert got == exp


def test_ftos_nulls():
    col = convert.ftos(np.array([1.5, 2.5]), nulls=np.array([True, False]))
    assert to_host_strings(col) == [None, "2.5"]


@pytest.mark.parametrize("units", ["s", "ms", "us", "ns", "D", "h", "m", "Y", "M"])
def test_int2timestamp_device_exact(units):
    rng = np.random.default_rng(3)
    ranges = {
        "s": 10**11, "ms": 10**14, "us": 10**17, "ns": 10**18,
        "D": 10**6, "h": 3 * 10**7, "m": 2 * 10**9,
    }
    if units == "Y":
        vs = rng.integers(-1900 + 1, 8000, 50)
    elif units == "M":
        vs = rng.integers(-23000, 96000, 50)
    else:
        r = ranges[units]
        vs = rng.integers(-r // 40, r, 50)
    fmt = "%Y-%m-%dT%H:%M:%S.%f %p %j%z"
    got = to_host_strings(datetime_k.int2timestamp(vs, units=units, fmt=fmt))
    items = datetime_k._compile(fmt)
    exp = [datetime_k._format_one(int(v), units, items) for v in vs]
    assert got == exp


def test_int2timestamp_nulls_default_fmt():
    got = to_host_strings(
        datetime_k.int2timestamp(
            np.array([0, 86400]), units="s", nulls=np.array([True, False])
        )
    )
    assert got == [None, "1970-01-02T00:00:00Z"]
