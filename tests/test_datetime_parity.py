"""Device datetime parser/formatter vs the reference-exact host oracle.

The oracle (_parse_one/_format_one) mirrors datetime.cu byte-for-byte
(see docstrings); the device kernels must agree on every format in the
reference's compiler map — including the quirks: %y = +1900 / -1900,
%j sets the DAY field, %p adds 12 when hour <= 12, %Z only matches UTC,
%a/%A/%b/%B/%w/%U/%W parse every row to 0, and %f width follows units.
"""

import numpy as np
import pytest

from custrings.column import from_host_strings, to_host_strings
from custrings.ops import datetime_k as dk

FORMATS = [
    (None, "s"),
    ("%Y-%m-%d", "D"),
    ("%Y-%m-%dT%H:%M:%S.%f", "us"),
    ("%Y-%m-%dT%H:%M:%S.%f", "ms"),
    ("%Y-%m-%dT%H:%M:%S.%f", "ns"),
    ("%m/%d/%y %I:%M %p", "m"),
    ("%Y-%m-%dT%H:%M:%S%z", "s"),
    ("%Y-%m-%dT%H:%M:%S %Z", "s"),
    ("%Y %j %H", "h"),
    ("%Y", "Y"),
    ("%Y-%m", "M"),
    ("100%% %Y", "Y"),
]


def _corpus(fmt, units):
    rng = np.random.default_rng(hash((fmt, units)) % (2**31))
    vals = rng.integers(0, 4 * 10**9, 8)
    items = dk._compile(fmt or dk.DEFAULT_FORMAT)
    rows = [dk._format_one(int(v), "s", items) for v in vals]
    # quirk rows: tz signs, PM/pm/AM, short rows (error 1), garbage
    # digits, empty, null, bad %Z
    extras = [
        "2019-03-20T12:34:56+0530",
        "2019-03-20T12:34:56-0130",
        "05/20/19 12:30 PM",
        "05/20/19 02:30 pm",
        "05/20/19 02:30 AM",
        "2020 366 23",
        "20",  # shorter than any spec span
        "",
        None,
        "x" * 30,
        "2019-03-20T12:34:56 UTC",
        "2019-03-20T12:34:56 EST",
        "2019-03-20T12:34:56.123456789",
    ]
    return rows + extras


@pytest.mark.parametrize("fmt,units", FORMATS)
def test_parse_device_vs_oracle(fmt, units):
    rows = _corpus(fmt, units)
    col = from_host_strings(rows)
    got = [int(x) for x in dk.timestamp2int(col, fmt, units)]
    exp = [int(x) for x in dk.timestamp2int_host_oracle(col, fmt, units)]
    assert got == exp, [
        (r, g, e) for r, g, e in zip(rows, got, exp) if g != e
    ][:4]


def test_parse_error_specs_zero():
    col = from_host_strings(["Mon 2019", "Tue 2020"])
    for fmt in ("%a %Y", "%A %Y", "%b %Y", "%w %Y", "%U %Y"):
        got = list(dk.timestamp2int(col, fmt, "s"))
        assert got == [0, 0], fmt


def test_unknown_specifier_raises():
    col = from_host_strings(["2019"])
    with pytest.raises(ValueError):
        dk.timestamp2int(col, "%Q", "s")


@pytest.mark.parametrize("units", ["s", "ms", "us", "ns", "D", "h", "m", "Y", "M"])
def test_format_device_vs_oracle_full_matrix(units):
    rng = np.random.default_rng(11)
    ranges = {
        "s": 10**11, "ms": 10**14, "us": 10**17, "ns": 10**18,
        "D": 10**6, "h": 3 * 10**7, "m": 2 * 10**9,
        "Y": 8000, "M": 96000,
    }
    vs = rng.integers(0, ranges[units], 40)
    fmt = "%Y-%m-%dT%H:%M:%S.%f %p %j %I %y%z%Z"
    items = dk._compile(fmt)
    got = to_host_strings(
        dk.int2timestamp(vs, units=units, fmt=fmt)
    )
    exp = [dk._format_one(int(v), units, items) for v in vs]
    assert got == exp, [
        (v, g, e) for v, g, e in zip(vs, got, exp) if g != e
    ][:4]


def test_roundtrip_default():
    vals = [0, 1, 86399, 1553085296, 1583020799]
    s = dk.int2timestamp(np.asarray(vals), units="s")
    back = [int(x) for x in dk.timestamp2int(s)]
    assert back == vals
