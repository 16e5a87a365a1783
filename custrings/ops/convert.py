"""Number/string conversion ops.

Array re-design of cpp/src/strings/convert.cu: parsing ops (stoi/stol/
stof/stod/htoi/ip2int/to_booleans, hash) run as vectorized char scans on
device; formatting constructors (itos/ftos/int2ip/from_booleans) take HOST
arrays in the reference API (python/nvstrings.py:153-347) and are formatted
with numpy/Python replicating the reference's exact algorithms (notably the
10-significant-digit ftos_converter, convert.cu:450-650).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..column import StringColumn, from_host_strings
from . import layout

_I64 = jnp.int64
_F64 = jnp.float64


def _require_x64():
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------- hash


def hash_mm3(col: StringColumn) -> jax.Array:
    """MurmurHash3_32 seed=31 per row (custring.inl:164-231).

    Vectorized across rows: one lax.fori_loop over 4-byte blocks of the
    padded view.
    """
    w = layout.max_row_bytes(col)
    w4 = -(-w // 4) * 4
    view = layout.padded_view(col, w4).astype(jnp.uint32)
    lens = col.lengths().astype(jnp.uint32)
    n = col.size
    blocks = (
        view[:, 0::4]
        | (view[:, 1::4] << 8)
        | (view[:, 2::4] << 16)
        | (view[:, 3::4] << 24)
    )  # little-endian 32-bit blocks [n, w4//4]
    c1 = jnp.uint32(0xCC9E2D51)
    c2 = jnp.uint32(0x1B873593)

    def rotl(x, r):
        return (x << r) | (x >> (32 - r))

    nblocks = lens // 4

    def body(i, h1):
        k1 = blocks[:, i]
        k1 = k1 * c1
        k1 = rotl(k1, 15)
        k1 = k1 * c2
        h = h1 ^ k1
        h = rotl(h, 13)
        h = h * jnp.uint32(5) + jnp.uint32(0xE6546B64)
        return jnp.where(i < nblocks, h, h1)

    h1 = jax.lax.fori_loop(
        0, w4 // 4, body, jnp.full(n, 31, jnp.uint32)
    )
    # tail
    tail_start = (nblocks * 4).astype(jnp.int32)
    rem = (lens & 3).astype(jnp.int32)

    def tb(i):
        idx = jnp.clip(tail_start + i, 0, w4 - 1)
        return jnp.take_along_axis(view, idx[:, None], axis=1)[:, 0]

    k1 = jnp.zeros(n, jnp.uint32)
    k1 = jnp.where(rem >= 3, k1 ^ (tb(2) << 16), k1)
    k1 = jnp.where(rem >= 2, k1 ^ (tb(1) << 8), k1)
    k1 = jnp.where(rem >= 1, k1 ^ tb(0), k1)
    k1 = k1 * c1
    k1 = rotl(k1, 15)
    k1 = k1 * c2
    h1 = jnp.where(rem > 0, h1 ^ k1, h1)
    h1 = h1 ^ lens
    h1 = h1 ^ (h1 >> 16)
    h1 = h1 * jnp.uint32(0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = h1 * jnp.uint32(0xC2B2AE35)
    h1 = h1 ^ (h1 >> 16)
    return h1


# ---------------------------------------------------------------- parse


def _char_mat(col: StringColumn):
    w = max(layout.max_row_bytes(col), 1)
    return layout.padded_view(col, w).astype(jnp.int32), col.lengths()


def stol(col: StringColumn) -> jax.Array:
    """Leading optional sign + digits; stops at first non-digit
    (custring.inl stol)."""
    _require_x64()
    mat, lens = _char_mat(col)
    n, w = mat.shape
    first = mat[:, 0]
    neg = first == ord("-")
    signed = neg | (first == ord("+"))

    def body(carry, j):
        val, done = carry
        c = mat[:, j]
        in_row = j < lens
        is_sign_pos = signed & (j == 0)
        digit = (c >= ord("0")) & (c <= ord("9")) & in_row
        val = jnp.where(
            ~done & digit, val * 10 + (c - ord("0")).astype(_I64), val
        )
        done = done | (~digit & ~is_sign_pos)
        return (val, done), None

    (val, _), _ = jax.lax.scan(
        body,
        (jnp.zeros(n, _I64), jnp.zeros(n, jnp.bool_)),
        jnp.arange(w),
    )
    val = jnp.where(neg, -val, val)
    return jnp.where(col.validity, val, 0)


def stoi(col: StringColumn) -> jax.Array:
    return stol(col).astype(jnp.int32)


def htoi(col: StringColumn) -> jax.Array:
    """Hex parse, optional 0x prefix (convert.cu htoi:202)."""
    _require_x64()
    mat, lens = _char_mat(col)
    n, w = mat.shape

    def hexval(c):
        return jnp.where(
            (c >= ord("0")) & (c <= ord("9")),
            c - ord("0"),
            jnp.where(
                (c >= ord("A")) & (c <= ord("F")),
                c - ord("A") + 10,
                jnp.where(
                    (c >= ord("a")) & (c <= ord("f")), c - ord("a") + 10, -1
                ),
            ),
        )

    def body(carry, j):
        val, done, started = carry
        c = mat[:, j]
        in_row = j < lens
        hv = jnp.where(in_row, hexval(c), -1)
        # skip 0x prefix
        is_x = (c == ord("x")) | (c == ord("X"))
        skip = is_x & (j <= 1)
        ok = (hv >= 0) & ~done
        val = jnp.where(ok, val * 16 + hv.astype(_I64), val)
        done = done | ((hv < 0) & ~skip & started)
        started = started | ok | skip
        return (val, done, started), None

    (val, _, _), _ = jax.lax.scan(
        body,
        (
            jnp.zeros(n, _I64),
            jnp.zeros(n, jnp.bool_),
            jnp.zeros(n, jnp.bool_),
        ),
        jnp.arange(w),
    )
    return jnp.where(col.validity, val, 0)


def stod(col: StringColumn) -> jax.Array:
    """Float parse (custr::stod): nan/inf/-inf specials, sign, mantissa
    with '.', optional e/E exponent."""
    _require_x64()
    mat, lens = _char_mat(col)
    n, w = mat.shape
    # stages: 0=start,1=mantissa,2=exp-start,3=exp-digits,4=done
    MAXM = jnp.int64(0x0FFFFFFFFFFFFF)

    def body(carry, j):
        sign, digits, exp_off, dec, stage, esign, e10 = carry
        c = mat[:, j]
        in_row = j < lens
        is_digit = (c >= ord("0")) & (c <= ord("9")) & in_row
        d = (c - ord("0")).astype(_I64)

        at_start = stage == 0
        sgn = (c == ord("-")) | (c == ord("+"))
        sign = jnp.where(at_start & sgn & in_row, jnp.where(c == ord("-"), -1.0, 1.0), sign)
        stage = jnp.where(at_start & in_row, 1, stage)
        # '.' enters decimal mode
        is_dot = (c == ord(".")) & in_row & (stage <= 1)
        dec = dec | is_dot
        consumed_sign = at_start & sgn & in_row
        # mantissa digits
        m_ok = is_digit & (stage == 1) & ~consumed_sign
        over = digits > MAXM
        new_digits = jnp.where(
            m_ok & ~over, digits * 10 + d, digits
        )
        re_over = new_digits > MAXM
        digits2 = jnp.where(m_ok & ~over & re_over, new_digits // 10, new_digits)
        exp_off = jnp.where(
            m_ok,
            jnp.where(
                over,
                exp_off + jnp.where(dec, 0, 1),
                jnp.where(
                    re_over,
                    exp_off + jnp.where(dec, 0, 1),
                    exp_off - jnp.where(dec, 1, 0),
                ),
            ),
            exp_off,
        )
        digits = digits2
        # exponent char
        is_e = ((c == ord("e")) | (c == ord("E"))) & in_row & (stage == 1)
        stage = jnp.where(is_e, 2, stage)
        # mantissa breaks on anything else
        brk = (
            (stage == 1)
            & ~m_ok
            & ~is_dot
            & ~is_e
            & ~consumed_sign
        )
        stage = jnp.where(brk, 4, stage)
        # exponent sign / digits
        at_e = (stage == 2) & ~is_e
        esgn = (c == ord("-")) | (c == ord("+"))
        esign = jnp.where(at_e & esgn & in_row, jnp.where(c == ord("-"), -1, 1), esign)
        stage = jnp.where(at_e & in_row, 3, stage)
        e_ok = is_digit & (stage == 3) & ~(at_e & esgn)
        e10 = jnp.where(e_ok, e10 * 10 + d.astype(jnp.int32), e10)
        return (sign, digits, exp_off, dec, stage, esign, e10), None

    init = (
        jnp.ones(n, _F64),
        jnp.zeros(n, _I64),
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, jnp.bool_),
        jnp.zeros(n, jnp.int32),
        jnp.ones(n, jnp.int32),
        jnp.zeros(n, jnp.int32),
    )
    (sign, digits, exp_off, dec, stage, esign, e10), _ = jax.lax.scan(
        body, init, jnp.arange(w)
    )
    exp = exp_off + esign * e10
    val = sign * digits.astype(_F64) * jnp.power(
        jnp.float64(10.0), exp.astype(_F64)
    )
    # specials
    from .find import startswith as _sw

    is_nan = _sw(col, "nan") | _sw(col, "NaN")
    is_inf = _sw(col, "inf") | _sw(col, "Inf")
    is_ninf = _sw(col, "-inf") | _sw(col, "-Inf")
    val = jnp.where(is_nan, jnp.nan, val)
    val = jnp.where(is_inf, jnp.inf, val)
    val = jnp.where(is_ninf, -jnp.inf, val)
    return jnp.where(col.validity, val, 0.0)


def stof(col: StringColumn) -> jax.Array:
    return stod(col).astype(jnp.float32)


def ip2int(col: StringColumn) -> jax.Array:
    """Parse 'a.b.c.d' IPv4 to uint32 (convert.cu ip2int:739)."""
    _require_x64()
    mat, lens = _char_mat(col)
    n, w = mat.shape

    def body(carry, j):
        octet, result = carry
        c = mat[:, j]
        in_row = j < lens
        is_digit = (c >= ord("0")) & (c <= ord("9")) & in_row
        is_dot = (c == ord(".")) & in_row
        octet = jnp.where(is_digit, octet * 10 + (c - ord("0")).astype(_I64), octet)
        result = jnp.where(is_dot, result * 256 + octet, result)
        octet = jnp.where(is_dot, 0, octet)
        return (octet, result), None

    (octet, result), _ = jax.lax.scan(
        body,
        (jnp.zeros(n, _I64), jnp.zeros(n, _I64)),
        jnp.arange(w),
    )
    out = result * 256 + octet
    return jnp.where(col.validity, out, 0).astype(jnp.uint32)


def to_booleans(col: StringColumn, true="True") -> jax.Array:
    from .find import match_strings

    target = from_host_strings([true] * col.size)
    return match_strings(col, target) & col.validity


# ---------------------------------------------------------------- format


def itos(values: np.ndarray, nulls=None) -> StringColumn:
    """Integers -> strings (convert.cu itos:257/ltos:315 semantics ==
    plain decimal).  Fully on device (format_k.itos_device)."""
    from .format_k import itos_device

    valid = _valid_from_bitmask(nulls, len(values))
    return itos_device(np.asarray(values), valid)


def _dissect_value(value: float):
    """Exact port of ftos_converter::dissect_value (convert.cu)."""
    significant_digits = 10
    nine_digits = 1000000000
    upper_limit = 1000000000.0
    lower_limit = 0.0001
    upper10 = [10.0, 100.0, 10000.0, 1e8, 1e16, 1e32, 1e64, 1e128, 1e256]
    lower10 = [0.1, 0.01, 0.0001, 1e-8, 1e-16, 1e-32, 1e-64, 1e-128, 1e-256]
    blower10 = [1.0, 0.1, 0.001, 1e-7, 1e-15, 1e-31, 1e-63, 1e-127, 1e-255]
    decimal_places = significant_digits - 1
    exp10 = 0
    if value > upper_limit:
        fx = 256
        for idx in range(8, -1, -1):
            if value >= upper10[idx]:
                value *= lower10[idx]
                exp10 += fx
            fx >>= 1
    elif 0.0 < value < lower_limit:
        fx = 256
        for idx in range(8, -1, -1):
            if value < blower10[idx]:
                value *= upper10[idx]
                exp10 -= fx
            fx >>= 1
    max_digits = nine_digits
    integer = int(value)
    i = integer
    while i >= 10:
        decimal_places -= 1
        max_digits //= 10
        i //= 10
    remainder = (value - integer) * max_digits
    decimal = int(remainder)
    remainder -= decimal
    decimal += int(2.0 * remainder)
    if decimal >= max_digits:
        decimal = 0
        integer += 1
        if exp10 and integer >= 10:
            exp10 += 1
            integer = 1
    while decimal % 10 == 0 and decimal_places > 0:
        decimal //= 10
        decimal_places -= 1
    return integer, decimal, exp10, decimal_places


def _float_to_string(value: float) -> str:
    """Exact port of ftos_converter::float_to_string."""
    if math.isnan(value):
        return "NaN"
    bneg = False
    if value < 0.0:
        value = -value
        bneg = True
    if math.isinf(value):
        return "-Inf" if bneg else "Inf"
    integer, decimal, exp10, decimal_places = _dissect_value(value)
    s = "-" if bneg else ""
    s += str(integer)
    s += "."
    if decimal_places:
        s += _dec_str(decimal, decimal_places)
    else:
        s += "0"
    if exp10:
        s += "e"
        s += "-" if exp10 < 0 else "+"
        e = abs(exp10)
        s += ("0" + str(e)) if e < 10 else str(e)
    return s


def _dec_str(decimal: int, decimal_places: int) -> str:
    digits = []
    for _ in range(decimal_places):
        digits.append(chr(ord("0") + decimal % 10))
        decimal //= 10
    return "".join(reversed(digits))


def ftos(values: np.ndarray, nulls=None) -> StringColumn:
    """Floats -> strings, byte-exact ftos_converter output, on device
    (format_k.ftos_device; _float_to_string above stays as the oracle)."""
    from .format_k import ftos_device

    valid = _valid_from_bitmask(nulls, len(values))
    return ftos_device(np.asarray(values, np.float64), valid)


def int2ip(values, nulls=None) -> StringColumn:
    """uint32 -> dotted quad, on device (format_k.int2ip_device)."""
    from .format_k import int2ip_device

    valid = _valid_from_bitmask(nulls, len(values))
    return int2ip_device(
        np.asarray(values, np.int64) & 0xFFFFFFFF, valid
    )


def from_booleans(values, true="True", false="False", nulls=None) -> StringColumn:
    from .format_k import from_booleans_device

    valid = _valid_from_bitmask(nulls, len(values))
    return from_booleans_device(
        np.asarray([bool(v) for v in values], np.bool_), true, false, valid
    )


def _valid_from_bitmask(nulls, count):
    if nulls is None:
        return np.ones(count, bool)
    arr = np.asarray(nulls)
    if arr.dtype == np.bool_ and arr.size == count:
        return ~arr
    bits = np.unpackbits(arr.view(np.uint8).ravel(), bitorder="little")
    return bits[:count].astype(bool)
