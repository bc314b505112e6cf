"""The EEL2 numeric contract, as exact Python-scalar operations.

This module is the single normative statement of the language's numeric
semantics for CPU backends; the JAX lowering implements the same contract
with jnp ops (see lowering/eelmath.py).  Rules follow the reference
emitter (ref: dsp_jsfx_aot.py:4062-4381, 5213-5311):

* every value is an IEEE f64,
* comparisons produce 1.0/0.0 and are ORDERED (NaN -> false; note `!=` is
  ordered too: NaN != NaN is FALSE),
* truthiness is the ordered comparison x != 0 (NaN is falsy),
* bitwise ops and `%` truncate operands toward zero and wrap to int32;
  shift counts are masked & 31; `>>` is arithmetic,
* bracket addressing truncates (base + index + 1e-5) toward zero ONCE and
  clamps negatives to 0,
* `^` is libm pow; `/` by zero follows IEEE (+-inf / NaN), never raises,
* rand() is MT19937 with fixed seed 0x4141F00D and per-instance state,
* invsqrt() is the classic f32 bit-trick approximation.
"""
from __future__ import annotations

import math
import struct

NAN = float("nan")
INF = float("inf")

_U32 = 0xFFFFFFFF
_I32_MIN = -(1 << 31)

# ---------------------------------------------------------------------------
# int conversions


def trunc_i64(x: float) -> int:
    """fptosi f64 -> i64 (truncate toward zero; saturate the UB cases)."""
    try:
        i = int(x)
    except (ValueError, OverflowError):  # NaN / inf: LLVM UB, pick 0
        return 0
    if i > (1 << 62):
        return 1 << 62
    if i < -(1 << 62):
        return -(1 << 62)
    return i


def to_i32(x: float) -> int:
    """fptosi then wrap mod 2^32 into signed int32."""
    return ((trunc_i64(x) - _I32_MIN) & _U32) + _I32_MIN


def wrap_i32(i: int) -> int:
    return ((i - _I32_MIN) & _U32) + _I32_MIN


# ---------------------------------------------------------------------------
# binary ops


def eel_or(a: float, b: float) -> float:
    return float(to_i32(a) | to_i32(b))


def eel_and(a: float, b: float) -> float:
    return float(to_i32(a) & to_i32(b))


def eel_xor(a: float, b: float) -> float:
    return float(to_i32(a) ^ to_i32(b))


def eel_shl(a: float, b: float) -> float:
    return float(wrap_i32(to_i32(a) << (to_i32(b) & 31)))


def eel_shr(a: float, b: float) -> float:
    return float(to_i32(a) >> (to_i32(b) & 31))  # arithmetic shift


def eel_mod(a: float, b: float) -> float:
    """C srem on int32 operands (result keeps the dividend's sign)."""
    li, ri = to_i32(a), to_i32(b)
    if ri == 0:
        return 0.0  # LLVM UB; EEL2 returns 0
    r = abs(li) % abs(ri)
    return float(-r if li < 0 else r)


def eel_div(a: float, b: float) -> float:
    try:
        return a / b
    except ZeroDivisionError:
        if a != a or a == 0.0:
            return NAN
        return INF if (a > 0.0) == (not math.copysign(1.0, b) < 0.0) else -INF


def eel_pow(a: float, b: float) -> float:
    try:
        return math.pow(a, b)
    except OverflowError:
        # C pow overflow -> +-inf; sign follows (-x)^odd
        if a < 0.0 and b == b and b == int(b) and int(b) & 1:
            return -INF
        return INF
    except ValueError:
        if a == 0.0 and b < 0.0:
            # C pow(+-0, negative): +-inf (sign from -0 with odd integer exp)
            odd = b == int(b) and int(b) & 1
            return -INF if (math.copysign(1.0, a) < 0.0 and odd) else INF
        # negative base with non-integer exponent: C pow gives NaN
        return NAN


# ordered comparisons -> 1.0/0.0 (NaN always 0.0)

def cmp_lt(a: float, b: float) -> float:
    return 1.0 if a < b else 0.0


def cmp_le(a: float, b: float) -> float:
    return 1.0 if a <= b else 0.0


def cmp_gt(a: float, b: float) -> float:
    return 1.0 if a > b else 0.0


def cmp_ge(a: float, b: float) -> float:
    return 1.0 if a >= b else 0.0


def cmp_eq(a: float, b: float) -> float:
    return 1.0 if a == b else 0.0


def cmp_ne(a: float, b: float) -> float:
    # ordered "one": false when NaN present
    return 1.0 if (a == a and b == b and a != b) else 0.0


def truthy(x: float) -> bool:
    return x < 0.0 or x > 0.0  # ordered !=0 (NaN falsy)


def eel_not(x: float) -> float:
    return 1.0 if x == 0.0 else 0.0


def eel_neg(x: float) -> float:
    return 0.0 - x


# ---------------------------------------------------------------------------
# math builtins (C libm edge-case behavior, never raising)


def eel_min(a: float, b: float) -> float:
    return a if a < b else b


def eel_max(a: float, b: float) -> float:
    return a if a > b else b


def eel_sqr(a: float) -> float:
    return a * a


def eel_sign(a: float) -> float:
    if a > 0.0:
        return 1.0
    return -1.0 if a < 0.0 else 0.0


def eel_abs(x: float) -> float:
    return math.fabs(x)


def eel_floor(x: float) -> float:
    try:
        return float(math.floor(x))
    except (ValueError, OverflowError):
        return x  # inf/nan pass through like C floor


def eel_ceil(x: float) -> float:
    try:
        return float(math.ceil(x))
    except (ValueError, OverflowError):
        return x


def eel_sqrt(x: float) -> float:
    try:
        return math.sqrt(x)
    except ValueError:
        return NAN


def eel_exp(x: float) -> float:
    try:
        return math.exp(x)
    except OverflowError:
        return INF


def eel_log(x: float) -> float:
    if x == 0.0:
        return -INF
    try:
        return math.log(x)
    except ValueError:
        return NAN


def eel_log10(x: float) -> float:
    if x == 0.0:
        return -INF
    try:
        return math.log10(x)
    except ValueError:
        return NAN


def eel_sin(x: float) -> float:
    try:
        return math.sin(x)
    except ValueError:
        return NAN


def eel_cos(x: float) -> float:
    try:
        return math.cos(x)
    except ValueError:
        return NAN


def eel_tan(x: float) -> float:
    try:
        return math.tan(x)
    except ValueError:
        return NAN


def eel_asin(x: float) -> float:
    try:
        return math.asin(x)
    except ValueError:
        return NAN


def eel_acos(x: float) -> float:
    try:
        return math.acos(x)
    except ValueError:
        return NAN


def eel_atan(x: float) -> float:
    return math.atan(x)


def eel_atan2(y: float, x: float) -> float:
    return math.atan2(y, x)


def eel_invsqrt(x: float) -> float:
    """Quake fast inverse square root, matched bit-for-bit on the f32 step
    (ref: dsp_jsfx_aot.py:5256-5280)."""
    try:
        f32 = struct.pack("<f", x)
    except OverflowError:
        f32 = struct.pack("<f", math.copysign(INF, x))
    (bits,) = struct.unpack("<i", f32)
    approx = wrap_i32(0x5F3759DF - (bits >> 1))
    (y0,) = struct.unpack("<f", struct.pack("<i", approx))
    return y0 * (1.5 - 0.5 * x * y0 * y0)


# ---------------------------------------------------------------------------
# memory addressing


def mem_address(base: float, index: float) -> int:
    """EEL2 bracket addressing: trunc(base + index + 1e-5), clamp to >= 0.

    The bias is added BEFORE the single truncation (ref:
    dsp_jsfx_aot.py:4062-4090 — NOT trunc(base)+trunc(index)).
    """
    addr = trunc_i64(base + index + 1.0e-5)
    return 0 if addr < 0 else addr


def blob_address(x: float) -> int:
    """Address-rounding used by memset/memcpy dest/src (trunc(x+1e-5), >=0)."""
    addr = trunc_i64(x + 1.0e-5)
    return 0 if addr < 0 else addr


# ---------------------------------------------------------------------------
# MT19937 (EEL2 rand)

_MT_N = 624
_MT_M = 397
_MT_SEED = 0x4141F00D
_MT_MATRIX_A = 0x9908B0DF
_MT_UPPER = 0x80000000
_MT_LOWER = 0x7FFFFFFF


class EelRng:
    """Per-instance MT19937 with EEL2's fixed seed; index 0 = uninitialized
    (ref: dsp_jsfx_aot.py:3880-4060)."""

    __slots__ = ("mt", "idx")

    def __init__(self) -> None:
        self.mt = [0] * _MT_N
        self.idx = 0

    def _init(self) -> None:
        mt = self.mt
        mt[0] = _MT_SEED
        for i in range(1, _MT_N):
            prev = mt[i - 1]
            mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & _U32
        self.idx = _MT_N

    def _twist(self) -> None:
        mt = self.mt
        for kk in range(_MT_N - _MT_M):
            y = (mt[kk] & _MT_UPPER) | (mt[kk + 1] & _MT_LOWER)
            mt[kk] = mt[kk + _MT_M] ^ (y >> 1) ^ (_MT_MATRIX_A if y & 1 else 0)
        for kk in range(_MT_N - _MT_M, _MT_N - 1):
            y = (mt[kk] & _MT_UPPER) | (mt[kk + 1] & _MT_LOWER)
            mt[kk] = mt[kk - (_MT_N - _MT_M)] ^ (y >> 1) ^ (_MT_MATRIX_A if y & 1 else 0)
        y = (mt[_MT_N - 1] & _MT_UPPER) | (mt[0] & _MT_LOWER)
        mt[_MT_N - 1] = mt[_MT_M - 1] ^ (y >> 1) ^ (_MT_MATRIX_A if y & 1 else 0)

    def gen_u32(self) -> int:
        if self.idx == 0:
            self._init()
        if self.idx >= _MT_N:
            self._twist()
            self.idx = 1
            y = self.mt[0]
        else:
            y = self.mt[self.idx]
            self.idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680 & _U32
        y ^= (y << 15) & 0xEFC60000 & _U32
        y ^= y >> 18
        return y & _U32

    def rand(self, limit: float = 1.0) -> float:
        top = eel_floor(limit)
        if not top >= 1.0:  # NaN or < 1 -> 1
            top = 1.0
        return self.gen_u32() * (1.0 / 4294967295.0) * top

    # state export for cross-backend parity
    def snapshot(self):
        return (list(self.mt), self.idx)

    def restore(self, snap) -> None:
        self.mt = list(snap[0])
        self.idx = snap[1]
