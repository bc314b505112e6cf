"""EEL2 numeric semantics on torch time-series (the vector counterpart of
semantics/scalar.py — keep the two in lockstep).

Counterpart of zorak_tpu/lowering/eelmath.py.  All values are f64
tensors; int ops truncate toward zero to i64, wrap to i32, and return
f64.  Comparisons are ordered (NaN -> 0.0) and produce 1.0/0.0.

The three linear-recurrence solvers at the end keep the reference's
doubling order.  They are the plain versions of the CUDA kernel in
`kernels/linrec_scan.py`, which the emitter calls: it takes them on CPU
tensors only.
"""
from __future__ import annotations

import torch

F64 = torch.float64
I32 = torch.int32
I64 = torch.int64

_TWO63 = 9223372036854775808.0          # 2^63, exact in f64
_I64_TOP_F = 9223372036854774784.0      # largest f64 below 2^63
_I64_MAX = 9223372036854775807
_I64_MIN = -9223372036854775808


def to_i64(x):
    """Truncate toward zero; saturate outside int64; NaN gives 0.

    `tensor.to(int64)` of a NaN or an out-of-range double is undefined
    and differs between CPU and CUDA, so the edges are spelled out: both
    devices give what the reference's convert gives.
    """
    t = torch.trunc(x)
    safe = torch.where(t == t, t, torch.zeros_like(t)).clamp(-_TWO63, _I64_TOP_F)
    r = safe.to(I64)
    return torch.where(t >= _TWO63, torch.full_like(r, _I64_MAX), r)


def to_i32(x):
    return to_i64(x).to(I32)  # wraps mod 2^32


def from_i(x):
    return x.to(F64)


def eel_or(a, b):
    return from_i(to_i32(a) | to_i32(b))


def eel_and(a, b):
    return from_i(to_i32(a) & to_i32(b))


def eel_xor(a, b):
    return from_i(to_i32(a) ^ to_i32(b))


def eel_shl(a, b):
    return from_i(to_i32(a) << (to_i32(b) & 31))


def eel_shr(a, b):
    return from_i(to_i32(a) >> (to_i32(b) & 31))  # arithmetic on int32


def eel_mod(a, b):
    li, ri = torch.broadcast_tensors(to_i32(a), to_i32(b))
    mag = torch.where(ri == 0, torch.zeros_like(li),
                      torch.remainder(torch.abs(li),
                                      torch.abs(ri).clamp(min=1)))
    return from_i(torch.where(li < 0, -mag, mag))


def eel_div(a, b):
    return a / b  # IEEE: inf/NaN, never raises


def eel_pow(a, b):
    # C pow edge cases (neg base frac exp -> NaN, etc.)
    return torch.pow(a, b)


def _bool_to_f(c):
    return c.to(F64)


def cmp_lt(a, b):
    return _bool_to_f(a < b)


def cmp_le(a, b):
    return _bool_to_f(a <= b)


def cmp_gt(a, b):
    return _bool_to_f(a > b)


def cmp_ge(a, b):
    return _bool_to_f(a >= b)


def cmp_eq(a, b):
    return _bool_to_f(a == b)


def cmp_ne(a, b):
    # ordered: NaN present -> 0
    return _bool_to_f((a == a) & (b == b) & (a != b))


def truthy_mask(x):
    return (x < 0.0) | (x > 0.0)  # NaN falsy


def eel_not(x):
    return _bool_to_f(x == 0.0)


def eel_select(c, a, b):
    return torch.where(truthy_mask(c), a, b)


def eel_min(a, b):
    return torch.where(a < b, a, b)  # NaN -> b, matching scalar select


def eel_max(a, b):
    return torch.where(a > b, a, b)


def eel_sign(a):
    one = torch.ones_like(a)
    return torch.where(a > 0.0, one,
                       torch.where(a < 0.0, -one, torch.zeros_like(a)))


def eel_invsqrt(x):
    bits = x.to(torch.float32).contiguous().view(I32)
    approx = 0x5F3759DF - (bits >> 1)
    y0 = approx.view(torch.float32).to(F64)
    return y0 * (1.5 - 0.5 * x * y0 * y0)


UNARY = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "sqrt": torch.sqrt, "abs": torch.abs, "fabs": torch.abs,
    "floor": torch.floor, "ceil": torch.ceil, "invsqrt": eel_invsqrt,
    "not": eel_not, "sign": eel_sign,
}

BINARY = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": eel_div,
    "^": eel_pow,
    "%": eel_mod,
    "|": eel_or,
    "&": eel_and,
    "~": eel_xor,
    "<<": eel_shl,
    ">>": eel_shr,
    "<": cmp_lt, "<=": cmp_le, ">": cmp_gt, ">=": cmp_ge,
    "==": cmp_eq, "!=": cmp_ne,
    "min": eel_min, "max": eel_max,
    "atan2": torch.atan2, "pow": eel_pow,
}


def _shift(x, s, fill):
    """x delayed by s along the last axis, the head filled with `fill`."""
    head = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[..., :-s]], dim=-1)


def linrec_assoc_scan(a, b, z0):
    """Solve z_t = a_t * z_{t-1} + b_t (z_{-1} = z0) in O(log N) stages.

    a may be a 0-d tensor (broadcast) or a length-N tensor; b is
    length-N.  Returns the length-N stream of z_t, as a Hillis-Steele
    doubling scan.  z0 is folded into b[0] (b0' = b0 + a0*z0, identical
    op order to the sequential golden's first step).
    """
    n = b.shape[0]
    if n == 0:
        return b
    a = torch.as_tensor(a, dtype=F64, device=b.device)
    b = b.clone()
    if a.dim() == 0:
        b[0] += a * z0
        s, w = 1, a
        while s < n:
            b = b + w * _shift(b, s, 0.0)
            w = w * w
            s <<= 1
        return b
    b[0] += a[0] * z0
    A = a
    s = 1
    while s < n:
        b_sh = _shift(b, s, 0.0)
        A_sh = _shift(A, s, 1.0)
        b = b + A * b_sh
        A = A * A_sh
        s <<= 1
    return b


def linrec_doubling_scalar_batch(a_vec, B, z0_vec):
    """Batched constant-coefficient linear recurrences: row i solves
    z_t = a_vec[i] * z_{t-1} + B[i, t] with z_{-1} = z0_vec[i].

    One doubling ladder serves every row; per-row op order is identical
    to linrec_assoc_scan's scalar path.
    """
    k, n = B.shape
    if n == 0 or k == 0:
        return B
    a_vec = torch.as_tensor(a_vec, dtype=F64, device=B.device)
    z0_vec = torch.as_tensor(z0_vec, dtype=F64, device=B.device)
    B = B.clone()
    B[:, 0] += a_vec * z0_vec
    w = a_vec
    s = 1
    while s < n:
        B = B + w[:, None] * _shift(B, s, 0.0)
        w = w * w
        s <<= 1
    return B


def linrec_doubling_vector_batch(A, B, z0_vec):
    """Batched varying-coefficient linear recurrences: row i solves
    z_t = A[i, t] * z_{t-1} + B[i, t] with z_{-1} = z0_vec[i]."""
    k, n = B.shape
    if n == 0 or k == 0:
        return B
    A = torch.as_tensor(A, dtype=F64, device=B.device)
    z0_vec = torch.as_tensor(z0_vec, dtype=F64, device=B.device)
    B = B.clone()
    B[:, 0] += A[:, 0] * z0_vec
    s = 1
    while s < n:
        A_sh = _shift(A, s, 1.0)
        B_sh = _shift(B, s, 0.0)
        B = B + A * B_sh
        A = A * A_sh
        s <<= 1
    return B
