"""The port's EEL2 vector semantics (torch) against the JAX package's
(`zorak_tpu.lowering.eelmath`) and against the scalar contract
(`semantics/scalar.py`), on the same f64 inputs made with numpy.

Tolerances, per op.  Against JAX: the integer ops, compares, selects,
min/max, sign, abs, floor, ceil, the four arithmetic ops and invsqrt are
bit-identical (NaN where the other side has NaN, -0.0 apart from 0.0),
except that XLA's CPU backend flushes subnormal numbers to zero, so a
result below the smallest normal number (of f64, or of f32 inside
invsqrt's f32 bit trick) counts as equal to a zero of the same sign, and
no subnormal input is drawn.  sqrt may differ by 1 ulp: PyTorch's
vectorised CPU sqrt is not correctly rounded for every input (0.5, 2.0),
the card's is.  The transcendental functions (sin .. log10, pow, atan2)
come from two math libraries and may differ in the last places: 4 ulps of
the result.  Against the scalar contract the same, by value (the scalar
floor and ceil return +0.0 where the vector ops of both packages return
-0.0).
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from zorak_tpu.lowering import eelmath as JEM
from zorak_tpu.lowering.specialize import _SC_BINARY, _SC_UNARY

from zorak_tpu_torch.lowering import eelmath as EM
from zorak_tpu_torch.lowering.specialize import _host_i64

ULPS = 4
LIBM_UNARY = {"sin", "cos", "tan", "asin", "acos", "atan", "exp", "log",
              "log10"}
LIBM_BINARY = {"^", "pow", "atan2"}

SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -3.0, 7.0, 31.0,
                    32.0, 33.0, 1e-300, -1e-300, 1e300, -1e300, 2.0 ** 31,
                    -2.0 ** 31, 2.0 ** 31 - 1, 2.0 ** 32, 2.0 ** 32 + 5,
                    -2.0 ** 32 - 5, 2.0 ** 53, 2.0 ** 63, -2.0 ** 63,
                    2.0 ** 63 - 1024, 2.0 ** 64, 1e19, -1e19, 3.7e18,
                    np.inf, -np.inf, np.nan, 1234567.891, -98765.4321,
                    4294967295.0, 4294967296.5, 0.1, np.pi, -np.e])


def seeded(n=4000, seed=7):
    rng = np.random.RandomState(seed)
    parts = [rng.randn(n), rng.randn(n) * 1e3, rng.uniform(-40, 40, n).round(),
             rng.randn(n) * 2.0 ** 40, rng.uniform(-1, 1, n)]
    return np.concatenate([SPECIAL] + parts)


def pairs():
    a = seeded()
    rng = np.random.RandomState(11)
    b = rng.permutation(a)
    # every special against every special too
    sa, sb = np.meshgrid(SPECIAL, SPECIAL)
    return np.concatenate([a, sa.ravel()]), np.concatenate([b, sb.ravel()])


def same(got: np.ndarray, want: np.ndarray, ulps: int = 0,
         tiny: float = float(np.finfo(np.float64).tiny), by_value=False):
    """Equal bit for bit (NaN matching NaN, -0.0 apart from 0.0; by value
    if asked), or within `ulps` units in the last place of the wanted
    value; magnitudes below `tiny` on both sides count as equal zeros."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    flushed = (np.abs(g) < tiny) & (np.abs(w) < tiny)
    if not by_value:
        flushed &= np.signbit(g) == np.signbit(w)
    if ulps == 0 and not by_value:
        assert np.all((g.view(np.int64) == w.view(np.int64)) | flushed)
        return
    inf = np.isinf(w)
    assert np.array_equal(g[inf], w[inf])
    g, w, flushed = g[~inf], w[~inf], flushed[~inf]
    close = np.abs(g - w) <= ulps * np.spacing(np.abs(w))
    assert np.all(close | flushed)


def ulps_of(op):
    if op in LIBM_UNARY or op in LIBM_BINARY:
        return ULPS
    return 1 if op == "sqrt" else 0


# invsqrt's f32 first guess, flushed by XLA when subnormal, is scaled by
# up to 1.5 on its way to the f64 result
F32_TINY = 2.0 * float(np.finfo(np.float32).tiny)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("op", sorted(EM.UNARY))
def test_unary_matches_jax(op):
    assert sorted(EM.UNARY) == sorted(JEM.UNARY)
    x = seeded()
    with np.errstate(all="ignore"):
        got = EM.UNARY[op](t(x)).numpy()
        want = np.asarray(JEM.UNARY[op](jnp.asarray(x)))
    if op == "invsqrt":
        same(got, want, tiny=F32_TINY)
    else:
        same(got, want, ulps_of(op))


@pytest.mark.parametrize("op", sorted(EM.BINARY))
def test_binary_matches_jax(op):
    assert sorted(EM.BINARY) == sorted(JEM.BINARY)
    a, b = pairs()
    got = EM.BINARY[op](t(a), t(b)).numpy()
    want = np.asarray(JEM.BINARY[op](jnp.asarray(a), jnp.asarray(b)))
    same(got, want, ulps_of(op))


@pytest.mark.parametrize("op", sorted(EM.UNARY))
def test_unary_matches_the_scalar_contract(op):
    x = seeded(400)
    got = EM.UNARY[op](t(x)).numpy()
    want = np.array([_SC_UNARY[op](float(v)) for v in x])
    same(got, want, ulps_of(op), tiny=0.0, by_value=True)


# the scalar contract's integer conversion is undefined upstream for NaN,
# inf and |x| >= 2^63 (it raises or wraps where the vector ops saturate),
# so the element-wise comparison of the integer ops stays inside int64
INT_OPS = {"|", "&", "~", "<<", ">>", "%"}


@pytest.mark.parametrize("op", sorted(EM.BINARY))
def test_binary_matches_the_scalar_contract(op):
    a, b = pairs()
    if op in INT_OPS:
        # "%": where the left operand wraps to INT32_MIN the vector op of
        # both packages takes |INT32_MIN| in int32, the scalar one in
        # Python ints; the comparison stays below 2^31
        lim = 2.0 ** 31 if op == "%" else 2.0 ** 62
        ok = (np.abs(a) < lim) & (np.abs(b) < lim)
        a, b = a[ok], b[ok]
    a, b = a[:1500], b[:1500]
    got = EM.BINARY[op](t(a), t(b)).numpy()
    want = []
    for u, v in zip(a, b):
        try:
            want.append(_SC_BINARY[op](float(u), float(v)))
        except (OverflowError, ZeroDivisionError, ValueError):
            want.append(None)
    keep = np.array([w is not None for w in want])
    same(got[keep], np.array([w for w in want if w is not None]),
         ulps_of(op), tiny=0.0, by_value=True)


def test_to_i64_saturates_and_sends_nan_to_zero_like_jax():
    x = seeded()
    got = EM.to_i64(t(x)).numpy()
    assert np.array_equal(got, np.asarray(JEM.to_i64(jnp.asarray(x))))
    assert EM.to_i64(t(np.array([np.nan, np.inf, -np.inf, 1e19, -1e19,
                                 2.0 ** 63, -2.0 ** 63, -7.9]))).tolist() == \
        [0, 2 ** 63 - 1, -2 ** 63, 2 ** 63 - 1, -2 ** 63, 2 ** 63 - 1,
         -2 ** 63, -7]
    assert [_host_i64(float(v)) for v in x] == got.tolist()


def test_to_i32_wraps_like_jax():
    x = seeded()
    assert np.array_equal(EM.to_i32(t(x)).numpy(),
                          np.asarray(JEM.to_i32(jnp.asarray(x))))
    assert EM.to_i32(t(np.array([2.0 ** 32 + 5, -2.0 ** 31 - 1,
                                 4294967295.0]))).tolist() == [5, 2 ** 31 - 1, -1]


def test_select_and_truthy_match_jax():
    c, a = pairs()
    b = a[::-1].copy()
    same(EM.eel_select(t(c), t(a), t(b)).numpy(),
         np.asarray(JEM.eel_select(jnp.asarray(c), jnp.asarray(a),
                                   jnp.asarray(b))))
    assert np.array_equal(EM.truthy_mask(t(c)).numpy(),
                          np.asarray(JEM.truthy_mask(jnp.asarray(c))))
    assert EM.truthy_mask(t(np.array([np.nan, 0.0, -0.0, 1e-320, -1.0]))
                          ).tolist() == [False, False, False, True, True]


def test_scalars_broadcast_like_jax():
    # the emitter mixes 0-d constants with [L] streams
    x = seeded(100)
    for op in ("+", "min", "max", "&", "%", "<", "pow"):
        got = EM.BINARY[op](torch.tensor(3.0, dtype=torch.float64), t(x))
        want = JEM.BINARY[op](jnp.float64(3.0), jnp.asarray(x))
        same(got.numpy(), np.asarray(want), ulps_of(op))
        assert got.dtype == torch.float64


doubles = st.floats(allow_nan=True, allow_infinity=True, width=64,
                    allow_subnormal=False)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.tuples(doubles, doubles), min_size=1, max_size=40))
def test_hypothesis_drawn_values_match_jax(vals):
    a = np.array([v[0] for v in vals])
    b = np.array([v[1] for v in vals])
    for op in ("|", "&", "~", "<<", ">>", "%", "<", "<=", ">", ">=", "==",
               "!=", "min", "max", "+", "-", "*", "/"):
        with np.errstate(all="ignore"):
            got = EM.BINARY[op](t(a), t(b)).numpy()
        same(got, np.asarray(JEM.BINARY[op](jnp.asarray(a), jnp.asarray(b))))
    for op in ("floor", "ceil", "abs", "sign", "not", "sqrt", "invsqrt"):
        if op == "invsqrt":
            # an input that is subnormal as f32 is flushed by XLA too
            a = a[~(np.abs(a) < np.finfo(np.float32).tiny) | (a == 0.0)]
        same(EM.UNARY[op](t(a)).numpy(),
             np.asarray(JEM.UNARY[op](jnp.asarray(a))), ulps_of(op),
             tiny=F32_TINY if op == "invsqrt" else float(
                 np.finfo(np.float64).tiny))
    assert np.array_equal(EM.to_i32(t(a)).numpy(),
                          np.asarray(JEM.to_i32(jnp.asarray(a))))


def test_norm_loop_matches_repeated_subtraction():
    from zorak_tpu_torch.lowering.specialize import _norm_loop

    x = np.random.RandomState(3).randn(500) * 1000
    meta = {"C": 180.0, "S": -360.0, "op": ">"}
    got = _norm_loop(t(x), meta).numpy()
    want = np.array([_norm_loop(float(v), meta) for v in x])
    same(got, want)
    assert math.isclose(_norm_loop(900.0, meta), 180.0)
