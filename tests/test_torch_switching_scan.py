"""The chunk-parallel switching scan's algorithm, held bit for bit on the CPU.

`csrc/switching_scan.cu` splits the switching one-pole across threads in
two phases: every chunk is speculated from a guess after a warm-up, then
a fix-up walks the chunks with the true carry and re-runs a chunk, with
bitwise comparisons, wherever the guess had not merged yet.  The CUDA
kernels run only on the card (chip_smoke.py holds them to the plain loop
there); this file holds a NumPy model of the same two phases, written
here and used by nothing else, to the port's plain loop
(`switching_scan_reference`) and to the JAX package's
`zorak_tpu.models.dspkit.switching_onepole` (f64 `lax.scan`) on seeded
and hypothesis-drawn inputs: silence, constant runs, -0.0, NaN, poles in
(0, 1), z0 != 0.  Against the plain loop, and against JAX's scan run op
by op, the model agrees bit for bit; against JAX's compiled scan, within
a few ulps (see jax_scan).  It also checks the wrapper's `chunk` and
`warmup` arguments, and that a CPU tensor runs the plain loop.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from zorak_tpu.models import dspkit as J
from zorak_tpu_torch.kernels import switching_scan as SS

_INT = {np.dtype(np.float64): np.int64, np.dtype(np.float32): np.int32}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(_INT[a.dtype])


def _plan(n_t, chunk, warmup):
    chunk = min(chunk, n_t)
    n = -(-n_t // chunk)
    return chunk, min(warmup, (n - 1) * chunk), n


def speculate(x, up, dn, z0, chunk, warmup):
    """Phase 1: all (chunk, lane) trajectories at once, one relative step
    r at a time; chunk c's step r is time c*chunk - warmup + r.  Returns
    y and each chunk's recorded start and end states [n_chunks, lanes]."""
    n_t = x.shape[0]
    chunk, warm, n = _plan(n_t, chunk, warmup)
    t_first = np.arange(n)[:, None] * chunk - warm          # [n, 1]
    exact = t_first <= 0                                    # reaches t = 0
    z = np.where(exact, z0[None, :], x[np.maximum(t_first[:, 0], 0)])
    r_lo = np.where(exact, -t_first, 0)
    r_hi = np.minimum(warm + chunk, n_t - t_first)
    y = np.empty_like(x)
    start = z
    for r in range(warm + chunk):
        if r == warm:
            start = z.copy()
        t = np.clip(t_first[:, 0] + r, 0, n_t - 1)
        xt = x[t]
        with np.errstate(invalid="ignore"):
            step = xt + (z - xt) * np.where(xt > z, up, dn)
        active = (r >= r_lo) & (r < r_hi)
        z = np.where(active, step, z)
        if r >= warm:
            rows = active[:, 0]
            y[t[rows]] = z[rows]
    return y, start, z


def fixup(x, up, dn, y, start, end, chunk):
    """Phase 2: per lane, walk the chunks with the true carry; a chunk
    whose recorded start differs in its bits is re-run until the state
    equals the speculative y[t] in its bits.  Returns re-run steps."""
    n_t, lanes = x.shape
    chunk = min(chunk, n_t)
    steps = 0
    for lane in range(lanes):
        carry = end[0, lane]
        for c in range(1, start.shape[0]):
            if _bits(carry) == _bits(start[c, lane]):
                carry = end[c, lane]
                continue
            z, merged = carry, False
            for t in range(c * chunk, min(n_t, c * chunk + chunk)):
                xt = x[t, lane]
                with np.errstate(invalid="ignore"):
                    z = xt + (z - xt) * (up[lane] if xt > z else dn[lane])
                steps += 1
                if _bits(z) == _bits(y[t, lane]):
                    merged = True
                    break
                y[t, lane] = z
            carry = end[c, lane] if merged else z
    return steps


def chunked_scan(x, up, dn, z0, chunk, warmup):
    y, start, end = speculate(x, up, dn, z0, chunk, warmup)
    return y, fixup(x, up, dn, y, start, end, chunk)


def plain(x, up, dn, z0):
    return SS.switching_scan_reference(*(torch.from_numpy(v)
                                         for v in (x, up, dn, z0))).numpy()


def jax_scan(x, up, dn, z0, jit=True):
    """zorak_tpu's switching_onepole takes time last and runs in f64.

    Compiled, XLA's CPU backend contracts `xt + (z - xt) * pole` into a
    fused multiply-add, one rounding where the plain loop has two, so its
    result differs by a few ulps (JAX_TOL).  With jit disabled every op
    runs on its own and rounds as the plain loop does: bit for bit, but
    about 60 ms a step, so only at a few dozen steps.
    """
    args = (jnp.asarray(x.T), jnp.asarray(up), jnp.asarray(dn),
            jnp.asarray(z0))
    if jit:
        return np.asarray(jax.jit(J.switching_onepole)(*args)).T
    with jax.disable_jit():
        return np.asarray(J.switching_onepole(*args)).T


# f64: a few ulps of an O(1) signal, as in tests/test_torch_dspkit.py
JAX_TOL = 1e-12


def make_input(kind, n_t, lanes, seed, dtype=np.float64):
    """Detector-like input [T, lanes] with the features that stress a
    merge: bursts into exact silence, constant runs, -0.0 and NaN."""
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(n_t, lanes)) * 0.5
    if kind == "silence":          # a burst, then zeros: never merges
        x[n_t // 5:] = 0.0
    elif kind == "constant":
        x[:] = 0.25
    elif kind == "runs":           # constant and silent stretches
        for a in rng.randint(0, n_t, size=6):
            x[a:a + rng.randint(1, 200)] = rng.choice([0.0, 0.3, 1.0])
    elif kind == "negzero":
        x[::3] = -0.0
        x[1::7] = -x[1::7]
    elif kind == "nan":
        x[n_t // 2] = np.nan
    up = rng.uniform(0.3, 0.95, lanes)
    dn = rng.uniform(0.9, 0.9995, lanes)
    z0 = rng.uniform(-1.0, 1.0, lanes)
    return tuple(np.ascontiguousarray(v, dtype) for v in (x, up, dn, z0))


KINDS = ["noise", "silence", "constant", "runs", "negzero", "nan"]
CASES = [(kind, n_t, lanes, chunk, warmup)
         for kind in KINDS
         for n_t, lanes, chunk, warmup in ((1, 1, 64, 64), (65, 3, 64, 64),
                                           (4095, 8, 64, 64),
                                           (2000, 2, 100, 37),
                                           (3000, 1, 4096, 49152))]


@pytest.mark.parametrize("kind,n_t,lanes,chunk,warmup", CASES)
def test_model_matches_plain_loop_and_jax_f64(kind, n_t, lanes, chunk, warmup):
    args = make_input(kind, n_t, lanes, seed=n_t + lanes)
    y, _ = chunked_scan(*args, chunk, warmup)
    np.testing.assert_array_equal(_bits(y), _bits(plain(*args)))
    np.testing.assert_allclose(y, jax_scan(*args), rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_model_is_jax_switching_onepole_bit_for_bit(kind):
    """Eight chunks of 6 steps with a warm-up of 5, against JAX's scan
    run op by op (no fused multiply-add)."""
    args = make_input(kind, 48, 2, seed=5)
    y, _ = chunked_scan(*args, 6, 5)
    np.testing.assert_array_equal(_bits(y), _bits(jax_scan(*args, jit=False)))


@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_plain_loop_f32(kind):
    args = make_input(kind, 3001, 3, seed=7, dtype=np.float32)
    y, _ = chunked_scan(*args, 64, 64)
    assert y.dtype == np.float32
    np.testing.assert_array_equal(_bits(y), _bits(plain(*args)))


def test_rerun_steps_follow_the_merge():
    """Silence after a burst never merges (every later chunk is re-run
    whole); a warm-up longer than the merge re-runs nothing."""
    n_t, chunk = 4000, 64
    x, up, dn, z0 = make_input("silence", n_t, 1, seed=3)
    y, steps = chunked_scan(x, up, dn, z0, chunk, 64)
    np.testing.assert_array_equal(_bits(y), _bits(plain(x, up, dn, z0)))
    assert steps >= n_t - n_t // 5 - 2 * chunk
    x, up, dn, z0 = make_input("noise", n_t, 1, seed=3)
    up[:], dn[:] = 0.5, 0.6                 # merges within a few dozen steps
    y, steps = chunked_scan(x, up, dn, z0, chunk, 256)
    np.testing.assert_array_equal(_bits(y), _bits(plain(x, up, dn, z0)))
    assert steps == 0


@st.composite
def scan_inputs(draw):
    n_t = draw(st.integers(1, 3000))
    lanes = draw(st.integers(1, 8))
    dtype = draw(st.sampled_from([np.float64, np.float32]))
    seed = draw(st.integers(0, 2**31 - 1))
    x, up, dn, z0 = make_input(draw(st.sampled_from(KINDS)), n_t, lanes,
                               seed, dtype)
    pole = st.floats(1e-6, 1.0, exclude_max=True)
    up[:] = [draw(pole) for _ in range(lanes)]
    dn[:] = [draw(pole) for _ in range(lanes)]
    z0[:] = [draw(st.floats(-3.0, 3.0)) for _ in range(lanes)]
    z0[0] = draw(st.sampled_from([z0[0], -0.0, 0.0, 1.0]))
    chunk = draw(st.integers(1, 300))
    warmup = draw(st.integers(0, 300))
    return x, up, dn, z0, chunk, warmup


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(scan_inputs())
def test_model_is_the_plain_loop_on_drawn_inputs(case):
    x, up, dn, z0, chunk, warmup = case
    y, _ = chunked_scan(x, up, dn, z0, chunk, warmup)
    np.testing.assert_array_equal(_bits(y), _bits(plain(x, up, dn, z0)))


@settings(max_examples=20, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(scan_inputs())
def test_model_is_jax_switching_onepole_on_drawn_inputs(case):
    x, up, dn, z0, chunk, warmup = case
    x, up, dn, z0 = (v.astype(np.float64) for v in (x, up, dn, z0))
    y, _ = chunked_scan(x, up, dn, z0, chunk, warmup)
    np.testing.assert_allclose(y, jax_scan(x, up, dn, z0), rtol=0,
                               atol=JAX_TOL)


def test_chunk_plan_matches_the_model():
    assert SS.chunk_plan(10, 4, 100) == (4, 8, 3) == _plan(10, 4, 100)
    assert SS.chunk_plan(5, 100, 7) == (5, 0, 1)
    assert SS.chunk_plan(4096 * 3, 4096, 49152) == (4096, 8192, 3)
    assert SS.chunk_plan(2_880_000, SS.CHUNK, SS.WARMUP[torch.float64]) == (
        1024, 49152, 2813)


@pytest.mark.parametrize("kw", [{"chunk": 0}, {"chunk": -3}, {"chunk": 2.5},
                                {"chunk": True}, {"warmup": -1},
                                {"warmup": 1.0}, {"warmup": False}])
def test_wrapper_rejects_bad_chunk_and_warmup(kw):
    x = torch.zeros(10, 2, dtype=torch.float64)
    v = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="chunk|warmup"):
        SS.switching_scan(x, v, v, v, **kw)


@pytest.mark.parametrize("kw", [{}, {"chunk": 1, "warmup": 0},
                                {"chunk": 64, "warmup": 64},
                                {"chunk": 10**9}])
def test_cpu_tensor_runs_the_plain_loop_and_launches_nothing(kw):
    x, up, dn, z0 = (torch.from_numpy(v) for v in
                     make_input("runs", 500, 3, seed=11))
    launches, reruns = SS.LAUNCHES, dict(SS.RERUN_STEPS)
    y = SS.switching_scan(x, up, dn, z0, **kw)
    assert SS.LAUNCHES == launches and SS.RERUN_STEPS == reruns
    ref = SS.switching_scan_reference(x, up, dn, z0)
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(ref.numpy()))
