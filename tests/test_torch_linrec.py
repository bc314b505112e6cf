"""The linear-recurrence solvers: the port's three plain doubling ladders
against the JAX package's (<= 1e-12 relative to max|z|) and against the
sequential NumPy loop; the chunked order of the CUDA kernel
(`linrec_chunked`, which the kernel equals bit for bit on the card)
against the sequential loop and the JAX ladders within the stated
tolerance (1e-9 x max|z|), exact on integer counters, NaN and inf where
the loop has them; and the wrapper's dispatch on CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zorak_tpu.lowering import eelmath as JEM

from zorak_tpu_torch.kernels import linrec_scan as LS
from zorak_tpu_torch.lowering import eelmath as EM

REL = 1e-12


def rel_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def case(k, n, vec_a, seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-0.999, 0.9999, (k, n) if vec_a else (k,))
    a.flat[0] = 0.0
    return a, rng.randn(k, n), rng.uniform(-2.0, 2.0, k)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4096])
@pytest.mark.parametrize("vec_a", [False, True])
def test_assoc_scan_matches_jax_and_the_sequential_loop(n, vec_a):
    a, b, z0 = case(1, n, vec_a, seed=n)
    a1 = a[0] if vec_a else a[0].item()
    got = EM.linrec_assoc_scan(
        torch.from_numpy(a[0]) if vec_a else torch.tensor(a1, dtype=torch.float64),
        torch.from_numpy(b[0]), float(z0[0])).numpy()
    want = JEM.linrec_assoc_scan(jnp.asarray(a[0]) if vec_a else a1,
                                 jnp.asarray(b[0]), float(z0[0]))
    assert rel_err(got, want) <= REL
    assert rel_err(got, LS.linrec_sequential(a, b, z0)[0]) <= REL


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("n", [1, 7, 1000, 4096])
def test_scalar_batch_matches_jax_and_the_sequential_loop(k, n):
    a, b, z0 = case(k, n, False, seed=10 * k + n)
    got = EM.linrec_doubling_scalar_batch(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(z0)).numpy()
    want = JEM.linrec_doubling_scalar_batch(jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(z0))
    assert rel_err(got, want) <= REL
    assert rel_err(got, LS.linrec_sequential(a, b, z0)) <= REL


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("n", [1, 7, 1000, 4096])
def test_vector_batch_matches_jax_and_the_sequential_loop(k, n):
    a, b, z0 = case(k, n, True, seed=20 * k + n)
    got = EM.linrec_doubling_vector_batch(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(z0)).numpy()
    want = JEM.linrec_doubling_vector_batch(jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(z0))
    assert rel_err(got, want) <= REL
    assert rel_err(got, LS.linrec_sequential(a, b, z0)) <= REL


@pytest.mark.parametrize("vec_a", [False, True])
def test_wrapper_takes_the_plain_version_on_cpu_tensors(vec_a):
    a, b, z0 = case(3, 513, vec_a, seed=5)
    at, bt, zt = (torch.from_numpy(v) for v in (a, b, z0))
    before = LS.LAUNCHES
    got = LS.linrec_scan(at, bt, zt)
    assert LS.LAUNCHES == before          # no kernel was launched
    assert torch.equal(got, LS.linrec_scan_reference(at, bt, zt))
    assert torch.equal(bt, torch.from_numpy(b))     # inputs left alone
    assert rel_err(got.numpy(), LS.linrec_sequential(a, b, z0)) <= REL


def test_sequential_loop_is_the_golden_order():
    # z = a*z + b, multiply then add, one row after the other
    a, b, z0 = case(2, 50, True, seed=9)
    want = np.empty_like(b)
    for r in range(2):
        z = z0[r]
        for i in range(50):
            z = a[r, i] * z + b[r, i]
            want[r, i] = z
    assert np.array_equal(LS.linrec_sequential(a, b, z0), want)


def test_nan_and_empty_inputs():
    a, b, z0 = case(2, 64, False, seed=1)
    b[1, 20] = np.nan
    got = LS.linrec_scan(*(torch.from_numpy(v) for v in (a, b, z0))).numpy()
    seq = LS.linrec_sequential(a, b, z0)
    assert np.array_equal(np.isnan(got), np.isnan(seq))
    assert not np.isnan(got[0]).any() and np.isnan(got[1, 20:]).all()
    empty = LS.linrec_scan(torch.zeros(2, dtype=torch.float64),
                           torch.zeros((2, 0), dtype=torch.float64),
                           torch.zeros(2, dtype=torch.float64))
    assert empty.shape == (2, 0)


@pytest.mark.parametrize("bad", ["b_1d", "a_shape", "z0_shape", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros(2, dtype=torch.float64)
    b = torch.zeros((2, 8), dtype=torch.float64)
    z0 = torch.zeros(2, dtype=torch.float64)
    if bad == "b_1d":
        b = b[0]
    elif bad == "a_shape":
        a = torch.zeros(3, dtype=torch.float64)
    elif bad == "z0_shape":
        z0 = torch.zeros(1, dtype=torch.float64)
    else:
        b = b.to(torch.float32)
    with pytest.raises(ValueError):
        LS.linrec_scan(a, b, z0)


# (b) the kernel's chunked order ---------------------------------------------


def chunk_case(kind, k, n, vec_a, seed):
    rng = np.random.RandomState(seed)
    shape = (k, n) if vec_a else (k,)
    if kind == "pole":               # |a| < 1, both signs
        a = rng.uniform(0.5, 0.99995, shape) * np.where(
            rng.rand(*shape) < 0.3, -1.0, 1.0)
    elif kind == "integrator":       # a = 1
        a = np.ones(shape)
    elif kind == "growing":          # |a| > 1
        a = rng.uniform(1.0, 1.0 + 2.0 / max(n, 1), shape)
    else:                            # a = 0 here and there: z = b
        a = rng.uniform(-0.99, 0.99, shape)
        a.flat[::5] = 0.0
    return a, rng.randn(k, n), rng.uniform(-2.0, 2.0, k)


def finite_rel_err(got, want):
    fin = np.isfinite(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[np.isinf(want)], want[np.isinf(want)])
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(got[fin] - want[fin]))
                 / max(float(np.max(np.abs(want[fin]))), 1e-300))


@pytest.mark.parametrize("chunk", [1, 64, 256])
@pytest.mark.parametrize("n", [1, 7, 63, 1000, 4096])
@pytest.mark.parametrize("kind", ["pole", "integrator", "growing", "zero"])
@pytest.mark.parametrize("vec_a", [False, True])
def test_chunked_order_is_within_the_tolerance_of_the_loop(vec_a, kind, n,
                                                           chunk):
    a, b, z0 = chunk_case(kind, 3, n, vec_a, seed=n + chunk)
    got = LS.linrec_chunked(a, b, z0, chunk)
    seq = LS.linrec_sequential(a, b, z0)
    assert got.shape == seq.shape
    assert finite_rel_err(got, seq) <= LS.TOL_REL
    # chunk 0 starts from z0: the loop's own values, bit for bit
    c = min(chunk, n)
    assert np.array_equal(got[:, :c], seq[:, :c])
    if chunk >= n:
        assert np.array_equal(got, seq)


@pytest.mark.parametrize("vec_a", [False, True])
def test_chunked_order_is_exact_on_sample_counters(vec_a):
    # a = 1 and integer b below 2^53: every sum is exact in either order
    rng = np.random.RandomState(3)
    n = 5000
    a = np.ones((2, n) if vec_a else 2)
    b = rng.randint(-1000, 1000, (2, n)).astype(np.float64)
    b[0] = 1.0                                   # t + z0, a counter
    z0 = np.array([7.0, -3.0])
    got = LS.linrec_chunked(a, b, z0, 256)
    assert np.array_equal(got, LS.linrec_sequential(a, b, z0))
    assert np.array_equal(got[0], 7.0 + np.arange(1, n + 1))


def test_chunked_order_puts_nan_and_inf_where_the_loop_does():
    n, chunk = 3000, 256
    rng = np.random.RandomState(4)
    a = rng.uniform(0.5, 0.99, (6, n))
    b = rng.randn(6, n)
    b[0, 700] = np.nan                  # NaN in b: NaN from there on
    b[1, 400] = np.inf                  # inf in b
    a[1, 2000] = 0.0                    # then 0 * inf: NaN
    b[2, 300] = np.nan
    a[2, 1300] = 0.0                    # a = 0 after a NaN carry: NaN
    a[3] = 1.5                          # overflows to inf
    a[4] = 10.0
    a[4, 600] = 0.0                     # overflow, then 0 * inf: NaN
    a[5] = 1e-200                       # products underflow to 0; the
                                        # inf carry stays inf
    z0 = np.array([0.5, 0.5, 0.5, 0.5, 1e300, np.inf])
    seq = LS.linrec_sequential(a, b, z0)
    for vec in (True, False):
        av = a if vec else a[:, 0]
        sq = seq if vec else LS.linrec_sequential(av, b, z0)
        got = LS.linrec_chunked(av, b, z0, chunk)
        assert finite_rel_err(got, sq) <= LS.TOL_REL
    assert np.isnan(seq[0, 700:]).all() and np.isnan(seq[1, 2000:]).all()
    assert np.isinf(seq[1, 400:2000]).all() and np.isinf(seq[3, -1])
    assert np.isnan(seq[4, 600:]).all() and np.isinf(seq[4, 599])
    assert np.isinf(seq[5]).all()


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("n", [7, 1000, 4096])
@pytest.mark.parametrize("vec_a", [False, True])
def test_chunked_order_is_within_the_tolerance_of_the_jax_ladders(k, n,
                                                                  vec_a):
    # the same numpy inputs through the reference's doubling ladders
    a, b, z0 = case(k, n, vec_a, seed=30 * k + n + vec_a)
    ladder = (JEM.linrec_doubling_vector_batch if vec_a
              else JEM.linrec_doubling_scalar_batch)
    want = np.asarray(ladder(jnp.asarray(a), jnp.asarray(b), jnp.asarray(z0)))
    for chunk in (64, LS.CHUNK):
        got = LS.linrec_chunked(a, b, z0, chunk)
        assert rel_err(got, want) <= LS.TOL_REL


@pytest.mark.parametrize("chunk", [0, -3, 1.5, True])
def test_wrapper_rejects_a_chunk_the_kernel_does_not_take(chunk):
    a, b, z0 = case(2, 16, False, seed=2)
    with pytest.raises(ValueError, match="chunk"):
        LS.linrec_scan(*(torch.from_numpy(v) for v in (a, b, z0)),
                       chunk=chunk)
