"""The linear-recurrence solvers: the port's three plain doubling ladders
against the JAX package's (<= 1e-12 relative to max|z|), against the
sequential NumPy loop that the CUDA kernel is held to on the card, and the
wrapper's dispatch on CPU tensors."""
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
