"""zorak_tpu_torch dspkit and the switching-scan wrapper against zorak_tpu.

Every input is made from a seed with numpy and handed to both packages.
Runs on the CPU, where the port's wrapper takes the plain PyTorch loop;
the CUDA kernel itself is held to that loop on the card by chip_smoke.py.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zorak_tpu.kernels.pallas_scan import switching_onepole_pallas
from zorak_tpu.models import dspkit as J
from zorak_tpu_torch.convert import state_from_numpy
from zorak_tpu_torch.device import resolve_device
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import switching_scan as SS
from zorak_tpu_torch.models import dspkit as P

SR = 48000.0
# f64 scans: the port runs Hillis-Steele doubling, JAX lax.associative_scan;
# the two combine the same terms in another order, so they differ by
# rounding only (observed <= 1e-14 on unit-variance input at T <= 3000).
SCAN_TOL = 1e-12
# f64 elementwise helpers: libm vs XLA's exp/log/pow differ by an ulp or so.
ELEM_TOL = 1e-14
# The JAX scans below run under jax.jit: one XLA compile instead of one
# per eager op of the associative scan's levels (seconds each on the CPU).


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _cpu(a):
    return torch.from_numpy(np.asarray(a, np.float64))


# ---------------------------------------------------------------------------
# scalar and elementwise helpers

HELPERS = [
    ("db2lin", (-6.5,)),
    ("db2lin", (_x((50,), 1) * 20,)),
    ("lin2db", (np.abs(_x((50,), 2)),)),
    ("clamp", (_x((50,), 3), -0.3, 0.4)),
    ("clamp", (0.9, 0.0, 0.5)),
    ("smoothstep01", (_x((50,), 4),)),
    ("ms2pole", (12.0, SR)),
    ("ms2pole", (np.abs(_x((50,), 5)) * 100 + 1, SR)),
    ("hz2pole", (0.0, SR)),
    ("hz2pole", (np.abs(_x((50,), 6)) * 1000, SR)),
]


@pytest.mark.parametrize("name,args", HELPERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(HELPERS)])
def test_helper_matches_jax(name, args):
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    pargs = [_cpu(a) if isinstance(a, np.ndarray) else a for a in args]
    want = np.asarray(getattr(J, name)(*jargs))
    got = getattr(P, name)(*pargs)
    assert isinstance(got, torch.Tensor) == isinstance(args[0], np.ndarray)
    np.testing.assert_allclose(_np(got), want, rtol=ELEM_TOL, atol=ELEM_TOL)


@pytest.mark.parametrize("kind,fc,q", [("hp", 11500.0, 0.707),
                                       ("lp", 2000.0, 0.707),
                                       ("bp_skirt", 9500.0, 1.0),
                                       ("bp_skirt", 30000.0, 0.0)])
def test_rbj_coeffs_match_jax(kind, fc, q):
    want = [float(c) for c in J.rbj_coeffs(kind, fc, q, SR)]
    got = P.rbj_coeffs(kind, fc, q, SR)
    np.testing.assert_allclose(got, want, rtol=ELEM_TOL, atol=ELEM_TOL)


def test_rbj_coeffs_unknown_kind():
    with pytest.raises(ValueError):
        P.rbj_coeffs("notch", 1000.0, 1.0, SR)


@pytest.mark.parametrize("samples", [0, 1, 15, 2999, 3000, 5000])
def test_delay_matches_jax(samples):
    x = _x((2, 3000), 7)
    want = np.asarray(J.delay(jnp.asarray(x), samples))
    assert np.array_equal(_np(P.delay(_cpu(x), samples)), want)


@pytest.mark.parametrize("ntaps", [3, 31, 257])
def test_fir_matches_jax(ntaps):
    x = _x((2, 3, 3000), 8)
    taps = _x((ntaps,), 9)
    want = np.asarray(J.fir(jnp.asarray(x), taps))
    # f64 convolution: XLA and conv1d sum the taps in another order
    np.testing.assert_allclose(_np(P.fir(_cpu(x), taps)), want,
                               rtol=0, atol=1e-12)


def test_fir_is_causal():
    x = np.zeros(64)
    x[10] = 1.0
    y = _np(P.fir(_cpu(x), np.array([0.5, 0.25, 0.125])))
    assert y[10] == 0.5 and y[11] == 0.25 and y[12] == 0.125
    assert np.all(y[:10] == 0)


@pytest.mark.parametrize("sigma", [0.1, 24.0, 96.0])
def test_gaussian_taps_match_jax(sigma):
    want = np.asarray(J.gaussian_fir_taps(sigma, 128))
    got = _np(P.gaussian_fir_taps(sigma, 128, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ELEM_TOL)
    assert abs(got.sum() - 1.0) < 1e-12


# ---------------------------------------------------------------------------
# recurrences

LINEAR = [("onepole", 0.98), ("integrator", 0.95), ("max_follower", 0.97)]
SHAPES = [(400,), (2, 3, 3000)]


@pytest.mark.parametrize("shape", SHAPES, ids=["T400", "2x3xT3000"])
@pytest.mark.parametrize("name,pole", LINEAR, ids=[n for n, _ in LINEAR])
def test_linear_scan_matches_jax(name, pole, shape):
    x = _x(shape, 10)
    if name == "max_follower":
        x = np.abs(x)
    z0 = np.abs(_x(shape[:-1] + (1,), 11))
    ref = jax.jit(lambda a, z: getattr(J, name)(a, pole, z))
    want = np.asarray(ref(jnp.asarray(x), jnp.asarray(z0)))
    got = getattr(P, name)(_cpu(x), pole, state_from_numpy(z0, device="cpu"))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=SCAN_TOL)


def test_onepole_per_sample_pole_matches_jax():
    x = _x((3000,), 12)
    pole = 0.9 + 0.09 * np.abs(np.sin(np.arange(3000) / 50.0))
    want = np.asarray(jax.jit(J.onepole)(jnp.asarray(x), jnp.asarray(pole)))
    np.testing.assert_allclose(_np(P.onepole(_cpu(x), _cpu(pole))), want,
                               rtol=0, atol=SCAN_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=["T400", "2x3xT3000"])
def test_switching_onepole_matches_jax(shape):
    x = _x(shape, 13)
    z0 = np.abs(_x(shape[:-1], 14)) if len(shape) > 1 else 0.3
    want = np.asarray(J.switching_onepole(jnp.asarray(x), 0.7, 0.99,
                                          jnp.asarray(z0)))
    got = P.switching_onepole(_cpu(x), 0.7, 0.99,
                              state_from_numpy(z0, device="cpu"))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=SCAN_TOL)


def test_amp_follower_matches_jax():
    x = _x((2, 3000), 15) * 10
    want = np.asarray(J.amp_follower_ar(jnp.asarray(x), 0.012, 0.35, SR))
    got = P.amp_follower_ar(_cpu(x), 0.012, 0.35, SR)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=SCAN_TOL)


@pytest.mark.parametrize("kind,fc,q", [("hp", 11500.0, 0.707),
                                       ("lp", 2000.0, 0.707),
                                       ("bp_skirt", 16000.0, 1.2)])
def test_biquad_matches_jax(kind, fc, q):
    x = _x((2, 3000), 16)
    c = P.rbj_coeffs(kind, fc, q, SR)
    s0 = (0.1, -0.2)
    want = np.asarray(jax.jit(lambda a: J.biquad_tf2(a, *c, s0=s0))(
        jnp.asarray(x)))
    got = P.biquad_tf2(_cpu(x), *c, s0=state_from_numpy(s0, device="cpu"))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=SCAN_TOL)


@pytest.mark.parametrize("seed", [12345, 54321, 0, 2**32 - 1])
def test_lcg_noise_is_bit_exact(seed):
    want = np.asarray(J.lcg_noise(3000, seed=seed))
    got = _np(P.lcg_noise(3000, seed=seed, device="cpu"))
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the switching-scan wrapper and its plain version

# f32: the Pallas kernel (interpret mode) and the plain loop do the same
# f32 steps; 1e-5 is the bound tests/test_pallas_scan.py holds it to.
PALLAS = [((2, 3000), 0.6, 0.995, 0), ((500,), 0.5, 0.99, 1),
          ((2500,), 0.7, 0.98, 2)]


@pytest.mark.parametrize("shape,up,dn,seed", PALLAS,
                         ids=["2xT3000", "T500", "T2500-chunk-carry"])
def test_reference_matches_pallas_interpret(shape, up, dn, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if shape == (500,):
        x = np.abs(x)
    want = np.asarray(switching_onepole_pallas(jnp.asarray(x), up, dn,
                                               interpret=True))
    lead = shape[:-1]
    lanes = int(np.prod(lead)) if lead else 1
    xl = torch.from_numpy(x.reshape(lanes, shape[-1]).T.copy())
    full = lambda v: torch.full((lanes,), v, dtype=torch.float32)  # noqa: E731
    y = SS.switching_scan_reference(xl, full(up), full(dn), full(0.0))
    got = y.T.reshape(shape).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_wrapper_on_cpu_is_the_plain_loop_and_launches_nothing():
    x = torch.from_numpy(np.abs(_x((700, 3), 17)))
    up, dn, z0 = (torch.full((3,), v, dtype=torch.float64)
                  for v in (0.5, 0.99, 0.1))
    before = SS.LAUNCHES
    got = SS.switching_scan(x, up, dn, z0)
    assert SS.LAUNCHES == before
    assert torch.equal(got, SS.switching_scan_reference(x, up, dn, z0))


@pytest.mark.parametrize("case", ["1d", "int", "lanes", "dtype"])
def test_wrapper_rejects_bad_inputs(case):
    x = torch.zeros(10, 2, dtype=torch.float64)
    v = torch.zeros(2, dtype=torch.float64)
    args = {"1d": (x[:, 0], v, v, v),
            "int": (x.long(), v.long(), v.long(), v.long()),
            "lanes": (x, torch.zeros(3, dtype=torch.float64), v, v),
            "dtype": (x, v.float(), v, v)}[case]
    with pytest.raises((ValueError, TypeError)):
        SS.switching_scan(*args)


def test_chain_probe_takes_only_cuda_tensors():
    x = torch.zeros(SS.CHAIN_CHUNK, dtype=torch.float64)
    v = torch.zeros(1, dtype=torch.float64)
    launches = SS.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        SS.switching_chain_probe(x, v, v, v, 1024)
    assert SS.LAUNCHES == launches


def test_build_module_imports_and_names_libraries_without_nvcc(
        monkeypatch, tmp_path):
    assert set(_build.SOURCES) == {"switching_scan", "linrec_scan",
                                   "ring_taps", "stft_ola", "partition_mac"}
    for name, src in _build.SOURCES.items():
        assert (_build.CSRC_DIR / src).is_file(), name
    path = _build.library_path("switching_scan")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("switching_scan")  # stable hash
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in _build.NVCC_FLAGS
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if not os.path.isfile("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build("switching_scan")
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build_all()
        assert not (tmp_path / "build").exists()


def test_resolve_device_policy():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cpu"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            P.lcg_noise(10)
    with pytest.raises(ValueError):
        resolve_device("meta")
