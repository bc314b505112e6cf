"""The port's convolution (zorak_tpu_torch/kernels/convolution.py) on the
CPU, held to the JAX package's zorak_tpu/kernels/convolution.py and to
np.convolve on the same inputs, and K8's plain version held to a NumPy
loop in the kernel's order.

Tolerances:
- `fir_conv` (f64 in both packages) within 1e-9 of the JAX function and
  of np.convolve, as tests/test_kernels.py holds the JAX one;
- `partitioned_convolve` (f32/complex64 in both) within AUDIO_EPS = 1e-5
  x max(1, max|y|) of the JAX function (two FFT libraries round
  differently; the output's scale grows with the IR's energy), and
  within 2e-5 x max(1, max|ref|) of np.convolve in f64, the bound of
  tests/test_kernels.py;
- K8's plain version bit for bit against its NumPy loop;
- the new form of `partitioned_convolve` (irfft's 1/N folded into K8 as
  a power-of-two scale, the inverse transform unscaled) bit for bit
  against the old form (scale 1, irfft's own 1/N) at the shapes
  chip_smoke.py holds the card's convolution at: a power of two scales
  every rounding exactly;
- K8's library yardstick, one grouped complex `F.conv1d` over frames (a
  group a bin), within 1e-5 x max|y| of K8's plain version: the same
  function summed in another order (PyTorch's complex convolution
  forms each product from three real ones), a few f32 ulps of the
  largest partial sum apart.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zorak_tpu_torch.verify import AUDIO_EPS

JC = importlib.import_module("zorak_tpu.kernels.convolution")
PC = importlib.import_module("zorak_tpu_torch.kernels.convolution")


def _ir(k, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(k) * np.exp(-np.arange(k) / (k / 4))).astype(np.float32)


@pytest.mark.parametrize("shape", [(3000,), (3, 3000), (1, 500)])
@pytest.mark.parametrize("k", [1, 64, 700])
def test_fir_conv_matches_jax_and_numpy(shape, k):
    x = np.random.RandomState(3).randn(*shape)
    taps = np.random.RandomState(4).randn(k)
    got = PC.fir_conv(torch.from_numpy(x), torch.from_numpy(taps))
    assert got.dtype == torch.float64 and tuple(got.shape) == shape
    want = np.asarray(JC.fir_conv(jnp.asarray(x), jnp.asarray(taps)))
    assert np.abs(got.numpy() - want).max() < 1e-9
    ref = np.stack([np.convolve(r, taps)[:shape[-1]]
                    for r in x.reshape(-1, shape[-1])]).reshape(shape)
    assert np.abs(got.numpy() - ref).max() < 1e-9


def test_fir_conv_takes_f32_input():
    x = np.random.RandomState(5).randn(2, 800).astype(np.float32)
    taps = np.random.RandomState(6).randn(33)
    got = PC.fir_conv(torch.from_numpy(x), taps).numpy()
    want = np.asarray(JC.fir_conv(jnp.asarray(x), jnp.asarray(taps)))
    assert np.abs(got - want).max() < 1e-9


# (lanes or None for [T], T, IR length, part_size): the shapes chip_smoke.py
# holds K8 at, cut to CPU size: T not a multiple of B, an IR under one
# partition, T < B, one and three lanes, many partitions
CASES = [
    (None, 20000, 100, 1024),
    (None, 20000, 2048, 1024),
    (None, 20000, 10000, 1024),
    (1, 700, 300, 256),
    (3, 5000, 3000, 512),
    (3, 4097, 9000, 256),
    (None, 100, 1000, 256),
    (2, 1024, 1024, 1024),
]
IDS = [f"{'T' if l is None else l}x{t}-k{k}-B{b}" for l, t, k, b in CASES]


@pytest.mark.parametrize("lanes,t,k,b", CASES, ids=IDS)
def test_partitioned_convolve_matches_jax_and_numpy(lanes, t, k, b):
    shape = (t,) if lanes is None else (lanes, t)
    x = np.random.RandomState(t).randn(*shape).astype(np.float32)
    ir = _ir(k, k)
    got = PC.partitioned_convolve(torch.from_numpy(x), torch.from_numpy(ir),
                                  part_size=b).numpy()
    assert got.shape == shape and got.dtype == np.float32
    rows = x.reshape(-1, t)
    want = np.stack([np.asarray(JC.partitioned_convolve(
        jnp.asarray(r), jnp.asarray(ir), part_size=b)) for r in rows])
    got = got.reshape(-1, t)
    assert np.abs(got - want).max() <= AUDIO_EPS * max(1.0, np.abs(want).max())
    ref = np.stack([np.convolve(r.astype(np.float64), ir.astype(np.float64))[:t]
                    for r in rows])
    assert np.abs(got - ref).max() < 2e-5 * max(1.0, np.abs(ref).max())


def test_partitioned_convolve_takes_numpy_ir_and_f64_input():
    x = np.random.RandomState(7).randn(3000)
    ir = _ir(500, 8).astype(np.float64)
    got = PC.partitioned_convolve(torch.from_numpy(x), ir, part_size=256)
    assert got.dtype == torch.float32
    want = np.asarray(JC.partitioned_convolve(jnp.asarray(x), jnp.asarray(ir),
                                              part_size=256))
    assert np.abs(got.numpy() - want).max() <= AUDIO_EPS * max(
        1.0, np.abs(want).max())


def test_ir_spectra_match_the_reference_partitions():
    ir = _ir(1000, 9)
    h = PC.ir_spectra(torch.from_numpy(ir), 256).numpy()
    assert h.shape == (4, 257) and h.dtype == np.complex64
    parts = np.zeros((4, 256), np.float32)
    parts.reshape(-1)[:1000] = ir
    want = np.fft.rfft(parts.astype(np.float64), 512, axis=-1)
    assert np.abs(h - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# K8's plain version against a NumPy loop, bit for bit

def _mac_loop(x, h):
    """y[f] = sum over p ascending of x[f-p] * h[p], x[g] = 0 for g < 0 (the
    zero rows added too), the complex product written out, each step
    rounded in f32."""
    lanes, n_frames, bins = x.shape
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    hr, hi = h.real.astype(np.float32), h.imag.astype(np.float32)
    yr = np.zeros(x.shape, np.float32)
    yi = np.zeros(x.shape, np.float32)
    zero = np.zeros((lanes, bins), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for f in range(n_frames):
            for p in range(h.shape[0]):
                sr = xr[:, f - p] if f - p >= 0 else zero
                si = xi[:, f - p] if f - p >= 0 else zero
                yr[:, f] = yr[:, f] + (sr * hr[p] - si * hi[p])
                yi[:, f] = yi[:, f] + (sr * hi[p] + si * hr[p])
    return yr, yi


@pytest.mark.parametrize("lanes,n_frames,bins,parts", [
    (1, 5, 9, 1), (3, 7, 33, 4), (2, 3, 17, 9), (1, 20, 5, 70)])
def test_partition_mac_reference_keeps_the_order(lanes, n_frames, bins, parts):
    rng = np.random.RandomState(parts)
    x = (rng.randn(lanes, n_frames, bins)
         + 1j * rng.randn(lanes, n_frames, bins)).astype(np.complex64)
    h = ((rng.randn(parts, bins) + 1j * rng.randn(parts, bins)) * 1e3
         ).astype(np.complex64)
    h[0, 1] = complex(np.inf, 0.0)     # the zero rows meet it: NaN
    got = PC.partition_mac(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    yr, yi = _mac_loop(x, h)
    for a, b in ((got.real, yr), (got.imag, yi)):
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan)
        assert np.array_equal(np.where(nan, 0, a).view(np.int32),
                              np.where(nan, 0, b).view(np.int32))


def test_partition_mac_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 4, 9, dtype=torch.complex64)
    h = torch.zeros(3, 9, dtype=torch.complex64)
    with pytest.raises(ValueError):
        PC.partition_mac(x.to(torch.complex128), h)
    with pytest.raises(ValueError):
        PC.partition_mac(x, h[:, :8])
    with pytest.raises(ValueError):
        PC.partition_mac(x, h[:0])
    with pytest.raises(ValueError):
        PC.partition_mac(x[0], h)
    with pytest.raises(ValueError):
        PC.partition_mac(x.to("meta"), h.to("meta"))
    with pytest.raises(ValueError):
        PC.partitioned_convolve(torch.zeros(2, 2, 10), np.ones(3))


def test_cpu_tensors_take_the_plain_version():
    before = PC.LAUNCHES
    PC.partitioned_convolve(torch.zeros(2, 3000), _ir(3000, 1), part_size=512)
    assert PC.LAUNCHES == before


def test_partition_mac_scale_is_exact():
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.randn(2, 9, 17) + 1j * rng.randn(2, 9, 17)
                          ).astype(np.complex64))
    h = torch.from_numpy((rng.randn(5, 17) + 1j * rng.randn(5, 17)
                          ).astype(np.complex64))
    y = PC.partition_mac(x, h)
    for scale in (2.0 ** -13, 0.5, 8.0):
        got = torch.view_as_real(PC.partition_mac(x, h, scale))
        assert torch.equal(got, torch.view_as_real(y) * scale)


def test_partition_mac_refuses_a_scale_that_is_not_a_power_of_two():
    x = torch.zeros(1, 4, 9, dtype=torch.complex64)
    h = torch.zeros(3, 9, dtype=torch.complex64)
    for scale in (0.3, 3.0, -0.5, 0.0, float("inf"), float("nan"),
                  2.0 ** -127, 2.0 ** 128):
        with pytest.raises(ValueError, match="power of two"):
            PC.partition_mac(x, h, scale)
    with pytest.raises(ValueError, match="tile"):
        PC.partition_mac(x, h, tile=(4, 2, 8))      # the host form's only
    with pytest.raises(ValueError, match="power of 2"):
        PC.partitioned_convolve(torch.zeros(100), np.ones(3), part_size=384)


# chip_smoke.py's CONV_ODD: (lanes or None for [T], T, IR taps, part_size)
CONV_ODD = [(None, 20000, 100, 1024), (3, 5000, 3000, 512),
            (1, 700, 300, 256), (3, 4097, 9000, 256), (None, 100, 1000, 256)]


@pytest.mark.parametrize("lanes,t,k,b", CONV_ODD, ids=[
    f"{'T' if l is None else l}x{t}-k{k}-B{b}" for l, t, k, b in CONV_ODD])
def test_folded_scale_equals_the_separate_inverse_scale(lanes, t, k, b):
    shape = (t,) if lanes is None else (lanes, t)
    x = torch.from_numpy(np.random.RandomState(k).randn(*shape).astype(
        np.float32))
    ir = torch.from_numpy(_ir(k, t))
    got = PC.partitioned_convolve(x, ir, part_size=b)
    # the old form: K8 unscaled, then irfft with its own 1/N
    xl = x.reshape(-1, t)
    y_spec = PC.partition_mac(PC.input_spectra(xl, b), PC.ir_spectra(ir, b))
    old = PC.overlap_save_crop(torch.fft.irfft(y_spec, 2 * b, dim=-1), t)
    assert torch.equal(got.view(torch.int32),
                       old.reshape(shape).view(torch.int32))


@pytest.mark.parametrize("lanes,n_frames,bins,parts", [
    (2, 40, 33, 8), (3, 7, 33, 4), (1, 20, 5, 70), (2, 3, 17, 9),
    (3, 130, 65, 65)])
def test_partition_mac_library_call_computes_the_same_function(
        lanes, n_frames, bins, parts):
    rng = np.random.RandomState(n_frames)
    x = torch.from_numpy((rng.randn(lanes, n_frames, bins)
                          + 1j * rng.randn(lanes, n_frames, bins)
                          ).astype(np.complex64))
    h = torch.from_numpy((rng.randn(parts, bins) + 1j * rng.randn(
        parts, bins)).astype(np.complex64))
    # chip_smoke.py times this call as K8's library_ms
    lib = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x.permute(0, 2, 1), (parts - 1, 0)),
        h.T.flip(-1).unsqueeze(1), groups=bins).permute(0, 2, 1)
    want = PC.partition_mac_reference(x, h)
    assert lib.shape == want.shape
    assert (lib - want).abs().max() <= 1e-5 * want.abs().max()
