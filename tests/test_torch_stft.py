"""The port's STFT pipeline (zorak_tpu_torch/kernels/stft.py) on the CPU,
held to the JAX package's zorak_tpu/kernels/stft.py on the same inputs,
and its kernels' plain versions (K7a, K7b, K7c) held to NumPy loops in
the order each kernel keeps.

Tolerances:
- spectra within 1e-5 x max|X| (two FFT libraries round differently);
- audio within AUDIO_EPS = 1e-5 where the window-power sum wsum is at
  least 1e-3.  Both packages divide by wsum, which falls to ~0 within the
  first and last hop of a symmetric Hann window: there it magnifies the
  FFTs' rounding (~1e-7 of the frame) by 1/w.  The overlap-add before
  that division (y x wsum) is held within AUDIO_EPS everywhere.
- the plain kernels' versions bit for bit against their NumPy loops.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zorak_tpu_torch.verify import AUDIO_EPS

JS = importlib.import_module("zorak_tpu.kernels.stft")
PS = importlib.import_module("zorak_tpu_torch.kernels.stft")

SPEC_REL = 1e-5
WSUM_MIN = 1e-3

# (lanes or None for [T], T, size, hop): the shapes chip_smoke.py holds
# the kernels at, cut to CPU size: 1 and 3 lanes, a hop that does not
# divide the size, T < size, T not a multiple of the hop
CASES = [
    (None, 6000, 512, 128),
    (1, 4096, 512, None),
    (3, 5000, 512, 128),
    (3, 7001, 600, 250),
    (1, 300, 512, 128),
    (None, 1000, 256, 96),
]
IDS = [f"{'T' if l is None else l}x{t}-{s}-{h}" for l, t, s, h in CASES]


def _input(lanes, t, seed, scale=0.25):
    shape = (t,) if lanes is None else (lanes, t)
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _jax_lanes(fn, x):
    """The JAX function on [T], or vmapped by hand over [lanes, T]."""
    if x.ndim == 1:
        return np.array(fn(jnp.asarray(x)))
    return np.stack([np.asarray(fn(jnp.asarray(row))) for row in x])


def _wsum(t, size, hop):
    n_frames = JS._n_frames(t, size, hop)
    w = np.hanning(size).astype(np.float32)
    return JS._ola_window_norm(w, n_frames, size, hop)[:t].astype(np.float64)


def _assert_audio(got, want, size, hop):
    t = got.shape[-1]
    wsum = _wsum(t, size, hop)
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (d * wsum).max() <= AUDIO_EPS
    assert d[..., wsum >= WSUM_MIN].max() <= AUDIO_EPS


@pytest.mark.parametrize("lanes,t,size,hop", CASES, ids=IDS)
def test_stft_matches_jax(lanes, t, size, hop):
    x = _input(lanes, t, 1)
    spec, meta = PS.stft(torch.from_numpy(x), size, hop)
    want = _jax_lanes(lambda a: JS.stft(a, size, hop)[0], x)
    got = spec.numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.abs(got - want).max() <= SPEC_REL * np.abs(want).max()
    assert meta[0] == size and meta[1] == (hop or size // 2) and meta[3] == t
    assert np.array_equal(meta[2], np.hanning(size).astype(np.float32))


@pytest.mark.parametrize("lanes,t,size,hop", CASES, ids=IDS)
def test_istft_of_the_jax_spectrum_matches_jax(lanes, t, size, hop):
    x = _input(lanes, t, 2)
    want = _jax_lanes(lambda a: JS.istft(*JS.stft(a, size, hop)), x)
    spec = _jax_lanes(lambda a: JS.stft(a, size, hop)[0], x)
    _, meta = PS.stft(torch.from_numpy(x), size, hop)
    got = PS.istft(torch.from_numpy(spec), meta).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    _assert_audio(got, want, size, hop or size // 2)


@pytest.mark.parametrize("lanes,t,size,hop", CASES, ids=IDS)
def test_stft_process_matches_jax(lanes, t, size, hop):
    x = _input(lanes, t, 3)

    def tilt_j(s):
        return s * jnp.linspace(0.5, 1.5, s.shape[-1], dtype=jnp.float32)

    def tilt_p(s):
        return s * torch.linspace(0.5, 1.5, s.shape[-1])

    want = _jax_lanes(lambda a: JS.stft_process(a, tilt_j, size, hop), x)
    got = PS.stft_process(torch.from_numpy(x), tilt_p, size, hop).numpy()
    assert got.shape == x.shape
    _assert_audio(got, want, size, hop or size // 2)


@pytest.mark.parametrize("lanes,t,size,hop", CASES, ids=IDS)
def test_spectral_gate_matches_jax(lanes, t, size, hop):
    # quiet noise (as the bench's denoiser input) with a tone in lane 0
    x = _input(lanes, t, 4, scale=0.02)
    tone = (0.3 * np.sin(2 * np.pi * 440 * np.arange(t) / 48000.0)
            ).astype(np.float32)
    if lanes is None:
        x += tone
    else:
        x[0] += tone
    want = _jax_lanes(lambda a: JS.spectral_gate(a, size=size, hop=hop), x)
    got = PS.spectral_gate(torch.from_numpy(x), size=size, hop=hop).numpy()
    assert got.shape == x.shape
    _assert_audio(got, want, size, hop or size // 2)


def test_spectral_gate_takes_the_threshold_and_floor():
    x = _input(2, 4096, 5, scale=0.05)
    for thr_db, floor_db in ((-30.0, -12.0), (-80.0, -40.0)):
        want = _jax_lanes(lambda a: JS.spectral_gate(
            a, threshold_db=thr_db, size=512, floor_db=floor_db), x)
        got = PS.spectral_gate(torch.from_numpy(x), threshold_db=thr_db,
                               size=512, floor_db=floor_db).numpy()
        _assert_audio(got, want, 512, 256)


def test_stft_takes_f64_input_and_a_given_window():
    x = np.random.RandomState(6).randn(3000)
    w = np.blackman(256)
    spec, meta = PS.stft(torch.from_numpy(x), 256, 64, window=w)
    want = np.asarray(JS.stft(jnp.asarray(x), 256, 64, window=w)[0])
    assert spec.dtype == torch.complex64
    assert np.abs(spec.numpy() - want).max() <= SPEC_REL * np.abs(want).max()
    assert meta[2].dtype == np.float32


# ---------------------------------------------------------------------------
# the plain versions of K7a, K7b, K7c against NumPy loops, bit for bit

@pytest.mark.parametrize("t,size,hop", [(5000, 512, 128), (300, 512, 128),
                                        (7001, 600, 250), (2048, 2048, 512)])
def test_frame_window_reference_is_the_padded_framing(t, size, hop):
    x = _input(3, t, 7)
    w = np.hanning(size).astype(np.float32)
    got = PS.frame_window(torch.from_numpy(x), torch.from_numpy(w), size,
                          hop).numpy()
    n_frames = PS._n_frames(t, size, hop)
    xp = np.zeros((3, (n_frames - 1) * hop + size), np.float32)
    xp[:, :t] = x
    want = np.stack([xp[:, f * hop:f * hop + size] * w
                     for f in range(n_frames)], axis=1)
    assert np.array_equal(got, want)
    assert n_frames == JS._n_frames(t, size, hop)


def _ola_loop(frames, w, inv, hop, t_out):
    """NumPy loop of K7b's order: frames descending where hop divides the
    size, ascending otherwise, each product and sum rounded in f32."""
    lanes, n_frames, size = frames.shape
    order = (range(n_frames - 1, -1, -1) if size % hop == 0
             else range(n_frames))
    y = np.zeros((lanes, t_out), np.float32)
    for t in range(t_out):
        acc = np.zeros(lanes, np.float32)
        for f in order:
            i = t - f * hop
            if 0 <= i < size:
                acc = acc + frames[:, f, i] * w[i]
        y[:, t] = acc * inv[t]
    return y


@pytest.mark.parametrize("n_frames,size,hop,t_out", [
    (6, 64, 16, 140), (5, 60, 25, 150), (1, 64, 32, 40), (4, 32, 40, 150),
    (3, 48, 48, 144)])
def test_overlap_add_norm_reference_keeps_the_order(n_frames, size, hop,
                                                    t_out):
    rng = np.random.RandomState(n_frames * size)
    frames = (rng.randn(2, n_frames, size) * 1e3).astype(np.float32)
    frames[0, 0, 3] = -0.0
    w = np.hanning(size).astype(np.float32)
    inv = PS._inv_wsum(w.tobytes(), n_frames, size, hop)
    got = PS.overlap_add_norm(torch.from_numpy(frames), torch.from_numpy(w),
                              torch.from_numpy(inv), hop, t_out).numpy()
    want = _ola_loop(frames, w, inv, hop, t_out)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_inv_wsum_is_the_f32_reciprocal_of_the_reference_sum():
    w = np.hanning(512).astype(np.float32)
    inv = PS._inv_wsum(w.tobytes(), 9, 512, 128)
    want = np.float32(1.0) / np.asarray(JS._ola_window_norm(w, 9, 512, 128))
    assert inv.dtype == np.float32 and np.array_equal(inv, want)


def _gain_loop(spec, thr, floor_db):
    """NumPy f32 formula of K7c, each step rounded."""
    f = np.float32
    m = f(10.0 ** (floor_db / 20.0))
    re, im = spec.real.astype(f), spec.imag.astype(f)
    th = np.maximum(thr, f(1e-12))[:, None, None]
    with np.errstate(invalid="ignore"):
        mag = np.sqrt(re * re + im * im)
        s = np.clip((mag / th - f(1)) / f(2), f(0), f(1))
        g = m + (f(1) - m) * s * s * (f(3) - f(2) * s)
    return re * g, im * g


def test_gate_gain_reference_is_the_soft_knee():
    rng = np.random.RandomState(8)
    spec = (rng.randn(3, 7, 33) + 1j * rng.randn(3, 7, 33)).astype(np.complex64)
    spec[1, 2, 3] = np.nan
    thr = np.array([0.5, 1.0, 0.0], np.float32)
    got = PS.gate_gain(torch.from_numpy(spec), torch.from_numpy(thr),
                       -24.0).numpy()
    re, im = _gain_loop(spec, thr, -24.0)
    assert np.array_equal(got.real, re, equal_nan=True)
    assert np.array_equal(got.imag, im, equal_nan=True)


def test_magnitude_is_within_an_ulp_of_abs():
    rng = np.random.RandomState(9)
    spec = (rng.randn(4000) + 1j * rng.randn(4000)).astype(np.complex64)
    got = PS.magnitude(torch.from_numpy(spec)).numpy()
    want = np.abs(spec)
    assert np.abs(got - want).max() <= np.spacing(want).max()


# ---------------------------------------------------------------------------
# the noise estimate: jnp.percentile's and jnp.median's rules
#
# The linear rule takes lo*(1-w) + hi*w in f64 and rounds it to f32.  The
# port rounds each step; XLA's CPU backend fuses the two products' sum
# into one multiply-add, so the two differ by at most one f32 ulp (in
# under 1 % of the bins here).  The port equals a NumPy evaluation of the
# rule step by step bit for bit.

def _percentile_steps(a, q, axis):
    """NumPy: the linear rule, each f64 step rounded."""
    n = a.shape[axis]
    pos = (q / 100.0) * (n - 1.0)
    srt = np.sort(a, axis=axis)
    lo = np.take(srt, int(np.clip(np.floor(pos), 0, n - 1)), axis=axis)
    hi = np.take(srt, int(np.clip(np.ceil(pos), 0, n - 1)), axis=axis)
    hw = pos - np.floor(pos)
    return (lo.astype(np.float64) * (1.0 - hw)
            + hi.astype(np.float64) * hw).astype(np.float32)


def _assert_percentile(got, a, q, axis):
    want = np.asarray(jnp.percentile(jnp.asarray(a), q, axis=axis))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, _percentile_steps(a, q, axis))
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("shape", [(10, 7), (11, 8), (1, 5), (2, 3),
                                   (1872, 4)])
def test_percentile_follows_jnp_percentile(shape):
    a = np.random.RandomState(shape[0]).rand(*shape).astype(np.float32)
    a[0, 0] = a[1 % shape[0], 0]            # a tie
    for q in (10.0, 50.0, 0.0, 100.0, 37.5):
        got = PS.percentile(torch.from_numpy(a), q, dim=0).numpy()
        _assert_percentile(got, a, q, 0)


def test_percentile_is_nan_where_a_column_holds_nan():
    a = np.random.RandomState(1).rand(9, 4).astype(np.float32)
    a[3, 1] = np.nan
    got = PS.percentile(torch.from_numpy(a), 10.0, dim=0).numpy()
    want = np.asarray(jnp.percentile(jnp.asarray(a), 10.0, axis=0))
    assert np.isnan(got[1]) and np.isnan(want[1])
    keep = [0, 2, 3]
    assert (np.abs(got[keep] - want[keep])
            <= np.spacing(np.abs(want[keep]))).all()


@pytest.mark.parametrize("n", [1, 2, 6, 7, 1025, 1024])
def test_median_is_jnp_median(n):
    a = np.random.RandomState(n).rand(3, n).astype(np.float32)
    got = PS.median(torch.from_numpy(a)).numpy()
    want = np.stack([np.asarray(jnp.median(jnp.asarray(r))) for r in a])
    assert np.array_equal(got, want)
    if n % 2 == 0:   # the mean of the two middle values, not the lower
        srt = np.sort(a, axis=-1)
        mid = (srt[:, n // 2 - 1] + srt[:, n // 2]) * np.float32(0.5)
        assert np.array_equal(got, mid)
        if n > 2:
            assert not np.array_equal(got, torch.median(
                torch.from_numpy(a), dim=-1).values.numpy())
    a[1, 0] = np.nan
    assert np.isnan(PS.median(torch.from_numpy(a)).numpy()[1])


def test_percentile_and_median_beyond_2_pow_24_elements():
    # the bench's gate takes the percentile over 32 x 1,872 x 1,025
    # (61.4 M) magnitudes; torch.quantile refuses inputs of more than 2^24
    # elements (in the versions that check)
    a = np.random.RandomState(3).rand(2, 1872, 4500).astype(np.float32)
    assert a.size > 2 ** 24
    ta = torch.from_numpy(a)
    _assert_percentile(PS.percentile(ta, 10.0, dim=1).numpy(), a, 10.0, 1)
    flat = a.reshape(-1)[:2 ** 24 + 2]
    assert np.array_equal(PS.median(torch.from_numpy(flat)).numpy(),
                          np.asarray(jnp.median(jnp.asarray(flat))))


# ---------------------------------------------------------------------------
# the wrappers

def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 100)
    w = torch.zeros(64)
    with pytest.raises(ValueError):
        PS.frame_window(x.double(), w, 64, 16)
    with pytest.raises(ValueError):
        PS.frame_window(x, torch.zeros(63), 64, 16)
    with pytest.raises(ValueError):
        PS.frame_window(x.to("meta"), w.to("meta"), 64, 16)
    fr = torch.zeros(2, 3, 64)
    with pytest.raises(ValueError):
        PS.overlap_add_norm(fr, w, torch.zeros(95), 16, 90)   # inv too short
    with pytest.raises(ValueError):
        PS.overlap_add_norm(fr, w, torch.zeros(96), 16, 97)   # past the end
    spec = torch.zeros(2, 3, 33, dtype=torch.complex64)
    with pytest.raises(ValueError):
        PS.gate_gain(spec, torch.zeros(3), -24.0)
    with pytest.raises(ValueError):
        PS.gate_gain(spec.to(torch.complex128), torch.zeros(2), -24.0)
    with pytest.raises(ValueError):
        PS.stft(torch.zeros(2, 2, 100), 64)


def test_cpu_tensors_take_the_plain_versions():
    before = dict(PS.LAUNCHES)
    PS.spectral_gate(torch.from_numpy(_input(2, 3000, 10)), size=256)
    assert PS.LAUNCHES == before
