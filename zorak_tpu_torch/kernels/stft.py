"""STFT overlap-add processing: CUDA kernels + plain versions.

Counterpart of zorak_tpu/kernels/stft.py, with the same names and the
same f32/complex64 pipeline: frames are not centred, the tail is padded
with zeros, the window is NumPy's symmetric Hann (`np.hanning`, not
`torch.hann_window`), and the overlap-add is normalised by the
window-power sum.  It takes `[T]` or `[lanes, T]` (the reference vmaps
over lanes).  FFTs are `torch.fft.rfft`/`irfft` (cuFFT on the card), as
the reference leaves them to XLA.  Around them, three kernels of
`csrc/stft_ola.cu`:

    K7a frame_window      framing times the analysis window
    K7b overlap_add_norm  synthesis window, overlap-add, x 1/wsum, crop
    K7c gate_gain         the spectral gate's soft-knee gain

Each wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch version (`*_reference`, the same operations in the same order,
each rounded on its own) on a CPU tensor; the two are equal bit for bit.
Nothing falls back from one to the other.  The gate's noise estimate (a
10th percentile along frames, a median across bins) is plain PyTorch,
written out with `jnp.percentile`'s and `jnp.median`'s rules
(`percentile`, `median`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

from . import _build

# Kernel launches by kernel since the counts were last set; chip_smoke.py
# zeroes them before a path and reads them after to show the path went
# through the kernels.
LAUNCHES = {"frame_window": 0, "overlap_add_norm": 0, "gate_gain": 0}

F32 = torch.float32
C64 = torch.complex64


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("stft_ola")
    lib.zorak_frame_window.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p]
    lib.zorak_overlap_add_norm.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.zorak_gate_gain.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p]
    for fn in (lib.zorak_frame_window, lib.zorak_overlap_add_norm,
               lib.zorak_gate_gain):
        fn.restype = ctypes.c_int
    return lib


def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return True


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# framing and window normalisation

def _n_frames(t: int, size: int, hop: int) -> int:
    return max(1, -(-max(t - size, 0) // hop) + 1)


def _frame(x: torch.Tensor, size: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., frames, size] with zero padding at the tail."""
    t = x.shape[-1]
    n_frames = _n_frames(t, size, hop)
    pad = (n_frames - 1) * hop + size - t
    xp = torch.nn.functional.pad(x, (0, pad))
    return xp.unfold(-1, size, hop)


def _ola_window_norm(window, n_frames: int, size: int, hop: int) -> np.ndarray:
    """Input-independent analysis*synthesis window-power sum, as the
    reference computes it on the host (f64 sums, floored at 1e-12, f32)."""
    w2 = np.asarray(window, np.float64) ** 2
    total = (n_frames - 1) * hop + size
    wsum = np.zeros(total, np.float64)
    for f in range(n_frames):
        wsum[f * hop:f * hop + size] += w2
    return np.maximum(wsum, 1e-12).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _inv_wsum(window_bytes: bytes, n_frames: int, size: int,
              hop: int) -> np.ndarray:
    """1 / wsum in f32 (a reciprocal, then a multiply, as the reference)."""
    window = np.frombuffer(window_bytes, np.float32)
    return np.float32(1.0) / _ola_window_norm(window, n_frames, size, hop)


def _as_lanes(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() not in (1, 2):
        raise ValueError(f"{name} takes [T] or [lanes, T], got shape "
                         f"{tuple(x.shape)}")
    return x.reshape(-1, x.shape[-1])


def frame_window_reference(x: torch.Tensor, window: torch.Tensor, size: int,
                           hop: int) -> torch.Tensor:
    """Plain version of K7a: [lanes, T] f32 -> [lanes, frames, size] f32."""
    return _frame(x, size, hop) * window


def frame_window(x: torch.Tensor, window: torch.Tensor, size: int,
                 hop: int) -> torch.Tensor:
    """K7a: frames of x (zero-padded tail) times the window.

    x [lanes, T] f32, window [size] f32 on x's device -> [lanes, frames,
    size] f32.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    if x.dim() != 2 or x.dtype != F32:
        raise ValueError(f"x must be [lanes, T] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if tuple(window.shape) != (size,) or window.dtype != F32 \
            or window.device != x.device:
        raise ValueError(f"window must be [{size}] float32 on {x.device}")
    if size < 1 or hop < 1:
        raise ValueError(f"size and hop must be >= 1, got {size}, {hop}")
    if not _on_card(x, "frame_window"):
        return frame_window_reference(x, window, size, hop)
    lanes, t = x.shape
    n_frames = _n_frames(t, size, hop)
    x, window = x.contiguous(), window.contiguous()
    out = torch.empty((lanes, n_frames, size), dtype=F32, device=x.device)
    if lanes == 0:
        return out
    with torch.cuda.device(x.device):
        err = _library().zorak_frame_window(
            x.data_ptr(), window.data_ptr(), out.data_ptr(), lanes, t, size,
            hop, n_frames, _stream(x))
    _launched("frame_window", err)
    return out


def _overlap_add(frames: torch.Tensor, size: int, hop: int) -> torch.Tensor:
    """[..., n_frames, size] -> [..., (n_frames-1)*hop + size].

    Output sample t sums the frames that cover it, starting from +0.0, in
    the reference's order: descending frames where hop divides size (its
    shifted slice-adds give output block j frame j first), ascending
    otherwise (its scatter).  The r-th step adds the r-th covering frame,
    where there is one."""
    n_frames = frames.shape[-2]
    total = (n_frames - 1) * hop + size
    t = torch.arange(total, device=frames.device)
    f_hi = torch.clamp(t // hop, max=n_frames - 1)
    f_lo = torch.where(t >= size, torch.div(t - size, hop,
                                            rounding_mode="floor") + 1, 0)
    flat = frames.reshape(frames.shape[:-2] + (-1,))
    acc = torch.zeros(frames.shape[:-2] + (total,), dtype=frames.dtype,
                      device=frames.device)
    for r in range(-(-size // hop)):
        f = f_hi - r if size % hop == 0 else f_lo + r
        ok = (f >= f_lo) & (f <= f_hi)
        idx = torch.where(ok, f * size + (t - f * hop), 0)
        acc = torch.where(ok, acc + flat[..., idx], acc)
    return acc


def overlap_add_norm_reference(frames: torch.Tensor, window: torch.Tensor,
                               inv_wsum: torch.Tensor, hop: int,
                               t_out: int) -> torch.Tensor:
    """Plain version of K7b: [lanes, frames, size] -> [lanes, t_out]."""
    size = frames.shape[-1]
    y = _overlap_add(frames * window, size, hop)
    return (y * inv_wsum)[..., :t_out]


def overlap_add_norm(frames: torch.Tensor, window: torch.Tensor,
                     inv_wsum: torch.Tensor, hop: int,
                     t_out: int) -> torch.Tensor:
    """K7b: the synthesis window, overlap-add, x inv_wsum, crop to t_out.

    frames [lanes, n_frames, size] f32 (the irFFT of each frame), window
    [size] f32, inv_wsum [(n_frames-1)*hop + size] f32 -> [lanes, t_out]
    f32.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    if frames.dim() != 3 or frames.dtype != F32:
        raise ValueError(f"frames must be [lanes, frames, size] float32, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    lanes, n_frames, size = frames.shape
    total = (n_frames - 1) * hop + size
    for name, v, n in (("window", window, size), ("inv_wsum", inv_wsum, total)):
        if tuple(v.shape) != (n,) or v.dtype != F32 \
                or v.device != frames.device:
            raise ValueError(f"{name} must be [{n}] float32 on "
                             f"{frames.device}")
    if hop < 1 or not 0 <= t_out <= total or n_frames < 1:
        raise ValueError(f"hop {hop}, t_out {t_out}, {n_frames} frames: "
                         f"need hop >= 1, a frame, 0 <= t_out <= {total}")
    if not _on_card(frames, "overlap_add_norm"):
        return overlap_add_norm_reference(frames, window, inv_wsum, hop, t_out)
    if lanes > 65535 or total >= 2 ** 30:
        raise ValueError("overlap_add_norm takes at most 65535 lanes and "
                         "2^30 samples")
    frames, window, inv_wsum = (v.contiguous()
                                for v in (frames, window, inv_wsum))
    y = torch.empty((lanes, t_out), dtype=F32, device=frames.device)
    if lanes == 0 or t_out == 0:
        return y
    with torch.cuda.device(frames.device):
        err = _library().zorak_overlap_add_norm(
            frames.data_ptr(), window.data_ptr(), inv_wsum.data_ptr(),
            y.data_ptr(), lanes, n_frames, size, hop, t_out,
            int(size % hop == 0), _stream(frames))
    _launched("overlap_add_norm", err)
    return y


# ---------------------------------------------------------------------------
# the pipeline

def stft(x: torch.Tensor, size: int = 2048, hop: Optional[int] = None,
         window=None):
    """x: [T] or [lanes, T] real -> (spec [..., frames, size//2+1]
    complex64, meta)."""
    hop = hop or size // 2
    # the window stays NumPy in meta: the normalisation is computed from
    # its values on the host
    if window is None:
        window = np.hanning(size).astype(np.float32)
    else:
        window = np.asarray(window, np.float32)
    xl = _as_lanes(x, "stft").to(F32)
    w = torch.from_numpy(window).to(xl.device)
    frames = frame_window(xl, w, size, hop)
    spec = torch.fft.rfft(frames, dim=-1)
    spec = spec.reshape(x.shape[:-1] + spec.shape[-2:])
    return spec, (size, hop, window, x.shape[-1])


def istft(spec: torch.Tensor, meta) -> torch.Tensor:
    size, hop, window, t_out = meta
    lead = spec.shape[:-2]
    frames = torch.fft.irfft(spec.to(C64).reshape((-1,) + spec.shape[-2:]),
                             size, dim=-1)
    n_frames = frames.shape[-2]
    inv = torch.from_numpy(
        _inv_wsum(window.tobytes(), n_frames, size, hop)).to(frames.device)
    w = torch.from_numpy(window).to(frames.device)
    y = overlap_add_norm(frames.contiguous(), w, inv, hop, t_out)
    return y.reshape(lead + (t_out,))


def stft_process(x: torch.Tensor, bin_fn: Callable, size: int = 2048,
                 hop: Optional[int] = None) -> torch.Tensor:
    """Spectral processing pipeline: stft -> bin_fn(spec) -> istft.

    bin_fn receives [..., frames, bins] complex64 and returns the same
    shape."""
    spec, meta = stft(x, size, hop)
    return istft(bin_fn(spec), meta)


# ---------------------------------------------------------------------------
# the spectral gate

def percentile(a: torch.Tensor, q: float, dim: int) -> torch.Tensor:
    """`jnp.percentile(a, q, axis=dim)` (linear rule) for f32 `a`: a sort
    along `dim`, the value at q/100 * (n-1) between its two neighbours,
    weights and sum in f64, rounded to f32; NaN wherever the slice holds
    one.  (`torch.quantile` refuses more than 2^24 elements.)"""
    n = a.shape[dim]
    pos = (q / 100.0) * (n - 1.0)
    lo_i = min(max(np.floor(pos), 0.0), n - 1.0)
    hi_i = min(max(np.ceil(pos), 0.0), n - 1.0)
    hw = pos - np.floor(pos)
    srt = torch.sort(a, dim=dim).values
    lo = srt.select(dim, int(lo_i)).to(torch.float64)
    hi = srt.select(dim, int(hi_i)).to(torch.float64)
    out = (lo * (1.0 - hw) + hi * hw).to(a.dtype)
    return torch.where(torch.isnan(a).any(dim), float("nan"), out)


def median(a: torch.Tensor) -> torch.Tensor:
    """`jnp.median` along the last axis of f32 `a`: the mean of the two
    middle values for an even count, (lo + hi) * 0.5 in f32 (not
    `torch.median`, which returns the lower); NaN where a holds one."""
    n = a.shape[-1]
    pos = 0.5 * (n - 1.0)
    srt = torch.sort(a, dim=-1).values
    lo = srt[..., int(np.floor(pos))]
    hi = srt[..., int(np.ceil(pos))]
    out = (lo + hi) * 0.5
    return torch.where(torch.isnan(a).any(-1), float("nan"), out)


def magnitude(spec: torch.Tensor) -> torch.Tensor:
    """|X| as sqrt(re*re + im*im), each step rounded in f32 (K7c's)."""
    re, im = spec.real, spec.imag
    return torch.sqrt(re * re + im * im)


def _gain_constants(floor_db: float):
    m = np.float32(10.0 ** (floor_db / 20.0))
    return float(m), float(np.float32(1.0) - m)


def gate_gain_reference(spec: torch.Tensor, thr: torch.Tensor,
                        floor_db: float) -> torch.Tensor:
    """Plain version of K7c: [lanes, frames, bins] complex64, thr [lanes]
    f32 -> the gated spectrum."""
    m, one_minus_m = _gain_constants(floor_db)
    th = torch.clamp_min(thr, 1e-12)[:, None, None]
    s = torch.clamp((magnitude(spec) / th - 1.0) / 2.0, 0.0, 1.0)
    g = m + one_minus_m * s * s * (3.0 - 2.0 * s)
    return torch.view_as_complex(torch.stack((spec.real * g, spec.imag * g),
                                             dim=-1))


def gate_gain(spec: torch.Tensor, thr: torch.Tensor,
              floor_db: float) -> torch.Tensor:
    """K7c: the soft-knee gain of `spectral_gate` applied to the spectrum.

    spec [lanes, frames, bins] complex64, thr [lanes] f32 (the threshold
    before its 1e-12 floor) -> complex64 of spec's shape.  CUDA tensors go
    to the kernel, CPU tensors to the plain version."""
    if spec.dim() != 3 or spec.dtype != C64:
        raise ValueError(f"spec must be [lanes, frames, bins] complex64, got "
                         f"{tuple(spec.shape)} {spec.dtype}")
    lanes = spec.shape[0]
    if tuple(thr.shape) != (lanes,) or thr.dtype != F32 \
            or thr.device != spec.device:
        raise ValueError(f"thr must be [{lanes}] float32 on {spec.device}")
    if not _on_card(spec, "gate_gain"):
        return gate_gain_reference(spec, thr, floor_db)
    if lanes > 65535:
        raise ValueError("gate_gain takes at most 65535 lanes")
    m, one_minus_m = _gain_constants(floor_db)
    spec, thr = spec.contiguous(), thr.contiguous()
    out = torch.empty_like(spec)
    per_lane = spec.shape[1] * spec.shape[2]
    with torch.cuda.device(spec.device):
        err = _library().zorak_gate_gain(
            spec.data_ptr(), thr.data_ptr(), m, one_minus_m, out.data_ptr(),
            lanes, per_lane, _stream(spec))
    _launched("gate_gain", err)
    return out


def spectral_gate(x: torch.Tensor, threshold_db: float = -50.0,
                  size: int = 2048, hop: Optional[int] = None,
                  floor_db: float = -24.0) -> torch.Tensor:
    """Reference-style restoration denoiser: per-bin gating against a
    noise floor with a soft knee (BASELINE config 3), each lane against
    its own noise estimate."""
    floor_thr = np.float32(10.0 ** (threshold_db / 20.0))

    def gate(spec):
        sl = spec.reshape((-1,) + spec.shape[-2:])
        # broadband noise estimate: the median across bins of each bin's
        # quiet-frame level
        per_bin_quiet = percentile(magnitude(sl), 10.0, dim=-2)
        noise_est = median(per_bin_quiet)
        thr = torch.clamp_min(noise_est, float(floor_thr)) * 4.0
        return gate_gain(sl, thr, floor_db).reshape(spec.shape)

    return stft_process(x, gate, size, hop)
