"""Convolution: direct FIR and partitioned FFT convolution for long impulse
responses, with the partition MAC as a CUDA kernel.

Counterpart of zorak_tpu/kernels/convolution.py.  `fir_conv` is the f64
`conv1d` of `models/dspkit.py` `fir` (the reference uses an XLA
convolution there, not a Pallas kernel).  `partitioned_convolve` is
uniform partitioned overlap-save in f32/complex64, as the reference: the
IR cut into partitions of `part_size` and transformed once, the input
framed with one leading history block and transformed by
`torch.fft.rfft` (cuFFT on the card), then every output frame
accumulates X[f-p] * H[p] over the partitions (K8 `partition_mac`,
`csrc/partition_mac.cu`), then `irfft` and the overlap-save crop.

`partition_mac` launches the kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor: a loop over partitions on the real and
imaginary parts, each multiply and add rounded on its own, in the same
order (partitions ascending, the zero history rows added too), so the two
are equal bit for bit.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0

F32 = torch.float32
C64 = torch.complex64


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("partition_mac")
    lib.zorak_partition_mac.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.zorak_partition_mac.restype = ctypes.c_int
    return lib


def fir_conv(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal direct FIR: y[t] = sum_k taps[k] x[t-k], in f64.

    x: [..., T]; taps: [K].  Right choice for K up to a few thousand."""
    from ..models.dspkit import fir  # models import this package

    return fir(x.to(torch.float64), taps)


def partition_mac_reference(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: x [lanes, frames, bins], h [parts, bins]
    complex64 -> y [lanes, frames, bins], y[f] = sum_p x[f-p] * h[p]."""
    parts = h.shape[0]
    n_frames = x.shape[1]
    xr = torch.nn.functional.pad(x.real, (0, 0, parts - 1, 0))
    xi = torch.nn.functional.pad(x.imag, (0, 0, parts - 1, 0))
    yr = torch.zeros(x.shape, dtype=F32, device=x.device)
    yi = torch.zeros(x.shape, dtype=F32, device=x.device)
    for p in range(parts):
        sr = xr[:, parts - 1 - p:parts - 1 - p + n_frames]
        si = xi[:, parts - 1 - p:parts - 1 - p + n_frames]
        hr, hi = h[p].real, h[p].imag
        yr = yr + (sr * hr - si * hi)
        yi = yi + (sr * hi + si * hr)
    return torch.complex(yr, yi)


def partition_mac(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """K8: y[l, f, b] = sum over partitions p (ascending) of
    x[l, f-p, b] * h[p, b], with x[l, g] = 0 for g < 0.

    x [lanes, frames, bins] complex64, h [parts, bins] complex64 on x's
    device.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    global LAUNCHES
    if x.dim() != 3 or x.dtype != C64:
        raise ValueError(f"x must be [lanes, frames, bins] complex64, got "
                         f"{tuple(x.shape)} {x.dtype}")
    lanes, n_frames, bins = x.shape
    if h.dim() != 2 or h.shape[1] != bins or h.shape[0] < 1 \
            or h.dtype != C64 or h.device != x.device:
        raise ValueError(f"h must be [parts >= 1, {bins}] complex64 on "
                         f"{x.device}, got {tuple(h.shape)} {h.dtype} on "
                         f"{h.device}")
    if x.device.type == "cpu":
        return partition_mac_reference(x, h)
    if x.device.type != "cuda":
        raise ValueError(f"partition_mac runs on cuda or cpu, not {x.device}")
    if lanes > 65535 or n_frames >= 2 ** 31 or bins >= 2 ** 31:
        raise ValueError("partition_mac takes at most 65535 lanes and 2^31 "
                         "frames and bins")
    x, h = x.contiguous(), h.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().zorak_partition_mac(
            x.data_ptr(), h.data_ptr(), y.data_ptr(), lanes, n_frames, bins,
            h.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"partition_mac kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return y


def ir_spectra(ir: torch.Tensor, part_size: int) -> torch.Tensor:
    """The IR cut into partitions of part_size and each transformed at
    2 x part_size: [parts, part_size + 1] complex64."""
    b = part_size
    ir = ir.to(F32)
    k = ir.shape[-1]
    n_parts = max(1, -(-k // b))
    ir_p = torch.nn.functional.pad(ir, (0, n_parts * b - k)).reshape(n_parts, b)
    return torch.fft.rfft(ir_p, 2 * b, dim=-1)


def partitioned_convolve(x: torch.Tensor, ir, part_size: int = 2048
                         ) -> torch.Tensor:
    """Uniform partitioned convolution (overlap-save per partition).

    x: [T] or [lanes, T] input; ir: [K] impulse response, the same for
    every lane.  Output of x's shape (causal, truncated like a realtime
    convolver), f32.  part_size must be a power of 2."""
    if x.dim() not in (1, 2):
        raise ValueError(f"partitioned_convolve takes [T] or [lanes, T], got "
                         f"shape {tuple(x.shape)}")
    b = part_size
    xl = x.reshape(-1, x.shape[-1]).to(F32)
    t = xl.shape[-1]
    if t == 0:
        return xl.reshape(x.shape)
    h = ir_spectra(torch.as_tensor(ir, device=xl.device), b)
    n_frames = -(-t // b)
    # frame f covers input samples [f*B - B, f*B + B) (overlap-save)
    xp = torch.nn.functional.pad(xl, (b, n_frames * b - t))
    spec = torch.fft.rfft(xp.unfold(-1, 2 * b, b), dim=-1)
    y_spec = partition_mac(spec, h)
    del spec
    y = torch.fft.irfft(y_spec, 2 * b, dim=-1)[..., b:]
    return y.reshape(xl.shape[0], -1)[:, :t].reshape(x.shape)
