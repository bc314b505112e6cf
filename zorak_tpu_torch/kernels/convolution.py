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
`csrc/partition_mac.cu`, which also multiplies by irfft's 1/N: N is a
power of two, so the product is exact and the inverse transform runs
unscaled), then `irfft` and the overlap-save crop.

`partition_mac` launches the kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor: a loop over partitions on the real and
imaginary parts, each multiply and add rounded on its own, in the same
order (partitions ascending, the zero history rows added too), so the two
are equal bit for bit.  Nothing falls back from one to the other.
`partition_mac_host` runs the kernel's walk compiled for the CPU, for
tests.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0

F32 = torch.float32
C64 = torch.complex64

# (frames a thread, warps a block, partitions a group) of the kernel's
# builds, csrc/partition_mac.cu PM_DEVICE_TILES; the first is the default
TILES: Tuple[Tuple[int, int, int], ...] = (
    (16, 8, 64), (16, 4, 64), (32, 4, 64), (32, 2, 64))
# the host form has a small walk too, which crosses tiles and groups at
# the tests' sizes
HOST_TILES = TILES + ((4, 2, 8),)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("partition_mac")
    lib.zorak_partition_mac.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.zorak_partition_mac.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _host_library() -> ctypes.CDLL:
    lib = _build.load_host("partition_mac")
    lib.zorak_partition_mac_host.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3
    lib.zorak_partition_mac_host.restype = ctypes.c_int
    return lib


def fir_conv(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal direct FIR: y[t] = sum_k taps[k] x[t-k], in f64.

    x: [..., T]; taps: [K].  Right choice for K up to a few thousand."""
    from ..models.dspkit import fir  # models import this package

    return fir(x.to(torch.float64), taps)


def partition_mac_reference(x: torch.Tensor, h: torch.Tensor,
                            scale: float = 1.0) -> torch.Tensor:
    """Plain version of K8: x [lanes, frames, bins], h [parts, bins]
    complex64 -> y [lanes, frames, bins], y[f] = scale * sum_p x[f-p] *
    h[p]."""
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
    return torch.complex(yr * scale, yi * scale)


def _checked(x: torch.Tensor, h: torch.Tensor, scale: float,
             tile: Optional[Tuple[int, int, int]],
             tiles: Tuple[Tuple[int, int, int], ...]
             ) -> Tuple[float, Tuple[int, int, int]]:
    """Refuse what the kernel does not take; return (scale, tile)."""
    if x.dim() != 3 or x.dtype != C64:
        raise ValueError(f"x must be [lanes, frames, bins] complex64, got "
                         f"{tuple(x.shape)} {x.dtype}")
    bins = x.shape[2]
    if h.dim() != 2 or h.shape[1] != bins or h.shape[0] < 1 \
            or h.dtype != C64 or h.device != x.device:
        raise ValueError(f"h must be [parts >= 1, {bins}] complex64 on "
                         f"{x.device}, got {tuple(h.shape)} {h.dtype} on "
                         f"{h.device}")
    scale = float(scale)
    mant, exp = math.frexp(scale)
    if mant != 0.5 or not -125 <= exp <= 128:
        raise ValueError(f"scale must be a power of two in f32's normal "
                         f"range (2^-126 .. 2^127), got {scale!r}")
    tile = tiles[0] if tile is None else tuple(tile)
    if tile not in tiles:
        raise ValueError(f"tile must be one of {tiles}, got {tile}")
    return scale, tile


def partition_mac(x: torch.Tensor, h: torch.Tensor, scale: float = 1.0,
                  tile: Optional[Tuple[int, int, int]] = None
                  ) -> torch.Tensor:
    """K8: y[l, f, b] = scale * the sum over partitions p (ascending) of
    x[l, f-p, b] * h[p, b], with x[l, g] = 0 for g < 0.

    x [lanes, frames, bins] complex64, h [parts, bins] complex64 on x's
    device; scale a power of two (the product is exact).  CUDA tensors go
    to the kernel, CPU tensors to the plain version.  `tile` picks one of
    the kernel's builds (TILES; the first by default): every one gives the
    same bits."""
    global LAUNCHES
    scale, tile = _checked(x, h, scale, tile, TILES)
    lanes, n_frames, bins = x.shape
    if x.device.type == "cpu":
        return partition_mac_reference(x, h, scale)
    if x.device.type != "cuda":
        raise ValueError(f"partition_mac runs on cuda or cpu, not {x.device}")
    if lanes > 65535 or n_frames >= 2 ** 31 or bins >= 2 ** 31 \
            or -(-n_frames // (tile[0] * tile[1])) > 65535:
        raise ValueError(f"partition_mac takes at most 65535 lanes, 65535 "
                         f"tiles of {tile[0] * tile[1]} frames and 2^31 "
                         f"bins")
    x, h = x.contiguous(), h.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().zorak_partition_mac(
            x.data_ptr(), h.data_ptr(), y.data_ptr(), lanes, n_frames, bins,
            h.shape[0], scale, *tile, stream)
    if err != 0:
        raise RuntimeError(f"partition_mac kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return y


def partition_mac_host(x: torch.Tensor, h: torch.Tensor, scale: float = 1.0,
                       tile: Optional[Tuple[int, int, int]] = None
                       ) -> torch.Tensor:
    """K8's walk compiled for the CPU (partition_mac.cu's host form, built
    with a host C++ compiler): the kernel's blocks, stages and threads one
    after another, on CPU tensors.  For tests where there is no GPU; it
    leaves LAUNCHES alone.  `tile` is one of HOST_TILES."""
    scale, tile = _checked(x, h, scale, tile, HOST_TILES)
    if x.device.type != "cpu":
        raise ValueError("partition_mac_host takes CPU tensors")
    xn = np.ascontiguousarray(x.numpy())
    hn = np.ascontiguousarray(h.numpy())
    y = np.empty_like(xn)
    if y.size:
        err = _host_library().zorak_partition_mac_host(
            xn.ctypes.data, hn.ctypes.data, y.ctypes.data, *x.shape,
            h.shape[0], scale, *tile)
        if err != 0:
            raise RuntimeError(f"partition_mac_host: no walk for tile {tile}")
    return torch.from_numpy(y)


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
    if b < 1 or b & (b - 1):
        raise ValueError(f"part_size must be a power of 2, got {b}")
    xl = x.reshape(-1, x.shape[-1]).to(F32)
    t = xl.shape[-1]
    if t == 0:
        return xl.reshape(x.shape)
    h = ir_spectra(torch.as_tensor(ir, device=xl.device), b)
    spec = input_spectra(xl, b)
    # irfft's 1/N at K8's store: N = 2B is a power of two, so the product
    # commutes with every rounding of the inverse transform, which then
    # runs unscaled (one pass over the spectrum fewer)
    y_spec = partition_mac(spec, h, scale=1.0 / (2 * b))
    del spec
    y = torch.fft.irfft(y_spec, 2 * b, dim=-1, norm="forward")
    return overlap_save_crop(y, t).reshape(x.shape)


def input_spectra(xl: torch.Tensor, part_size: int) -> torch.Tensor:
    """The overlap-save frames' spectra of xl [lanes, T] f32: frame f
    covers input samples [f*B - B, f*B + B), B = part_size, zeros outside
    the input; [lanes, ceil(T / B), B + 1] complex64."""
    b = part_size
    t = xl.shape[-1]
    n_frames = -(-t // b)
    xp = torch.nn.functional.pad(xl, (b, n_frames * b - t))
    return torch.fft.rfft(xp.unfold(-1, 2 * b, b), dim=-1)


def overlap_save_crop(frames: torch.Tensor, t: int) -> torch.Tensor:
    """The valid second half of each inverse-transformed frame [lanes,
    frames, 2B], joined and cut to t samples: [lanes, t]."""
    b = frames.shape[-1] // 2
    return frames[..., b:].reshape(frames.shape[0], -1)[:, :t]
