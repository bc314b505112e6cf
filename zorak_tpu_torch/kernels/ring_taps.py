"""Sum of constant-gain ring-buffer taps: CUDA kernel + plain version.

Counterpart of the tap reads of zorak_tpu/lowering/specialize.py
(`ring_hist_full`, `ring_delayed`) and the multiply-add chain that
consumes them.  With `buf` a ring region in write order,
`[history | this segment's write stream]`, and `starts[k] = mod -
delay[k]` a tap's static offset into it,

    acc = init;  for k in order:  acc = acc + gains[k] * buf[starts[k] : starts[k] + L]

in f64, multiply and add as two roundings a tap.  On a CUDA tensor
`ring_tap_sum` launches the kernel of `csrc/ring_taps.cu`, one thread a
sample; on a CPU tensor it runs `ring_tap_sum_reference`, the same fold
over tensor slices.  Both keep the chain's order, so both equal the
node-by-node emission bit for bit.  Nothing falls back from one to the
other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("ring_taps")
    lib.zorak_ring_tap_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p]
    lib.zorak_ring_tap_sum.restype = ctypes.c_int
    return lib


def _check(buf, starts, gains, init, length) -> int:
    """Validates the arguments; returns L."""
    if buf.dim() != 1 or buf.dtype != torch.float64:
        raise ValueError("buf must be a 1-d float64 tensor")
    if starts.dim() != 1 or starts.dtype != torch.int64:
        raise ValueError("starts must be a 1-d int64 tensor")
    if gains.shape != starts.shape or gains.dtype != torch.float64:
        raise ValueError(f"gains must be float64 {tuple(starts.shape)}")
    tensors = [("starts", starts), ("gains", gains)]
    if isinstance(init, torch.Tensor):
        if init.dim() != 1 or init.dtype != torch.float64:
            raise ValueError("init must be a float or a 1-d float64 tensor")
        if length is None:
            length = init.shape[0]
        if init.shape[0] != length:
            raise ValueError(f"init has {init.shape[0]} samples, not {length}")
        tensors.append(("init", init))
    elif length is None:
        raise ValueError("a scalar init needs `length`")
    for name, v in tensors:
        if v.device != buf.device:
            raise ValueError(f"{name} is on {v.device}, buf on {buf.device}")
    if length < 0 or length > buf.shape[0]:
        raise ValueError(f"length {length} does not fit a buffer of "
                         f"{buf.shape[0]} samples")
    return int(length)


def ring_tap_sum_reference(buf: torch.Tensor, starts: torch.Tensor,
                           gains: torch.Tensor, init,
                           length: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: one multiply and one add a tap, on slices."""
    n = _check(buf, starts, gains, init, length)
    acc = init if isinstance(init, torch.Tensor) else torch.full(
        (n,), float(init), dtype=torch.float64, device=buf.device)
    for s, g in zip(starts.tolist(), gains.tolist()):
        if s < 0 or s + n > buf.shape[0]:
            raise ValueError(f"tap window [{s}, {s + n}) lies outside the "
                             f"buffer of {buf.shape[0]} samples")
        acc = acc + g * buf[s:s + n]
    return acc


def ring_tap_sum(buf: torch.Tensor, starts: torch.Tensor, gains: torch.Tensor,
                 init, length: int | None = None) -> torch.Tensor:
    """buf [M] f64; starts [K] i64; gains [K] f64; init a float or [L] f64
    -> acc [L], with L = `length` (default: init's).

    CUDA tensors go to the kernel, CPU tensors to the plain version.  Every
    tap window [starts[k], starts[k] + L) must lie inside buf: the plain
    version raises otherwise, and the kernel, which does not read the
    offsets back to the host, gives NaN for that tap.
    """
    global LAUNCHES
    n = _check(buf, starts, gains, init, length)
    if buf.device.type == "cpu":
        return ring_tap_sum_reference(buf, starts, gains, init, n)
    if buf.device.type != "cuda":
        raise ValueError(f"ring_tap_sum runs on cuda or cpu, not {buf.device}")
    buf, starts, gains = (v.contiguous() for v in (buf, starts, gains))
    out = torch.empty((n,), dtype=torch.float64, device=buf.device)
    if n == 0:
        return out
    if isinstance(init, torch.Tensor):
        init = init.contiguous()
        init_ptr, init_scalar = init.data_ptr(), 0.0
    else:
        init_ptr, init_scalar = None, float(init)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = _library().zorak_ring_tap_sum(
            buf.data_ptr(), buf.shape[0], starts.data_ptr(), gains.data_ptr(),
            starts.shape[0], init_ptr, init_scalar, out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"ring_tap_sum kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
