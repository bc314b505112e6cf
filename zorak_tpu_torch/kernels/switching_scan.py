"""Batched switching one-pole (attack/release) scan: CUDA kernel + plain version.

Counterpart of zorak_tpu/kernels/pallas_scan.py.  The recurrence

    z[t] = x[t] + (z[t-1] - x[t]) * (up if x[t] > z[t-1] else dn)

is not associative (the pole depends on the state), so it runs as one
sequential loop per lane.  On a CUDA tensor `switching_scan` launches the
hand-written kernel `csrc/switching_scan.cu` (f32 or f64) or raises; on a
CPU tensor it runs `switching_scan_reference`, the plain PyTorch loop
with the same arithmetic.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0

_DTYPES = (torch.float32, torch.float64)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("switching_scan")
    for fn in (lib.zorak_switching_scan_f32, lib.zorak_switching_scan_f64):
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.zorak_switching_chain_f32, lib.zorak_switching_chain_f64):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, up, dn, z0) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [T, lanes], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    lanes = x.shape[1]
    for name, v in (("up", up), ("dn", dn), ("z0", z0)):
        if v.shape != (lanes,):
            raise ValueError(f"{name} must be [{lanes}], got {tuple(v.shape)}")
        if v.dtype != x.dtype or v.device != x.device:
            raise ValueError(f"{name} must be {x.dtype} on {x.device}, "
                             f"got {v.dtype} on {v.device}")


def switching_scan_reference(x: torch.Tensor, up: torch.Tensor,
                             dn: torch.Tensor, z0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a time loop over [lanes] vectors."""
    _check(x, up, dn, z0)
    y = torch.empty_like(x)
    z = z0
    for t in range(x.shape[0]):
        xt = x[t]
        pole = torch.where(xt > z, up, dn)
        z = xt + (z - xt) * pole
        y[t] = z
    return y


def switching_scan(x: torch.Tensor, up: torch.Tensor, dn: torch.Tensor,
                   z0: torch.Tensor) -> torch.Tensor:
    """x [T, lanes]; up/dn/z0 [lanes]; f32 or f64 -> y [T, lanes].

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    """
    global LAUNCHES
    _check(x, up, dn, z0)
    if x.device.type == "cpu":
        return switching_scan_reference(x, up, dn, z0)
    if x.device.type != "cuda":
        raise ValueError(f"switching_scan runs on cuda or cpu, not {x.device}")
    x, up, dn, z0 = (v.contiguous() for v in (x, up, dn, z0))
    y = torch.empty_like(x)
    n_t, lanes = x.shape
    if n_t == 0 or lanes == 0:
        return y
    lib = _library()
    fn = (lib.zorak_switching_scan_f64 if x.dtype == torch.float64
          else lib.zorak_switching_scan_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), up.data_ptr(), dn.data_ptr(), z0.data_ptr(),
                 y.data_ptr(), n_t, lanes, stream)
    if err != 0:
        raise RuntimeError(f"switching_scan kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return y


CHAIN_CHUNK = 32  # kUnroll of csrc/switching_scan.cu


def switching_chain_probe(x: torch.Tensor, up: torch.Tensor, dn: torch.Tensor,
                          z0: torch.Tensor, n_t: int) -> torch.Tensor:
    """Timing probe of the scan's dependent chain (used by chip_smoke.py).

    One CUDA thread runs n_t // CHAIN_CHUNK * CHAIN_CHUNK steps of the
    recurrence with x cycling through the CHAIN_CHUNK values of `x`, held
    in registers, and returns the last state as a [1] tensor.  With no
    memory traffic, its time per step is the floor under the scan with one
    lane.  Not a kernel of any path, so it leaves LAUNCHES alone.
    """
    _check(x.reshape(CHAIN_CHUNK, 1), up, dn, z0)
    if x.device.type != "cuda" or up.shape != (1,):
        raise ValueError("the chain probe takes one lane of CUDA tensors")
    lib = _library()
    fn = (lib.zorak_switching_chain_f64 if x.dtype == torch.float64
          else lib.zorak_switching_chain_f32)
    z = torch.empty_like(z0)
    x, up, dn, z0 = (v.contiguous() for v in (x, up, dn, z0))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), up.data_ptr(), dn.data_ptr(), z0.data_ptr(),
                 z.data_ptr(), n_t, stream)
    if err != 0:
        raise RuntimeError(f"switching_chain_probe launch failed: "
                           f"cudaError {err}")
    return z


def switching_onepole(x: torch.Tensor, up_pole, dn_pole,
                      z0=0.0) -> torch.Tensor:
    """dspkit layout: x [..., T] (time last) -> y [..., T].

    The leading dims flatten into lanes; poles and z0 broadcast to them.
    """
    lead, n_t = x.shape[:-1], x.shape[-1]
    lanes = math.prod(lead)

    def per_lane(v):
        v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        return v.broadcast_to(lead).reshape(lanes).contiguous()

    xl = x.reshape(lanes, n_t).T.contiguous()
    y = switching_scan(xl, per_lane(up_pole), per_lane(dn_pole), per_lane(z0))
    return y.T.reshape(x.shape)
