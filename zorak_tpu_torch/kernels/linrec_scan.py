"""Batched first-order linear recurrences: CUDA kernel + plain versions.

Counterpart of the three doubling-scan solvers of
zorak_tpu/lowering/eelmath.py.  Row r solves

    z[r, t] = a[r, t] * z[r, t-1] + b[r, t],    z[r, -1] = z0[r]

in f64, with `a` one value per row or one per sample.  On a CUDA tensor
`linrec_scan` launches the kernel of `csrc/linrec_scan.cu`: a block per
row, one thread of which walks time in the sequential order, multiply
and add as two roundings, while the others copy, so its result equals
`linrec_sequential` bit for bit.  On a
CPU tensor it runs `linrec_scan_reference`, the doubling-order solvers
of `lowering/eelmath.py` in plain PyTorch; the two orders differ by
rounding only.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0

CHAIN_CHUNK = 32  # kChain of csrc/linrec_scan.cu


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("linrec_scan")
    lib.zorak_linrec_scan.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.zorak_linrec_scan.restype = ctypes.c_int
    lib.zorak_linrec_chain.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.zorak_linrec_chain.restype = ctypes.c_int
    return lib


def _check(a, b, z0) -> None:
    if b.dim() != 2:
        raise ValueError(f"b must be [k, L], got shape {tuple(b.shape)}")
    k = b.shape[0]
    if tuple(a.shape) not in ((k,), tuple(b.shape)):
        raise ValueError(f"a must be [{k}] or {tuple(b.shape)}, got "
                         f"{tuple(a.shape)}")
    if tuple(z0.shape) != (k,):
        raise ValueError(f"z0 must be [{k}], got {tuple(z0.shape)}")
    for name, v in (("a", a), ("b", b), ("z0", z0)):
        if v.dtype != torch.float64 or v.device != b.device:
            raise ValueError(f"{name} must be float64 on {b.device}, got "
                             f"{v.dtype} on {v.device}")


def linrec_scan_reference(a: torch.Tensor, b: torch.Tensor,
                          z0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the reference's doubling ladders."""
    from ..lowering import eelmath as EM

    _check(a, b, z0)
    if a.dim() == 1:
        return EM.linrec_doubling_scalar_batch(a, b, z0)
    return EM.linrec_doubling_vector_batch(a, b, z0)


def linrec_sequential(a: np.ndarray, b: np.ndarray,
                      z0: np.ndarray) -> np.ndarray:
    """NumPy time loop, `z = a * z + b` in two roundings, rows side by
    side: the order the kernel keeps (and the sequential golden's)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    z = np.array(z0, dtype=np.float64)
    out = np.empty_like(b)
    with np.errstate(all="ignore"):
        for t in range(b.shape[1]):
            z = (a if a.ndim == 1 else a[:, t]) * z + b[:, t]
            out[:, t] = z
    return out


def linrec_scan(a: torch.Tensor, b: torch.Tensor,
                z0: torch.Tensor) -> torch.Tensor:
    """a [k] or [k, L]; b [k, L]; z0 [k]; f64 -> z [k, L].

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    """
    global LAUNCHES
    _check(a, b, z0)
    if b.device.type == "cpu":
        return linrec_scan_reference(a, b, z0)
    if b.device.type != "cuda":
        raise ValueError(f"linrec_scan runs on cuda or cpu, not {b.device}")
    k, n = b.shape
    a, b, z0 = (v.contiguous() for v in (a, b, z0))
    y = torch.empty_like(b)
    if k == 0 or n == 0:
        return y
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = _library().zorak_linrec_scan(
            a.data_ptr(), b.data_ptr(), z0.data_ptr(), y.data_ptr(), k, n,
            int(a.dim() == 2), stream)
    if err != 0:
        raise RuntimeError(f"linrec_scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return y


def linrec_chain_probe(a: torch.Tensor, b: torch.Tensor, z0: torch.Tensor,
                       n_t: int) -> torch.Tensor:
    """Timing probe of the recurrence's dependent chain (for chip_smoke.py).

    One CUDA thread runs n_t // CHAIN_CHUNK * CHAIN_CHUNK steps with a and
    b cycling through their CHAIN_CHUNK values, held in registers, and
    returns the last state as a [1] tensor.  With no memory traffic its
    time per step is the floor under one row's steps.  Not a kernel of any
    path, so it leaves LAUNCHES alone.
    """
    for name, v, n in (("a", a, CHAIN_CHUNK), ("b", b, CHAIN_CHUNK),
                       ("z0", z0, 1)):
        if v.shape != (n,) or v.dtype != torch.float64 \
                or v.device.type != "cuda":
            raise ValueError(f"{name} must be [{n}] float64 on cuda")
    a, b, z0 = (v.contiguous() for v in (a, b, z0))
    z = torch.empty_like(z0)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = _library().zorak_linrec_chain(
            a.data_ptr(), b.data_ptr(), z0.data_ptr(), z.data_ptr(), n_t,
            stream)
    if err != 0:
        raise RuntimeError(f"linrec_chain_probe launch failed: cudaError {err}")
    return z
