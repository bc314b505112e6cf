"""Batched first-order linear recurrences: CUDA kernel + plain versions.

Counterpart of the three doubling-scan solvers of
zorak_tpu/lowering/eelmath.py.  Row r solves

    z[r, t] = a[r, t] * z[r, t-1] + b[r, t],    z[r, -1] = z0[r]

in f64, with `a` one value per row or one per sample.  On a CUDA tensor
`linrec_scan` launches the chunked affine scan of `csrc/linrec_scan.cu`:
each row is cut into chunks of `chunk` samples, each chunk composes its
map z -> A*z + B, one thread a row carries z0 across the maps (walking a
chunk sample by sample wherever the map could overflow or meets a value
that is not finite), and each chunk walks its samples again from its start
carry.  `linrec_chunked` is the same order in NumPy, and the kernel equals
it bit for bit.  Against `linrec_sequential`, the golden's order, it is
within `TOL_REL` x max|z| (exact where every value is an integer below
2^53, NaN and inf in the same places).  On a CPU tensor `linrec_scan` runs
`linrec_scan_reference`, the doubling-order solvers of
`lowering/eelmath.py` in plain PyTorch; the orders differ by rounding only.
Nothing falls back from one to the other.
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

# Samples of a chunk.  A row of L samples costs the card about 2 x CHUNK
# dependent steps (compose, then apply) plus L / CHUNK steps of the carry
# pass; at the engine's segment length of 131,072 chunks of 128 read best
# on an H100 (`chip_smoke.py` prints the time by chunk).  Never changes
# the result's tolerance, only its rounding.
CHUNK = 128

# The stated tolerance against `linrec_sequential` and against the
# doubling ladders: relative to the largest finite |z| of the case.
TOL_REL = 1e-9

# |z| * M + N at most this and the composed step cannot overflow (kSafe).
_SAFE = 2.0 ** 1000


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("linrec_scan")
    lib.zorak_linrec_scan.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
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
    side: the sequential golden's order, which the kernel's chunk 0
    keeps."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    z = np.array(z0, dtype=np.float64)
    out = np.empty_like(b)
    with np.errstate(all="ignore"):
        for t in range(b.shape[1]):
            z = (a if a.ndim == 1 else a[:, t]) * z + b[:, t]
            out[:, t] = z
    return out


def linrec_chunked(a: np.ndarray, b: np.ndarray, z0: np.ndarray,
                   chunk: int = CHUNK) -> np.ndarray:
    """NumPy mirror of the kernel's order, bit for bit: compose each
    chunk's map (A <- a*A, B <- a*B + b, M and N the largest |A| and |B|
    along it, M = inf where A or B is not finite), carry z0 across the
    maps in order (sample by sample where |z|*M + N <= 2^1000 fails: A,
    B or z not finite, or a sample that might overflow; a NaN carry stays
    as it is), then walk each chunk from its start carry.  Every multiply
    and add rounds on its own."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    k, n = b.shape
    out = np.empty_like(b)
    if k == 0 or n == 0:
        return out
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    pad = ((0, 0), (0, n_chunks * chunk - n))
    bp = np.pad(b, pad).reshape(k, n_chunks, chunk)
    ap = (np.broadcast_to(a[:, None, None], bp.shape) if a.ndim == 1
          else np.pad(a, pad).reshape(k, n_chunks, chunk))
    zs = np.empty((k, n_chunks))
    zs[:, 0] = z0
    with np.errstate(all="ignore"):
        m = n_chunks - 1                  # the last chunk's map is not used
        A, B = np.ones((k, m)), np.zeros((k, m))
        M, N = np.zeros((k, m)), np.zeros((k, m))
        for i in range(chunk):
            A = ap[:, :m, i] * A
            B = ap[:, :m, i] * B + bp[:, :m, i]
            M = np.fmax(M, np.abs(A))
            N = np.fmax(N, np.abs(B))
        M[~(np.isfinite(A) & np.isfinite(B))] = np.inf
        z = np.array(z0, dtype=np.float64)
        for c in range(m):
            ok = np.abs(z) * M[:, c] + N[:, c] <= _SAFE
            walked = z.copy()
            for r in np.flatnonzero(~ok & ~np.isnan(z)):
                for i in range(chunk):
                    walked[r] = ap[r, c, i] * walked[r] + bp[r, c, i]
            z = np.where(ok, A[:, c] * z + B[:, c], walked)
            zs[:, c + 1] = z
        z = zs
        op = np.empty_like(bp)
        for i in range(chunk):
            z = ap[:, :, i] * z + bp[:, :, i]
            op[:, :, i] = z
    return op.reshape(k, n_chunks * chunk)[:, :n]


def linrec_scan(a: torch.Tensor, b: torch.Tensor, z0: torch.Tensor, *,
                chunk: int = CHUNK) -> torch.Tensor:
    """a [k] or [k, L]; b [k, L]; z0 [k]; f64 -> z [k, L].

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    `chunk` is the kernel's chunk length (it changes the rounding, not
    the tolerance); chunk >= L is one chunk, the sequential walk.
    """
    global LAUNCHES
    _check(a, b, z0)
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be an int >= 1, got {chunk!r}")
    if b.device.type == "cpu":
        return linrec_scan_reference(a, b, z0)
    if b.device.type != "cuda":
        raise ValueError(f"linrec_scan runs on cuda or cpu, not {b.device}")
    k, n = b.shape
    if k > 65535:
        raise ValueError("linrec_scan takes at most 65535 rows")
    a, b, z0 = (v.contiguous() for v in (a, b, z0))
    y = torch.empty_like(b)
    if k == 0 or n == 0:
        return y
    chunk = min(chunk, n)
    ws = torch.empty(5 * k * -(-n // chunk), dtype=torch.float64,
                     device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = _library().zorak_linrec_scan(
            a.data_ptr(), b.data_ptr(), z0.data_ptr(), y.data_ptr(),
            ws.data_ptr(), k, n, chunk, int(a.dim() == 2), stream)
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
    time per step is the floor under a row walked by one thread, and
    CHUNK of its steps the floor under a chunk's walk.  Not a kernel of
    any path, so it leaves LAUNCHES alone.
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
