"""Batched switching one-pole (attack/release) scan: CUDA kernel + plain version.

Counterpart of zorak_tpu/kernels/pallas_scan.py.  The recurrence

    z[t] = x[t] + (z[t-1] - x[t]) * (up if x[t] > z[t-1] else dn)

is not associative (the pole depends on the state), yet it splits across
threads exactly: with both poles in (0, 1) the step contracts, so a
trajectory started from a guess some `warmup` steps early becomes
bit-identical to the true one, and stays so.  On a CUDA tensor
`switching_scan` launches the two kernels of `csrc/switching_scan.cu`
(f32 or f64): one speculates every chunk of `chunk` steps in parallel
after its warm-up, the other walks the chunks with the true carry and
re-runs a chunk from it, comparing bit patterns, wherever the guess had
not yet merged (one chunk is that walk alone, a thread per lane).  The
result is the sequential loop's bit for bit.  On a CPU tensor it runs
`switching_scan_reference`, the plain PyTorch loop with the same
arithmetic.  Nothing falls back from one to the other.
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

# Steps the fix-up kernel re-ran, one int64 tensor per CUDA device, added
# to on the device and never read back by the wrapper; chip_smoke.py
# zeroes them before a path and sums them after.
RERUN_STEPS: dict = {}

# Steps of a chunk, and warm-up steps before it.  On VAR's detector
# signal from seeded noise a trajectory started from a guess became
# bit-identical to the true one within 34,016 to 36,727 steps in f64 and
# 13,364 to 17,028 in f32 (scripts/switching_merge_length.py), so the
# warm-up covers that and the fix-up re-runs nothing there.  Where the
# detector does not merge within the warm-up (a decay in digital silence,
# RED's slowly falling gain target) the fix-up re-runs those chunks one
# after another.  A chunk adds its own steps to every thread's warm-up;
# scripts/switching_scan_sweep.py times the choices on the card.
CHUNK = 1024
WARMUP = {torch.float64: 49152, torch.float32: 32768}

_DTYPES = (torch.float32, torch.float64)
_MAX_LANES = 65535 * 32  # grid.y of the speculate kernel, 32 lanes a block


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("switching_scan")
    for fn in (lib.zorak_switching_scan_f32, lib.zorak_switching_scan_f64):
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p]
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


def chunk_plan(n_t: int, chunk: int, warmup: int):
    """(chunk, warmup, n_chunks) as the kernels run them for T = n_t.

    A chunk is at most T long, and the warm-up never reaches back before
    t = 0 for every chunk: chunk c starts at max(0, c*chunk - warmup),
    from z0 where that is 0 (an exact start).
    """
    chunk = min(chunk, n_t)
    n_chunks = -(-n_t // chunk)
    return chunk, min(warmup, (n_chunks - 1) * chunk), n_chunks


def _rerun_counter(device: torch.device) -> torch.Tensor:
    if device not in RERUN_STEPS:
        RERUN_STEPS[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return RERUN_STEPS[device]


def switching_scan(x: torch.Tensor, up: torch.Tensor, dn: torch.Tensor,
                   z0: torch.Tensor, *, chunk: int = CHUNK,
                   warmup: int | None = None) -> torch.Tensor:
    """x [T, lanes]; up/dn/z0 [lanes]; f32 or f64 -> y [T, lanes].

    CUDA tensors go to the kernels, CPU tensors to the plain version.
    `chunk` and `warmup` (default WARMUP[x.dtype]) shape the kernels'
    split of time and never change the result; chunk >= T is one chunk:
    a thread per lane walks all of T, with nothing speculated.
    """
    global LAUNCHES
    _check(x, up, dn, z0)
    if warmup is None:
        warmup = WARMUP[x.dtype]
    for name, v, least in (("chunk", chunk, 1), ("warmup", warmup, 0)):
        if isinstance(v, bool) or not isinstance(v, int) or v < least:
            raise ValueError(f"{name} must be an int >= {least}, got {v!r}")
    if x.device.type == "cpu":
        return switching_scan_reference(x, up, dn, z0)
    if x.device.type != "cuda":
        raise ValueError(f"switching_scan runs on cuda or cpu, not {x.device}")
    n_t, lanes = x.shape
    if lanes > _MAX_LANES:
        raise ValueError(f"switching_scan takes at most {_MAX_LANES} lanes")
    x, up, dn, z0 = (v.contiguous() for v in (x, up, dn, z0))
    y = torch.empty_like(x)
    if n_t == 0 or lanes == 0:
        return y
    chunk, warmup, n_chunks = chunk_plan(n_t, chunk, warmup)
    ws = torch.empty((n_chunks, lanes, 2), dtype=x.dtype, device=x.device)
    reruns = _rerun_counter(x.device)
    lib = _library()
    fn = (lib.zorak_switching_scan_f64 if x.dtype == torch.float64
          else lib.zorak_switching_scan_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), up.data_ptr(), dn.data_ptr(), z0.data_ptr(),
                 y.data_ptr(), ws.data_ptr(), reruns.data_ptr(), n_t, lanes,
                 chunk, warmup, stream)
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
    memory traffic, its time per step is the floor under one thread's
    steps, so (warmup + chunk) of them bound the chunked scan.  Not a
    kernel of any path, so it leaves LAUNCHES alone.
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
