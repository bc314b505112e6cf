"""Sequential scan groups: a generated CUDA kernel + the plain Python loop.

Counterpart of the `lax.scan` that the reference solves a DAG level of
scan groups with (zorak_tpu/lowering/specialize.py, `solve_scan_group`):
carries c [n] (f64), external streams xs [L, n_ext] (f64), a body that is
a small DAG of EEL2 operations over carries, externals and constants;
ys [L, n] out, c <- ys[t] each sample.  A state-dependent recurrence (an
attack/release envelope, a peak hold, a nonlinear feedback, a mutually
recursive pair) has no closed form, so time is walked in order.

The body differs from plugin to plugin, so the kernel's text is generated
from the level's step list (`lowering/scan_codegen.py`), compiled with
nvcc at first use and kept by its text (`_build.load_generated`).  On a
CUDA tensor `scan_group` launches that kernel: a block of one thread for
each independent component of the level, which walks the L samples with
its carries and the step values in registers.  On a CPU tensor it runs
`scan_group_plain`, the per-sample Python loop in the scalar EEL2
semantics, which the generated body repeats bit for bit wherever it calls
no transcendental (those go to the device's libm, 1 to 2 ulp from
glibc's).  Nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from . import _build
from ..lowering import scan_codegen as CG

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0


class ScanGroupProgram:
    """One level's step list with its generated source; made once for a
    kernel's life, so that no segment prints the text again.  `unroll` is
    the most samples a thread holds in registers at once; `probe` adds the
    chain probe to the source, for `scan_group_chain_probe`."""

    def __init__(self, steps: Sequence[CG.Step], outs: Sequence[CG.Operand],
                 n_ext: int, unroll: int = CG.MAX_UNROLL,
                 probe: bool = False):
        self.steps = list(steps)
        self.outs = list(outs)
        self.n_carry = len(self.outs)
        self.n_ext = int(n_ext)
        self.probe = probe
        self.source = CG.emit_scan_source(self.steps, self.outs, self.n_carry,
                                          self.n_ext, unroll, probe)
        self.block_rows = CG.block_rows(self.steps, self.outs, unroll)
        self.components = CG.components(self.steps, self.outs)
        self.transcendental = CG.has_transcendental(self.steps)


# xs (or xc), c0, ys (or out), L, stream
_LAUNCH_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load_generated(source)
    lib.scan_group_launch.argtypes = _LAUNCH_ARGS
    lib.scan_group_launch.restype = ctypes.c_int
    return lib


def _check(n_carry: int, n_ext: int, xs, c0) -> None:
    if xs.dim() != 2 or xs.shape[1] != n_ext:
        raise ValueError(f"xs must be [L, {n_ext}], got {tuple(xs.shape)}")
    if tuple(c0.shape) != (n_carry,):
        raise ValueError(f"c0 must be [{n_carry}], got {tuple(c0.shape)}")
    for name, v in (("xs", xs), ("c0", c0)):
        if v.dtype != torch.float64 or v.device != xs.device:
            raise ValueError(f"{name} must be float64 on {xs.device}, got "
                             f"{v.dtype} on {v.device}")


def scan_group_plain(steps: Sequence[CG.Step], outs: Sequence[CG.Operand],
                     xs: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Plain version: the per-sample loop over the level's steps in Python,
    with the scalar EEL2 tables.  xs [L, n_ext], c0 [n] -> ys [L, n]."""
    from ..lowering.specialize import _SC_BINARY, _SC_UNARY, _norm_loop
    from ..semantics import scalar as SC

    _check(len(outs), xs.shape[1], xs, c0)
    n_t = xs.shape[0]
    rows = xs.tolist() if xs.shape[1] else [()] * n_t
    cv = c0.tolist()
    ys: List[List[float]] = []
    vals = [0.0] * len(steps)

    def get(spec, x_t):
        tag, v = spec
        if tag == "s":
            return vals[v]
        if tag == "x":
            return x_t[v]
        return cv[v] if tag == "p" else v

    for x_t in rows:
        for i, (kind, op, meta, args) in enumerate(steps):
            if kind == "bin":
                vals[i] = _SC_BINARY[op](get(args[0], x_t),
                                         get(args[1], x_t))
            elif kind == "call":
                vals[i] = _SC_UNARY[op](get(args[0], x_t))
            elif kind == "select":
                vals[i] = (get(args[1], x_t)
                           if SC.truthy(get(args[0], x_t))
                           else get(args[2], x_t))
            else:
                vals[i] = _norm_loop(get(args[0], x_t), meta)
        cv = [float(get(o, x_t)) for o in outs]
        ys.append(cv)
    out = torch.tensor(ys, dtype=torch.float64).reshape(n_t, len(outs))
    return out.to(xs.device)


def scan_group(program: ScanGroupProgram, xs: torch.Tensor,
               c0: torch.Tensor) -> torch.Tensor:
    """xs [L, n_ext]; c0 [n]; f64 -> ys [L, n], ys[t] the carries after
    sample t.

    CUDA tensors go to the kernel generated from the program's steps, CPU
    tensors to the plain loop over them.
    """
    global LAUNCHES
    _check(program.n_carry, program.n_ext, xs, c0)
    if xs.device.type == "cpu":
        return scan_group_plain(program.steps, program.outs, xs, c0)
    if xs.device.type != "cuda":
        raise ValueError(f"scan_group runs on cuda or cpu, not {xs.device}")
    xs, c0 = xs.contiguous(), c0.contiguous()
    n_t = xs.shape[0]
    ys = torch.empty((n_t, program.n_carry), dtype=torch.float64,
                     device=xs.device)
    if n_t == 0:
        return ys
    lib = _library(program.source)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.scan_group_launch(xs.data_ptr(), c0.data_ptr(),
                                    ys.data_ptr(), n_t, stream)
    if err != 0:
        raise RuntimeError(f"scan_group kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return ys


def scan_group_chain_probe(program: ScanGroupProgram, xc: torch.Tensor,
                           c0: torch.Tensor, n_t: int) -> torch.Tensor:
    """Timing probe of the level's dependent chain (for chip_smoke.py).

    Each component's thread runs n_t // block_rows * block_rows steps with
    the externals cycling through the `program.block_rows` rows of xc,
    held in registers, and the last carries come back as an [n] tensor.
    With no memory traffic its time per step is the floor under the
    kernel's.  The program must have been made with `probe=True`.  Not a
    kernel of any path, so it leaves LAUNCHES alone.
    """
    _check(program.n_carry, program.n_ext, xc, c0)
    if not program.probe:
        raise ValueError("the program's source was made without the probe")
    if xc.device.type != "cuda" or xc.shape[0] != program.block_rows:
        raise ValueError(f"xc must be [{program.block_rows}, "
                         f"{program.n_ext}] on cuda")
    xc, c0 = xc.contiguous(), c0.contiguous()
    out = torch.empty_like(c0)
    lib = _library(program.source)
    lib.scan_group_chain.argtypes = _LAUNCH_ARGS
    lib.scan_group_chain.restype = ctypes.c_int
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.scan_group_chain(xc.data_ptr(), c0.data_ptr(),
                                   out.data_ptr(), n_t, stream)
    if err != 0:
        raise RuntimeError(f"scan_group chain probe failed: cudaError {err}")
    return out


def scan_group_host(program: ScanGroupProgram, xs: torch.Tensor,
                    c0: torch.Tensor) -> torch.Tensor:
    """The generated bodies compiled for the CPU with a host C++ compiler
    (the source's host form, a plain loop over t), on CPU tensors.  Shows
    without a GPU that the generated text repeats `scan_group_plain`; no
    render path calls it, and it leaves LAUNCHES alone."""
    _check(program.n_carry, program.n_ext, xs, c0)
    if xs.device.type != "cpu":
        raise ValueError("scan_group_host takes CPU tensors")
    fn = _build.load_generated_host(program.source).scan_group_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    fn.restype = ctypes.c_int
    xs, c0 = xs.contiguous(), c0.contiguous()
    ys = torch.empty((xs.shape[0], program.n_carry), dtype=torch.float64)
    fn(xs.data_ptr(), c0.data_ptr(), ys.data_ptr(), xs.shape[0])
    return ys
