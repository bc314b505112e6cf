"""Sequential scan groups: generated CUDA kernels + the plain Python loop.

Counterpart of the `lax.scan` that the reference solves a DAG level of
scan groups with (zorak_tpu/lowering/specialize.py, `solve_scan_group`):
carries c [n] (f64), external streams xs [L, n_ext] (f64), a body that is
a small DAG of EEL2 operations over carries, externals and constants;
ys [L, n] out, c <- ys[t] each sample; or the same for a batch of files,
xs [nf, L, n_ext], c0 [nf, n], ys [nf, L, n], in one launch.  A state-dependent recurrence (an
attack/release envelope, a peak hold, a nonlinear feedback, a mutually
recursive pair) has no closed form, yet it splits across time exactly
where two walks from different carries come to meet, as a contracting
body's do.

The body differs from plugin to plugin, so the kernels' text is generated
from the level's step list (`lowering/scan_codegen.py`), compiled with
nvcc at first use and kept by its text (`_build.load_generated`).  On a
CUDA tensor `scan_group` launches them: a speculate kernel walks every
chunk of `chunk` samples of every independent component in parallel,
started from the segment's start carries `warmup` samples early, and a
fix-up kernel walks the chunks in order with the true carries, passing
through each chunk whose recorded start equals them in every bit and
walking the others again until they meet the speculated values.  The
result is the sequential walk's bit for bit, whatever the body.  Where a
launch re-walked more than half a file's samples, that file's flag makes
the next launch walk it in series without speculating (the flags live on
the device; no host read).  L <= warmup + chunk is that walk alone.  On a CPU
tensor `scan_group` runs `scan_group_plain`, the per-sample Python loop in
the scalar EEL2 semantics, which the generated body repeats bit for bit
wherever it calls no transcendental (those go to the device's libm, 1 to
2 ulp from glibc's).  Nothing falls back from one to the other.
`scan_group_host` runs the same two phases compiled for the CPU, so that
the tests hold the algorithm itself to the plain loop.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from . import _build
from ..lowering import scan_codegen as CG

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0

# Steps the fix-up kernels re-walked, one int64 tensor per CUDA device,
# added to on the device and never read back by the wrapper; chip_smoke.py
# zeroes them before a path and sums them after.
RERUN_STEPS: dict = {}

# Samples of a chunk, and warm-up samples before it.  A speculating thread
# walks at most WARMUP + CHUNK samples.  The K4 bodies of chip_smoke.py
# whose walks meet did so within 6,505 samples on noise and 14,357 on
# program-like material (the followers; the envelope 10,996, the others
# 10,000 or fewer), so this warm-up covers them, and a chunk's own samples
# add to it.  A release pole of 0.999 alone may need about 37,000 (53
# halvings of a gap); where a warm-up falls short the fix-up walks the
# chunk again, and past half the samples the next launch walks in
# series.  K1's warm-up of 49,152 made the speculation slower than the
# walk in series for the two stereo followers on an H100.
CHUNK = 1024
WARMUP = 16384


class ScanGroupProgram:
    """One level's step list with its generated source; made once for a
    kernel's life, so that no segment prints the text again.  `unroll` is
    the most samples a thread holds in registers at once; `probe` adds the
    chain probe to the source, for `scan_group_chain_probe`; `staged`
    overrides how the speculate kernel loads its externals (None: by the
    count of external streams, `scan_codegen.STAGE_MAX_EXT`; the sweep of
    `chip_smoke.py` sets it to time both ways)."""

    def __init__(self, steps: Sequence[CG.Step], outs: Sequence[CG.Operand],
                 n_ext: int, unroll: int = CG.MAX_UNROLL,
                 probe: bool = False, staged: Optional[bool] = None):
        # the no-merge flags (one a file) and the launch count, by device
        # ("cpu" for the host form) and batch size: a launch that re-walked
        # more than half a file's samples writes its number into the
        # file's flag, and the next launch, seeing the number before its
        # own, walks that file in series
        self._flags: dict = {}
        self.steps = list(steps)
        self.outs = list(outs)
        self.n_carry = len(self.outs)
        self.n_ext = int(n_ext)
        self.probe = probe
        self.source = CG.emit_scan_source(self.steps, self.outs, self.n_carry,
                                          self.n_ext, unroll, probe, staged)
        self.block_rows = CG.block_rows(self.steps, self.outs, unroll)
        self.components = CG.components(self.steps, self.outs)
        self.transcendental = CG.has_transcendental(self.steps)
        self.host_last = None     # set by scan_group_host
        self.host_marks = None    # set by scan_group_host


# xs, c0, ys, ws, mark, reruns; L, chunk, warm, launch number, files; stream
_LAUNCH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 5 + [
    ctypes.c_void_p]
# xc, c0, out, L, stream
_CHAIN_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load_generated(source)
    lib.scan_group_launch.argtypes = _LAUNCH_ARGS
    lib.scan_group_launch.restype = ctypes.c_int
    return lib


def chunk_plan(n_t: int, chunk: int, warmup: int):
    """(chunk, warm, n_chunks) as the kernels run L = n_t samples: one
    chunk, the walk in series, where n_t <= warmup + chunk; else the
    warm-up never reaches back before t = 0 for every chunk."""
    for name, v, least in (("chunk", chunk, 1), ("warmup", warmup, 0)):
        if isinstance(v, bool) or not isinstance(v, int) or v < least:
            raise ValueError(f"{name} must be an int >= {least}, got {v!r}")
    if n_t <= warmup + chunk:
        return max(n_t, 1), 0, 1
    n_chunks = -(-n_t // chunk)
    return chunk, min(warmup, (n_chunks - 1) * chunk), n_chunks


def _rerun_counter(device: torch.device) -> torch.Tensor:
    if device not in RERUN_STEPS:
        RERUN_STEPS[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return RERUN_STEPS[device]


def _check(n_carry: int, n_ext: int, xs, c0) -> None:
    if xs.dim() not in (2, 3) or xs.shape[-1] != n_ext:
        raise ValueError(f"xs must be [L, {n_ext}] or [files, L, {n_ext}], "
                         f"got {tuple(xs.shape)}")
    if tuple(c0.shape) != tuple(xs.shape[:-2]) + (n_carry,):
        raise ValueError(f"c0 must be {list(xs.shape[:-2]) + [n_carry]}, "
                         f"got {tuple(c0.shape)}")
    for name, v in (("xs", xs), ("c0", c0)):
        if v.dtype != torch.float64 or v.device != xs.device:
            raise ValueError(f"{name} must be float64 on {xs.device}, got "
                             f"{v.dtype} on {v.device}")


def scan_group_plain(steps: Sequence[CG.Step], outs: Sequence[CG.Operand],
                     xs: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Plain version: the per-sample loop over the level's steps in Python,
    with the scalar EEL2 tables.  xs [L, n_ext], c0 [n] -> ys [L, n]; a
    batch, xs [nf, L, n_ext] and c0 [nf, n], a file after another."""
    from ..lowering.specialize import _SC_BINARY, _SC_UNARY, _norm_loop
    from ..semantics import scalar as SC

    _check(len(outs), xs.shape[-1], xs, c0)
    if xs.dim() == 3:
        return torch.stack([scan_group_plain(steps, outs, x, c)
                            for x, c in zip(xs, c0)]) if xs.shape[0] else \
            torch.empty((0, xs.shape[1], len(outs)), dtype=torch.float64,
                        device=xs.device)
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
               c0: torch.Tensor, *, chunk: int = CHUNK,
               warmup: int = WARMUP) -> torch.Tensor:
    """xs [L, n_ext]; c0 [n]; f64 -> ys [L, n], ys[t] the carries after
    sample t.  A batch of files, xs [nf, L, n_ext] and c0 [nf, n], gives
    ys [nf, L, n] from one launch, each file as it would walk alone.

    CUDA tensors go to the kernels generated from the program's steps, CPU
    tensors to the plain loop over them.  `chunk` and `warmup` shape the
    kernels' split of time and never change the result; L <= warmup +
    chunk is one chunk, a thread a component and file walking all of L.
    """
    global LAUNCHES
    _check(program.n_carry, program.n_ext, xs, c0)
    n_t = xs.shape[-2]
    chunk, warm, n_chunks = chunk_plan(n_t, chunk, warmup)
    if xs.device.type == "cpu":
        return scan_group_plain(program.steps, program.outs, xs, c0)
    if xs.device.type != "cuda":
        raise ValueError(f"scan_group runs on cuda or cpu, not {xs.device}")
    nf = xs.shape[0] if xs.dim() == 3 else 1
    if nf > 65535:
        raise ValueError("scan_group takes at most 65535 files")
    xs, c0 = xs.contiguous(), c0.contiguous()
    ys = torch.empty(tuple(xs.shape[:-1]) + (program.n_carry,),
                     dtype=torch.float64, device=xs.device)
    if n_t == 0 or nf == 0:
        return ys
    ws = torch.empty((nf, 2, n_chunks, program.n_carry), dtype=torch.float64,
                     device=xs.device)
    mark, launch_no = _next_launch(program, xs.device, nf)
    reruns = _rerun_counter(xs.device)
    lib = _library(program.source)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.scan_group_launch(
            xs.data_ptr(), c0.data_ptr(), ys.data_ptr(), ws.data_ptr(),
            mark.data_ptr(), reruns.data_ptr(), n_t, chunk, warm, launch_no,
            nf, stream)
    if err != 0:
        raise RuntimeError(f"scan_group kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return ys


def _next_launch(program: ScanGroupProgram, device, nf: int):
    """(the program's flags, one a file, for batches of nf files on
    `device`, and this launch's number, from 1)."""
    key = (str(device), nf)
    if key not in program._flags:
        flag = ((ctypes.c_longlong * nf)(*[-1] * nf) if key[0] == "cpu" else
                torch.full((nf,), -1, dtype=torch.int64, device=device))
        program._flags[key] = [flag, 0]
    entry = program._flags[key]
    entry[1] += 1
    return entry[0], entry[1]


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
    lib.scan_group_chain.argtypes = _CHAIN_ARGS
    lib.scan_group_chain.restype = ctypes.c_int
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = lib.scan_group_chain(xc.data_ptr(), c0.data_ptr(),
                                   out.data_ptr(), n_t, stream)
    if err != 0:
        raise RuntimeError(f"scan_group chain probe failed: cudaError {err}")
    return out


def scan_group_host(program: ScanGroupProgram, xs: torch.Tensor,
                    c0: torch.Tensor, *, chunk: int = CHUNK,
                    warmup: int = WARMUP) -> torch.Tensor:
    """The generated source compiled for the CPU with a host C++ compiler
    (its host form: the kernels' two phases, one chunk after another), on
    CPU tensors.  Shows without a GPU that the generated text and the
    speculation repeat `scan_group_plain`; no render path calls it, and
    it leaves LAUNCHES alone.  `program.host_last` then holds (whether
    the call speculated, the steps its fix-up re-walked); the no-merge
    flags of the host form are the program's own, as on the card.  A
    batch (xs [nf, L, n_ext], c0 [nf, n]) runs its files one after
    another; `host_last` then holds (the files speculated, the steps all
    files re-walked), and `host_marks` the files' flags after the call."""
    _check(program.n_carry, program.n_ext, xs, c0)
    if xs.device.type != "cpu":
        raise ValueError("scan_group_host takes CPU tensors")
    fn = _build.load_generated_host(program.source).scan_group_host
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 5
    fn.restype = ctypes.c_int
    batched = xs.dim() == 3
    xs, c0 = xs.contiguous(), c0.contiguous()
    nf = xs.shape[0] if batched else 1
    n_t = xs.shape[-2]
    chunk, warm, n_chunks = chunk_plan(n_t, chunk, warmup)
    ys = torch.empty(tuple(xs.shape[:-1]) + (program.n_carry,),
                     dtype=torch.float64)
    ws = torch.empty((nf, 2, n_chunks, program.n_carry), dtype=torch.float64)
    mark, launch_no = _next_launch(program, "cpu", nf)
    reruns = ctypes.c_ulonglong(0)
    speculated = fn(xs.data_ptr(), c0.data_ptr(), ys.data_ptr(),
                    ws.data_ptr(), ctypes.addressof(mark),
                    ctypes.addressof(reruns), n_t, chunk, warm, launch_no,
                    nf)
    program.host_last = (speculated if batched else bool(speculated),
                         reruns.value)
    program.host_marks = list(mark)
    return ys
