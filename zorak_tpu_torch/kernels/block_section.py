"""The audio-coupled @block between sample segments: K10 + its plain version.

Replaces the reference's traced `@block` step of the fused block/sample
pipeline (`DeviceSection.step`, zorak_tpu/lowering/devgen.py:463, as
`_coupled_run` runs it inside its scan, zorak_tpu/lowering/specialize.py:
3085-3150): once a block, each file's sample state goes into the device
view of its section (vars [n_vars], heap [total_mem]), the @block section
runs (and @slider where @block retriggered it), the device view goes back
into the sample state, and the control row of the next segment is
gathered.

On a CUDA tensor `block_section` launches one generated kernel: a CUDA
block a file, whose threads copy the exchanges and then run the
section's phases (`lowering/devgen.py`, `csrc/block_ops.cuh`): thread 0
alone the ordered code, every thread the FFT calls, the block copies and
the loops with independent iterations, between barriers (inside a user
function called as a statement and a loop that holds them too).  On a
CPU tensor it runs `block_section_plain`, the same exchanges in torch
and the sections through the port's Python golden (`shadow/pyexec.py`)
with the device heap's addressing.  Nothing falls back from one to the other.
`block_section_host` runs the generated text compiled with a host C++
compiler, for the tests: the phases with any number of threads, their
shares in either order, or the one-thread form.

A build made with `probe=True` also holds the earlier design, thread 0
running the whole section (`block_section_earlier`), and timing probes;
chip_smoke.py holds K10 to it bit for bit and times the two in turns.

A section that uses gmem or the message bus is staged (`Stage`): in a
graph's lockstep (runtime/graph.py) its gmem is the shared segment, read
and written in place, and its launch also runs the bus's prologue and
epilogue on thread 0.  The prologue compacts the graph's ring window by
the members' smallest cursor (at the block's first member), routes the
window's entries that match this member into its heap queues, in ring
order, and zeroes its OUT table; the epilogue, after the section and any
@slider rerun, appends the OUT rows to the window with the member's
sender id.  The window, its count, the cursors and the overflow counter
are device tensors for the whole render, so a render's members run one
after another on one stream with no copy to the host between them.

A section that calls the host services (a loaded sample pool, file_mem's
copies, string gathers) reads its program's `HostTables`
(`lowering/devgen.py`), staged on the device at the first launch and kept
(`kernels/host_tables.py`): every launch of a render passes the same
tables.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .host_tables import tables_arg
from ..lowering.devgen import (
    MIDI_OUT_CAP, MIDI_POS_SLOT, MSG_ENT, MSG_OUT_CAP, MSG_QENT, MSG_QUEUE_CAP,
    PENDING_SLOT_NAMES, DeviceSection, plain_host)
from ..runtime import fftops as FO
from ..shadow.state import HostServices

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0

# Threads of a file's CUDA block (a build parameter, `threads=`): they
# share the exchanges, the block FFTs and the block loops.
THREADS = 256

# Block loops and block copies that thread 0 ran alone because this run's
# values failed their checks (a copy: overlapping runs), by device (an
# int64 counter on the device, added to by the kernel); `serial_runs`
# reads it.
SERIAL_RUNS: dict = {}

# The most shared memory a block takes (of an H100's 227 KB, after the
# opt-in above 48 KB): the var row and the FFT workspace live there when
# they fit, else in device memory.
SMEM_MAX = 200 * 1024

# The stated tolerance of a section with an FFT against the plain version
# (NumPy's FFT): a heap cell relative to the largest magnitude of the heap,
# a var or control value relative to its own magnitude (at least 1).  A
# radix-2 in f64 and pocketfft differ by rounding, of the order of log2(n)
# ulps of the transform's largest magnitude.
FFT_TOL_REL = 1e-12


def fft_excess(heap, heap_want, vals, vals_want) -> float:
    """How far a section's heap row and var (or control) values lie
    outside FFT_TOL_REL of the wanted ones (<= 0 means inside)."""
    heap_tol = FFT_TOL_REL * max(1.0, float(heap_want.abs().max()))
    val_tol = FFT_TOL_REL * vals_want.abs().clamp(min=1.0)
    return max(float((heap - heap_want).abs().max()) - heap_tol,
               float(((vals - vals_want).abs() - val_tol).max()))

_DESIGN = """\
// K10 block_section: replaces the traced @block step of the reference's
// fused block/sample pipeline (zorak_tpu/lowering/devgen.py:463
// DeviceSection.step inside specialize.py _coupled_run's scan).
//
// What bounds it: the section's ordered code, one dependent chain on one
// thread (a loop that carries a sum, the scalar updates), and the
// barriers between phases; the exchanges move (rings + scalars) x 16
// bytes a file, far less.
//
// What the design does: a CUDA block a file.  Its threads copy the
// sample side into the device view (carried scalars -> var slots, each
// ring region and carried cell -> the heap), then run the section's
// phases (zb_run_team): thread 0 alone the ordered statements (ZB_SOLO),
// every thread a strided share of each FFT call, each memcpy and memset
// and each loop whose iterations touch no common cell (ZB_STEPS), with a
// barrier after each, also inside a user function called as a statement
// and inside a loop whose body holds such work (every thread follows the
// pass thread 0 decides and publishes); @slider, where @block retriggered
// it, on thread 0.  Then the threads copy the view back and gather the
// next segment's control row.  A butterfly, a copied cell and an
// iteration do the same arithmetic as on one thread, so the result is the
// same bits.  No barrier sits in code that only thread 0 runs.
"""


# a ring window row: [sender, bc, dest, chan_id, tag, a, b, c, d]
WINDOW_ENT = 9
# the window's control row: [count, overflow, compacted, cursor of each
# member that uses the bus]
CTL_COUNT, CTL_OVERFLOW, CTL_COMPACTED, CTL_CURSORS = 0, 1, 2, 3


class Stage(NamedTuple):
    """What one lockstep member's launch shares with the graph (one file).

    gseg     the shared gmem segment, f64 [cells] (None: the heap's window)
    window   the ring window, f64 [rows, WINDOW_ENT] (None: no bus)
    ctl      its control row, f64 [CTL_CURSORS + members]
    member   this member's cursor among the bus's members
    compact  compact the window first (the block's first bus member)
    sub      this member's subscriptions by channel id, f64 [channels]
    my_id    this member's instance id"""
    gseg: Optional[torch.Tensor] = None
    window: Optional[torch.Tensor] = None
    ctl: Optional[torch.Tensor] = None
    member: int = 0
    compact: bool = False
    sub: Optional[torch.Tensor] = None
    my_id: float = 0.0


class BlockSectionProgram:
    """K10's generated source for one coupled plugin, made once for the
    kernel's life.

    block, slider   the @block section and, where @block can retrigger it,
                    the @slider section (DeviceSections over one slot
                    table and heap);
    n_svec          carried scalars of the sample side;
    inter           [(svec index, slot)]: carried scalars the section sees;
    regions         [(origin, mod)]: the carried heap regions (the rings);
    cells           [(svec index, address)]: carried single heap cells;
    ctrl            [("v", slot) or ("m", address)]: the control row;
    probe           also build the earlier design and the timing probes;
    threads         threads of a file's CUDA block (1 to 1,024).
    """

    def __init__(self, block: DeviceSection, slider: Optional[DeviceSection],
                 n_svec: int, inter: Sequence[Tuple[int, int]],
                 regions: Sequence[Tuple[int, int]],
                 cells: Sequence[Tuple[int, int]],
                 ctrl: Sequence[Tuple[str, int]], probe: bool = False,
                 threads: int = THREADS):
        if slider is not None and (slider.slots != block.slots
                                   or slider.mem_size != block.mem_size):
            raise ValueError("@block and @slider must share slots and heap")
        self.block, self.slider = block, slider
        secs = [s for s in (block, slider) if s is not None]
        self.n_vars = block.n_vars
        self.mem_size = block.mem_size
        self.uses_midi_in = any(s.uses_midi_in for s in secs)
        self.uses_midi_out = any(s.uses_midi_out for s in secs)
        # the heap's tail, laid out by @block for both sections
        layout = ("gmem_base", "gmem_cells", "midi_out_base",
                  "msg_out_base", "msg_out_cells", "msg_in_base",
                  "msg_queues", "total_mem")
        if slider is not None and any(getattr(slider, k) != getattr(block, k)
                                      for k in layout):
            raise ValueError("@block and @slider must share the heap's layout")
        if self.uses_midi_out != block.uses_midi_out:
            raise ValueError("@block's layout has no MIDI out table")
        for k in layout:
            setattr(self, k, getattr(block, k))
        self.midi_out_cells = block.midi_out_cells
        # the host services' tables, shared by the sections: a launch
        # passes their staged copy (the text and the launch take one more
        # argument)
        if slider is not None and slider.tables is not block.tables:
            raise ValueError("@block and @slider must share their tables")
        self.tables = block.tables
        self.tabled = self.tables.used
        if self.tabled and probe:
            raise ValueError("the probe builds read no host tables")
        self.uses_gmem = block.uses_gmem
        self.uses_msg = block.msg_cfg is not None
        # a staged launch: gmem through the view, the bus's prologue and
        # epilogue (the text and the launch take more arguments)
        self.staged = self.uses_gmem or self.uses_msg
        self.n_svec = int(n_svec)
        self.inter = [(int(a), int(b)) for a, b in inter]
        self.regions = [(int(o), int(m)) for o, m in regions]
        self.cells = [(int(a), int(b)) for a, b in cells]
        self.ctrl = [(k, int(v)) for k, v in ctrl]
        self.fft_max = max(s.fft_max for s in secs)
        self.scratch_cells = max(1, max(s.scratch_cells for s in secs))
        self.perm_sizes = sorted({n for s in secs for n in s.perm_sizes})
        self.probe = probe
        if isinstance(threads, bool) or not isinstance(threads, int) \
                or not 1 <= threads <= 1024:
            raise ValueError(f"threads must be an int in [1, 1024], got "
                             f"{threads!r}")
        self.threads = threads
        # thread 0's working set on chip: the var row (its loop counters and
        # accumulators), and the FFT workspace where both fit
        self.v_shared = self.n_vars * 8 <= SMEM_MAX
        self.scratch_shared = self.v_shared and \
            (self.n_vars + self.scratch_cells) * 8 <= SMEM_MAX
        self.smem_bytes = 8 * ((self.n_vars if self.v_shared else 0)
                               + (self.scratch_cells if self.scratch_shared
                                  else 0))
        self.pend_slots = [block.slots[("var", nm)] for nm in PENDING_SLOT_NAMES]
        self.pos_slot = block.slots[("var", MIDI_POS_SLOT)]
        for o, m in self.regions:
            if o + m > self.mem_size:
                raise ValueError(f"region ({o}, {m}) beyond the heap")
        self.source = _emit_source(self)
        # cos, sin of 2 pi k / n, k < n / 2, for the largest transform
        n = max(self.fft_max, 2)
        ang = 2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
        self.twiddles = np.stack([np.cos(ang), np.sin(ang)], axis=1).reshape(-1)
        self._device_tables: Dict[str, torch.Tensor] = {}
        self._scratch: Dict[Tuple[str, int], torch.Tensor] = {}
        self._plain_fns = None
        self._plain_state = None

    def twiddles_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._device_tables:
            self._device_tables[key] = torch.from_numpy(
                self.twiddles.copy()).to(device)
        return self._device_tables[key]

    def scratch_on(self, device, nf: int) -> torch.Tensor:
        key = (str(device), nf)
        if key not in self._scratch:
            self._scratch[key] = torch.zeros(
                (nf, self.scratch_cells), dtype=torch.float64, device=device)
        return self._scratch[key]


def _c_table(name: str, values: Sequence[int], ctype: str = "long long") -> str:
    vals = ", ".join(str(int(v)) for v in values) or "0"
    return f"ZB_DEV const {ctype} {name}[] = {{{vals}}};"


def _emit_source(p: BlockSectionProgram) -> str:  # noqa: C901 (one file)
    """K10's text: the sections, the exchanges, the kernel, its launcher
    and, for a host compiler, the same phases a file after another."""
    secs = [s for s in (p.block, p.slider) if s is not None]
    functions: Dict[str, str] = {}
    for s in secs:
        for name, text in s.functions.items():
            if functions.setdefault(name, text) != text:
                raise ValueError(f"{name} prints differently in two sections")
    perm = FO.perm_table
    nr = len(p.regions)
    ring_params = "".join(f", double* r{i}" for i in range(nr))
    ring_args = "".join(f", r{i}" for i in range(nr))
    out = [
        _DESIGN,
        '#include "block_ops.cuh"',
        "",
        "#ifdef __CUDACC__",
        "#define ZB_DEV static __device__",
        "#else",
        "#define ZB_DEV static",
        "#endif",
        "",
        f"#define ZB_NS {p.n_svec}",
        f"#define ZB_NV {p.n_vars}",
        f"#define ZB_TM {p.total_mem}",
        f"#define ZB_MEM {p.mem_size}",
        f"#define ZB_MO {p.midi_out_base if p.uses_midi_out else -1}",
        f"#define ZB_MO_CELLS {p.midi_out_cells}",
        f"#define ZB_NC {len(p.ctrl)}",
        f"#define ZB_SCRATCH {p.scratch_cells}",
        f"#define ZB_THREADS {p.threads}",
        f"#define ZB_NQ {max(1, p.block.n_pub)}",
        f"#define ZB_NP {max(1, p.block.n_pub_double)}",
        f"#define ZB_V_SHARED {int(p.v_shared)}",
        f"#define ZB_SCRATCH_SHARED {int(p.scratch_shared)}",
        f"#define ZB_SMEM {p.smem_bytes}",
        "",
    ]
    for n in p.perm_sizes:
        out.append(_c_table(f"zb_perm_{n}", perm(n), "int"))
    out.append(_c_table("zb_in_sv", [a for a, _b in p.inter]))
    out.append(_c_table("zb_in_slot", [b for _a, b in p.inter]))
    out.append(_c_table("zb_cell_sv", [a for a, _b in p.cells]))
    out.append(_c_table("zb_cell_at", [b for _a, b in p.cells]))
    out.append(_c_table("zb_ctrl_mem", [k == "m" for k, _v in p.ctrl], "int"))
    out.append(_c_table("zb_ctrl_at", [v for _k, v in p.ctrl]))
    out.append("")
    out += [text.split(" {", 1)[0] + ";" for text in functions.values()]
    out += list(functions.values())
    out += [s.body_source for s in secs]
    run = [f"  {p.block.fn_name}(S);"]
    if p.slider is not None:
        a, b, c = p.pend_slots
        run += [
            "  // @block retriggered @slider: run it and clear the masks",
            f"  if (S->V[{a}] + S->V[{b}] + S->V[{c}] != 0.0) {{",
            f"    {p.slider.fn_name}(S);",
            f"    S->V[{a}] = 0.0; S->V[{b}] = 0.0; S->V[{c}] = 0.0;",
            "  }",
        ]
    out += ["", "ZB_DEV void zb_run(ZB* S) {", *run, "}", ""]
    # the exchanges: thread t of nt takes every nt-th copy
    loop = "for (long long i = t; i < {n}; i += nt) "
    view_in = [
        f"ZB_DEV void zb_view_in(long long f, long long t, long long nt, "
        f"double* V, double* M, const double* sv{ring_params}) {{",
        "  (void)f;",
        f"  {loop.format(n=len(p.inter))}V[zb_in_slot[i]] = sv[zb_in_sv[i]];",
    ]
    for i, (o, m) in enumerate(p.regions):
        view_in.append(f"  {loop.format(n=m)}M[{o} + i] = r{i}[f * {m} + i];")
    view_in.append(f"  {loop.format(n=p.midi_out_cells)}M[ZB_MO + i] = 0.0;")
    if p.uses_midi_in:
        view_in.append(f"  if (t == 0) V[{p.pos_slot}] = 0.0;  "
                       "// a fresh host queue each block")
    view_in += ["}", ""]
    cells_in = [
        "ZB_DEV void zb_cells_in(long long t, long long nt, double* M, "
        "const double* sv) {",
        f"  {loop.format(n=len(p.cells))}M[zb_cell_at[i]] = sv[zb_cell_sv[i]];",
        "}", ""]
    view_out = [
        f"ZB_DEV void zb_view_out(long long f, long long t, long long nt, "
        f"const double* V, const double* M, double* sv{ring_params}, "
        "double* ctrl, double* mout) {",
        "  (void)f; (void)ctrl; (void)mout;",
        f"  {loop.format(n=len(p.inter))}sv[zb_in_sv[i]] = V[zb_in_slot[i]];",
    ]
    for i, (o, m) in enumerate(p.regions):
        view_out.append(f"  {loop.format(n=m)}r{i}[f * {m} + i] = M[{o} + i];")
    view_out += [
        f"  {loop.format(n=len(p.cells))}sv[zb_cell_sv[i]] = M[zb_cell_at[i]];",
        f"  {loop.format(n=len(p.ctrl))}ctrl[f * ZB_NC + i] = "
        "zb_ctrl_mem[i] ? M[zb_ctrl_at[i]] : V[zb_ctrl_at[i]];",
        f"  {loop.format(n=p.midi_out_cells)}"
        "mout[f * ZB_MO_CELLS + i] = M[ZB_MO + i];",
        "}", ""]
    out += view_in + cells_in + view_out
    out += _team_function(p)
    out += _staging_functions(p)
    make_s = ("ZB S = {V, M, ZB_MEM, ZB_MO, samplesblock, midi_ev, midi_n, "
              "W, tw, tw_n, runs};")
    # a staged launch: the view's gmem and bus, then the bus's prologue
    # (thread 0; the section's bus calls run on thread 0 after it)
    stage_in, stage_out, stage_params, stage_args, stage_void = \
        [], [], "", "", ""
    if p.tabled:
        stage_in.append("  S.H = zh;")
    if p.staged:
        stage_params = (", double* gseg, double* mwin, double* mctl, "
                        "long long mrows, long long nmem, long long member, "
                        "int compact, const double* msub, long long nsub, "
                        "double my_id")
        stage_args = (", gseg, mwin, mctl, mrows, nmem, member, compact, "
                      "msub, nsub, my_id")
        stage_void = (", void* gseg_, void* mwin_, void* mctl_, "
                      "long long mrows, long long nmem, long long member, "
                      "int compact, const void* msub_, long long nsub, "
                      "double my_id")
        stage_in += [
            "  S.G = gseg ? gseg : M + ZB_GBASE;",
            "  S.gmem_cells = ZB_GCELLS;",
            "  S.msg_out = ZB_MSG_OUT;",
            "  S.msg_in = ZB_MSG_IN;",
        ]
        if p.uses_msg:
            stage_in.append("  if (t == 0) zb_msg_begin(M, mwin, mctl, mrows, "
                            "nmem, member, compact, msub, nsub, my_id);")
            stage_out.append("  if (t == 0) zb_msg_end(M, mwin, mctl, mrows, "
                             "my_id);")
    # the kernels' var row and FFT workspace: shared memory where it fits
    on_chip = [
        "  extern __shared__ double zb_sh[];",
        "#if ZB_V_SHARED",
        "  double* const V = zb_sh;",
        "  for (long long i = t; i < ZB_NV; i += nt) V[i] = bvars[f * ZB_NV + i];",
        "  __syncthreads();",
        "#else",
        "  double* const V = bvars + f * ZB_NV;",
        "#endif",
        "#if ZB_SCRATCH_SHARED",
        "  double* const W = zb_sh + ZB_NV;",
        "#else",
        "  double* const W = scratch + f * ZB_SCRATCH;",
        "#endif",
    ]
    off_chip = [
        "#if ZB_V_SHARED",
        "  for (long long i = t; i < ZB_NV; i += nt) bvars[f * ZB_NV + i] = V[i];",
        "#endif",
    ]
    args = ("void* svec, void* bvars, void* bmem, void* ctrl, void* mout, "
            "const void* midi_ev, double midi_n, void* scratch, "
            "const void* tw, long long tw_n, double samplesblock, "
            "long long nf, void* serial_runs" + stage_void
            + (", const void* tables" if p.tabled else ""))
    stage_casts = [
        "  double* gseg = static_cast<double*>(gseg_);",
        "  double* mwin = static_cast<double*>(mwin_);",
        "  double* mctl = static_cast<double*>(mctl_);",
        "  const double* msub = static_cast<const double*>(msub_);",
    ] if p.staged else []
    if p.tabled:
        stage_casts.append("  const ZH zh = *static_cast<const ZH*>(tables);")
    table_param = ", ZH zh" if p.tabled else ""
    table_arg = ", zh" if p.tabled else ""
    casts = stage_casts + [
        "  double* sv0 = static_cast<double*>(svec);",
        "  double* bv = static_cast<double*>(bvars);",
        "  double* bm = static_cast<double*>(bmem);",
        "  double* cr = static_cast<double*>(ctrl);",
        "  double* mo = static_cast<double*>(mout);",
        "  const double* ev = static_cast<const double*>(midi_ev);",
        "  double* sc = static_cast<double*>(scratch);",
        "  const double* twd = static_cast<const double*>(tw);",
        "  unsigned long long* runs = static_cast<unsigned long long*>("
        "serial_runs);",
    ] + [f"  double* r{i} = static_cast<double*>(ring{i});"
         for i in range(nr)]
    ring_void = "".join(f", void* ring{i}" for i in range(nr))

    def kernel(name: str, run: List[str]) -> List[str]:
        return [
            f"__global__ void __launch_bounds__(ZB_THREADS) {name}(",
            "    double* svec, double* bvars, double* bmem, double* ctrl,",
            "    double* mout, const double* midi_ev, double midi_n,",
            "    double* scratch, const double* tw, long long tw_n,",
            "    double samplesblock, unsigned long long* runs"
            f"{stage_params}{table_param}{ring_params}) {{",
            "  const long long f = blockIdx.x, t = threadIdx.x, nt = blockDim.x;",
            *on_chip,
            "  double* M = bmem + f * ZB_TM;",
            "  double* sv = svec + f * ZB_NS;",
            f"  zb_view_in(f, t, nt, V, M, sv{ring_args});",
            "  __syncthreads();",
            "  zb_cells_in(t, nt, M, sv);   // a cell may lie in a ring region",
            "  __syncthreads();",
            f"  {make_s}",
            *stage_in,
            *run,
            *stage_out,
            f"  zb_view_out(f, t, nt, V, M, sv{ring_args}, ctrl, mout);",
            *off_chip,
            "}",
            "",
        ]

    def launcher(name: str, kern: str) -> List[str]:
        return [
            f'extern "C" int {name}({args}, void* stream{ring_void}) {{',
            "  cudaGetLastError();  // clear an error left by an earlier call",
            "  if (nf <= 0) return 0;",
            "  if (nf > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);",
            *casts,
            "  static bool opted_in = false;   // above 48 KB only after this",
            "  if (!opted_in && ZB_SMEM > 48 * 1024) {",
            f"    cudaFuncSetAttribute({kern},",
            "        cudaFuncAttributeMaxDynamicSharedMemorySize, ZB_SMEM);",
            "    opted_in = true;",
            "  }",
            f"  {kern}<<<static_cast<unsigned>(nf), ZB_THREADS, ZB_SMEM,",
            "              static_cast<cudaStream_t>(stream)>>>(sv0, bv, bm, cr,",
            f"      mo, ev, midi_n, sc, twd, tw_n, samplesblock, runs"
            f"{stage_args}{table_arg}{ring_args});",
            "  return static_cast<int>(cudaGetLastError());",
            "}",
            "",
        ]

    out += ["#ifdef __CUDACC__", ""]
    out += kernel("zb_kernel", [
        "  __shared__ double zb_p[ZB_NP];      // what thread 0 shares",
        "  __shared__ long long zb_q[ZB_NQ];",
        "  const ZT team = {t, nt, 0};",
        "  zb_run_team(&S, team, zb_p, zb_q);  // ends at a barrier",
    ])
    out += launcher("block_section_launch", "zb_kernel")
    if p.probe:
        out += ["// the earlier design: thread 0 runs the sections alone"]
        out += kernel("zb_kernel_earlier", [
            "  if (t == 0) zb_run(&S);",
            "  __syncthreads();",
        ])
        out += launcher("block_section_launch_earlier", "zb_kernel_earlier")
        out += _probe_kernels(p, make_s, on_chip, off_chip)
    out += [
        "#else  // a host compiler: the same phases, a file after another",
        "",
        "// nt <= 0: the one-thread form (zb_run); else the phases with nt",
        "// threads, each block step's shares in ascending t, or descending",
        "// where desc",
        f'extern "C" int block_section_host({args}, long long nt, int desc'
        f'{ring_void}) {{',
        *casts,
        "  for (long long f = 0; f < nf; ++f) {",
        "    double* V = bv + f * ZB_NV;",
        "    double* M = bm + f * ZB_TM;",
        "    double* sv = sv0 + f * ZB_NS;",
        f"    zb_view_in(f, 0, 1, V, M, sv{ring_args});",
        "    zb_cells_in(0, 1, M, sv);",
        "    {",
        "      const double* midi_ev = ev;",
        "      const double* tw = twd;",
        "      double* W = sc + f * ZB_SCRATCH;",
        f"      {make_s}",
        *["    " + line.replace("if (t == 0) ", "") for line in stage_in],
        "      if (nt <= 0) {",
        "        zb_run(&S);",
        "      } else {",
        "        double zp[ZB_NP];",
        "        long long zq[ZB_NQ];",
        "        const ZT team = {0, nt, desc};",
        "        zb_run_team(&S, team, zp, zq);",
        "      }",
        *["    " + line.replace("if (t == 0) ", "") for line in stage_out],
        "    }",
        f"    zb_view_out(f, 0, 1, V, M, sv{ring_args}, cr, mo);",
        "  }",
        "  return 0;",
        "}",
        "",
        "#endif",
        "",
    ]
    return "\n".join(out)


def _staging_functions(p: BlockSectionProgram) -> List[str]:
    """A staged program's layout and, where it uses the bus, the launch's
    prologue and epilogue (thread 0): the reference's joint-scan steps
    (zorak_tpu/lowering/specialize.py `_msg_route`, `_in_mask`, `_publish`
    and the compaction by the smallest cursor)."""
    if not p.staged:
        return []
    out = [
        "// the heap's tail: gmem window, msg OUT table, msg IN region",
        f"#define ZB_GBASE {p.gmem_base}",
        f"#define ZB_GCELLS {p.gmem_cells}",
        f"#define ZB_MSG_OUT {p.msg_out_base if p.uses_msg else -1}",
        f"#define ZB_MSG_IN {p.msg_in_base if p.uses_msg else -1}",
        "",
    ]
    if not p.uses_msg:
        return out
    queues = sorted(p.msg_queues.items())
    out += [
        f"#define ZB_NQUEUE {len(queues)}",
        _c_table("zb_q_chan", [c for c, _b in queues]),
        _c_table("zb_q_base", [b for _c, b in queues]),
        "",
        "// Begin-block: compact the ring window by the smallest cursor where",
        "// `compact` (the block's first bus member), route the entries past",
        "// this member's cursor that match it (a direct dest, or a broadcast",
        "// on a subscribed channel it did not send) into its queues in ring",
        "// order, a full queue counting into the drop cell, and start a",
        "// fresh OUT table.  Without a window (a render outside a graph) only",
        "// the OUT table is reset: sends go nowhere.",
        "ZB_DEV void zb_msg_begin(double* M, double* win, double* ctl,",
        "    long long rows, long long nmem, long long member, int compact,",
        "    const double* sub, long long nsub, double my) {",
        "  (void)rows;",
        "  M[ZB_MSG_OUT] = 0.0;",
        "  if (!ctl) return;",
        "  if (compact) {",
        f"    double lo = ctl[{CTL_CURSORS}];",
        "    for (long long j = 1; j < nmem; ++j)",
        f"      lo = ctl[{CTL_CURSORS} + j] < lo ? ctl[{CTL_CURSORS} + j] : lo;",
        f"    const long long m = (long long)lo, n = (long long)ctl[{CTL_COUNT}];",
        "    if (m > 0) {",
        "      for (long long g = m; g < n; ++g)",
        f"        for (int k = 0; k < {WINDOW_ENT}; ++k)",
        f"          win[{WINDOW_ENT} * (g - m) + k] = win[{WINDOW_ENT} * g + k];",
        f"      ctl[{CTL_COUNT}] = (double)(n - m);",
        f"      ctl[{CTL_COMPACTED}] += (double)m;",
        f"      for (long long j = 0; j < nmem; ++j) ctl[{CTL_CURSORS} + j] -= "
        "(double)m;",
        "    }",
        "  }",
        f"  const long long n = (long long)ctl[{CTL_COUNT}];",
        f"  for (long long g = (long long)ctl[{CTL_CURSORS} + member]; g < n; "
        "++g) {",
        f"    const double* e = win + {WINDOW_ENT} * g;",
        "    const long long c = (long long)e[3];",
        "    const bool hit = e[1] > 0.5",
        "        ? (c >= 0 && c < nsub && sub[c] != 0.0 && e[0] != my)",
        "        : e[2] == my;",
        "    if (!hit) continue;",
        "    for (int q = 0; q < ZB_NQUEUE; ++q) {",
        "      if (zb_q_chan[q] != c) continue;",
        "      double* Q = M + zb_q_base[q];",
        "      if (Q[1] < ZB_MSG_QUEUE_CAP) {",
        "        double pos = Q[0] + Q[1];",
        "        if (pos >= ZB_MSG_QUEUE_CAP) pos -= ZB_MSG_QUEUE_CAP;",
        "        double* r = Q + 2 + ZB_MSG_QENT * (long long)pos;",
        "        r[0] = e[0]; r[1] = e[4]; r[2] = e[5];",
        "        r[3] = e[6]; r[4] = e[7]; r[5] = e[8];",
        "        Q[1] += 1.0;",
        "      } else {",
        "        M[ZB_MSG_IN] += 1.0;",
        "      }",
        "    }",
        "  }",
        f"  ctl[{CTL_CURSORS} + member] = (double)n;",
        "}",
        "",
        "// End-block: the OUT rows appended to the window with the sender's id;",
        "// rows past the window count into the overflow counter.",
        "ZB_DEV void zb_msg_end(const double* M, double* win, double* ctl,",
        "    long long rows, double my) {",
        "  if (!ctl) return;",
        "  const long long cnt = (long long)M[ZB_MSG_OUT];",
        f"  long long n = (long long)ctl[{CTL_COUNT}];",
        "  for (long long k = 0; k < cnt; ++k) {",
        "    if (n < rows) {",
        f"      double* r = win + {WINDOW_ENT} * n;",
        "      r[0] = my;",
        "      for (int i = 0; i < ZB_MSG_ENT; ++i)",
        "        r[1 + i] = M[ZB_MSG_OUT + 1 + ZB_MSG_ENT * k + i];",
        "      ++n;",
        "    } else {",
        f"      ctl[{CTL_OVERFLOW}] += 1.0;",
        "    }",
        "  }",
        f"  ctl[{CTL_COUNT}] = (double)n;",
        "}",
        "",
    ]
    return out


def _team_function(p: BlockSectionProgram) -> List[str]:
    """zb_run_team: @block's phases (`DeviceSection.phases`), thread 0's
    code in ZB_SOLO, the block's in ZB_STEPS, then @slider where @block
    retriggered it, on thread 0."""
    lines = ["ZB_DEV void zb_run_team(ZB* S, ZT team, double* zp, "
             "long long* zq) {",
             "  (void)zp; (void)zq;"]
    solo = _team_phases(p.block.phases, lines, "  ")
    if p.slider is not None:
        a, b, c = p.pend_slots
        solo.append(
            f"if (S->V[{a}] + S->V[{b}] + S->V[{c}] != 0.0) {{ "
            f"{p.slider.fn_name}(S); S->V[{a}] = 0.0; S->V[{b}] = 0.0; "
            f"S->V[{c}] = 0.0; }}")
    if solo:
        lines += ["  // the ordered rest, on thread 0",
                  f"  ZB_SOLO(team, {' '.join(solo)});"]
    lines += ["}", ""]
    if p.probe:
        # thread 0's share alone, no block work and no barrier: the
        # ordered code's own time (a probe; the block phases' results are
        # not made, so the data the ordered code reads differs)
        lines += ["ZB_DEV void zb_run_solo(ZB* S, double* zp, long long* zq) {",
                  "  (void)zp; (void)zq;"]
        _solo_phases(p.block.phases, lines, "  ")
        lines += ["}", ""]
    return lines


def _team_phases(phases, lines: List[str], ind: str) -> List[str]:
    """The phases' text into `lines`: each block phase one ZB_SOLO (thread
    0's code since the last one, then its own) and its block step; a loop
    whose body holds block phases (a "while" or "repeat" phase) a loop
    every thread runs on thread 0's published decision, its next decision
    in the ZB_SOLO that ends each pass.  Returns thread 0's code left
    after the last block phase."""
    solo: List[str] = []
    for ph in phases:
        solo.append(ph.solo)
        if ph.kind == "serial":
            continue
        lines.append(f"{ind}// {ph.label}, across the block")
        lines.append(f"{ind}ZB_SOLO(team, {' '.join(solo)});")
        solo = []
        if ph.body:
            lines.append(f"{ind}while ({ph.test}) {{")
            rest = _team_phases(ph.body, lines, ind + "  ")
            rest.append(ph.again)
            lines.append(f"{ind}  ZB_SOLO(team, {' '.join(rest)});")
            lines.append(f"{ind}}}")
        else:
            lines.append(f"{ind}{ph.team}")
    return solo


def _solo_phases(phases, lines: List[str], ind: str) -> None:
    """Thread 0's code of the phases alone (the probe's `zb_run_solo`):
    each phase's share in braces, a loop phase's control as a loop."""
    for ph in phases:
        lines.append(f"{ind}{{ {ph.solo} }}")
        if ph.body:
            lines.append(f"{ind}while ({ph.test}) {{")
            _solo_phases(ph.body, lines, ind + "  ")
            lines.append(f"{ind}  {{ {ph.again} }}")
            lines.append(f"{ind}}}")


def barriers_a_launch(p: BlockSectionProgram,
                      team_barriers: Optional[int] = None) -> int:
    """__syncthreads() a file's block passes in one K10 launch, as
    `zb_kernel` and `_team_function` place them: the exchanges' (3, or 2
    with the var row in device memory), one after each of thread 0's
    runs, and each block phase's steps.  A section with a loop phase
    passes a number of barriers its run decides: give the phases' count
    of that run as `team_barriers` (`block_section_host`'s `barriers`)."""
    n = 3 if p.v_shared else 2
    if team_barriers is not None:
        return n + team_barriers
    if any(ph.body for ph in p.block.phases):
        raise ValueError("the section's loop phases pass barriers its run "
                         "decides: count them with block_section_host")
    solo = False
    for ph in p.block.phases:
        solo = True
        if ph.kind != "serial":
            n += 1 + ph.steps
            solo = False
    return n + int(solo or p.slider is not None)


def _probe_kernels(p: BlockSectionProgram, make_s: str, on_chip: List[str],
                   off_chip: List[str]) -> List[str]:
    """Timing probes (chip_smoke.py): the sections alone on one thread,
    `reps` times on file 0's view (its dependent chain with no exchange);
    and each transform the section calls, alone, at the heap's start, on
    one thread or in its block form.  Both keep the var row and workspace
    where the kernel keeps them."""
    calls = _fft_calls(p)
    head = ["  const long long f = 0, t = threadIdx.x, nt = blockDim.x;",
            "  unsigned long long* runs = nullptr;", *on_chip,
            "  double* M = bmem;", f"  {make_s}"]
    cases = []
    for i, (_label, one, block) in enumerate(calls):
        cases += [f"      case {2 * i}: if (t == 0) {one}; break;",
                  f"      case {2 * i + 1}: {block}; break;"]
    out = [
        "__global__ void zb_chain_kernel(double* bvars, double* bmem,",
        "    const double* midi_ev, double midi_n, double* scratch,",
        "    const double* tw, long long tw_n, double samplesblock,",
        "    long long reps) {",
        *head,
        "  for (long long r = 0; r < reps; ++r) zb_run(&S);",
        *off_chip,
        "}",
        "",
        "__global__ void zb_fft_probe_kernel(double* bvars, double* bmem,",
        "    double* scratch, const double* tw, long long tw_n, int which,",
        "    long long reps) {",
        "  const double* midi_ev = nullptr;",
        "  const double midi_n = 0.0, samplesblock = 0.0;",
        *head,
        "  const ZT team = {t, nt, 0};",
        "  for (long long r = 0; r < reps; ++r) {",
        "    switch (which) {",
        *cases,
        "      default: break;",
        "    }",
        "    __syncthreads();",
        "  }",
        *off_chip,
        "}",
        "",
        "__global__ void zb_solo_kernel(double* bvars, double* bmem,",
        "    const double* midi_ev, double midi_n, double* scratch,",
        "    const double* tw, long long tw_n, double samplesblock,",
        "    long long reps) {",
        *head,
        "  double zp[ZB_NP];",
        "  long long zq[ZB_NQ];",
        "  for (long long r = 0; r < reps; ++r) zb_run_solo(&S, zp, zq);",
        *off_chip,
        "}",
        "",
        "// what = 0: `reps` dependent f64 adds on one thread; 1: `reps`",
        "// barriers of a block of ZB_THREADS threads",
        "__global__ void zb_latency_kernel(double* out, double y, long long reps,",
        "                                  int what) {",
        "  double x = out[0];",
        "  if (what == 1) {",
        "    for (long long r = 0; r < reps; ++r) __syncthreads();",
        "  } else if (threadIdx.x == 0) {",
        "    for (long long r = 0; r < reps; ++r) x = x + y;",
        "  }",
        "  if (threadIdx.x == 0) out[0] = x;",
        "}",
        "",
        'extern "C" int block_section_latency(void* out, double y,',
        "    long long reps, int what, void* stream) {",
        "  zb_latency_kernel<<<1, what == 1 ? ZB_THREADS : 1, 0,",
        "                      static_cast<cudaStream_t>(stream)>>>(",
        "      static_cast<double*>(out), y, reps, what);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
        'extern "C" int block_section_chain(void* bvars, void* bmem,',
        "    const void* midi_ev, double midi_n, void* scratch, const void* tw,",
        "    long long tw_n, double samplesblock, long long reps, void* stream) {",
        "  if (ZB_SMEM > 48 * 1024)",
        "    cudaFuncSetAttribute(zb_chain_kernel,",
        "        cudaFuncAttributeMaxDynamicSharedMemorySize, ZB_SMEM);",
        "  zb_chain_kernel<<<1, 1, ZB_SMEM, static_cast<cudaStream_t>(stream)>>>(",
        "      static_cast<double*>(bvars), static_cast<double*>(bmem),",
        "      static_cast<const double*>(midi_ev), midi_n,",
        "      static_cast<double*>(scratch), static_cast<const double*>(tw),",
        "      tw_n, samplesblock, reps);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
        'extern "C" int block_section_solo(void* bvars, void* bmem,',
        "    const void* midi_ev, double midi_n, void* scratch, const void* tw,",
        "    long long tw_n, double samplesblock, long long reps, void* stream) {",
        "  if (ZB_SMEM > 48 * 1024)",
        "    cudaFuncSetAttribute(zb_solo_kernel,",
        "        cudaFuncAttributeMaxDynamicSharedMemorySize, ZB_SMEM);",
        "  zb_solo_kernel<<<1, 1, ZB_SMEM, static_cast<cudaStream_t>(stream)>>>(",
        "      static_cast<double*>(bvars), static_cast<double*>(bmem),",
        "      static_cast<const double*>(midi_ev), midi_n,",
        "      static_cast<double*>(scratch), static_cast<const double*>(tw),",
        "      tw_n, samplesblock, reps);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
        "// which = 2 i: transform i on one thread; 2 i + 1: its block form on",
        "// ZB_THREADS threads",
        'extern "C" int block_section_fft_probe(void* bvars, void* bmem,',
        "    void* scratch, const void* tw, long long tw_n, int which,",
        "    long long reps, void* stream) {",
        "  if (ZB_SMEM > 48 * 1024)",
        "    cudaFuncSetAttribute(zb_fft_probe_kernel,",
        "        cudaFuncAttributeMaxDynamicSharedMemorySize, ZB_SMEM);",
        "  zb_fft_probe_kernel<<<1, (which & 1) ? ZB_THREADS : 1, ZB_SMEM,",
        "                        static_cast<cudaStream_t>(stream)>>>(",
        "      static_cast<double*>(bvars), static_cast<double*>(bmem),",
        "      static_cast<double*>(scratch), static_cast<const double*>(tw),",
        "      tw_n, which, reps);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
    ]
    return out


def _fft_calls(p: BlockSectionProgram) -> List[Tuple[str, str, str]]:
    """The probe's (label, one-thread call, block call) triples: for each
    complex size n the section's tables serve, fft(n) and fft_real(2n),
    where the twiddle table and the heap are large enough."""
    calls = []
    for n in p.perm_sizes:
        if 2 * n <= p.fft_max and 2 * n <= p.mem_size:
            calls.append((f"fft_real({2 * n})",
                          f"zb_fft_real(&S, 0.0, {2 * n}, zb_perm_{n})",
                          f"zb_blk_fft_real(&S, 0, {2 * n}, zb_perm_{n}, team)"))
        if n <= p.fft_max and 2 * n <= p.mem_size:
            calls.append((f"fft({n})", f"zb_fft(&S, 0.0, {n}, zb_perm_{n})",
                          f"zb_blk_fft(&S, 0, {n}, zb_perm_{n}, team)"))
    return calls


def fft_probe_names(program: BlockSectionProgram) -> List[str]:
    """What each `which` of `block_section_fft_probe` runs."""
    return [label for label, _one, _block in _fft_calls(program)]


# -- the checks shared by every form ---------------------------------------------

def _check(program: BlockSectionProgram, svec, rings, bvars, bmem,
           stage: Optional[Stage] = None) -> int:
    nf = bvars.shape[0]
    dev = bvars.device
    want = [("svec", svec, (nf, program.n_svec)),
            ("bvars", bvars, (nf, program.n_vars)),
            ("bmem", bmem, (nf, program.total_mem))]
    if stage is not None:
        if not program.staged or nf != 1:
            raise ValueError("a stage takes one file of a program that uses "
                             "gmem or the message bus")
        if stage.gseg is not None:
            want.append(("gseg", stage.gseg, (program.gmem_cells,)))
        if stage.window is not None:
            if stage.ctl is None or stage.sub is None:
                raise ValueError("a ring window comes with its ctl and sub")
            want += [("window", stage.window,
                      (stage.window.shape[0], WINDOW_ENT)),
                     ("ctl", stage.ctl, (stage.ctl.shape[0],)),
                     ("sub", stage.sub, (stage.sub.shape[0],))]
            if not 0 <= stage.member < stage.ctl.shape[0] - CTL_CURSORS:
                raise ValueError(f"member {stage.member} has no cursor")
    if len(rings) != len(program.regions):
        raise ValueError(f"{len(rings)} rings for {len(program.regions)} "
                         "regions")
    want += [(f"ring {r}", a, (nf, r[1]))
             for r, a in zip(program.regions, rings)]
    for name, t, shape in want:
        if tuple(t.shape) != shape or t.dtype != torch.float64 \
                or t.device != dev:
            raise ValueError(f"{name} must be float64 {list(shape)} on {dev}, "
                             f"got {t.dtype} {list(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (updated in place)")
    return nf


def _midi_args(program, midi):
    """(events [k, 4] f64 or None, count) of this block's staged queue."""
    if midi is None or not program.uses_midi_in:
        return None, 0.0
    ev, n = midi
    return ev, float(n)


def block_section(program: BlockSectionProgram, svec: torch.Tensor,
                  rings: Sequence[torch.Tensor], bvars: torch.Tensor,
                  bmem: torch.Tensor, samplesblock: float, midi=None,
                  ctrl: Optional[torch.Tensor] = None,
                  mout: Optional[torch.Tensor] = None,
                  stage: Optional[Stage] = None):
    """One block of the coupled pipeline for nf files, in place.

    svec [nf, n_svec] and rings (one [nf, mod] a region, in
    `program.regions` order) are the sample side's carry; bvars [nf,
    n_vars] and bmem [nf, total_mem] the device view; all f64,
    contiguous, on one device, and all updated in place.  midi: (events
    [k, 4] f64 on the device, count) of this block's staged host queue,
    shared by the files, where the section calls midirecv.  Returns
    (ctrl [nf, n_ctrl], mout [nf, midi_out_cells] or None): the control
    row of the next segment and the block's MIDI out table (written into
    `ctrl` and `mout` where given).  stage: a graph's lockstep member's
    shared segment and ring window (one file; see `Stage`), updated in
    place.

    CUDA tensors go to the generated kernel, CPU tensors to the plain
    version; nothing falls back from one to the other.
    """
    global LAUNCHES
    nf = _check(program, svec, rings, bvars, bmem, stage)
    dev = bvars.device
    if ctrl is None:
        ctrl = torch.empty((nf, len(program.ctrl)), dtype=torch.float64,
                           device=dev)
    if mout is None and program.midi_out_cells:
        mout = torch.empty((nf, program.midi_out_cells), dtype=torch.float64,
                           device=dev)
    if dev.type == "cpu":
        block_section_plain(program, svec, rings, bvars, bmem, samplesblock,
                            midi, ctrl, mout, stage)
        return ctrl, mout
    if dev.type != "cuda":
        raise ValueError(f"block_section runs on cuda or cpu, not {dev}")
    _launch(program, "block_section_launch", svec, rings, bvars, bmem,
            samplesblock, midi, ctrl, mout, stage=stage)
    LAUNCHES += 1
    return ctrl, mout


def block_section_earlier(program: BlockSectionProgram, svec, rings, bvars,
                          bmem, samplesblock: float, midi=None, ctrl=None,
                          mout=None, stage: Optional[Stage] = None):
    """The earlier design of K10, in place as `block_section`: thread 0
    runs the whole section, the other threads wait at a barrier.  Needs a
    program made with `probe=True`; chip_smoke.py holds the kernel to it
    and times the two in turns.  Not a kernel of any path: LAUNCHES and
    the serial-run counter stay."""
    if not program.probe:
        raise ValueError("the earlier design is built with probe=True")
    nf = _check(program, svec, rings, bvars, bmem, stage)
    dev = bvars.device
    if dev.type != "cuda":
        raise ValueError("block_section_earlier takes CUDA tensors")
    if ctrl is None:
        ctrl = torch.empty((nf, len(program.ctrl)), dtype=torch.float64,
                           device=dev)
    if mout is None and program.midi_out_cells:
        mout = torch.empty((nf, program.midi_out_cells), dtype=torch.float64,
                           device=dev)
    _launch(program, "block_section_launch_earlier", svec, rings, bvars,
            bmem, samplesblock, midi, ctrl, mout, count=False, stage=stage)
    return ctrl, mout


def _stage_args(program, stage: Optional[Stage]) -> list:
    """A staged program's launch arguments after the head's (none for
    another program)."""
    if not program.staged:
        return []
    st = stage or Stage()

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    rows = 0 if st.window is None else st.window.shape[0]
    nmem = 0 if st.ctl is None else st.ctl.shape[0] - CTL_CURSORS
    nsub = 0 if st.sub is None else st.sub.shape[0]
    return [ptr(st.gseg), ptr(st.window), ptr(st.ctl), rows, nmem,
            int(st.member), int(bool(st.compact)), ptr(st.sub), nsub,
            float(st.my_id)]


# gseg, mwin, mctl; rows, members, member; compact; msub; nsub; my_id
_STAGE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double]


def _table_args(program, device) -> list:
    """A tabled program's staged tables (their addresses, by reference),
    none for another."""
    return [tables_arg(program.tables, device)] if program.tabled else []


def _launch(program, entry: str, svec, rings, bvars, bmem, samplesblock,
            midi, ctrl, mout, count: bool = True,
            stage: Optional[Stage] = None) -> None:
    dev = bvars.device
    ev, n_ev = _midi_args(program, midi)
    lib = _library(program.source, len(program.regions), program.staged,
                   program.tabled)
    tw = program.twiddles_on(dev)
    scratch = program.scratch_on(dev, bvars.shape[0])
    runs = _serial_counter(dev) if count else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            svec.data_ptr(), bvars.data_ptr(), bmem.data_ptr(),
            ctrl.data_ptr(), 0 if mout is None else mout.data_ptr(),
            0 if ev is None else ev.data_ptr(), n_ev, scratch.data_ptr(),
            tw.data_ptr(), max(program.fft_max, 2), float(samplesblock),
            bvars.shape[0], 0 if runs is None else runs.data_ptr(),
            *_stage_args(program, stage), *_table_args(program, dev), stream,
            *[r.data_ptr() for r in rings])
    if err != 0:
        raise RuntimeError(f"block_section kernel launch failed ({entry}): "
                           f"cudaError {err}")


def _device_key(device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _serial_counter(device: torch.device) -> torch.Tensor:
    key = _device_key(device)
    if key not in SERIAL_RUNS:
        SERIAL_RUNS[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return SERIAL_RUNS[key]


def serial_runs(device) -> int:
    """Block loops that K10 ran on thread 0 alone on `device` since the
    counter was made or zeroed (`zero_serial_runs`); reads the device, so
    it waits for the launches before it."""
    t = SERIAL_RUNS.get(_device_key(device))
    return 0 if t is None else int(t.item())


def zero_serial_runs() -> None:
    """Set every device's serial-run counter to 0."""
    for t in SERIAL_RUNS.values():
        t.zero_()


# svec, bvars, bmem, ctrl, mout, midi_ev; midi_n; scratch, tw; tw_n;
# samplesblock; nf; serial_runs
_HEAD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_double, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_double, ctypes.c_longlong,
                                      ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library(source: str, n_rings: int, staged: bool = False,
             tabled: bool = False) -> ctypes.CDLL:
    lib = _build.load_generated(source)
    entries = [lib.block_section_launch]
    if "block_section_launch_earlier" in source:
        entries.append(lib.block_section_launch_earlier)
    for fn in entries:
        fn.argtypes = _HEAD_ARGS + (_STAGE_ARGS if staged else []) + [
            ctypes.c_void_p] * (1 + n_rings + int(tabled))
        fn.restype = ctypes.c_int
    return lib


def block_section_host(program: BlockSectionProgram, svec, rings, bvars,
                       bmem, samplesblock: float, midi=None,
                       threads: int = 0, descending: bool = False,
                       stage: Optional[Stage] = None,
                       barriers: Optional[list] = None):
    """The generated source compiled for the CPU with a host C++ compiler
    (its host form), on CPU tensors, in place as `block_section`.  With
    `threads` = 0 it runs the one-thread form (`zb_run`, the earlier
    design's); else the kernel's phases with that many threads, each block
    step running the threads' shares one after another, in ascending t or,
    where `descending`, in descending t.  Shows without a GPU that the
    printed sections, their phases and exchanges repeat
    `block_section_plain` and each other; no render path calls it, and it
    leaves LAUNCHES alone.  Returns (ctrl, mout or None, block loops and
    copies run on thread 0).  Where `barriers` is a list, the barriers the
    phases of the launch's files passed (the card's __syncthreads() but
    the exchanges', `barriers_a_launch`) are appended to it."""
    nf = _check(program, svec, rings, bvars, bmem, stage)
    if bvars.device.type != "cpu":
        raise ValueError("block_section_host takes CPU tensors")
    if isinstance(threads, bool) or not isinstance(threads, int) \
            or threads < 0:
        raise ValueError(f"threads must be an int >= 0, got {threads!r}")
    lib = _build.load_generated_host(program.source)
    fn = lib.block_section_host
    lib.zb_host_barrier_count.restype = ctypes.c_longlong
    passed = lib.zb_host_barrier_count()
    fn.argtypes = _HEAD_ARGS + (_STAGE_ARGS if program.staged else []) + [
        ctypes.c_void_p] * int(program.tabled) + [
        ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_void_p] * len(program.regions)
    fn.restype = ctypes.c_int
    ctrl = torch.empty((nf, len(program.ctrl)), dtype=torch.float64)
    mout = torch.empty((nf, max(program.midi_out_cells, 1)),
                       dtype=torch.float64)
    ev, n_ev = _midi_args(program, midi)
    ev = None if ev is None else ev.contiguous()
    scratch = torch.zeros((nf, program.scratch_cells), dtype=torch.float64)
    tw = torch.from_numpy(program.twiddles.copy())
    runs = torch.zeros(1, dtype=torch.int64)
    fn(svec.data_ptr(), bvars.data_ptr(), bmem.data_ptr(), ctrl.data_ptr(),
       mout.data_ptr(), 0 if ev is None else ev.data_ptr(), n_ev,
       scratch.data_ptr(), tw.data_ptr(), max(program.fft_max, 2),
       float(samplesblock), nf, runs.data_ptr(),
       *_stage_args(program, stage), *_table_args(program, "cpu"), threads,
       int(descending),
       *[r.data_ptr() for r in rings])
    if barriers is not None:
        barriers.append(lib.zb_host_barrier_count() - passed)
    return ctrl, (mout if program.midi_out_cells else None), int(runs)


def block_section_chain_probe(program: BlockSectionProgram, bvars, bmem,
                              samplesblock: float, reps: int, midi=None,
                              ordered_only: bool = False):
    """Timing probe (chip_smoke.py): the sections alone on one thread,
    `reps` times on file 0's view, which they change.  Its time a rep is
    the section's dependent chain with no exchange.  Where `ordered_only`,
    thread 0's share of the phases alone (no block phase runs): the
    ordered code's time.  Needs a program made with `probe=True`; not a
    kernel of any path, so LAUNCHES stays."""
    if not program.probe or bvars.device.type != "cuda":
        raise ValueError("a probe program and CUDA tensors are needed")
    lib = _library(program.source, len(program.regions))
    entry = lib.block_section_solo if ordered_only else \
        lib.block_section_chain
    entry.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_double, ctypes.c_longlong,
        ctypes.c_void_p]
    entry.restype = ctypes.c_int
    ev, n_ev = _midi_args(program, midi)
    dev = bvars.device
    with torch.cuda.device(dev):
        err = entry(
            bvars.data_ptr(), bmem.data_ptr(),
            0 if ev is None else ev.data_ptr(), n_ev,
            program.scratch_on(dev, 1).data_ptr(),
            program.twiddles_on(dev).data_ptr(), max(program.fft_max, 2),
            float(samplesblock), int(reps),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_section chain probe failed: cudaError {err}")


def block_section_fft_probe(program: BlockSectionProgram, bvars, bmem,
                            which: int, reps: int, block: bool = False):
    """Timing probe (chip_smoke.py): transform `which` of
    `fft_probe_names(program)` alone, `reps` times, on the start of file
    0's heap (which it overwrites): on one thread, or where `block` in its
    block form on the build's threads."""
    if not program.probe or bmem.device.type != "cuda":
        raise ValueError("a probe program and CUDA tensors are needed")
    lib = _library(program.source, len(program.regions))
    lib.block_section_fft_probe.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.block_section_fft_probe.restype = ctypes.c_int
    dev = bmem.device
    with torch.cuda.device(dev):
        err = lib.block_section_fft_probe(
            bvars.data_ptr(), bmem.data_ptr(),
            program.scratch_on(dev, 1).data_ptr(),
            program.twiddles_on(dev).data_ptr(), max(program.fft_max, 2),
            2 * int(which) + int(bool(block)), int(reps),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_section FFT probe failed: cudaError {err}")


def block_section_latency_probe(program: BlockSectionProgram, out,
                                reps: int, barriers: bool = False):
    """Timing probe (chip_smoke.py): `reps` dependent f64 adds on one
    thread into out[0] (a CUDA f64 tensor), or, where `barriers`, `reps`
    barriers of a block of the build's threads.  Its time a rep is the
    latency the ordered chain and the phases' barriers pay."""
    if not program.probe or out.device.type != "cuda":
        raise ValueError("a probe program and a CUDA tensor are needed")
    lib = _library(program.source, len(program.regions))
    lib.block_section_latency.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.block_section_latency.restype = ctypes.c_int
    with torch.cuda.device(out.device):
        err = lib.block_section_latency(
            out.data_ptr(), 1.0e-9, int(reps), int(bool(barriers)),
            torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_section latency probe failed: cudaError "
                           f"{err}")


# -- the plain version -------------------------------------------------------------

def block_section_plain(program: BlockSectionProgram, svec, rings, bvars,
                        bmem, samplesblock: float, midi=None, ctrl=None,
                        mout=None, stage: Optional[Stage] = None):
    """Plain version: the exchanges in torch, and for each file the
    sections through the port's Python golden (`shadow/pyexec.py`) on a
    ShadowState built from the file's slots and heap row, with the device
    heap's addressing (clamped addresses, runs and FFT regions inside the
    heap), and the host calls of gmem and the bus as K10 makes them
    (`_StagedHost`); a stage's prologue and epilogue as the kernel runs
    them.  In place, as `block_section`; CPU tensors."""
    nf = _check(program, svec, rings, bvars, bmem, stage)
    if ctrl is None:
        ctrl = torch.empty((nf, len(program.ctrl)), dtype=torch.float64)
    if mout is None and program.midi_out_cells:
        mout = torch.empty((nf, program.midi_out_cells), dtype=torch.float64)
    if program.inter:
        sv_i = torch.tensor([a for a, _b in program.inter])
        sl_i = torch.tensor([b for _a, b in program.inter])
        bvars[:, sl_i] = svec[:, sv_i]
    for (o, m), r in zip(program.regions, rings):
        bmem[:, o:o + m] = r
    mo = program.midi_out_base
    bmem[:, mo:mo + program.midi_out_cells] = 0.0
    if program.uses_midi_in:
        bvars[:, program.pos_slot] = 0.0
    for a, addr in program.cells:
        bmem[:, addr] = svec[:, a]
    events = []
    if midi is not None and program.uses_midi_in:
        ev, n = midi
        events = ev.detach().cpu().numpy()[:int(n)].tolist()
    block_fn, slider_fn = _plain_functions(program)
    st = stage or Stage()
    for f in range(nf):
        row = bmem[f].numpy()
        if program.uses_msg:
            _msg_begin_plain(program, row, st)
        gmem = None
        if program.uses_gmem:
            gmem = st.gseg.numpy() if st.gseg is not None else \
                row[program.gmem_base:program.gmem_base + program.gmem_cells]
        _plain_file(program, block_fn, slider_fn, bvars[f], bmem[f],
                    float(samplesblock), events, gmem)
        if program.uses_msg:
            _msg_end_plain(program, row, st)
    if program.inter:
        svec[:, sv_i] = bvars[:, sl_i]
    for (o, m), r in zip(program.regions, rings):
        r.copy_(bmem[:, o:o + m])
    for a, addr in program.cells:
        svec[:, a] = bmem[:, addr]
    for i, (kind, at) in enumerate(program.ctrl):
        ctrl[:, i] = bmem[:, at] if kind == "m" else bvars[:, at]
    if mout is not None:
        mout.copy_(bmem[:, mo:mo + program.midi_out_cells])
    return ctrl, mout


def _msg_begin_plain(program, M: np.ndarray, stage: Stage) -> None:
    """The staged prologue (`zb_msg_begin`) on a heap row."""
    M[program.msg_out_base] = 0.0
    if stage.ctl is None:
        return
    win, ctl = stage.window.numpy(), stage.ctl.numpy()
    cur = ctl[CTL_CURSORS:]
    if stage.compact:
        m, n = int(cur.min()), int(ctl[CTL_COUNT])
        if m > 0:
            win[:n - m] = win[m:n].copy()
            ctl[CTL_COUNT] = float(n - m)
            ctl[CTL_COMPACTED] += float(m)
            cur -= float(m)
    n = int(ctl[CTL_COUNT])
    sub = stage.sub.numpy()
    queues = dict(sorted(program.msg_queues.items()))
    for g in range(int(cur[stage.member]), n):
        e = win[g]
        c = int(e[3])
        if e[1] > 0.5:
            hit = 0 <= c < len(sub) and sub[c] != 0.0 and e[0] != stage.my_id
        else:
            hit = e[2] == stage.my_id
        qb = queues.get(c)
        if not hit or qb is None:
            continue
        if M[qb + 1] < MSG_QUEUE_CAP:
            pos = M[qb] + M[qb + 1]
            if pos >= MSG_QUEUE_CAP:
                pos -= MSG_QUEUE_CAP
            r = qb + 2 + MSG_QENT * int(pos)
            M[r:r + MSG_QENT] = (e[0], e[4], e[5], e[6], e[7], e[8])
            M[qb + 1] += 1.0
        else:
            M[program.msg_in_base] += 1.0
    cur[stage.member] = float(n)


def _msg_end_plain(program, M: np.ndarray, stage: Stage) -> None:
    """The staged epilogue (`zb_msg_end`) on a heap row."""
    if stage.ctl is None:
        return
    win, ctl = stage.window.numpy(), stage.ctl.numpy()
    base = program.msg_out_base
    n = int(ctl[CTL_COUNT])
    for k in range(int(M[base])):
        if n < win.shape[0]:
            win[n, 0] = stage.my_id
            win[n, 1:] = M[base + 1 + MSG_ENT * k:base + 1 + MSG_ENT * (k + 1)]
            n += 1
        else:
            ctl[CTL_OVERFLOW] += 1.0
    ctl[CTL_COUNT] = float(n)


class _StagedHost(HostServices):
    """The golden's host calls of gmem and the bus as K10 makes them, for
    the plain version: gmem is the golden's own (HostServices on the
    state's `gmem`, the shared segment or the heap's window; attaching is
    a no-op), and a lone instance's bus is HostServices' (inert)."""

    def __init__(self, sec: DeviceSection, M: np.ndarray):
        super().__init__()
        self.sec, self.M = sec, M
        self.comm = getattr(sec.snap, "host", None)
        self.instance_id_value = float(getattr(self.comm, "instance_id_value",
                                               0.0))
        # the file, pool, string and clock calls: the snapshot host's
        services = plain_host(self.comm)
        if services is not None:
            for name in ("file_call", "file_var_read", "file_riff_read",
                         "sample_pool_call", "sample_read2",
                         "sample_preview_read", "sample_name", "now",
                         "strlen", "str_getchar"):
                setattr(self, name, getattr(services, name))

    def gmem_attach(self, st, handle) -> float:
        return 0.0 if self.sec.comm_solo else 1.0

    def gmem_attach_size(self, st, handle, size) -> float:
        return self.gmem_attach(st, handle)


class _StagedBus(_StagedHost):
    """A lockstep member's: its sends go into the heap row's OUT table,
    its receives pop the row's queues, and the topology is read from its
    frozen InstanceComm."""

    def msg_dropped(self, st, chan) -> float:
        return self.comm.msg_dropped(st, chan)

    def msg_peer_count(self, st, chan, role) -> float:
        return self.comm.msg_peer_count(st, chan, role)

    def msg_peer_id(self, st, chan, role, idx) -> float:
        return self.comm.msg_peer_id(st, chan, role, idx)

    def msg_peer_caps(self, st, peer) -> float:
        return self.comm.msg_peer_caps(st, peer)

    def msg_peer_alive(self, st, peer) -> float:
        return self.comm.msg_peer_alive(st, peer)

    def _cid(self, st, chan) -> int:
        text = st.string_for_handle(chan)
        name = text if text is not None else repr(float(chan))
        return self.sec.msg_cfg.chan_ids[name]

    def _out(self, bc, dest, cid, vals) -> None:
        M, base = self.M, self.sec.msg_out_base
        n = int(M[base])
        if n < MSG_OUT_CAP:
            r = base + 1 + MSG_ENT * n
            M[r:r + MSG_ENT] = [bc, dest, float(cid)] + [float(v) for v in vals]
            M[base] = float(n + 1)
        else:
            M[self.sec.msg_in_base] += 1.0

    def msg_send(self, st, chan, tag, a, b, c, d) -> float:
        self._out(1.0, 0.0, self._cid(st, chan), (tag, a, b, c, d))
        return 1.0

    def msg_sendto(self, st, dest, chan, tag, a, b, c, d) -> float:
        try:
            dest_i = int(dest)
        except (ValueError, OverflowError):
            return 0.0
        self._out(0.0, float(dest_i), self._cid(st, chan), (tag, a, b, c, d))
        return 1.0

    def _queue(self, st, chan) -> int:
        return self.sec.msg_queues[self._cid(st, chan)]

    def msg_recv(self, st, chan):
        M, qb = self.M, self._queue(st, chan)
        cnt = M[qb + 1]
        if not cnt > 0.0:
            return None
        h = int(M[qb])
        nh = M[qb] + 1.0
        M[qb] = 0.0 if nh >= MSG_QUEUE_CAP else nh
        M[qb + 1] = cnt - 1.0
        r = qb + 2 + MSG_QENT * h
        return tuple(float(v) for v in M[r:r + MSG_QENT])

    def msg_avail(self, st, chan) -> float:
        return float(self.M[self._queue(st, chan) + 1])

    def msg_kind(self, st, chan) -> float:
        return 1.0 if self.msg_avail(st, chan) > 0.0 else 0.0

    def msg_length(self, st, chan) -> float:
        return 4.0 if self.msg_avail(st, chan) > 0.0 else 0.0

    def msg_clear(self, st, chan) -> float:
        M, qb = self.M, self._queue(st, chan)
        cnt = float(M[qb + 1])
        M[qb] = math.fmod(M[qb] + cnt, float(MSG_QUEUE_CAP))
        M[qb + 1] = 0.0
        return cnt


def _plain_file(program, block_fn, slider_fn, v_row, m_row,
                samplesblock: float, events, gmem=None) -> None:
    from ..shadow.state import MidiEvent

    sec = program.block
    st = program._plain_state.clone()
    host = st.host
    if program.staged:
        host = _StagedBus if program.uses_msg else _StagedHost
        st.host = host(sec, m_row.numpy())
        st.gmem = gmem if gmem is not None else np.zeros(0)
    vals = v_row.tolist()
    masks = ("pending_change_mask", "pending_automate_mask",
             "pending_automate_end_mask")
    for key, slot in sec.slots.items():
        _put(st, key, vals[slot], masks)
    st.mem = m_row[:program.mem_size].numpy()   # shares the row
    st.mem_used = program.mem_size
    st.samplesblock = samplesblock
    st.midi_in = [MidiEvent(int(e[0]), int(e[1]), int(e[2]), int(e[3]))
                  for e in events]
    st.midi_in_pos = int(vals[program.pos_slot])
    st.midi_out = []
    if not program.staged:
        st.host = plain_host(host)
    block_fn(st)
    if slider_fn is not None and (st.pending_change_mask
                                  or st.pending_automate_mask
                                  or st.pending_automate_end_mask):
        if not program.staged:
            st.host = plain_host(host)
        slider_fn(st)
        st.pending_change_mask = 0
        st.pending_automate_mask = 0
        st.pending_automate_end_mask = 0
    out = list(vals)
    for key, slot in sec.slots.items():
        got = _get(st, key, masks)
        if got is not None:
            out[slot] = got
    out[program.pos_slot] = float(st.midi_in_pos) if program.uses_midi_in \
        else vals[program.pos_slot]
    v_row.copy_(torch.tensor(out, dtype=torch.float64))
    if program.midi_out_cells:
        table = np.zeros(program.midi_out_cells)
        sent = st.midi_out[:MIDI_OUT_CAP]
        table[0] = float(len(sent))
        for k, ev in enumerate(sent):
            table[1 + 4 * k:5 + 4 * k] = (ev.offset, ev.b1, ev.b2, ev.b3)
        mo = program.midi_out_base
        m_row[mo:mo + program.midi_out_cells] = torch.from_numpy(table)


def _put(st, key, v: float, masks) -> None:
    kind = key[0]
    if kind == "var" and key[1] in PENDING_SLOT_NAMES:
        setattr(st, masks[PENDING_SLOT_NAMES.index(key[1])],
                int(max(0.0, v)) if v == v else 0)
    elif kind == "var":
        st.V[key[1]] = v
    elif kind == "spl":
        st.spl[key[1]] = v
    elif kind == "slider":
        st.sliders[key[1]] = v


def _get(st, key, masks):
    kind = key[0]
    if kind == "var" and key[1] in PENDING_SLOT_NAMES:
        return float(getattr(st, masks[PENDING_SLOT_NAMES.index(key[1])]))
    if kind == "var":
        return float(st.V.get(key[1], 0.0))
    if kind == "spl":
        return float(st.spl[key[1]])
    if kind == "slider":
        return float(st.sliders[key[1]])
    return None   # params: the C functions take them as arguments


def _plain_functions(program: BlockSectionProgram):
    """(@block, @slider or None) compiled by pyexec with the device heap's
    addressing in place of the golden's growable heap."""
    if program._plain_fns is None:
        from ..shadow import pyexec as PX

        P = program.block.P
        ns = PX._exec_namespace(P)
        ns.update(_device_heap_helpers())
        for spec_name, proto in P.fn_defs.items():
            PX._compile_callable(P, ns, PX._py_fn_name(spec_name),
                                 proto.params, [proto.body], return_last=True)
        fns = [PX._compile_callable(P, ns,
                                    f"jsfx_{s.section.replace('-', '_')}",
                                    (), s.body, return_last=False)
               if s is not None else None
               for s in (program.block, program.slider)]
        program._plain_fns = tuple(fns)
        # the frozen state the sections read; each file brings its heap row
        program._plain_state = program.block.snap.clone()
        program._plain_state.mem = np.zeros(1)
    return program._plain_fns


def _device_heap_helpers():
    """pyexec's heap helpers with `csrc/block_ops.cuh`'s addressing: the
    heap is the state's fixed row (len(S.mem) = mem_size)."""
    from ..semantics import scalar as SC
    from ..shadow import pyexec as PX

    def addr(S, base, idx):
        return min(SC.mem_address(base, idx), len(S.mem) - 1)

    def mget(S, base, idx):
        return float(S.mem[addr(S, base, idx)])

    def mset(S, val, base, idx):
        S.mem[addr(S, base, idx)] = val
        return val

    def mrmw(S, rhs, base, idx, op):
        a = addr(S, base, idx)
        out = PX._COMPOUND[op](float(S.mem[a]), rhs)
        S.mem[a] = out
        return out

    def run(S, x, length):
        n = min(max(0, SC.trunc_i64(length)), len(S.mem))
        return min(SC.blob_address(x), len(S.mem) - n), n

    def memset(S, dest, value, length):
        d, n = run(S, dest, length)
        S.mem[d:d + n] = value
        return dest

    def memcpy(S, dest, src, length):
        d, n = run(S, dest, length)
        s, _n = run(S, src, length)
        S.mem[d:d + n] = S.mem[s:s + n].copy()
        return dest

    def inside(S, base, span):
        return FO._same_page(base, span) and base + span <= len(S.mem)

    def fft_call(S, which, a0, a1):
        n = FO._round_index(a1)
        if not FO._pow2_ok(n):
            return 0.0
        span = n if which in ("fft_real", "ifft_real") else 2 * n
        if not inside(S, max(0, FO._round_index(a0)), span):
            return 0.0
        return FO.dispatch(S, which, a0, a1)

    def convolve_c(S, dest, src, size):
        n = FO._round_index(size)
        if n <= 0 or n > FO.PAGE_DOUBLES // 2:
            return 0.0
        if not (inside(S, max(0, FO._round_index(dest)), 2 * n)
                and inside(S, max(0, FO._round_index(src)), 2 * n)):
            return 0.0
        return FO.convolve_c(S, dest, src, size)

    return {"_mget": mget, "_mset": mset, "_mrmw": mrmw, "_maddr": addr,
            "_memset": memset, "_memcpy": memcpy, "_fft_call": fft_call,
            "_convolve_c": convolve_c}
