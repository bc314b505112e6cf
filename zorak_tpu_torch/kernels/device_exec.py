"""The sequential device executor's render: K11 + its plain version.

Replaces the fused XLA program of the reference's sequential executor
(`DeviceExecKernel._make_run`, zorak_tpu/lowering/devexec.py:491-586): an
outer scan over the host's blocks, then @block, then the pending-mask
@slider retrigger, then an inner scan of @sample over the block's samples.
Plain torch for that work would pay several launches for every sample, so
the whole render is one generated kernel.

On a CUDA tensor `device_exec` launches it: a CUDA block of one warp a
file, whose lanes stage the file's var row and its heap's first
PAGE_CELLS cells in shared memory and whose lane 0 runs the whole
render, block after block, through the sections that `lowering/devgen.py`
prints as C (`DeviceSection.body_source`, with the reduced heap's
addressing and the staged draw pool of `csrc/block_ops.cuh`), inlined.
On a CPU tensor it runs `device_exec_plain`: for each file the port's
Python golden (`shadow/pyexec.py`) with the same heap, pool and block
loop, its file, sample-pool, string and clock calls answered by the
snapshot's host (`runtime/services.py` EngineHost).  Nothing falls back
from one to the other.  The host services' tables (`lowering/devgen.py`
HostTables: the loaded pool's generation, file_mem's chunks, the string
literals) are staged once a render (`kernels/host_tables.py`) and read by
every file.  `device_exec_host` runs
the generated text compiled with a host C++ compiler, for the tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .host_tables import tables_arg
from ..lowering.devgen import (
    MEM_HIWATER_SLOT, MIDI_OUT_CAP, MIDI_POS_SLOT, PAGE_CELLS,
    PENDING_SLOT_NAMES, RAND_POS_SLOT, DeviceSection)
from ..runtime import fftops as FO

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0

# Threads of a CUDA block of K11: one warp, one file.
THREADS = 32

# Shared memory a block takes without opting in; a plugin whose var row
# does not fit beside the heap's page there takes dynamic shared memory,
# up to SMEM_OPT_IN (decided when the text is printed).
SMEM_STATIC = 48 * 1024
SMEM_OPT_IN = 227 * 1024

_DESIGN = """\
// K11 device_exec: replaces the fused XLA program of the reference's
// sequential executor (zorak_tpu/lowering/devexec.py:491-586 _make_run:
// a scan over blocks of @block, the @slider retrigger and a scan of
// @sample over the block's samples).
//
// What bounds it: one thread's dependent chain of f64 operations and
// loads through every @sample step of the render, one sample after
// another; the bytes (the audio in and out, the heap cells the sections
// touch) are far less.
//
// What the design does: one file a CUDA block of one warp.  The lanes
// stage the file's var row and its heap's first ZX_PAGE cells into shared
// memory, coalesced; lane 0 runs the whole render over them; the lanes
// write both back.  Every section and helper is inlined into the kernel,
// so the view (ZX, csrc/block_ops.cuh) lives in registers, the var row
// is reached through its own __restrict__ pointer (nothing the heap does
// aliases it), and the high-water mark is a register stored to its slot
// at each block's end.  For each block lane 0 clears the MIDI position and
// the MIDI out table where they are used, runs @block, runs @slider where
// a pending mask is set (and clears the masks), then runs @sample over the
// block's samples: each f32 input widened into its spl slot, the body, the
// spl slot rounded to f32 on output.  The remainder block's length is an
// argument, and so are the heap's size, the gmem window's base and cells
// (the row past the heap, read and written in device memory) and the row
// strides: one build serves every length and every rung of the ladder.
// A file whose reduced heap overflowed (its high water at or past the
// heap) stops at the end of that block, its row and page written back:
// the executor discards the render and replays it on a larger heap.
"""


# The section probe: the same text built again with ZX_PROBE defined
# (`section_probe`, chip_smoke.py).  clock64() around each section call and
# the sample loop's I/O, summed a file into cycles[f * PROBE_SLOTS + k]:
# @block, @slider, @sample, the I/O, the whole render.
PROBE_SLOTS = 5
PROBE_NAMES = ("block", "slider", "sample", "io", "render")
_PROBE_MACROS = """\
#if defined(ZX_PROBE) && defined(__CUDA_ARCH__)
#define ZX_CYCLES unsigned long long zc[4] = {0, 0, 0, 0}; \\
  const long long zt_all = clock64();
#define ZX_TICK(t) const long long t = clock64();
#define ZX_TOCK(k, t) zc[k] += (unsigned long long)(clock64() - t);
#define ZX_FLUSH { for (int k = 0; k < 4; ++k) cycles[f * 5 + k] = zc[k]; \\
  cycles[f * 5 + 4] = (unsigned long long)(clock64() - zt_all); }
#else
#define ZX_CYCLES
#define ZX_TICK(t)
#define ZX_TOCK(k, t)
#define ZX_FLUSH
#endif
"""

# The links the latency probe times, each a dependent chain on one thread:
# an f64 add, an f64 sin (with its add), a shared-memory load, a global
# load that hits L1 and one that hits L2 (a pointer chase through
# CHASE_CELLS cells), and a heap read through K11's accessor (zx_rmget,
# the chase in the on-chip page: the address and the load).
LINKS = ("add", "sin", "shared", "l1", "l2", "heap")
CHASE_CELLS = 1024


class DeviceExecProgram:
    """K11's generated source for one plugin: its @sample section and,
    where the plugin has them, @block and @slider (DeviceSections over one
    slot table and heap, made with `reduced_heap`).

    nch   the channels of the render (spl0 ... spl{nch-1} in and out);
    B     the host's block size (samples a full block).
    """

    def __init__(self, sample: DeviceSection,
                 block: Optional[DeviceSection] = None,
                 slider: Optional[DeviceSection] = None,
                 nch: int = 1, block_size: int = 512):
        secs = [s for s in (block, slider, sample) if s is not None]
        for s in secs:
            if not s.reduced_heap:
                raise ValueError(f"@{s.section} is not a reduced-heap section")
            if s.slots != sample.slots or s.total_mem != sample.total_mem \
                    or s.mem_size != sample.mem_size:
                raise ValueError("the sections must share slots and heap")
        if slider is not None and block is None:
            raise ValueError("@slider reruns only after @block")
        if any(s.tables is not sample.tables for s in secs):
            raise ValueError("the sections must share their tables")
        self.tables = sample.tables
        self.sample, self.block, self.slider = sample, block, slider
        self.nch = int(nch)
        self.B = int(block_size)
        if not 1 <= self.nch <= 64 or self.B < 1:
            raise ValueError(f"nch {nch} and block size {block_size}")
        self.n_vars = sample.n_vars
        self.mem_size = sample.mem_size
        self.total_mem = sample.total_mem
        # the heap row, the reference's: [heap | gmem window | MIDI out]
        self.gmem_base, self.gmem_cells = sample.gmem_base, sample.gmem_cells
        self.midi_out_base = sample.midi_out_base
        self.midi_out_cells = sample.midi_out_cells
        self.uses_midi_in = block is not None and block.uses_midi_in
        self.uses_rand = any(s.uses_rand for s in secs)
        self.spl_slots = [sample.slots[("spl", c)] for c in range(self.nch)]
        self.pend_slots = [sample.slots[("var", nm)]
                           for nm in PENDING_SLOT_NAMES]
        self.pos_slot = sample.slots[("var", MIDI_POS_SLOT)]
        self.hw_slot = sample.slots[("var", MEM_HIWATER_SLOT)]
        self.fft_max = max(s.fft_max for s in secs)
        self.scratch_cells = max(1, max(s.scratch_cells for s in secs))
        self.perm_sizes = sorted({n for s in secs for n in s.perm_sizes})
        # a block's shared memory: the var row and the heap's first page
        self.smem_bytes = 8 * (self.n_vars + PAGE_CELLS)
        if self.smem_bytes > SMEM_OPT_IN:
            raise ValueError(f"{self.n_vars} var slots do not fit in shared "
                             f"memory beside the heap's page "
                             f"({self.smem_bytes} > {SMEM_OPT_IN} bytes)")
        self.dynamic_smem = self.smem_bytes > SMEM_STATIC
        self.source = _emit_source(self)
        n = max(self.fft_max, 2)
        ang = 2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
        self.twiddles = np.stack([np.cos(ang), np.sin(ang)], axis=1).reshape(-1)
        self._tables: Dict[str, torch.Tensor] = {}
        self._plain_fns = None
        self._plain_state = None

    def rows(self, T: int) -> Tuple[int, int, int]:
        """(full blocks, remainder, blocks) of a render of T samples."""
        nfull, rem = divmod(int(T), self.B)
        return nfull, rem, nfull + (1 if rem else 0)

    def twiddles_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(self.twiddles.copy()).to(device)
        return self._tables[key]


def _c_table(name: str, values: Sequence[int], ctype: str = "long long") -> str:
    vals = ", ".join(str(int(v)) for v in values) or "0"
    return f"ZB_DEV const {ctype} {name}[] = {{{vals}}};"


def _emit_source(p: DeviceExecProgram) -> str:  # noqa: C901 (one file)
    """K11's text: the sections, one file's render (`zx_file`), the warp's
    staging, the kernel and its launcher, and for a host compiler the files
    one after another.  Nothing in it depends on the heap's size."""
    secs = [s for s in (p.block, p.slider, p.sample) if s is not None]
    functions: Dict[str, str] = {}
    for s in secs:
        for name, text in s.functions.items():
            if functions.setdefault(name, text) != text:
                raise ValueError(f"{name} prints differently in two sections")
    out = [
        _DESIGN,
        f"#define ZX_PAGE {PAGE_CELLS}",
        "#define ZB_FORCE_INLINE",
        '#include "block_ops.cuh"',
        "",
        "#ifdef __CUDACC__",
        "#define ZB_DEV static __device__",
        "#define ZX_DEV static __device__ __forceinline__",
        "#else",
        "#define ZB_DEV static",
        "#define ZX_DEV static inline",
        "#endif",
        "",
        f"#define ZX_NCH {p.nch}",
        f"#define ZX_B {p.B}",
        f"#define ZX_MO_CELLS {p.midi_out_cells}",
        f"#define ZX_HW {p.hw_slot}",
        f"#define ZX_NV {p.n_vars}",
        f"#define ZX_DYN {int(p.dynamic_smem)}   // the row and page in "
        "dynamic shared memory",
        f"#define ZX_SMEM {p.smem_bytes}",
        "",
        _PROBE_MACROS,
        "// the host-service tables of a launch (zero where it passes none)",
        "static ZH zx_tables(const void* p) {",
        "  ZH z = {};",
        "  if (p) z = *static_cast<const ZH*>(p);",
        "  return z;",
        "}",
    ]
    for n in p.perm_sizes:
        out.append(_c_table(f"zb_perm_{n}", FO.perm_table(n), "int"))
    out.append(_c_table("zx_spl", p.spl_slots))
    out.append("")
    out += [text.split(" {", 1)[0] + ";" for text in functions.values()]
    out += list(functions.values())
    out += [s.body_source for s in secs]
    blk: List[str] = []
    if p.midi_out_cells:
        blk.append("    for (long long i = 0; i < ZX_MO_CELLS; ++i) "
                   "M[mo + i] = 0.0;   // the block's MIDI out table")
    if p.block is not None:
        if p.uses_midi_in:
            blk += [f"    V[{p.pos_slot}] = 0.0;   // a fresh host queue a block",
                    "    S.midi_ev = mev + b * mk * 4;",
                    "    S.midi_n = mn[b];"]
        blk.append(f"    ZX_TICK(zt_b) {p.block.fn_name}(&S, V); ZX_TOCK(0, zt_b)")
        if p.slider is not None:
            a, b, c = p.pend_slots
            blk += ["    // @block retriggered @slider: run it, clear the masks",
                    f"    if (V[{a}] + V[{b}] + V[{c}] != 0.0) {{",
                    f"      ZX_TICK(zt_r) {p.slider.fn_name}(&S, V); "
                    "ZX_TOCK(1, zt_r)",
                    f"      V[{a}] = 0.0; V[{b}] = 0.0; V[{c}] = 0.0;",
                    "    }"]
    mout = []
    if p.midi_out_cells:
        mout = ["    for (long long i = 0; i < ZX_MO_CELLS; ++i)",
                "      mout[(f * rows + b) * ZX_MO_CELLS + i] = M[mo + i];"]
    args = ("const float* x, float* y, double* bvars, double* bmem, "
            "double* mout, const double* mev, const double* mn, long long mk, "
            "const double* pool, long long pool_n, double* scratch, "
            "long long scratch_n, const double* tw, long long tw_n, "
            "long long T, long long nfull, long long rem, long long mem_size, "
            "long long gmem_base, long long gmem_cells, long long total_mem, "
            "ZH zh")
    names = ("x, y, bvars, bmem, mout, mev, mn, mk, pool, pool_n, scratch, "
             "scratch_n, tw, tw_n, T, nfull, rem, mem_size, gmem_base, "
             "gmem_cells, total_mem, zh")
    casts = [
        "static_cast<const float*>(x), static_cast<float*>(y),",
        "static_cast<double*>(bvars), static_cast<double*>(bmem),",
        "static_cast<double*>(mout), static_cast<const double*>(mev),",
        "static_cast<const double*>(mn), mk, static_cast<const double*>(pool),",
        "pool_n, static_cast<double*>(scratch), scratch_n,",
        "static_cast<const double*>(tw), tw_n, T, nfull, rem, mem_size,",
        "gmem_base, gmem_cells, total_mem, zx_tables(tables),"]
    c_args = ("const void* x, void* y, void* bvars, void* bmem, void* mout, "
              "const void* mev, const void* mn, long long mk, const void* pool, "
              "long long pool_n, void* scratch, long long scratch_n, "
              "const void* tw, long long tw_n, long long T, long long nfull, "
              "long long rem, long long mem_size, long long gmem_base, "
              "long long gmem_cells, long long total_mem, long long nf, "
              "const void* tables")
    out += [
        "",
        "// One file's whole render on lane 0 of its warp, over the warp's",
        "// copies of its var row V and its heap's first page P; returns 1",
        "// where the heap overflowed.",
        "ZX_DEV int zx_file(long long f, double* __restrict__ V, "
        f"double* __restrict__ P, {args}, unsigned long long* cycles) {{",
        "  (void)bvars; (void)mev; (void)mn; (void)mk; (void)mout; (void)cycles;",
        "  ZX_CYCLES",
        "  double* M = bmem + f * total_mem;",
        "  const long long mo = gmem_base + gmem_cells;   // the MIDI out table",
        "  (void)mo;",
        "  ZX S = {P, M, mem_size, mem_size < ZX_PAGE ? mem_size : ZX_PAGE, mo,",
        "          (double)ZX_B, nullptr, 0.0, scratch + f * scratch_n, tw, tw_n,",
        "          pool, pool_n, (long long)V[ZX_HW], M + gmem_base, gmem_cells};",
        "  S.H = zh;",
        "  const long long rows = nfull + (rem > 0 ? 1 : 0);",
        "  const float* xf = x + f * ZX_NCH * T;",
        "  float* yf = y + f * ZX_NCH * T;",
        "  for (long long b = 0; b < rows; ++b) {",
        "    const long long n = b < nfull ? ZX_B : rem;",
        "    S.samplesblock = (double)n;",
        *blk,
        "    for (long long i = 0; i < n; ++i) {",
        "      const long long t = b * ZX_B + i;",
        "      ZX_TICK(zt_i)",
        "      for (int c = 0; c < ZX_NCH; ++c) V[zx_spl[c]] = (double)xf[c * T + t];",
        "      ZX_TOCK(3, zt_i) ZX_TICK(zt_s)",
        f"      {p.sample.fn_name}(&S, V);",
        "      ZX_TOCK(2, zt_s) ZX_TICK(zt_o)",
        "      for (int c = 0; c < ZX_NCH; ++c) yf[c * T + t] = (float)V[zx_spl[c]];",
        "      ZX_TOCK(3, zt_o)",
        "    }",
        *mout,
        "    // the high water's slot, where the overflow check reads it; a",
        "    // dropped write: the render is discarded and replayed",
        "    V[ZX_HW] = (double)S.hw;",
        "    if (S.hw >= mem_size) { ZX_FLUSH return 1; }",
        "  }",
        "  ZX_FLUSH",
        "  return 0;",
        "}",
        "",
        "// The warp's copies of file f's var row and heap page, lane `lane` of",
        "// `lanes` a strided share: in at the file's start (the page's cells",
        "// past a small heap 0), out at its end or its overflow stop.",
        "ZX_DEV void zx_stage_in(long long f, double* V, double* P, "
        "const double* bvars,",
        "                        const double* M, long long pn, long long lane,",
        "                        long long lanes) {",
        "  for (long long i = lane; i < ZX_NV; i += lanes) V[i] = bvars[f * ZX_NV + i];",
        "  for (long long i = lane; i < ZX_PAGE; i += lanes) P[i] = i < pn ? M[i] : 0.0;",
        "}",
        "ZX_DEV void zx_stage_out(long long f, const double* V, const double* P,",
        "                         double* bvars, double* M, long long pn,",
        "                         long long lane, long long lanes) {",
        "  for (long long i = lane; i < ZX_NV; i += lanes) bvars[f * ZX_NV + i] = V[i];",
        "  for (long long i = lane; i < pn; i += lanes) M[i] = P[i];",
        "}",
        "",
        "#ifdef __CUDACC__",
        "",
        "// a file a block of one warp: the lanes stage, lane 0 renders",
        f"__global__ void __launch_bounds__({THREADS}) zx_kernel({args}, "
        "unsigned long long* cycles) {",
        "#if ZX_DYN",
        "  extern __shared__ double zx_sh[];",
        "  double* const zV = zx_sh;",
        "  double* const zP = zx_sh + ZX_NV;",
        "#else",
        "  __shared__ double zV[ZX_NV];",
        "  __shared__ double zP[ZX_PAGE];",
        "#endif",
        "  const long long f = blockIdx.x, lane = threadIdx.x;",
        "  double* M = bmem + f * total_mem;",
        "  const long long pn = mem_size < ZX_PAGE ? mem_size : ZX_PAGE;",
        f"  zx_stage_in(f, zV, zP, bvars, M, pn, lane, {THREADS});",
        "  __syncwarp();",
        f"  if (lane == 0) zx_file(f, zV, zP, {names}, cycles);",
        "  __syncwarp();",
        f"  zx_stage_out(f, zV, zP, bvars, M, pn, lane, {THREADS});",
        "}",
        "",
        "// a probe of the chain bound: `reps` dependent links of one kind on",
        "// one thread (LINKS: 0 an f64 add, 1 an f64 sin and its add, 2 a shared",
        "// load, 3 a global load that hits L1, 4 one that hits L2, 5 a heap read",
        "// through zx_rmget from the page)",
        "__global__ void zx_latency_kernel(double* out, double y, long long reps,",
        "                                  int link, const long long* chase) {",
        f"  __shared__ long long zs[{CHASE_CELLS}];",
        f"  __shared__ double zh[{CHASE_CELLS}];",
        f"  if (link == 2) for (int i = 0; i < {CHASE_CELLS}; ++i) zs[i] = chase[i];",
        f"  if (link == 5) for (int i = 0; i < {CHASE_CELLS}; ++i) zh[i] = (double)chase[i];",
        f"  const ZX S = {{zh, nullptr, {CHASE_CELLS}, {CHASE_CELLS}, {CHASE_CELLS}, 0.0,",
        "                nullptr, 0.0, nullptr, nullptr, 0, nullptr, 0, 0};",
        "  double v = out[0], d = 0.0;",
        "  long long i = 0;",
        "  if (link == 5) for (long long r = 0; r < reps; ++r) d = zx_rmget(&S, d, 0.0);",
        "  if (link == 0) for (long long r = 0; r < reps; ++r) v = v + y;",
        "  if (link == 1) for (long long r = 0; r < reps; ++r) v = sin(v + 1.0);",
        "  if (link == 2) for (long long r = 0; r < reps; ++r) i = zs[i];",
        "  if (link == 3) for (long long r = 0; r < reps; ++r) i = __ldca(chase + i);",
        "  if (link == 4) for (long long r = 0; r < reps; ++r) i = __ldcg(chase + i);",
        "  out[0] = v + d + (double)i;",
        "}",
        "",
        'extern "C" int device_exec_latency(void* out, double y, long long reps,',
        "                                   int link, const void* chase,",
        "                                   void* stream) {",
        "  zx_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(",
        "      static_cast<double*>(out), y, reps, link,",
        "      static_cast<const long long*>(chase));",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
        "// the dynamic shared memory the kernel takes (0 for the static row",
        "// and page), opted in above 48 KB",
        "static int zx_dyn_bytes() {",
        "  if (!ZX_DYN) return 0;",
        "  cudaFuncSetAttribute(zx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,",
        "                       ZX_SMEM);",
        "  return ZX_SMEM;",
        "}",
        "",
        "// what the card makes of the kernel: its registers, its shared memory",
        "// a block and the blocks an SM holds at once",
        'extern "C" int device_exec_occupancy(int* regs, long long* smem,',
        "                                     int* blocks) {",
        "  cudaGetLastError();",
        "  const int dyn = zx_dyn_bytes();",
        "  cudaFuncAttributes a;",
        "  cudaFuncGetAttributes(&a, zx_kernel);",
        "  *regs = a.numRegs;",
        "  *smem = static_cast<long long>(a.sharedSizeBytes) + dyn;",
        f"  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, zx_kernel, {THREADS},",
        "                                                dyn);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
        f'extern "C" int device_exec_launch({c_args}, void* cycles,',
        "                                  void* stream) {",
        "  cudaGetLastError();  // clear an error left by an earlier call",
        "  if (nf <= 0) return 0;",
        "  if (nf > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);",
        "  const int dyn = zx_dyn_bytes();",
        f"  zx_kernel<<<static_cast<unsigned>(nf), {THREADS}, dyn,",
        "              static_cast<cudaStream_t>(stream)>>>(",
        *(f"      {c}" for c in casts),
        "      static_cast<unsigned long long*>(cycles));",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
        "#else  // a host compiler: the files one after another, as a warp would",
        "",
        "// the reduced heap's addresses, for the tests",
        'extern "C" long long device_exec_raddr(double base, double idx) {',
        "  return zx_raddr(base, idx);",
        "}",
        'extern "C" long long device_exec_raddr_k(double base, long long k) {',
        "  return zx_raddr_k(base, k);",
        "}",
        "",
        f'extern "C" int device_exec_host({c_args}) {{',
        "  double zV[ZX_NV], zP[ZX_PAGE];",
        "  double* B = static_cast<double*>(bvars);",
        "  for (long long f = 0; f < nf; ++f) {",
        "    double* M = static_cast<double*>(bmem) + f * total_mem;",
        "    const long long pn = mem_size < ZX_PAGE ? mem_size : ZX_PAGE;",
        "    zx_stage_in(f, zV, zP, B, M, pn, 0, 1);",
        "    zx_file(f, zV, zP,",
        *(f"            {c}" for c in casts),
        "            nullptr);",
        "    zx_stage_out(f, zV, zP, B, M, pn, 0, 1);",
        "  }",
        "  return 0;",
        "}",
        "",
        "#endif",
        "",
    ]
    return "\n".join(out)


# -- the checks shared by every form -----------------------------------------------

def _check(program: DeviceExecProgram, x, bvars, bmem, pool) -> Tuple[int, int]:
    """(files, samples) after checking the shapes, types and devices."""
    if x.dim() != 3 or x.dtype != torch.float32 or x.shape[1] != program.nch:
        raise ValueError(f"x must be float32 [files, {program.nch}, T], got "
                         f"{x.dtype} {list(x.shape)}")
    nf, _, T = x.shape
    dev = x.device
    for name, t, shape in (("bvars", bvars, (nf, program.n_vars)),
                           ("bmem", bmem, (nf, program.total_mem))):
        if tuple(t.shape) != shape or t.dtype != torch.float64 \
                or t.device != dev:
            raise ValueError(f"{name} must be float64 {list(shape)} on {dev}, "
                             f"got {t.dtype} {list(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (updated in place)")
    if program.uses_rand:
        if pool is None or pool.dim() != 1 or pool.numel() < 1 \
                or pool.dtype != torch.float64 or pool.device != dev:
            raise ValueError(f"a float64 draw pool on {dev} is needed")
    return nf, T


def _midi(program: DeviceExecProgram, midi, rows: int, dev):
    """(events [rows, K, 4], counts [rows], K) of the staged host queue, or
    empty stand-ins where the plugin reads no MIDI."""
    if program.uses_midi_in and midi is not None:
        mev, mn = midi
        if mev.shape[0] != rows or mn.shape != (rows,) or mev.shape[2] != 4:
            raise ValueError(f"MIDI planes {list(mev.shape)}, {list(mn.shape)}"
                             f" for {rows} blocks")
        return (mev.to(dev, torch.float64).contiguous(),
                mn.to(dev, torch.float64).contiguous(), int(mev.shape[1]))
    z = torch.zeros((max(rows, 1), 1, 4), dtype=torch.float64, device=dev)
    return z, torch.zeros(max(rows, 1), dtype=torch.float64, device=dev), 1


def device_exec(program: DeviceExecProgram, x: torch.Tensor,
                bvars: torch.Tensor, bmem: torch.Tensor,
                pool: Optional[torch.Tensor] = None, midi=None):
    """One render of nf files.

    x [nf, nch, T] float32 is the input; bvars [nf, n_vars] and bmem [nf,
    total_mem] (float64, contiguous) are each file's var row and heap row,
    updated in place; pool [cap] float64 is the staged draw pool every file
    reads (each keeps its own cursor), where the plugin draws rand(); midi
    is (events [blocks, K, 4], counts [blocks]) of the host's queue, shared
    by the files.  Returns (y [nf, nch, T] float32, MIDI out tables [nf,
    blocks, cells] or None).  One file a CUDA block of one warp.

    CUDA tensors go to the generated kernel, CPU tensors to the plain
    version; nothing falls back from one to the other.
    """
    global LAUNCHES
    nf, T = _check(program, x, bvars, bmem, pool)
    dev = x.device
    if dev.type == "cpu":
        nfull, rem, rows = program.rows(T)
        mout = (torch.zeros((nf, rows, program.midi_out_cells),
                            dtype=torch.float64)
                if program.midi_out_cells else None)
        y = device_exec_plain(program, x, bvars, bmem, pool, midi, mout)
        return y, mout
    if dev.type != "cuda":
        raise ValueError(f"device_exec runs on cuda or cpu, not {dev}")
    y, mout = _launch(program, _library(program.source), x, bvars, bmem,
                      pool, midi, None)
    LAUNCHES += 1
    return y, mout


def section_probe(program: DeviceExecProgram, x, bvars, bmem, pool=None,
                  midi=None) -> torch.Tensor:
    """Timing probe (chip_smoke.py): `device_exec` on CUDA tensors through
    the text built again with ZX_PROBE defined; returns the clock64()
    cycles a file spent in each of PROBE_NAMES, [nf, PROBE_SLOTS] int64.
    Not a kernel of any path, so LAUNCHES stays."""
    nf, _T = _check(program, x, bvars, bmem, pool)
    if x.device.type != "cuda":
        raise ValueError("the section probe takes CUDA tensors")
    cycles = torch.zeros((nf, PROBE_SLOTS), dtype=torch.int64,
                         device=x.device)
    _launch(program, _library(probe_source(program)), x, bvars, bmem, pool,
            midi, cycles)
    return cycles


def probe_source(program: DeviceExecProgram) -> str:
    return "#define ZX_PROBE\n" + program.source


def _launch(program, lib, x, bvars, bmem, pool, midi, cycles):
    nf, T = x.shape[0], x.shape[2]
    dev = x.device
    nfull, rem, rows = program.rows(T)
    mout = (torch.zeros((nf, rows, program.midi_out_cells),
                        dtype=torch.float64, device=dev)
            if program.midi_out_cells else None)
    y = torch.empty_like(x)
    mev, mn, mk = _midi(program, midi, rows, dev)
    if pool is None:
        pool = torch.zeros(1, dtype=torch.float64, device=dev)
    scratch = torch.zeros((nf, program.scratch_cells), dtype=torch.float64,
                          device=dev)
    tw = program.twiddles_on(dev)
    x = x.contiguous()
    with torch.cuda.device(dev):
        err = lib.device_exec_launch(
            x.data_ptr(), y.data_ptr(), bvars.data_ptr(), bmem.data_ptr(),
            0 if mout is None else mout.data_ptr(), mev.data_ptr(),
            mn.data_ptr(), mk, pool.data_ptr(), pool.numel(),
            scratch.data_ptr(), program.scratch_cells, tw.data_ptr(),
            max(program.fft_max, 2), T, nfull, rem, program.mem_size,
            program.gmem_base, program.gmem_cells, program.total_mem, nf,
            _tables(program, dev),
            0 if cycles is None else cycles.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"device_exec kernel launch failed: cudaError {err}")
    return y, mout


# x, y, bvars, bmem, mout, mev, mn; mk; pool; pool_n; scratch; scratch_n;
# tw; tw_n, T, nfull, rem, mem_size, gmem_base, gmem_cells, total_mem, nf;
# tables
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_void_p]
         + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])


def _tables(program: DeviceExecProgram, device):
    """The program's host-service tables staged on `device` (once a
    render: a later launch, file or rung reuses them), by reference, or
    None where no printed call reads them."""
    return tables_arg(program.tables, device) if program.tables.used \
        else None


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    lib = _build.load_generated(source)
    lib.device_exec_launch.argtypes = _ARGS + [ctypes.c_void_p,
                                               ctypes.c_void_p]
    lib.device_exec_launch.restype = ctypes.c_int
    return lib


def occupancy(program: DeviceExecProgram) -> Dict[str, int]:
    """What the card makes of K11's kernel (chip_smoke.py): its registers
    a thread, its shared memory a block and the blocks an SM holds."""
    lib = _library(program.source)
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    smem = ctypes.c_longlong(0)
    lib.device_exec_occupancy.argtypes = [ctypes.c_void_p] * 3
    lib.device_exec_occupancy.restype = ctypes.c_int
    err = lib.device_exec_occupancy(ctypes.byref(regs), ctypes.byref(smem),
                                    ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"device_exec occupancy query failed: cudaError "
                           f"{err}")
    return {"registers": regs.value, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}


def chase_table(seed: int = 0) -> np.ndarray:
    """One cycle through CHASE_CELLS cells in a seeded order: next[i]."""
    order = np.random.RandomState(seed).permutation(CHASE_CELLS)
    out = np.empty(CHASE_CELLS, dtype=np.int64)
    out[order] = np.roll(order, -1)
    return out


def latency_probe(program: DeviceExecProgram, out: torch.Tensor,
                  reps: int, link: str = "add",
                  chase: Optional[torch.Tensor] = None) -> None:
    """Timing probe (chip_smoke.py): `reps` dependent links of one kind
    (LINKS) on one thread into out[0] (a CUDA f64 tensor); its time a rep
    is the latency of one link of K11's dependent chain.  The loads chase
    `chase` (a CUDA int64 `chase_table`).  Not a kernel of any path, so
    LAUNCHES stays."""
    if out.device.type != "cuda":
        raise ValueError("the latency probe takes a CUDA tensor")
    if link not in LINKS:
        raise ValueError(f"link is one of {LINKS}, not {link!r}")
    if chase is None or chase.device != out.device \
            or chase.dtype != torch.int64 or chase.numel() != CHASE_CELLS:
        raise ValueError(f"chase must be {CHASE_CELLS} int64 on {out.device}")
    lib = _library(program.source)
    lib.device_exec_latency.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                        ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.device_exec_latency.restype = ctypes.c_int
    with torch.cuda.device(out.device):
        err = lib.device_exec_latency(
            out.data_ptr(), 1.0e-9, int(reps), LINKS.index(link),
            chase.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"device_exec latency probe failed: cudaError {err}")


def build(programs: Sequence[DeviceExecProgram],
          probes: Sequence[DeviceExecProgram] = ()) -> Dict[str, str]:
    """Build the programs' kernels and the probe builds of `probes` (one
    nvcc each, all started together) before their first launch; returns
    nvcc's log by source text."""
    return _build.build_generated([p.source for p in programs]
                                  + [probe_source(p) for p in probes])


def device_exec_host(program: DeviceExecProgram, x, bvars, bmem, pool=None,
                     midi=None):
    """The generated source compiled for the CPU with a host C++ compiler
    (its host form), on CPU tensors, in place as `device_exec`: shows
    without a GPU that the printed sections and the block loop repeat
    `device_exec_plain`.  No render path calls it, and it leaves LAUNCHES
    alone.  Returns (y, MIDI out tables or None)."""
    nf, T = _check(program, x, bvars, bmem, pool)
    if x.device.type != "cpu":
        raise ValueError("device_exec_host takes CPU tensors")
    fn = _build.load_generated_host(program.source).device_exec_host
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    nfull, rem, rows = program.rows(T)
    y = torch.empty_like(x)
    mout = torch.zeros((nf, rows, max(program.midi_out_cells, 1)),
                       dtype=torch.float64)
    mev, mn, mk = _midi(program, midi, rows, x.device)
    pool = torch.zeros(1, dtype=torch.float64) if pool is None \
        else pool.contiguous()
    scratch = torch.zeros((nf, program.scratch_cells), dtype=torch.float64)
    tw = torch.from_numpy(program.twiddles.copy())
    x = x.contiguous()
    fn(x.data_ptr(), y.data_ptr(), bvars.data_ptr(), bmem.data_ptr(),
       mout.data_ptr(), mev.data_ptr(), mn.data_ptr(), mk, pool.data_ptr(),
       pool.numel(), scratch.data_ptr(), program.scratch_cells, tw.data_ptr(),
       max(program.fft_max, 2), T, nfull, rem, program.mem_size,
       program.gmem_base, program.gmem_cells, program.total_mem, nf,
       _tables(program, "cpu"))
    return y, (mout if program.midi_out_cells else None)


# -- the plain version ---------------------------------------------------------------

class _PoolDraws:
    """rand() of the plain version: the staged pool at the cursor slot,
    as `zb_rand` draws it (the state's `rng`)."""

    def __init__(self, pool: np.ndarray, state):
        self.pool, self.state = pool, state

    def rand(self, limit: float = 1.0) -> float:
        V = self.state.V
        c = V[RAND_POS_SLOT]          # a count of draws: a whole number
        i = min(max(int(c), 0), len(self.pool) - 1)
        V[RAND_POS_SLOT] = c + 1.0
        top = float(np.floor(limit))
        if not top >= 1.0:
            top = 1.0
        return float(self.pool[i]) * (1.0 / 4294967295.0) * top


def device_exec_plain(program: DeviceExecProgram, x, bvars, bmem, pool=None,
                      midi=None, mout=None):
    """Plain version: for each file the sections through the port's Python
    golden (`shadow/pyexec.py`) on a ShadowState built from the file's
    slots and heap row, with the reduced heap's addressing and the staged
    pool's draws, block after block as the kernel runs them.  In place,
    as `device_exec`; CPU tensors.  Returns y."""
    nf, T = _check(program, x, bvars, bmem, pool)
    nfull, rem, rows = program.rows(T)
    fns = _plain_functions(program)
    xs = x.numpy()
    y = np.zeros(xs.shape, dtype=np.float32)
    pool_np = None if pool is None else pool.numpy()
    events: List[list] = [[] for _ in range(rows)]
    if midi is not None and program.uses_midi_in:
        mev, mn = midi
        mev, mn = mev.cpu().numpy(), mn.cpu().numpy()
        events = [mev[b, :int(mn[b])].tolist() for b in range(rows)]
    masks = ("pending_change_mask", "pending_automate_mask",
             "pending_automate_end_mask")
    sec = program.sample
    for f in range(nf):
        st = program._plain_state.clone()
        vals = bvars[f].tolist()
        for key, slot in sec.slots.items():
            _put(st, key, vals[slot], masks)
        m_row = bmem[f]
        st.mem = m_row[:program.mem_size].numpy()     # shares the row
        st.mem_used = program.mem_size
        g0 = program.gmem_base
        st.gmem = m_row[g0:g0 + program.gmem_cells].numpy()   # the window
        if pool_np is not None:
            st.rng = _PoolDraws(pool_np, st)
        _plain_file(program, fns, st, xs[f], y[f], events, nfull, rem,
                    m_row, None if mout is None else mout[f])
        out = list(vals)
        for key, slot in sec.slots.items():
            got = _get(st, key, masks)
            if got is not None:
                out[slot] = got
        out[program.pos_slot] = float(st.midi_in_pos) \
            if program.uses_midi_in else vals[program.pos_slot]
        bvars[f] = torch.tensor(out, dtype=torch.float64)
    return torch.from_numpy(y)


def _plain_file(program, fns, st, xf, yf, events, nfull, rem, m_row,
                mout) -> None:
    from ..shadow.state import MidiEvent
    from .block_section import _StagedHost

    block_fn, slider_fn, sample_fn = fns
    B, nch = program.B, program.nch
    mo = program.midi_out_base
    spl = st.spl
    sec = program.sample

    def run(fn) -> None:
        # the host calls as the printed text makes them (gmem on the
        # state's window, a lone instance's bus inert), and the file API
        # from no file open, as each print of a section folds it
        st.host = _StagedHost(sec, None)
        fn(st)
    for b in range(nfull + (1 if rem else 0)):
        n = B if b < nfull else rem
        st.samplesblock = float(n)
        st.midi_out = []            # the kernel clears the table a block
        if block_fn is not None:
            if program.uses_midi_in:
                st.midi_in = [MidiEvent(int(e[0]), int(e[1]), int(e[2]),
                                        int(e[3])) for e in events[b]]
                st.midi_in_pos = 0
            run(block_fn)
            if slider_fn is not None and (st.pending_change_mask
                                          or st.pending_automate_mask
                                          or st.pending_automate_end_mask):
                run(slider_fn)
                st.pending_change_mask = 0
                st.pending_automate_mask = 0
                st.pending_automate_end_mask = 0
        t0 = b * B
        for i in range(n):
            for c in range(nch):
                spl[c] = float(xf[c, t0 + i])
            run(sample_fn)
            for c in range(nch):
                yf[c, t0 + i] = np.float32(spl[c])
        if program.midi_out_cells:
            table = np.zeros(program.midi_out_cells)
            sent = st.midi_out[:MIDI_OUT_CAP]
            table[0] = float(len(sent))
            for k, ev in enumerate(sent):
                table[1 + 4 * k:5 + 4 * k] = (ev.offset, ev.b1, ev.b2, ev.b3)
            m_row[mo:mo + program.midi_out_cells] = torch.from_numpy(table)
            if mout is not None:
                mout[b] = torch.from_numpy(table)
        if st.V[MEM_HIWATER_SLOT] >= mo:
            return


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


def _plain_functions(program: DeviceExecProgram):
    """(@block or None, @slider or None, @sample) compiled by pyexec with
    the reduced heap's addressing in place of the golden's growable heap."""
    if program._plain_fns is None:
        from ..shadow import pyexec as PX

        P = program.sample.P
        ns = PX._exec_namespace(P)
        ns.update(_reduced_heap_helpers())
        for spec_name, proto in P.fn_defs.items():
            PX._compile_callable(P, ns, PX._py_fn_name(spec_name),
                                 proto.params, [proto.body], return_last=True)
        program._plain_fns = tuple(
            PX._compile_callable(P, ns, f"jsfx_{s.section}", (), s.body,
                                 return_last=False)
            if s is not None else None
            for s in (program.block, program.slider, program.sample))
        program._plain_state = program.sample.snap.clone()
        program._plain_state.mem = np.zeros(1)
    return program._plain_fns


def _reduced_heap_helpers():
    """pyexec's heap helpers with `csrc/block_ops.cuh`'s reduced heap: the
    heap is the state's fixed row (len(S.mem) = mem_size); dynamic reads
    past it give 0, writes there drop, and every dynamic write raises the
    high-water var to its address."""
    from ..semantics import scalar as SC
    from ..shadow import pyexec as PX

    def mark(S, a):
        if S.V[MEM_HIWATER_SLOT] < float(a):
            S.V[MEM_HIWATER_SLOT] = float(a)

    def mget(S, base, idx):
        a = SC.mem_address(base, idx)
        return float(S.mem[a]) if a < len(S.mem) else 0.0

    def mset(S, val, base, idx):
        a = SC.mem_address(base, idx)
        mark(S, a)
        if a < len(S.mem):
            S.mem[a] = val
        return val

    def mrmw(S, rhs, base, idx, op):
        a = SC.mem_address(base, idx)
        cur = float(S.mem[a]) if a < len(S.mem) else 0.0
        out = PX._COMPOUND[op](cur, rhs)
        mark(S, a)
        if a < len(S.mem):
            S.mem[a] = out
        return out

    def maddr(S, base, idx):
        return min(SC.mem_address(base, idx), len(S.mem) - 1)

    def run(S, v, length):
        n = min(max(0, SC.trunc_i64(length)), len(S.mem))
        return min(SC.blob_address(v), len(S.mem) - n), n

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
        if not FO._same_page(base, span):
            return False
        if base + span <= len(S.mem):
            return True
        mark(S, base + span - 1)
        return False

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

    return {"_mget": mget, "_mset": mset, "_mrmw": mrmw, "_maddr": maddr,
            "_memset": memset, "_memcpy": memcpy, "_fft_call": fft_call,
            "_convolve_c": convolve_c}


# -- the chain bound ---------------------------------------------------------------

# rand() counts its floor and two multiplies; every other builtin call one
# (a libm call counts one, which keeps the count a lower bound)
_RAND_OPS = 3
# the libm's calls (priced as a link of kind "libm" by sample_chain_ops)
_LIBM = frozenset({"sin", "cos", "tan", "asin", "acos", "atan", "atan2",
                   "exp", "log", "log10", "pow", "sqrt"})


def sample_chain_ops(program: DeviceExecProgram,
                     trips: Optional[Dict[str, float]] = None,
                     cost: Optional[Dict[str, float]] = None) -> float:
    """The dependent f64 operations on the longest path through one
    @sample step, counted on the section's syntax tree, which
    `DeviceSection.body_source` prints one to one: an arithmetic or
    comparison operator, a compound assignment and a builtin call each add
    one link, a heap address (base + index + 1e-5) two, rand() three; a
    load, a store, a select and a branch add none (each arm is followed,
    the longer kept).  A value from an earlier step starts at depth 0.
    `loop(n, ...)` runs its body trips[n] times where n is a var named in
    `trips` (the run's mean count a sample: what this run's data needs),
    its constant count otherwise, else once; a fractional mean
    interpolates between its floor and the next count.  A lower bound:
    nothing on the longest path can overlap.

    `cost` prices the links instead ({"op": ..., "libm": ..., "load":
    ...}, e.g. ns each): an operation, a libm call, and a heap load (a
    heap read, and the read of a compound assignment to the heap), which
    the count leaves at 0."""
    w = {"op": 1.0, "libm": 1.0, "load": 0.0}
    w.update(cost or {})
    from ..frontend.astnodes import (
        Asn, Bin, Block, CallExpr, Cond, Const, IfStmt, LoopExpr, Mem, Name,
        Str, Un, WhileStmt)

    trips = dict(trips or {})
    P = program.sample.P
    fracs = [t - np.floor(t) for t in trips.values()]
    frac = float(np.mean(fracs)) if fracs else 0.0

    def step(up: int) -> float:
        deepest = [0.0]

        def note(d: float) -> float:
            deepest[0] = max(deepest[0], d)
            return d

        def count(n) -> int:
            if isinstance(n, Name) and n.ident in trips:
                return int(np.floor(trips[n.ident])) + up
            if isinstance(n, Const):
                return max(0, int(n.value))
            return 1

        def addr(m, env) -> float:
            return max(ex(m.base, env), ex(m.index, env)) + 2 * w["op"]

        def ex(n, env) -> float:  # noqa: C901 (one dispatch)
            if n is None or isinstance(n, (Const, Str)):
                return 0.0
            if isinstance(n, Name):
                return env.get(n.ident, 0.0)
            if isinstance(n, Mem):
                return note(addr(n, env) + w["load"])
            if isinstance(n, Un):
                d = ex(n.operand, env)
                return note(d if n.op == "+" else d + w["op"])
            if isinstance(n, Bin):
                return note(max(ex(n.lhs, env), ex(n.rhs, env)) + w["op"])
            if isinstance(n, Asn):
                v = ex(n.value, env)
                if isinstance(n.target, Mem) and n.op == "=":
                    note(addr(n.target, env))
                if n.op != "=":
                    v = max(v, ex(n.target, env)) + w["op"]
                if isinstance(n.target, Name):
                    env[n.target.ident] = v
                return note(v)
            if isinstance(n, CallExpr):
                args = [ex(a, env) for a in n.args]
                if n.func in P.fn_defs:
                    proto = P.fn_defs[n.func]
                    inner = dict(env)
                    inner.update(zip(proto.params, args))
                    d = ex(proto.body, inner)
                    env.update({k: v for k, v in inner.items()
                                if k not in proto.params})
                    return note(d)
                link = (_RAND_OPS * w["op"] if n.func == "rand"
                        else w["libm"] if n.func in _LIBM else w["op"])
                return note(max(args, default=0.0) + link)
            if isinstance(n, (Cond, IfStmt)):
                ex(n.pred, env)
                arms = []
                for arm in (n.then, n.other):
                    e = dict(env)
                    arms.append((ex(arm, e), e))
                for k in set(arms[0][1]) | set(arms[1][1]):
                    env[k] = max(arms[0][1].get(k, 0.0),
                                 arms[1][1].get(k, 0.0))
                return max(arms[0][0], arms[1][0])
            if isinstance(n, Block):
                d = 0.0
                for it in n.items:
                    d = ex(it, env)
                return d
            if isinstance(n, LoopExpr):
                d = 0.0
                for _ in range(count(n.count)):
                    d = ex(n.body, env)
                return d
            if isinstance(n, WhileStmt):
                d = 0.0
                for _ in range(int(trips.get("while", 1))):
                    ex(n.pred, env)
                    d = ex(n.body, env)
                return d
            return 0.0

        env: Dict[str, float] = {}
        for st in program.sample.body:
            ex(st, env)
        return deepest[0]

    lo = step(0)
    return lo + frac * (step(1) - lo) if frac else lo
