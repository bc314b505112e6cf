"""CUDA C++ text for one level of sequential scan groups.

Counterpart of the `lax.scan` body that the reference builds a DAG level
of scan groups into (zorak_tpu/lowering/specialize.py, `solve_scan_group`).
`solve_scan_group` of this package lowers the level to a step list; this
module prints that list as a source file: pure text, no torch, no compiler.
The design of the kernels it prints is in the comment at the top of each
generated file (`_DESIGN`).

The step list
    steps  [(kind, op, meta, args)], in evaluation order; kind is "bin",
           "call", "select" or "normloop"; an operand is ("c", float) a
           constant, ("x", j) external j of this sample, ("p", i) carry i
           as the last sample left it, ("s", k) the value of step k;
    outs   one operand a carry: its value after this sample.

Per sample t the generated code reads xs[t, :], evaluates the steps with
the operations of `csrc/scan_ops.cuh` (the scalar EEL2 semantics, which
the plain Python loop of `kernels/scan_group.py` also uses), writes
ys[t, :] = outs and carries them to t + 1.

The carries are split into independent components (carries that share no
step and read none of each other's values: a stereo plugin's left and
right envelope), and each component is scanned on its own blocks.

The same file holds, for a host compiler (`g++ -x c++`, no CUDA), the same
bodies under the same two phases, run one chunk after another, which is
how the CPU tests run them.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

Operand = Tuple[str, object]
Step = Tuple[str, str, Dict, Sequence[Operand]]

# The most samples whose externals a walking thread holds in registers at
# once (the next block's loads are in flight while this block's steps
# run); a block takes at most 4 x this many f64 registers, so a component
# with more than four externals holds fewer samples.  16 read best for one
# and two externals on an H100 (`chip_smoke.py --phases k4sweep`).
MAX_UNROLL = 16

# The speculate kernel stages the externals through shared memory where a
# level has at most this many external streams, and loads them in register
# blocks above it: on an H100 staging read faster with one stream and
# slower with two or three (`chip_smoke.py --phases k4sweep` times both).
STAGE_MAX_EXT = 1
# Chunk records the fix-up loads into shared memory at once (fewer where
# a component has many carries: two groups take at most 16 KB).
FIX_GROUP = 16
# The most shared memory a block of the speculate kernel may take (an
# H100's 227 KB, after the opt-in above 48 KB).
MAX_SMEM = 227 * 1024

_DESIGN = """\
// Replaces the lax.scan of zorak_tpu/lowering/specialize.py
// solve_scan_group (one DAG level of sequential scan groups): carries
// c [ZS_N] f64, externals xs [L, ZS_NX] f64, ys[t] = the carries after
// sample t; for each of nf files at once (xs [nf, L, ZS_NX], c0 [nf,
// ZS_N], ys [nf, L, ZS_N]), the files a grid axis of every kernel, each
// with its own chunk records and its own "walk in series" flag.
//
// What bounds it: the body is a chain of dependent steps, far above the
// (ZS_NX + ZS_N) * 8 bytes a sample moves.  One thread walking all L
// samples of a component is bound by L links of that chain; this design
// bounds a launch by warm + chunk links on each thread, plus the fix-up's
// walk over the chunk records.
//
// What the design does: an exact chunk-parallel scan, as
// csrc/switching_scan.cu does for its fixed body, in three kernels.
//   zs_speculate_kernel: a thread per (component, chunk of `chunk`
//     samples).  A chunk whose warm-up reaches t = 0 starts there from c0
//     and is exact; any other starts `warm` samples early from c0, the
//     segment's own start carries (a state the plugin has been in, so
//     that an unbounded `while` cannot meet a state it never reached),
//     walks the warm-up without writing, then its own samples, writes ys
//     and records the carries it started its chunk with and ended with.
//     A warp is 32 chunks of one component.  No global load sits on a
//     chain: with one external stream the warp loads the next segment of
//     its 32 chunks with coalesced loads into registers while it walks
//     this one, and passes it through a tile in shared memory; with more
//     streams each thread loads its own externals in register blocks of
//     ZS_U samples, a block ahead (STAGE_MAX_EXT in scan_codegen.py).
//   zs_fixup_kernel: a thread per component walks the chunks in order
//     with the true carries.  A chunk whose recorded start equals them in
//     every bit is exact; any other is walked again from them until the
//     carries equal the speculated ys[t] in every bit (from there on the
//     two walks are the same), and its steps are added to a re-run
//     counter on the device.
//   zs_walk_kernel: a thread per component walks all L samples in series
//     from c0, register blocks of ZS_U samples with the next block's
//     loads in flight; it runs where the launch does not speculate, and
//     returns at once where it does.
// Exactness: bit patterns are compared, not floats (-0.0 == 0.0 and
// NaN != NaN as floats), and a step is a function of the carries and the
// externals alone, so by induction over the chunks ys is the sequential
// walk's for every body and every input, whether the body contracts (two
// walks then meet, and the fix-up passes through) or not (the fix-up then
// walks the chunk in series).
// Where a launch re-walked more than half a file's samples (a body that
// never contracts, such as a wrap; a decay into exact silence, where two
// followers keep a fixed ratio), its fix-up marks that file's flag with
// the launch's number; the next launch then neither speculates nor fixes
// up that file, and zs_walk_kernel walks it in series (a launch with one
// chunk, L <= warm + chunk, is that walk alone).  The flags are read on
// the device only and hold for one launch; a silent file does not push
// the others into series.
"""

_BINARY_INFIX = {"+": "+", "-": "-", "*": "*"}
_BINARY_FN = {
    "/": "z_div", "^": "z_pow", "pow": "z_pow", "%": "z_mod",
    "|": "z_or", "&": "z_and", "~": "z_xor", "<<": "z_shl", ">>": "z_shr",
    "<": "z_lt", "<=": "z_le", ">": "z_gt", ">=": "z_ge",
    "==": "z_eq", "!=": "z_ne", "min": "z_min", "max": "z_max",
    "atan2": "atan2",
}
_UNARY_FN = {
    "sin": "sin", "cos": "cos", "tan": "tan", "asin": "asin", "acos": "acos",
    "atan": "atan", "exp": "exp", "log": "log", "log10": "log10",
    "sqrt": "sqrt", "abs": "z_abs", "fabs": "z_abs", "floor": "z_floor",
    "ceil": "z_ceil", "invsqrt": "z_invsqrt", "sign": "z_sign",
    "not": "z_not",
}
# calls whose device versions are not correctly rounded: a body with one
# of them is held to the plain loop within a tolerance, not bit for bit
TRANSCENDENTAL = frozenset({
    "sin", "cos", "tan", "asin", "acos", "atan", "exp", "log", "log10",
    "^", "pow", "atan2"})


def c_double(v) -> str:
    """A C++ expression whose value has exactly the bits of float(v)."""
    v = float(v)
    if v != v or math.isinf(v):
        (bits,) = struct.unpack("<Q", struct.pack("<d", v))
        return f"zt_from_bits(0x{bits:016x}ULL)"
    return f"({v.hex()})" if v < 0 or math.copysign(1.0, v) < 0 else v.hex()


def has_transcendental(steps: Sequence[Step]) -> bool:
    return any(kind in ("bin", "call") and op in TRANSCENDENTAL
               for kind, op, _meta, _args in steps)


def components(steps: Sequence[Step], outs: Sequence[Operand]
               ) -> List[List[int]]:
    """The carries (indices into outs) grouped into independent
    components, each sorted, in order of their first carry."""
    n = len(outs)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        i, j = find(i), find(j)
        if i != j:
            parent[max(i, j)] = min(i, j)

    owner: Dict[int, int] = {}           # step -> a carry that needs it

    def walk(spec, carry):
        tag, v = spec
        if tag == "p":
            union(carry, v)
        elif tag == "s":
            if v in owner:
                union(carry, owner[v])
                return
            owner[v] = carry
            for a in steps[v][3]:
                walk(a, carry)

    for i, o in enumerate(outs):
        walk(o, i)
    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return [groups[r] for r in sorted(groups)]


def _needed(steps, outs, carries):
    """(steps, externals) that the outs of `carries` need; the carries
    they read are `carries` themselves, by the way components are made."""
    need_s, need_x = set(), set()
    stack = [outs[i] for i in carries]
    while stack:
        tag, v = stack.pop()
        if tag == "x":
            need_x.add(v)
        elif tag == "s" and v not in need_s:
            need_s.add(v)
            stack.extend(steps[v][3])
    return sorted(need_s), sorted(need_x)


def _layout(steps, outs, unroll):
    """(components, what each needs, samples held in registers at once)."""
    comps = components(steps, outs)
    parts = [_needed(steps, outs, c) for c in comps]
    widest = max((len(xs_used) for _s, xs_used in parts), default=0)
    return comps, parts, max(1, min(unroll, 4 * unroll // max(1, widest)))


def block_rows(steps: Sequence[Step], outs: Sequence[Operand],
               unroll: int = MAX_UNROLL) -> int:
    """ZS_U of the generated source: the samples a thread holds at once,
    which is also the rows of externals that the chain probe cycles
    through."""
    return _layout(steps, outs, unroll)[2]


def _operand(spec: Operand) -> str:
    tag, v = spec
    if tag == "c":
        return c_double(v)
    return {"x": f"x[{v}]", "p": f"p[{v}]", "s": f"s{v}"}[tag]


def _step_lines(i: int, step: Step) -> List[str]:
    kind, op, meta, args = step
    a = [_operand(s) for s in args]
    if kind == "bin":
        if op in _BINARY_INFIX:
            return [f"const double s{i} = {a[0]} {_BINARY_INFIX[op]} {a[1]};"]
        if op not in _BINARY_FN:
            raise ValueError(f"scan group: no C body for binary {op!r}")
        return [f"const double s{i} = {_BINARY_FN[op]}({a[0]}, {a[1]});"]
    if kind == "call":
        if op not in _UNARY_FN:
            raise ValueError(f"scan group: no C body for call {op!r}")
        return [f"const double s{i} = {_UNARY_FN[op]}({a[0]});"]
    if kind == "select":
        return [f"const double s{i} = z_true({a[0]}) ? {a[1]} : {a[2]};"]
    if kind == "normloop":
        cmp_op = meta["op"]
        if cmp_op not in (">", ">=", "<", "<="):
            raise ValueError(f"scan group: normloop predicate {cmp_op!r}")
        return [f"double s{i} = {a[0]};",
                f"while (s{i} {cmp_op} {c_double(meta['C'])}) "
                f"s{i} = s{i} + {c_double(meta['S'])};"]
    raise ValueError(f"scan group: no C body for step kind {kind!r}")


def emit_scan_source(steps: Sequence[Step], outs: Sequence[Operand],
                     n_carry: int, n_ext: int, unroll: int = MAX_UNROLL,
                     probe: bool = False, staged: Optional[bool] = None
                     ) -> str:
    """The source text of one scan-group level; `unroll` is the most
    samples a walking thread holds in registers at once, `probe` adds the
    chain probe, which no render launches, and `staged` picks how the
    speculate kernel loads its externals: staged through shared memory
    (True) or in register blocks (False); None, the default, stages
    exactly where the level has one external stream (`STAGE_MAX_EXT`).

    Entry points (plain C interface, arrays f64 and contiguous unless
    named otherwise, for nf files, each file's rows after the last's; ws
    holds nf x 2 x n_chunks x n_carry f64, the start and end records;
    mark is nf int64, a file's flag, reruns one uint64, the steps all
    files re-walked):
      scan_group_launch(xs [nf, L, n_ext], c0 [nf, n_carry],
                        ys [nf, L, n_carry], ws, mark, reruns, L, chunk,
                        warm, launch_no, nf, stream)
                                   the kernels (the walk alone where
                                   chunk >= L); returns the cudaError
      scan_group_chain(xc [ZS_U, n_ext], c0, out [n_carry], L, stream)
                                   with `probe` only, for timing: the same
                                   steps with the externals cycling
                                   through registers, no memory traffic;
                                   writes the last carry
      scan_group_host(xs, c0, ys, ws, mark, reruns, L, chunk, warm,
                      launch_no, nf)
                                   host compilers only: the same two
                                   phases, one chunk after another, a
                                   file after another; returns the files
                                   it speculated (the others it walked
                                   in series)
    """
    if n_carry != len(outs) or n_carry < 1:
        raise ValueError(f"{len(outs)} outs for {n_carry} carries")
    for _k, _o, _m, args in steps:
        for tag, v in args:
            if tag == "x" and not 0 <= v < n_ext:
                raise ValueError(f"external {v} of {n_ext}")
    comps, parts, unroll = _layout(steps, outs, unroll)
    if staged is None:
        staged = n_ext <= STAGE_MAX_EXT
    nxa = max(1, n_ext)                       # no zero-length arrays
    # samples of a staged row: 32 (a segment walked while the next one's
    # loads land), fewer where a lane would hold more than 4 doubles a row
    seg = 32 if nxa <= 4 else max(1, 128 // nxa)
    pitch = (seg * n_ext) | 1                 # odd: no bank conflicts
    smem = 32 * pitch * 8
    if staged and smem > MAX_SMEM:
        raise ValueError(f"scan group: {n_ext} externals need {smem} bytes "
                         "of shared memory a block")
    out: List[str] = [
        "// Generated by zorak_tpu_torch/lowering/scan_codegen.py: one level",
        f"// of sequential scan groups, {n_carry} carries in {len(comps)} "
        f"independent component(s),",
        f"// {n_ext} external stream(s), {len(steps)} steps a sample.",
        "//",
        *_DESIGN.splitlines(),
        '#include "scan_ops.cuh"',
        "",
        f"#define ZS_N {n_carry}",
        f"#define ZS_NX {n_ext}",
        f"#define ZS_NXA {nxa}",
        f"#define ZS_U {unroll}",
        f"#define ZS_COMPONENTS {len(comps)}",
        f"#define ZS_SEG {seg}",
        f"#define ZS_ROW {seg * n_ext}",
        f"#define ZS_PITCH {pitch}",
        f"#define ZS_SMEM {smem if staged else 0}",
        f"#define ZS_GROUP {max(1, min(FIX_GROUP, 1024 // n_carry))}",
        "",
        "// a double's bit pattern",
        "ZT_FN uint64_t zs_bits(double v) {",
        "  uint64_t b;",
        "  memcpy(&b, &v, 8);",
        "  return b;",
        "}",
        "",
    ]
    for k, (carries, (need_s, need_x)) in enumerate(zip(comps, parts)):
        out.append(f"// component {k}: carries {carries}, externals {need_x}")
        out.append(f"ZT_FN void zs_body_{k}(const double* x, double* p) {{")
        for i in need_s:
            out.extend("  " + ln for ln in _step_lines(i, steps[i]))
        for i in carries:
            out.append(f"  const double o{i} = {_operand(outs[i])};")
        for i in carries:
            out.append(f"  p[{i}] = o{i};")
        out.append("}")
        out.append("")

    def loads(dst, row, need_x, indent):
        return [f"{indent}{dst}[{j}] = xs[({row}) * ZS_NX + {j}];"
                for j in need_x]

    def stores(row, carries, indent):
        return [f"{indent}ys[({row}) * ZS_N + {i}] = p[{i}];" for i in carries]

    def same(carries, other):
        return " && ".join(f"zs_bits(p[{i}]) == zs_bits({other(i)})"
                           for i in carries)

    def copy(dst, src, carries, indent):
        return [f"{indent}{dst(i)} = {src(i)};" for i in carries]

    def fixup(carries, rewalk, indent):
        """The fix-up of a component: walk the chunks in order with the
        true carries (`rewalk` names the component's checking walk)."""
        rec_s = lambda i: f"rs[g * ZS_N + {i}]"
        rec_e = lambda i: f"re[g * ZS_N + {i}]"
        return [indent + ln for ln in [
            "double p[ZS_N];",
            "unsigned long long walked = 0;",
            "// chunk 0 started from c0: exact",
            *copy(lambda i: f"p[{i}]", lambda i: f"ws_end[{i}]", carries, ""),
            "for (long long g0 = 1; g0 < n_chunks; g0 += ZS_GROUP) {",
            "  const int count = (int)(n_chunks - g0 < ZS_GROUP ? n_chunks - g0"
            " : ZS_GROUP);",
            "  for (int g = 0; g < count; ++g) {   // records, loaded at once",
            *copy(lambda i: f"    rs[g * ZS_N + {i}]",
                  lambda i: f"ws_start[(g0 + g) * ZS_N + {i}]", carries, ""),
            *copy(lambda i: f"    re[g * ZS_N + {i}]",
                  lambda i: f"ws_end[(g0 + g) * ZS_N + {i}]", carries, ""),
            "  }",
            "  for (int g = 0; g < count; ++g) {",
            f"    if ({same(carries, rec_s)}) {{",
            *copy(lambda i: f"      p[{i}]", rec_e, carries, ""),
            "      continue;",
            "    }",
            "    const long long t0 = (g0 + g) * chunk;",
            f"    if ({rewalk}(xs, ys, p, t0, t0 + chunk < L ? t0 + chunk : L,"
            " walked)) {",
            *copy(lambda i: f"      p[{i}]", rec_e, carries, ""),
            "    }",
            "  }",
            "}",
        ]]

    def speculate_staged(k, carries):
        """The speculate thread of component k, its externals staged
        through shared memory (`staged`): the warp loads a segment of its
        32 chunks' externals with coalesced loads into registers while it
        walks the segment before, then stores them to the tile."""
        return [
            "// Thread q of block (x, y): chunk 32x + q of component y.  Its",
            "// walk runs relative steps r = 0 .. warm + chunk - 1, sample",
            "// t = c*chunk - warm + r, stepping where t lies in [0, L).",
            f"__device__ void zs_speculate_{k}(const double* __restrict__ xs,",
            "    const double* __restrict__ c0, double* __restrict__ ys,",
            "    double* __restrict__ ws_start, double* __restrict__ ws_end,",
            "    long long L, long long chunk, long long warm,",
            "    long long n_chunks) {",
            "  extern __shared__ __align__(16) double tile[];  // [32][ZS_PITCH]",
            "  const int q = threadIdx.x;",
            "  const long long cb = (long long)blockIdx.x * 32;",
            "  const long long c = cb + q;",
            "  const bool owner = c < n_chunks;",
            "  const long long span = warm + chunk;",
            "  const long long t_first = c * chunk - warm;",
            "  const long long r_lo = t_first < 0 ? -t_first : 0;",
            "  const long long r_hi = !owner ? 0"
            " : (span < L - t_first ? span : L - t_first);",
            "  const long long n_seg = (span + ZS_SEG - 1) / ZS_SEG;",
            "  double p[ZS_N];",
            *[f"  p[{i}] = c0[{i}];" for i in carries],
            "  // row i of segment j: the externals of samples j*ZS_SEG ..",
            "  // j*ZS_SEG + ZS_SEG - 1 of chunk cb + i's walk, ZS_ROW",
            "  // contiguous doubles of xs; lane q holds elements q, q + 32 ..",
            "  constexpr int RL = (ZS_ROW + 31) / 32;",
            "  double pf[32][RL > 0 ? RL : 1];",
            "  const long long g_row0 = (cb * chunk - warm) * ZS_NX;",
            "  const long long row_step = chunk * ZS_NX;",
            "  const bool all_rows = cb + 32 <= n_chunks;",
            "  auto fetch = [&](long long j) {",
            "    const long long g = g_row0 + j * (ZS_SEG * ZS_NX);",
            "    if (all_rows && g >= 0 && g + 31 * row_step + ZS_ROW <= L * ZS_NX) {",
            "#pragma unroll",
            "      for (int i = 0; i < 32; ++i) {",
            "#pragma unroll",
            "        for (int e = 0; e < RL; ++e)",
            "          if (q + 32 * e < ZS_ROW)",
            "            pf[i][e] = xs[g + i * row_step + q + 32 * e];",
            "      }",
            "    } else {",
            "#pragma unroll",
            "      for (int i = 0; i < 32; ++i) {",
            "#pragma unroll",
            "        for (int e = 0; e < RL; ++e) {",
            "          const long long gi = g + i * row_step + q + 32 * e;",
            "          const bool ok = q + 32 * e < ZS_ROW && cb + i < n_chunks"
            " && gi >= 0 && gi < L * ZS_NX;",
            "          pf[i][e] = ok ? xs[gi] : 0.0;",
            "        }",
            "      }",
            "    }",
            "  };",
            "  fetch(0);",
            "  for (long long j = 0; j < n_seg; ++j) {",
            "    __syncwarp();            // the tile of segment j - 1 is read",
            "#pragma unroll",
            "    for (int i = 0; i < 32; ++i) {",
            "#pragma unroll",
            "      for (int e = 0; e < RL; ++e)",
            "        if (q + 32 * e < ZS_ROW) tile[i * ZS_PITCH + q + 32 * e] = pf[i][e];",
            "    }",
            "    __syncwarp();            // segment j is in the tile",
            "    if (j + 1 < n_seg) fetch(j + 1);   // lands while j is walked",
            "    const long long r0 = j * ZS_SEG;",
            "    const double* v = tile + q * ZS_PITCH;   // this chunk's row",
            "    const bool inside = r0 >= r_lo && r0 + ZS_SEG <= r_hi;",
            "    if (inside && r0 + ZS_SEG <= warm) {   // warm-up: no writes",
            "#pragma unroll",
            "      for (int s = 0; s < ZS_SEG; ++s)",
            f"        zs_body_{k}(v + s * ZS_NX, p);",
            "    } else if (inside && r0 >= warm) {      // the chunk's own",
            "      if (r0 == warm) {",
            *[f"        ws_start[c * ZS_N + {i}] = p[{i}];" for i in carries],
            "      }",
            "#pragma unroll",
            "      for (int s = 0; s < ZS_SEG; ++s) {",
            f"        zs_body_{k}(v + s * ZS_NX, p);",
            *stores("t_first + r0 + s", carries, "        "),
            "      }",
            "    } else if (owner && r0 + ZS_SEG > r_lo && r0 < r_hi) {",
            "      // the segment holds t = 0, the chunk's start or t = L",
            "#pragma unroll",
            "      for (int s = 0; s < ZS_SEG; ++s) {",
            "        const long long r = r0 + s;",
            "        if (r == warm) {",
            *[f"          ws_start[c * ZS_N + {i}] = p[{i}];" for i in carries],
            "        }",
            "        if (r >= r_lo && r < r_hi) {",
            f"          zs_body_{k}(v + s * ZS_NX, p);",
            "          if (r >= warm) {",
            *stores("t_first + r", carries, "            "),
            "          }",
            "        }",
            "      }",
            "    }",
            "  }",
            "  if (owner) {",
            *[f"    ws_end[c * ZS_N + {i}] = p[{i}];" for i in carries],
            "  }",
            "}",
            "",
        ]

    def speculate_blocked(k, carries, need_x):
        """The speculate thread of component k, its externals loaded into
        registers a block of ZS_U samples ahead, as the walk's are."""
        def block_loads(dst, r0, indent):
            """The externals of block r0: straight off a pointer where the
            block lies in [0, L), else each index clamped into it."""
            return [
                f"{indent}if (t_first + ({r0}) >= 0 && t_first + ({r0}) + ZS_U <= L) {{",
                f"{indent}  const double* xb = xs + (t_first + ({r0})) * ZS_NX;",
                f"{indent}#pragma unroll",
                f"{indent}  for (int j = 0; j < ZS_U; ++j) {{",
                *[f"{indent}    {dst}[{j}] = xb[j * ZS_NX + {j}];"
                  for j in need_x],
                f"{indent}  }}",
                f"{indent}}} else {{",
                f"{indent}#pragma unroll",
                f"{indent}  for (int j = 0; j < ZS_U; ++j) {{",
                f"{indent}    long long t = t_first + ({r0}) + j;",
                f"{indent}    t = t < 0 ? 0 : (t < L ? t : L - 1);",
                *loads(dst, "t", need_x, indent + "    "),
                f"{indent}  }}",
                f"{indent}}}"]
        return [
            "// Thread q of block (x, y): chunk 32x + q of component y.  Its",
            "// walk runs relative steps r = 0 .. warm + chunk - 1, sample",
            "// t = c*chunk - warm + r, stepping where t lies in [0, L), in",
            "// blocks of ZS_U samples whose externals sit in registers, the",
            "// next block's loads issued before the steps.",
            f"__device__ void zs_speculate_{k}(const double* __restrict__ xs,",
            "    const double* __restrict__ c0, double* __restrict__ ys,",
            "    double* __restrict__ ws_start, double* __restrict__ ws_end,",
            "    long long L, long long chunk, long long warm,",
            "    long long n_chunks) {",
            "  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;",
            "  if (c >= n_chunks) return;",
            "  const long long span = warm + chunk;",
            "  const long long t_first = c * chunk - warm;",
            "  const long long r_lo = t_first < 0 ? -t_first : 0;",
            "  const long long r_hi = span < L - t_first ? span : L - t_first;",
            "  const long long n_blk = (r_hi + ZS_U - 1) / ZS_U;",
            "  double p[ZS_N];",
            *[f"  p[{i}] = c0[{i}];" for i in carries],
            "  double xv[ZS_U][ZS_NXA], xn[ZS_U][ZS_NXA];",
            *block_loads("xn[j]", "0", "  "),
            "  for (long long b = 0; b < n_blk; ++b) {",
            "    const long long r0 = b * ZS_U;",
            "#pragma unroll",
            "    for (int j = 0; j < ZS_U; ++j) {",
            *[f"      xv[j][{j}] = xn[j][{j}];" for j in need_x],
            "    }",
            "    if (b + 1 < n_blk) {",
            *block_loads("xn[j]", "r0 + ZS_U", "      "),
            "    }",
            "    const bool inside = r0 >= r_lo && r0 + ZS_U <= r_hi;",
            "    if (inside && r0 + ZS_U <= warm) {   // warm-up: no writes",
            "#pragma unroll",
            f"      for (int j = 0; j < ZS_U; ++j) zs_body_{k}(xv[j], p);",
            "    } else if (inside && r0 >= warm) {   // the chunk's own",
            "      if (r0 == warm) {",
            *[f"        ws_start[c * ZS_N + {i}] = p[{i}];" for i in carries],
            "      }",
            "#pragma unroll",
            "      for (int j = 0; j < ZS_U; ++j) {",
            f"        zs_body_{k}(xv[j], p);",
            *stores("t_first + r0 + j", carries, "        "),
            "      }",
            "    } else {   // the block holds t = 0, the chunk's start or t = L",
            "#pragma unroll   // registers: the index must be a constant",
            "      for (int j = 0; j < ZS_U; ++j) {",
            "        const long long r = r0 + j;",
            "        if (r == warm) {",
            *[f"          ws_start[c * ZS_N + {i}] = p[{i}];" for i in carries],
            "        }",
            "        if (r >= r_lo && r < r_hi) {",
            f"          zs_body_{k}(xv[j], p);",
            "          if (r >= warm) {",
            *stores("t_first + r", carries, "            "),
            "          }",
            "        }",
            "      }",
            "    }",
            "  }",
            *[f"  ws_end[c * ZS_N + {i}] = p[{i}];" for i in carries],
            "}",
            "",
        ]

    # -- the card ---------------------------------------------------------------
    out += [
        "#ifdef __CUDACC__",
        "#include <cuda_runtime.h>",
        "namespace {",
        "",

        "",
    ]
    for k, (carries, (_s, need_x)) in enumerate(zip(comps, parts)):
        out += [
            "// The walk in series from c0 over all L samples: blocks of",
            "// ZS_U samples whose externals sit in registers, the next",
            "// block's loads issued before the steps and landing while they",
            "// run, then the ragged end.",
            f"__device__ void zs_walk_{k}(const double* __restrict__ xs,",
            "    const double* __restrict__ c0, double* __restrict__ ys,",
            "    long long L) {",
            "  double p[ZS_N];",
            *[f"  p[{i}] = c0[{i}];" for i in carries],
            "  double xv[ZS_U][ZS_NXA], xn[ZS_U][ZS_NXA];",
            "  const long long full = L / ZS_U * ZS_U;",
            "  if (full > 0) {",
            "#pragma unroll",
            "    for (int j = 0; j < ZS_U; ++j) {",
            *loads("xn[j]", "(long long)j", need_x, "      "),
            "    }",
            "  }",
            "  for (long long t0 = 0; t0 < full; t0 += ZS_U) {",
            "#pragma unroll",
            "    for (int j = 0; j < ZS_U; ++j) {",
            *[f"      xv[j][{j}] = xn[j][{j}];" for j in need_x],
            "    }",
            "    if (t0 + ZS_U < full) {",
            "#pragma unroll",
            "      for (int j = 0; j < ZS_U; ++j) {",
            *loads("xn[j]", "t0 + ZS_U + j", need_x, "        "),
            "      }",
            "    }",
            "#pragma unroll",
            "    for (int j = 0; j < ZS_U; ++j) {",
            f"      zs_body_{k}(xv[j], p);",
            *stores("t0 + j", carries, "      "),
            "    }",
            "  }",
            "  for (long long t = full; t < L; ++t) {   // the ragged end",
            "    double xr[ZS_NXA];",
            *loads("xr", "t", need_x, "    "),
            f"    zs_body_{k}(xr, p);",
            *stores("t", carries, "    "),
            "  }",
            "}",
            "",
            "// The fix-up's walk of a speculated chunk [t0, t1) from the true",
            "// carries p, in the same register blocks: after each block the",
            "// carries are held to the speculated ys of the block's last",
            "// sample (read before the block is written) and, in the ragged",
            "// end, of each sample; it stops where they are equal in every",
            "// bit and returns true.",
            f"__device__ bool zs_rewalk_{k}(const double* __restrict__ xs,",
            "    double* __restrict__ ys, double* p, long long t0,",
            "    long long t1, unsigned long long& walked) {",
            "  double xv[ZS_U][ZS_NXA], xn[ZS_U][ZS_NXA], sp[ZS_N];",
            "  const long long full = t0 + (t1 - t0) / ZS_U * ZS_U;",
            "  if (full > t0) {",
            "#pragma unroll",
            "    for (int j = 0; j < ZS_U; ++j) {",
            *loads("xn[j]", "t0 + j", need_x, "      "),
            "    }",
            "  }",
            "  for (long long t = t0; t < full; t += ZS_U) {",
            "#pragma unroll",
            "    for (int j = 0; j < ZS_U; ++j) {",
            *[f"      xv[j][{j}] = xn[j][{j}];" for j in need_x],
            "    }",
            *[f"    sp[{i}] = ys[(t + ZS_U - 1) * ZS_N + {i}];" for i in carries],
            "    if (t + ZS_U < full) {",
            "#pragma unroll",
            "      for (int j = 0; j < ZS_U; ++j) {",
            *loads("xn[j]", "t + ZS_U + j", need_x, "        "),
            "      }",
            "    }",
            "#pragma unroll",
            "    for (int j = 0; j < ZS_U; ++j) {",
            f"      zs_body_{k}(xv[j], p);",
            *stores("t + j", carries, "      "),
            "    }",
            "    walked += ZS_U;",
            f"    if ({same(carries, lambda i: f'sp[{i}]')}) return true;",
            "  }",
            "  for (long long t = full; t < t1; ++t) {   // the ragged end",
            "    double xr[ZS_NXA];",
            *loads("xr", "t", need_x, "    "),
            f"    zs_body_{k}(xr, p);",
            "    ++walked;",
            f"    if ({same(carries, lambda i: f'ys[t * ZS_N + {i}]')})"
            " return true;",
            *stores("t", carries, "    "),
            "  }",
            "  return false;",
            "}",
            "",
            *(speculate_staged(k, carries) if staged
              else speculate_blocked(k, carries, need_x)),
            f"__device__ void zs_fixup_{k}(const double* __restrict__ xs,",
            "    double* __restrict__ ys, const double* __restrict__ ws_start,",
            "    const double* __restrict__ ws_end, long long L,",
            "    long long chunk, long long n_chunks, double* rs, double* re,",
            "    unsigned long long& walked_out) {",
            *fixup(carries, f"zs_rewalk_{k}", "  "),
            "  walked_out = walked;",
            "}",
            "",
        ]
        if not probe:
            continue
        out += [
            f"__device__ void zs_chain_{k}(const double* __restrict__ xc,",
            "    const double* __restrict__ c0, double* __restrict__ out,",
            "    long long L) {",
            "  double p[ZS_N];",
            *[f"  p[{i}] = c0[{i}];" for i in carries],
            "  double xv[ZS_U][ZS_NXA];",
            "#pragma unroll",
            "  for (int j = 0; j < ZS_U; ++j) {",
            *[f"    xv[j][{j}] = xc[j * ZS_NX + {j}];" for j in need_x],
            "  }",
            "  for (long long t0 = 0; t0 + ZS_U <= L; t0 += ZS_U) {",
            "#pragma unroll",
            f"    for (int j = 0; j < ZS_U; ++j) zs_body_{k}(xv[j], p);",
            "  }",
            *[f"  out[{i}] = p[{i}];" for i in carries],
            "}",
            "",
        ]
    ncomp = len(comps)
    out += [
        "// A warp a block: 32 chunks of component blockIdx.y of file",
        "// blockIdx.z.  Returns at once where the launch before marked the",
        "// file's flag with its number.",
        "__global__ void __launch_bounds__(32) zs_speculate_kernel(",
        "    const double* __restrict__ xs, const double* __restrict__ c0,",
        "    double* __restrict__ ys, double* __restrict__ ws,",
        "    const long long* __restrict__ mark, long long L, long long chunk,",
        "    long long warm, long long n_chunks, long long launch_no) {",
        "  const long long f = blockIdx.z;",
        "  if (mark[f] == launch_no - 1) return;",
        "  xs += f * L * ZS_NX;",
        "  c0 += f * ZS_N;",
        "  ys += f * L * ZS_N;",
        "  ws += f * 2 * n_chunks * ZS_N;",
        "  double* ws_end = ws + n_chunks * ZS_N;",
        "  switch (blockIdx.y) {",
        *[f"    case {k}: zs_speculate_{k}(xs, c0, ys, ws, ws_end, L, chunk, "
          "warm, n_chunks); break;" for k in range(ncomp)],
        "  }",
        "}",
        "",
        "// Where the file's flag says the launch before re-walked most of",
        "// its samples, or the launch has one chunk (`force`): the walk in",
        "// series, a block of one thread a component (blockIdx.x) and file",
        "// (blockIdx.y); else nothing.",
        "__global__ void __launch_bounds__(1) zs_walk_kernel(",
        "    const double* __restrict__ xs, const double* __restrict__ c0,",
        "    double* __restrict__ ys, const long long* __restrict__ mark,",
        "    long long L, long long launch_no, int force) {",
        "  const long long f = blockIdx.y;",
        "  if (!force && mark[f] != launch_no - 1) return;",
        "  xs += f * L * ZS_NX;",
        "  c0 += f * ZS_N;",
        "  ys += f * L * ZS_N;",
        "  switch (blockIdx.x) {              // a block a component",
        *[f"    case {k}: zs_walk_{k}(xs, c0, ys, L); break;"
          for k in range(ncomp)],
        "  }",
        "}",
        "",
        "// The fix-up, a block of one thread a component (blockIdx.x) and",
        "// file (blockIdx.y), after a launch that speculated the file (else",
        "// nothing); marks the file's flag where a component re-walked more",
        "// than half its samples.",
        "__global__ void __launch_bounds__(1) zs_fixup_kernel(",
        "    const double* __restrict__ xs, double* __restrict__ ys,",
        "    const double* __restrict__ ws, long long* __restrict__ mark,",
        "    unsigned long long* __restrict__ reruns, long long L,",
        "    long long chunk, long long n_chunks, long long launch_no) {",
        "  const long long f = blockIdx.y;",
        "  if (mark[f] == launch_no - 1) return;",
        "  xs += f * L * ZS_NX;",
        "  ys += f * L * ZS_N;",
        "  ws += f * 2 * n_chunks * ZS_N;",
        "  const double* ws_end = ws + n_chunks * ZS_N;",
        "  __shared__ double rs[ZS_GROUP * ZS_N], re[ZS_GROUP * ZS_N];",
        "  unsigned long long walked = 0;",
        "  switch (blockIdx.x) {",
        *[f"    case {k}: zs_fixup_{k}(xs, ys, ws, ws_end, L, chunk, "
          "n_chunks, rs, re, walked); break;" for k in range(ncomp)],
        "  }",
        "  if (2 * walked > (unsigned long long)L) mark[f] = launch_no;",
        "  if (walked) atomicAdd(reruns, walked);",
        "}",
        "",
    ]
    if probe:
        out += [
            "__global__ void zs_chain_kernel(const double* __restrict__ xs,",
            "    const double* __restrict__ c0, double* __restrict__ out,",
            "    long long L) {",
            "  switch (blockIdx.x) {              // a block a component",
            *[f"    case {k}: zs_chain_{k}(xs, c0, out, L); break;"
              for k in range(ncomp)],
            "  }",
            "}",
            "",
        ]
    out += [
        "}  // namespace",
        "",
        'extern "C" int scan_group_launch(const void* xs, const void* c0,',
        "    void* ys, void* ws, void* mark, void* reruns, long long L,",
        "    long long chunk, long long warm, long long launch_no,",
        "    long long nf, void* stream) {",
        "  cudaGetLastError();  // clear an error left by an earlier call",
        "  if (L <= 0 || nf <= 0) return 0;",
        "  if (nf > 65535) return static_cast<int>(cudaErrorInvalidValue);",
        "  const unsigned files = static_cast<unsigned>(nf);",
        "  const auto s = static_cast<cudaStream_t>(stream);",
        "  const auto* x = static_cast<const double*>(xs);",
        "  const auto* c = static_cast<const double*>(c0);",
        "  auto* y = static_cast<double*>(ys);",
        "  auto* w = static_cast<double*>(ws);",
        "  auto* m = static_cast<long long*>(mark);",
        "  const long long n_chunks = (L + chunk - 1) / chunk;",
        "  if (n_chunks > 1) {",
        "    static bool opted_in = false;   // above 48 KB only after this",
        "    if (!opted_in && ZS_SMEM > 48 * 1024) {",
        "      cudaFuncSetAttribute(zs_speculate_kernel,",
        "          cudaFuncAttributeMaxDynamicSharedMemorySize, ZS_SMEM);",
        "      opted_in = true;",
        "    }",
        "    const dim3 grid((unsigned)((n_chunks + 31) / 32), ZS_COMPONENTS,",
        "                    files);",
        "    zs_speculate_kernel<<<grid, 32, ZS_SMEM, s>>>(x, c, y, w, m, L,",
        "        chunk, warm, n_chunks, launch_no);",
        "    cudaError_t err = cudaGetLastError();",
        "    if (err != cudaSuccess) return static_cast<int>(err);",
        "    zs_fixup_kernel<<<dim3(ZS_COMPONENTS, files), 1, 0, s>>>(x, y, w,",
        "        m, static_cast<unsigned long long*>(reruns), L, chunk, n_chunks,",
        "        launch_no);",
        "    err = cudaGetLastError();",
        "    if (err != cudaSuccess) return static_cast<int>(err);",
        "  }",
        "  zs_walk_kernel<<<dim3(ZS_COMPONENTS, files), 1, 0, s>>>(x, c, y, m,",
        "      L, launch_no, n_chunks <= 1);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
    ]
    if probe:
        out += [
            'extern "C" int scan_group_chain(const void* xc, const void* c0,',
            "                                void* out, long long L,",
            "                                void* stream) {",
            "  zs_chain_kernel<<<ZS_COMPONENTS, 1, 0,",
            "                    static_cast<cudaStream_t>(stream)>>>(",
            "      static_cast<const double*>(xc), static_cast<const double*>(c0),",
            "      static_cast<double*>(out), L);",
            "  return static_cast<int>(cudaGetLastError());",
            "}",
            "",
        ]
    # -- a host compiler: the same phases, one chunk after another ------------
    out += ["#else  // a host compiler: the same two phases, in series", ""]
    for k, (carries, (_s, need_x)) in enumerate(zip(comps, parts)):
        out += [
            f"static void zs_walk_{k}(const double* xs, const double* c0,",
            "    double* ys, long long L) {",
            "  double p[ZS_N];",
            *[f"  p[{i}] = c0[{i}];" for i in carries],
            "  for (long long t = 0; t < L; ++t) {",
            "    double xr[ZS_NXA];",
            *loads("xr", "t", need_x, "    "),
            f"    zs_body_{k}(xr, p);",
            *stores("t", carries, "    "),
            "  }",
            "}",
            "",
            f"static bool zs_rewalk_{k}(const double* xs, double* ys, double* p,",
            "    long long t0, long long t1, unsigned long long& walked) {",
            "  for (long long t = t0; t < t1; ++t) {",
            "    double xr[ZS_NXA];",
            *loads("xr", "t", need_x, "    "),
            f"    zs_body_{k}(xr, p);",
            "    ++walked;",
            f"    if ({same(carries, lambda i: f'ys[t * ZS_N + {i}]')})"
            " return true;",
            *stores("t", carries, "    "),
            "  }",
            "  return false;",
            "}",
            "",
            f"static void zs_speculate_{k}(const double* xs, const double* c0,",
            "    double* ys, double* ws_start, double* ws_end, long long L,",
            "    long long chunk, long long warm, long long c) {",
            "  const long long t_first = c * chunk - warm;",
            "  const long long t_end = c * chunk + chunk < L"
            " ? c * chunk + chunk : L;",
            "  double p[ZS_N];",
            *[f"  p[{i}] = c0[{i}];" for i in carries],
            "  for (long long t = t_first < 0 ? 0 : t_first; t < t_end; ++t) {",
            "    if (t == c * chunk) {",
            *[f"      ws_start[c * ZS_N + {i}] = p[{i}];" for i in carries],
            "    }",
            "    double xr[ZS_NXA];",
            *loads("xr", "t", need_x, "    "),
            f"    zs_body_{k}(xr, p);",
            "    if (t >= c * chunk) {",
            *stores("t", carries, "      "),
            "    }",
            "  }",
            *[f"  ws_end[c * ZS_N + {i}] = p[{i}];" for i in carries],
            "}",
            "",
            f"static unsigned long long zs_fixup_{k}(const double* xs,",
            "    double* ys, const double* ws_start, const double* ws_end,",
            "    long long L, long long chunk, long long n_chunks) {",
            "  double rs[ZS_GROUP * ZS_N], re[ZS_GROUP * ZS_N];",
            *fixup(carries, f"zs_rewalk_{k}", "  "),
            "  return walked;",
            "}",
            "",
        ]
    out += [
        'extern "C" int scan_group_host(const double* xs0, const double* c00,',
        "    double* ys0, double* ws0, long long* mark,",
        "    unsigned long long* reruns, long long L, long long chunk,",
        "    long long warm, long long launch_no, long long nf) {",
        "  if (L <= 0) return 0;",
        "  const long long n_chunks = (L + chunk - 1) / chunk;",
        "  int speculated = 0;",
        "  for (long long f = 0; f < nf; ++f) {   // a file after another",
    ]
    body = [
        "const double* xs = xs0 + f * L * ZS_NX;",
        "const double* c0 = c00 + f * ZS_N;",
        "double* ys = ys0 + f * L * ZS_N;",
        "double* ws = ws0 + f * 2 * n_chunks * ZS_N;",
        "const bool serial = n_chunks <= 1 || mark[f] == launch_no - 1;",
        "double* ws_end = ws + n_chunks * ZS_N;",
        "speculated += serial ? 0 : 1;",
    ]
    for k in range(ncomp):
        body += [
            "if (serial) {",
            f"  zs_walk_{k}(xs, c0, ys, L);",
            "} else {",
            "  for (long long c = 0; c < n_chunks; ++c)",
            f"    zs_speculate_{k}(xs, c0, ys, ws, ws_end, L, chunk, warm, c);",
            f"  const unsigned long long walked = zs_fixup_{k}(xs, ys, ws, ws_end,",
            "      L, chunk, n_chunks);",
            "  if (2 * walked > (unsigned long long)L) mark[f] = launch_no;",
            "  *reruns += walked;",
            "}",
        ]
    out += ["    " + ln for ln in body]
    out += ["  }", "  return speculated;", "}", "", "#endif", ""]
    return "\n".join(out)
