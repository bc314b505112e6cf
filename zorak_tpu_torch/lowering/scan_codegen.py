"""CUDA C++ text for one level of sequential scan groups.

Counterpart of the `lax.scan` body that the reference builds a DAG level
of scan groups into (zorak_tpu/lowering/specialize.py, `solve_scan_group`).
`solve_scan_group` of this package lowers the level to a step list; this
module prints that list as a source file: pure text, no torch, no compiler.

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
right envelope), and each component walks time in a block of its own
(one thread; blocks land on different SMs).

The same file holds, for a host compiler (`g++ -x c++`, no CUDA), the same
bodies under a plain loop over t, which is how the CPU tests run them.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List, Sequence, Tuple

Operand = Tuple[str, object]
Step = Tuple[str, str, Dict, Sequence[Operand]]

# The most samples whose externals a walking thread holds in registers at
# once (the next block's loads are in flight while this block's steps
# run); a block takes at most 4 x this many f64 registers, so a component
# with more than four externals holds fewer samples.  16 read best for one
# and two externals on an H100 (`chip_smoke.py --phases k4sweep`).
MAX_UNROLL = 16

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
                     probe: bool = False) -> str:
    """The source text of one scan-group level; `unroll` is the most
    samples a thread holds in registers at once, and `probe` adds the
    chain probe, which no render launches.

    Entry points (plain C interface, all arrays f64 and contiguous):
      scan_group_launch(xs [L, n_ext], c0 [n_carry], ys [L, n_carry], L,
                        stream)              the kernel; returns the
                                             cudaError of the launch
      scan_group_chain(xc [ZS_U, n_ext], c0, out [n_carry], L, stream)
                                             with `probe` only, for timing:
                                             the same steps
                                             with the externals cycling
                                             through registers, no memory
                                             traffic; writes the last carry
      scan_group_host(xs, c0, ys, L)         host compilers only: the same
                                             bodies under a plain loop
    """
    if n_carry != len(outs) or n_carry < 1:
        raise ValueError(f"{len(outs)} outs for {n_carry} carries")
    for _k, _o, _m, args in steps:
        for tag, v in args:
            if tag == "x" and not 0 <= v < n_ext:
                raise ValueError(f"external {v} of {n_ext}")
    comps, parts, unroll = _layout(steps, outs, unroll)
    nxa = max(1, n_ext)                       # no zero-length arrays
    out: List[str] = [
        "// Generated by zorak_tpu_torch/lowering/scan_codegen.py: one level",
        f"// of sequential scan groups, {n_carry} carries in {len(comps)} "
        f"independent component(s),",
        f"// {n_ext} external stream(s), {len(steps)} steps a sample.",
        '#include "scan_ops.cuh"',
        "",
        f"#define ZS_N {n_carry}",
        f"#define ZS_NX {n_ext}",
        f"#define ZS_NXA {nxa}",
        f"#define ZS_U {unroll}",
        f"#define ZS_COMPONENTS {len(comps)}",
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

    # -- the card: a block of one thread a component ---------------------------
    out.append("#ifdef __CUDACC__")
    out.append("#include <cuda_runtime.h>")
    out.append("namespace {")
    for k, (carries, (_s, need_x)) in enumerate(zip(comps, parts)):
        out += [
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
            "    // this block's externals sit in registers; the next block's",
            "    // loads are issued before the steps and land while they run",
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
    entries = [("zs_scan_kernel", "zs_walk", "ys")]
    if probe:
        entries.append(("zs_chain_kernel", "zs_chain", "out"))
    for name, walk, what in entries:
        out += [
            f"__global__ void {name}(const double* __restrict__ xs,",
            f"    const double* __restrict__ c0, double* __restrict__ {what},",
            "    long long L) {",
            "  switch (blockIdx.x) {              // a block a component",
            *[f"    case {k}: {walk}_{k}(xs, c0, {what}, L); break;"
              for k in range(len(comps))],
            "  }",
            "}",
            "",
        ]
    out += [
        "}  // namespace",
        "",
        'extern "C" int scan_group_launch(const void* xs, const void* c0,',
        "                                 void* ys, long long L, void* stream) {",
        "  if (L <= 0) return 0;",
        "  zs_scan_kernel<<<ZS_COMPONENTS, 1, 0,",
        "                   static_cast<cudaStream_t>(stream)>>>(",
        "      static_cast<const double*>(xs), static_cast<const double*>(c0),",
        "      static_cast<double*>(ys), L);",
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
    out += [
        "#else  // a host compiler: the same bodies under a plain loop over t",
        "",
        'extern "C" int scan_group_host(const double* xs, const double* c0,',
        "                               double* ys, long long L) {",
    ]
    for k, (carries, (_s, need_x)) in enumerate(zip(comps, parts)):
        out += [
            "  {",
            "    double p[ZS_N];",
            *[f"    p[{i}] = c0[{i}];" for i in carries],
            "    for (long long t = 0; t < L; ++t) {",
            "      double xr[ZS_NXA];",
            *loads("xr", "t", need_x, "      "),
            f"      zs_body_{k}(xr, p);",
            *stores("t", carries, "      "),
            "    }",
            "  }",
        ]
    out += ["  return 0;", "}", "", "#endif", ""]
    return "\n".join(out)
