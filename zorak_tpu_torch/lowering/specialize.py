"""Time-vectorizing specializer: @sample -> one data-parallel torch program.

Counterpart of zorak_tpu/lowering/specialize.py.  The planner (symbolic
execution of @sample against the concrete post-@init/@slider state, the
matchers, the per-variable plans, scan groups and linrec waves) is that
module's, copied: it is numpy and Python only.  The emitter and the
segment loop are rewritten for torch.

Instead of translating the sequential sample loop, we *specialize* the
@sample body against the concrete state produced by interpreting
@init/@slider on the host (sliders, tap tables, coefficients — all
block-rate control state), then symbolically execute it over the whole
time axis:

* slider-derived values fold to compile-time constants (quality levels,
  tap counts, monitor modes, filter coefficients),
* `loop(n, ...)` with a now-concrete n unrolls,
* counter variables (v += const) classify as inductions,
* `mem[base + (cursor & mask)]` ring-buffer writes/reads with induction
  cursors become static-shift delayed streams (slices of
  [history | this segment's write stream]),
* first-order recurrences z = A*z' + B (one-poles, meters, envelopes with
  state-independent coefficients) go to the `linrec_scan` CUDA kernel,
  sums of constant-gain ring taps to the `ring_tap_sum` CUDA kernel,
* state-dependent recurrences (attack/release envelopes, peak holds,
  nonlinear feedback, mutually recursive pairs) form sequential scan
  groups, each DAG level of which runs as one `scan_group` kernel whose
  CUDA text is generated from the level's steps,
* data-dependent branches become `select` via per-variable branch merging.

The emitted segment function runs eagerly in a host loop across
segments.  An audio-coupled @block (meters, accumulator resets, shared
mem, FFTs of buffers @sample fills) runs on the device between segments
of one block each: `lowering/devgen.py` prints it as CUDA C and K10
(`kernels/block_section.py`) runs it, a launch a block, in the fused
block/sample loop `_coupled_run`.  A hop section (FFT block work fired
every N samples from inside @sample) is extracted and printed the same
way, and K10 runs it after each hop's segment in the fused sample/hop
loop `_hop_run`, whose steps (a hop's segment, then K10) K5 captures and
replays on the card (`_hop_steps`).  The gated regime runs in the
segment program: cursors that advance only where a gate fires
(positions from the gate's int64 prefix sum), taps gathered from ring
history at those positions, gated ring writes scattered to consecutive
positions, rand() drawn only where its gate fires (the draw pool indexed
by a fire-count prefix sum), and loop(n) unrolled to a guessed bound
behind an overflow monitor that `render_device`'s ladder reads.
Plugins whose @sample uses features outside this subset raise
SpecializeError and fall back to the golden executor.
"""
from __future__ import annotations

import math
import os
import struct
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from ..frontend.astnodes import (
    Asn, Bin, Block, CallExpr, Cond, Const, IfStmt, LoopExpr, Mem, Name,
    Node, Str, Un, WhileStmt, walk,
)
from ..ir.program import PluginProgram
from ..ir.symbols import dollar_const, slider_index, spl_index
from ..semantics import scalar as SC

MAX_UNROLL = 65536
MAX_WHILE_CONCRETE = 1 << 22
MAX_INLINE_DEPTH = 64
# the guessed loop(n) bounds' overflow ladder: rebuilds before it gives up
LADDER_ATTEMPTS = 8
# the render lengths whose fresh ungated draw matrix a kernel keeps
RAND_CACHE_LENGTHS = 4
# the profiler range over K6's ops: the gated regime's gate masks, prefix
# sums, cursor arithmetic, gathers and ring scatter (no other work inside)
K6_RANGE = "zorak.k6"
# the profiler range over K3b's ops: an ungated ring cursor's positions and
# a dynamic ring read's slot arithmetic, last-writer choice and gather
K3B_RANGE = "zorak.k3b"
# the profiler range over one K5 step's host work: the copies into its
# static buffers, the replay (or the run and capture), the copy out
K5_RANGE = "zorak.k5"


def _profiler_range(name: str):
    """A `torch.profiler` range named `name` while a profiler runs, else
    nothing: a range costs microseconds of host time a call even then."""
    import contextlib

    import torch

    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _k6_range():
    return _profiler_range(K6_RANGE)


def _k3b_range():
    return _profiler_range(K3B_RANGE)


def _k5_range():
    return _profiler_range(K5_RANGE)


class _CoupledUpgrade(Exception):
    """Internal: @block/@sample mem sharing discovered during symexec —
    retry with the device-executed (coupled) @block regime (or, for
    settling write-only @block heaps, the baked uncoupled regime)."""

    def __init__(self, reason: str = "writes", spans=None):
        super().__init__(reason)
        self.reason = reason  # "reads" | "writes"
        # sample-written mem spans [(origin, length)] at raise time, for
        # the settle probe's poison test
        self.spans = spans or []


class _SettledRetry(Exception):
    """Internal: the optimistic settled-constant assumption was violated
    for some vars; re-run discovery with them demoted to carried state."""

    def __init__(self, violations: Set[Any]):
        super().__init__("settled retry")
        self.violations = violations


class _SegmentRetry(Exception):
    """Internal: ring-ring delay cycles break when the segment shrinks to
    the minimum cross-ring coupling delay (time-blocked scans) — rebuild
    the kernel with this segment length."""

    def __init__(self, segment_len: int):
        super().__init__(f"segment retry {segment_len}")
        self.segment_len = int(segment_len)


# batched same-level linrec solving (opt-out knob for A/B timing probes)
_LINREC_BATCH = not os.environ.get("ZORAK_NO_LINREC_BATCH")


class SpecializeError(Exception):
    """Raised when @sample uses features outside the vectorizable subset."""


# ---------------------------------------------------------------------------
# symbolic values


@dataclass(frozen=True)
class CV:
    """Block-constant concrete value."""
    v: float


@dataclass(eq=False)
class GNode:
    """Time-series graph node (one value per sample of the segment)."""
    kind: str                       # in/prev/bin/un/call/select/ind/ringread/ringstatic
    op: str = ""
    args: Tuple = ()                # operands: GNode | float
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class TS:
    node: GNode


@dataclass(frozen=True)
class IndAff:
    """Induction-affine value: state[var] + offset + t   (unit step)."""
    var: Any
    offset: int


@dataclass(frozen=True)
class RingIdx:
    """(state[var] + offset + t) & (mod - 1), plus a concrete origin."""
    var: Any
    offset: int
    mod: int
    origin: int = 0


@dataclass(frozen=True)
class GRingIdx:
    """GATED ring cursor value: (state[var] + G_t + offset) mod M plus a
    concrete origin, where G_t is the exclusive prefix count of the
    cursor's per-sample gate stream (sym.gate_of[var]) — the cursor
    advances by one only on samples where the gate fires (the JSFX
    ctrl/audio-gated delay-tank idiom, ref 3DPanner.jsfx:2461-2462:
    `sceneverb_active ? ( buf[wpos] = ..; wpos = (wpos+1) & mask; )`).
    incl=True is the post-advance value (inclusive prefix): select(p,
    X+1, X) on an exclusive cursor X is EXACTLY anchor + G_t + p_t."""
    var: Any
    offset: int
    mod: int
    origin: int = 0
    incl: bool = False


SymVal = Union[CV, TS, IndAff, RingIdx, GRingIdx]

_COMPOUND_SC = {
    "+=": lambda c, r: c + r,
    "-=": lambda c, r: c - r,
    "*=": lambda c, r: c * r,
    "/=": SC.eel_div, "%=": SC.eel_mod, "^=": SC.eel_pow,
    "|=": SC.eel_or, "&=": SC.eel_and, "~=": SC.eel_xor,
}
_COMPOUND_OP = {"+=": "+", "-=": "-", "*=": "*", "/=": "/", "%=": "%",
                "^=": "^", "|=": "|", "&=": "&", "~=": "~"}

_SC_UNARY = {
    "sin": SC.eel_sin, "cos": SC.eel_cos, "tan": SC.eel_tan,
    "asin": SC.eel_asin, "acos": SC.eel_acos, "atan": SC.eel_atan,
    "exp": SC.eel_exp, "log": SC.eel_log, "log10": SC.eel_log10,
    "sqrt": SC.eel_sqrt, "abs": SC.eel_abs, "fabs": SC.eel_abs,
    "floor": SC.eel_floor, "ceil": SC.eel_ceil, "invsqrt": SC.eel_invsqrt,
    "sign": SC.eel_sign, "not": SC.eel_not,
}
_SC_BINARY = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
    "/": SC.eel_div, "^": SC.eel_pow, "%": SC.eel_mod,
    "|": SC.eel_or, "&": SC.eel_and, "~": SC.eel_xor,
    "<<": SC.eel_shl, ">>": SC.eel_shr,
    "<": SC.cmp_lt, "<=": SC.cmp_le, ">": SC.cmp_gt, ">=": SC.cmp_ge,
    "==": SC.cmp_eq, "!=": SC.cmp_ne,
    "min": SC.eel_min, "max": SC.eel_max, "pow": SC.eel_pow,
    "atan2": SC.eel_atan2,
}


def _is_int(x: float) -> bool:
    return x == x and abs(x) < 2 ** 52 and float(x) == int(x)


# ---------------------------------------------------------------------------
# syntactic assigned-variable analysis


_MEM_WRITING_BUILTINS = frozenset({
    "memset", "memcpy", "fft", "ifft", "fft_real", "ifft_real",
    "fft_permute", "fft_ipermute", "convolve_c", "gmem_get", "file_mem",
    "sample_export_mem", "sample_export_mem2", "midirecv_buf", "msg_recv_buf",
})


def section_var_usage(program: PluginProgram, section: str):
    """(reads, writes, writes_mem) of a section by env key, transitively
    through called user functions.  Conservative on dynamic slider()/spl()."""
    reads: Set[Any] = set()
    writes: Set[Any] = set()
    writes_mem = [False]
    reads_mem = [False]
    seen_fns: Set[str] = set()

    def scan(nodes: Sequence[Node], params: Set[str]) -> None:
        for root in nodes:
            for n in walk(root):
                if isinstance(n, Name) and n.ident not in params \
                        and n.ident not in ("mem", "gmem") \
                        and dollar_const(n.ident) is None:
                    reads.add(_env_key_for_name(n.ident))
                if isinstance(n, Mem) and not (
                        isinstance(n.base, Name) and n.base.ident == "gmem"):
                    reads_mem[0] = True  # over-approximate: any bracket access
                if isinstance(n, Asn):
                    t = n.target
                    if isinstance(t, Name) and t.ident not in params:
                        writes.add(_env_key_for_name(t.ident))
                    elif isinstance(t, Mem):
                        if not (isinstance(t.base, Name) and t.base.ident == "gmem"):
                            writes_mem[0] = True
                    elif isinstance(t, CallExpr) and t.func == "spl":
                        writes.update(("spl", c) for c in range(64))
                    elif isinstance(t, CallExpr) and t.func == "slider":
                        writes.update(("slider", c) for c in range(64))
                if isinstance(n, CallExpr):
                    if n.func in _MEM_WRITING_BUILTINS:
                        writes_mem[0] = True
                    if n.func in program.fn_defs and n.func not in seen_fns:
                        seen_fns.add(n.func)
                        proto = program.fn_defs[n.func]
                        scan([proto.body], set(proto.params))
                    # out-params of recv-style builtins are writes
                    if n.func in ("midirecv", "msg_recv", "file_var",
                                  "file_riff", "sample_read2",
                                  "sample_read2_interp", "sample_preview_read",
                                  "slider_next_chg", "instance_uid",
                                  "instance_get_name", "track_name",
                                  "msg_peer_name", "msg_peer_uid"):
                        for a in n.args:
                            if isinstance(a, Name):
                                writes.add(_env_key_for_name(a.ident))

    scan(program.sections.get(section, []), set())
    return reads, writes, writes_mem[0], reads_mem[0]


def assigned_vars_of_sample(program: PluginProgram) -> Set[Any]:
    """Variables (by env key) that @sample may assign."""
    return section_var_usage(program, "sample")[1]


def section_genuine_reads(program: PluginProgram, section: str) -> Set[Any]:
    """Flow-sensitive read-before-write set: vars whose value ENTERING the
    section is actually consumed (scratch loop counters assigned first do
    not count).  Conservative: assignments inside branches/loops are not
    'definite', reads inside them still count unless defined earlier at
    the top level."""
    genuine: Set[Any] = set()
    fn_reads_cache: Dict[str, Set[Any]] = {}

    def fn_reads(fname: str) -> Set[Any]:
        got = fn_reads_cache.get(fname)
        if got is not None:
            return got
        fn_reads_cache[fname] = set()  # recursion guard
        proto = program.fn_defs[fname]
        out: Set[Any] = set()
        _walk(proto.body, set(), set(proto.params), out, definite=True)
        fn_reads_cache[fname] = out
        return out

    def _walk(n: Node, defined: Set[Any], params: Set[str],
              out: Set[Any], definite: bool) -> None:
        if isinstance(n, Name):
            if n.ident in params or n.ident in ("mem", "gmem") \
                    or dollar_const(n.ident) is not None:
                return
            key = _env_key_for_name(n.ident)
            if key not in defined:
                out.add(key)
            return
        if isinstance(n, (Const, Str)):
            return
        if isinstance(n, Asn):
            _walk(n.value, defined, params, out, definite)
            t = n.target
            if isinstance(t, Name) and t.ident not in params:
                key = _env_key_for_name(t.ident)
                if n.op != "=" and key not in defined:
                    out.add(key)  # compound assign reads the target
                if definite:
                    defined.add(key)
            else:
                for c in _children_of(t):
                    _walk(c, defined, params, out, definite)
            return
        if isinstance(n, (IfStmt, Cond)):
            _walk(n.pred, defined, params, out, definite)
            # walk each branch sequentially on a copy: write-then-read
            # inside one branch is not a pre-section read; the copy is
            # discarded so later code can't rely on branch writes
            _walk(n.then, set(defined), params, out, definite)
            other = getattr(n, "other", None)
            if other is not None:
                _walk(other, set(defined), params, out, definite)
            return
        if isinstance(n, (LoopExpr, WhileStmt)):
            head = n.count if isinstance(n, LoopExpr) else n.pred
            _walk(head, defined, params, out, definite)
            # first-iteration order decides whether a pre-section value
            # is consumed; later iterations read loop-internal values
            _walk(n.body, set(defined), params, out, definite)
            return
        if isinstance(n, Block):
            for item in n.items:
                _walk(item, defined, params, out, definite)
            return
        if isinstance(n, CallExpr):
            for a in n.args:
                _walk(a, defined, params, out, definite)
            if n.func in program.fn_defs:
                out |= (fn_reads(n.func) - defined)
            return
        for c in _children_of(n):
            _walk(c, defined, params, out, definite)

    def _children_of(n: Node):
        from ..frontend.astnodes import children
        return children(n)

    defined: Set[Any] = set()
    for stmt in program.sections.get(section, []):
        _walk(stmt, defined, set(), genuine, True)
    return genuine


def _env_key_for_name(ident: str):
    i = spl_index(ident)
    if i is not None:
        return ("spl", i)
    i = slider_index(ident)
    if i is not None:
        return ("slider", i)
    if ident in ("srate", "samplesblock", "midi_bus", "ext_midi_bus"):
        return ("builtin", ident)
    return ("var", ident)


# ---------------------------------------------------------------------------
# symbolic executor


class _RingWrite:
    __slots__ = ("var", "offset", "mod", "origin", "value", "order")

    def __init__(self, var, offset, mod, origin, value, order):
        self.var = var
        self.offset = offset
        self.mod = mod
        self.origin = origin
        self.value = value
        self.order = order


class _DynWrite:
    """Conditionally-gated mem write at a time-varying address (metering
    histories: `cond ? ( hist[wpos] = v; wpos += 1; wpos >= M ? wpos = 0 )`).
    origin is the concrete base; idx the per-sample index node; gate the
    condition node (None = unconditional); mod resolved at plan time from
    the index var's wrap bound."""
    __slots__ = ("origin", "idx", "value", "gate", "order", "mod")

    def __init__(self, origin, idx, value, gate, order):
        self.origin = origin
        self.idx = idx
        self.value = value
        self.gate = gate
        self.order = order
        self.mod = 0


class _GRingWrite:
    """Ring write at a GATED cursor position (inside the gate's branch):
    executes only on samples where the cursor's gate fires, landing at
    consecutive mod-M positions in gate-count (G-) space."""
    __slots__ = ("var", "offset", "mod", "origin", "value", "order", "gate")

    def __init__(self, var, offset, mod, origin, value, order, gate):
        self.var = var
        self.offset = offset
        self.mod = mod
        self.origin = origin
        self.value = value
        self.order = order
        self.gate = gate


class _SymExec:
    def __init__(self, program: PluginProgram, snapshot, nch: int,
                 induction_vars: Dict[Any, int],
                 known_mem_cells: Set[int],
                 segment_len_hint: int,
                 control_vars: Optional[Set[Any]] = None,
                 mod_inductions: Optional[Dict[Any, int]] = None,
                 const_overrides: Optional[Dict[Any, float]] = None,
                 settled_vars: Optional[Set[Any]] = None,
                 gated_mod_inductions: Optional[Dict[Any, int]] = None,
                 masked_loop_k: int = 32):
        self.P = program
        self.snap = snapshot              # ShadowState after init/slider
        # block-invariant constants (post-@block values; the block runs
        # before its samples, so these override the snapshot)
        self.const_overrides = const_overrides or {}
        self.nch = nch
        self.inductions = induction_vars  # env key -> step (always 1 for ring use)
        # wrapped counters: v = (v + 1) mod M each sample (either via
        # `v >= M ? v = 0` or `v = (v+1) & mask`) -> env key -> modulus M
        self.mod_inductions = mod_inductions or {}
        # GATED wrapped counters: v advances (v+1) mod M only on samples
        # where a per-sample gate fires (env key -> modulus M); the gate
        # node itself is recorded per pass in gate_of when the cursor's
        # select-merge is seen
        self.gated_mod_inductions = gated_mod_inductions or {}
        self.gate_of: Dict[Any, GNode] = {}
        self.gring_writes: Dict[Tuple[int, int], List[_GRingWrite]] = {}
        self.known_cells = known_mem_cells
        self.assigned = assigned_vars_of_sample(program)
        # optimistic SCCP-style constants: vars syntactically assigned in
        # @sample whose assignments all sit in branches that fold false
        # under this very assumption (e.g. `srate != last_srate ? ...`
        # re-init guards).  A write that actually executes with any other
        # value is a violation; discovery shrinks the set and retries.
        self.settled = settled_vars or set()
        self.settled_violations: Set[Any] = set()
        self.control_vars = control_vars or set()
        self.ctrl_nodes: Dict[Any, GNode] = {}
        self.env: Dict[Any, SymVal] = {}
        self.prev_nodes: Dict[Any, GNode] = {}
        self.writes: Set[Any] = set()
        self.ring_writes: Dict[Tuple[int, int], List[_RingWrite]] = {}
        self.dyn_writes: List[_DynWrite] = []
        self._gate: Optional[GNode] = None  # ambient branch condition
        self.written_cells: Set[int] = set()
        self.read_cells: Set[int] = set()
        self.order = 0
        self.depth = 0
        self.rand_slots = 0
        self.rand_sites: List[Tuple[int, Optional[GNode]]] = []
        self._branch_depth = 0
        # data-dependent loop(n) masked unrolls whose bound K was a GUESS
        # (no finite static interval on n): each entry (count_node, K)
        # feeds the runtime overflow monitor — see _masked_loop
        self.masked_loop_k = int(masked_loop_k)
        self.masked_loops: List[Tuple[GNode, int]] = []
        self.L_hint = segment_len_hint

        for c in range(nch):
            self.env[("spl", c)] = TS(GNode("in", meta={"ch": c}))

    # -- environment ---------------------------------------------------------

    def _state_value(self, key) -> float:
        got = self.const_overrides.get(key)
        if got is not None:
            return got
        kind = key[0]
        if kind == "spl":
            return float(self.snap.spl[key[1]])
        if kind == "slider":
            return float(self.snap.sliders[key[1]])
        if kind == "builtin":
            name = key[1]
            if name == "samplesblock":
                return float(self.L_hint)
            return float(getattr(self.snap, name))
        if kind == "var":
            return float(self.snap.V.get(key[1], 0.0))
        if kind == "mem":
            a = key[1]
            return float(self.snap.mem[a]) if a < len(self.snap.mem) else 0.0
        if kind == "rand":
            return 0.0  # consumed-draw counter starts at the pool head
        if kind == "mloop":
            return 0.0  # masked-loop overflow monitor starts clean
        raise AssertionError(key)

    def read_key(self, key) -> SymVal:
        if key in self.env:
            return self.env[key]
        if key in self.mod_inductions:
            # the carried scalar is the wrapped cursor in [0, M); its value
            # at sample t is (c0 + t) mod M — a ring position with offset 0
            val: SymVal = RingIdx(key, 0, self.mod_inductions[key], 0)
        elif key in self.gated_mod_inductions:
            # pre-advance value: anchor + (exclusive gate prefix) mod M
            val = GRingIdx(key, 0, self.gated_mod_inductions[key], 0)
        elif key in self.inductions:
            val = IndAff(key, 0)
        elif key in self.settled and key not in self.settled_violations:
            val = CV(self._state_value(key))
        elif key in self.assigned or (key[0] == "mem" and key[1] in self.known_cells):
            node = self.prev_nodes.get(key)
            if node is None:
                node = GNode("prev", meta={"key": key})
                self.prev_nodes[key] = node
            val = TS(node)
        elif key in self.control_vars:
            node = self.ctrl_nodes.get(key)
            if node is None:
                node = GNode("ctrl", meta={"key": key})
                self.ctrl_nodes[key] = node
            val = TS(node)
        else:
            val = CV(self._state_value(key))
        self.env[key] = val
        return val

    def write_key(self, key, val: SymVal) -> None:
        if key in self.settled and key not in self.settled_violations:
            same = isinstance(val, CV) and val.v == self._state_value(key)
            if not same:
                self.settled_violations.add(key)
        self.env[key] = val
        self.writes.add(key)

    # -- symbolic operations -------------------------------------------------

    def _node(self, sv: SymVal) -> Union[GNode, float]:
        if isinstance(sv, CV):
            return sv.v
        if isinstance(sv, TS):
            return sv.node
        if isinstance(sv, IndAff):
            return GNode("ind", meta={"var": sv.var, "offset": sv.offset})
        if isinstance(sv, RingIdx):
            return GNode("ringidx", meta={"var": sv.var, "offset": sv.offset,
                                          "mod": sv.mod, "origin": sv.origin})
        if isinstance(sv, GRingIdx):
            return GNode("gringidx",
                         meta={"var": sv.var, "offset": sv.offset,
                               "mod": sv.mod, "origin": sv.origin,
                               "incl": sv.incl})
        raise AssertionError(sv)

    def binop(self, op: str, a: SymVal, b: SymVal) -> SymVal:
        if isinstance(a, CV) and isinstance(b, CV):
            return CV(_SC_BINARY[op](a.v, b.v))

        # induction-affine algebra (keeps ring addressing recognizable)
        if op in ("+", "-"):
            if isinstance(a, IndAff) and isinstance(b, CV) and _is_int(b.v):
                d = int(b.v) if op == "+" else -int(b.v)
                return IndAff(a.var, a.offset + d)
            if op == "+" and isinstance(b, IndAff) and isinstance(a, CV) and _is_int(a.v):
                return IndAff(b.var, b.offset + int(a.v))
            if isinstance(a, RingIdx) and isinstance(b, CV) and _is_int(b.v):
                d = int(b.v) if op == "+" else -int(b.v)
                return RingIdx(a.var, a.offset, a.mod, a.origin + d)
            if op == "+" and isinstance(b, RingIdx) and isinstance(a, CV) and _is_int(a.v):
                return RingIdx(b.var, b.offset, b.mod, b.origin + int(a.v))
            if isinstance(a, GRingIdx) and isinstance(b, CV) and _is_int(b.v):
                d = int(b.v) if op == "+" else -int(b.v)
                return GRingIdx(a.var, a.offset, a.mod, a.origin + d, a.incl)
            if op == "+" and isinstance(b, GRingIdx) and isinstance(a, CV) \
                    and _is_int(a.v):
                return GRingIdx(b.var, b.offset, b.mod, b.origin + int(a.v),
                                b.incl)
        if op == "&" and isinstance(a, IndAff) and isinstance(b, CV):
            m = b.v
            if _is_int(m) and int(m) > 0 and (int(m) + 1) & int(m) == 0:
                return RingIdx(a.var, a.offset, int(m) + 1, 0)
        if op == "&" and isinstance(a, RingIdx) and isinstance(b, CV):
            # re-masking a wrapped position: (origin + pos) & (M-1) folds the
            # origin into the mod-M offset (two's-complement & == mod for
            # pow2, including negative origins)
            m = b.v
            if _is_int(m) and int(m) + 1 == a.mod and (int(m) + 1) & int(m) == 0:
                return RingIdx(a.var, a.offset + a.origin, a.mod, 0)
        if op == "&" and isinstance(a, GRingIdx) and isinstance(b, CV):
            m = b.v
            if _is_int(m) and int(m) + 1 == a.mod and (int(m) + 1) & int(m) == 0:
                return GRingIdx(a.var, a.offset + a.origin, a.mod, 0, a.incl)
        if op == "&" and isinstance(a, TS) and isinstance(b, CV):
            # time-varying value masked to a power-of-2 ring: tag it so
            # mem addressing can recognize dynamic ring/table indexing
            m = b.v
            if _is_int(m) and int(m) > 0 and (int(m) + 1) & int(m) == 0:
                return TS(GNode("maskidx", args=(a.node,),
                                meta={"mod": int(m) + 1}))
        if op in ("&&", "||"):
            raise AssertionError("logical ops handled in eval")
        return TS(GNode("bin", op=op, args=(self._node(a), self._node(b))))

    def unop(self, op: str, a: SymVal) -> SymVal:
        if op == "+":
            return a
        if isinstance(a, CV):
            return CV(SC.eel_neg(a.v) if op == "-" else SC.eel_not(a.v))
        if op == "-":
            return TS(GNode("bin", op="-", args=(0.0, self._node(a))))
        return TS(GNode("call", op="not", args=(self._node(a),)))

    def call_math(self, fn: str, args: List[SymVal]) -> SymVal:
        if all(isinstance(a, CV) for a in args):
            if len(args) == 1:
                return CV(_SC_UNARY[fn](args[0].v))
            return CV(_SC_BINARY[fn](args[0].v, args[1].v))
        if len(args) == 1:
            return TS(GNode("call", op=fn, args=(self._node(args[0]),)))
        return TS(GNode("bin", op=fn, args=(self._node(args[0]), self._node(args[1]))))

    # -- memory --------------------------------------------------------------

    def _addr_of(self, base: SymVal, idx: SymVal) -> SymVal:
        """Symbolic EEL2 address trunc(base + idx + 1e-5)."""
        s = self.binop("+", base, idx)
        if isinstance(s, CV):
            return CV(float(SC.mem_address(s.v, 0.0)))
        if isinstance(s, (IndAff, RingIdx, GRingIdx)):
            return s  # integral by construction; bias is a no-op
        return s

    @staticmethod
    def _match_dynaddr(node: GNode):
        """origin + (bounded time-varying index) -> (origin, mod, idx_node).

        The index is bounded either by a pow2 mask (maskidx) or by the
        runtime-wrap idiom `select(X < 0, X + M, X)` (exact when the raw
        index lies in [-M, M), which `cursor - clamp(delay, 0, M)` does).
        Constant adds may nest (base vars fold one CV at a time, e.g.
        `bX + ((wofs - d) & MASK)` then the implicit +0 of addressing),
        so peel them recursively while accumulating the origin."""
        origin = 0
        while isinstance(node, GNode) and node.kind == "bin" and node.op == "+":
            a, b = node.args
            if isinstance(a, float) and _is_int(a):
                origin += int(a)
                node = b
            elif isinstance(b, float) and _is_int(b):
                origin += int(b)
                node = a
            else:
                return None
        if not isinstance(node, GNode) or origin < 0:
            return None
        if node.kind == "maskidx":
            return (origin, node.meta["mod"], node)
        if node.kind == "select":
            cond, tv, ev = node.args
            if isinstance(cond, GNode) and cond.kind == "bin" \
                    and cond.op == "<" and cond.args[0] is ev \
                    and cond.args[1] == 0.0 \
                    and isinstance(tv, GNode) and tv.kind == "bin" \
                    and tv.op == "+":
                ta, tb = tv.args
                for x_arg, m_arg in ((ta, tb), (tb, ta)):
                    if x_arg is ev and isinstance(m_arg, float) \
                            and _is_int(m_arg) and int(m_arg) >= 2:
                        return (origin, int(m_arg), node)
        return None

    def mem_read(self, base: SymVal, idx: SymVal) -> SymVal:
        addr = self._addr_of(base, idx)
        if isinstance(addr, CV):
            self.read_cells.add(int(addr.v))
            return self.read_key(("mem", int(addr.v)))
        if isinstance(addr, RingIdx):
            if addr.origin < 0:
                raise SpecializeError(
                    "ring read at negative base (unnormalized wrap index?)")
            region = (addr.origin, addr.mod)
            self.order += 1
            # resolution against the region's write (delay, ordering, or
            # static snapshot gather) happens at emission when all writes
            # of the body are known
            return TS(GNode("ringref",
                            meta={"region": region, "var": addr.var,
                                  "offset": addr.offset, "order": self.order}))
        if isinstance(addr, GRingIdx):
            if addr.origin < 0:
                raise SpecializeError(
                    "gated ring read at negative base "
                    "(unnormalized wrap index?)")
            region = (addr.origin, addr.mod)
            self.order += 1
            return TS(GNode("gringref",
                            meta={"region": region, "var": addr.var,
                                  "offset": addr.offset, "incl": addr.incl,
                                  "order": self.order}))
        if isinstance(addr, TS):
            m = self._match_dynaddr(addr.node)
            if m is not None:
                origin, mod, idx_node = m
                gd = _match_gated_dyn(idx_node, mod)
                if gd is not None:
                    var, off, dnode = gd
                    self.order += 1
                    return TS(GNode("gdynringref", args=(idx_node,),
                                    meta={"region": (origin, mod),
                                          "var": var, "offset": off,
                                          "dnode": dnode,
                                          "order": self.order}))
                self.order += 1
                return TS(GNode("dynringref", args=(idx_node,),
                                meta={"region": (origin, mod),
                                      "order": self.order}))
            # interval-bounded dynamic read: EEL clamp idioms bound the
            # address statically (ref Texture.jsfx:2547-2563 tex_read —
            # `frame < 0 ? frame = 0; frame > lim ? frame = lim` then
            # base + floor(frame)*ch) even when no pow2 mask exists.
            # The bounded span becomes a read-only gather region through
            # the existing dynringref machinery; spans the sample path
            # WRITES reject in the discovery/plan disjointness checks
            # (meta["ivr"] marks these for the concrete-write overlap
            # check — regions from mask/wrap idioms keep their historic
            # legality rules).
            ivr = _node_interval(addr.node)
            if ivr is not None and math.isfinite(ivr[0]) \
                    and math.isfinite(ivr[1]) and ivr[0] >= 0.0:
                origin = int(math.floor(ivr[0]))
                hi_i = int(math.floor(ivr[1] + 1.0e-5))
                mod = hi_i - origin + 1
                if 1 <= mod <= self.IVREAD_MAX_SPAN:
                    # emission truncates once more (idempotent): node is
                    # floor(raw + 1e-5) - origin, exactly mem_address
                    # minus the region base (raw >= 0, so floor == trunc)
                    idx_node = GNode(
                        "bin", op="-",
                        args=(GNode("call", op="floor",
                                    args=(GNode("bin", op="+",
                                                args=(addr.node, 1.0e-5)),)),
                              float(origin)))
                    self.order += 1
                    return TS(GNode("dynringref", args=(idx_node,),
                                    meta={"region": (origin, mod),
                                          "ivr": True,
                                          "order": self.order}))
        if isinstance(addr, IndAff):
            raise SpecializeError("unbounded cursor mem read (no mask)")
        # dynamic address: tolerated during discovery passes, fatal at final
        if os.environ.get("ZORAK_SPEC_DEBUG"):
            import sys as _sys

            def _shallow(n, d=0):
                if not isinstance(n, GNode):
                    return repr(n)
                if d >= 7:
                    return n.kind
                extra = ""
                if n.kind in ("in", "ind", "prev"):
                    extra = repr(n.meta.get("key", n.meta or ""))[:40]
                inner = ",".join(_shallow(a, d + 1)
                                 for a in n.args[:3])
                return f"{n.kind}({n.op or ''}{extra};{inner})"
            print(f"[spec] dynmem ivr={_node_interval(addr.node)} "
                  f"{_shallow(addr.node)}", file=_sys.stderr, flush=True)
        return TS(GNode("dynmem", args=(self._node(addr),)))

    def _wrap_norm_while(self, n: WhileStmt, scope) -> Optional[SymVal]:
        """Data-dependent range-normalization loop (`while (a > 180)
        a -= 360;`, ref shape: 3DPanner.jsfx:137-138): lowers to one
        vector-wide lax.while_loop with a masked step — bit-exact to the
        golden's per-element repeated add/subtract."""
        pred = n.pred
        if not (isinstance(pred, Bin) and pred.op in (">", ">=", "<", "<=")
                and isinstance(pred.lhs, Name)):
            return None
        v_ident = pred.lhs.ident
        scoped = v_ident in scope
        lim = self.eval(pred.rhs, scope)
        if not isinstance(lim, CV):
            return None
        body = n.body.items if isinstance(n.body, Block) else [n.body]
        if len(body) != 1 or not isinstance(body[0], Asn):
            return None
        a = body[0]
        if not (isinstance(a.target, Name) and a.target.ident == v_ident):
            return None
        if a.op in ("-=", "+="):
            sgn = -1.0 if a.op == "-=" else 1.0
            step = self.eval(a.value, scope)
        elif a.op == "=" and isinstance(a.value, Bin) \
                and a.value.op in ("-", "+") \
                and isinstance(a.value.lhs, Name) \
                and a.value.lhs.ident == v_ident:
            sgn = -1.0 if a.value.op == "-" else 1.0
            step = self.eval(a.value.rhs, scope)
        else:
            return None
        if not (isinstance(step, CV) and step.v > 0.0):
            return None
        # direction must shrink toward the bound or the loop diverges
        if (pred.op in (">", ">=")) != (sgn < 0):
            return None
        cur = scope[v_ident] if scoped \
            else self.read_key(_env_key_for_name(v_ident))
        self.order += 1
        node = GNode("normloop", args=(self._node(cur),),
                     meta={"op": pred.op, "C": lim.v,
                           "S": sgn * step.v, "order": self.order})
        if scoped:
            scope[v_ident] = TS(node)
        else:
            self.write_key(_env_key_for_name(v_ident), TS(node))
        return CV(0.0)

    def _cursor_anchor(self, var, offset: int, mod: int) -> int:
        """Slot a mod-M cursor addresses at t=0: (start + offset) mod M."""
        return (int(self._state_value(var)) + offset) % mod

    def mem_write(self, base: SymVal, idx: SymVal, val: SymVal) -> None:
        addr = self._addr_of(base, idx)
        if isinstance(addr, CV):
            a = int(addr.v)
            self.written_cells.add(a)
            self.write_key(("mem", a), val)
            return
        if isinstance(addr, RingIdx):
            if addr.origin < 0:
                raise SpecializeError(
                    "ring write at negative base (unnormalized wrap index?)")
            region = (addr.origin, addr.mod)
            prior = self.ring_writes.get(region)
            if prior is not None:
                # multi-writer shared ring (e.g. several delay-line
                # "instances" left pointing at the same buffer): legal only
                # when every write lands on the SAME slot each sample —
                # distinct cursor vars are fine when their anchors (start +
                # offset mod M) coincide; reads then resolve by program
                # order (last writer wins)
                p0 = prior[0]
                if (p0.mod, p0.origin) != (addr.mod, addr.origin) or \
                        self._cursor_anchor(p0.var, p0.offset, p0.mod) != \
                        self._cursor_anchor(addr.var, addr.offset, addr.mod):
                    raise SpecializeError(
                        "multiple ring writes to one region at different "
                        "cursor positions per sample")
            self.order += 1
            self.ring_writes.setdefault(region, []).append(_RingWrite(
                addr.var, addr.offset, addr.mod, addr.origin,
                self._node(val), self.order))
            return
        if isinstance(addr, GRingIdx):
            if addr.origin < 0:
                raise SpecializeError(
                    "gated ring write at negative base "
                    "(unnormalized wrap index?)")
            if addr.incl:
                raise SpecializeError(
                    "ring write at a post-advance gated cursor — "
                    "write-before-advance is the supported idiom")
            region = (addr.origin, addr.mod)
            self.order += 1
            # the write sits inside the gate's branch: capture the ambient
            # condition; plan time requires it to BE the cursor's gate
            # (write fires exactly when the cursor advances, so writes
            # land at consecutive G-space positions)
            self.gring_writes.setdefault(region, []).append(_GRingWrite(
                addr.var, addr.offset, addr.mod, addr.origin,
                self._node(val), self.order, self._gate))
            return
        if isinstance(addr, IndAff):
            raise SpecializeError("unbounded cursor mem write (no mask)")
        if isinstance(addr, TS):
            # gated dynamic write (metering-history shape): peel constant
            # adds to a concrete base; the index bound resolves at plan
            # time from the cursor var's wrap pattern
            origin = 0
            node = addr.node
            while isinstance(node, GNode) and node.kind == "bin" \
                    and node.op == "+":
                a, b = node.args
                if isinstance(a, float) and _is_int(a):
                    origin += int(a)
                    node = b
                elif isinstance(b, float) and _is_int(b):
                    origin += int(b)
                    node = a
                else:
                    node = None
                    break
            if node is not None and origin >= 0 and isinstance(node, GNode):
                self.order += 1
                self.dyn_writes.append(_DynWrite(
                    origin, node, self._node(val), self._gate, self.order))
                return
        # dynamic address write: mark; final pass raises
        self.written_cells.add(-1)

    # -- branch merging ------------------------------------------------------

    @staticmethod
    def _wrap_normalize(cnode, tv, ev) -> Optional[RingIdx]:
        """Recognize conditional ring-wrap normalization idioms
        (`r < 0 ? r += M` after a delay subtract; `v >= M ? v = 0` /
        `v -= M` on a wrapped cursor) merging to an EXACT mod-M position.
        Returns the normalized RingIdx/GRingIdx or None."""
        if not (isinstance(cnode, GNode) and cnode.kind == "bin"):
            return None
        if isinstance(ev, GRingIdx):
            # gated-cursor dual: same wrap algebra on anchor+G positions
            x, lim = cnode.args
            if not (isinstance(x, GNode) and x.kind == "gringidx"
                    and isinstance(lim, float)):
                return None
            m = x.meta
            if (m["var"], m["offset"], m["mod"], m["origin"],
                    m["incl"]) != (ev.var, ev.offset, ev.mod, ev.origin,
                                   ev.incl):
                return None
            M = ev.mod
            if cnode.op == "<" and lim == 0.0 and -M <= ev.origin <= 0:
                if isinstance(tv, GRingIdx) and ev.incl == tv.incl \
                        and (tv.var, tv.offset, tv.mod) == \
                        (ev.var, ev.offset, ev.mod) \
                        and tv.origin == ev.origin + M:
                    return GRingIdx(ev.var, ev.offset + ev.origin, M, 0,
                                    ev.incl)
            if cnode.op in (">=", ">") and 0 <= ev.origin <= M \
                    and lim == float(M if cnode.op == ">=" else M - 1):
                if isinstance(tv, CV) and tv.v == 0.0 and ev.origin == 1:
                    return GRingIdx(ev.var, ev.offset + 1, M, 0, ev.incl)
                if isinstance(tv, GRingIdx) and ev.incl == tv.incl \
                        and (tv.var, tv.offset, tv.mod) == \
                        (ev.var, ev.offset, ev.mod) \
                        and tv.origin == ev.origin - M:
                    return GRingIdx(ev.var, ev.offset + ev.origin, M, 0,
                                    ev.incl)
            return None
        if not isinstance(ev, RingIdx):
            return None
        x, lim = cnode.args
        if not (isinstance(x, GNode) and x.kind == "ringidx"
                and isinstance(lim, float)):
            return None
        m = x.meta
        if (m["var"], m["offset"], m["mod"], m["origin"]) != \
                (ev.var, ev.offset, ev.mod, ev.origin):
            return None
        M = ev.mod
        if cnode.op == "<" and lim == 0.0 and -M <= ev.origin <= 0:
            # raw value w + origin is in [-M, M): one +M wrap is exact
            if isinstance(tv, RingIdx) and (tv.var, tv.offset, tv.mod) == \
                    (ev.var, ev.offset, ev.mod) and tv.origin == ev.origin + M:
                return RingIdx(ev.var, ev.offset + ev.origin, M, 0)
        if cnode.op in (">=", ">") and 0 <= ev.origin <= M \
                and lim == float(M if cnode.op == ">=" else M - 1):
            # raw value w + origin is in [0, 2M): one -M wrap is exact;
            # `= 0` matches only a unit-step cursor (wrap lands exactly on 0)
            if isinstance(tv, CV) and tv.v == 0.0 and ev.origin == 1:
                return RingIdx(ev.var, ev.offset + 1, M, 0)
            if isinstance(tv, RingIdx) and (tv.var, tv.offset, tv.mod) == \
                    (ev.var, ev.offset, ev.mod) and tv.origin == ev.origin - M:
                return RingIdx(ev.var, ev.offset + ev.origin, M, 0)
        return None

    def _gated_cursor_merge(self, cnode, tv, ev) -> Optional["GRingIdx"]:
        """select(gate, wrapped(X+1), X) on a gated cursor X (both arms
        pre-advance/exclusive) folds EXACTLY to the post-advance value
        anchor + inclusive-gate-prefix + offset, for ANY gate stream:
        p ? (a+G+o+1) : (a+G+o) == a + (G+p) + o.  Records the gate."""
        if not (isinstance(tv, GRingIdx) and isinstance(ev, GRingIdx)):
            return None
        if tv.incl or ev.incl:
            return None
        if (tv.var, tv.mod) != (ev.var, ev.mod) \
                or tv.var not in self.gated_mod_inductions:
            return None
        if tv.origin != 0 or ev.origin != 0:
            return None
        if tv.offset != ev.offset + 1:
            return None
        prev_gate = self.gate_of.get(tv.var)
        if prev_gate is not None and prev_gate is not cnode:
            raise SpecializeError(
                "gated cursor advanced under two different gates")
        self.gate_of[tv.var] = cnode
        return GRingIdx(tv.var, ev.offset, tv.mod, 0, True)

    def _merged_exec(self, cond: SymVal, then_fn, else_fn,
                     scope: Optional[Dict[str, SymVal]] = None) -> SymVal:
        """Execute both branches on env copies, select-merge the writes.

        `scope` is the enclosing function-local binding dict (inlined user
        functions): branch assignments to params/locals land there instead
        of the env, so it snapshots and select-merges the same way (a
        leaked unconditional `v = lo` inside `v < lo ? v = lo;` was the
        clamp-helper bug the Contour state compare caught)."""
        base_env = dict(self.env)
        base_writes = self.writes
        base_rings = {k: list(v) for k, v in self.ring_writes.items()}
        base_scope = dict(scope) if scope else None

        # run each branch with its OWN write-set so the merge below only
        # touches variables the branch actually assigned; dynamic mem
        # writes carry the arm's condition as their gate
        base_gate = self._gate
        cnode0 = self._node(cond)

        def _and(old, cn):
            if old is None:
                return cn
            return GNode("select", args=(old, cn, 0.0))

        self._branch_depth += 1
        self.writes = set()
        self._gate = _and(base_gate, cnode0)
        tval = then_fn() if then_fn else CV(0.0)
        then_env, then_writes = self.env, self.writes
        then_scope = dict(scope) if scope else None
        if scope:
            scope.clear()
            scope.update(base_scope)
        if self.ring_writes != base_rings:
            raise SpecializeError("ring write inside data-dependent branch")

        self.env = dict(base_env)
        self.writes = set()
        self._gate = _and(base_gate,
                          GNode("call", op="not", args=(cnode0,)))
        eval_ = else_fn() if else_fn else CV(0.0)
        else_env, else_writes = self.env, self.writes
        else_scope = dict(scope) if scope else None
        if self.ring_writes != base_rings:
            raise SpecializeError("ring write inside data-dependent branch")

        self._gate = base_gate
        self._branch_depth -= 1
        cnode = self._node(cond)
        if scope:
            # select-merge function-local bindings the arms diverged on
            scope.clear()
            scope.update(base_scope)
            for key in set(then_scope) | set(else_scope):
                tv = then_scope.get(key)
                ev = else_scope.get(key)
                if tv is None:
                    tv = base_scope.get(key, CV(0.0))
                if ev is None:
                    ev = base_scope.get(key, CV(0.0))
                if tv == ev:
                    scope[key] = tv
                else:
                    norm = self._wrap_normalize(cnode, tv, ev)
                    if norm is None and isinstance(cnode, GNode) \
                            and cnode.kind == "call" and cnode.op == "not":
                        norm = self._wrap_normalize(cnode.args[0], ev, tv)
                    scope[key] = norm if norm is not None else TS(GNode(
                        "select",
                        args=(cnode, self._node(tv), self._node(ev))))
        merged = dict(base_env)
        for key in then_writes | else_writes:
            tv = then_env.get(key)
            ev = else_env.get(key)
            if tv is None or ev is None:
                # assigned in one branch only: the untouched side keeps the
                # pre-branch (or prev-sample) value
                fallback = base_env.get(key)
                if fallback is None:
                    saved_env, saved_writes = self.env, self.writes
                    self.env, self.writes = dict(base_env), set()
                    fallback = self.read_key(key)
                    self.env, self.writes = saved_env, saved_writes
                tv = tv if tv is not None else fallback
                ev = ev if ev is not None else fallback
            if tv == ev:  # CV by value, TS by node identity
                merged[key] = tv
            else:
                norm = self._gated_cursor_merge(cnode, tv, ev)
                if norm is None:
                    norm = self._wrap_normalize(cnode, tv, ev)
                if norm is None and isinstance(cnode, GNode) \
                        and cnode.kind == "call" and cnode.op == "not":
                    # inverted condition (`r >= 0 ? : r += M` style): the
                    # arms swap roles
                    inner = cnode.args[0]
                    norm = self._wrap_normalize(inner, ev, tv)
                if norm is not None:
                    merged[key] = norm
                else:
                    merged[key] = TS(GNode(
                        "select",
                        args=(cnode, self._node(tv), self._node(ev))))
        self.env = merged
        self.writes = base_writes | then_writes | else_writes

        if isinstance(tval, CV) and isinstance(eval_, CV) and tval.v == eval_.v:
            return tval
        gm = self._gated_cursor_merge(cnode, tval, eval_)
        if gm is not None:
            return gm
        return TS(GNode("select", args=(cnode, self._node(tval), self._node(eval_))))

    # -- evaluation ----------------------------------------------------------

    def run(self, nodes: Sequence[Node]) -> None:
        for stmt in nodes:
            self.eval(stmt, {})

    def eval(self, n: Node, scope: Dict[str, SymVal]) -> SymVal:  # noqa: C901
        if isinstance(n, Const):
            return CV(float(n.value))
        if isinstance(n, Str):
            return CV(float(self.P.string_handle(n.text)))
        if isinstance(n, Name):
            ident = n.ident
            if ident in scope:
                return scope[ident]
            if ident == "mem":
                return CV(0.0)
            if ident == "gmem":
                raise SpecializeError("gmem in @sample")
            c = dollar_const(ident)
            if c is not None:
                return CV(c)
            return self.read_key(_env_key_for_name(ident))
        if isinstance(n, Mem):
            if isinstance(n.base, Name) and n.base.ident == "gmem":
                raise SpecializeError("gmem in @sample")
            b = self.eval(n.base, scope)
            i = self.eval(n.index, scope)
            return self.mem_read(b, i)
        if isinstance(n, Un):
            return self.unop(n.op, self.eval(n.operand, scope))
        if isinstance(n, Bin):
            if n.op in ("&&", "||"):
                l = self.eval(n.lhs, scope)
                if isinstance(l, CV):
                    lt = SC.truthy(l.v)
                    if n.op == "&&":
                        if not lt:
                            return CV(0.0)
                        r = self.eval(n.rhs, scope)
                        return CV(1.0 if isinstance(r, CV) and SC.truthy(r.v) else 0.0) \
                            if isinstance(r, CV) else self._bool(r)
                    if lt:
                        return CV(1.0)
                    r = self.eval(n.rhs, scope)
                    return CV(1.0 if isinstance(r, CV) and SC.truthy(r.v) else 0.0) \
                        if isinstance(r, CV) else self._bool(r)
                # TS lhs: rewrite as conditional evaluation of rhs
                def rhs_bool():
                    return self._bool(self.eval(n.rhs, scope))
                if n.op == "&&":
                    return self._merged_exec(l, rhs_bool, lambda: CV(0.0),
                                              scope=scope)
                return self._merged_exec(l, lambda: CV(1.0), rhs_bool,
                                         scope=scope)
            l = self.eval(n.lhs, scope)
            r = self.eval(n.rhs, scope)
            return self.binop(n.op, l, r)
        if isinstance(n, Cond):
            c = self.eval(n.pred, scope)
            if isinstance(c, CV):
                return self.eval(n.then if SC.truthy(c.v) else n.other, scope)
            return self._merged_exec(c,
                                     lambda: self.eval(n.then, scope),
                                     lambda: self.eval(n.other, scope),
                                     scope=scope)
        if isinstance(n, IfStmt):
            c = self.eval(n.pred, scope)
            if isinstance(c, CV):
                if SC.truthy(c.v):
                    self.eval(n.then, scope)
                elif n.other is not None:
                    self.eval(n.other, scope)
                return CV(0.0)
            self._merged_exec(
                c, lambda: self.eval(n.then, scope),
                (lambda: self.eval(n.other, scope)) if n.other is not None
                else None, scope=scope)
            return CV(0.0)
        if isinstance(n, WhileStmt):
            count = 0
            while True:
                c = self.eval(n.pred, scope)
                if not isinstance(c, CV):
                    got = self._wrap_norm_while(n, scope)
                    if got is not None:
                        return got
                    raise SpecializeError("data-dependent while in @sample")
                if not SC.truthy(c.v):
                    return CV(0.0)
                self.eval(n.body, scope)
                count += 1
                if count > MAX_WHILE_CONCRETE:
                    raise SpecializeError("runaway concrete while")
        if isinstance(n, LoopExpr):
            cnt = self.eval(n.count, scope)
            if not isinstance(cnt, CV):
                return self._masked_loop(n, cnt, scope)
            trips = max(0, SC.trunc_i64(cnt.v))
            if trips > MAX_UNROLL:
                raise SpecializeError(f"loop too long to unroll ({trips})")
            last: SymVal = CV(0.0)
            for _ in range(trips):
                last = self.eval(n.body, scope)
            return last
        if isinstance(n, Block):
            last: SymVal = CV(0.0)
            for item in n.items:
                v = self.eval(item, scope)
                last = CV(0.0) if isinstance(item, (IfStmt, WhileStmt)) else v
            return last
        if isinstance(n, Asn):
            return self._assign(n, scope)
        if isinstance(n, CallExpr):
            return self._call(n, scope)
        raise SpecializeError(f"unsupported node {type(n).__name__}")

    def _bool(self, sv: SymVal) -> SymVal:
        if isinstance(sv, CV):
            return CV(1.0 if SC.truthy(sv.v) else 0.0)
        node = self._node(sv)
        return TS(GNode("select", args=(node, 1.0, 0.0)))

    # masked bounded unroll of data-dependent loop(n) — the Texture
    # event-bounds expansion scans (ref Texture.jsfx:3411-3447:
    # loop(max_bins, cont ? (... left -= 1 : cont = 0))) are the catalog
    # class this covers.  EEL evaluates the count ONCE at loop entry and
    # runs the body trunc(n) times; K static iterations each gated by
    # (n >= i+1) through the branch-merge machinery are bit-equivalent
    # (a masked-off iteration leaves every write untouched; the loop's
    # value is the last ACTIVE body value, 0.0 when n < 1).
    MASKED_UNROLL_MAX = 4096
    MASKED_UNROLL_WEIGHT = 1 << 17
    # interval-bounded dynamic reads: largest read-only span (cells) that
    # may bake/carry as a gather region
    IVREAD_MAX_SPAN = 1 << 22

    def _masked_loop(self, n: LoopExpr, cnt: SymVal, scope) -> SymVal:
        cnt_node = self._node(cnt)
        iv = _node_interval(cnt_node)
        K = None
        guessed = False
        if iv is not None and math.isfinite(iv[1]):
            K = max(0, SC.trunc_i64(iv[1]))
        if K is None or K > self.MASKED_UNROLL_MAX:
            # no usable static bound: guess, and register the count node
            # with the runtime overflow monitor — a render whose n ever
            # exceeds K is INVALID and the kernel rebuilds with a doubled
            # K and replays (render_device), mirroring the devexec
            # reduced-heap ladder
            K = self.masked_loop_k
            guessed = True
        if K > self.MASKED_UNROLL_MAX:
            raise SpecializeError(
                f"data-dependent loop bound {K} past the masked-unroll "
                "cap")
        body_nodes = sum(1 for _ in walk(n.body))
        if K * body_nodes > self.MASKED_UNROLL_WEIGHT:
            raise SpecializeError(
                f"masked loop too heavy to unroll ({K} x {body_nodes} "
                "nodes)")
        if guessed:
            self.masked_loops.append((cnt_node, K))
        last: SymVal = CV(0.0)
        for i in range(K):
            gate = self.binop(">=", cnt, CV(float(i + 1)))
            prev = last
            last = self._merged_exec(gate,
                                     lambda: self.eval(n.body, scope),
                                     lambda p=prev: p, scope=scope)
        return last

    def _assign(self, n: Asn, scope: Dict[str, SymVal]) -> SymVal:
        rhs = self.eval(n.value, scope)
        tgt = n.target
        if isinstance(tgt, Name):
            ident = tgt.ident
            if ident in scope:
                if n.op == "=":
                    scope[ident] = rhs
                    return rhs
                cur = scope[ident]
                out = self._compound(n.op, cur, rhs)
                scope[ident] = out
                return out
            if ident in ("mem", "gmem"):
                raise SpecializeError(f"cannot assign to {ident}")
            key = _env_key_for_name(ident)
            if key[0] == "builtin":
                raise SpecializeError(f"assignment to {ident} in @sample")
            if n.op == "=":
                self.write_key(key, rhs)
                return rhs
            cur = self.read_key(key)
            out = self._compound(n.op, cur, rhs)
            self.write_key(key, out)
            return out
        if isinstance(tgt, Mem):
            if isinstance(tgt.base, Name) and tgt.base.ident == "gmem":
                raise SpecializeError("gmem in @sample")
            b = self.eval(tgt.base, scope)
            i = self.eval(tgt.index, scope)
            if n.op == "=":
                self.mem_write(b, i, rhs)
                return rhs
            cur = self.mem_read(b, i)
            out = self._compound(n.op, cur, rhs)
            self.mem_write(b, i, out)
            return out
        if isinstance(tgt, CallExpr) and tgt.func in ("slider", "spl"):
            raise SpecializeError("dynamic slider()/spl() assignment in @sample")
        raise SpecializeError("invalid assignment target")

    def _compound(self, op: str, cur: SymVal, rhs: SymVal) -> SymVal:
        if isinstance(cur, CV) and isinstance(rhs, CV):
            return CV(_COMPOUND_SC[op](cur.v, rhs.v))
        base_op = _COMPOUND_OP[op]
        return self.binop(base_op, cur, rhs)

    def _call(self, n: CallExpr, scope: Dict[str, SymVal]) -> SymVal:
        fn = n.func
        if fn in ("slider", "spl"):
            idx = self.eval(n.args[0], scope)
            if isinstance(idx, CV):
                i = SC.trunc_i64(idx.v + 1e-5) - (1 if fn == "slider" else 0)
                if 0 <= i < 64:
                    return self.read_key((fn, i))
                return CV(0.0)
            raise SpecializeError(f"dynamic {fn}() index in @sample")
        if fn in self.P.fn_defs:
            proto = self.P.fn_defs[fn]
            if self.depth >= MAX_INLINE_DEPTH:
                raise SpecializeError("user-function inline depth exceeded")
            args = [self.eval(a, scope) for a in n.args]
            args = (args + [CV(0.0)] * len(proto.params))[: len(proto.params)]
            inner = dict(zip(proto.params, args))
            self.depth += 1
            try:
                return self.eval(proto.body, inner)
            finally:
                self.depth -= 1
        if fn in ("min", "max", "pow", "atan2"):
            a = self.eval(n.args[0], scope)
            b = self.eval(n.args[1], scope)
            return self.call_math(fn, [a, b])
        if fn == "sqr":
            a = self.eval(n.args[0], scope)
            return self.binop("*", a, a)
        if fn in _SC_UNARY:
            return self.call_math(fn, [self.eval(n.args[0], scope)])
        if fn == "rand":
            if len(n.args) > 1:
                raise SpecializeError("rand expects 0 or 1 args")
            # a call site inside a data-dependent branch draws only when
            # its gate holds; the vector engine compacts draw indices with
            # a gate-count prefix sum so the MT19937 sequence matches the
            # golden's conditional consumption exactly
            slot = self.rand_slots
            self.rand_slots += 1
            self.order += 1
            args = (self._gate,) if self._gate is not None else ()
            self.rand_sites.append((slot, self._gate))
            u = TS(GNode("rand", args=args,
                         meta={"slot": slot, "order": self.order}))
            if n.args:
                limit = self.eval(n.args[0], scope)
            else:
                limit = CV(1.0)
            top = self.call_math("floor", [limit])
            if isinstance(top, CV):
                tv = top.v
                top = CV(tv if tv >= 1.0 else 1.0)
            else:
                ge = self.binop(">=", top, CV(1.0))
                top = TS(GNode("select",
                               args=(self._node(ge), self._node(top), 1.0)))
            scaled = self.binop("*", u, CV(1.0 / 4294967295.0))
            return self.binop("*", scaled, top)

        if fn == "__memtop":
            return CV(float(self.P.memtop))
        if fn == "freembuf":
            self.eval(n.args[0], scope)
            return CV(0.0)
        if fn.startswith("gfx_"):
            for a in n.args:
                self.eval(a, scope)
            return CV(0.0)
        raise SpecializeError(f"builtin {fn}() not vectorizable in @sample")


# ---------------------------------------------------------------------------
# recurrence classification


def _tarjan_sccs(adj: Dict[Any, Set]):
    """Iterative Tarjan over the var dependency graph; yields components."""
    index: Dict[Any, int] = {}
    low: Dict[Any, int] = {}
    on_stack: Set[Any] = set()
    stack: List[Any] = []
    counter = [0]
    out = []

    for root in adj:
        if root in index:
            continue
        work = [(root, iter(adj[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj[w])))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _prev_deps(node: Union[GNode, float], cache: Dict[int, Set],
               ring_writes: Optional[Dict] = None) -> Set:
    if not isinstance(node, GNode):
        return set()
    got = cache.get(id(node))
    if got is not None:
        return got
    cache[id(node)] = set()  # cycle guard (delay feedback creates real cycles)
    out: Set = set()
    if node.kind == "prev":
        out.add(node.meta["key"])
    if node.kind in ("ringref", "dynringref") and ring_writes is not None:
        for w in ring_writes.get(node.meta["region"]) or ():
            out |= _prev_deps(w.value, cache, ring_writes)
    for a in node.args:
        out |= _prev_deps(a, cache, ring_writes)
    cache[id(node)] = out
    return out


def _match_mod_induction(node, key) -> Optional[int]:
    """Detect a wrapped unit-step counter from the var's end-of-sample value
    in a discovery pass (where the var reads back as prev(key)):

        select(prev+1 >= M, 0,        prev+1)    v += 1; v >= M ? v = 0;
        select(prev+1 >  M-1, 0,      prev+1)
        select(prev+1 >= M, prev+1-M, prev+1)    v += 1; v >= M ? v -= M;
        maskidx(prev+1)                          v = (v + 1) & (M - 1);

    Returns the modulus M or None.  (Ref semantics: the JSFX circular-
    buffer idiom, e.g. SOMA.jsfx:550-551, Roomalizer.jsfx:366-367,
    Alias.jsfx:106.)"""
    def is_prev_plus_1(x) -> bool:
        if not (isinstance(x, GNode) and x.kind == "bin" and x.op == "+"):
            return False
        a, b = x.args
        for p, c in ((a, b), (b, a)):
            if isinstance(p, GNode) and p.kind == "prev" \
                    and p.meta["key"] == key and c == 1.0:
                return True
        return False

    if not isinstance(node, GNode):
        return None
    if node.kind == "maskidx" and is_prev_plus_1(node.args[0]):
        return int(node.meta["mod"])
    if node.kind != "select":
        return None
    cond, tv, ev = node.args
    if not (is_prev_plus_1(ev) and isinstance(cond, GNode)
            and cond.kind == "bin" and cond.args[0] is ev
            and isinstance(cond.args[1], float) and _is_int(cond.args[1])):
        return None
    lim = int(cond.args[1])
    if cond.op == ">=":
        M = lim
    elif cond.op == ">":
        M = lim + 1
    else:
        return None
    if M < 2:
        return None
    if tv == 0.0:
        return M
    if isinstance(tv, GNode) and tv.kind == "bin" and tv.op == "-" \
            and tv.args[0] is ev and tv.args[1] == float(M):
        return M
    return None


def _node_interval(node, memo=None) -> Optional[Tuple[float, float]]:
    """Static value interval of a time-series node, or None when
    unbounded.  Sound over +,-,*,min,max,abs,floor,ceil and the EEL clamp
    idioms (`x < lo ? x = lo` / `x > hi ? x = hi` lower to relational
    selects that are exactly max(x, lo) / min(x, hi)); everything else
    (inputs, ctrl streams, recurrences) is unknown.  Used to bound
    ctrl-dependent delay-tap expressions (ref 3DPanner.jsfx:2441-2448:
    sv_dN = floor((a + b*sv_size)*srate) with sv_size clamped to [0,1])."""
    if isinstance(node, float):
        return (node, node)
    if not isinstance(node, GNode):
        return None
    if memo is None:
        memo = {}
    got = memo.get(id(node))
    if got is not None:
        return got if got != "none" else None
    memo[id(node)] = "none"   # cycle guard -> unknown

    def iv(x):
        return _node_interval(x, memo)

    out: Optional[Tuple[float, float]] = None
    if node.kind == "bin" and node.op in ("+", "-", "*", "min", "max"):
        a, b = iv(node.args[0]), iv(node.args[1])
        if a is not None and b is not None:
            if node.op == "+":
                out = (a[0] + b[0], a[1] + b[1])
            elif node.op == "-":
                out = (a[0] - b[1], a[1] - b[0])
            elif node.op == "*":
                cs = (a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1])
                out = (min(cs), max(cs))
            elif node.op == "min":
                out = (min(a[0], b[0]), min(a[1], b[1]))
            else:
                out = (max(a[0], b[0]), max(a[1], b[1]))
    elif node.kind == "call" and node.op in ("floor", "ceil", "abs"):
        a = iv(node.args[0])
        if a is not None:
            # half-infinite intervals flow out of one-sided clamps;
            # math.floor/ceil raise on inf, so pass infinities through
            def _fl(v):
                return v if math.isinf(v) else math.floor(v)

            def _ce(v):
                return v if math.isinf(v) else math.ceil(v)

            if node.op == "floor":
                out = (_fl(a[0]), _fl(a[1]))
            elif node.op == "ceil":
                out = (_ce(a[0]), _ce(a[1]))
            else:
                lo = 0.0 if a[0] <= 0.0 <= a[1] else min(abs(a[0]), abs(a[1]))
                out = (lo, max(abs(a[0]), abs(a[1])))
    elif node.kind == "select":
        cond, tv, ev = node.args
        # relational clamps: select(X < c, c', X) == max-like when c'>=c
        # is not required — the EXACT identity select(X < c, c, X) ==
        # max(X, c) (and the > / >= , <= duals) needs c' == c and the
        # SAME X on both sides
        if isinstance(cond, GNode) and cond.kind == "bin" \
                and cond.op in ("<", "<=", ">", ">="):
            X, c = cond.args
            ivc = iv(c)
            if ev is X and ivc is not None and ivc[0] == ivc[1] \
                    and isinstance(tv, (float, GNode)):
                ivt = iv(tv)
                ivx = iv(X)
                if ivt is not None and ivt[0] == ivt[1] \
                        and ivt[0] == ivc[0]:
                    cval = ivc[0]
                    if ivx is None:
                        ivx = (-math.inf, math.inf)
                    if cond.op in ("<", "<="):
                        out = (max(ivx[0], cval), max(ivx[1], cval))
                    else:
                        out = (min(ivx[0], cval), min(ivx[1], cval))
        if out is None:
            a, b = iv(tv), iv(ev)
            if a is not None and b is not None:
                out = (min(a[0], b[0]), max(a[1], b[1]))
    memo[id(node)] = out if out is not None else "none"
    return out


def _match_gated_dyn(idx_node, mod: int):
    """maskidx( gringidx(var, off) - D ) with the matching modulus ->
    (var, off, D_node): a delay tap off a gated cursor at a time-varying
    (typically ctrl-derived) delay.  Legality (the bounded D keeps every
    read in carry history) is interval-checked at plan time."""
    if not (isinstance(idx_node, GNode) and idx_node.kind == "maskidx"
            and idx_node.meta["mod"] == mod):
        return None
    inner = idx_node.args[0]
    if not (isinstance(inner, GNode) and inner.kind == "bin"
            and inner.op == "-"):
        return None
    g, d = inner.args
    if not (isinstance(g, GNode) and g.kind == "gringidx"
            and g.meta["mod"] == mod and not g.meta["incl"]
            and g.meta["origin"] == 0):
        return None
    return (g.meta["var"], g.meta["offset"], d)


def _match_gated_mod_induction(node, key) -> Optional[int]:
    """select(gate, <wrap pattern of prev+1>, prev) — a wrapped counter
    that advances only when a per-sample gate fires (the gated delay-tank
    cursor idiom, ref 3DPanner.jsfx:2461-2462).  Returns the modulus M,
    or None.  The gate must not itself consume the cursor (its prefix
    count would then feed its own definition)."""
    if not (isinstance(node, GNode) and node.kind == "select"):
        return None
    cond, tv, ev = node.args
    if not (isinstance(ev, GNode) and ev.kind == "prev"
            and ev.meta["key"] == key):
        return None
    if not isinstance(tv, GNode):
        return None
    M = _match_mod_induction(tv, key)
    if M is None:
        return None
    # gate self-dependence check
    stack = [cond]
    seen: Set[int] = set()
    while stack:
        x = stack.pop()
        if not isinstance(x, GNode) or id(x) in seen:
            continue
        seen.add(id(x))
        if x.kind == "prev" and x.meta["key"] == key:
            return None
        stack.extend(a for a in x.args if isinstance(a, GNode))
    return M


def _feq(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


def _host_i64(v: float) -> int:
    """`eelmath.to_i64` of one host float: truncate toward zero, saturate
    outside int64, NaN gives 0."""
    if v != v:
        return 0
    if v >= 9223372036854775808.0:
        return 9223372036854775807
    if v <= -9223372036854775808.0:
        return -9223372036854775808
    return int(v)


def _gate_reader_spec(n) -> Tuple:
    """A `gringidx` or `gringref` node as the reader spec K6a takes:
    (kind, offset, mod, incl, origin, region)."""
    if n.kind == "gringidx":
        return ("position", n.meta["offset"], n.meta["mod"], n.meta["incl"],
                float(n.meta["origin"]), None)
    region = n.meta["region"]
    return ("value", n.meta["offset"], region[1], n.meta.get("incl", False),
            None, region)


# the plans whose slot the host mirror advances a segment (`_counter_next`)
_COUNTER_PLANS = ("induction", "modind", "const")


def _counter_next(plan, v, L: int):
    """A counter slot after a segment of L, one rule for the host mirror
    and the device: v is the slot before it, a Python float (the host
    mirror, the eager step) or an [nf, 1] f64 tensor (the graph's step),
    and both go through the same f64 operations in the same order.  An
    induction counter ends at w0 + out + L - 1; a modular one takes that
    by Python's float % (fmod, the divisor added where the signs differ,
    a zero remainder +0.0: `torch.remainder` then + 0.0 on the device);
    a constant is its value."""
    import torch

    if plan.kind == "const":
        return float(plan.out)
    w = v + float(plan.out + L - 1)
    if plan.kind == "induction":
        return w
    if isinstance(w, float):
        return w % float(plan.A)
    return torch.remainder(w, float(plan.A)) + 0.0


def _shared_value(values: Sequence[float], key) -> float:
    """The one value every file of a batch holds for a host-mirrored
    carried scalar; a batch whose files disagree on it is refused, never
    rendered with one file's value."""
    first = values[0]
    if any(_f64_bits(v) != _f64_bits(first) for v in values[1:]):
        raise SpecializeError(
            f"the files of a batch hold different values of the host-"
            f"mirrored carried scalar {key!r}: render them apart")
    return first


def _shared_known(rows: Sequence[Sequence[float]], mirrored: Sequence[int],
                  keys: Sequence[Any]) -> List[Optional[float]]:
    """The host mirror a batch starts from: carried scalar i as a float
    where every file holds the same bits, else None (the device holds
    it).  A mirrored slot (`mirrored_slots`) on which the files disagree
    raises a SpecializeError."""
    known: List[Optional[float]] = list(rows[0])
    mirrored_set = set(mirrored)
    for i in range(len(known)):
        col = [r[i] for r in rows]
        if i in mirrored_set:
            known[i] = _shared_value(col, keys[i])
        elif any(_f64_bits(v) != _f64_bits(col[0]) for v in col[1:]):
            known[i] = None
    return known


def _f64_bits(v: float) -> int:
    return struct.unpack("<q", struct.pack("<d", v))[0]


def _norm_loop(v, meta):
    """Masked fixpoint for range-normalization whiles (a tensor, or one
    Python float): iterate `v (+|-)= S where pred(v, C)` until no lane
    satisfies pred — identical rounding sequence to the golden's
    per-element loop."""
    C = float(meta["C"])
    S = float(meta["S"])
    op = meta["op"]

    def pred(z):
        if op == ">":
            return z > C
        if op == ">=":
            return z >= C
        if op == "<":
            return z < C
        return z <= C

    if isinstance(v, float):
        while pred(v):
            v = v + S
        return v
    import torch

    while True:
        p = pred(v)
        if not bool(p.any()):
            return v
        v = torch.where(p, v + S, v)



def _block_var_dataflow(program: PluginProgram, sample_writes: Set[Any],
                        mem_taint: bool = True, sb_taint: bool = True,
                        include_slider: bool = False
                        ) -> Tuple[Set[str], Dict[str, Set[str]]]:
    """Audio-taint + var-dependency analysis over @block (control
    dependences included).

    Returns (tainted, deps): a var is TAINTED if any path to its value
    reads audio-rate state (@sample-written vars, spl registers, mem,
    midi/comm/rand), or it is assigned under such a condition; deps[v] is
    the set of @block/global vars (transitively via locals and calls)
    feeding v's value or its guarding conditions — untainted vars depend
    only on their deps plus frozen constants, so a host probe whose clean
    dependency closure repeats across two blocks repeats forever."""
    tainted: Set[str] = {k[1] for k in sample_writes if k[0] == "var"}
    if sb_taint:
        # samplesblock differs in the remainder block; values derived from
        # it are not block-invariant.  With sb_taint=False the caller must
        # validate candidates empirically against odd-sized blocks.
        tainted.add("samplesblock")
    deps: Dict[str, Set[str]] = {}
    TAINT_CALLS = frozenset({
        "midirecv", "midirecv_buf", "msg_recv", "msg_recv_buf", "msg_avail",
        "msg_kind", "msg_length", "msg_dropped", "msg_peer_count",
        "gmem_get", "rand", "gfx_getchar", "sample_read", "sample_read2",
        "sample_get", "slider_next_chg",
    })
    # (taint, reads) pair per expression; `scope` maps fn params to pairs
    Pair = Tuple[bool, Set[str]]

    def read_name(ident: str, scope) -> Pair:
        got = scope.get(ident)
        if got is not None:
            return got
        if dollar_const(ident) is not None:
            return (False, set())
        if spl_index(ident) is not None:
            return (True, set())
        return (ident in tainted, {ident})

    def walk_e(n: Node, scope, cond: Pair) -> Pair:
        if isinstance(n, (Const, Str)):
            return (False, set())
        if isinstance(n, Name):
            return read_name(n.ident, scope)
        if isinstance(n, Mem):
            walk_e(n.base, scope, cond)
            walk_e(n.index, scope, cond)
            # mem: conservative audio-shared blob; the settle probe's
            # poison test justifies dropping this taint (mem_taint=False)
            return (mem_taint, set())
        if isinstance(n, Un):
            return walk_e(n.operand, scope, cond)
        if isinstance(n, Bin):
            a = walk_e(n.lhs, scope, cond)
            if n.op in ("&&", "||"):
                b = walk_e(n.rhs, scope,
                           (cond[0] or a[0], cond[1] | a[1]))
            else:
                b = walk_e(n.rhs, scope, cond)
            return (a[0] or b[0], a[1] | b[1])
        if isinstance(n, Asn):
            val = walk_e(n.value, scope, cond)
            t = n.target
            if isinstance(t, Name):
                out_t = val[0] or cond[0]
                out_r = val[1] | cond[1]
                if n.op != "=":
                    cur = read_name(t.ident, scope)
                    out_t = out_t or cur[0]
                    out_r = out_r | cur[1]
                if t.ident in scope:
                    prev = scope[t.ident]
                    scope[t.ident] = (prev[0] or out_t, prev[1] | out_r)
                else:
                    if out_t:
                        tainted.add(t.ident)
                    deps.setdefault(t.ident, set()).update(out_r)
                return (out_t, out_r)
            if isinstance(t, Mem):
                walk_e(t.base, scope, cond)
                walk_e(t.index, scope, cond)
                return (True, val[1])
            if isinstance(t, CallExpr):
                for a in t.args:
                    walk_e(a, scope, cond)
            return val
        if isinstance(n, Cond):
            c = walk_e(n.pred, scope, cond)
            inner = (cond[0] or c[0], cond[1] | c[1])
            a = walk_e(n.then, scope, inner)
            b = walk_e(n.other, scope, inner)
            return (c[0] or a[0] or b[0], c[1] | a[1] | b[1])
        if isinstance(n, IfStmt):
            c = walk_e(n.pred, scope, cond)
            inner = (cond[0] or c[0], cond[1] | c[1])
            walk_e(n.then, scope, inner)
            if n.other is not None:
                walk_e(n.other, scope, inner)
            return (False, set())
        if isinstance(n, (LoopExpr, WhileStmt)):
            cnt = n.count if isinstance(n, LoopExpr) else n.pred
            c = walk_e(cnt, scope, cond)
            inner = (cond[0] or c[0], cond[1] | c[1])
            b = walk_e(n.body, scope, inner)
            return (c[0] or b[0], c[1] | b[1])
        if isinstance(n, Block):
            out: Pair = (False, set())
            for item in n.items:
                out = walk_e(item, scope, cond)
            return out
        if isinstance(n, CallExpr):
            arg_ps = [walk_e(a, scope, cond) for a in n.args]
            f = n.func
            if f in program.fn_defs:
                proto = program.fn_defs[f]
                inner_scope: Dict[str, Pair] = {}
                for i, p in enumerate(proto.params):
                    inner_scope[p] = (arg_ps[i] if i < len(arg_ps)
                                      else (False, set()))
                return walk_e(proto.body, inner_scope, cond)
            if f in TAINT_CALLS or f == "spl":
                return (True, set())
            t = any(p[0] for p in arg_ps)
            r: Set[str] = set()
            for p in arg_ps:
                r |= p[1]
            return (t, r)
        return (True, set())  # unknown node: conservative

    stmts = list(program.sections.get("block", []))
    if include_slider:
        # @block can retrigger @slider: its recomputations are part of the
        # per-block dataflow (ref: dsp_jsfx_aot.py:5788-5804)
        stmts += list(program.sections.get("slider", []))
    for _ in range(6):  # taint only grows; small fixpoint
        before = (len(tainted), sum(len(v) for v in deps.values()))
        for stmt in stmts:
            walk_e(stmt, {}, (False, set()))
        if (len(tainted), sum(len(v) for v in deps.values())) == before:
            break
    return tainted, deps


def _iter_nodes(root):
    seen: Set[int] = set()
    stack = [root]
    while stack:
        n = stack.pop()
        if not isinstance(n, GNode) or id(n) in seen:
            continue
        seen.add(id(n))
        yield n
        stack.extend(a for a in n.args if isinstance(a, GNode))


def _dyn_write_bound(sym, idx_node) -> Optional[int]:
    """Prove an upper bound for a dynamic write index.

    Direct mask/wrap forms carry their own modulus; a bare prev(cursor)
    read takes its bound from the cursor's own wrap-reset pattern
    (select(prev-chain >= M, 0, ...)) plus an in-range start value."""
    if not isinstance(idx_node, GNode):
        return None
    if idx_node.kind == "maskidx":
        return int(idx_node.meta["mod"])
    if idx_node.kind == "gringidx":
        # a gated cursor is in [0, M) by construction
        if idx_node.meta["offset"] == 0 and idx_node.meta["origin"] == 0:
            return int(idx_node.meta["mod"])
        return None
    if idx_node.kind != "prev":
        return None
    key = idx_node.meta["key"]
    out = sym.env.get(key)
    node = out.node if isinstance(out, TS) else None
    if node is None:
        return None

    def contains_prev(x) -> bool:
        return any(n.kind == "prev" and n.meta["key"] == key
                   for n in _iter_nodes(x)) if isinstance(x, GNode) else False

    best: Optional[int] = None
    for x in _iter_nodes(node):
        if x.kind != "select":
            continue
        cond, tv, _ev = x.args
        if not (isinstance(cond, GNode) and cond.kind == "bin"
                and cond.op in (">=", ">") and tv == 0.0):
            continue
        lhs, lim = cond.args
        if isinstance(lim, float) and _is_int(lim) and contains_prev(lhs):
            m = int(lim) + (1 if cond.op == ">" else 0)
            best = m if best is None else max(best, m)
    if best is None or best < 1:
        return None
    start = sym._state_value(key)
    if not (_is_int(start) and 0 <= start < best):
        return None
    return best


def _node_integral(x) -> bool:
    """Conservatively prove an index expression is integer-valued (an
    EEL2 f64 holding an exact integer).  Integrality makes truncation
    commute with the time split in `_mod_slope`, so a uniform-delay read
    can safely lower as one dynamic_slice."""
    if not isinstance(x, GNode):
        return isinstance(x, float) and _is_int(x)
    if x.kind in ("ind", "ringidx", "maskidx"):
        return True                     # cursor positions / masked indices
    if x.kind == "bin":
        if x.op in ("&", "|", "~", "<<", ">>", "%",
                    "<", "<=", ">", ">=", "==", "!="):
            return True                 # EEL2 bitwise/compare: int results
        if x.op in ("+", "-", "*", "min", "max"):
            return all(_node_integral(a) for a in x.args)
        return False
    if x.kind == "call":
        if x.op in ("floor", "ceil", "not", "sign"):
            return True
        if x.op in ("abs", "fabs"):
            return _node_integral(x.args[0])
        return False
    if x.kind == "select":
        return (_node_integral(x.args[1]) and _node_integral(x.args[2]))
    return False


def _mod_slope(x, mod: int) -> Optional[int]:
    """Slope of an index expression in the per-sample time index, valid
    modulo `mod`: 0 = time-invariant over the segment, 1 = `t +
    invariant`, None = anything else (a genuinely time-varying delay).

    Wrapping subexpressions are congruence-transparent when their
    modulus matches: pow2 masks (`eel_and` is two's-complement, == mod
    for negatives too), wrapped cursors (true mod), and the
    runtime-wrap idiom `select(X < 0, X + M, X)`."""
    memo: Dict[int, object] = {}

    def rec(n):
        if not isinstance(n, GNode):
            return 0 if (isinstance(n, float) and _is_int(n)) else None
        got = memo.get(id(n), "?")
        if got != "?":
            return got
        memo[id(n)] = None              # cycle-safe default
        r = None
        if n.kind == "ind":
            r = 1
        elif n.kind == "ringidx":
            r = 1 if int(n.meta["mod"]) == mod else None
        elif n.kind == "maskidx":
            if int(n.meta["mod"]) == mod:
                r = rec(n.args[0])
        elif n.kind == "bin":
            if n.op in ("+", "-"):
                a, b = rec(n.args[0]), rec(n.args[1])
                if a is not None and b is not None:
                    s = a + b if n.op == "+" else a - b
                    r = s if s in (0, 1) else None
            elif n.op in ("*", "/", "%", "min", "max", "pow", "atan2",
                          "&", "|", "~", "<<", ">>",
                          "<", "<=", ">", ">=", "==", "!="):
                if rec(n.args[0]) == 0 and rec(n.args[1]) == 0:
                    r = 0
        elif n.kind == "call":
            if rec(n.args[0]) == 0:
                r = 0
        elif n.kind == "select":
            c, tv, ev = n.args
            # wrap idiom: both branches congruent (tv = ev + mod)
            if (isinstance(tv, GNode) and tv.kind == "bin"
                    and tv.op == "+"
                    and ((tv.args[0] is ev and tv.args[1] == float(mod))
                         or (tv.args[1] is ev
                             and tv.args[0] == float(mod)))):
                r = rec(ev)
            elif rec(c) == 0:
                a, b = rec(tv), rec(ev)
                if a == b and a in (0, 1):
                    r = a
        memo[id(n)] = r
        return r

    return rec(x)


def _linearize(node: Union[GNode, float], key, cache: Dict[int, Set],
               ring_writes: Optional[Dict] = None):
    """Match node == A * prev(key) + B with A, B free of prev(key).

    Returns (A, B) as graph-or-float operands, or None.
    """
    def free(x) -> bool:
        return key not in _prev_deps(x, cache, ring_writes)

    def mk(op, a, b):
        if isinstance(a, float) and isinstance(b, float):
            return _SC_BINARY[op](a, b)
        if op == "+":
            if isinstance(a, float) and a == 0.0:
                return b
            if isinstance(b, float) and b == 0.0:
                return a
        if op == "*":
            if isinstance(a, float) and a == 1.0:
                return b
            if isinstance(b, float) and b == 1.0:
                return a
            if (isinstance(a, float) and a == 0.0) or (isinstance(b, float) and b == 0.0):
                return 0.0
        return GNode("bin", op=op, args=(a, b))

    memo: Dict[int, Any] = {}
    _MISS = object()

    def rec(x):
        if not isinstance(x, GNode):
            return (0.0, x)
        got = memo.get(id(x), _MISS)
        if got is not _MISS:
            return got
        out = _rec(x)
        memo[id(x)] = out
        return out

    def _rec(x):
        if x.kind == "prev" and x.meta["key"] == key:
            return (1.0, 0.0)
        if free(x):
            return (0.0, x)
        if x.kind == "bin" and x.op in ("+", "-"):
            la = rec(x.args[0])
            lb = rec(x.args[1])
            if la is None or lb is None:
                return None
            if x.op == "+":
                return (mk("+", la[0], lb[0]), mk("+", la[1], lb[1]))
            return (mk("-", la[0], lb[0]), mk("-", la[1], lb[1]))
        if x.kind == "bin" and x.op == "*":
            a, b = x.args
            if free(a):
                rb = rec(b)
                if rb is None:
                    return None
                return (mk("*", a, rb[0]), mk("*", a, rb[1]))
            if free(b):
                ra = rec(a)
                if ra is None:
                    return None
                return (mk("*", ra[0], b), mk("*", ra[1], b))
            return None
        if x.kind == "select":
            c, t, e = x.args
            if not free(c):
                return None
            rt = rec(t)
            re_ = rec(e)
            if rt is None or re_ is None:
                return None
            return (GNode("select", args=(c, rt[0], re_[0])) if not (
                        isinstance(rt[0], float) and isinstance(re_[0], float)
                        and rt[0] == re_[0]) else rt[0],
                    GNode("select", args=(c, rt[1], re_[1])))
        return None

    return rec(node)


# ---------------------------------------------------------------------------
# kernel construction


@dataclass
class _VarPlan:
    kind: str                      # const/induction/linrec/stream
    out: Any = None                # GNode | float  (stream value of the var)
    A: Any = None
    B: Any = None
    step: int = 0


@dataclass(eq=False)
class _TapChain:
    """A left-leaning `+` chain of constant-gain taps of one ring region,
    folded by `ring_tap_sum`: `acc = init; acc = acc + g * buf[s + t]`."""
    root: GNode                    # the chain's last `+`
    init: Any                      # GNode | float, the chain's first operand
    region: Tuple[int, int]        # (origin, mod)
    needs_src: bool                # a tap reads this segment's write stream
    starts: List[int]              # mod - delay, in fold order
    gains: List[float]


@dataclass(eq=False)
class _TapGroup:
    """Chains folded by one `ring_tap_sum` launch, with their tables."""
    members: List[_TapChain]
    tables: Any                    # kernels.ring_taps.TapTables


class SpecializedSampleKernel:
    """Compiled, segment-scanned render kernel for one plugin config."""

    # a `+` chain of constant-gain ring taps goes to the ring_tap_sum
    # kernel from this many taps up; shorter ones go node by node
    MIN_CHAIN_TAPS = 2

    def __init__(self, program: PluginProgram, snapshot, nch: int,
                 segment_len: int = 1 << 17, block_size: int = 512,
                 masked_loop_k: Optional[int] = None, device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self.P = program
        self.snap = snapshot
        self.nch = nch
        self.B = int(block_size)
        self.L = max(self.B, (int(segment_len) // self.B) * self.B)
        # guessed bound for data-dependent loop(n) masked unrolls; the
        # overflow ladder in render_device doubles it when a render's
        # realized n exceeds the guess (see _SymExec._masked_loop)
        self.masked_loop_k = int(
            masked_loop_k if masked_loop_k is not None
            else os.environ.get("ZORAK_MASKED_LOOP_K", 32))
        # unrolled FIR banks / deep branch merges build node graphs past
        # CPython's default recursion ceiling
        if sys.getrecursionlimit() < 100_000:
            sys.setrecursionlimit(100_000)

        if not program.sections.get("sample"):
            raise SpecializeError("no @sample section")

        # @block support, two regimes:
        #  - audio-independent @block: the whole trajectory is interpreted
        #    on the host and enters the device program as piecewise-constant
        #    control streams (one value per block),
        #  - audio-COUPLED @block (reads meters/accumulators @sample
        #    computes, rewrites audio-rate state, or shares mem with
        #    @sample): the section compiles to device code and runs
        #    between vectorized sample segments inside ONE fused scan.
        self.has_block = bool(program.sections.get("block"))
        self._block_has_midi = self._section_calls("block", "midirecv")
        self.control_vars: Set[Any] = set()
        self.block_writes_mem = False
        self.block_reads_mem = False
        self.coupled = False
        self._block_writes: Set[Any] = set()
        self._block_consts: Dict[Any, float] = {}
        # baked regime: @block mem writes that settle after the first block
        self._block_settled = False
        self._settled_cells: Set[int] = set()
        self._bake_state = None
        # @block-written sample vars pending settle validation
        self._fb_vars: Set[Any] = set()
        self._retriggers = False
        # hop regime: an extracted every-N-samples device section
        self._hop = None
        self._hop_body: Optional[List[Node]] = None
        self._hop_ctr: Optional[Tuple[str, str]] = None
        self._hop_len = 0
        self._mirrored: Optional[List[int]] = None
        self._sample_stmts: List[Node] = list(
            program.sections.get("sample") or [])
        self._extract_hop()
        if self.has_block:
            _, writes_b, wmem_b, rmem_b = section_var_usage(program, "block")
            reads_b = section_genuine_reads(program, "block")
            sample_writes = assigned_vars_of_sample(program)
            # @block writing mem[] is allowed when @sample's mem accesses
            # are all concrete-addressed: those cells join the control
            # trajectory (per-block coefficient tables).  Verified after
            # symbolic execution below.
            self.block_writes_mem = wmem_b
            self.block_reads_mem = rmem_b
            # @slider joins the trajectory only if @block can retrigger it
            retriggers = any(
                isinstance(n, CallExpr)
                and n.func in ("sliderchange", "slider_automate")
                for stmt in program.sections.get("block", [])
                for n in walk(stmt))
            writes_sl: Set[Any] = set()
            if retriggers:
                _, writes_sl, wmem_sl, _rm = section_var_usage(program, "slider")
                if wmem_sl:
                    raise SpecializeError(
                        "@slider (re-run from @block) writes mem[]")
            spl_keys = {("spl", c) for c in range(64)}
            hot = reads_b & (sample_writes | spl_keys)
            # feedback only matters for vars @sample genuinely consumes
            # across samples; scratch vars written-first in both
            # sections are dead at the block boundary
            sample_greads = section_genuine_reads(program, "sample")
            fb = (writes_b | writes_sl) & sample_writes & sample_greads
            self._block_writes = writes_b | writes_sl
            self.control_vars = (writes_b | writes_sl) - sample_writes
            self._ctrl_baseline = set(self.control_vars)
            self._retriggers = retriggers
            # fold block-1-fixpoint control vars as constants up front:
            # gating flags like `ir_ready` must be static for the ring
            # machinery to see through their branches
            self._discover_block_consts()
            if hot:
                self._require_devblock()
            elif fb:
                # @block WRITES sample state but never reads it (hot is
                # empty): typically one-time reload resets.  Defer to the
                # settle probe, whose sentinel test proves blocks 2+ leave
                # these vars alone; genuine rewriting falls back to the
                # device @block.
                self._fb_vars = {k for k in fb if k[0] == "var"}

        tried_opt = False
        while True:
            try:
                sym = self._stable_symexec()
                break
            except _CoupledUpgrade as up:
                poison = up.spans if (up.reason == "reads"
                                      or self.block_reads_mem) else None
                if not self._block_settled \
                        and self._try_block_settle(poison):
                    # baked regime: kernel mem view = post-block-1 heap,
                    # @block stays a host trajectory, no device section
                    self._discover_block_consts(mem_taint=False)
                    continue
                self._require_devblock()
            except SpecializeError:
                # mem-read taint may have blocked the very const folds
                # (gating flags) that make the plugin expressible; retry
                # optimistically — the post-symexec upgrade path then
                # VALIDATES the assumption with the settle/poison probe
                if self.has_block and not tried_opt and not self.coupled:
                    tried_opt = True
                    before = set(self._block_consts)
                    self._discover_block_consts(mem_taint=False)
                    if set(self._block_consts) != before:
                        continue
                raise
        self._plan(sym)
        self.ctrl_order = sorted(sym.ctrl_nodes.keys(), key=repr)
        self._devblock = None
        self._devslider = None
        self._block_prog = None
        self._hop_prog = None
        if self.coupled:
            self._build_devblock()
        if self._hop_body is not None:
            self._build_hop()
        self.n_rand = sym.rand_slots
        if self.n_rand and self.has_block:
            for stmt in program.sections.get("block", []):
                for nd in walk(stmt):
                    if isinstance(nd, CallExpr) and nd.func == "rand":
                        raise SpecializeError(
                            "rand() in both @block and @sample — draw "
                            "interleaving not reproducible")
        # out events: (offset, b1, b2, b3) short / + (payload_bytes,) long
        self.last_midi_out: List[Tuple] = []
        self._traj_midi_out: List[Tuple] = []
        self._traj_cache: Dict[Tuple[int, int], Any] = {}
        # device-resident master of the fresh-render carry
        self._carry0 = None
        # the generator state after this kernel's draws; in the gated
        # regime also the state before the pool (only `used` of its draws
        # are real, see _advance_rng_by_used)
        self._rng_state = None
        self._rng_prestate = None
        # T -> (a fresh ungated render's draw matrix [T, n_rand], f64 on
        # the kernel's device, and the generator state after it): a fresh
        # render draws from snap.rng, so the matrix is a pure function of T
        self._rand_cache: Dict[int, Tuple[Any, Any]] = {}
        self._traj_plugin = None
        self.last_control_state = None
        self._seg_fns: Dict[Any, Callable] = {}
        self._graph_seg_fns: Dict[Any, Callable] = {}
        # K5: the static buffers and captured steps (made at the first
        # captured render), what the last render's steps ran as ("graph",
        # "static" or "eager: <why>") and the host mirror it ended with
        self._k5 = None
        self.dispatch: Optional[str] = None
        self._k5_mirror: Optional[List[Optional[float]]] = None
        # per-kernel device constants: 0-d tensors by value, and, by
        # segment length, the ring tap chains' launches (or None) by `+`
        # node (`_tap_plan`)
        self._const_cache: Dict[Any, Any] = {}
        self._tap_tables: Dict[Tuple[int, int], Dict[int, Any]] = {}
        # a gated cursor's readers that K6a serves in one launch, by cursor
        # var (`_gate_readers`)
        self._gate_reader_specs: Dict[Any, Any] = {}
        # the lowered scan-group levels (step list, externals, generated
        # source) by DAG level
        self._scan_programs: Dict[int, Any] = {}
        # the scan groups' DAGs lowered now, by DAG level: a group K4
        # cannot run refuses here, at build, where the engine falls back,
        # not at the first render (the program text is made at the first
        # segment, from these steps)
        self._scan_steps: Dict[int, Any] = {
            level: self._scan_level_steps(level)
            for level in sorted({self.scan_levels.get(i, 0)
                                 for i in range(len(self.scan_groups))})}
        # why K5 cannot capture this plan's step, or None: decided here,
        # from the plan alone (`_find_k5_refusal`)
        self.k5_refusal: Optional[str] = self._find_k5_refusal()

    def _require_devblock(self) -> None:
        """Switch to the coupled regime: @block must print as device code
        (raises SpecializeError with the devgen reason if it cannot, at
        build time, not at render time).  Also discovers block-invariant
        constants: @block vars unconditionally re-derived from frozen
        slider/init state each block fold as constants in @sample instead
        of control streams."""
        if self.coupled:
            return
        from .devgen import DeviceSection, DevgenError, section_dynamic_keys

        try:
            # a trial heap as large as the reference's: the sizing below
            # needs the plan, and only a static address past it refuses
            trial_sz = 1 << max(22, int(max(self.P.memtop or 0,
                                            len(self.snap.mem))
                                        - 1).bit_length())
            msg_cfg = self._make_msg_cfg()
            layout = self._devblock_layout()
            DeviceSection(self.P, self.snap, "block",
                          section_dynamic_keys(self.P, ("block", "sample")),
                          trial_sz, msg_cfg=msg_cfg, layout_bodies=layout)
            if self._retriggers:
                # @block can retrigger @slider: that section must print
                # as device code too (K10 runs it when a mask is pending)
                DeviceSection(self.P, self.snap, "slider",
                              section_dynamic_keys(
                                  self.P, ("block", "slider", "sample")),
                              trial_sz, msg_cfg=msg_cfg, layout_bodies=layout)
        except DevgenError as exc:
            raise SpecializeError(f"audio-coupled @block: {exc}") from None

        self._discover_block_consts()
        self.coupled = True

    def _build_devblock(self) -> None:
        """Size the device heap, print @block (and @slider where @block
        retriggers it) and K10's exchanges with the sample side."""
        from ..kernels.block_section import BlockSectionProgram
        from .devgen import (DeviceSection, DevgenError, HostTables,
                             section_dynamic_keys)

        top = len(self.snap.mem)
        top = max(top, int(self.P.memtop or 0))
        for origin, mod in self.carry_regions:
            top = max(top, origin + mod)
        for key in self.carried_vars:
            if key[0] == "mem":
                top = max(top, key[1] + 1)
        for key in self.ctrl_order:
            if key[0] == "mem":
                top = max(top, key[1] + 1)
        blocked = self._probe_block_mem_writes()
        if blocked:
            top = max(top, max(blocked) + 1)
        size = 1 << max(12, int(top - 1).bit_length() if top > 1 else 12)
        secs = ("block", "slider", "sample") if self._retriggers \
            else ("block", "sample")
        self._dev_dyn = section_dynamic_keys(self.P, secs)
        msg_cfg = self._make_msg_cfg()
        layout = self._devblock_layout()
        # one program's host-service tables (K10 passes them every block)
        tables = HostTables()
        try:
            self._devblock = DeviceSection(
                self.P, self.snap, "block", self._dev_dyn, size,
                msg_cfg=msg_cfg, layout_bodies=layout, tables=tables)
            self._devslider = DeviceSection(
                self.P, self.snap, "slider", self._dev_dyn, size,
                msg_cfg=msg_cfg, layout_bodies=layout, tables=tables) \
                if self._retriggers else None
        except DevgenError as exc:
            raise SpecializeError(f"audio-coupled @block: {exc}") from None
        dev = self._devblock
        ctrl = []
        for key in self.ctrl_order:
            if key in dev.slots:
                ctrl.append(("v", dev.slots[key]))
            elif key[0] == "mem":
                ctrl.append(("m", key[1]))
            else:
                raise SpecializeError(
                    f"coupled control key {key!r} has no device source")
        si = self.scalar_index
        self._block_prog = BlockSectionProgram(
            dev, self._devslider, len(self.carried_vars),
            [(si[k], dev.slots[k]) for k in self.carried_vars
             if k in dev.slots],
            self.carry_regions,
            [(si[k], k[1]) for k in self.carried_vars if k[0] == "mem"],
            ctrl)
        # carried scalars K10 may rewrite: the host's mirror of them is
        # void after each block
        self._block_rewrites = sorted(
            si[k] for k in self.carried_vars
            if k in self._block_writes
            or (k[0] == "mem" and self.block_writes_mem))

    def _devblock_layout(self) -> List[List[Node]]:
        """The sections that share K10's heap: @block, and the @slider it
        retriggers."""
        secs = ("block", "slider") if self._retriggers else ("block",)
        return [list(self.P.sections.get(sec) or []) for sec in secs]

    def _make_msg_cfg(self):
        """The live bus of the device @block (the reference's
        `_make_msg_cfg`, its specialize.py:2732): where the snapshot's
        host is a live InstanceComm and a DSP section touches the bus.
        The channel ids are one dict a CommWorld, so every member of a
        graph prints the same ids."""
        from ..comm.bus import InstanceComm
        from .devgen import MsgConfig, bus_touch

        host = getattr(self.snap, "host", None)
        if not isinstance(host, InstanceComm) \
                or getattr(host, "comm_solo", False) \
                or not bus_touch(self.P)[0]:
            return None
        world = host.world
        ids = getattr(world, "msg_chan_ids", None)
        if ids is None:
            ids = world.msg_chan_ids = {}
        return MsgConfig(ids, host)

    def _build_hop(self) -> None:
        """Print the extracted hop body (FFT block work fired every N
        samples from inside @sample) as the device section "sample-hop",
        and K10's program for it: `_hop_run` launches it after each hop's
        segment (ref: PsychoConvolver.jsfx:355-420
        process_convolution_block behind the block_fill counter).  The
        refusals are the reference's; its check is printing the
        section."""
        from ..kernels.block_section import BlockSectionProgram
        from .devgen import DeviceSection, DevgenError

        sym = self.sym
        key, N = self._hop_ctr, self._hop_len
        if key not in sym.writes and key not in sym.mod_inductions:
            # the guarded region folded away (e.g. no IR loaded): the hop
            # can never fire — plain pipeline
            self._hop_body = None
            self._hop = None
            return
        if self.coupled:
            raise SpecializeError(
                "hop section alongside a device @block — not supported yet")
        if sym.mod_inductions.get(key) != N:
            raise SpecializeError(
                "hop counter did not classify as a mod-N cursor")
        c0 = int(sym._state_value(key))
        if N % self.B or (N - c0) % self.B:
            raise SpecializeError(
                f"hop length {N} (phase {c0}) not aligned to the "
                f"block grid ({self.B})")
        self._hop_phase = c0
        self._hop_phase0 = c0

        # vars the hop body writes: the vector side must never touch them
        hop_writes: Set[Any] = set()
        seen_fns: Set[str] = set()

        def scan(roots):
            for root in roots:
                for x in walk(root):
                    if isinstance(x, Asn) and isinstance(x.target, Name):
                        hop_writes.add(_env_key_for_name(x.target.ident))
                    elif isinstance(x, CallExpr) \
                            and x.func in self.P.fn_defs \
                            and x.func not in seen_fns:
                        seen_fns.add(x.func)
                        scan([self.P.fn_defs[x.func].body])

        scan(self._hop_body)
        if any(k[0] != "var" for k in hop_writes):
            raise SpecializeError("hop body writes spl/slider state")
        touched = set(sym.env.keys()) | set(self.control_vars) \
            | set(self._block_consts)
        clash = hop_writes & touched
        if clash:
            raise SpecializeError(
                f"hop body state {sorted(clash)[:3]} is also used by the "
                "vectorized sample path")

        # vars the hop body READS: anything the vectorized sample path
        # writes per-sample is not in the hop's dynamic keys, so the
        # device section would fold it to its static snapshot value —
        # silently wrong audio. Reject honestly instead.
        hop_reads: Set[Any] = set()
        seen_fns.clear()

        def scan_reads(roots):
            for root in roots:
                for x in walk(root):
                    if isinstance(x, Name):
                        hop_reads.add(_env_key_for_name(x.ident))
                    elif isinstance(x, CallExpr) \
                            and x.func in self.P.fn_defs \
                            and x.func not in seen_fns:
                        seen_fns.add(x.func)
                        scan_reads([self.P.fn_defs[x.func].body])

        scan_reads(self._hop_body)
        hop_reads -= hop_writes
        varying = (set(sym.writes) | set(self.carried_vars)
                   | set(self.control_vars))
        stale = {k for k in hop_reads & varying if k[0] != "mem"}
        if stale:
            raise SpecializeError(
                f"hop body reads {sorted(stale)[:3]} which the sample/"
                "control path updates — the device section would fold it "
                "to a stale snapshot")

        top = len(self.snap.mem)
        top = max(top, int(self.P.memtop or 0))
        for origin, mod in self.carry_regions:
            top = max(top, origin + mod)
        for k in self.carried_vars:
            if k[0] == "mem":
                top = max(top, k[1] + 1)
        for k in self.ctrl_order:
            if k[0] == "mem":
                top = max(top, k[1] + 1)
        size = 1 << max(12, int(top - 1).bit_length() if top > 1 else 12)
        snap_h = self._bake_state if self._bake_state is not None \
            else self.snap
        try:
            # samplesblock is K10's argument: `_hop_run` passes the
            # kernel's B, the value the reference folds through `consts`
            self._hop = DeviceSection(self.P, snap_h, "sample-hop",
                                      hop_writes, size, body=self._hop_body)
        except DevgenError as exc:
            self._hop = None
            raise SpecializeError(f"hop section: {exc}") from None
        si = self.scalar_index
        # the hop sees no carried scalar but the mem cells: its vars are
        # its own, written by nothing on the sample side (checked above)
        self._hop_prog = BlockSectionProgram(
            self._hop, None, len(self.carried_vars), [],
            self.carry_regions,
            [(si[k], k[1]) for k in self.carried_vars if k[0] == "mem"], [])
        # carried scalars K10 rewrites that the host mirrors: the
        # reference's refusals leave none (its cells are heap cells, and
        # the mirror holds cursors and counters)
        hop_rewrites = set(si[k] for k in self.carried_vars
                           if k[0] == "mem") & set(self.mirrored_slots())
        assert not hop_rewrites, hop_rewrites

    def _discover_block_consts(self, mem_taint: bool = True) -> None:
        if not self.has_block:
            return
        # idempotent: always restart from the pre-fold control set
        self.control_vars = set(getattr(self, "_ctrl_baseline",
                                        self.control_vars))
        return self._discover_block_consts_inner(mem_taint)

    def _discover_block_consts_inner(self, mem_taint: bool = True) -> None:
        """Block-invariant constant discovery: audio-UNTAINTED @block vars
        evolve independently of the device, so the host can probe them.
        If the untainted state reaches a fixpoint after the FIRST block
        (state after block 1 == after block 2), those values hold during
        every block's samples and fold as CVs in @sample — e.g. filter
        lengths/coefficients rebuilt once behind a need_rebuild flag
        (ref shape: TSEQ.jsfx @block rebuild_all/update_consts gate)."""
        self._block_consts = {}
        try:
            sample_writes = assigned_vars_of_sample(self.P)
            tainted, deps = _block_var_dataflow(
                self.P, sample_writes, mem_taint=mem_taint,
                include_slider=self._retriggers)
            # soft candidates: only blocked by the samplesblock taint
            # (remainder-block conservatism); they can still fold after an
            # empirical sweep injecting odd-sized blocks
            tainted_ns, deps_ns = _block_var_dataflow(
                self.P, sample_writes, mem_taint=mem_taint, sb_taint=False,
                include_slider=self._retriggers)
            ctrl_names = {k[1] for k in self.control_vars if k[0] == "var"}
            clean = {n for n in ctrl_names if n not in tainted}
            soft = {n for n in ctrl_names
                    if n not in tainted_ns and n in tainted}
            if clean or soft:
                from ..shadow import compile_shadow

                plug = compile_shadow(self.P)
                plug.state = self._probe_state()

                def _probe_block():
                    stp = plug.state
                    stp.samplesblock = float(self.B)
                    plug.run_block()
                    if (stp.pending_change_mask or stp.pending_automate_mask
                            or stp.pending_automate_end_mask):
                        plug.run_slider()
                        stp.pending_change_mask = 0
                        stp.pending_automate_mask = 0
                        stp.pending_automate_end_mask = 0

                _probe_block()
                v1 = dict(plug.state.V)
                _probe_block()
                v2 = dict(plug.state.V)

                def stable(name: str) -> bool:
                    return _feq(float(v1.get(name, 0.0)),
                                float(v2.get(name, 0.0)))

                # a clean var folds only if its whole clean dependency
                # closure repeats between block 1 and 2 (then by induction
                # it repeats forever — clean vars read no audio state)
                def mk_ok(tset, dmap):
                    closure_ok: Dict[str, bool] = {}

                    def ok(name: str, stack: Set[str]) -> bool:
                        got = closure_ok.get(name)
                        if got is not None:
                            return got
                        if name in stack:
                            return stable(name)
                        if name in tset or not stable(name):
                            closure_ok[name] = False
                            return False
                        stack.add(name)
                        out = all(ok(d, stack) for d in dmap.get(name, ())
                                  if dollar_const(d) is None)
                        stack.discard(name)
                        closure_ok[name] = out
                        return out

                    return ok

                ok_hard = mk_ok(tainted, deps)
                for name in clean:
                    if ok_hard(name, set()):
                        self._block_consts[("var", name)] = float(
                            v1.get(name, 0.0))
                # soft candidates depend on samplesblock only through
                # threshold idioms (poll counters); the dependency-closure
                # induction does not apply — the windowed sweep (covering
                # a full poll cycle, with odd-sized blocks injected at
                # every position) is the arbiter instead
                cands = {n: float(v1.get(n, 0.0)) for n in soft
                         if stable(n)}
                for n, v in self._validate_soft_consts(cands).items():
                    self._block_consts[("var", n)] = v
        except Exception:
            self._block_consts = {}
        self.control_vars -= set(self._block_consts)

    def _validate_soft_consts(self, cands: Dict[str, float]
                              ) -> Dict[str, float]:
        """Empirical sweep for samplesblock-sensitive candidates: advance
        through one poll cycle of full-size blocks; at every position run
        odd-sized blocks on a clone.  A candidate folds only if its value
        never moves (window-bounded heuristic; null tests backstop it)."""
        if not cands:
            return {}
        import math as _math

        from ..shadow import compile_shadow

        plug = compile_shadow(self.P)
        plug.state = self._probe_state()
        st = plug.state
        live = dict(cands)
        W = max(8, int(_math.ceil(0.30 * float(st.srate) / self.B)) + 2)
        inj_sizes = sorted({1, self.B // 2 + 1, max(1, self.B - 1)})

        def run_one(state, n):
            plug.state = state
            state.samplesblock = float(n)
            plug.run_block()
            if (state.pending_change_mask or state.pending_automate_mask
                    or state.pending_automate_end_mask):
                plug.run_slider()
                state.pending_change_mask = 0
                state.pending_automate_mask = 0
                state.pending_automate_end_mask = 0

        def check(state):
            for nm in list(live):
                if not _feq(float(state.V.get(nm, 0.0)), live[nm]):
                    live.pop(nm)

        for _p in range(W):
            run_one(st, self.B)
            check(st)
            if not live:
                break
            for n in inj_sizes:
                cl = st.clone()
                run_one(cl, n)
                check(cl)
                if not live:
                    break
            plug.state = st
            if not live:
                break
        return live

    # -- hop extraction --------------------------------------------------------

    _HOP_BUILTINS = frozenset({
        "memcpy", "memset", "fft", "ifft", "fft_real", "ifft_real",
        "fft_permute", "fft_ipermute", "convolve_c"})

    def _section_calls(self, section: str, fname: str) -> bool:
        """Does a section (transitively through user fns) call fname?"""
        seen: Set[str] = set()

        def scan(roots) -> bool:
            for root in roots:
                for x in walk(root):
                    if isinstance(x, CallExpr):
                        if x.func == fname:
                            return True
                        if x.func in self.P.fn_defs and x.func not in seen:
                            seen.add(x.func)
                            if scan([self.P.fn_defs[x.func].body]):
                                return True
            return False

        return scan(self.P.sections.get(section) or [])

    def _hop_worthy(self, stmts: Sequence[Node]) -> bool:
        """True when the candidate body uses constructs the vector engine
        cannot express but the device section executor can (the FFT-hop
        shape, ref: PsychoConvolver.jsfx:355-420)."""
        seen: Set[str] = set()

        def scan(roots) -> bool:
            for root in roots:
                for x in walk(root):
                    if isinstance(x, WhileStmt):
                        return True
                    if isinstance(x, CallExpr):
                        if x.func in self._HOP_BUILTINS:
                            return True
                        if x.func in self.P.fn_defs and x.func not in seen:
                            seen.add(x.func)
                            if scan([self.P.fn_defs[x.func].body]):
                                return True
            return False

        return scan(stmts)

    def _extract_hop(self) -> None:
        """Detect and strip the hop idiom at the TAIL of @sample:

            ctr += 1;
            ctr >= N ? ( <device work>; ctr = 0; );

        The branch body (minus the counter reset) becomes a device section
        run between vectorized sample segments; the stripped @sample keeps
        only the wrap reset, so ctr classifies as a plain mod-N cursor.
        Tail position guarantees the device work observes the whole
        sample's effects and nothing downstream observes its own."""

        def match(node) -> Optional[Tuple[str, float, List[Node]]]:
            if isinstance(node, Cond):
                pred, then, other = node.pred, node.then, node.other
                if other is not None and not (isinstance(other, Const)
                                              and other.value == 0.0):
                    return None
            elif isinstance(node, IfStmt):
                pred, then, other = node.pred, node.then, node.other
                if other is not None:
                    return None
            else:
                return None
            if not (isinstance(pred, Bin) and pred.op == ">="
                    and isinstance(pred.lhs, Name)):
                return None
            ctr = pred.lhs.ident
            if isinstance(pred.rhs, Const):
                n_val = float(pred.rhs.value)
            elif isinstance(pred.rhs, Name):
                n_val = float(self.snap.V.get(pred.rhs.ident, 0.0))
            else:
                return None
            if not (n_val == int(n_val) and n_val >= 2.0):
                return None
            items = then.items if isinstance(then, Block) else [then]
            resets = [st for st in items
                      if isinstance(st, Asn) and st.op == "="
                      and isinstance(st.target, Name)
                      and st.target.ident == ctr
                      and isinstance(st.value, Const)
                      and st.value.value == 0.0]
            if len(resets) != 1 or items[-1] is not resets[0]:
                return None
            body = [st for st in items if st is not resets[0]]
            if not body or not self._hop_worthy(body):
                return None
            # the body must not touch the counter
            for st in body:
                for x in walk(st):
                    if isinstance(x, Name) and x.ident == ctr:
                        return None
            return ctr, n_val, body

        def rewrite_tail(stmts: List[Node]) -> Optional[List[Node]]:
            """Find the hop at the tail (descending through a trailing
            branch arm); returns a rebuilt list or None."""
            if not stmts:
                return None
            last = stmts[-1]
            m = match(last)
            if m is not None:
                ctr, n_val, body = m
                self._hop_ctr = ("var", ctr)
                self._hop_len = int(n_val)
                self._hop_body = body
                reset = Asn(last.pos, op="=",
                            target=Name(last.pos, ident=ctr),
                            value=Const(last.pos, value=0.0))
                stripped = Cond(last.pos,
                                pred=last.pred,
                                then=Block(last.pos, items=[reset]),
                                other=Const(last.pos, value=0.0))
                return stmts[:-1] + [stripped]
            if isinstance(last, (Cond, IfStmt)) \
                    and isinstance(last.then, Block):
                inner = rewrite_tail(list(last.then.items))
                if inner is not None:
                    new_then = Block(last.then.pos, items=inner)
                    if isinstance(last, Cond):
                        node = Cond(last.pos, pred=last.pred, then=new_then,
                                    other=last.other)
                    else:
                        node = IfStmt(last.pos, pred=last.pred,
                                      then=new_then, other=last.other)
                    return stmts[:-1] + [node]
            return None

        out = rewrite_tail(self._sample_stmts)
        if out is not None:
            self._sample_stmts = out

    def _try_block_settle(self, poison_spans=None) -> bool:
        """Probe whether @block's mem writes reach a fixpoint after the
        FIRST block (load/rebuild work behind need_* flags, ref shape:
        PsychoConvolver.jsfx @block).  On success the kernel's mem view
        (ring initials, baked static regions, concrete cells) switches to
        the post-block-1 heap; @block itself stays on the host trajectory
        and no device @block is needed.

        When @block also READS mem, poison_spans (the sample path's write
        regions) drive an equivalence test: the probe re-runs with those
        cells poisoned, and any divergence in @block's vars or mem writes
        proves genuine audio-rate coupling (→ device @block instead).
        Heuristic over a bounded window; the null-test suite backstops it."""
        import math as _math

        from ..shadow import compile_shadow

        fb_names = sorted(k[1] for k in self._fb_vars)

        def probe(poison: bool):
            plug = compile_shadow(self.P)
            plug.state = self._probe_state()
            st = plug.state
            pcells = []
            if poison:
                rng = np.random.RandomState(0xC0FFEE)
                for origin, ln in poison_spans or []:
                    st.mem_ensure(origin + ln)
                    st.mem[origin:origin + ln] = rng.randn(ln)
                    pcells.append((origin, ln))

            def run_one():
                st.samplesblock = float(self.B)
                plug.run_block()
                if (st.pending_change_mask or st.pending_automate_mask
                        or st.pending_automate_end_mask):
                    plug.run_slider()
                    st.pending_change_mask = 0
                    st.pending_automate_mask = 0
                    st.pending_automate_end_mask = 0

            run_one()
            m1 = np.array(st.mem, dtype=np.float64, copy=True)
            bake = st.clone()
            probes = max(8, int(_math.ceil(0.30 * float(st.srate)
                                           / self.B)) + 2)
            for k in range(probes):
                # sentinels prove blocks 2+ never rewrite sample state
                # (sound because hot is empty: @block never READS these)
                sent = {nm: 7.015e13 + 31.0 * k + i
                        for i, nm in enumerate(fb_names)}
                for nm, v in sent.items():
                    st.V[nm] = v
                run_one()
                for nm, v in sent.items():
                    if float(st.V.get(nm, 0.0)) != v:
                        return None
                cur = np.asarray(st.mem, dtype=np.float64)
                n = min(len(m1), len(cur))
                if not np.array_equal(m1[:n], cur[:n]):
                    return None
                if len(cur) > n and np.any(cur[n:]):
                    return None
            # mask the poisoned cells out of the comparison view
            mview = m1.copy()
            for origin, ln in pcells:
                if origin < len(mview):
                    mview[origin:origin + ln] = 0.0
            return mview, dict(st.V), m1, bake

        try:
            got = probe(False)
            if got is None:
                return False
            mview, vfin, m1, bake = got
            if poison_spans:
                got_p = probe(True)
                if got_p is None:
                    return False
                mview_p, vfin_p, _m1p, _bake_p = got_p
                same_v = (vfin.keys() == vfin_p.keys()
                          and all(_feq(vfin[k], vfin_p[k]) for k in vfin))
                n = min(len(mview), len(mview_p))
                if not (same_v and np.array_equal(mview[:n], mview_p[:n])):
                    return False
        except Exception:
            return False

        base = np.asarray(self.snap.mem, dtype=np.float64)
        n = min(len(base), len(m1))
        cells = set(np.nonzero(m1[:n] != base[:n])[0].tolist())
        cells |= {int(i) + n for i in np.nonzero(m1[n:])[0]}
        self._settled_cells = cells
        self._bake_state = bake
        # hybrid kernel snapshot: sample-owned vars stay pre-block (the
        # carry picks them up at render start), mem view goes post-block-1,
        # and fb vars (@block-written sample state, e.g. reload resets)
        # adopt block 1's values — that is what block 1's samples see
        hybrid = self.snap.clone()
        hybrid.mem_ensure(len(m1))
        hybrid.mem[:len(m1)] = m1
        for k in self._fb_vars:
            hybrid.V[k[1]] = float(bake.V.get(k[1], 0.0))
        self.snap = hybrid
        self._block_settled = True
        return True

    def _stable_symexec(self) -> _SymExec:
        # optimistic settled set: assigned vars assumed to hold their
        # snapshot value; violated assumptions shrink the set and retry
        settled = {k for k in assigned_vars_of_sample(self.P)
                   if k[0] == "var"}
        settled -= self.control_vars
        settled -= self._block_writes
        settled -= set(self._block_consts)
        for _outer in range(64):
            try:
                return self._discover_symexec(settled)
            except _SettledRetry as r:
                settled = settled - r.violations
        raise SpecializeError("settled-constant fixpoint did not converge")

    def _discover_symexec(self, settled: Set[Any]) -> _SymExec:
        inductions: Dict[Any, int] = {}
        mod_inductions: Dict[Any, int] = {}
        gated_inductions: Dict[Any, int] = {}
        cells: Set[int] = set()
        sym = None
        for _ in range(8):
            sym = _SymExec(self.P, self.snap, self.nch, inductions, cells,
                           self.B, control_vars=self.control_vars,
                           mod_inductions=mod_inductions,
                           const_overrides=self._block_consts,
                           settled_vars=settled,
                           gated_mod_inductions=gated_inductions,
                           masked_loop_k=self.masked_loop_k)
            try:
                sym.run(self._sample_stmts)
            except SpecializeError:
                if sym.settled_violations:
                    # the failure may be an artifact of the now-invalid
                    # optimistic pass — shrink and retry before giving up
                    raise _SettledRetry(sym.settled_violations) from None
                raise
            if sym.settled_violations:
                raise _SettledRetry(sym.settled_violations)
            new_ind = dict(inductions)
            new_modind = dict(mod_inductions)
            new_gmod = dict(gated_inductions)
            cache: Dict[int, Set] = {}
            for key in sym.writes:
                if key in inductions or key in mod_inductions \
                        or key in gated_inductions:
                    continue
                out = sym.env[key]
                if isinstance(out, (IndAff, RingIdx, GRingIdx)):
                    continue
                node = out.node if isinstance(out, TS) else None
                if node is None:
                    continue
                lin = _linearize(node, key, cache, sym.ring_writes)
                if lin is not None and isinstance(lin[0], float) and lin[0] == 1.0 \
                        and isinstance(lin[1], float) and _is_int(lin[1]) \
                        and lin[1] == 1.0:
                    start = sym._state_value(key)
                    if _is_int(start):
                        new_ind[key] = 1
                    continue
                mod = _match_mod_induction(node, key)
                if mod is not None:
                    start = sym._state_value(key)
                    if _is_int(start) and 0 <= start < mod:
                        new_modind[key] = mod
                    continue
                gmod = _match_gated_mod_induction(node, key)
                if gmod is not None:
                    start = sym._state_value(key)
                    if _is_int(start) and 0 <= start < gmod:
                        new_gmod[key] = gmod
            new_cells = {c for c in sym.written_cells if c >= 0}
            grew_ctrl = False
            if self.block_writes_mem:
                # concrete cells @sample reads but does not write become
                # block-trajectory control streams
                ctrl_cells = {("mem", a) for a in sym.read_cells
                              if a not in new_cells and a not in cells}
                fresh = ctrl_cells - self.control_vars
                if fresh:
                    self.control_vars |= fresh
                    grew_ctrl = True
            if new_ind == inductions and new_modind == mod_inductions \
                    and new_gmod == gated_inductions \
                    and new_cells <= cells and not grew_ctrl:
                break
            inductions = new_ind
            mod_inductions = new_modind
            gated_inductions = new_gmod
            cells = cells | new_cells
        assert sym is not None
        if -1 in sym.written_cells:
            raise SpecializeError("data-dependent mem write address in @sample")
        has_ringstatic = False
        for node_check in self._all_nodes(sym):
            if node_check.kind == "dynmem":
                raise SpecializeError("data-dependent mem read address in @sample")
            if node_check.kind in ("ringref", "dynringref") \
                    and node_check.meta["region"] not in sym.ring_writes:
                has_ringstatic = True
        written_spans = list(sym.ring_writes.keys())
        for node_check in self._all_nodes(sym):
            if node_check.kind in ("ringref", "dynringref") \
                    and node_check.meta["region"] not in sym.ring_writes:
                o, m = node_check.meta["region"]
                for wo, wm in written_spans:
                    if o < wo + wm and wo < o + m:
                        raise SpecializeError(
                            "mem read region overlaps a written ring at a "
                            "different origin/stride — cannot vectorize")
                if node_check.meta.get("ivr") and any(
                        o <= a < o + m
                        for a in sym.written_cells if a >= 0):
                    # an interval-span gather sees the segment-start copy;
                    # a concrete @sample write inside it would be invisible
                    # to later reads — reject honestly
                    raise SpecializeError(
                        "interval-bounded mem read span overlaps "
                        "@sample-written cells — cannot vectorize")
        if not self.coupled:
            sample_spans = [(a, 1) for a in sym.written_cells if a >= 0]
            sample_spans += list(sym.ring_writes.keys())
            sample_spans += list(sym.gring_writes.keys())
            for dw in sym.dyn_writes:
                sample_spans.append(
                    (dw.origin, _dyn_write_bound(sym, dw.idx) or 1))
            if self.block_reads_mem and not self._block_settled \
                    and (sym.written_cells or sym.ring_writes
                         or sym.dyn_writes or sym.gring_writes):
                # block work MAY consume audio-rate mem state: the settle
                # probe's poison test decides (device @block otherwise)
                raise _CoupledUpgrade("reads", sample_spans)
            if self.block_writes_mem and (sym.ring_writes or has_ringstatic
                                          or sym.written_cells):
                blocked = (self._settled_cells
                           if self._block_settled else None)
                if blocked is None:
                    blocked = self._probe_block_mem_writes()
                conflict = blocked & sym.written_cells
                spans = list(sym.ring_writes.keys()) \
                    + list(sym.gring_writes.keys())
                write_spans = list(spans)
                for node_check in self._all_nodes(sym):
                    if node_check.kind in ("ringref", "dynringref") \
                            and node_check.meta["region"] not in sym.ring_writes:
                        spans.append(node_check.meta["region"])
                if self._block_settled:
                    # baked regime: @block's settled writes may feed
                    # sample READS (the kernel sees the baked heap), but a
                    # cell both sides WRITE would diverge from the host
                    # trajectory's view
                    for origin, mod in write_spans:
                        if any(origin <= a < origin + mod for a in blocked):
                            conflict.add(origin)
                    for dw in sym.dyn_writes:
                        dmod = _dyn_write_bound(sym, dw.idx) or 1
                        if any(dw.origin <= a < dw.origin + dmod
                               for a in blocked):
                            conflict.add(dw.origin)
                    if conflict:
                        raise SpecializeError(
                            "@block and @sample both write a shared mem "
                            "region — not bakeable")
                else:
                    for origin, mod in spans:
                        if any(origin <= a < origin + mod for a in blocked):
                            conflict.add(origin)
                    if conflict:
                        raise _CoupledUpgrade("writes", sample_spans)
            if self._fb_vars and not self._block_settled:
                raise _CoupledUpgrade("writes", sample_spans)
        return sym

    def _probe_state(self):
        """Snapshot clone for host-side @block probes: side-effect-free —
        the clone's gmem view must be PRIVATE (ShadowState.clone keeps the
        attached segment's shared array; probe blocks bumping BUS_TICK-
        style cells would pollute the real segment and skew the device
        view — observed as CMD's tick starting at 12)."""
        st = self.snap.clone()
        st.gmem = np.array(st.gmem, dtype=np.float64, copy=True)
        return st

    def _probe_block_mem_writes(self) -> Set[int]:
        """Empirically determine which mem cells @block writes by running a
        few trajectory blocks against a clone and diffing the heap.  Used
        only for the disjointness check (the null-test suite backstops the
        heuristic for plugins with block-varying write addresses)."""
        from ..shadow import compile_shadow

        plug = compile_shadow(self.P)
        plug.state = self._probe_state()
        st = plug.state
        base = self.snap.mem
        written: Set[int] = set()
        for _ in range(3):
            st.samplesblock = float(self.B)
            plug.run_block()
            n = min(len(base), len(st.mem))
            diff = np.nonzero(st.mem[:n] != base[:n])[0]
            written.update(int(i) for i in diff)
            if len(st.mem) > len(base):
                extra = np.nonzero(st.mem[len(base):])[0]
                written.update(int(i) + len(base) for i in extra)
        return written

    @staticmethod
    def _plan_roots(sym: _SymExec) -> List[GNode]:
        """The nodes the plan starts from: every var's value, every ring,
        dynamic and gated write."""
        roots = [sv.node for sv in sym.env.values() if isinstance(sv, TS)]
        roots += [w.value for ws in sym.ring_writes.values() for w in ws]
        roots += [x for dw in sym.dyn_writes
                  for x in (dw.idx, dw.value, dw.gate)]
        roots += [x for gws in sym.gring_writes.values() for gw in gws
                  for x in (gw.value, gw.gate)]
        return [x for x in roots if isinstance(x, GNode)]

    def _all_nodes(self, sym: _SymExec):
        seen: Set[int] = set()
        stack: List[GNode] = []

        def push(x):
            if isinstance(x, GNode) and id(x) not in seen:
                seen.add(id(x))
                stack.append(x)

        for x in self._plan_roots(sym):
            push(x)
        while stack:
            n = stack.pop()
            yield n
            for a in n.args:
                push(a)

    def _linrec_wave_map(self) -> Dict[Any, Tuple[Any, ...]]:
        """Group linrec plans into dependency 'waves' solvable with ONE
        kernel launch each (k same-level recurrences share a launch).

        The current-value dependency walk is CONSERVATIVE: prev-refs and
        ring reads are followed without the emitter's delay >= L history
        cuts, so it may report a dependency (or a cycle) the emission
        would not have.  Over-approximation only splits or disables
        waves; it never merges two linrecs that genuinely depend on each
        other — and the emitter's wave solver still falls back to
        per-recurrence emission if a wave turns out unemittable.

        Returns {linrec key -> tuple of same-wave keys} for waves of
        size >= 2; keys in conservative cycles are left out (they emit
        individually, exactly as before).
        """
        got = getattr(self, "_linrec_waves_cache", None)
        if got is not None:
            return got
        P_plans, sym = self.plans, self.sym
        lin_set = {k for k, p in P_plans.items() if p.kind == "linrec"}

        # linrec -> set of linrecs its emission transitively needs
        edges: Dict[Any, Set[Any]] = {}
        key_memo: Dict[Any, Set[Any]] = {}
        CYCLE = object()

        def node_deps(node, out, seen, stack_keys):
            if not isinstance(node, GNode) or id(node) in seen:
                return
            seen.add(id(node))
            if node.kind == "prev":
                key_deps(node.meta["key"], out, stack_keys)
                return
            if node.kind in ("ringref", "dynringref"):
                region = node.meta.get("region")
                for w in sym.ring_writes.get(region, ()):
                    node_deps(w.value, out, seen, stack_keys)
                for dw in sym.dyn_writes:
                    if region is not None and dw.origin == region[0]:
                        for x in (dw.idx, dw.value, dw.gate):
                            node_deps(x, out, seen, stack_keys)
            for a in node.args:
                node_deps(a, out, seen, stack_keys)

        def key_deps(k, out, stack_keys):
            p = P_plans.get(k)
            if p is None:
                return
            if p.kind == "linrec":
                out.add(k)
                return
            if k in stack_keys:
                out.add(CYCLE)     # conservative walk cycle: poison
                return
            cached = key_memo.get(k)
            if cached is not None:
                out |= cached
                return
            sub: Set[Any] = set()
            stack_keys.add(k)
            if p.kind == "stream":
                node_deps(p.out, sub, set(), stack_keys)
            elif p.kind == "scan":
                for g in self.scan_groups[p.step]:
                    gp = P_plans.get(g)
                    if gp is not None and isinstance(gp.out, GNode):
                        node_deps(gp.out, sub, set(), stack_keys)
            stack_keys.discard(k)
            key_memo[k] = sub
            out |= sub

        for k in lin_set:
            out: Set[Any] = set()
            p = P_plans[k]
            for e in (p.A, p.B):
                node_deps(e, out, set(), {k})
            edges[k] = out

        # poison: walk cycles, self-references, or deps through CYCLE
        fallback = {k for k, d in edges.items() if CYCLE in d or k in d}

        # levels by longest path over linrec edges; cycles -> fallback
        level: Dict[Any, int] = {}

        def level_of(k, visiting):
            if k in level:
                return level[k]
            if k in visiting or k in fallback:
                fallback.add(k)
                return 0
            visiting.add(k)
            lv = 0
            for d in edges[k] & lin_set:
                lv = max(lv, level_of(d, visiting) + 1)
            visiting.discard(k)
            level[k] = lv
            return lv

        for k in lin_set:
            level_of(k, set())

        waves: Dict[int, List[Any]] = {}
        for k in lin_set - fallback:
            waves.setdefault(level[k], []).append(k)
        by_key: Dict[Any, Tuple[Any, ...]] = {}
        for lv, ks in waves.items():
            if len(ks) >= 2:
                tk = tuple(sorted(ks, key=repr))
                for k in ks:
                    by_key[k] = tk
        self._linrec_waves_cache = by_key
        return by_key

    # -- ring tap chains ------------------------------------------------------

    def _tap_slice(self, x) -> Optional[Tuple[Tuple[int, int], int]]:
        """(region, start) when ringref x reads the static slice
        [start, start + L) of its region's [history | write stream]
        buffer, else None."""
        sym = self.sym
        region = x.meta["region"]
        ws = sym.ring_writes.get(region)
        if ws is None:
            return None
        w = ws[-1]
        delay = (sym._cursor_anchor(w.var, w.offset, w.mod)
                 - sym._cursor_anchor(x.meta["var"], x.meta["offset"],
                                      w.mod)) % w.mod
        if delay == 0:
            pre = [u for u in ws if u.order < x.meta["order"]]
            if pre:
                # same-slot same-sample: the final writer's value is the
                # tail of the buffer; an earlier writer's is not in it
                return (region, w.mod) if pre[-1] is w else None
            delay = w.mod   # read precedes every write: prior wrap
        return region, w.mod - delay

    @staticmethod
    def _tap_term(x) -> Optional[Tuple[float, GNode]]:
        """(gain, ringref) of `const * ringref` / `ringref * const`."""
        if not (isinstance(x, GNode) and x.kind == "bin" and x.op == "*"):
            return None
        a, b = x.args
        if isinstance(a, float) and isinstance(b, GNode) \
                and b.kind == "ringref":
            return a, b
        if isinstance(b, float) and isinstance(a, GNode) \
                and a.kind == "ringref":
            return b, a
        return None

    def _tap_chain(self, x, L: int) -> Optional[_TapChain]:
        """The maximal left-leaning `+` chain ending at x whose right
        operands are constant-gain ring taps of ONE region, or None when
        fewer than MIN_CHAIN_TAPS taps match."""
        taps = []
        region = None
        node = x
        while isinstance(node, GNode) and node.kind == "bin" \
                and node.op == "+":
            term = self._tap_term(node.args[1])
            if term is None:
                break
            where = self._tap_slice(term[1])
            if where is None or (region is not None and where[0] != region):
                break
            region = where[0]
            taps.append((term[0], where[1]))
            node = node.args[0]
        if len(taps) < self.MIN_CHAIN_TAPS:
            return None
        taps.reverse()
        # taps that reach this segment's writes need the stream; a chain
        # of long delays reads history alone and stays free of the
        # current source
        needs_src = max(s for _g, s in taps) + L > region[1]
        return _TapChain(x, node, region, needs_src, [s for _g, s in taps],
                         [g for g, _s in taps])

    def _tap_group(self, x, L: int, nf: int = 1) -> Optional[_TapGroup]:
        """The launch that folds the chain ending at `+` node x in the
        segment program of length L over nf files, or None when x is no
        chain.  Chains are grouped once for the kernel's life
        (`_tap_plan`); a chain the plan did not list (a node inside
        another chain that is also read elsewhere) is a launch of its
        own, matched at its first use."""
        plan = self._tap_plan(L, nf)
        if id(x) not in plan:
            chain = self._tap_chain(x, L)
            plan[id(x)] = None if chain is None else \
                self._tap_launch([chain], L, nf)
        return plan[id(x)]

    def _gate_readers(self, var) -> Tuple[List[Tuple], Optional[int],
                                           Optional[int]]:
        """What one K6a launch (`gated_cursor`) computes for gated cursor
        `var`, enumerated once for the kernel's life: (the readers as
        (kind, offset, mod, incl, origin, region) specs, each distinct
        `gringidx` and `gringref` of the cursor in plan order; the index of
        the `gmodind` stream's spec or None; the modulus of the cursor's
        carried value or None).  A reader the walk did not meet is a
        launch of its own, made at its first use."""
        got = self._gate_reader_specs.get(var)
        if got is not None:
            return got
        specs: List[Tuple] = []

        def add(spec) -> int:
            if spec not in specs:
                specs.append(spec)
            return specs.index(spec)

        for n in self._all_nodes(self.sym):
            if n.kind in ("gringidx", "gringref") and n.meta["var"] == var:
                add(_gate_reader_spec(n))
        plan = self.plans.get(var)
        stream = carry_mod = None
        if plan is not None and plan.kind == "gmodind":
            stream = add(("position", 0, plan.A, True, None, None))
            if var in self.carried_vars:
                carry_mod = plan.A
        got = (specs, stream, carry_mod)
        self._gate_reader_specs[var] = got
        return got

    def tap_launches(self, L: int, nf: int = 1) -> List[_TapGroup]:
        """The planned `ring_tap_sum` launches of the segment program of
        length L over nf files, each with its chains and tables."""
        return list({id(g): g for g in self._tap_plan(L, nf).values()
                     if g is not None}.values())

    def _tap_launch(self, members: List[_TapChain], L: int,
                    nf: int) -> _TapGroup:
        from ..kernels.ring_taps import TapTables

        return _TapGroup(members, TapTables(
            [(m.starts, m.gains) for m in members], self.device, length=L,
            files=nf))

    def _tap_plan(self, L: int, nf: int = 1) -> Dict[int, Optional[_TapGroup]]:
        """{id(chain root): its launch} for the segment program of length
        L over nf files, built once (the files set only the kernel's
        tile).

        The roots are the chains the emitter can meet: the plan's nodes
        reached through their operands, a chain through its init alone
        (its taps are never emitted).  A chain joins a launch only when
        neither its inputs (init; with the stream, its region's writes)
        reach a chain of that launch nor theirs reach it, walking the
        emitter's edges conservatively: operands, a `prev` to its var's
        plan and the plans solved with it (a linrec wave, a scan level),
        a ring read to the region's writes, and a chain to the inputs of
        every chain of its launch.  Launches then form no cycle, and a
        cross-fed pair (the right ring written from the left sum) stays
        two launches.
        """
        got = self._tap_tables.get((L, nf))
        if got is not None:
            return got
        from ..kernels.ring_taps import MAX_CHAINS

        sym, P_plans = self.sym, self.plans
        chains: Dict[int, _TapChain] = {}
        seen: Set[int] = set()
        stack = list(reversed(self._plan_roots(sym)))
        while stack:
            x = stack.pop()
            if not isinstance(x, GNode) or id(x) in seen:
                continue
            seen.add(id(x))
            chain = (self._tap_chain(x, L)
                     if x.kind == "bin" and x.op == "+" else None)
            if chain is not None:
                chains[id(x)] = chain
                stack.append(chain.init)
            else:
                stack.extend(reversed(x.args))

        waves = self._linrec_wave_map()

        def plan_nodes(key):
            keys = [key]
            p = P_plans.get(key)
            if p is None:
                return []
            if p.kind == "linrec":
                keys += list(waves.get(key, ()))
            elif p.kind == "scan":
                level = self.scan_levels.get(p.step, 0)
                keys += [g for i, grp in enumerate(self.scan_groups)
                         if self.scan_levels.get(i, 0) == level for g in grp]
            return [v for k in keys if k in P_plans
                    for v in (P_plans[k].out, P_plans[k].A, P_plans[k].B)]

        def inputs(m: _TapChain):
            return [m.init] + ([w.value for w in sym.ring_writes[m.region]]
                               if m.needs_src else [])

        group_of: Dict[int, List[_TapChain]] = {}

        def reach(nodes) -> Set[int]:
            """The chain roots the emission of `nodes` may meet."""
            found: Set[int] = set()
            done: Set[int] = set()
            todo = list(nodes)
            while todo:
                x = todo.pop()
                if not isinstance(x, GNode) or id(x) in done:
                    continue
                done.add(id(x))
                if id(x) in chains:
                    found.add(id(x))
                    for m in group_of.get(id(x), [chains[id(x)]]):
                        todo.extend(inputs(m))
                    continue
                if x.kind == "prev":
                    todo.extend(plan_nodes(x.meta["key"]))
                elif x.kind in ("ringref", "dynringref"):
                    region = x.meta["region"]
                    todo.extend(w.value for w in sym.ring_writes.get(region, ()))
                    todo.extend(v for dw in sym.dyn_writes
                                if dw.origin == region[0]
                                for v in (dw.idx, dw.value, dw.gate))
                todo.extend(x.args)
            return found

        groups: List[List[_TapChain]] = []
        for chain in chains.values():
            key = id(chain.root)
            for grp in groups:
                ids = {id(m.root) for m in grp}
                if len(grp) < MAX_CHAINS \
                        and not reach(inputs(chain)) & ids \
                        and key not in reach(
                            [v for m in grp for v in inputs(m)]):
                    grp.append(chain)
                    group_of[key] = grp
                    break
            else:
                groups.append([chain])
                group_of[key] = groups[-1]
        plan: Dict[int, Optional[_TapGroup]] = {}
        for grp in groups:
            launch = self._tap_launch(grp, L, nf)
            for m in grp:
                plan[id(m.root)] = launch
        self._tap_tables[(L, nf)] = plan
        return plan

    # -- planning ------------------------------------------------------------

    def _validate_gated_rings(self, sym: _SymExec) -> None:
        """Legality of gated-cursor ring traffic (see GRingIdx).

        * every write's ambient branch condition IS the cursor's gate
          (write fires exactly when the cursor advances, so in-segment
          writes land at consecutive G-space positions),
        * one write site per region, one cursor var per region,
        * every read's G-space delay (write offset - read offset mod M)
          reaches past the segment: delay in [L, M-L] means the read can
          only touch carry history — the gated generalization of the
          time-blocked feedback rule (cursor steps <= 1 per sample, so a
          G-space delay d spans >= d wall samples); shorter delays retry
          with a shrunken segment (_SegmentRetry),
        * the region is disjoint from every other addressed span."""
        if not sym.gring_writes and not any(
                n.kind in ("gringref", "gdynringref")
                for n in self._all_nodes(sym)):
            return
        # WRITE-ONLY gated regions demote to the gated DYN-write path
        # (scatter-max last-writer): it handles short rings (M < L,
        # multiple wraps per segment) and arbitrary write gates — the
        # decimated-metering-history idiom that predates gated cursors
        # keeps its lowering; gring emission is only needed when the
        # region is READ (history-tap resolution)
        read_regions = {n.meta["region"] for n in self._all_nodes(sym)
                        if n.kind in ("gringref", "gdynringref")}
        for region in [r for r in sym.gring_writes
                       if r not in read_regions]:
            for w in sym.gring_writes.pop(region):
                idx = GNode("gringidx", meta={
                    "var": w.var, "offset": w.offset, "mod": w.mod,
                    "origin": 0, "incl": False})
                if w.offset != 0:
                    raise SpecializeError(
                        "write-only gated ring at a cursor offset")
                sym.dyn_writes.append(_DynWrite(
                    region[0], idx, w.value, w.gate, w.order))
        for region, ws in sym.gring_writes.items():
            if len(ws) > 1:
                raise SpecializeError(
                    "multiple writes per sample to one gated ring region")
            w = ws[0]
            if w.var not in sym.gated_mod_inductions:
                raise SpecializeError(
                    "gated ring write cursor is not a gated wrapped "
                    "counter")
            gate = sym.gate_of.get(w.var)
            if gate is None or w.gate is not gate:
                raise SpecializeError(
                    "gated ring write outside its cursor's gate branch — "
                    "write-when-advance is the supported idiom")
            # read regions keep the single-scatter write-back: the read
            # delay bound (>= L, checked below) already implies M > L,
            # so in-segment G positions are distinct
        reads: Dict[Tuple[int, int], List[GNode]] = {}
        for n in self._all_nodes(sym):
            if n.kind in ("gringref", "gdynringref"):
                reads.setdefault(n.meta["region"], []).append(n)

        def check_delay(delay_lo: float, delay_hi: float) -> None:
            M = region[1]
            # an unbounded clamp side yields +/-inf and inf*0 in the
            # interval product yields NaN; both must reject (NaN bounds
            # would make the comparisons below silently False -> unsound
            # vectorization, and int(inf) raises OverflowError, not
            # SpecializeError, so the engine's demote path would crash)
            if not (math.isfinite(delay_lo) and math.isfinite(delay_hi)):
                raise SpecializeError(
                    "gated ring tap with unboundable (non-finite) delay "
                    "interval")
            if delay_hi > M - self.L:
                # shrink the segment so the tap clears the write window
                # across the mod seam too
                l_new = (int(M - delay_hi) // self.B) * self.B
                if l_new >= self.B and l_new < self.L:
                    raise _SegmentRetry(l_new)
                raise SpecializeError(
                    "gated ring tap too close to the write head "
                    "(mod wrap-around inside one segment)")
            if delay_lo < self.L:
                l_new = (int(delay_lo) // self.B) * self.B
                if l_new >= self.B and l_new < self.L:
                    raise _SegmentRetry(l_new)
                raise SpecializeError(
                    "gated ring feedback within one segment — min "
                    f"G-space delay {delay_lo} < block {self.B}")

        for region, rs in reads.items():
            ws = sym.gring_writes.get(region)
            for r in rs:
                if r.meta.get("incl"):
                    raise SpecializeError(
                        "gated ring read at a post-advance cursor")
                if ws is None:
                    continue   # read-only region: carry/static gather
                w = ws[0]
                if r.meta["var"] != w.var:
                    raise SpecializeError(
                        "gated ring read and write use different cursors")
                M = region[1]
                if r.kind == "gringref":
                    delay = (w.offset - r.meta["offset"]) % M
                    check_delay(delay, delay)
                else:
                    # time-varying (ctrl-derived) tap delay D: read slot =
                    # cursor + off - D, so the G-space delay is
                    # w.offset - off + D — interval-bound D statically
                    div = _node_interval(r.meta["dnode"])
                    if div is None:
                        raise SpecializeError(
                            "gated ring tap with unboundable dynamic "
                            "delay expression")
                    off = r.meta["offset"]
                    check_delay(w.offset - off + div[0],
                                w.offset - off + div[1])
        # region disjointness vs everything else the sample path touches
        gregions = set(sym.gring_writes) | set(reads)
        others = list(sym.ring_writes.keys()) \
            + [(a, 1) for a in sym.read_cells] \
            + [(a, 1) for a in sym.written_cells if a >= 0] \
            + [n.meta["region"] for n in self._all_nodes(sym)
               if n.kind in ("ringref", "dynringref")]
        for origin, mod in gregions:
            for o2, m2 in others:
                if origin < o2 + m2 and o2 < origin + mod:
                    raise SpecializeError(
                        "gated ring region overlaps other addressed "
                        "sample state — not vectorizable")
            for o2, m2 in gregions:
                if (origin, mod) != (o2, m2) and origin < o2 + m2 \
                        and o2 < origin + mod:
                    raise SpecializeError(
                        "gated ring regions overlap at different "
                        "origins/strides")

    def _plan(self, sym: _SymExec) -> None:
        self.sym = sym
        cache: Dict[int, Set] = {}
        plans: Dict[Any, _VarPlan] = {}
        self._validate_gated_rings(sym)

        # dependency SCC check: mutual recursions are not supported in v1
        dep_edges: Dict[Any, Set] = {}
        for key in sym.writes:
            out = sym.env[key]
            node = out.node if isinstance(out, TS) else None
            dep_edges[key] = (_prev_deps(node, cache, sym.ring_writes)
                              if node is not None else set())

        # strongly-connected components over cross-timestep dependencies:
        # each SCC of size > 1 (and each non-linear self-loop) runs as its
        # OWN inner lax.scan, in dependency order; everything between the
        # scans stays time-parallel (SCCs of a dependency graph form a DAG,
        # so no between-var absorption is needed)
        assigned = set(sym.writes)
        adj = {v: {w for w in dep_edges.get(v, ()) if w in assigned and w != v}
               for v in assigned}
        group_sets: List[Set[Any]] = [set(c) for c in _tarjan_sccs(adj)
                                      if len(c) > 1]
        in_group: Set[Any] = set().union(*group_sets) if group_sets else set()

        # pass A: nonlinear self-recurrences become singleton groups
        lin_cache: Dict[Any, Tuple] = {}
        for key in sym.writes:
            out = sym.env[key]
            if key in sym.inductions or not isinstance(out, TS):
                continue
            deps = dep_edges[key]
            if key in deps and key not in in_group:
                lin = _linearize(out.node, key, cache, sym.ring_writes)
                ok = (lin is not None
                      and key not in _prev_deps(lin[0], cache, sym.ring_writes)
                      and key not in _prev_deps(lin[1], cache, sym.ring_writes))
                if ok:
                    lin_cache[key] = lin
                else:
                    group_sets.append({key})
                    in_group.add(key)
        scc_group = in_group

        # pass B: assign plans
        for key in sym.writes:
            out = sym.env[key]
            if key in sym.inductions:
                off = out.offset if isinstance(out, IndAff) else 0
                plans[key] = _VarPlan("induction", step=1, out=off)
                continue
            if key in sym.mod_inductions:
                M = sym.mod_inductions[key]
                if not (isinstance(out, RingIdx) and out.var == key
                        and out.origin == 0 and out.offset == 1
                        and out.mod == M):
                    raise SpecializeError(
                        "wrapped-counter final value inconsistent with its "
                        "classification")
                plans[key] = _VarPlan("modind", step=1, out=1, A=M)
                continue
            if key in sym.gated_mod_inductions:
                M = sym.gated_mod_inductions[key]
                if not (isinstance(out, GRingIdx) and out.var == key
                        and out.origin == 0 and out.offset == 0
                        and out.mod == M and out.incl
                        and key in sym.gate_of):
                    raise SpecializeError(
                        "gated wrapped-counter final value inconsistent "
                        "with its classification")
                plans[key] = _VarPlan("gmodind", step=1, out=0, A=M)
                continue
            if isinstance(out, CV):
                plans[key] = _VarPlan("const", out=out.v)
                continue
            if isinstance(out, (IndAff, RingIdx)):
                plans[key] = _VarPlan("stream", out=sym._node(out))
                continue
            node = out.node
            if key in scc_group:
                gid = next(i for i, g in enumerate(group_sets) if key in g)
                plans[key] = _VarPlan("scan", out=node, step=gid)
            elif key in lin_cache:
                lin = lin_cache[key]
                plans[key] = _VarPlan("linrec", A=lin[0], B=lin[1])
            else:
                plans[key] = _VarPlan("stream", out=node)

        self.scan_group = scc_group
        self.scan_groups = [sorted(g, key=repr) for g in group_sets]
        # batching levels: groups with no dependency path between them
        # solve in ONE lax.scan (filled from the gedges DAG below).
        # Per-group scans cost a full sequential pass EACH — ADS's nine
        # independent slew recurrences were nine 65536-step scans per
        # segment, ~9x the sequential device time, enough to blow the
        # remote execution deadline at 30 s renders (device then reports
        # 'UNAVAILABLE ... kernel fault' and wedges).  Merging levels
        # keeps each component's op order IDENTICAL (bit-exactness).
        self.scan_levels: Dict[int, int] = {}
        if group_sets:
            # ring writes driven by a sequential group are fine as long as
            # no group transitively consumes a read of a region whose write
            # depends on THAT SAME group or on a group downstream of it —
            # that would be delay-line feedback the vectorized emission
            # cannot order (the ring would have to live in a scan carry)
            def feeding_regions(keys) -> Set[Tuple[int, int]]:
                regions: Set[Tuple[int, int]] = set()
                seen_k: Set[Any] = set()
                seen_n: Set[int] = set()
                stack_k = list(keys)
                while stack_k:
                    k = stack_k.pop()
                    if k in seen_k:
                        continue
                    seen_k.add(k)
                    out_k = sym.env.get(k)
                    node_k = out_k.node if isinstance(out_k, TS) else None
                    todo = [node_k] if node_k is not None else []
                    while todo:
                        n = todo.pop()
                        if not isinstance(n, GNode) or id(n) in seen_n:
                            continue
                        seen_n.add(id(n))
                        if n.kind in ("ringref", "dynringref"):
                            regions.add(n.meta["region"])
                        if n.kind == "prev":
                            stack_k.append(n.meta["key"])
                        todo.extend(a for a in n.args if isinstance(a, GNode))
                return regions

            ring_wdeps = {
                region: set().union(*(
                    _prev_deps(w.value, cache, sym.ring_writes)
                    if isinstance(w.value, GNode) else set()
                    for w in ws))
                for region, ws in sym.ring_writes.items()}

            # group dependency edges: g -> h when solving g's externals can
            # recurse into h's scan (through vars or through ring reads)
            def reach_keys(keys) -> Set[Any]:
                seen = set(keys)
                todo = list(keys)
                while todo:
                    v = todo.pop()
                    for w in adj.get(v, ()):
                        if w not in seen:
                            seen.add(w)
                            todo.append(w)
                return seen

            gedges: Dict[int, Set[int]] = {}
            for gi, g in enumerate(group_sets):
                needs = reach_keys(g) - g
                for region in feeding_regions(g):
                    wd = reach_keys(ring_wdeps.get(region, set()))
                    if wd & g:
                        raise SpecializeError(
                            "delay-line feedback through a ring buffer into "
                            "a sequential recurrence group — not "
                            "vectorizable yet")
                    needs |= wd
                gedges[gi] = {hi for hi, h in enumerate(group_sets)
                              if hi != gi and needs & h}
            # the group graph must be a DAG (cross-group ring entanglement
            # could otherwise deadlock the emission ordering)
            state: Dict[int, int] = {}

            def dfs(u) -> bool:
                state[u] = 1
                for v in gedges.get(u, ()):
                    if state.get(v) == 1:
                        return False
                    if state.get(v) is None and not dfs(v):
                        return False
                state[u] = 2
                return True

            for gi in range(len(group_sets)):
                if state.get(gi) is None and not dfs(gi):
                    raise SpecializeError(
                        "cyclic entanglement between sequential recurrence "
                        "groups (through delay lines) — not vectorizable yet")

            # DAG levels by longest dependency path: groups on one level
            # are mutually independent and batch into one scan
            def glevel(u, visiting) -> int:
                got = self.scan_levels.get(u)
                if got is not None:
                    return got
                visiting.add(u)
                lv = 0
                for v in gedges.get(u, ()):
                    if v not in visiting:
                        lv = max(lv, glevel(v, visiting) + 1)
                visiting.discard(u)
                self.scan_levels[u] = lv
                return lv

            for gi in range(len(group_sets)):
                glevel(gi, set())

        # ring-ring cycle detection at PLAN time (emission recursion would
        # otherwise fail at render, after the engine already chose this
        # kernel): edge R1 -> R2 when R1's written value needs R2's
        # current-segment source (delay shorter than the longest segment;
        # reads reaching only into carry history are cycle-free)
        if sym.ring_writes:
            # edge R1 -> R2 carries the MINIMUM coupling delay; a cycle
            # whose edges all reach back >= some D can be broken by
            # shrinking the segment to L <= D (time-blocked scans: the
            # other ring's values then always come from carry history)
            redges: Dict[Tuple[int, int], Dict[Tuple[int, int], int]] = {}
            for region, ws in sym.ring_writes.items():
                rdeps: Dict[Tuple[int, int], int] = {}
                stack_n = [w.value for w in ws
                           if isinstance(w.value, GNode)]
                seen_n2: Set[int] = set()
                while stack_n:
                    nd = stack_n.pop()
                    if id(nd) in seen_n2:
                        continue
                    seen_n2.add(id(nd))
                    stack_n.extend(a for a in nd.args
                                   if isinstance(a, GNode))
                    if nd.kind == "dynringref" \
                            and nd.meta["region"] in sym.ring_writes:
                        # audio-dependent tap: delay unknowable -> 0
                        rdeps[nd.meta["region"]] = 0
                    elif nd.kind == "ringref" \
                            and nd.meta["region"] in sym.ring_writes:
                        r2 = nd.meta["region"]
                        w2 = sym.ring_writes[r2][-1]
                        delay = (sym._cursor_anchor(w2.var, w2.offset,
                                                    w2.mod)
                                 - sym._cursor_anchor(nd.meta["var"],
                                                      nd.meta["offset"],
                                                      w2.mod)) % w2.mod
                        if delay == 0 and not any(
                                u.order < nd.meta["order"]
                                for u in sym.ring_writes[r2]):
                            delay = w2.mod
                        if delay < self.L:
                            rdeps[r2] = min(rdeps.get(r2, delay),
                                            int(delay))
                redges[region] = rdeps

            color: Dict[Tuple[int, int], int] = {}

            def rdfs(u) -> bool:
                color[u] = 1
                for v in redges.get(u, ()):
                    if color.get(v) == 1 or (color.get(v) is None
                                             and not rdfs(v)):
                        return False
                color[u] = 2
                return True

            for r in redges:
                if color.get(r) is None and not rdfs(r):
                    # time-blocked retry: the shortest edge bounds the
                    # largest cycle-free segment.  Conservative (uses the
                    # global min, not just cycle edges); iterating
                    # converges since L strictly shrinks.
                    dmin = min((d for deps in redges.values()
                                for d in deps.values()), default=0)
                    l_new = (dmin // self.B) * self.B
                    if l_new >= self.B and l_new < self.L:
                        raise _SegmentRetry(l_new)
                    raise SpecializeError(
                        "cyclic delay-line coupling between ring buffers "
                        "within one segment — not vectorizable yet "
                        f"(min coupling delay {dmin} < block {self.B})")

        # cross-variable cycles (v depends on prev(w), w on prev(v)) are fine:
        # prev() only needs the other var's solved stream shifted by one — but a
        # genuine cycle among linrec/stream plans through *current* values
        # cannot happen (env is functional).  Nothing more to verify here.
        self.plans = plans

        # gated rand sites: the consumed-draw counter rides in the carry
        self.rand_sites = sorted(sym.rand_sites)
        self.rand_gated = any(g is not None for _s, g in self.rand_sites)

        # dynamic carried state: every written var + every prev-read key
        # + input spl registers (their post-render value is the last input)
        carried = set(sym.writes) | set(sym.prev_nodes.keys()) | set(sym.inductions)
        carried |= {("spl", c) for c in range(self.nch)}
        if self.rand_gated:
            carried.add(("rand", "used"))
        if sym.masked_loops:
            # runtime monitor for guessed masked-loop bounds: the carried
            # scalar accumulates max(realized n - K) across segments;
            # render_device checks it and rebuilds with a doubled K
            carried.add(("mloop", "ovf"))
        self.carried_vars = sorted(carried, key=repr)
        self.scalar_index = {key: i for i, key in enumerate(self.carried_vars)}
        self.ring_regions = sorted(
            {**{w: None for w in sym.ring_writes}}.keys())
        # regions @sample reads but never writes: baked static normally; in
        # the coupled regime @block may rewrite them per block, so they ride
        # in the carry and sync with the device heap
        static = {n.meta["region"] for n in self._all_nodes(sym)
                  if n.kind in ("ringref", "dynringref")
                  and n.meta["region"] not in sym.ring_writes}
        static |= {n.meta["region"] for n in self._all_nodes(sym)
                   if n.kind in ("gringref", "gdynringref")
                   and n.meta["region"] not in sym.gring_writes}
        self.static_ring_regions = sorted(static)
        self.gring_regions = sorted(sym.gring_writes)

        # gated dynamic writes (write-only metering histories): resolve
        # index bounds and require full disjointness from everything the
        # sample path reads or writes
        self.dyn_write_map: Dict[Tuple[int, int], _DynWrite] = {}
        for w in sym.dyn_writes:
            mod = _dyn_write_bound(sym, w.idx)
            if mod is None:
                raise SpecializeError(
                    "dynamic mem write with unprovable index bound")
            w.mod = mod
            region = (w.origin, mod)
            if region in self.dyn_write_map:
                raise SpecializeError(
                    "multiple dynamic writes to one mem region per sample")
            self.dyn_write_map[region] = w
        if self.dyn_write_map:
            read_spans = list(static) + \
                list(sym.ring_writes.keys()) + \
                list(self.gring_regions) + \
                [(a, 1) for a in sym.read_cells] + \
                [(a, 1) for a in sym.written_cells if a >= 0]
            for origin, mod in self.dyn_write_map:
                for o2, m2 in read_spans:
                    if origin < o2 + m2 and o2 < origin + mod:
                        raise SpecializeError(
                            "dynamic mem write region overlaps sample-read "
                            "state — last-writer read resolution not "
                            "supported for gated writes yet")
        self.dyn_regions = sorted(self.dyn_write_map)
        self.carry_regions = self.ring_regions + self.dyn_regions \
            + self.gring_regions + (
                self.static_ring_regions
                if (self.coupled or self._hop_body is not None) else [])

    # -- emission ------------------------------------------------------------
    # -- emission ------------------------------------------------------------

    def _const(self, v: float):
        """A Python float as a 0-d f64 tensor on the kernel's device, made
        once per value (and per sign of zero)."""
        import torch

        ck = (v, math.copysign(1.0, v))
        got = self._const_cache.get(ck)
        if got is None:
            got = torch.tensor(v, dtype=torch.float64, device=self.device)
            if v == v:
                self._const_cache[ck] = got
        return got

    def scan_level_program(self, level: int):
        """One DAG level of scan groups, lowered for `scan_group` once for
        the kernel's life (the plan is static): (carried keys, external
        GNodes, ScanGroupProgram with the step list and the generated
        source, positions of the carries in svec as an int64 tensor on
        the kernel's device)."""
        import torch

        from ..kernels.scan_group import ScanGroupProgram

        lowered = self._scan_programs.get(level)
        if lowered is not None:
            return lowered
        scan_group_keys, externals, steps, outs = self._scan_steps[level]
        lowered = self._scan_programs[level] = (
            scan_group_keys, externals,
            ScanGroupProgram(steps, outs, len(externals)),
            torch.tensor([self.scalar_index[g] for g in scan_group_keys],
                         dtype=torch.int64).to(self.device))
        return lowered

    def _scan_level_steps(self, level: int):
        """One DAG level's internal DAG in evaluation order: (carried
        keys, external GNodes, steps, outputs); raises SpecializeError
        where a node has no scan-group step."""
        P_plans = self.plans
        scan_group_keys = [k for i, grp in enumerate(self.scan_groups)
                           if self.scan_levels.get(i, 0) == level
                           for k in grp]
        scan_gset = set(scan_group_keys)
        targets = {g: P_plans[g].out for g in scan_group_keys}
        internal_memo: Dict[int, bool] = {}

        def is_internal(x) -> bool:
            if not isinstance(x, GNode):
                return False
            got = internal_memo.get(id(x))
            if got is not None:
                return got
            if x.kind == "prev":
                r = x.meta["key"] in scan_gset
            elif x.kind in ("dynringref", "gdynringref"):
                if any(is_internal(a) for a in x.args):
                    raise SpecializeError(
                        "dynamic delay index driven by a sequential "
                        "recurrence group")
                r = False
            elif x.kind in ("in", "ind", "ringidx", "ringref",
                            "ctrl", "rand"):
                r = False
            else:
                r = any(is_internal(a) for a in x.args)
            internal_memo[id(x)] = r
            return r

        externals: List[GNode] = []
        ext_ids: Dict[int, int] = {}
        g_index = {g: i for i, g in enumerate(scan_group_keys)}
        # the internal DAG in evaluation order; an operand is
        # ("c", float) | ("x", external) | ("p", carry) | ("s", slot)
        steps: List[Tuple[str, str, Dict, List]] = []
        slot_of: Dict[int, int] = {}

        def lower(x):
            if not isinstance(x, GNode):
                return ("c", x)
            if not is_internal(x):
                if id(x) not in ext_ids:
                    ext_ids[id(x)] = len(externals)
                    externals.append(x)
                return ("x", ext_ids[id(x)])
            if x.kind == "prev":
                return ("p", g_index[x.meta["key"]])
            got = slot_of.get(id(x))
            if got is None:
                if x.kind not in ("bin", "call", "select",
                                  "normloop"):
                    raise SpecializeError(
                        f"a {x.kind} node inside a sequential recurrence "
                        "group has no scan-group step (ROADMAP queue 3: "
                        "a power-of-two mask fed by a group carry)")
                args = [lower(a) for a in x.args]
                got = len(steps)
                slot_of[id(x)] = got
                steps.append((x.kind, x.op, x.meta, args))
            return ("s", got)

        outs = [lower(targets[g]) for g in scan_group_keys]
        return scan_group_keys, externals, steps, outs

    def scan_level_programs(self) -> Dict[int, Any]:
        """Every DAG level of scan groups, lowered: {level:
        `scan_level_program(level)`}; empty for a plan without them."""
        return {lv: self.scan_level_program(lv) for lv in self._scan_steps}

    def _make_seg_fn(self, L: int, nf: int = 1,
                     graph: bool = False) -> Callable:
        """The per-segment program of length L over a batch of nf files,
        in torch.

        Counterpart of the reference's `_make_seg_fn` under its files
        vmap (zorak_tpu/parallel/batch.py): the same walk over the plan's
        GNode DAG, run eagerly, with the files as a leading axis.  A
        file's streams are [nf, L] (x [nf, nch, L], the carry (svec [nf,
        n], rings {region: [nf, mod]})); what every file shares stays
        unbatched and broadcasts: the control and draw streams [L], the
        read-only regions [mod], the host-known values.  A file's rows go
        through the same operations in the same order as when it renders
        alone, so the batch equals the solo renders bit for bit, and the
        solo render is the nf = 1 case of this program.

        The host keeps a mirror of the carried scalars it can compute
        itself (cursors, counters, constants), shared by every file, so
        every ring cursor is a Python int and every ring access a slice (a
        view) of `[history | this segment's write stream]`, and no segment
        waits for the device: the values only the device knows (a
        recurrence's last state) stay [nf, 1] tensors.  Three hot loops
        go to the hand-written kernels, each launched once for the whole
        batch: the linear recurrences (`linrec_scan`, files x rows as its
        rows), the ring tap sums (`ring_tap_sum`: the chains planned into
        one launch together, each ring read in place, the files its grid's
        third axis) and the sequential scan groups (`scan_group`,
        generated from the group's steps, a block a component and file).

        `graph`: the program K5 captures (`_run_steps`).  It reads no host
        value but the ring cursors that shape it (slices, split points,
        the tap launches' cursors and the writeback's start, each a cursor
        mod a ring's length): every other carried scalar comes from svec,
        the induction counters advance on the device by the host's
        operations in the host's order, and nothing is uploaded, so one
        capture replays on every segment whose cursors agree mod those
        lengths.  `seg.uses` collects the (slot, length) pairs its runs
        reduced a cursor by.  The host mirror is the caller's to advance
        (`_advance_mirror`): the step returns None in its place.
        """
        import torch

        from . import eelmath as EM
        from ..kernels.gated_index import (
            CursorReader, dyn_ring_read as ring_read, gated_cursor,
            gated_draws, gated_ring_write, ring_cursor)
        from ..kernels.linrec_scan import linrec_scan
        from ..kernels.ring_taps import ring_tap_sum
        from ..kernels.scan_group import scan_group

        F64 = torch.float64
        dev = self.device
        P_plans = self.plans
        sym = self.sym
        nch = self.nch
        carried_vars = self.carried_vars
        carry_regions = self.carry_regions
        dyn_write_map = self.dyn_write_map
        snap = self.snap
        const = self._const

        # read-only regions bake as constants, shared by every file; in the
        # coupled and hop regimes they ride in the carry instead (@block or
        # the hop section may rewrite them)
        static_regions: Dict[Tuple[int, int], Any] = {}
        baked = not (self.coupled or self._hop_body is not None)
        for node in (self._all_nodes(sym) if baked else []):
            if (node.kind in ("ringref", "dynringref")
                    and node.meta["region"] not in sym.ring_writes) \
                    or (node.kind in ("gringref", "gdynringref")
                        and node.meta["region"] not in sym.gring_writes):
                origin, mod = node.meta["region"]
                if (origin, mod) in static_regions:
                    continue
                snap.mem_ensure(origin + mod)
                static_regions[(origin, mod)] = torch.from_numpy(np.array(
                    snap.mem[origin:origin + mod], dtype=np.float64)).to(dev)

        scalar_index = self.scalar_index
        scan_groups = self.scan_groups
        scan_levels = self.scan_levels
        ctrl_index = {k: i for i, k in enumerate(self.ctrl_order)}
        B = self.B
        rand_gated = self.rand_gated
        rand_sites = self.rand_sites
        t64 = torch.arange(L, dtype=torch.int64, device=dev)
        tf = t64.to(F64)
        # the carried regions a gated cursor writes, by cursor: K6c writes
        # them in one launch
        gated_regions: Dict[Any, List[Tuple[int, int]]] = {}
        for region in carry_regions:
            if not sym.ring_writes.get(region) and region in sym.gring_writes:
                gated_regions.setdefault(
                    sym.gring_writes[region][0].var, []).append(region)

        def upload(values, dtype):
            """A host list as a tensor on the kernel's device, without
            making the host wait for the device: a plain copy from
            pageable memory synchronises the stream, one through pinned
            memory does not."""
            host = torch.tensor(values, dtype=dtype)
            if dev.type != "cuda":
                return host
            return host.pin_memory().to(dev, non_blocking=True)

        def is_scalar(v) -> bool:
            """One value a file (a float, a 0-d or an [nf, 1] tensor), not
            a stream ([L] or [nf, L]); at L = 1 the two agree."""
            return isinstance(v, float) or v.dim() == 0 or v.shape[-1] == 1

        def seg(carry, xs, known):
            """One segment.  `known[i]` is carried scalar i as a Python
            float where the host knows it (the same for every file), else
            None (it is svec[:, i] on the device).  Returns (new carry, y
            [nf, nch, L], new known)."""
            xseg, ctrlseg, randseg = xs
            svec, rings = carry
            memo: Dict[int, Any] = {}

            def sc(key):
                """A carried scalar: a float, or an [nf, 1] device tensor
                (always the tensor in the graph's program)."""
                i = scalar_index[key]
                v = None if graph else known[i]
                return svec[:, i:i + 1] if v is None else v

            def host_scalar(key) -> float:
                """A carried scalar as a float; reads the device (and
                waits for it) only for a value the host does not know,
                which every file must then agree on."""
                i = scalar_index[key]
                if known[i] is None:
                    known[i] = _shared_value(svec[:, i].tolist(), key)
                return known[i]

            def host_cursor(var, mod) -> int:
                """A ring cursor as the host's int, to be taken mod
                `mod`: the one host value the graph's program reads."""
                if not graph:
                    return _host_i64(host_scalar(var))
                i = scalar_index[var]
                if known[i] is None:
                    raise SpecializeError(
                        f"the captured step needs the cursor {var!r}, which "
                        "the host does not know (a plan K5 refuses)")
                seg.uses.add((i, mod))
                return _host_i64(known[i])

            var_stream: Dict[Any, Any] = {}
            var_prev: Dict[Any, Any] = {}
            ring_src: Dict[Tuple[Tuple[int, int], int], Any] = {}
            in_progress: Set[Any] = set()

            def cursor_start(var, offset, mod):
                return (host_cursor(var, mod) + offset) % mod

            def cursor_idx(var, offset, mod, k0, k1):
                start = cursor_start(var, offset + k0, mod)
                with _k3b_range():
                    return ring_cursor(start, mod, k1 - k0, dev)

            def _arr(v):
                return const(v) if isinstance(v, float) else v

            def _full(v):
                """A value as [nf, L]: a view where it is shared."""
                if isinstance(v, float):
                    return torch.full((L,), v, dtype=F64,
                                      device=dev).expand(nf, L)
                return v.expand(nf, L)

            def _rows(vals):
                """Python floats and one-value-a-file tensors -> [nf, k]
                (one upload for the floats of every file; in the graph's
                program, where every float is a constant, a join)."""
                if graph:
                    if not vals:
                        return torch.zeros((nf, 0), dtype=F64, device=dev)
                    return torch.cat(
                        [(const(v) if isinstance(v, float) else v)
                         .reshape(-1, 1).expand(nf, 1) for v in vals], dim=1)
                out = upload([v if isinstance(v, float) else 0.0
                              for v in vals] * nf, F64).view(nf, len(vals))
                for i, v in enumerate(vals):
                    if not isinstance(v, float):
                        out[:, i:i + 1] = v
                return out

            def ring_of(region):
                """A region's ring: the carry's, or its baked constant."""
                return (rings[region] if region not in static_regions
                        else static_regions[region])

            # K6: a gated cursor's readers, its draws and its ring writes,
            # one launch each a gate and segment (kernels/gated_index.py);
            # their inputs are emitted outside K6's range
            k6: Dict[Any, Any] = {}

            def gated_cursor_out(var):
                """K6a's launch for gated cursor var, memoized: (its
                readers' outputs, the cursor's next carried value)."""
                got = k6.get(("cursor", var))
                if got is None:
                    specs, _stream, carry_mod = self._gate_readers(var)
                    gate = _arr(emit(sym.gate_of[var]))
                    readers = [CursorReader(kind, off, mod, incl, origin,
                                            None if region is None
                                            else ring_of(region))
                               for kind, off, mod, incl, origin, region
                               in specs]
                    with _k6_range():
                        got = gated_cursor(gate, sc(var), readers, nf, L,
                                           carry_mod)
                    k6[("cursor", var)] = got
                return got

            def gated_reader(x):
                """A `gringidx` or `gringref` node's value: its reader's
                output of K6a's launch (a launch of its own for a reader
                the plan did not list)."""
                var = x.meta["var"]
                spec = _gate_reader_spec(x)
                specs = self._gate_readers(var)[0]
                if spec in specs:
                    return gated_cursor_out(var)[0][specs.index(spec)]
                kind, off, mod, incl, origin, region = spec
                gate = _arr(emit(sym.gate_of[var]))
                reader = CursorReader(kind, off, mod, incl, origin,
                                      None if region is None
                                      else ring_of(region))
                with _k6_range():
                    return gated_cursor(gate, sc(var), [reader], nf, L)[0][0]

            # gated rand: sites draw only when their branch gate holds, so
            # the flat MT19937 pool (randseg: the whole render's) is
            # indexed by a fire-count prefix sum, from each file's own
            # consumed-draw count (carried)
            rand_ctx: Dict[str, Any] = {}

            def gated_rand_vals():
                """The draws [nf, L, sites] of every rand site (K6b)."""
                got = rand_ctx.get("vals")
                if got is not None:
                    return got
                if rand_ctx.get("building"):
                    raise SpecializeError(
                        "rand draw feeds its own gating — draw compaction "
                        "is not expressible")
                rand_ctx["building"] = True
                gates = [None if gate is None else _arr(emit(gate))
                         for _slot, gate in rand_sites]
                rand_ctx["building"] = False
                with _k6_range():
                    rand_ctx["vals"], rand_ctx["used"] = gated_draws(
                        gates, sc(("rand", "used")), randseg, nf, L)
                return rand_ctx["vals"]

            tap_emitting: Set[int] = set()

            def emit_tap_group(group):
                """Folds every chain of a launch and memoizes each one's
                sum: one `ring_tap_sum` call, the rings read in place."""
                if id(group) in tap_emitting:
                    raise SpecializeError(
                        "tap chains of one launch feed each other")
                tap_emitting.add(id(group))
                rings_g, cursors, streams, inits = [], [], [], []
                for m in group.members:
                    w = sym.ring_writes[m.region][-1]
                    rings_g.append(rings[m.region])
                    cursors.append(cursor_start(w.var, w.offset, m.region[1]))
                    streams.append(ring_source(m.region) if m.needs_src
                                   else None)
                    inits.append(emit(m.init))
                out = ring_tap_sum(group.tables, rings_g, cursors, streams,
                                   inits, L)
                tap_emitting.discard(id(group))
                for i, m in enumerate(group.members):
                    memo[id(m.root)] = out[i]

            def emit(x):
                if not isinstance(x, GNode):
                    return x  # python float (broadcasts)
                got = memo.get(id(x))
                if got is not None:
                    return got
                if x.kind == "in":
                    val = xseg[:, x.meta["ch"]]
                elif x.kind == "ctrl" and ctrlseg.dim() == 3:
                    # the coupled regime: a row a file and block, [nf,
                    # rows, n_ctrl], from the device @block
                    col = ctrlseg[:, :, ctrl_index[x.meta["key"]]]
                    val = (col.expand(nf, L) if col.shape[1] == 1 else
                           torch.repeat_interleave(col, B, dim=1)[:, :L])
                elif x.kind == "ctrl":
                    col = ctrlseg[:, ctrl_index[x.meta["key"]]]
                    val = torch.repeat_interleave(col, B)[:L]
                elif x.kind == "rand":
                    val = (gated_rand_vals()[:, :, x.meta["slot"]]
                           if rand_gated else randseg[:, x.meta["slot"]])
                elif x.kind == "prev":
                    val = prev_of(x.meta["key"])
                elif x.kind == "ind":
                    val = sc(x.meta["var"]) + (x.meta["offset"] + tf)
                elif x.kind == "ringidx":
                    idx = cursor_idx(x.meta["var"], x.meta["offset"],
                                     x.meta["mod"], 0, L)
                    val = idx.to(F64) + float(x.meta["origin"])
                elif x.kind in ("gringidx", "gringref"):
                    # a gringref: plan time pinned every tap of a written
                    # gated region into carry history (G-space delay >= L),
                    # so the gather never reads this segment's writes
                    val = gated_reader(x)
                elif x.kind == "gdynringref":
                    # bounded dynamic-delay tap off a gated cursor: the
                    # masked index expression is the absolute slot, which
                    # plan time proved reaches only carry history (K3b's
                    # gather, in K6's range)
                    slot = _arr(emit(x.args[0]))
                    with _k6_range():
                        val = ring_read(ring_of(x.meta["region"]), slot, nf,
                                        L)
                elif x.kind == "bin":
                    # the plan is static, so a `+` node is matched once
                    # for the kernel's life, not once a segment
                    group = (self._tap_group(x, L, nf) if x.op == "+"
                             else None)
                    if group is not None:
                        emit_tap_group(group)
                        return memo[id(x)]
                    val = EM.BINARY[x.op](_arr(emit(x.args[0])),
                                          _arr(emit(x.args[1])))
                elif x.kind == "call":
                    val = EM.UNARY[x.op](_arr(emit(x.args[0])))
                elif x.kind == "select":
                    c = _arr(emit(x.args[0]))
                    val = EM.eel_select(c, _arr(emit(x.args[1])),
                                        _arr(emit(x.args[2])))
                elif x.kind == "maskidx":
                    val = EM.eel_and(_arr(emit(x.args[0])),
                                     const(float(x.meta["mod"] - 1)))
                elif x.kind == "normloop":
                    if graph:
                        # its loop reads the device each pass
                        raise SpecializeError(
                            "a normloop in the captured step (a plan K5 "
                            "refuses)")
                    val = _norm_loop(_arr(emit(x.args[0])), x.meta)
                elif x.kind == "ringref":
                    region = x.meta["region"]
                    ws = sym.ring_writes.get(region)
                    if ws is None:
                        origin, mod = region
                        src_arr = (rings[region] if region not in
                                   static_regions else static_regions[region])
                        val = src_arr[..., cursor_idx(x.meta["var"],
                                                      x.meta["offset"], mod,
                                                      0, L)]
                    else:
                        w = ws[-1]
                        # delay via cursor anchors so distinct-but-equal
                        # cursor vars (shared multi-writer rings) resolve
                        delay = (sym._cursor_anchor(w.var, w.offset, w.mod)
                                 - sym._cursor_anchor(x.meta["var"],
                                                      x.meta["offset"],
                                                      w.mod)) % w.mod
                        if delay == 0:
                            pre = [u for u in ws
                                   if u.order < x.meta["order"]]
                            if pre:
                                # same-slot same-sample: latest preceding
                                # writer in program order wins
                                val = write_stream(region, ws.index(pre[-1]))
                            else:
                                # read precedes every write: prior wrap
                                val = ring_delayed(region, w.mod)
                        else:
                            val = ring_delayed(region, delay)
                elif x.kind == "dynringref":
                    val = dyn_ring_read(x)
                else:
                    raise AssertionError(x.kind)
                memo[id(x)] = val
                return val

            ring_emitting: Set[Tuple[int, int, int]] = set()

            def write_stream(region, i):
                """Vectorized value stream of the region's i-th write."""
                ck = (region, i)
                src = ring_src.get(ck)
                if src is None:
                    if (region[0], region[1], i) in ring_emitting:
                        raise SpecializeError(
                            "cyclic delay-line coupling between ring buffers"
                            " — not vectorizable yet")
                    ring_emitting.add((region[0], region[1], i))
                    src = _full(emit(sym.ring_writes[region][i].value))
                    ring_emitting.discard((region[0], region[1], i))
                    ring_src[ck] = src
                return src

            def ring_source(region):
                """Final slot value per sample = last write in program
                order (multi-writer rings: last writer wins)."""
                return write_stream(region, len(sym.ring_writes[region]) - 1)

            ring_cache: Dict[Tuple[Any, Any], Any] = {}

            def ring_window(region, var, offset, k):
                """`rings[region]` at cursor positions (var+offset ..
                +k-1) mod M: a slice, or two joined at the wrap."""
                mod = region[1]
                ring = rings[region]
                if k > mod:   # window re-wraps: the general gather
                    return ring[:, cursor_idx(var, offset, mod, 0, k)]
                start = cursor_start(var, offset, mod)
                if start + k <= mod:
                    return ring[:, start:start + k]
                return torch.cat([ring[:, start:], ring[:, :start + k - mod]],
                                 dim=1)

            def ring_hist(region):
                """The region's whole ring in write order (element mod-1 =
                most recent past sample), shared by every tap."""
                got = ring_cache.get((region, "hist"))
                if got is None:
                    w = sym.ring_writes[region][-1]
                    got = ring_window(region, w.var, w.offset, region[1])
                    ring_cache[(region, "hist")] = got
                return got

            def ring_hist_full(region):
                """[history | this segment's final write stream], length
                mod+L; a tap at delay d<L is full[mod-d : mod-d+L]."""
                got = ring_cache.get((region, "full"))
                if got is None:
                    got = torch.cat([ring_hist(region), ring_source(region)],
                                    dim=1)
                    ring_cache[(region, "full")] = got
                return got

            def ring_delayed(region, delay):
                if delay == 0:
                    return ring_source(region)
                mod = region[1]
                # delay >= L: the whole read window predates this segment,
                # so slice the source-free history only (keeps long
                # feedback legal and cycle-free)
                buf = ring_hist(region) if delay >= L \
                    else ring_hist_full(region)
                return buf[:, mod - delay:mod - delay + L]

            def dyn_ring_read(x):
                """Read with a time-varying slot index: resolve each sample
                against whichever write (this segment or ring history) last
                touched that slot."""
                region = x.meta["region"]
                # the slot's expression, the segment's writes and the
                # joined history are emitted outside K3b's range
                slot = _arr(emit(x.args[0]))                # in [0, mod)
                ws = sym.ring_writes.get(region)
                if ws is None:
                    with _k3b_range():
                        return ring_read(ring_of(region), slot, nf, L)
                w = ws[-1]
                full = ring_hist_full(region)
                # the write cursor: the host's, or in the graph's program
                # the device's ([nf, 1]; the kernel converts either)
                cursor = sc(w.var) if graph else host_scalar(w.var)
                pre = [u for u in ws if u.order < x.meta["order"]]
                # same-slot same-sample reads see the latest PRECEDING
                # writer, not the region's final (last-writer) value
                same = (write_stream(region, ws.index(pre[-1]))
                        if pre and pre[-1] is not w else None)
                with _k3b_range():
                    return ring_read(full, slot, nf, L, cursor, w.offset,
                                     bool(pre), same)

            solved_groups: Set[int] = set()

            def solve_scan_group(gid):
                """Jointly solve one sequential-recurrence group with ONE
                `scan_group` call a DAG level (the generated kernel on a
                CUDA device, the plain per-sample loop on the CPU);
                external feeds stay vectorized and stream in as inputs.
                Groups run in dependency order (the group graph is a DAG,
                checked at plan time)."""
                if gid in solved_groups:
                    return
                # levels are mutually independent, so batching only
                # concatenates the carries; the files are the kernel's
                # own axis
                level = scan_levels.get(gid, 0)
                batch = [i for i in range(len(scan_groups))
                         if scan_levels.get(i, 0) == level
                         and i not in solved_groups]
                solved_groups.update(batch)
                # the plan is static: a level is lowered, and its kernel's
                # text printed, once for the kernel's life
                keys, externals, program, carry_idx = \
                    self.scan_level_program(level)
                xs_l = (torch.stack([_full(emit(e)) for e in externals],
                                    dim=2) if externals
                        else torch.zeros((nf, L, 0), dtype=F64, device=dev))
                # the start carries stay where they are: svec holds every
                # carried scalar, known to the host or not
                ys = scan_group(program, xs_l, svec[:, carry_idx])
                for i, g in enumerate(keys):
                    var_stream[g] = ys[:, :, i]

            linrec_waves = ({} if not _LINREC_BATCH
                            else self._linrec_wave_map())

            def solve_linrec_wave(wave) -> bool:
                """Emit every linrec of a dependency wave and solve them
                with ONE launch each for the scalar-A and the vector-A
                rows.  Returns False (state restored) if emission of any
                member recursed into the wave itself — the conservative
                wave map missed a dependency — so the caller falls back to
                the per-recurrence path."""
                live = [k for k in wave if k not in var_stream]
                if len(live) < 2:
                    return False
                saved_ip = set(in_progress)
                saved_re = set(ring_emitting)
                in_progress.update(live)
                emitted = []
                try:
                    for k in live:
                        p = P_plans[k]
                        emitted.append((k, emit(p.A), _full(emit(p.B))))
                except SpecializeError:
                    in_progress.clear()
                    in_progress.update(saved_ip)
                    ring_emitting.clear()
                    ring_emitting.update(saved_re)
                    return False
                in_progress.difference_update(set(live) - saved_ip)
                scalar_g = [e for e in emitted if is_scalar(e[1])]
                vector_g = [e for e in emitted if not is_scalar(e[1])]
                for grp in (scalar_g, vector_g):
                    if grp:
                        out = solve_linrecs([e[1] for e in grp],
                                            [e[2] for e in grp],
                                            [sc(e[0]) for e in grp],
                                            grp is scalar_g)
                        for i, e in enumerate(grp):
                            var_stream[e[0]] = out[:, i]
                return True

            def solve_linrecs(As, Bs, z0s, scalar_a):
                """k recurrences of every file in ONE `linrec_scan` launch:
                the rows are files x recurrences ([nf * k, L]), each row's
                a one value (scalar_a) or a stream.  Returns [nf, k, L]."""
                k = len(Bs)
                Am = (_rows(As).reshape(nf * k) if scalar_a
                      else torch.stack([_full(a) for a in As],
                                       dim=1).reshape(nf * k, L))
                Bm = torch.stack(Bs, dim=1).reshape(nf * k, L)
                z0 = _rows(z0s).reshape(nf * k)
                return linrec_scan(Am, Bm, z0).view(nf, k, L)

            def stream_of(key):
                got = var_stream.get(key)
                if got is not None:
                    return got
                if key in in_progress:
                    raise SpecializeError(f"unexpected cyclic emission on {key!r}")
                in_progress.add(key)
                plan = P_plans[key]
                if plan.kind == "const":
                    val = torch.full((L,), plan.out, dtype=F64, device=dev)
                elif plan.kind == "induction":
                    val = sc(key) + (plan.out + tf)
                elif plan.kind == "modind":
                    # end-of-sample cursor value: (c0 + t + step) mod M
                    val = cursor_idx(key, plan.out, plan.A, 0, L).to(F64)
                elif plan.kind == "gmodind":
                    # end-of-sample gated cursor: anchor + inclusive prefix
                    val = gated_cursor_out(key)[0][self._gate_readers(key)[1]]
                elif plan.kind == "stream":
                    val = _full(emit(plan.out))
                elif plan.kind == "linrec":
                    wave = linrec_waves.get(key)
                    if wave is not None and solve_linrec_wave(wave) \
                            and key in var_stream:
                        val = var_stream[key]
                    else:
                        A = emit(plan.A)
                        val = solve_linrecs([A], [_full(emit(plan.B))],
                                            [sc(key)], is_scalar(A))[:, 0]
                elif plan.kind == "scan":
                    solve_scan_group(plan.step)
                    val = var_stream[key]
                else:
                    raise AssertionError(plan.kind)
                in_progress.discard(key)
                var_stream[key] = val
                return val

            def prev_of(key):
                got = var_prev.get(key)
                if got is not None:
                    return got
                if key in P_plans:
                    cur = stream_of(key)
                    val = torch.empty((nf, L), dtype=F64, device=dev)
                    val[:, :1] = sc(key)
                    val[:, 1:] = cur[..., :-1]
                else:
                    val = _full(sc(key))
                var_prev[key] = val
                return val

            # outputs: spl registers after the body
            outs = []
            for c in range(nch):
                key = ("spl", c)
                sv = sym.env.get(key)
                if key in sym.writes:
                    outs.append(_full(stream_of(key)))
                elif sv is not None and isinstance(sv, TS) and sv.node.kind == "in":
                    outs.append(xseg[:, c])
                else:
                    outs.append(_full(sc(key)) if key in scalar_index
                                else xseg[:, c])
            y = torch.stack(outs, dim=1)

            # carry updates: host floats and 0-d device values, joined
            # into one vector
            new_vals = []
            for key in carried_vars:
                if key == ("rand", "used"):
                    # force the gate masks even if every draw is dead code:
                    # the golden still consumes those draws
                    gated_rand_vals()
                    new_vals.append(rand_ctx["used"])
                elif key == ("mloop", "ovf"):
                    # masked-loop overflow monitor: a running max of
                    # (realised loop count - guessed bound K); a positive
                    # value voids the render and render_device's ladder
                    # rebuilds with a doubled K and replays
                    acc = _arr(sc(key))
                    for cnt_node, k_lim in sym.masked_loops:
                        acc = torch.maximum(
                            acc, _full(emit(cnt_node)).amax(
                                dim=1, keepdim=True) - float(k_lim))
                    new_vals.append(acc)
                elif key in P_plans:
                    plan = P_plans[key]
                    if plan.kind in _COUNTER_PLANS:
                        v = None if plan.kind == "const" else (
                            sc(key) if graph else host_scalar(key))
                        new_vals.append(_counter_next(plan, v, L))
                    elif plan.kind == "gmodind":
                        # a value a file: the device keeps it
                        new_vals.append(gated_cursor_out(key)[1])
                    else:
                        new_vals.append(stream_of(key)[..., -1:])
                elif key[0] == "spl" and key[1] < nch:
                    new_vals.append(xseg[:, key[1], -1:])
                else:
                    new_vals.append(sc(key))
            new_svec = _rows(new_vals)
            new_known = None if graph else [
                v if isinstance(v, float) else None for v in new_vals]
            new_rings = {}
            for region in carry_regions:
                ws_r = sym.ring_writes.get(region)
                w = ws_r[-1] if ws_r else None
                if w is None:
                    gws = sym.gring_writes.get(region)
                    if gws is not None:
                        # gated ring write: the segment's writes land at
                        # consecutive G-space positions (the cursor
                        # advances exactly when the write fires); every
                        # region of the cursor in one K6c launch
                        var = gws[0].var
                        if ("write", var) not in k6:
                            regs = gated_regions[var]
                            writes = [
                                (rings[r], _full(emit(sym.gring_writes[r][0]
                                                      .value)),
                                 sym.gring_writes[r][0].offset, r[1])
                                for r in regs]
                            gate = _arr(emit(sym.gate_of[var]))
                            with _k6_range():
                                k6[("write", var)] = dict(zip(
                                    regs, gated_ring_write(gate, sc(var),
                                                           writes, nf, L)))
                        new_rings[region] = k6[("write", var)][region]
                        continue
                    dw = dyn_write_map.get(region)
                    if dw is None:  # carried read-only region: pass through
                        new_rings[region] = rings[region]
                        continue
                    # gated dynamic write, last writer wins: the latest
                    # write time per slot (amax), then each written slot's
                    # value at that time; dead samples go to a spare slot.
                    # Each file scatters into its own row.
                    mod = region[1]
                    idx = EM.to_i64(_arr(emit(dw.idx))).expand(nf, L)
                    val = _full(emit(dw.value))
                    live = (idx >= 0) & (idx < mod)
                    if dw.gate is not None:
                        live = live & EM.truthy_mask(_arr(emit(dw.gate)))
                    pos = torch.where(live, idx, torch.full_like(idx, mod))
                    lastt = torch.zeros((nf, mod + 1), dtype=torch.int64,
                                        device=dev).scatter_reduce(
                        1, pos, (t64 + 1).expand(nf, L), "amax")[:, :mod]
                    gathered = torch.gather(val, 1, (lastt - 1).clamp(0, L - 1))
                    new_rings[region] = torch.where(lastt > 0, gathered,
                                                    rings[region])
                    continue
                src = ring_source(region)
                k = min(L, w.mod)
                mod = w.mod
                # the last k writes land at consecutive mod-M positions
                # from `start`: copy them into a fresh ring in one or two
                # slices (the carry handed in is left as it was)
                start = (host_cursor(w.var, mod) + w.offset
                         + (L - k)) % mod
                ring = rings[region].clone()
                n1 = min(k, mod - start)
                ring[:, start:start + n1] = src[:, L - k:L - k + n1]
                if k > n1:
                    ring[:, :k - n1] = src[:, L - k + n1:]
                new_rings[region] = ring
            seg.ran = True
            return (new_svec, new_rings), y, new_known

        seg.uses = set()
        seg.ran = False
        return seg

    # -- state plumbing ------------------------------------------------------

    def cached_trajectory(self, n_blocks: int, rem_block: int = 0):
        """Input-independent control trajectory, memoized per length:
        host-side @block interpretation otherwise dominates repeated
        renders of fast kernels."""
        tkey = (n_blocks, rem_block)
        cached = self._traj_cache.get(tkey)
        if cached is not None:
            ctrl, self.last_control_state, self._traj_midi_out = cached
            return ctrl
        ctrl = self.control_trajectory(n_blocks, rem_block)
        if len(self._traj_cache) < 8:
            self._traj_cache[tkey] = (ctrl, self.last_control_state,
                                      self._traj_midi_out)
        return ctrl

    def trajectory_stepper(self, midi=None, resume=False) -> "_TrajStepper":
        """Block-at-a-time @block/@slider interpretation on the host, by
        the Python golden."""
        if self._traj_plugin is None:
            from ..shadow import compile_shadow

            self._traj_plugin = compile_shadow(self.P)
        plug = self._traj_plugin
        src = self.last_control_state if (resume and
                                          self.last_control_state is not None) \
            else self.snap
        plug.state = src.clone()
        return _TrajStepper(self, plug, sorted(midi or [],
                                               key=lambda e: e[0]),
                            bool(midi))

    def control_trajectory(self, n_blocks: int, rem_block: int = 0,
                           midi=None, resume=False):
        """Interpret the @block/@slider trajectory on the host; returns the
        control matrix [n_blocks(+1 if rem), n_ctrl] and keeps the final
        control-state for writeback.  midi events route into each block's
        queue (host-side midirecv, the uncoupled path).

        resume=True continues from the previous render's final control
        state (@block counters/envelopes persist across renders like the
        reference's long-lived state struct); the kernel tracks ONE
        resumable stream — pair each resumed carry with its own kernel."""
        stp = self.trajectory_stepper(midi=midi, resume=resume)
        rows = n_blocks + (1 if rem_block else 0)
        for b in range(rows):
            stp.step(rem_block if (rem_block and b == n_blocks) else self.B)
        return stp.finish()

    @staticmethod
    def _key_value(st, key) -> float:
        kind = key[0]
        if kind == "spl":
            return float(st.spl[key[1]])
        if kind == "slider":
            return float(st.sliders[key[1]])
        if kind == "builtin":
            return float(getattr(st, key[1]))
        if kind == "var":
            return float(st.V.get(key[1], 0.0))
        if kind == "mem":
            return float(st.mem[key[1]]) if key[1] < len(st.mem) else 0.0
        raise AssertionError(key)

    def initial_carry(self):
        """Host-side initial carry (numpy): (svec, rings)."""
        sym = self.sym
        svec = np.array([sym._state_value(key) for key in self.carried_vars],
                        dtype=np.float64)
        rings = {}
        for region in self.carry_regions:
            origin, mod = region
            self.snap.mem_ensure(origin + mod)
            rings[region] = np.asarray(self.snap.mem[origin:origin + mod],
                                       dtype=np.float64).copy()
        if self._hop is not None:
            return ((svec, rings), self._hop.initial_vars(),
                    self._hop.initial_mem())
        if not self.coupled:
            return (svec, rings)
        dev = self._devblock
        return ((svec, rings), dev.initial_vars(), dev.initial_mem())

    @property
    def has_device_view(self) -> bool:
        """Whether the carry holds a device section's view, ((svec,
        rings), vars, heap): the coupled @block's or the hop section's."""
        return self.coupled or self._hop is not None

    def device_carry(self, carry):
        """A carry of numpy arrays or tensors -> f64 tensors on the
        kernel's device (copies, so the caller's arrays stay as they are,
        and contiguous: K10 updates them in place).  The coupled and hop
        regimes' carry is ((svec, rings), bvars, bmem)."""
        import torch

        def put(a):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a, dtype=np.float64))
            return a.to(device=self.device, dtype=torch.float64,
                        copy=True).contiguous()

        if self.has_device_view:
            (svec, rings), bvars, bmem = carry
            return ((put(svec), {tuple(r): put(a) for r, a in rings.items()}),
                    put(bvars), put(bmem))
        svec, rings = carry
        return (put(svec), {tuple(r): put(a) for r, a in rings.items()})

    def _seg_fn(self, L: int, nf: int = 1, graph: bool = False):
        fns = self._graph_seg_fns if graph else self._seg_fns
        fn = fns.get((L, nf))
        if fn is None:
            fn = self._make_seg_fn(L, nf, graph)
            fns[(L, nf)] = fn
        return fn

    def mirrored_slots(self) -> List[int]:
        """The carried scalars whose value the host mirrors as a Python
        float for the whole batch (`known` of the segment program): the
        induction and modular-induction counters, and the cursors of
        every ring access.  A batch holds them as one value for all its
        files, so every file must start with the same.  A gated cursor
        (a `gmodind` plan, the cursor of a gated ring) moves with the
        audio: no plain ring access reads it, so it is not listed, and
        the device holds it, a value a file."""
        if self._mirrored is None:
            keys = {k for k, p in self.plans.items()
                    if p.kind in ("induction", "modind")}
            keys |= {w.var for ws in self.sym.ring_writes.values()
                     for w in ws}
            keys |= {n.meta["var"] for n in self._all_nodes(self.sym)
                     if n.kind in ("ringidx", "ringref", "dynringref")
                     and "var" in n.meta}
            self._mirrored = sorted(self.scalar_index[k] for k in keys
                                    if k in self.scalar_index)
        return self._mirrored

    # -- K5: the captured step ------------------------------------------------

    def cursor_slots(self) -> Set[int]:
        """The mirrored slots that shape the segment program: the ring
        cursors (every ring write's, every plain ring access's, and the
        modular counters', whose stream is a cursor's positions).  The
        other mirrored slots, the induction counters, only enter
        arithmetic (value slots)."""
        keys = {w.var for ws in self.sym.ring_writes.values() for w in ws}
        keys |= {n.meta["var"] for n in self._all_nodes(self.sym)
                 if n.kind in ("ringidx", "ringref", "dynringref")
                 and "var" in n.meta}
        keys |= {k for k, p in self.plans.items() if p.kind == "modind"}
        return {self.scalar_index[k] for k in keys if k in self.scalar_index}

    def _find_k5_refusal(self) -> Optional[str]:
        """Why K5 cannot capture this plan's step, or None.  A captured
        step reads no host value but the cursors that shape it, so a plan
        is refused where such a cursor is one the host cannot follow, or
        where a step must read the device or the host mid-way."""
        if any(n.kind == "normloop" for n in self._all_nodes(self.sym)):
            # the segment program may emit it even where a scan group
            # walks it too (a consumer of the loop's own value)
            return ("a range-normalization loop (normloop) reads the "
                    "device each pass")
        cursors = self.cursor_slots()
        for i in sorted(cursors):
            key = self.carried_vars[i]
            plan = self.plans.get(key)
            if plan is not None and plan.kind not in ("induction", "modind",
                                                      "const"):
                return (f"the ring cursor {key!r} is a {plan.kind} the "
                        "device computes, and it shapes the segment")
        if self.coupled:
            for i in self._block_rewrites:
                if i in cursors:
                    return (f"@block rewrites the ring cursor "
                            f"{self.carried_vars[i]!r}, which shapes the "
                            "segment")
            if self.accepts_midi or self._block_prog.midi_out_cells:
                return ("MIDI in the coupled @block: a host event count "
                        "and an out table a block")
        return None

    def _step_mode(self, step) -> str:
        """How a render's steps run (`k5_step_mode`), with `dispatch` set
        to say so: "graph" (K5, captured and replayed), "static" (K5's
        step on CPU tensors, uncaptured) or "eager"."""
        mode, self.dispatch = k5_step_mode([self], step)
        return mode

    def _k5_graphs(self):
        if self._k5 is None:
            from ..kernels.segment_graph import StepGraphs

            self._k5 = StepGraphs(self.device)
        return self._k5

    def _mirror_start(self, svec) -> List[Optional[float]]:
        """The host mirror a captured render starts from: the mirrored
        slots' shared values (one device read), None elsewhere."""
        mirrored = self.mirrored_slots()
        known = _shared_known(svec.tolist(), mirrored, self.carried_vars)
        keep = set(mirrored)
        return [v if i in keep else None for i, v in enumerate(known)]

    def _advance_mirror(self, known, L: int) -> List[Optional[float]]:
        """The host mirror after a segment of L, each mirrored slot as the
        eager step's host computes it, None where only the device knows
        it."""
        out: List[Optional[float]] = [None] * len(known)
        for i in self.mirrored_slots():
            v = known[i]
            plan = self.plans.get(self.carried_vars[i])
            if plan is None:
                out[i] = v                  # @sample does not write it
            elif plan.kind in _COUNTER_PLANS and (
                    v is not None or plan.kind == "const"):
                out[i] = _counter_next(plan, v, L)
        return out

    @staticmethod
    def _k5_key(kind: str, seg, L: int, nf: int, pool, known):
        """A step's capture key: what decides every constant its program
        bakes in (None before the program's first run)."""
        if not seg.ran:
            return None
        cursors = []
        for i, mod in sorted(seg.uses):
            if known[i] is None:
                raise SpecializeError(f"the cursor in slot {i} is unknown "
                                      "to the host (a plan K5 refuses)")
            cursors.append((i, mod, _host_i64(known[i]) % mod))
        return (kind, L, nf, None if pool is None else pool.numel(),
                tuple(cursors))

    def _k5_carry(self, k5, nf: int, svec0, rings0):
        """The static sample-side carry of nf files, loaded with (svec0,
        rings0)."""
        import torch

        svec = k5.static("svec", svec0.shape, torch.float64)
        svec.copy_(svec0)
        rings = {}
        for r, a in rings0.items():
            rings[r] = k5.static(("ring", r), a.shape, torch.float64)
            rings[r].copy_(a)
        return svec, rings

    def _k5_pool(self, k5, rand):
        """The gated regime's draw pool in its static buffer (one copy a
        render), else None."""
        import torch

        if not self.rand_gated:
            return None
        flat = rand.reshape(-1)
        pool = k5.static("pool", flat.shape, torch.float64)
        pool.copy_(flat)
        return pool

    @staticmethod
    def _k5_store(svec, rings, new_svec, new_rings) -> None:
        """A step's new carry into the static one (inside the step)."""
        svec.copy_(new_svec)
        for r, a in new_rings.items():
            if a is not rings[r]:
                rings[r].copy_(a)

    def _run_steps(self, carry, x, ctrl, rand, L: int):
        """`_run` through K5: each segment's inputs copied into the static
        buffers, the step replayed (captured the second time its key is
        seen), the output copied out.  ctrl and the draw rows go in as one
        row a segment, packed once a render."""
        import torch

        f64 = torch.float64
        k5 = self._k5_graphs()
        capture = self.device.type == "cuda"
        nf, nch, T = x.shape
        known = self._mirror_start(carry[0])
        svec, rings = self._k5_carry(k5, nf, *carry)
        pool = self._k5_pool(k5, rand)
        nfull, rem = divmod(T, L)
        rps = L // self.B
        nc = ctrl.shape[1]
        nr = 0 if pool is not None else rand.shape[1]
        spans = [(s * L, s * rps, L, rps) for s in range(nfull)]
        if rem:
            spans.append((nfull * L, nfull * rps, rem,
                          ctrl.shape[0] - nfull * rps))
        parts = ([ctrl[:nfull * rps].reshape(nfull, rps * nc)] if nc else []) \
            + ([rand[:nfull * L].reshape(nfull, L * nr)] if nr else [])
        packed = torch.cat(parts, dim=1) if parts else None
        y = torch.empty((nf, self.nch, T), dtype=torch.float32,
                        device=self.device)
        for s, (t0, r0, n, rows) in enumerate(spans):
            xin = k5.static("x", (nf, nch, n), torch.float32)
            yout = k5.static("y", (nf, self.nch, n), torch.float32)
            aux = k5.static("aux", (rows * nc + n * nr,), f64)
            seg = self._seg_fn(n, nf, graph=True)
            ctrl_v = aux[:rows * nc].view(rows, nc)
            draws = pool if pool is not None else \
                aux[rows * nc:].view(n, nr)

            def body(seg=seg, xin=xin, yout=yout, ctrl_v=ctrl_v,
                     draws=draws, kn=known):
                (sv, rg), yseg, _ = seg((svec, rings),
                                        (xin.to(f64), ctrl_v, draws), kn)
                self._k5_store(svec, rings, sv, rg)
                yout.copy_(yseg)

            with _k5_range():
                xin.copy_(x[:, :, t0:t0 + n])
                if s < nfull and packed is not None:
                    aux.copy_(packed[s])
                elif s == nfull:                  # the remainder's rows
                    if nc:
                        aux[:rows * nc].copy_(ctrl[r0:r0 + rows].reshape(-1))
                    if nr:
                        aux[rows * nc:].copy_(rand[t0:t0 + n].reshape(-1))
                k5.step(lambda seg=seg, n=n, kn=known:
                        self._k5_key("seg", seg, n, nf, pool, kn),
                        body, capture)
                y[:, :, t0:t0 + n].copy_(yout)
            known = self._advance_mirror(known, n)
        self._k5_mirror = known
        return y, (svec.clone(), {r: a.clone() for r, a in rings.items()})

    def _coupled_steps(self, carry, x, rand):
        """`_coupled_run` through K5: a block's step is K10 then the
        block's segment, on the static carry, K10's view and control row
        included."""
        import torch

        k5 = self._k5_graphs()
        capture = self.device.type == "cuda"
        nf, nch, T = x.shape
        B = self.B
        blk = _K5Block(self, k5, carry, rand, nf)
        nfull, rem = divmod(T, B)
        y = torch.empty((nf, self.nch, T), dtype=torch.float32,
                        device=self.device)
        for b in range(nfull + (1 if rem else 0)):
            L = B if b < nfull else rem
            t0 = b * B
            xin = k5.static("x", (nf, nch, L), torch.float32)
            yout = k5.static("y", (nf, self.nch, L), torch.float32)
            blk.begin(L, None if blk.pool is not None else
                      k5.static("aux", (L, blk.nr), torch.float64))
            with _k5_range():
                xin.copy_(x[:, :, t0:t0 + L])
                if blk.pool is None and blk.nr:
                    blk.draws.copy_(rand[t0:t0 + L])
                k5.step(blk.key,
                        lambda xin=xin, yout=yout: blk.body(xin, yout),
                        capture)
                y[:, :, t0:t0 + L].copy_(yout)
            blk.end()
        return y, blk.result(), None

    def _run(self, carry, x, ctrl, rand, L: int, step=None):
        """The segment loop over a batch of files: full segments of L,
        then the remainder.  x [nf, nch, T] on the device (f32 audio, each
        segment taken to f64 as it runs); carry (svec [nf, n], rings
        {region: [nf, mod]}) f64; ctrl and rand shared by every file.
        Returns (y f32 [nf, nch, T], carry).  `step` as `k5_step_mode`
        takes it: K5 (`_run_steps`) or the eager loop below."""
        import torch

        if self._step_mode(step) != "eager":
            return self._run_steps(carry, x, ctrl, rand, L)
        nf, _nch, T = x.shape
        # the one device-to-host read of a render: the scalars it starts
        # from.  From here on each segment hands the next what the host
        # can compute itself, and the rest stays on the device.
        known = _shared_known(carry[0].tolist(), self.mirrored_slots(),
                              self.carried_vars)
        nfull = T // L
        rem = T - nfull * L
        rows_per_seg = L // self.B
        f64 = torch.float64
        draws = self._draws_of(rand)
        y = torch.empty((nf, self.nch, T), dtype=torch.float32,
                        device=self.device)
        for s in range(nfull):
            t0, r0 = s * L, s * rows_per_seg
            carry, yseg, known = self._seg_fn(L, nf)(
                carry, (x[:, :, t0:t0 + L].to(f64),
                        ctrl[r0:r0 + rows_per_seg], draws(t0, t0 + L)), known)
            y[:, :, t0:t0 + L] = yseg
        if rem:
            t0 = nfull * L
            carry, yseg, known = self._seg_fn(rem, nf)(
                carry, (x[:, :, t0:].to(f64), ctrl[nfull * rows_per_seg:],
                        draws(t0, T)), known)
            y[:, :, t0:] = yseg
        return y, carry

    def _draws_of(self, rand):
        """draws(t0, t1): a segment's draw input from the render's draw
        matrix rand [T, n_rand]: its rows, or in the gated regime the whole
        render's flat pool, which each segment indexes by its files'
        consumed-draw counts."""
        if self.rand_gated:
            pool = rand.reshape(-1)
            return lambda t0, t1: pool
        return lambda t0, t1: rand[t0:t1]

    def _coupled_run(self, carry, x, rand, midi_planes=None, step=None):
        """The fused block/sample pipeline over a batch of files: a host
        loop over blocks, each one K10 launch (the device @block and its
        exchanges) then the segment program of the block's length, the
        remainder block with samplesblock = its length.  x [nf, nch, T]
        on the device; carry ((svec [nf, n], rings {region: [nf, mod]}),
        bvars [nf, n_vars], bmem [nf, total_mem]) f64, updated in place;
        rand [T, n_rand] and the MIDI planes (events [rows, K, 4] on the
        device, counts [rows] on the host) shared by every file.  Returns
        (y f32 [nf, nch, T], carry, the MIDI out tables [rows, nf, cells]
        or None).  Nothing in the loop waits for the device unless @block
        rewrites a cursor the host mirrors.  `step` as `k5_step_mode` takes
        it: K5 (`_coupled_steps`) or the eager blocks of `_CoupledSteps`."""
        if self._step_mode(step) != "eager":
            return self._coupled_steps(carry, x, rand)
        steps = _CoupledSteps(self, carry, x, rand, midi_planes)
        for b in range(steps.n_rows):
            steps.step(b)
        return steps.result()

    def _hop_spans(self, T: int, phase: int) -> List[Tuple[int, bool]]:
        """A hop render's spans of T samples from the counter's phase:
        (length, whether the hop fires at its end): a lead segment up to
        the counter's wrap, full hops of H, then a tail."""
        H, B = self._hop_len, self.B
        lead = (H - phase) % H
        if lead % B and self.ctrl_order:
            raise SpecializeError(
                "resumed hop phase misaligned with the control-block grid")
        if T < lead:
            # the render ends inside the lead: the counter never wraps
            return [(T, False)]
        # T == lead takes the whole lead, so the hop fires at its end (the
        # golden runs the hop body inside that sample)
        nfull = (T - lead) // H
        tail = T - lead - nfull * H
        return ([(lead, True)] if lead else []) + [(H, True)] * nfull \
            + ([(tail, False)] if tail else [])

    def _hop_run(self, carry, x, ctrl, rand, phase: int, step=None):
        """The fused sample/hop pipeline over a batch of files, a host loop
        (the reference's `_hop_run` scans it): a lead segment up to the hop
        counter's wrap, full segments of H samples, each followed by one
        K10 launch of the hop section (the sample state into its heap, the
        section, the heap back), then a tail.  phase is the counter's value
        entering the render.  x [nf, nch, T] on the device; carry ((svec
        [nf, n], rings {region: [nf, mod]}), hvars [nf, n_vars], hmem [nf,
        total_mem]) f64, updated in place; ctrl and rand shared by every
        file.  Returns (y f32 [nf, nch, T], carry).  `step` as
        `k5_step_mode` takes it: K5 (`_hop_steps`) or the eager loop
        below."""
        import torch

        from ..kernels.block_section import block_section

        if self._step_mode(step) != "eager":
            return self._hop_steps(carry, x, ctrl, rand, phase)
        B = self.B
        prog = self._hop_prog
        (svec, rings), hvars, hmem = carry
        nf, _nch, T = x.shape
        spans = self._hop_spans(T, phase)
        # the one device-to-host read of a render: the scalars it starts
        # from, which every file must agree on where the host mirrors them
        known = _shared_known(svec.tolist(), self.mirrored_slots(),
                              self.carried_vars)
        cells = [a for a, _addr in prog.cells]
        draws = self._draws_of(rand)
        f64 = torch.float64
        y = torch.empty((nf, self.nch, T), dtype=torch.float32,
                        device=self.device)
        t0 = r0 = 0
        for n, fires in spans:
            rows = -(-n // B)
            (svec, rings), yseg, known = self._seg_fn(n, nf)(
                (svec, rings), (x[:, :, t0:t0 + n].to(f64), ctrl[r0:r0 + rows],
                                draws(t0, t0 + n)), known)
            y[:, :, t0:t0 + n] = yseg
            if fires:
                block_section(prog, svec, [rings[r] for r in prog.regions],
                              hvars, hmem, float(B))
                # the section may rewrite the carried cells; none is
                # mirrored (checked at build), so the device holds them
                for i in cells:
                    known[i] = None
            t0 += n
            r0 += rows
        return y, ((svec, rings), hvars, hmem)

    def _hop_steps(self, carry, x, ctrl, rand, phase: int):
        """`_hop_run` through K5: each span a step on the static carry,
        K10's view included: its segment, then, where the hop fires, K10
        on the hop section (a full hop's step is the reference's scan body,
        zorak_tpu/lowering/specialize.py:2976).  A span's key is its kind,
        length, files, pool, the cursors that shape its segment and the
        hop counter's phase at its start, so every full hop shares one
        capture.  The host mirror after a hop is `_hop_run`'s: the carried
        heap cells K10 may rewrite are voided (no mirrored slot is one,
        checked at build)."""
        import torch

        from ..kernels.block_section import block_section

        f64 = torch.float64
        k5 = self._k5_graphs()
        capture = self.device.type == "cuda"
        H, B = self._hop_len, self.B
        prog = self._hop_prog
        (svec0, rings0), hvars0, hmem0 = carry
        nf, nch, T = x.shape
        spans = self._hop_spans(T, phase)
        known = self._mirror_start(svec0)
        svec, rings = self._k5_carry(k5, nf, svec0, rings0)
        hvars = k5.static("bvars", hvars0.shape, f64)
        hvars.copy_(hvars0)
        hmem = k5.static("bmem", hmem0.shape, f64)
        hmem.copy_(hmem0)
        pool = self._k5_pool(k5, rand)
        nc = ctrl.shape[1]
        nr = 0 if pool is not None else rand.shape[1]
        cells = [a for a, _addr in prog.cells]
        y = torch.empty((nf, self.nch, T), dtype=torch.float32,
                        device=self.device)
        t0 = r0 = 0
        at = phase
        for n, fires in spans:
            rows = -(-n // B)
            xin = k5.static("x", (nf, nch, n), torch.float32)
            yout = k5.static("y", (nf, self.nch, n), torch.float32)
            aux = k5.static("aux", (rows * nc + n * nr,), f64)
            seg = self._seg_fn(n, nf, graph=True)
            ctrl_v = aux[:rows * nc].view(rows, nc)
            draws = pool if pool is not None else \
                aux[rows * nc:].view(n, nr)

            def body(seg=seg, xin=xin, yout=yout, ctrl_v=ctrl_v,
                     draws=draws, kn=known, fires=fires):
                (sv, rg), yseg, _ = seg((svec, rings),
                                        (xin.to(f64), ctrl_v, draws), kn)
                self._k5_store(svec, rings, sv, rg)
                if fires:
                    block_section(prog, svec,
                                  [rings[r] for r in prog.regions], hvars,
                                  hmem, float(B))
                yout.copy_(yseg)

            def key(seg=seg, n=n, kn=known, fires=fires, at=at):
                got = self._k5_key("hop" if fires else "seg", seg, n, nf,
                                   pool, kn)
                return None if got is None else got + (at,)

            with _k5_range():
                xin.copy_(x[:, :, t0:t0 + n])
                if nc:
                    aux[:rows * nc].copy_(ctrl[r0:r0 + rows].reshape(-1))
                if nr:
                    aux[rows * nc:].copy_(rand[t0:t0 + n].reshape(-1))
                k5.step(key, body, capture)
                y[:, :, t0:t0 + n].copy_(yout)
            known = self._advance_mirror(known, n)
            if fires:
                for i in cells:
                    known[i] = None
            t0 += n
            r0 += rows
            at = (at + n) % H
        self._k5_mirror = known
        return y, ((svec.clone(), {r: a.clone() for r, a in rings.items()}),
                   hvars.clone(), hmem.clone())

    @property
    def accepts_midi(self) -> bool:
        """True when host MIDI events can reach @block: staged per-block
        device planes in the coupled regime, or the host-interpreted
        control trajectory in the uncoupled one."""
        if self.coupled:
            return bool(self._block_prog.uses_midi_in)
        return bool(self.has_block and self._block_has_midi)

    def _midi_planes(self, midi, T: int):
        """[(offset,b1,b2,b3)] at engine rate -> per-block planes
        (ev f64[rows, K, 4] with in-block offsets, n f64[rows])."""
        B = self.B
        rows = T // B + (1 if T % B else 0)
        per: List[List[Tuple[float, float, float, float]]] = \
            [[] for _ in range(rows)]
        for ev in sorted(midi or [], key=lambda e: e[0]):
            off = max(0, min(int(ev[0]), T - 1))
            per[off // B].append((float(off - (off // B) * B),
                                  float(int(ev[1]) & 0xFF),
                                  float(int(ev[2]) & 0xFF),
                                  float(int(ev[3]) & 0xFF)))
        K = max(1, max((len(p) for p in per), default=1))
        mev = np.zeros((rows, K, 4), dtype=np.float64)
        mn = np.zeros((rows,), dtype=np.float64)
        for b, evs in enumerate(per):
            mn[b] = len(evs)
            for k, e in enumerate(evs):
                mev[b, k] = e
        return mev, mn

    def _decode_midi_out(self, mo: np.ndarray):
        """Staged per-block OUT tables [rows, cells] -> [(abs_offset, b1,
        b2, b3)]."""
        from .devgen import MIDI_OUT_CAP

        events = []
        for b in range(mo.shape[0]):
            n = int(mo[b, 0])
            for k in range(min(n, MIDI_OUT_CAP)):
                ofs, b1, b2, b3 = mo[b, 1 + 4 * k: 5 + 4 * k]
                events.append((b * self.B + int(ofs), int(b1), int(b2),
                               int(b3)))
        return events

    def loop_overflow(self, carry) -> float:
        """The guessed loop(n) bounds' overflow monitor in a render's final
        carry, the largest of its files': how far a realised count passed
        the bound K, <= 0 where every count fit.  One device read."""
        c0 = carry[0]
        svec = c0[0] if isinstance(c0, tuple) else c0
        return float(svec[..., self.scalar_index[("mloop", "ovf")]].max())

    def with_larger_loop_bound(self, ovf: float):
        """This kernel rebuilt from its snapshot on the same device, with
        K doubled past the realised count K + ovf: the ladder's step, for
        the solo and the batch render."""
        old_k = self.masked_loop_k
        new_k = 1 << max(1, int(old_k + ovf - 1).bit_length())
        print(f"[specialize] masked-loop bound {old_k} exceeded by "
              f"{ovf:.0f}; rebuilding with K={new_k} and replaying",
              file=sys.stderr, flush=True)
        return specialize_sample_kernel(
            self.P, self.snap, self.nch, segment_len=self.L,
            block_size=self.B, masked_loop_k=new_k, device=self.device)

    def render_device(self, x, carry=None, midi=None, ctrl=None):
        """x: float32 [nch, T], a numpy array or a tensor.  Returns
        (y float32 tensor [nch, T] on the kernel's device, carry).

        midi: optional [(offset, b1, b2, b3)] at the kernel's rate, only
        when accepts_midi.  The output stays on the device; `render`
        brings it to the host.

        ctrl: optional precomputed control matrix from an external
        trajectory_stepper pass; the stepper's finish() already recorded
        last_control_state/_traj_midi_out.

        A kernel with guessed data-dependent loop(n) bounds
        (sym.masked_loops) renders behind the overflow ladder: it reads
        the carried overflow monitor after the render (one device read,
        only on such kernels), and where a sample's realised count passed
        the bound K, rebuilds with K doubled past it on the same device
        and replays with the generator state, the hop phase and the
        trajectory state it started from.

        On the card the steps go through K5 (`kernels/segment_graph.py`)
        wherever the plan allows it; `dispatch` says how they ran.
        """
        return self._render_device_as(None, x, carry, midi, ctrl)

    def _render_device_as(self, step, x, carry=None, midi=None, ctrl=None):
        """`render_device` with its steps run as `step` says
        (`k5_step_mode`): None as render_device, "eager" the eager step
        (chip_smoke.py's yardstick for K5), "graph" K5's step."""
        if not self.sym.masked_loops:
            return self._render_device_once(x, carry, midi, ctrl, step)
        T = x.shape[1]
        fresh = carry is None
        if ctrl is None and self.has_block and not self.coupled:
            # the host trajectory runs once: a replay must not advance the
            # trajectory's state again or re-run @block
            nfb = T // self.B
            self._traj_midi_out = []
            if midi or not fresh:
                ctrl = self.control_trajectory(nfb, T - nfb * self.B,
                                               midi=midi, resume=not fresh)
            else:
                ctrl = self.cached_trajectory(nfb, T - nfb * self.B)
        rng_save = (self._rng_state, self._rng_prestate)
        hop_save = self._hop_phase if self._hop is not None else None
        for _attempt in range(LADDER_ATTEMPTS):
            out = self._render_device_once(x, carry, midi, ctrl, step)
            ovf = self.loop_overflow(out[1])
            if ovf <= 0.0:
                return out
            traj_save = (self.last_control_state, self._traj_midi_out,
                         self.last_midi_out, self._traj_plugin)
            carry0 = self._carry0
            bigger = self.with_larger_loop_bound(ovf)
            same_carry = (bigger.carried_vars == self.carried_vars
                          and bigger.carry_regions == self.carry_regions)
            self.__dict__.update(bigger.__dict__)
            if same_carry:
                # fresh renders keep starting from the planned state
                self._carry0 = carry0
            self._rng_state, self._rng_prestate = rng_save
            if hop_save is not None:
                self._hop_phase = hop_save
            (self.last_control_state, self._traj_midi_out,
             self.last_midi_out, self._traj_plugin) = traj_save
        raise SpecializeError("masked-loop overflow ladder did not "
                              "converge")

    def _render_device_once(self, x, carry, midi, ctrl, step=None):
        """One render, `_render_device_as` without the ladder."""
        import torch

        nch, T = x.shape
        assert nch == self.nch
        fresh = carry is None
        if fresh:
            # every fresh render starts from the state the kernel was
            # planned on: the snapshot may since have taken a render's
            # writeback, so the first initial carry is kept as a master
            if self._carry0 is None:
                self._carry0 = self.device_carry(self.initial_carry())
            carry = self._carry0
            if self._hop is not None:
                self._hop_phase = self._hop_phase0
        carry = self.device_carry(carry)
        if not fresh and self.rand_gated:
            # a resumed render draws from a new pool: the generator
            # advances by the draws the last pool gave (one device read),
            # and the carried count starts again at the new pool's head
            svec = carry[0][0] if self.has_device_view else carry[0]
            slot = self.scalar_index[("rand", "used")]
            self._advance_rng_by_used(int(svec[slot].item()))
            svec[slot] = 0.0
        if self.coupled:
            return self._render_coupled(x, carry, fresh, midi, ctrl, step)
        L = self.segment_length(T)
        if ctrl is None:
            self._traj_midi_out = []
            if self.has_block and (midi or not fresh):
                n_full_blocks = T // self.B
                ctrl = self.control_trajectory(
                    n_full_blocks, T - n_full_blocks * self.B, midi=midi,
                    resume=not fresh)
            else:
                ctrl = self.fresh_control(T)
        rand = self._render_draws(T, fresh)
        self.last_midi_out = list(self._traj_midi_out)
        if midi and not self.accepts_midi:
            raise SpecializeError(
                "MIDI events supplied but this kernel has no @block "
                "midirecv path")

        if T == 0:
            return torch.zeros((nch, 0), dtype=torch.float32,
                               device=self.device), carry
        if self._hop is not None:
            # the counter's phase advances by T, and the next resumed
            # render segments from there
            phase = self._hop_phase
            self._hop_phase = (phase + T) % self._hop_len
            (svec, rings), hvars, hmem = carry
            y, ((svec, rings), hvars, hmem) = self._hop_run(
                ((svec[None], {r: a[None] for r, a in rings.items()}),
                 hvars[None], hmem[None]),
                self.put_audio(x)[None], self.put_f64(ctrl), rand, phase,
                step)
            return y[0], ((svec[0], {r: a[0] for r, a in rings.items()}),
                          hvars[0], hmem[0])
        # the solo render is the batch of one file
        svec, rings = carry
        y, (svec, rings) = self._run(
            (svec[None], {r: a[None] for r, a in rings.items()}),
            self.put_audio(x)[None], self.put_f64(ctrl), rand, L, step)
        return y[0], (svec[0], {r: a[0] for r, a in rings.items()})

    def _render_coupled(self, x, carry, fresh: bool, midi, ctrl,
                        step=None):
        """render_device's coupled branch: the solo render is the batch of
        one file through `_coupled_run`."""
        import torch

        if ctrl is not None:
            raise SpecializeError("a precomputed control matrix is the "
                                  "uncoupled path's")
        if midi and not self.accepts_midi:
            raise SpecializeError(
                "MIDI events supplied but this kernel has no @block "
                "midirecv path")
        nch, T = x.shape
        self._traj_midi_out = []
        self.last_midi_out = []
        rand = self._render_draws(T, fresh)
        if T == 0:
            return torch.zeros((nch, 0), dtype=torch.float32,
                               device=self.device), carry
        planes = None
        if self.accepts_midi:
            mev, mn = self._midi_planes(midi, T)
            planes = (self.put_f64(mev), mn)
        (svec, rings), bvars, bmem = carry
        y, ((svec, rings), bvars, bmem), mouts = self._coupled_run(
            ((svec[None], {r: a[None] for r, a in rings.items()}),
             bvars[None], bmem[None]),
            self.put_audio(x)[None], rand, planes, step)
        if mouts is not None:
            self.last_midi_out = self._decode_midi_out(
                mouts[:, 0].cpu().numpy())
        return y[0], ((svec[0], {r: a[0] for r, a in rings.items()}),
                      bvars[0], bmem[0])

    def segment_length(self, T: int) -> int:
        """The segment length of a render of T samples: the kernel's,
        or T cut to whole blocks where that is shorter."""
        return min(self.L, max(self.B, (T // self.B) * self.B)) if T \
            else self.L

    def put_audio(self, x):
        """Audio (a numpy array, f32, or a tensor) on the kernel's device
        in the type it has: f32 audio crosses at half the bytes, and each
        segment goes to f64 on the device as it runs."""
        import torch

        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(self.device)

    def put_f64(self, a):
        """A numpy array or tensor as f64 on the kernel's device."""
        import torch

        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device).to(torch.float64)

    def fresh_control(self, T: int) -> np.ndarray:
        """The control matrix of a fresh render of T samples with no MIDI:
        the @block trajectory from the planned state (memoized by
        length), or the empty trajectory of a plugin without @block."""
        n_full_blocks = T // self.B
        rem_block = T - n_full_blocks * self.B
        if self.has_block:
            return self.cached_trajectory(n_full_blocks, rem_block)
        rows = n_full_blocks + (1 if rem_block else 0)
        return np.zeros((rows, len(self.ctrl_order)), dtype=np.float64)

    def _render_draws(self, T: int, fresh: bool):
        """The draw matrix of a render of T samples, f64 on the kernel's
        device (`_rand_streams`).  A fresh ungated render's is kept by T,
        for at most RAND_CACHE_LENGTHS lengths, with the generator state
        after it: a hit leaves `_rng_state` as the miss did.  No render
        writes into the matrix it is given."""
        if not (self.n_rand and fresh and not self.rand_gated):
            return self.put_f64(self._rand_streams(T, reset=fresh))
        hit = self._rand_cache.get(T)
        if hit is not None:
            rand, self._rng_state = hit
            return rand
        rand = self.put_f64(self._rand_streams(T, reset=True))
        if len(self._rand_cache) < RAND_CACHE_LENGTHS:
            self._rand_cache[T] = (rand, self._rng_state)
        return rand

    def _rand_streams(self, T: int, reset: bool) -> np.ndarray:
        """Pregenerate the exact MT19937 draw matrix [T, n_rand] (f64 u32
        values), continuing the per-instance generator state.  In the gated
        regime the matrix is a flat pool that bounds what a render draws;
        the generator's state after the render follows from the carried
        consumed-draw count (`_advance_rng_by_used`)."""
        if self.n_rand == 0:
            return np.zeros((T, 0), dtype=np.float64)
        from ..semantics import mt19937np as MT

        if reset or self._rng_state is None:
            self._rng_state = MT.eelrng_state_tuple(self.snap.rng)
        if self.rand_gated:
            # keep the pre-pool state: only `used` of these draws are real
            self._rng_prestate = self._rng_state
            draws, _ = MT.generate(T * self.n_rand, self._rng_state)
        else:
            draws, self._rng_state = MT.generate(T * self.n_rand,
                                                 self._rng_state)
        return draws.astype(np.float64).reshape(T, self.n_rand)

    def _rng_after(self, used: int):
        """The generator state after a gated render drew `used` of its
        pool."""
        from ..semantics import mt19937np as MT

        if self._rng_prestate is None:
            self._rng_prestate = MT.eelrng_state_tuple(self.snap.rng)
        if used > 0:
            return MT.generate(int(used), self._rng_prestate)[1]
        return self._rng_prestate

    def _advance_rng_by_used(self, used: int) -> None:
        """Fix up the generator state after a gated render consumed `used`
        draws of the pregenerated pool."""
        self._rng_state = self._rng_after(used)

    def render(self, x, carry=None, midi=None, ctrl=None):
        """x: float32 [nch, T].  Returns (y float32 np [nch, T], final_carry)."""
        y_dev, carry = self.render_device(x, carry, midi=midi, ctrl=ctrl)
        return y_dev.cpu().numpy(), carry

    def writeback(self, carry, state, sync_gmem: bool = True) -> None:
        """Flush final carry into a ShadowState (for state parity checks).
        sync_gmem=False leaves gmem alone: a graph's lockstep owns the
        shared segment, and a member's heap window is not it."""
        if self.n_rand and self._rng_state is not None:
            from ..semantics import mt19937np as MT

            rng_state = self._rng_state
            if self.rand_gated:
                svec0 = carry[0][0] if self.has_device_view else carry[0]
                rng_state = self._rng_after(
                    int(svec0[self.scalar_index[("rand", "used")]]))
            MT.restore_eelrng(state.rng, rng_state)
        if self.last_control_state is not None:
            ts = self.last_control_state
            state.V.update(ts.V)
            state.sliders = list(ts.sliders)
            state.srate = ts.srate
            state.samplesblock = ts.samplesblock
            state.rng.restore(ts.rng.snapshot())
            state.pending_change_mask = ts.pending_change_mask
            state.pending_automate_mask = ts.pending_automate_mask
            state.pending_automate_end_mask = ts.pending_automate_end_mask
            # @block-owned mem evolves on the host trajectory (incl. the
            # settle-baked view the kernel snapshot adopted); flush it —
            # @sample-owned regions are overlaid by rings/cells below
            if ts.mem_used:
                state.mem_ensure(ts.mem_used)
                state.mem[:ts.mem_used] = np.asarray(
                    ts.mem[:ts.mem_used], dtype=np.float64)
        if self.has_device_view:
            (svec, rings), bvars, bmem = carry
            self._writeback_device_view(bvars, bmem, state, sync_gmem)
        else:
            svec, rings = carry
        svec_np = np.asarray(svec.cpu() if hasattr(svec, "cpu") else svec)
        for key in self.carried_vars:
            v = float(svec_np[self.scalar_index[key]])
            kind = key[0]
            if kind == "spl":
                state.spl[key[1]] = v
            elif kind == "slider":
                state.sliders[key[1]] = v
            elif kind == "var":
                state.V[key[1]] = v
            elif kind == "mem":
                state.mem_ensure(key[1] + 1)
                state.mem[key[1]] = v
            elif kind == "builtin":
                setattr(state, key[1], v)
        for region, arr in rings.items():
            origin, mod = region
            state.mem_ensure(origin + mod)
            state.mem[origin:origin + mod] = np.asarray(
                arr.cpu() if hasattr(arr, "cpu") else arr)

    def _writeback_device_view(self, bvars, bmem, state,
                               sync_gmem: bool = True) -> None:
        """The device section's heap and var slots (the coupled @block's or
        the hop section's) -> the state (the sample-carried values,
        written after, are newer); the heap's gmem window -> the state's
        gmem where sync_gmem, a changed span bumping the attached
        segment's page sequence numbers once (the reference's coarse
        attribution)."""
        from .devgen import MIDI_POS_SLOT, PENDING_SLOT_NAMES, RAND_POS_SLOT

        devsec = self._devblock if self.coupled else self._hop

        def to_host(a):
            return np.asarray(a.cpu() if hasattr(a, "cpu") else a)
        # the heap's head alone crosses to the host (a window of a
        # million cells need not, where the graph owns the segment)
        bm = to_host(bmem[:devsec.mem_size])
        if devsec.uses_gmem and sync_gmem:
            gm = to_host(bmem[devsec.gmem_base:
                           devsec.gmem_base + devsec.gmem_cells])
            old = np.asarray(state.gmem, dtype=np.float64)
            n = min(len(old), len(gm))
            changed = np.nonzero(old[:n] != gm[:n])[0]
            state.gmem[:n] = gm[:n]
            host = getattr(state, "host", None)
            seg = getattr(host, "attached_gmem", None)
            if seg is not None and changed.size:
                seg.bump(int(changed.min()), int(changed.max()),
                         getattr(host, "instance_id_int", 0))
        state.mem_ensure(len(bm))
        state.mem[:len(bm)] = bm
        bv = np.asarray(bvars.cpu() if hasattr(bvars, "cpu") else bvars)
        masks = ("pending_change_mask", "pending_automate_mask",
                 "pending_automate_end_mask")
        for key, slot in devsec.slots.items():
            if key in self.scalar_index or key[0] == "param":
                continue
            if key[0] == "var" and key[1] in PENDING_SLOT_NAMES:
                setattr(state, masks[PENDING_SLOT_NAMES.index(key[1])],
                        int(max(0.0, float(bv[slot]))))
                continue
            if key[0] == "var" and key[1] in (MIDI_POS_SLOT, RAND_POS_SLOT):
                continue
            v = float(bv[slot])
            if key[0] == "var":
                state.V[key[1]] = v
            elif key[0] == "spl":
                state.spl[key[1]] = v
            elif key[0] == "slider":
                state.sliders[key[1]] = v


def specialize_sample_kernel(program: PluginProgram, snapshot, nch: int,
                             segment_len: int = 1 << 17,
                             block_size: int = 512,
                             masked_loop_k: Optional[int] = None,
                             device=None) -> SpecializedSampleKernel:
    # time-blocked scans: ring-ring delay cycles break when the segment
    # shrinks below the minimum cross-ring coupling delay — each retry
    # strictly shrinks L, so this terminates
    for _ in range(12):
        try:
            return SpecializedSampleKernel(program, snapshot, nch,
                                           segment_len,
                                           block_size=block_size,
                                           masked_loop_k=masked_loop_k,
                                           device=device)
        except _SegmentRetry as r:
            segment_len = r.segment_len
    raise SpecializeError("segment-shrink retry did not converge")

class _TrajStepper:
    """One block of host @block/@slider interpretation per step() call.

    Produced by SpecializedSampleKernel.trajectory_stepper; a graph
    scheduler drives several instances' steppers in lockstep (one
    CommWorld, host processing order) so message/gmem exchanges between
    instances happen exactly as in the all-shadow graph, then each
    kernel's device render consumes the assembled control matrix."""

    def __init__(self, kern, plug, ev_sorted, has_midi: bool):
        self.kern = kern
        self.plug = plug
        self.ev = ev_sorted
        self.has_midi = has_midi
        self.st = plug.state
        self.rows: List[np.ndarray] = []
        self.midi_out: List[Tuple] = []
        self.b = 0

    @property
    def state(self):
        return self.st

    def step(self, nb: int) -> np.ndarray:
        from ..shadow.state import MidiEvent

        kern, st = self.kern, self.st
        if self.has_midi:
            start = self.b * kern.B
            st.midi_in = [
                MidiEvent(int(e[0] - start), int(e[1]) & 0xFF,
                          int(e[2]) & 0xFF, int(e[3]) & 0xFF)
                for e in self.ev if start <= e[0] < start + nb]
            st.midi_in_pos = 0
        st.samplesblock = float(nb)
        self.plug.run_block()
        if (st.pending_change_mask or st.pending_automate_mask
                or st.pending_automate_end_mask):
            self.plug.run_slider()
            st.pending_change_mask = 0
            st.pending_automate_mask = 0
            st.pending_automate_end_mask = 0
        for ev in st.midi_out:
            # variable-length events (sysex / midisend_buf family) ride
            # as 5-tuples carrying the full byte string; short events
            # stay 4-tuples (the common case, and the device OUT-plane
            # format)
            et = (self.b * kern.B + int(ev.offset), int(ev.b1),
                  int(ev.b2), int(ev.b3))
            if ev.data is not None:
                et += (tuple(int(v) & 0xFF for v in ev.data),)
            self.midi_out.append(et)
        st.midi_out = []
        row = np.array([kern._key_value(st, key)
                        for key in kern.ctrl_order], dtype=np.float64)
        self.rows.append(row)
        self.b += 1
        return row

    def finish(self) -> np.ndarray:
        kern = self.kern
        kern.last_control_state = self.st
        kern._traj_midi_out = self.midi_out
        if not self.rows:
            return np.zeros((0, len(kern.ctrl_order)), dtype=np.float64)
        return np.stack(self.rows)


class _CoupledSteps:
    """The fused block/sample pipeline of one render, a block at a time:
    one K10 launch (the device @block and its exchanges, with a graph's
    staging where given) then the segment program of the block's length,
    the remainder block with samplesblock = its length.  `_coupled_run`'s
    eager step steps its blocks in order (K5's step is `_coupled_steps`);
    a graph's eager lockstep (`lockstep_gmem_run`) steps its members'
    blocks in turn (K5's graph block is `_lockstep_graph_blocks`).

    x [nf, nch, T] on the device; carry ((svec [nf, n], rings {region:
    [nf, mod]}), bvars [nf, n_vars], bmem [nf, total_mem]) f64, updated in
    place; rand [T, n_rand] and the MIDI planes (events [rows, K, 4] on the
    device, counts [rows] on the host) shared by every file.  Nothing
    waits for the device unless @block rewrites a cursor the host
    mirrors."""

    def __init__(self, kern, carry, x, rand, midi_planes=None):
        import torch

        self.kern, self.x, self.midi_planes = kern, x, midi_planes
        prog = kern._block_prog
        (self.svec, self.rings), self.bvars, self.bmem = carry
        self.nf, _nch, T = x.shape
        B = kern.B
        self.nfull, self.rem = T // B, T % B
        self.n_rows = self.nfull + (1 if self.rem else 0)
        f64 = torch.float64
        # the one device-to-host read of a render: the scalars it starts
        # from, which every file must agree on where the host mirrors them
        self.known = _shared_known(self.svec.tolist(), kern.mirrored_slots(),
                                   kern.carried_vars)
        self.y = torch.empty((self.nf, kern.nch, T), dtype=torch.float32,
                             device=kern.device)
        self.ctrl = torch.empty((self.n_rows, self.nf, len(kern.ctrl_order)),
                                dtype=f64, device=kern.device)
        self.mouts = torch.empty(
            (self.n_rows, self.nf, prog.midi_out_cells), dtype=f64,
            device=kern.device) if prog.midi_out_cells else None
        self.draws = kern._draws_of(rand)

    def step(self, b: int, stage=None) -> None:
        """Block b: K10 (with `stage`, a lockstep member's share of the
        graph), then the block's segment."""
        import torch

        from ..kernels.block_section import block_section

        kern, prog = self.kern, self.kern._block_prog
        L = kern.B if b < self.nfull else self.rem
        t0 = b * kern.B
        midi = None if self.midi_planes is None else \
            (self.midi_planes[0][b], float(self.midi_planes[1][b]))
        block_section(prog, self.svec, [self.rings[r] for r in prog.regions],
                      self.bvars, self.bmem, float(L), midi,
                      ctrl=self.ctrl[b],
                      mout=None if self.mouts is None else self.mouts[b],
                      stage=stage)
        for i in kern._block_rewrites:
            self.known[i] = None
        (self.svec, self.rings), yseg, self.known = kern._seg_fn(L, self.nf)(
            (self.svec, self.rings),
            (self.x[:, :, t0:t0 + L].to(torch.float64), self.ctrl[b][:, None],
             self.draws(t0, t0 + L)), self.known)
        self.y[:, :, t0:t0 + L] = yseg

    def result(self):
        """(y f32 [nf, nch, T], carry, the MIDI out tables [rows, nf,
        cells] or None)."""
        return self.y, ((self.svec, self.rings), self.bvars, self.bmem), \
            self.mouts


class _K5Block:
    """One kernel's part of a K5 coupled block step: a render's own
    (`_coupled_steps`) or a member's share of a lockstep's graph block
    (`_lockstep_graph_blocks`).

    Loads, once a render, the kernel's static carry, K10's view and
    control row and its gated pool under `bufs`' names (a StepGraphs, or
    a lockstep member's `_MemberBuffers`), from `carry` ((svec [nf, n],
    rings {region: [nf, mod]}), bvars [nf, n_vars], bmem [nf, total_mem]):
    host arrays or tensors, copied straight into the static buffers.  Keeps
    the host mirror as `_coupled_steps` always has: `_mirror_start`, the
    slots @block rewrites voided before each block, `_advance_mirror`
    after it.  A block: `begin(L, draws)`, then `body` (K10 with `stage`,
    then the graph segment program of length L) inside the step and `key`
    its part of the capture key, then `end()`."""

    def __init__(self, kern, bufs, carry, rand, nf: int, stage=None):
        import torch

        f64 = torch.float64

        def t(a):
            return a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.asarray(a, dtype=np.float64))

        (svec0, rings0), bvars0, bmem0 = carry
        self.kern, self.nf, self.stage = kern, nf, stage
        self.svec, self.rings = kern._k5_carry(
            bufs, nf, t(svec0), {r: t(a) for r, a in rings0.items()})
        self.bvars = bufs.static("bvars", np.shape(bvars0), f64)
        self.bvars.copy_(t(bvars0))
        self.bmem = bufs.static("bmem", np.shape(bmem0), f64)
        self.bmem.copy_(t(bmem0))
        self.ctrl = bufs.static("ctrl", (nf, len(kern.ctrl_order)), f64)
        self.pool = kern._k5_pool(bufs, rand)
        # the render's draws [T, n_rand] on the device, and the draw rows a
        # sample a block takes where the gated pool does not draw
        self.rand = rand
        self.nr = 0 if self.pool is not None else rand.shape[1]
        self.known = kern._mirror_start(self.svec)
        self._rewrites = set(kern._block_rewrites)

    def begin(self, L: int, draws) -> None:
        """A block of L, its draw rows in `draws` [L, nr] (unused where
        the gated pool draws): the mirror with the slots K10 may rewrite
        voided, and the segment program."""
        self.L = L
        self.kn = [None if i in self._rewrites else v
                   for i, v in enumerate(self.known)]
        self.seg = self.kern._seg_fn(L, self.nf, graph=True)
        self.draws = self.pool if self.pool is not None else draws

    def body(self, xin, yout) -> None:
        """The block's program on the static buffers: K10 then the
        segment, reading xin [nf, nch, L] f32 and writing yout."""
        import torch

        from ..kernels.block_section import block_section

        kern, prog = self.kern, self.kern._block_prog
        block_section(prog, self.svec, [self.rings[r] for r in prog.regions],
                      self.bvars, self.bmem, float(self.L), None,
                      ctrl=self.ctrl, stage=self.stage)
        (sv, rg), yseg, _ = self.seg(
            (self.svec, self.rings),
            (xin.to(torch.float64), self.ctrl[:, None], self.draws), self.kn)
        kern._k5_store(self.svec, self.rings, sv, rg)
        yout.copy_(yseg)

    def key(self):
        return self.kern._k5_key("block", self.seg, self.L, self.nf,
                                 self.pool, self.kn)

    def end(self) -> None:
        self.known = self.kern._advance_mirror(self.kn, self.L)

    def result(self):
        """The carry cloned out of the static buffers, the mirror kept
        for the kernel."""
        self.kern._k5_mirror = self.known
        return ((self.svec.clone(), {r: a.clone()
                                     for r, a in self.rings.items()}),
                self.bvars.clone(), self.bmem.clone())


def k5_step_mode(kernels: Sequence["SpecializedSampleKernel"], step,
                 names: Optional[Sequence[str]] = None) -> Tuple[str, str]:
    """How the steps of a render of `kernels` run, and the dispatch that
    says so: one kernel's segments or blocks, or a graph's lockstep
    members' graph blocks (`names` their nodes).  ("graph", "graph"): K5,
    captured and replayed on the card; ("static", ...): K5's step on CPU
    tensors, uncaptured; ("eager", why).  K5 refuses where it refuses a
    kernel's plan (`k5_refusal`, decided at build; the first such member
    named).  step None: K5 wherever it may, the eager step on CPU
    tensors; "eager": the eager step (the yardstick); "graph": K5's step,
    or SpecializeError where a plan is refused."""
    if step == "eager":
        return "eager", "eager: the eager step, asked for"
    if step not in (None, "graph"):
        raise ValueError(f"step must be None, 'eager' or 'graph', not "
                         f"{step!r}")
    for j, k in enumerate(kernels):
        if k.k5_refusal is not None:
            why = k.k5_refusal if names is None else \
                f"node {names[j]}: {k.k5_refusal}"
            if step == "graph":
                raise SpecializeError(f"K5 refuses this plan: {why}")
            return "eager", f"eager: {why}"
    if kernels and kernels[0].device.type == "cuda":
        return "graph", "graph"
    if step == "graph":
        return "static", "static: K5's step on CPU tensors, uncaptured"
    return "eager", "eager: CPU tensors take the eager step"


def _lockstep_bus0(msg, m0, n_bus: int):
    """The bus as a render starts it, in NumPy f64: the ring window [W,
    WINDOW_ENT] with the pending rows first, and its control row."""
    from ..kernels.block_section import CTL_CURSORS, WINDOW_ENT

    marr0, mn0, mc0 = m0
    window = np.zeros((int(msg.W), WINDOW_ENT), dtype=np.float64)
    window[:len(marr0)] = np.asarray(marr0, dtype=np.float64)
    ctl = np.array([float(mn0), 0.0, 0.0] + [float(c) for c in mc0],
                   dtype=np.float64)
    assert ctl.shape[0] == CTL_CURSORS + n_bus
    return window, ctl


def _lockstep_stages(seg_ids, segs, window, ctl, subs, bus, msg):
    """Each member's `Stage` (None where it shares nothing): its shared
    segment, and where it uses the bus the window, its control row, the
    member's cursor, whether it compacts (the first bus member), its
    subscriptions and its instance id."""
    from ..kernels.block_section import Stage

    cursor_of = {j: c for c, j in enumerate(bus)}
    stages = []
    for j, sid in enumerate(seg_ids):
        seg = segs[sid] if sid >= 0 else None
        if j in cursor_of:
            stages.append(Stage(seg, window, ctl, cursor_of[j], j == bus[0],
                                subs[j], float(msg.my_ids[j])))
        else:
            stages.append(None if seg is None else Stage(gseg=seg))
    return stages


def lockstep_gmem_run(kernels: Sequence[SpecializedSampleKernel],
                      seg_ids: Sequence[int], carries, xs, rands, planes, g0,
                      msg=None, m0=None, step=None, graphs=None,
                      names: Optional[Sequence[str]] = None):
    """The joint render of a graph's lockstep members (the reference's
    `lockstep_gmem_run`, its specialize.py:5522).

    The all-shadow graph gives gmem sequential same-block visibility:
    every member's gmem is the shared segment, so in host processing order
    member i's @block sees member j < i's writes of the same block and j >
    i's of the block before.  This renders that schedule with one loop over
    blocks: in each, every member's K10 launch and segment in node order,
    on one stream, each K10 reading and writing its shared segment in
    place.  kernels: coupled kernels in node order, one block size;
    seg_ids: each member's shared segment (-1: none, its gmem is its own
    heap window).

    msg: SimpleNamespace(W, nc, my_ids, sub_masks) where a member uses the
    bus.  The members then share a ring window of W rows [sender, bc, dest,
    chan_id, tag, a, b, c, d], its count, a cursor a bus member and an
    overflow counter (`block_section.Stage`): K10's prologue routes a
    member's matched entries past its cursor into its queues and its
    epilogue publishes its OUT table; the block's first bus member first
    drops the entries every member has seen, so W bounds two blocks of
    traffic and the graph refuses a render that overflowed it.

    step as `k5_step_mode` takes it: K5's graph blocks
    (`_lockstep_graph_blocks`, on `graphs`, the lockstep's StepGraphs the
    caller keeps across renders; a new one where None) or the eager loop
    of `_CoupledSteps`; names: the members' node names, for the dispatch.

    carries as `initial_carry()` gives them, xs f32 [nch, T], rands [T,
    n_rand], planes each member's MIDI planes or None, g0 each shared
    segment's cells, m0 (rows [n, 9], n, the bus members' cursors) where
    the bus is on.  Returns (ys, carries, gfin, mos, msg_fin, dispatch):
    per-member f32 outputs [nch, T] and final carries, the segments, the
    MIDI out tables [rows, cells] (None where a member sends none), (window,
    ctl) tensors where the bus is on (see `block_section.CTL_*`), and how
    the blocks ran (`k5_step_mode`).  Everything stays on the
    members' device."""
    import torch

    from ..kernels import _build

    if not kernels:
        raise SpecializeError("a lockstep needs a member")
    B = kernels[0].B
    if any(k.B != B for k in kernels):
        raise SpecializeError("gmem lockstep needs one shared block size")
    if any(not k.coupled for k in kernels):
        raise SpecializeError("a lockstep member needs a coupled @block")
    mode, dispatch = k5_step_mode(kernels, step, names)
    dev = kernels[0].device
    bus = [j for j, k in enumerate(kernels) if k._block_prog.uses_msg]
    if bus and msg is None:
        raise SpecializeError("members use the bus: msg is needed")
    bus0 = _lockstep_bus0(msg, m0, len(bus)) if bus else None
    if dev.type == "cuda":
        # one nvcc a member's K10, all started together
        _build.build_generated([k._block_prog.source for k in kernels])
    if mode != "eager":
        from ..kernels.segment_graph import StepGraphs

        k5 = graphs if graphs is not None else StepGraphs(dev)
        return _lockstep_graph_blocks(kernels, seg_ids, carries, xs, rands,
                                      g0, msg, bus, bus0, k5,
                                      mode == "graph") + (dispatch,)
    # copies: the host's segments stay as they were until the end
    segs = [torch.from_numpy(np.array(g, dtype=np.float64)).to(dev)
            for g in g0]
    window = ctl = None
    subs = {}
    if bus:
        window, ctl = (torch.from_numpy(a).to(dev) for a in bus0)
        subs = {j: torch.as_tensor(np.asarray(msg.sub_masks[j],
                                              dtype=np.float64)).to(dev)
                for j in bus}
    stages = _lockstep_stages(seg_ids, segs, window, ctl, subs, bus, msg)
    steps = []
    for j, k in enumerate(kernels):
        (svec, rings), bvars, bmem = k.device_carry(carries[j])
        steps.append(_CoupledSteps(
            k, ((svec[None], {r: a[None] for r, a in rings.items()}),
                bvars[None], bmem[None]),
            k.put_audio(xs[j])[None], k.put_f64(rands[j]),
            None if planes[j] is None else
            (k.put_f64(planes[j][0]), planes[j][1])))
    for b in range(steps[0].n_rows):
        for j in range(len(kernels)):
            steps[j].step(b, stages[j])
    ys, fin, mos = [], [], []
    for st in steps:
        y, ((svec, rings), bvars, bmem), mouts = st.result()
        ys.append(y[0])
        fin.append(((svec[0], {r: a[0] for r, a in rings.items()}),
                    bvars[0], bmem[0]))
        mos.append(None if mouts is None else mouts[:, 0])
    return ys, fin, segs, mos, (None if ctl is None else (window, ctl)), \
        dispatch


class _MemberBuffers:
    """A lockstep member's names in the lockstep's StepGraphs: `static`
    as StepGraphs', each name taken under the member's index, so that
    `_K5Block` lays out each member's buffers apart."""

    def __init__(self, k5, j: int):
        self.k5, self.j = k5, j

    def static(self, name, shape, dtype):
        return self.k5.static((self.j, name), shape, dtype)


def _lockstep_graph_blocks(kernels, seg_ids, carries, xs, rands, g0, msg,
                           bus, bus0, k5, capture: bool):
    """`lockstep_gmem_run` through K5 (the reference's one `lax.scan` over
    blocks, its `joint_step`): a graph block, every member's K10 with its
    staging and then its segment, in node order on one stream, is one step
    of the lockstep's StepGraphs (`k5`), captured the second time its key
    is seen and replayed; on CPU tensors (`capture` False) the same step
    runs uncaptured.

    Every buffer a graph block reads or writes is static, loaded once a
    render: each member's part (`_K5Block`, under its own names), the
    shared segments, and the bus's window, control row and subscriptions.
    The window is one storage for every render, sized once for the
    largest window the bus can ask for (W grows with the ring's backlog
    as a render starts), each render's W a prefix of it.  Where the
    members share a channel count their inputs go to the card stacked,
    [members, nch, T], and a graph block copies one slice in and one out;
    else a member's slice each.  A graph block's key is ("lockstep", L,
    W, nc) and the members' block keys (`_k5_key`) in node order.  Returns
    (ys, carries, gfin, mos, msg_fin) as `lockstep_gmem_run`, the results
    cloned out of the static buffers."""
    import torch

    from ..comm.bus import RING_CAPACITY
    from ..kernels.block_section import WINDOW_ENT
    from .devgen import MSG_OUT_CAP

    f64, f32 = torch.float64, torch.float32
    dev = kernels[0].device
    M, B = len(kernels), kernels[0].B
    T = xs[0].shape[1]
    segs = []
    for s, g in enumerate(g0):
        a = np.asarray(g, dtype=np.float64)
        segs.append(k5.static(("gseg", s), a.shape, f64))
        segs[-1].copy_(torch.from_numpy(a))
    window = ctl = None
    subs = {}
    if bus:
        k5.static("window", (2 * len(bus) * MSG_OUT_CAP + RING_CAPACITY,
                             WINDOW_ENT), f64)
        window = k5.static("window", bus0[0].shape, f64)
        window.copy_(torch.from_numpy(bus0[0]))
        ctl = k5.static("ctl", bus0[1].shape, f64)
        ctl.copy_(torch.from_numpy(bus0[1]))
        for j in bus:
            sub = np.asarray(msg.sub_masks[j], dtype=np.float64)
            subs[j] = k5.static(("sub", j), sub.shape, f64)
            subs[j].copy_(torch.from_numpy(sub))
    layout = (None, None) if not bus else (int(msg.W), int(msg.nc))
    stages = _lockstep_stages(seg_ids, segs, window, ctl, subs, bus, msg)
    members = [
        _K5Block(k, _MemberBuffers(k5, j),
                 ((carries[j][0][0][None],
                   {r: a[None] for r, a in carries[j][0][1].items()}),
                  carries[j][1][None], carries[j][2][None]),
                 k.put_f64(rands[j]), 1, stages[j])
        for j, k in enumerate(kernels)]
    stacked = len({k.nch for k in kernels}) == 1
    # the audio on the card, [members, nch, T] where the members share a
    # channel count (one copy in and one out a graph block), else [1, nch,
    # T] a member (a copy each a member)
    if stacked:
        audio = [torch.stack([k.put_audio(x) for k, x in zip(kernels, xs)])]
    else:
        audio = [k.put_audio(x)[None] for k, x in zip(kernels, xs)]
    outs = [torch.empty(a.shape, dtype=f32, device=dev) for a in audio]
    # the draw rows of the members that draw (not from a gated pool): one
    # row a full block of all of them, [B x nr] a member in node order,
    # packed once a render
    drawing = [m for m in members if m.nr]
    nfull, rem = divmod(T, B)
    packed = torch.cat([m.rand[:nfull * B].reshape(nfull, B * m.nr)
                        for m in drawing], dim=1) \
        if drawing and nfull else None
    for b in range(nfull + (1 if rem else 0)):
        L = B if b < nfull else rem
        t0 = b * B
        # the static input and output of the graph block, one a tensor of
        # `audio`, and each member's view of them
        x_st = [k5.static(("x", i), a.shape[:2] + (L,), f32)
                for i, a in enumerate(audio)]
        y_st = [k5.static(("y", i), a.shape[:2] + (L,), f32)
                for i, a in enumerate(audio)]
        if stacked:
            xins = [x_st[0][j:j + 1] for j in range(M)]
            youts = [y_st[0][j:j + 1] for j in range(M)]
        else:
            xins, youts = x_st, y_st
        aux = k5.static("aux", (L * sum(m.nr for m in members),), f64)
        at = 0
        for m in members:
            m.begin(L, aux[at:at + L * m.nr].view(L, m.nr))
            at += L * m.nr

        def body(xins=xins, youts=youts):
            for m, xin, yout in zip(members, xins, youts):
                m.body(xin, yout)

        def key(L=L):
            parts = [m.key() for m in members]
            if any(p is None for p in parts):
                return None
            return ("lockstep", L) + layout + tuple(parts)

        with _k5_range():
            for a, st in zip(audio, x_st):
                st.copy_(a[:, :, t0:t0 + L])
            if packed is not None and b < nfull:
                aux.copy_(packed[b])
            elif drawing:                       # the remainder's rows
                aux.copy_(torch.cat([m.rand[t0:t0 + L].reshape(-1)
                                     for m in drawing]))
            k5.step(key, body, capture)
            for st, y in zip(y_st, outs):
                y[:, :, t0:t0 + L].copy_(st)
        for m in members:
            m.end()
    ys = [outs[0][j] if stacked else outs[j][0] for j in range(M)]
    fin = [((svec[0], {r: a[0] for r, a in rings.items()}), bvars[0], bmem[0])
           for (svec, rings), bvars, bmem in (m.result() for m in members)]
    return (ys, fin, [s.clone() for s in segs], [None] * M,
            None if ctl is None else (window.clone(), ctl.clone()))
