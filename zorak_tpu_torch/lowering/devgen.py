"""Audio-coupled device sections: an EEL2 section -> CUDA C (K10's body).

Counterpart of zorak_tpu/lowering/devgen.py.  The reference traces an
audio-coupled @block (control computed from the audio: meters,
accumulators, spectral state) into XLA ops, and most of its bulk makes
scalar control code fit a TPU program: static/dynamic folding, both-arm
select-merges for traced branches, a loop vectorizer, cond outlining and
f64 DFT matmuls.  On an H100 scalar control code belongs on one thread,
so a `DeviceSection` here traces nothing: it prints the section as C
through `shadow/cgen.py`'s expression emitter, which has the golden's
scalar semantics, with the state retargeted at a device view:

* vars are the slots of a `double` row (`slots`, the reference's layout:
  the dynamic keys sorted by repr, then every user function's params,
  then the pseudo slots), anything else is frozen @init/@slider state and
  prints as a constant;
* mem is a heap row of `mem_size` cells, then (the reference's layout)
  the gmem window where a section uses gmem, the MIDI out table where one
  sends MIDI, and the message bus's OUT table and IN region (its queues)
  where a graph's lockstep member uses the bus;
* `samplesblock` is an argument, so one source serves full blocks and the
  remainder.

gmem is the view's `G`: the attached segment of a graph's lockstep
members (K10 reads and writes it in place, the members in node order on
one stream), else the heap's gmem window (K11's too: the reference's
sequential executor lays the window out over the union of its
sections).  The message bus follows the reference's live-bus subset
(`MSG_DEVICE_FNS`): sends append to the OUT table, receives pop the
queues K10's prologue filled from the graph's ring window, and the
topology queries fold against the frozen registry of the member's
`InstanceComm` (`MsgConfig.host`).  A lone instance (no live bus
host) folds the bus calls inert, as the golden's host does.

Heap addressing follows the reference's device sections, not the
golden's growable heap: a static address at or past `mem_size` raises
DevgenError while the source is printed, a dynamic one is clamped to
[0, mem_size - 1] (`csrc/block_ops.cuh`).  A section made with
`reduced_heap` (the sequential executor's, K11) addresses its heap as the
reference's reduced heap does instead: a dynamic address is raised to at
least 0, a read at or past `mem_size` gives 0, and a write there is
dropped and its address kept in the high-water slot, which the executor
reads after a render to climb its heap ladder.  Such a section prints
for K11's view of a file (`csrc/block_ops.cuh` ZX): the var row `V`
beside the view, the heap's first PAGE_CELLS cells on chip, a dynamic
address with a whole constant operand added as an integer, gmem's heap
side through `zx_gmem_bulk` (a gmem write moves no high water), and no live
bus (a lone instance's folds inert as K10's does; the reference's
executor passes no message config).  It may also draw `rand()` from a
staged pool (`rand_pool` > 0): K10's sections draw nothing.

The host services print as the reference's DeviceSection traces them.
The legacy file API folds while the text prints, on a fresh
`FileSlotService` over the snapshot host's slots each print (a load is
self-contained in one run of the section: open, riff, avail, file_mem,
close); its arguments must be static, a var assigned a static value reads
back static until the section writes it again, and a branch around a
load whose condition is static prints only the arm it takes.  file_mem's
chunk is no literal of the text: it is staged in the file table of the
program's `HostTables`, which the printed code copies into the heap.  A
loaded sample pool becomes gathers over its generation's packed tables
(`csrc/block_ops.cuh` zb_pool_*), an empty one folds to the golden host's
constants, and static queries fold through the host.  strlen and
str_getchar fold where their arguments are static and gather over the
literal pool's table where not; time() and time_precise() read the
golden host's virtual clock, static for a render.

What the section may not use raises DevgenError naming the work that
brings it; the specializer turns that into a SpecializeError, and the
engine renders the plugin through the golden.  `kernels/block_section.py`
wraps the printed sections into K10.

A section prints twice.  `body_source` is one function for one thread
(`zb_section_<name>`).  `phases` splits its statements, in source order,
into what thread 0 runs alone and what a file's whole CUDA block runs
between barriers.  A statement is split where it stands at statement
level: in the section, in the body of a user function called as a
statement, or in the body of a loop that holds block work.

* a static FFT call (`fft` ... `fft_ipermute`, `convolve_c`): thread 0
  evaluates its arguments and decides its region, then every thread runs
  the transform's block form;
* `memcpy` and `memset`: thread 0 evaluates the arguments and resolves
  the runs as the one-thread form does, then every thread copies a
  strided share; a copy whose runs overlap thread 0 makes itself (in
  memmove's order, counted);
* a `loop(n, ...; iv += 1)` or a counted `while (iv < e) (...; iv += 1)`
  (or `<=`, e loop-invariant) whose body is assignments and passes
  `_BlockLoop`'s checks: every thread runs a strided share of the
  iterations where thread 0 finds, on this run's values, that no two
  iterations touch one heap cell (for the `while`, its trips from iv's
  value by the golden's compare); else thread 0 runs the loop itself
  (and counts it);
* a user function called as a statement (its value unused): its body's
  phases in place, the arguments bound by thread 0 in the shared row,
  the locals in their var slots as in the one-thread form;
* any other `while` or `loop` whose body holds block work: thread 0 runs
  the loop's own control and publishes each pass's decision, every
  thread takes the same branch after a barrier, and the body's phases
  run inside;
* everything else, a serial phase on thread 0.

Either way the arithmetic of every FFT butterfly, every copy and every
iteration is the same, so both forms give the same bits.
"""
from __future__ import annotations

import copy
from dataclasses import fields
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from ..comm.bus import InstanceComm
from ..frontend.astnodes import (
    Asn, Bin, Block, CallExpr, Cond, Const, IfStmt, LoopExpr, Mem, Name,
    Node, Str, Un, WhileStmt, walk,
)
from ..ir.analyses import FUNSETS
from ..ir.program import PluginProgram
from ..ir.symbols import dollar_const
from ..runtime import fftops as FO
from ..semantics import scalar as SC
from ..shadow.cgen import _CGen, _mangle_c
from .scan_codegen import c_double
from .specialize import _env_key_for_name as _env_key, section_var_usage


class DevgenError(Exception):
    """The section uses a construct the device sections do not support."""


PENDING_SLOT_NAMES = ("__pend_chg__", "__pend_auto__", "__pend_auto_end__")
MIDI_POS_SLOT = "__midi_pos__"
MIDI_OUT_CAP = 64  # staged sends a block (later ones drop, like the ref queue)
# draws taken from the staged MT19937 pool: the sequential executor's
# sections (rand_pool > 0) draw from it, K10's draw nothing
RAND_POS_SLOT = "__rand_pos__"
# a reduced heap's high-water mark of dynamic write addresses (the
# reference's slot, after the others): at or past mem_size, a write was
# dropped and the executor replays on a larger heap
MEM_HIWATER_SLOT = "__mem_hiwater__"
# the reduced heap's first cells, which K11 keeps on chip (ZX_PAGE); the
# lowest rung of the executor's heap ladder holds them all
PAGE_CELLS = 4096

# device message-bus staging (a graph's lockstep members, the reference's
# devgen.py:62-76): a member's sends land in a heap OUT table, [count |
# MSG_OUT_CAP rows of MSG_ENT: bc, dest, chan_id, tag, a, b, c, d], that
# K10's epilogue appends to the graph's ring window; its prologue routes the
# window's matched entries into the member's queues, [drop cell | a queue a
# receive channel: head, count, MSG_QUEUE_CAP rows of MSG_QENT: sender, tag,
# a, b, c, d].  The drop cell counts sends past the OUT table and messages
# past a full queue: the graph refuses a render that dropped one (the
# golden's outbox and inbox are unbounded).
MSG_OUT_CAP = 32
MSG_QUEUE_CAP = 64
MSG_ENT = 8
MSG_QENT = 6


class MsgConfig:
    """The live bus of a graph's lockstep member.

    chan_ids: the channel-name -> small-int registry of the graph's
    CommWorld (one dict a world, so every member prints the same ids);
    host: the member's InstanceComm, whose frozen registry folds
    instance_id, msg_peer_* and msg_dropped while the source is printed."""

    def __init__(self, chan_ids: Dict[str, int], host):
        self.chan_ids = chan_ids
        self.host = host

    def intern(self, name: str) -> int:
        got = self.chan_ids.get(name)
        if got is None:
            got = len(self.chan_ids)
            self.chan_ids[name] = got
        return got


class HostTables:
    """The read-only tables the host-service calls of one program's
    sections read on the device: the loaded sample pool's generation
    packed as the reference's `_pool_tables` (f32 `data`, every entry's
    [frames, channels] row-major one after another; int64 `offs`, `frm`,
    `nch`, `pv_off`, `pv_bins` a row a sample id, row 0 none, and `order`;
    f64 `meta` (srate, peak, rms) and `pv`), the file table (the chunks
    file_mem copies, in print order, each once) and the literal pool
    (`_str_tables`).  They fill while the sections print, and `version`
    counts the prints that added to them.  The launch layer
    (`kernels/host_tables.py`) stages them on a device once a version and
    keeps its copies in `staged`, so the programs of one render (the rungs
    of a heap ladder, a batch's files) share one staging."""

    def __init__(self):
        self.pool: Optional[Dict[str, np.ndarray]] = None
        self._gen = None
        self.strings: Optional[Tuple[np.ndarray, ...]] = None
        self._chunks: List[np.ndarray] = []
        self._chunk_at: Dict[Any, int] = {}
        self.file_cells = 0
        self.version = 0
        self.staged: Dict[str, Any] = {}   # by device, the launch layer's
        self.stagings = 0          # how often they were copied to a device

    @property
    def used(self) -> bool:
        return (self.pool is not None or self.strings is not None
                or self.file_cells > 0)

    def pool_of(self, gen) -> Dict[str, np.ndarray]:
        """The packed tables of a loaded generation (made once a
        generation: a generation is immutable while it is published)."""
        if self._gen is not gen:
            maxsid = max(gen.entries)
            offs, frm, nch, pv_off, pv_bins = (
                np.zeros(maxsid + 1, np.int64) for _ in range(5))
            meta = np.zeros((maxsid + 1, 3), np.float64)
            datas, pvs = [], []
            cur = pcur = 0
            for sid in sorted(gen.entries):
                e = gen.entries[sid]
                offs[sid], frm[sid], nch[sid] = cur, e.data.shape[0], \
                    e.data.shape[1]
                meta[sid] = (float(e.srate), e.peak, e.rms)
                datas.append(np.asarray(e.data, np.float32).reshape(-1))
                cur += e.data.size
                pv_off[sid], pv_bins[sid] = pcur, len(e.preview)
                pvs.append(np.asarray(e.preview, np.float64).reshape(-1))
                pcur += e.preview.size
            self.pool = {
                "maxsid": maxsid, "n_order": len(gen.order),
                "data": np.concatenate(datas) if cur
                else np.zeros(1, np.float32),
                "offs": offs, "frm": frm, "nch": nch, "pv_off": pv_off,
                "pv_bins": pv_bins,
                "order": np.asarray(gen.order or [0], np.int64),
                "meta": meta.reshape(-1),
                "pv": np.concatenate(pvs) if pcur else np.zeros(3),
            }
            self._gen = gen
            self.version += 1
        return self.pool

    def strings_of(self, snap) -> Tuple[np.ndarray, ...]:
        """(handles, lengths, chars [literals, width]) of the literal pool:
        strings are immutable in every executor, so the snapshot's are all
        there are."""
        if self.strings is None:
            items = sorted((int(h), t or "") for h, t in
                           getattr(snap, "strings_by_handle", {}).items())
            items = items or [(-1, "")]
            width = max(1, max(len(t) for _h, t in items))
            chars = np.zeros((len(items), width), np.float64)
            for r, (_h, t) in enumerate(items):
                chars[r, :len(t)] = [float(ord(c)) for c in t]
            self.strings = (np.asarray([h for h, _t in items], np.int64),
                            np.asarray([len(t) for _h, t in items],
                                       np.float64), chars.reshape(-1), width)
            self.version += 1
        return self.strings

    def file_chunk(self, key, chunk: np.ndarray) -> int:
        """The file table's offset of a chunk (key: its file, cursor and
        length), appended at its first print."""
        at = self._chunk_at.get(key)
        if at is None:
            at = self._chunk_at[key] = self.file_cells
            self._chunks.append(np.asarray(chunk, np.float64))
            self.file_cells += len(chunk)
            self.version += 1
        return at

    def file_table(self) -> np.ndarray:
        """The file table: every chunk, in print order."""
        return np.concatenate(self._chunks)


def fresh_file_service(host):
    """A file service over the host's slots with no file open (the
    reference's `_fresh_file_service`): each print of a section, and each
    run of it in the plain versions, starts from it."""
    from ..runtime.services import FileSlotService

    svc = FileSlotService()
    src = getattr(host, "files", None)
    if src is not None:
        svc.slots = src.slots
    return svc


def plain_host(host):
    """The host a plain version's section run calls: the snapshot's, with
    a fresh file service (the file API folds each print from no file
    open, so each run of the section starts there too)."""
    if getattr(host, "files", None) is None:
        return host
    h = copy.copy(host)
    h.files = fresh_file_service(host)
    return h


# where each refused construct comes from (ROADMAP.md)
_BUS = ("the device sections stage scalar messages and fold the registry "
        "only (the reference's DeviceSection._MSG_DEVICE_FNS and _GMEM_FNS): "
        "buffer messages, registry changes, names, uids and page sequence "
        "numbers render through the golden, as in the reference")
_NEVER = ("the reference does not run it on the device either, and no "
          "slice brings it: the golden renders the plugin")

# the reference's sets (zorak_tpu/lowering/devgen.py:356, :369, :416),
# which decide what a section may use and how a graph routes its nodes:
# the bus calls a lone instance folds inert, the live-bus subset of a
# lockstep member, and the gmem builtins
COMM_FNS = frozenset({
    "msg_send", "msg_sendto", "msg_recv", "msg_peek",
    "msg_send_buf", "msg_sendto_buf",
    "msg_advertise", "msg_subscribe", "msg_unsubscribe",
    "msg_avail", "msg_kind", "msg_length", "msg_dropped", "msg_clear",
    "msg_peer_count", "msg_peer_id", "msg_peer_caps", "msg_peer_alive",
    "comm_join", "instance_id", "instance_set_name",
})
MSG_DEVICE_FNS = frozenset({
    "msg_send", "msg_sendto", "msg_recv",
    "msg_avail", "msg_kind", "msg_length", "msg_dropped", "msg_clear",
    "msg_peer_count", "msg_peer_id", "msg_peer_caps", "msg_peer_alive",
    "instance_id",
})
GMEM_FNS = frozenset({
    "gmem_attach", "gmem_attach_size", "gmem_size", "gmem_get",
    "gmem_put", "gmem_fill", "gmem_zero", "gmem_copy"})
# every bus and gmem builtin of the golden's host: what the sets above do
# not take is refused (_BUS)
_BUS_FNS = COMM_FNS | GMEM_FNS | {
    "msg_recv_buf", "msg_peer_name", "msg_peer_uid", "instance_uid",
    "instance_get_name", "gmem_seq", "gmem_page"}
_MSG_RECV_SIDE = frozenset({
    "msg_recv", "msg_avail", "msg_kind", "msg_length", "msg_clear"})
# the reference's _FORBIDDEN that no other list names, and the host's
# track names, which its device sections do not run either
_FORBIDDEN = frozenset({
    "midisend_buf", "midirecv_buf", "midisend_str", "midirecv_str",
    "midisyx", "slider_show", "slider_next_chg",
    "file_string", "file_read", "file_write",
    "get_host_placement", "export_buffer_to_project",
    "mem_set_values", "mem_get_values", "atomic_setifequal",
    "stack_push", "stack_pop", "stack_peek", "stack_exch",
}) | FUNSETS.HOST_TRACK
# the host services the sections run (the reference's `_file_call`,
# `_pool_call`, `_str_gather` and its virtual clock)
_FILE_FNS = FUNSETS.LEGACY_FILE
_POOL_FNS = FUNSETS.POOL_ALL
_POOL_SETUP = FUNSETS.POOL_SETUP
# the pool and string reads that touch no state: pure, like a heap read
_POOL_READS = frozenset({
    "sample_read", "sample_read_interp", "sample_get", "sample_len",
    "sample_channels", "sample_srate", "sample_peak", "sample_rms",
    "sample_preview_bins", "strlen", "str_getchar"})
_POOL_ROW = {"sample_len": "zb_pool_len(&S->H, {})",
             "sample_channels": "zb_pool_channels(&S->H, {})",
             "sample_preview_bins": "zb_pool_bins(&S->H, {})",
             "sample_srate": "zb_pool_meta(&S->H, {}, 0)",
             "sample_peak": "zb_pool_meta(&S->H, {}, 1)",
             "sample_rms": "zb_pool_meta(&S->H, {}, 2)"}
_POOL_LEVEL = frozenset({
    "sample_pool_state", "sample_pool_selected", "sample_pool_loaded",
    "sample_pool_failed", "sample_pool_ram_mb", "sample_pool_generation"})
_INERT = frozenset({
    "sprintf", "printf", "strcpy", "strcat", "strcmp", "str_setchar",
    "str_insert", "str_delete", "str_mid", "strncpy"})
_UNARY_C = {
    "sin": "sin", "cos": "cos", "tan": "tan", "asin": "asin",
    "acos": "acos", "atan": "atan", "exp": "exp", "log": "log",
    "log10": "log10", "sqrt": "sqrt", "abs": "z_abs", "fabs": "z_abs",
    "floor": "z_floor", "ceil": "z_ceil", "invsqrt": "z_invsqrt",
    "sign": "z_sign",
}
_BINARY_C = {
    "/": "z_div", "^": "z_pow", "%": "z_mod", "|": "z_or", "&": "z_and",
    "~": "z_xor", "<<": "z_shl", ">>": "z_shr", "<": "z_lt", "<=": "z_le",
    ">": "z_gt", ">=": "z_ge", "==": "z_eq", "!=": "z_ne",
    "min": "z_min", "max": "z_max", "pow": "z_pow", "atan2": "atan2",
}
_COMPOUND_C = {"+=": "+", "-=": "-", "*=": "*", "/=": "/", "%=": "%",
               "^=": "^", "|=": "|", "&=": "&", "~=": "~"}
_SC_BINARY = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": SC.eel_div, "^": SC.eel_pow,
    "%": SC.eel_mod, "|": SC.eel_or, "&": SC.eel_and, "~": SC.eel_xor,
    "<<": SC.eel_shl, ">>": SC.eel_shr, "<": SC.cmp_lt, "<=": SC.cmp_le,
    ">": SC.cmp_gt, ">=": SC.cmp_ge, "==": SC.cmp_eq, "!=": SC.cmp_ne,
}
# calls with no effect on the state (their operands may still have one)
_PURE_CALLS = frozenset(_UNARY_C) | {"min", "max", "pow", "atan2", "sqr",
                                     "__memtop"} | _POOL_READS
_FFT_FNS = ("fft", "ifft", "fft_real", "ifft_real", "fft_permute",
            "fft_ipermute")


def section_dynamic_keys(program: PluginProgram, sections: Sequence[str]):
    """Env keys any DSP section can CHANGE at runtime (everything else is
    frozen @init/@slider state and prints as a constant)."""
    dyn: Set[Any] = set()
    for sec in sections:
        if program.sections.get(sec):
            _, writes, _, _ = section_var_usage(program, sec)
            dyn |= writes
    dyn |= {("spl", c) for c in range(64)}
    return dyn


def _impure(node: Node) -> bool:
    """Whether evaluating node may change the state (an assignment, a call
    that writes), so that the operands around it must run in order."""
    for n in walk(node):
        if isinstance(n, Asn):
            return True
        if isinstance(n, CallExpr) and n.func not in _PURE_CALLS:
            return True
    return False


def reach(program: PluginProgram, bodies):
    """The nodes of the statement lists, and of each user function they
    call at its first call, in walk order (the reference's scans)."""
    seen: Set[str] = set()

    def scan(nodes):
        for root in nodes:
            for n in walk(root):
                yield n
                if isinstance(n, CallExpr) and n.func in program.fn_defs \
                        and n.func not in seen:
                    seen.add(n.func)
                    yield from scan([program.fn_defs[n.func].body])
    for b in bodies:
        yield from scan(b)


def bus_touch(program: PluginProgram,
              sections: Sequence[str] = ("slider", "block", "sample")
              ) -> Tuple[bool, bool]:
    """(touches the message bus, touches gmem) in the sections or the user
    functions they call, by the reference's sets: how a graph routes a
    node and whether a section gets the live bus."""
    msg = gmem = False
    for n in reach(program, [program.sections.get(s) or []
                             for s in sections]):
        if isinstance(n, Mem) and isinstance(n.base, Name) \
                and n.base.ident == "gmem":
            gmem = True
        elif isinstance(n, CallExpr):
            msg = msg or n.func in COMM_FNS
            gmem = gmem or n.func in GMEM_FNS
    return msg, gmem


def _gidx(x: float) -> int:
    """shadow/state.py's `_gmem_index`: max(0, int(x + 1e-5)), 0 where the
    conversion fails."""
    try:
        return max(0, int(x + 1.0e-5))
    except (ValueError, OverflowError):
        return 0


class _SectionC(_CGen):
    """cgen's expression emitter with the state of a device section: var
    slots `S->V[i]`, the clamped heap `S->M`, `csrc/block_ops.cuh` for what
    cgen sends to its host callback (on a reduced heap, K11's view: slots
    `V[i]`, the heap's first page `S->P`, the `zx_` helpers).  Operands
    that change the state are evaluated in the golden's order (left to
    right, an assignment's value before its target), which C leaves
    unspecified."""

    def __init__(self, dev: "DeviceSection", params: Sequence[str] = (),
                 local: Optional[Dict[Any, str]] = None,
                 in_function: bool = False):
        super().__init__(dev.P, params)
        self.dev = dev
        # var keys a block loop keeps in a thread's own C variables
        self.local = local or {}
        # the print-time state of the file API (the reference's trace-time
        # overlay): the open files, the vars known to hold a static value
        # here, the static values of the host calls printed so far, and
        # whether the code printed runs more than once a section run
        self.files = fresh_file_service(getattr(dev.snap, "host", None))
        self.known: Dict[Any, float] = {}
        self.static_of: Dict[int, float] = {}
        self.repeats = 1 if in_function else 0

    def tmp(self) -> str:
        self.dev._ntmp += 1
        return f"_z{self.dev._ntmp}"

    def seq(self, parts: Sequence[str], fmt) -> str:
        """fmt(values) with each part evaluated once, in order."""
        names = [self.tmp() for _ in parts]
        decl = " ".join(f"double {t} = ({p});" for t, p in zip(names, parts))
        return f"({{ {decl} {fmt(names)}; }})"

    def args(self, nodes: Sequence[Node], fmt) -> str:
        """fmt(operand texts), sequenced where an operand has an effect."""
        parts = [self.ex(a) for a in nodes]
        if len(nodes) > 1 and any(_impure(a) for a in nodes):
            return self.seq(parts, fmt)
        return fmt(parts)

    # -- names and constants ---------------------------------------------------

    def name_ref(self, ident: str) -> str:
        if ident in self.params:
            return self.params[ident]
        if ident == "mem":
            return "0.0"
        if ident == "gmem":
            raise DevgenError("gmem may only be used as gmem[index]")
        c = dollar_const(ident)
        if c is not None:
            return c_double(c)
        key = _env_key(ident)
        if key in self.local:
            return self.local[key]
        if key == ("builtin", "samplesblock"):
            return "S->samplesblock"
        slot = self.dev.slots.get(key)
        if slot is not None:
            return f"{self.dev.vrow}[{slot}]"
        return c_double(self.dev._frozen_value(key))

    def lvalue(self, ident: str) -> str:
        if ident in self.params:
            return self.params[ident]
        if ident in ("mem", "gmem") or dollar_const(ident) is not None:
            raise DevgenError(f"cannot assign to {ident}")
        key = _env_key(ident)
        if key in self.local:
            return self.local[key]
        slot = self.dev.slots.get(key)
        if slot is None:
            raise DevgenError(f"write to unclassified state {key!r}")
        return f"{self.dev.vrow}[{slot}]"

    def fold(self, n: Node, known: Optional[Dict[Any, float]] = None
             ) -> Optional[float]:
        """n's value when it is known while printing (constants and frozen
        state), else None.  With `known` (the file API's overlay), a var
        slot known to hold a static value, a host call printed static and
        min, max and a ternary over static operands fold too."""
        if isinstance(n, Const):
            return float(n.value)
        if isinstance(n, Str):
            return float(self.P.string_handle(n.text))
        if isinstance(n, Name):
            if n.ident in self.params or n.ident == "gmem":
                return None
            if n.ident == "mem":
                return 0.0
            c = dollar_const(n.ident)
            if c is not None:
                return float(c)
            key = _env_key(n.ident)
            if key in self.local or key == ("builtin", "samplesblock"):
                return None
            if key in self.dev.slots:
                return None if known is None else known.get(key)
            return self.dev._frozen_value(key)
        if isinstance(n, Un):
            a = self.fold(n.operand, known)
            if a is None:
                return None
            return {"+": a, "-": 0.0 - a}.get(n.op, SC.eel_not(a))
        if isinstance(n, Bin) and n.op in _SC_BINARY:
            a, b = self.fold(n.lhs, known), self.fold(n.rhs, known)
            if a is None or b is None:
                return None
            return _SC_BINARY[n.op](a, b)
        if known is None:
            return None
        if isinstance(n, CallExpr):
            if id(n) in self.static_of:
                return self.static_of[id(n)]
            if n.func in ("min", "max") and len(n.args) == 2:
                a, b = (self.fold(x, known) for x in n.args)
                if a is None or b is None:
                    return None
                return (SC.eel_min if n.func == "min" else SC.eel_max)(a, b)
            return None
        if isinstance(n, Cond):
            c = self.fold(n.pred, known)
            if c is None:
                return None
            return self.fold(n.then if SC.truthy(c) else n.other, known)
        return None

    def fold_known(self, n: Node) -> Optional[float]:
        return self.fold(n, self.known)

    # -- the file API's print-time state across control flow -------------------

    def forget(self, node: Optional[Node]) -> None:
        """Drop what the overlay knows of every var node may write: an
        assignment's target, a builtin's variable arguments (its
        out-params); a user function call may write any."""
        if node is None or not self.known:
            return
        for n in walk(node):
            if isinstance(n, Asn) and isinstance(n.target, Name):
                self.known.pop(_env_key(n.target.ident), None)
            elif isinstance(n, CallExpr):
                if n.func in self.P.fn_defs:
                    self.known.clear()
                    return
                if n.func not in _PURE_CALLS:
                    for a in n.args:
                        if isinstance(a, Name):
                            self.known.pop(_env_key(a.ident), None)

    def _file_state(self):
        svc = self.files
        fp = tuple(sorted((k, h.cursor, h.selected)
                          for k, h in svc.open_handles.items()))
        clone = fresh_file_service(getattr(self.dev.snap, "host", None))
        clone.open_handles = {k: copy.copy(h)
                              for k, h in svc.open_handles.items()}
        clone._next_handle = svc._next_handle
        clone._free_handles = list(svc._free_handles)
        return fp, clone

    def arms(self, a: Optional[Node], b: Optional[Node]) -> Tuple[str, str]:
        """The two arms of a branch taken at run time: each printed from
        the state before it; afterwards a var stays known where both arms
        agree, and the open files must be the same after either arm (the
        reference's `_merged`)."""
        known0 = dict(self.known)
        fp0, files0 = self._file_state()
        ta = self.ex(a) if a is not None else "0.0"
        known_a, files_a = self.known, self.files
        fp_a = self._file_state()[0]
        self.known, self.files = dict(known0), files0
        tb = self.ex(b) if b is not None else "0.0"
        fp_b = self._file_state()[0]
        if fp_a != fp_b:
            raise DevgenError("file cursor state diverges across a "
                              "data-dependent branch")
        if fp_a != fp0:
            self.files = files_a
        self.known = {k: v for k, v in known_a.items()
                      if k in self.known and self.known[k] == v}
        return ta, tb

    def static_arm(self, pred: Node, arms: Sequence[Optional[Node]]):
        """The arm a branch takes where its condition folds and an arm
        calls the file API (which folds only on the path it runs); else
        None."""
        if not any(a is not None and any(
                isinstance(n, CallExpr) and n.func in _FILE_FNS
                for n in walk(a)) for a in arms):
            return None
        c = self.fold_known(pred)
        if c is None:
            return None
        return (arms[0] if SC.truthy(c) else arms[1],)

    def looped(self, head: Optional[Node], body: Node, fmt) -> str:
        """A loop: the vars its body (and a while's condition) writes are
        unknown inside it and after it."""
        self.forget(head)
        self.forget(body)
        self.repeats += 1
        try:
            text = fmt()
        finally:
            self.repeats -= 1
        self.forget(head)
        self.forget(body)
        return text

    def static_addr(self, base: Node, idx: Node) -> Optional[int]:
        b, i = self.fold(base), self.fold(idx)
        if b is None or i is None:
            return None
        a = SC.mem_address(b, i)
        if a >= self.dev.mem_size:
            raise DevgenError(f"static mem address {a} beyond device heap "
                              f"({self.dev.mem_size})")
        return a

    def whole_operand(self, m: Mem):
        """(the other operand, k) where one operand of a dynamic heap
        address folds to a whole constant k, |k| < 2^31 (a record's field,
        a table's base): K11 adds it as an integer (zx_raddr_k, the same
        address); else None."""
        for node, other in ((m.index, m.base), (m.base, m.index)):
            v = self.fold(node)
            if v is not None and v == np.floor(v) and abs(v) < 2.0 ** 31:
                return other, int(v)
        return None

    def static_run(self, what: str, start: Node, length: Node) -> None:
        """A bulk operation's static run must lie inside the heap."""
        s, n = self.fold(start), self.fold(length)
        if s is not None and n is not None:
            end = SC.blob_address(s) + max(0, SC.trunc_i64(n))
            if end > self.dev.mem_size:
                raise DevgenError(f"{what}: static mem address {end} beyond "
                                  f"device heap ({self.dev.mem_size})")

    # -- expressions -----------------------------------------------------------

    def ex(self, n: Node) -> str:
        if isinstance(n, Const):
            return c_double(n.value)
        if isinstance(n, Str):
            return c_double(float(self.P.string_handle(n.text)))
        if isinstance(n, Mem):
            if self._is_gmem(n):
                return f"zb_gmem_get(S, {self.ex(n.index)})"
            a = self.static_addr(n.base, n.index)
            if a is not None:
                return self.dev.cell(a)
            k = self.whole_operand(n) if self.dev.reduced_heap else None
            if k is not None:
                return f"zx_rmget_k(S, {self.ex(k[0])}, {k[1]})"
            get = "zx_rmget" if self.dev.reduced_heap else "zb_mget"
            return self.args([n.base, n.index],
                             lambda v: f"{get}(S, {v[0]}, {v[1]})")
        if isinstance(n, Un):
            a = self.ex(n.operand)
            return {"+": a, "-": f"(0.0 - {a})"}.get(n.op, f"z_not({a})")
        if isinstance(n, Bin) and n.op not in ("&&", "||"):
            op = n.op
            if op in ("+", "-", "*"):
                return self.args([n.lhs, n.rhs],
                                 lambda v: f"({v[0]} {op} {v[1]})")
            return self.args([n.lhs, n.rhs],
                             lambda v: f"{_BINARY_C[op]}({v[0]}, {v[1]})")
        if isinstance(n, Bin):
            lhs = self.ex(n.lhs)
            rhs = self.arms(n.rhs, None)[0]
            if n.op == "&&":
                return (f"(z_true({lhs}) ? (z_true({rhs}) ? 1.0 : 0.0) "
                        ": 0.0)")
            return f"(z_true({lhs}) ? 1.0 : (z_true({rhs}) ? 1.0 : 0.0))"
        if isinstance(n, Cond):
            arm = self.static_arm(n.pred, (n.then, n.other))
            if arm is not None:
                return f"({self.ex(arm[0])})"
            pred = self.ex(n.pred)
            t, e = self.arms(n.then, n.other)
            return f"(z_true({pred}) ? ({t}) : ({e}))"
        if isinstance(n, LoopExpr):
            count = self.ex(n.count)
            return self.looped(None, n.body, lambda: (
                "({ double _lv = 0.0; int64_t _ln = zt_i64(%s); "
                "for (int64_t _li = 0; _li < _ln; _li++) { _lv = (%s); } "
                "_lv; })" % (count, self.ex(n.body))))
        return super().ex(n)

    def stmt(self, n: Node) -> str:
        if isinstance(n, IfStmt):
            arm = self.static_arm(n.pred, (n.then, n.other))
            if arm is not None:
                return f"(void)({self.ex(arm[0])});" \
                    if arm[0] is not None else ""
            pred = self.ex(n.pred)
            t, e = self.arms(n.then, n.other)
            out = f"if (z_true({pred})) {{ (void)({t}); }}"
            if n.other is not None:
                out += f" else {{ (void)({e}); }}"
            return out
        if isinstance(n, WhileStmt):
            return self.looped(n.pred, n.body, lambda: (
                f"while (z_true({self.ex(n.pred)})) "
                f"{{ (void)({self.ex(n.body)}); }}"))
        return super().stmt(n)

    def _assign(self, n: Asn) -> str:
        tgt = n.target
        rhs = self.ex(n.value)
        if isinstance(tgt, Name):
            ref = self.lvalue(tgt.ident)
            r = self.tmp()
            key = _env_key(tgt.ident)
            v = self.fold_known(n.value) if n.op == "=" else None
            if v is None or tgt.ident in self.params:
                self.known.pop(key, None)
            else:
                self.known[key] = v
            if n.op == "=":
                return f"({{ double {r} = ({rhs}); {ref} = {r}; {r}; }})"
            new = self._binop(_COMPOUND_C[n.op], ref, r)
            return f"({{ double {r} = ({rhs}); {ref} = {new}; {ref}; }})"
        if isinstance(tgt, Mem):
            if self._is_gmem(tgt):
                # the golden's order: the value, the index, then the cell
                r, i = self.tmp(), self.tmp()
                head = f"double {r} = ({rhs}); double {i} = ({self.ex(tgt.index)});"
                if n.op == "=":
                    return f"({{ {head} zb_gmem_set(S, {i}, {r}); }})"
                o = self.tmp()
                new = self._binop(_COMPOUND_C[n.op], f"zb_gmem_get(S, {i})", r)
                return (f"({{ {head} double {o} = {new}; "
                        f"zb_gmem_set(S, {i}, {o}); }})")
            r, a = self.tmp(), self.tmp()
            static = self.static_addr(tgt.base, tgt.index)
            if static is not None:
                where = f"long long {a} = {static};"
                # (K10's text names the cell through the temporary)
                cell = self.dev.cell(static) if self.dev.reduced_heap \
                    else f"S->M[{a}]"
            else:
                b, i = self.tmp(), self.tmp()
                if self.dev.reduced_heap:
                    k = self.whole_operand(tgt)
                    if k is not None:
                        where = (f"double {b} = ({self.ex(k[0])}); "
                                 f"long long {a} = zx_raddr_k({b}, {k[1]});")
                    else:
                        where = (f"double {b} = ({self.ex(tgt.base)}); "
                                 f"double {i} = ({self.ex(tgt.index)}); "
                                 f"long long {a} = zx_raddr({b}, {i});")
                    # a write past the heap drops and marks the high water
                    if n.op == "=":
                        return (f"({{ double {r} = ({rhs}); {where} "
                                f"zx_rmset(S, {a}, {r}); {r}; }})")
                    o = self.tmp()
                    new = self._binop(_COMPOUND_C[n.op], f"zx_rat(S, {a})", r)
                    return (f"({{ double {r} = ({rhs}); {where} double {o} = "
                            f"{new}; zx_rmset(S, {a}, {o}); {o}; }})")
                where = (f"double {b} = ({self.ex(tgt.base)}); "
                         f"double {i} = ({self.ex(tgt.index)}); "
                         f"long long {a} = zb_addr(S, {b}, {i});")
                cell = f"S->M[{a}]"
            if n.op == "=":
                return (f"({{ double {r} = ({rhs}); {where} "
                        f"{cell} = {r}; {r}; }})")
            new = self._binop(_COMPOUND_C[n.op], cell, r)
            return (f"({{ double {r} = ({rhs}); {where} "
                    f"{cell} = {new}; {cell}; }})")
        if isinstance(tgt, CallExpr) and tgt.func in ("slider", "spl"):
            raise DevgenError(f"dynamic {tgt.func}() assignment in a device "
                              f"section: {_NEVER}")
        raise DevgenError("invalid assignment target")

    @staticmethod
    def _binop(op: str, a: str, b: str) -> str:
        if op in ("+", "-", "*"):
            return f"({a} {op} {b})"
        return f"{_BINARY_C[op]}({a}, {b})"

    # -- calls -----------------------------------------------------------------

    def _call(self, n: CallExpr) -> str:
        fn = n.func
        if fn in _FILE_FNS:
            return self._file_call(n)
        if fn in ("time", "time_precise"):
            return self._clock(n)
        text = self._builtin(n)
        if fn in self.P.fn_defs:
            self.known.clear()
        elif fn not in _PURE_CALLS:
            self.forget(n)   # a builtin may write its variable arguments
        return text

    def _builtin(self, n: CallExpr) -> str:  # noqa: C901 (one dispatch)
        fn, A = n.func, n.args
        dev = self.dev
        if fn in self.P.fn_defs:
            proto = self.P.fn_defs[fn]
            dev._used_fns.add(fn)
            k = len(proto.params)
            name = f"uf_{_mangle_c(fn)}"
            view = dev.view_args
            if not k:
                return f"{name}({view})"
            # the golden drops extra arguments unevaluated and pads with 0
            nodes = list(A[:k])
            pad = ", 0.0" * (k - len(nodes))
            if not nodes:
                return f"{name}({view}{pad})"
            return self.args(nodes,
                             lambda v: f"{name}({view}, {', '.join(v)}{pad})")
        if fn in ("slider", "spl") and len(A) == 1:
            i = self.fold(A[0])
            if i is None:
                raise DevgenError(f"dynamic {fn}() read in a device section: "
                                  f"{_NEVER}")
            c = int(i + 1.0e-5) - (1 if fn == "slider" else 0)
            if not 0 <= c < 64:
                return "0.0"
            return self.name_ref(f"slider{c + 1}" if fn == "slider"
                                 else f"spl{c}")
        if fn in ("min", "max", "pow", "atan2") and len(A) == 2:
            return self.args(A, lambda v: f"{_BINARY_C[fn]}({v[0]}, {v[1]})")
        if fn in _UNARY_C and len(A) == 1:
            return f"{_UNARY_C[fn]}({self.ex(A[0])})"
        if fn == "sqr" and len(A) == 1:
            t = self.tmp()
            return f"({{ double {t} = ({self.ex(A[0])}); {t} * {t}; }})"
        if fn in ("memset", "memcpy") and len(A) == 3:
            self.static_run(fn, A[0], A[2])
            if fn == "memcpy":
                self.static_run(fn, A[1], A[2])
            return self.args(A, lambda v: f"{dev.ops}_{fn}(S, {', '.join(v)})")
        if fn in _FFT_FNS and len(A) == 2:
            return self._fft(fn, A)
        if fn == "convolve_c" and len(A) == 3:
            return self._convolve(A)
        if fn == "midirecv":
            return self._midirecv(A)
        if fn == "midisend":
            if len(A) not in (3, 4):
                raise DevgenError("midisend expects 3 or 4 args")
            assert dev.uses_midi_out, "the layout's scan missed a midisend"
            name = "zb_midisend" if len(A) == 4 else "zb_midisend3"
            return self.args(A, lambda v: f"{name}(S, {', '.join(v)})")
        if fn in ("sliderchange", "slider_automate") and A:
            return self._pending(fn, A)
        if fn == "freembuf":
            return "(" + "".join(f"(void)({self.ex(a)}), " for a in A) + "0.0)"
        if fn in _INERT:
            return "(" + "".join(f"(void)({self.ex(a)}), " for a in A) + "0.0)"
        if fn == "__memtop":
            return c_double(float(self.P.memtop))
        if fn == "rand":
            if not dev.rand_pool:
                raise DevgenError(
                    f"rand() in @{dev.section} on the device: the reference "
                    "stages no draw pool there; the engine renders the "
                    "plugin through the sequential executor (devexec, "
                    "slice 6b), whose sections draw from a staged pool")
            dev.uses_rand = True
            limit = self.ex(A[0]) if A else "1.0"
            pos = dev.slots[("var", RAND_POS_SLOT)]
            return f"zx_rand(S, &{dev.vrow}[{pos}], {limit})"
        if fn in _BUS_FNS:
            return self._bus_call(fn, A)
        if fn in _POOL_FNS:
            return self._pool_call(n)
        if fn in ("strlen", "str_getchar"):
            return self._string_call(n)
        if fn in _FORBIDDEN:
            raise DevgenError(f"@{dev.section} uses {fn}(): {_NEVER}")
        raise DevgenError(f"@{dev.section} builtin {fn}() not "
                          f"device-executable: {_NEVER}")

    # -- host services: files, the sample pool, strings, the clock --------------

    def _host(self):
        return getattr(self.dev.snap, "host", None)

    def _static_args(self, n: CallExpr, what: str):
        """(values, texts) of a call's arguments, each printed (a nested
        host call folds there) and then folded through the overlay;
        raises where one is not static."""
        texts, vals = [], []
        for a in n.args:
            texts.append(self.ex(a))
            v = self.fold_known(a)
            if v is None:
                raise DevgenError(f"{n.func} with non-static {what}")
            vals.append(v)
        return vals, texts

    def _const(self, n: CallExpr, value: float, texts=(), prep: str = "") -> str:
        """A host call folded to `value`: what its arguments printed that
        has an effect, then the constant (known to the overlay)."""
        self.static_of[id(n)] = float(value)
        keep = "".join(f"(void)({t}), " for t, a in zip(texts, n.args)
                       if _impure(a))
        if prep:
            return f"({{ {prep} ({keep}{c_double(float(value))}); }})"
        return f"({keep}{c_double(float(value))})"

    def _out_param(self, node: Node, fn: str) -> Tuple[str, Any]:
        """An out-parameter's (declarations, store(value text) -> C): its
        cell found now (the golden's order), written by the store."""
        if isinstance(node, Name) and node.ident not in ("mem", "gmem"):
            ref = self.lvalue(node.ident)
            key = _env_key(node.ident)

            def store(v: str, static: Optional[float] = None) -> str:
                if static is None or node.ident in self.params:
                    self.known.pop(key, None)
                else:
                    self.known[key] = static
                return f"{ref} = {v};"
            return "", store
        if isinstance(node, Mem) and not self._is_gmem(node):
            a = self.static_addr(node.base, node.index)
            if a is not None:
                cell = self.dev.cell(a) if self.dev.reduced_heap \
                    else f"S->M[{a}]"
                return "", lambda v, static=None: f"{cell} = {v};"
            t, b, i = self.tmp(), self.tmp(), self.tmp()
            head = (f"double {b} = ({self.ex(node.base)}); "
                    f"double {i} = ({self.ex(node.index)}); ")
            if self.dev.reduced_heap:
                return (head + f"long long {t} = zx_raddr({b}, {i});",
                        lambda v, static=None: f"zx_rmset(S, {t}, {v});")
            return (head + f"long long {t} = zb_addr(S, {b}, {i});",
                    lambda v, static=None: f"S->M[{t}] = {v};")
        raise DevgenError(f"{fn}: out-arg must be a variable or mem[] slot")

    def _file_call(self, n: CallExpr) -> str:
        """The legacy file API folded while the text prints (the
        reference's `_file_call`): the handle and every argument static,
        the answers FileSlotService's on the print's own service; a
        file_mem chunk goes into the file table and prints as a copy from
        it.  Once a print: not inside a loop or a user function, where the
        golden would call it again."""
        f, A = n.func, n.args
        dev = self.dev
        if self.repeats:
            raise DevgenError(
                f"@{dev.section} calls {f}() inside a loop or a user "
                "function: the file API folds once a print (as the "
                "reference's trace does), and the golden calls it each time")
        svc = self.files
        if (f, len(A)) in (("file_riff", 3), ("file_var", 2)):
            # file_riff(h, nch, srate), file_var(h, value)
            ht = self.ex(A[0])
            h = self.fold_known(A[0])
            if h is None:
                raise DevgenError(f"{f} with non-static handle")
            outs = [self._out_param(a, f) for a in A[1:]]
            prep = (f"(void)({ht}); " if _impure(A[0]) else "") + " ".join(
                d for d, _s in outs)
            r = svc.riff(h) if f == "file_riff" else svc.var_read(h)
            if r is None:
                return self._const(n, 0.0, prep=prep)
            vals = list(r) if f == "file_riff" else [r[1]]
            prep += " " + " ".join(st(c_double(float(v)), float(v))
                                   for (_d, st), v in zip(outs, vals))
            return self._const(n, 1.0 if f == "file_riff" else float(r[0]),
                               prep=prep)
        vals, texts = self._static_args(n, "arguments")
        if f in ("file_open", "file_open_multi"):
            return self._const(n, svc.open(vals[0] if vals else -1.0), texts)
        if f == "file_text":
            return self._const(n, 0.0, texts)
        if f == "file_mem" and len(vals) == 3:
            return self._file_mem(n, vals, texts)
        calls = {"file_close": (svc.close, 1), "file_avail": (svc.avail, 1),
                 "file_rewind": (svc.rewind, 1), "file_seek": (svc.seek, 2),
                 "file_multi_count": (svc.multi_count, 1),
                 "file_multi_select": (svc.multi_select, 2)}
        if f in calls and len(vals) >= calls[f][1]:
            fn, k = calls[f]
            return self._const(n, float(fn(*vals[:k])), texts)
        raise DevgenError(f"file builtin {f} not supported")

    def _file_mem(self, n: CallExpr, vals, texts) -> str:
        """file_mem(h, dst, want): min(want, avail) cells from the cursor,
        copied from the file table into the heap at dst."""
        dev = self.dev
        h = self.files._h(vals[0])
        if h is None or h.current is None:
            return self._const(n, 0.0, texts)
        try:
            dst = max(0, int(vals[1] + 1e-5))
            want = max(0, int(vals[2]))
        except (ValueError, OverflowError):
            return self._const(n, 0.0, texts)
        inter = h.current.audio.T.reshape(-1)
        k = min(want, max(0, len(inter) - h.cursor))
        if not k:
            return self._const(n, 0.0, texts)
        if dst + k > dev.mem_size:
            raise DevgenError(f"file_mem: static mem address {dst + k} "
                              f"beyond device heap ({dev.mem_size})")
        off = dev.tables.file_chunk(
            (h.slot, h.selected, id(h.current), h.cursor, k),
            inter[h.cursor:h.cursor + k])
        h.cursor += k
        self.static_of[id(n)] = float(k)
        keep = "".join(f"(void)({t}), " for t, a in zip(texts, n.args)
                       if _impure(a))
        return f"({keep}{dev.ops}_file_copy(S, {dst}, {off}, {k}))"

    def _clock(self, n: CallExpr) -> str:
        """time() / time_precise(): the golden host's virtual clock, static
        for a render; the optional argument receives it."""
        host = self._host()
        v = float(host.now(n.func == "time_precise")) \
            if host is not None else 0.0
        if not n.args:
            return self._const(n, v)
        decl, store = self._out_param(n.args[0], n.func)
        return self._const(n, v, prep=f"{decl} {store(c_double(v), v)}")

    def _string_call(self, n: CallExpr) -> str:
        """strlen / str_getchar: folded through the golden host where the
        arguments are static, else gathers over the literal pool."""
        texts = [self.ex(a) for a in n.args]
        vals = [self.fold(a) for a in n.args]
        host = self._host()
        if all(v is not None for v in vals):
            if host is None:
                return self._const(n, 0.0, texts)
            try:
                v = (host.strlen(self.dev.snap, vals[0]) if n.func == "strlen"
                     else host.str_getchar(self.dev.snap, vals[0], vals[1]))
            except (ValueError, OverflowError, IndexError):
                v = 0.0
            return self._const(n, float(v), texts)
        self.dev.tables.strings_of(self.dev.snap)
        if n.func == "strlen":
            return self._seq_texts(texts, n.args,
                                   lambda v: f"zb_strlen(&S->H, {v[0]})")
        return self._seq_texts(
            texts, n.args, lambda v: f"zb_str_getchar(&S->H, {v[0]}, {v[1]})")

    def _seq_texts(self, texts: Sequence[str], nodes: Sequence[Node], fmt):
        """`args` over texts already printed."""
        if len(nodes) > 1 and any(_impure(a) for a in nodes):
            return self.seq(texts, fmt)
        return fmt(texts)

    def _pool_call(self, n: CallExpr) -> str:  # noqa: C901 (one dispatch)
        """The sample pool (the reference's `_pool_call` and
        `_pool_gather_call`): with no loaded generation every call folds
        to the golden host's answer; with one, reads and per-entry queries
        gather over its packed tables, pool-level queries fold."""
        fn, A = n.func, n.args
        host = self._host()
        pool = getattr(host, "pool", None)
        gen = getattr(pool, "generation", None) if pool is not None else None
        loaded = bool(gen is not None and getattr(gen, "entries", None))
        if fn in _POOL_SETUP:
            if loaded:
                raise DevgenError(
                    f"{fn} with a loaded sample pool — a device section "
                    "cannot re-commit generations (host golden handles "
                    "pool mutation)")
            files = getattr(host, "files", None)
            if files is not None and any(files.slots.values()):
                raise DevgenError(
                    f"{fn} with populated file slots — pool setup would "
                    "load at trace time (host golden handles it)")
        if loaded and fn in ("sample_export_mem", "sample_export_mem2"):
            raise DevgenError(
                f"{fn} with a loaded pool — device heap export not "
                "implemented (host golden handles it)")
        if fn in ("sample_read2", "sample_read2_interp") and len(A) == 5:
            return self._pool_read2(n, loaded)
        if fn == "sample_preview_read" and len(A) == 6:
            return self._pool_preview(n, loaded)
        if fn == "sample_name" and len(A) >= 2:
            # the golden's host gives 0 (its dispatch has no case for it)
            return self._voids([A[0]] + list(A[2:]), "0.0")
        texts = [self.ex(a) for a in A]
        vals = [self.fold(a) for a in A]
        if host is None:
            return self._const(n, 0.0, texts)
        if all(v is not None for v in vals):
            # static arguments against a static generation: the host's
            # answer is a constant of the render
            try:
                v = float(host.sample_pool_call(self.dev.snap, fn, vals))
            except Exception:  # noqa: BLE001 (inert like the golden's host)
                v = 0.0
            return self._const(n, v, texts)
        if not loaded:
            # traced arguments over an empty pool: reads and queries are 0
            return self._const(n, 0.0, texts)
        self.dev.tables.pool_of(gen)
        if fn in _POOL_LEVEL:
            return self._const(n, float(host.sample_pool_call(
                self.dev.snap, fn, [0.0])), texts)
        if fn == "sample_get" and len(A) >= 2:
            return self._seq_texts(texts, A,
                                   lambda v: f"zb_pool_get(&S->H, {v[1]})")
        if fn in _POOL_ROW and len(A) >= 2:
            return self._seq_texts(texts, A,
                                   lambda v: _POOL_ROW[fn].format(v[1]))
        if fn in ("sample_read", "sample_read_interp") and len(A) >= 4:
            name = "zb_pool_read_interp" if fn.endswith("interp") \
                else "zb_pool_read"
            return self._seq_texts(texts, A, lambda v: (
                f"{name}(&S->H, {v[1]}, {v[2]}, {v[3]})"))
        raise DevgenError(f"loaded-pool call {fn} not supported on device")

    def _pool_read2(self, n: CallExpr, loaded: bool) -> str:
        """sample_read2{,_interp}(pool, sid, phase, l, r): the arguments,
        then the out-params' cells, then the read (zeros where it
        fails)."""
        A = n.args
        vs = [self.tmp() for _ in range(3)]
        head = " ".join(f"double {t} = ({self.ex(a)});"
                        for t, a in zip(vs, A[:3]))
        (dl, sl), (dr, sr) = (self._out_param(a, n.func) for a in A[3:])
        if not loaded:
            return (f"({{ {head} {dl} {dr} {sl('0.0', 0.0)} "
                    f"{sr('0.0', 0.0)} 0.0; }})")
        self.dev.tables.pool_of(self._host().pool.generation)
        l, r, ok = self.tmp(), self.tmp(), self.tmp()
        interp = int(n.func.endswith("interp"))
        return (f"({{ {head} {dl} {dr} double {l}, {r}; const double {ok} = "
                f"zb_pool_read2(&S->H, {vs[1]}, {vs[2]}, {interp}, &{l}, "
                f"&{r}); {sl(l)} {sr(r)} {ok}; }})")

    def _pool_preview(self, n: CallExpr, loaded: bool) -> str:
        """sample_preview_read(pool, sid, bin, min, max, rms): the golden
        writes the out-params only where the bin exists."""
        A = n.args
        vs = [self.tmp() for _ in range(3)]
        head = " ".join(f"double {t} = ({self.ex(a)});"
                        for t, a in zip(vs, A[:3]))
        outs = [self._out_param(a, n.func) for a in A[3:]]
        decls = " ".join(d for d, _s in outs)
        if not loaded:
            return f"({{ {head} {decls} 0.0; }})"
        self.dev.tables.pool_of(self._host().pool.generation)
        e = self.tmp()
        stores = " ".join(st(f"{e}[{k}]") for k, (_d, st) in enumerate(outs))
        return (f"({{ {head} {decls} const double* {e} = zb_pool_preview("
                f"&S->H, {vs[1]}, {vs[2]}); if ({e}) {{ {stores} }} "
                f"{e} ? 1.0 : 0.0; }})")

    # -- gmem and the message bus --------------------------------------------------

    def _voids(self, A: Sequence[Node], value: str) -> str:
        """The arguments evaluated in order for their effects, then value."""
        return "(" + "".join(f"(void)({self.ex(a)}), " for a in A) + value + ")"

    def _bus_call(self, fn: str, A: Sequence[Node]) -> str:
        """gmem builtins, a lockstep member's live bus, a lone instance's
        inert bus; what the reference's sets do not take is refused (K11's
        sections get no live bus: the reference's executor passes none)."""
        dev = self.dev
        if fn in GMEM_FNS:
            return self._gmem_call(fn, A)
        if fn in MSG_DEVICE_FNS and dev.msg_cfg is not None:
            return self._msg_call(fn, A)
        if fn in COMM_FNS and dev.comm_solo:
            # the golden host of a lone instance: nothing is sent or
            # received (out-params stay), every call gives 0 but the id
            value = "0.0"
            if fn == "instance_id":
                value = c_double(float(getattr(dev.snap.host,
                                               "instance_id_value", 0.0)))
            return self._voids(A, value)
        raise DevgenError(f"@{dev.section} uses {fn}(): {_BUS}")

    def _static(self, node: Node, fn: str) -> float:
        v = float(self.P.string_handle(node.text)) if isinstance(node, Str) \
            else self.fold(node)
        if v is None:
            raise DevgenError(f"{fn}: argument must fold static on the device")
        return v

    def _gmem_call(self, fn: str, A: Sequence[Node]) -> str:
        """shadow/state.py's gmem builtins on the view's segment: counts,
        and the heap side of gmem_get/gmem_put, static (as the reference's
        `_gmem_call` takes them), the segment side clamped as the golden
        clamps it."""
        dev = self.dev
        argc = {"gmem_attach": 1, "gmem_attach_size": 2, "gmem_size": 0,
                "gmem_get": 3, "gmem_put": 3, "gmem_fill": 3, "gmem_zero": 2,
                "gmem_copy": 3}[fn]
        if len(A) != argc:
            raise DevgenError(f"{fn} expects {argc} args")
        G = dev.gmem_cells
        if fn in ("gmem_attach", "gmem_attach_size"):
            if dev.comm_solo:
                return self._voids(A, "0.0")
            # a lockstep member stays on the segment the graph attached
            seg = dev.snap.host.attached_gmem
            name = self._chan_name(A[0], fn)
            size = SC.trunc_i64(self._static(A[1], fn)) if len(A) > 1 else 0
            if seg is None or name != seg.name or size > len(seg.cells):
                raise DevgenError(f"{fn}: a device section stays on the "
                                  "segment its graph attached")
            return self._voids(A, "1.0")
        if fn == "gmem_size":
            return c_double(float(G))
        n = max(0, _gidx(self._static(A[-1], fn)))
        if fn == "gmem_copy":
            d, s = (_gidx(self._static(a, fn)) for a in A[:2])
            n = min(n, G - max(d, s))
            return self._voids(A, f"zb_gmem_copy(S, {d}, {s}, {n})"
                               if n > 0 else "0.0")
        if fn in ("gmem_fill", "gmem_zero"):
            if fn == "gmem_zero":
                return self.args([A[0], A[1]], lambda v: (
                    f"zb_gmem_fill(S, {v[0]}, 0.0, {n})"))
            return self.args(A, lambda v: f"zb_gmem_fill(S, {v[0]}, {v[1]}, {n})")
        at_mem = 0 if fn == "gmem_get" else 1
        m = _gidx(self._static(A[at_mem], fn))
        if m + min(n, G) > dev.mem_size:
            raise DevgenError(f"{fn}: static mem address {m + min(n, G)} "
                              f"beyond device heap ({dev.mem_size})")
        to_mem = int(fn == "gmem_get")
        return self.args(A, lambda v: (
            f"{dev.ops}_gmem_bulk(S, {m}, {v[1 - at_mem]}, {n}, {to_mem})"))

    def _chan_name(self, node: Node, fn: str) -> str:
        """A channel (or segment) argument's name, as InstanceComm's
        `_chan_name` gives it: a string's text, else the numeric repr."""
        if isinstance(node, Str):
            return node.text
        return self.dev.handle_name(self._static(node, fn))

    def _msg_call(self, fn: str, A: Sequence[Node]) -> str:
        """A lockstep member's live bus (comm/bus.py's semantics): sends
        into the heap's OUT table, receives from its queues, the topology
        folded against the frozen registry."""
        dev = self.dev
        host = dev.msg_cfg.host
        argc = {"instance_id": 0, "msg_peer_count": 2, "msg_peer_id": 3,
                "msg_peer_caps": 1, "msg_peer_alive": 1, "msg_send": 6,
                "msg_sendto": 7, "msg_recv": 7}.get(fn, 1)
        if len(A) != argc:
            raise DevgenError(f"{fn} expects {argc} args")
        if fn == "instance_id":
            return c_double(float(host.instance_id_value))
        if fn in ("msg_peer_caps", "msg_peer_alive"):
            ids = sorted(host.domain.instances)
            vals = [float(host.domain.instances[i].caps) if fn ==
                    "msg_peer_caps" else 1.0 for i in ids]
            return self._pick(A[0], ids, vals)
        if fn in ("msg_peer_count", "msg_peer_id"):
            name = self._chan_name(A[0], fn)
            try:
                role = int(self._static(A[1], fn))
            except (ValueError, OverflowError):
                if fn == "msg_peer_id":
                    return self._voids(A, "0.0")
                role = 3
            peers = host.domain.peers_for(name, role,
                                          exclude=host.instance_id_int)
            if fn == "msg_peer_count":
                return c_double(float(len(peers)))
            return self._pick(A[2], list(range(len(peers))),
                              [float(p) for p in peers])
        cid = dev.msg_cfg.intern(self._chan_name(A[0 if fn != "msg_sendto"
                                                    else 1], fn))
        if fn == "msg_send":
            return self.args(A[1:], lambda v: (
                f"zb_msg_send(S, {cid}.0, {', '.join(v)})"))
        if fn == "msg_sendto":
            return self.args([A[0]] + list(A[2:]), lambda v: (
                f"zb_msg_sendto(S, {v[0]}, {cid}.0, {', '.join(v[1:])})"))
        if fn == "msg_dropped":
            return c_double(float(host.dropped.get(self._chan_name(A[0], fn),
                                                   0)))
        qb = dev.msg_queues.get(cid)
        if qb is None:
            raise DevgenError(f"{fn}: channel not in the static receive set "
                              "of this section")
        if fn == "msg_avail":
            return f"S->M[{qb + 1}]"
        if fn == "msg_kind":       # only scalar messages reach a device queue
            return f"(S->M[{qb + 1}] > 0.0 ? 1.0 : 0.0)"
        if fn == "msg_length":
            return f"(S->M[{qb + 1}] > 0.0 ? 4.0 : 0.0)"
        if fn == "msg_clear":
            return f"zb_msg_clear(S, {qb})"
        return self._msg_recv(A, qb)

    def _pick(self, node: Node, keys: Sequence[int],
              vals: Sequence[float]) -> str:
        """vals[keys.index(int(x))] for x = node's value, 0 where int(x)
        fails or is not a key (a peer id, a peer list's index)."""
        k = self.tmp()
        arms = "".join(f"{k} == {key} ? {c_double(v)} : "
                       for key, v in zip(keys, vals))
        return (f"({{ const long long {k} = zb_int_or(({self.ex(node)}), "
                f"-1); ({arms}0.0); }})")

    def _msg_recv(self, A: Sequence[Node], qb: int) -> str:
        """msg_recv(chan, src, tag, a, b, c, d): the out-params' cells are
        found first (the golden's order), written only when a message
        arrives."""
        decls, outs = [], []
        for a in A[1:]:
            o = self.tmp()
            if isinstance(a, Name) and a.ident not in ("mem", "gmem"):
                decls.append(f"double* {o} = &({self.lvalue(a.ident)});")
            elif isinstance(a, Mem) and not self._is_gmem(a):
                at = self.static_addr(a.base, a.index)
                if at is None:
                    b, i = self.tmp(), self.tmp()
                    decls.append(f"double {b} = ({self.ex(a.base)}); "
                                 f"double {i} = ({self.ex(a.index)});")
                    at = f"zb_addr(S, {b}, {i})"
                decls.append(f"double* {o} = &S->M[{at}];")
            else:
                raise DevgenError("msg_recv: out-arg must be a variable or "
                                  "mem[] slot")
            outs.append(o)
        e = self.tmp()
        stores = " ".join(f"*{o} = {e}[{k}];" for k, o in enumerate(outs))
        return (f"({{ {' '.join(decls)} const double* {e} = zb_msg_pop(S, "
                f"{qb}); if ({e}) {{ {stores} }} {e} ? 1.0 : 0.0; }})")

    def _size(self, fn: str, node: Node) -> int:
        v = self.fold(node)
        if v is None:
            raise DevgenError(f"{fn} with non-static size")
        return FO._round_index(v)

    def _fft_sizes(self, fn: str, n: int) -> int:
        """Note a transform of size n (its permutation table, twiddles and
        workspace); returns the size of its permutation table."""
        dev = self.dev
        complex_n = n // 2 if fn in ("fft_real", "ifft_real") else n
        dev._perm_sizes.add(complex_n)
        if fn != "fft_permute" and fn != "fft_ipermute":
            dev.fft_max = max(dev.fft_max, n)
        dev.scratch_cells = max(dev.scratch_cells, 2 * n)
        return complex_n

    def _fft(self, fn: str, A: Sequence[Node]) -> str:
        n = self._size(fn, A[1])
        dest = self.ex(A[0])
        if not FO._pow2_ok(n):
            return f"((void)({dest}), 0.0)"   # the WDL guard: a no-op
        span = n if fn in ("fft_real", "ifft_real") else 2 * n
        self._static_region(fn, A[0], span)
        perm = f"zb_perm_{self._fft_sizes(fn, n)}"
        ops = self.dev.ops
        if fn in ("fft_permute", "fft_ipermute"):
            flag = "true" if fn == "fft_ipermute" else "false"
            return f"{ops}_fft_permute(S, {dest}, {n}, {perm}, {flag})"
        return f"{ops}_{fn}(S, {dest}, {n}, {perm})"

    def _convolve(self, A: Sequence[Node]) -> str:
        n = self._size("convolve_c", A[2])
        if n <= 0 or n > FO.PAGE_DOUBLES // 2:
            return self.args(A[:2], lambda v: f"((void){v[0]}, (void){v[1]}, 0.0)")
        self._static_region("convolve_c", A[0], 2 * n)
        self._static_region("convolve_c", A[1], 2 * n)
        self.dev.scratch_cells = max(self.dev.scratch_cells, 2 * n)
        ops = self.dev.ops
        return self.args(A[:2],
                         lambda v: f"{ops}_convolve_c(S, {v[0]}, {v[1]}, {n})")

    def _static_region(self, fn: str, dest: Node, span: int) -> None:
        """A reduced heap's static FFT region past the heap (inside one
        page) raises, as the reference's does: the golden grows its heap
        for the call, and the executor's ladder climbs."""
        d = self.fold(dest)
        if not self.dev.reduced_heap or d is None:
            return
        base = max(0, FO._round_index(d))
        if FO._same_page(base, span) and base + span > self.dev.mem_size:
            raise DevgenError(f"{fn}: static mem address {base + span} "
                              f"beyond device heap ({self.dev.mem_size})")

    def _midirecv(self, A: Sequence[Node]) -> str:
        if len(A) not in (3, 4):
            raise DevgenError("midirecv expects 3 or 4 args")
        refs = []
        for a in A:
            if not isinstance(a, Name):
                raise DevgenError("midirecv out-param must be a variable")
            refs.append(self.lvalue(a.ident))
        dev = self.dev
        dev.uses_midi_in = True
        e = self.tmp()
        vals = [f"{e}[{k}]" for k in range(len(A))]
        if len(A) == 3:
            vals[2] = f"{e}[2] + {e}[3] * 256.0"
        stores = " ".join(f"{r} = {v};" for r, v in zip(refs, vals))
        pos = dev.slots[("var", MIDI_POS_SLOT)]
        return (f"({{ const double* {e} = zb_midirecv(S, &{dev.vrow}[{pos}]); "
                f"if ({e}) {{ {stores} }} {e} ? 1.0 : 0.0; }})")

    def _pending(self, fn: str, A: Sequence[Node]) -> str:
        slot = {k: self.dev.slots[("var", nm)]
                for k, nm in zip(("chg", "auto", "end"), PENDING_SLOT_NAMES)}
        mask = self._mask_arg(A[0])
        V = self.dev.vrow
        if fn == "sliderchange":
            return f"zb_pend_or(&{V}[{slot['chg']}], {mask})"
        end = self.ex(A[1]) if len(A) > 1 else "0.0"
        m, e = self.tmp(), self.tmp()
        return (f"({{ double {m} = ({mask}); double {e} = ({end}); "
                f"zb_pend_or(&{V}[z_true({e}) ? {slot['end']} : "
                f"{slot['auto']}], {m}); }})")


class Phase(NamedTuple):
    """One phase of a section.  `solo` is thread 0's C: a run of serial
    statements, or what a block phase needs first (its arguments, its
    region, its run-time checks).  `team` is what every thread of the
    file's block then runs ("" for a serial phase), `steps` the barriers
    it passes.

    A "while" or "repeat" phase (a loop whose body holds block work) runs
    `solo` to decide the first pass, then, while every thread finds
    `test` true, the phases of `body` and thread 0's `again` (the next
    pass's decision); its barriers vary with the run (steps 0)."""
    kind: str     # "serial", "loop", "fft", "copy", "while" or "repeat"
    label: str
    solo: str
    team: str
    steps: int = 0
    body: Tuple["Phase", ...] = ()
    test: str = ""
    again: str = ""


class _KeepSerial(Exception):
    """Why a top-level loop stays on thread 0."""


# a write's offset c and a read's mask M stay below 2^31: the cells
# base + iv + c stay exact integers, and z_and's int32 of M is M itself
_EXACT_OFFSET = float(1 << 31)


def _shape(n) -> Any:
    """A node's structure without positions: equal shapes print equal C
    and, where pure, give equal values."""
    if isinstance(n, Name):
        return ("Name", _env_key(n.ident))
    if isinstance(n, Node):
        return (type(n).__name__,) + tuple(
            _shape(getattr(n, f.name)) for f in fields(n)
            if f.name not in ("pos", "nid"))
    if isinstance(n, list):
        return tuple(_shape(x) for x in n)
    return n


def _unit_increment(st: Node) -> Optional[str]:
    """`i += 1` / `i = i + 1` / `i = 1 + i` -> 'i' (the reference's
    `_match_unit_increment`)."""
    if not (isinstance(st, Asn) and isinstance(st.target, Name)):
        return None
    iv = st.target.ident
    one = lambda n: isinstance(n, Const) and n.value == 1.0  # noqa: E731
    mine = lambda n: isinstance(n, Name) and n.ident == iv  # noqa: E731
    if st.op == "+=" and one(st.value):
        return iv
    if st.op == "=" and isinstance(st.value, Bin) and st.value.op == "+" \
            and ((mine(st.value.lhs) and one(st.value.rhs))
                 or (one(st.value.lhs) and mine(st.value.rhs))):
        return iv
    return None


class _BlockLoop:
    """A `loop(count, body)` or a counted `while (iv < e) body` (or `<=`)
    at statement level, run across the block.

    Print-time checks (else _KeepSerial): the body is assignments ending in
    `iv += 1`, the only assignment of iv; every other name it assigns is
    written before it is read in an iteration (a thread's own temporary,
    stored by the thread that runs the last iteration) and is no
    parameter of a function printed in place; no call with an effect, no
    nested loop, block or `&&`/`||`; every heap write is `base[iv + c]`
    with a loop-invariant base and an integer c, one c a base; every heap
    read is a cell some write of the same iteration writes, or has cells
    thread 0 can bound on the run's values: `C[iv + c]` over the trip,
    `C[e & M]` in [C, C + M] for a constant M >= 0, a loop-invariant
    address.  A `while`'s condition compares iv with a pure loop-invariant
    bound.  Thread 0 then checks the run's values (see `solo`) and runs the
    loop itself where they fail."""

    def __init__(self, dev: "DeviceSection", g: "_SectionC", loop: Node):
        self.dev, self.g, self.loop = dev, g, loop
        body = loop.body.items if isinstance(loop.body, Block) \
            else [loop.body]
        iv = _unit_increment(body[-1]) if body else None
        if iv is None:
            raise _KeepSerial("the body does not end in iv += 1")
        if not all(isinstance(it, Asn) for it in body):
            raise _KeepSerial("a statement of the body is no assignment")
        self.items = body
        self.iv = _env_key(iv)
        if self.iv not in dev.slots or iv in g.params:
            raise _KeepSerial(f"the induction {iv} has no var slot")
        temps: List[Any] = []
        for it in body[:-1]:
            if isinstance(it.target, Name):
                key = _env_key(it.target.ident)
                if key == self.iv:
                    raise _KeepSerial(f"{iv} is assigned in the body")
                if it.target.ident in g.params:
                    raise _KeepSerial(f"a write to the parameter "
                                      f"{it.target.ident}")
                if key not in temps:
                    temps.append(key)
            elif not isinstance(it.target, Mem):
                raise _KeepSerial("an assignment to slider() or spl()")
        self.temps = temps
        self.changing = set(temps) | {self.iv}
        for it in body:
            self._pure(it.value)
            self._pure(it.target)
        self._temps_written_first()
        # a while's bound and compare: (e, `<=`)
        self.bound: Optional[Tuple[Node, bool]] = None
        if isinstance(loop, WhileStmt):
            c = loop.pred
            if not (isinstance(c, Bin) and c.op in ("<", "<=")
                    and isinstance(c.lhs, Name)
                    and _env_key(c.lhs.ident) == self.iv
                    and c.lhs.ident not in g.params):
                raise _KeepSerial(f"the condition is not {iv} < e or "
                                  f"{iv} <= e")
            self._pure(c.rhs)
            if not self._invariant(c.rhs):
                raise _KeepSerial("the bound changes in the loop")
            self.bound = (c.rhs, c.op == "<=")
        # heap writes: (base shape, c) -> (base, c)
        self.writes: Dict[Tuple[Any, int], Tuple[Node, int]] = {}
        for it in body[:-1]:
            if isinstance(it.target, Mem):
                self._write(it.target)
        self.reads: List[Tuple[str, Node, Any]] = []   # (form, base, extra)
        for it in body:
            for part in (it.value, it.target):
                for m in walk(part):
                    if isinstance(m, Mem) and m is not it.target:
                        self._read(m)

    # -- print-time checks -------------------------------------------------------

    def _pure(self, node: Node) -> None:
        for n in walk(node):
            if isinstance(n, Asn):
                raise _KeepSerial("an assignment inside an expression")
            if isinstance(n, CallExpr) and n.func in _BUS_FNS:
                raise _KeepSerial(f"gmem or the message bus: {n.func}()")
            if isinstance(n, CallExpr) and (n.func not in _PURE_CALLS
                                            or n.func in self.dev.P.fn_defs):
                raise _KeepSerial(f"a call with an effect: {n.func}()")
            if not isinstance(n, (Asn, Bin, CallExpr, Cond, Const, Mem, Name,
                                  Str, Un)):
                raise _KeepSerial(f"a nested {type(n).__name__}")
            if isinstance(n, Bin) and n.op in ("&&", "||"):
                raise _KeepSerial(f"a short-circuit {n.op}")
            if isinstance(n, Mem) and self.g._is_gmem(n):
                raise _KeepSerial("gmem")

    def _temps_written_first(self) -> None:
        written: Set[Any] = set()
        for it in self.items[:-1]:
            parts = [it.value] + ([it.target] if isinstance(it.target, Mem)
                                  or it.op != "=" else [])
            for part in parts:
                for n in walk(part):
                    if isinstance(n, Name) and _env_key(n.ident) in \
                            self.temps and _env_key(n.ident) not in written:
                        raise _KeepSerial(f"{n.ident} is read before it is "
                                          "written in an iteration")
            if isinstance(it.target, Name):
                written.add(_env_key(it.target.ident))

    def _invariant(self, node: Node) -> bool:
        return not any(isinstance(n, Mem) or (
            isinstance(n, Name) and _env_key(n.ident) in self.changing)
            for n in walk(node))

    def _offset(self, idx: Node) -> Optional[int]:
        """c where idx is iv, iv + c, c + iv or iv - c with c an integer
        constant; else None."""
        def is_iv(n):
            return isinstance(n, Name) and _env_key(n.ident) == self.iv

        if is_iv(idx):
            return 0
        if not isinstance(idx, Bin) or idx.op not in ("+", "-"):
            return None
        if is_iv(idx.lhs):
            k, sign = idx.rhs, (1 if idx.op == "+" else -1)
        elif is_iv(idx.rhs) and idx.op == "+":
            k, sign = idx.lhs, 1
        else:
            return None
        c = self.g.fold(k)
        if c is None or c != np.floor(c) or abs(c) >= _EXACT_OFFSET:
            return None
        return sign * int(c)

    def _write(self, m: Mem) -> None:
        c = self._offset(m.index)
        if c is None or not self._invariant(m.base):
            raise _KeepSerial("a heap write that is not base[iv + c] with "
                              "a loop-invariant base")
        shape = _shape(m.base)
        if any(s == shape and k != c for s, k in self.writes):
            raise _KeepSerial("writes to one base at two offsets")
        self.writes[(shape, c)] = (m.base, c)

    def _read(self, m: Mem) -> None:
        g = self.g
        if g.static_addr(m.base, m.index) is not None:
            self.reads.append(("cell", m.base, m.index))
            return
        if not self._invariant(m.base):
            raise _KeepSerial("a heap read with a base the loop changes")
        c = self._offset(m.index)
        if c is not None:
            shape = _shape(m.base)
            if (shape, c) in self.writes:
                return              # the cell a write of this iteration writes
            if any(s == shape for s, _k in self.writes):
                raise _KeepSerial("a read of another iteration's cell "
                                  "(base[iv + c] beside a write at another c)")
            self.reads.append(("trip", m.base, m.index))
            return
        ix = m.index
        if isinstance(ix, Bin) and ix.op == "&":
            for k in (ix.rhs, ix.lhs):
                v = g.fold(k)
                if v is not None and v == np.floor(v) and \
                        0 <= v < _EXACT_OFFSET:
                    self.reads.append(("mask", m.base, v))
                    return
        if self._invariant(ix):
            self.reads.append(("cell", m.base, m.index))
            return
        raise _KeepSerial("a heap read whose cells cannot be bounded")

    # -- the C ---------------------------------------------------------------------

    def phase(self) -> Phase:
        dev, g = self.dev, self.g
        q, p = dev._publish(2), dev._publish_double(1)
        names = {self.iv: "zi"}
        names.update({k: f"zl{j}" for j, k in enumerate(self.temps)})
        gl = _SectionC(dev, local=names)
        gl.params = g.params
        spans = len(self.writes) + len(self.reads)
        checks = []
        for j, (base, c) in enumerate(self.writes.values()):
            checks.append(f"zok = zok && zb_unit_span(S, ({g.ex(base)}), zs, "
                          f"{c_double(float(c))}, zn, &zlo[{j}], &zhi[{j}]);")
        for j, (form, base, extra) in enumerate(self.reads, len(self.writes)):
            at = f"&zlo[{j}], &zhi[{j}]"
            if form == "trip":
                ix = gl.ex(extra)
                checks.append(
                    f"zok = zok && ({{ double zi = zs; const double za = "
                    f"({ix}); zi = zs + (double)(zn - 1); const double zb = "
                    f"({ix}); zb_read_span(S, ({g.ex(base)}), za, zb, {at}); "
                    "});")
            elif form == "mask":
                checks.append(f"zok = zok && zb_read_span(S, ({g.ex(base)}), "
                              f"0.0, {c_double(extra)}, {at});")
            else:
                a = g.static_addr(base, extra)
                cell = str(a) if a is not None else \
                    f"zb_addr(S, ({g.ex(base)}), ({g.ex(extra)}))"
                checks.append(f"zlo[{j}] = zhi[{j}] = {cell};")
        nw = len(self.writes)
        for a in range(nw):
            for b in range(a + 1, spans):
                checks.append(f"zok = zok && zb_apart(zlo[{a}], zhi[{a}], "
                              f"zlo[{b}], zhi[{b}]);")
        slot = dev.slots[self.iv]
        spans_c = (f"long long zlo[{spans}], zhi[{spans}]; "
                   f"if (zok && zn > 0) {{ {' '.join(checks)} }} "
                   if spans else "")
        if self.bound is None:
            head = (f"const long long zn = zt_i64({g.ex(self.loop.count)}); "
                    f"const double zs = S->V[{slot}]; bool zok = "
                    "zb_trip_ok(zs, zn); ")
            alone = (f"for (long long zk = 0; zk < zn; ++zk) "
                     f"{{ (void)({g.ex(self.loop.body)}); }}")
        else:
            # the trips of the golden's compare from iv's value, -1 where
            # the values iv + k leave the exact integers
            e, le = self.bound
            head = (f"const double zs = S->V[{slot}]; const long long zn = "
                    f"zb_while_trips(zs, ({g.ex(e)}), {int(le)}); "
                    "bool zok = zn >= 0; ")
            alone = g.stmt(self.loop)
        solo = (
            f"{{ {head}{spans_c}"
            f"zq[{q}] = zn; zq[{q + 1}] = zok ? 1 : 0; zp[{p}] = zs; "
            f"if (!zok) {{ zb_count_serial(S); {alone} }} }}")
        decl = "".join(f" double {nm} = 0.0;" for k, nm in names.items()
                       if k != self.iv)
        body = " ".join(f"(void)({gl.ex(it)});" for it in self.items)
        stores = " ".join(f"S->V[{dev.slots[k]}] = {nm};"
                          for k, nm in names.items())
        team = (
            f"ZB_STEPS(team, if (zq[{q + 1}]) {{ const long long zn = "
            f"zq[{q}]; const double zs = zp[{p}]; "
            "for (long long zk = t; zk < zn; zk += nt) { "
            f"double zi = zk == 0 ? zs : zs + (double)zk;{decl} {body} "
            f"if (zk == zn - 1) {{ {stores} }} }} }});")
        return Phase("loop", f"loop over {self.iv[1]}", solo, team, 1)


class DeviceSection:
    """One EEL2 section printed as a device function over (vars, mem)."""

    def __init__(self, program: PluginProgram, snapshot, section: str,
                 dynamic_keys: Set[Any], mem_size: int,
                 body: Optional[Sequence[Node]] = None,
                 reduced_heap: bool = False, rand_pool: int = 0,
                 msg_cfg: Optional[MsgConfig] = None,
                 layout_bodies: Optional[Sequence[Sequence[Node]]] = None,
                 tables: Optional[HostTables] = None):
        """body: an explicit statement list (the hop body extracted from
        @sample, printed as the section "sample-hop") in place of the
        named section's.  reduced_heap: the sequential executor's heap
        addressing and its high-water slot; rand_pool: the size of the
        staged draw pool rand() reads (0: rand() is refused);
        msg_cfg: the live bus of a graph's lockstep member (ignored where
        the snapshot's host is no live InstanceComm: a lone instance's
        bus folds inert, and on a reduced heap); layout_bodies: the
        statement lists whose gmem, MIDI out and receive channels lay out
        the heap's tail (default this section's; sections that share one
        heap are each given all of theirs: @block and the @slider it
        retriggers, every section of the sequential executor, as the
        reference's force_gmem and force_midi_out do); tables: the program's HostTables,
        shared by the sections of one program (default: this section's
        own)."""
        self.P = program
        self.tables = tables if tables is not None else HostTables()
        self.snap = snapshot
        self.section = section
        self.mem_size = int(mem_size)
        self.reduced_heap = bool(reduced_heap)
        self.rand_pool = int(rand_pool)
        if self.rand_pool and not self.reduced_heap:
            raise ValueError("a draw pool comes with the reduced heap (K11)")
        self.uses_rand = False
        # how the printed C reaches the state: K10's ZB view (vars S->V,
        # heap S->M) or, on a reduced heap, K11's (csrc/block_ops.cuh ZX):
        # the var row V passed beside the view, the heap's first page S->P,
        # the zx_ helpers
        if self.reduced_heap:
            self.fn_kw, self.view, self.view_args = \
                "ZX_DEV", "ZX* S, double* __restrict__ V", "S, V"
            self.vrow, self.ops = "V", "zx"
        else:
            self.fn_kw, self.view, self.view_args = "ZB_DEV", "ZB* S", "S"
            self.vrow, self.ops = "S->V", "zb"
        self.body = list(body) if body is not None \
            else list(program.sections.get(section, []))
        host = getattr(snapshot, "host", None)
        self.comm_solo = (not isinstance(host, InstanceComm)
                          or bool(getattr(host, "comm_solo", False)))
        self.msg_cfg = msg_cfg if (msg_cfg is not None and not self.comm_solo
                                   and not self.reduced_heap) else None
        self._layout(layout_bodies or [self.body])

        # slot table, the reference's order: dynamic vars, every
        # specialized function's params (one slot each; the C functions
        # take them as arguments), then the pseudo slots
        keys = sorted((k for k in dynamic_keys if k[0] != "builtin"),
                      key=repr)
        self.slots: Dict[Any, int] = {k: i for i, k in enumerate(keys)}
        for fname, fdef in program.fn_defs.items():
            for p in fdef.params:
                self.slots[("param", fname, p)] = len(self.slots)
        names = PENDING_SLOT_NAMES + (MIDI_POS_SLOT, RAND_POS_SLOT)
        if self.reduced_heap:
            names += (MEM_HIWATER_SLOT,)
        for nm in names:
            self.slots[("var", nm)] = len(self.slots)
        self.n_vars = len(self.slots)

        # what printing the body finds
        self.uses_midi_in = False
        self.fft_max = 0          # largest transform: the twiddle table's n
        self.scratch_cells = 0    # FFT workspace a file
        self._perm_sizes: Set[int] = set()
        self._used_fns: Set[str] = set()
        self._ntmp = 0
        self.fn_name = f"zb_section_{_mangle_c(section)}"
        g = _SectionC(self)
        stmts = " ".join(g.stmt(s) for s in self.body)
        self.body_source = (f"{self.fn_kw} void {self.fn_name}({self.view}) "
                            f"{{ {stmts} }}")
        # the phases: what thread 0 shares with the block (`zq` integers,
        # `zp` doubles, in shared memory on the card), and why each
        # top-level loop that stays serial does
        self.n_pub = 0
        self.n_pub_double = 0
        self.serial_loops: List[str] = []
        self.phases = self._print_phases()
        self.functions = self._print_functions()

    def _layout(self, bodies: Sequence[Sequence[Node]]) -> None:
        """The heap row, the reference's layout (its devgen.py:269-331):
        [plugin heap | gmem window | MIDI out table | msg OUT table | msg
        IN region], each part present where a section uses it."""
        self.uses_gmem = self._detect(
            bodies, lambda n: (isinstance(n, Mem) and isinstance(n.base, Name)
                               and n.base.ident == "gmem")
            or (isinstance(n, CallExpr) and n.func in GMEM_FNS))
        self.gmem_base = self.mem_size
        self.gmem_cells = len(self.snap.gmem) if self.uses_gmem else 0
        self.uses_midi_out = self._detect(
            bodies, lambda n: isinstance(n, CallExpr) and n.func == "midisend")
        # the MIDI out table: [count | CAP rows of 4]
        self.midi_out_base = self.gmem_base + self.gmem_cells
        self.midi_out_cells = (1 + MIDI_OUT_CAP * 4) \
            if self.uses_midi_out else 0
        self.msg_out_base = self.midi_out_base + self.midi_out_cells
        self.msg_out_cells = (1 + MSG_OUT_CAP * MSG_ENT) \
            if self.msg_cfg is not None else 0
        self.msg_in_base = self.msg_out_base + self.msg_out_cells
        self.msg_queues: Dict[int, int] = {}   # channel id -> queue base
        off = self.msg_in_base
        if self.msg_cfg is not None:
            off += 1                            # the drop cell
            for name in self._recv_channel_names(bodies):
                self.msg_queues[self.msg_cfg.intern(name)] = off
                off += 2 + MSG_QUEUE_CAP * MSG_QENT
        self.msg_in_cells = off - self.msg_in_base
        self.total_mem = off

    def _detect(self, bodies, hit) -> bool:
        """Whether hit(node) holds for a node of the bodies or of a user
        function they call."""
        return any(hit(n) for n in reach(self.P, bodies))

    def _recv_channel_names(self, bodies) -> List[str]:
        """The receive channels the bodies name statically, in source order
        (the reference's `_msg_recv_channel_names`): each gets a queue."""
        names: List[str] = []
        for n in reach(self.P, bodies):
            if not (isinstance(n, CallExpr) and n.func in _MSG_RECV_SIDE
                    and n.args):
                continue
            a, nm = n.args[0], None
            if isinstance(a, Str):
                nm = a.text
            elif isinstance(a, Name):
                try:
                    nm = self.handle_name(self._snap_value(_env_key(a.ident)))
                except AssertionError:
                    nm = None
            elif isinstance(a, Const):
                nm = self.handle_name(float(a.value))
            if nm is not None and nm not in names:
                names.append(nm)
        return names

    def handle_name(self, handle: float) -> str:
        """InstanceComm's `_chan_name` of a handle: its interned text, else
        the numeric repr (numeric channel handles are legal)."""
        text = self.snap.string_for_handle(float(handle))
        return text if text is not None else repr(float(handle))

    def cell(self, a: int) -> str:
        """Static heap cell a (below the heap): K11 keeps the first
        PAGE_CELLS on chip."""
        if self.reduced_heap and a < PAGE_CELLS:
            return f"S->P[{a}]"
        return f"S->M[{a}]"

    def _publish(self, k: int) -> int:
        self.n_pub += k
        return self.n_pub - k

    def _publish_double(self, k: int) -> int:
        self.n_pub_double += k
        return self.n_pub_double - k

    def _print_phases(self) -> List[Phase]:
        """The section's statements as phases, in source order (the
        module's docstring).  A reduced heap's section (K11) runs on one
        thread and has none."""
        if self.reduced_heap:
            return []
        return self._phases_of(_SectionC(self), self.body, ())

    def _phases_of(self, g: _SectionC, stmts: Sequence[Node],
                   fns: Tuple[str, ...]) -> List[Phase]:
        """Statements at statement level as phases: runs of serial
        statements and block phases.  g prints them; fns are the user
        functions printed in place around them."""
        phases: List[Phase] = []
        run: List[str] = []

        def serial() -> None:
            if run:
                phases.append(Phase("serial", f"{len(run)} statements",
                                    " ".join(run), ""))
                run.clear()
        for s in stmts:
            got = self._stmt_phases(g, s, fns)
            if got is None:
                run.append(g.stmt(s))
                continue
            serial()
            phases.extend(got)
        serial()
        return phases

    def _stmt_phases(self, g: _SectionC, s: Node,
                     fns: Tuple[str, ...]) -> Optional[List[Phase]]:
        """s's phases where it holds block work, else None (s is then
        printed as a serial statement; nothing of it is printed here)."""
        if isinstance(s, (LoopExpr, WhileStmt)):
            try:
                loop = _BlockLoop(self, g, s)
            except _KeepSerial as why:
                if self._block_work(g, s.body, fns):
                    return [self._repeat_phase(g, s, fns)]
                kind = "while" if isinstance(s, WhileStmt) else "loop"
                self.serial_loops.append(f"{kind} at line {s.pos[0]}: {why}")
                return None
            ph = loop.phase()
            g.forget(s)
            return [ph]
        if not self._block_work(g, s, fns):
            return None
        if isinstance(s, Block):
            return self._phases_of(g, s.items, fns)
        if s.func in self.P.fn_defs:
            return self._inline(g, s, fns)
        return [self._fft_phase(g, s) or self._copy_phase(g, s)]

    def _block_work(self, g: _SectionC, s: Node,
                    fns: Tuple[str, ...]) -> bool:
        """Whether s, at statement level, prints a block phase (decided
        without printing it)."""
        if isinstance(s, Block):
            return any(self._block_work(g, x, fns) for x in s.items)
        if isinstance(s, (LoopExpr, WhileStmt)):
            try:
                _BlockLoop(self, g, s)
                return True
            except _KeepSerial:
                return self._block_work(g, s.body, fns)
        if not isinstance(s, CallExpr):
            return False
        if s.func in self.P.fn_defs:
            proto = self.P.fn_defs[s.func]
            return s.func not in fns and self._block_work(
                _SectionC(self, proto.params, in_function=True), proto.body,
                fns + (s.func,))
        return (self._fft_size(g, s) is not None
                or (s.func in ("memcpy", "memset") and len(s.args) == 3))

    def _fft_size(self, g: _SectionC, s: CallExpr) -> Optional[int]:
        """The size of a static FFT call that runs in block form, else
        None (another call, or the WDL no-op of a bad size)."""
        fn, A = s.func, s.args
        if fn in self.P.fn_defs:
            return None
        if fn in _FFT_FNS and len(A) == 2:
            n = g._size(fn, A[1])
            return n if FO._pow2_ok(n) else None
        if fn == "convolve_c" and len(A) == 3:
            n = g._size(fn, A[2])
            return n if 0 < n <= FO.PAGE_DOUBLES // 2 else None
        return None

    def _fft_phase(self, g: _SectionC, s: Node) -> Optional[Phase]:
        """A static FFT call as a block phase: thread 0 evaluates the
        arguments and decides the region (-1: the no-op), then every
        thread runs the block form."""
        if not isinstance(s, CallExpr):
            return None
        n = self._fft_size(g, s)
        if n is None:
            return None
        fn, A = s.func, s.args
        if fn != "convolve_c":
            perm = f"zb_perm_{g._fft_sizes(fn, n)}"
            span = n if fn in ("fft_real", "ifft_real") else 2 * n
            q = self._publish(1)
            solo = f"zq[{q}] = zb_fft_region(S, ({g.ex(A[0])}), {span});"
            if fn in ("fft_permute", "fft_ipermute"):
                flag = "true" if fn == "fft_ipermute" else "false"
                team = (f"zb_blk_fft_permute(S, zq[{q}], {n}, {perm}, {flag}, "
                        "team);")
                steps = 2                         # gather, copy back
            else:
                team = f"zb_blk_{fn}(S, zq[{q}], {n}, {perm}, team);"
                steps = n.bit_length() + 1        # load, log2(n) stages, store
            return Phase("fft", f"{fn}({n})", solo, team, steps)
        self.scratch_cells = max(self.scratch_cells, 2 * n)
        q = self._publish(2)
        solo = (f"{{ const double zd = ({g.ex(A[0])}); const double zs = "
                f"({g.ex(A[1])}); zq[{q}] = zb_fft_region(S, zd, {2 * n}); "
                f"zq[{q + 1}] = zb_fft_region(S, zs, {2 * n}); }}")
        team = f"zb_blk_convolve_c(S, zq[{q}], zq[{q + 1}], {n}, team);"
        return Phase("fft", f"convolve_c({n})", solo, team, 2)

    def _copy_phase(self, g: _SectionC, s: CallExpr) -> Phase:
        """memcpy or memset as a block phase: thread 0 evaluates the
        arguments (in the one-thread form's order) and resolves the runs
        as zb_memcpy and zb_memset do, then every thread copies a strided
        share.  Overlapping runs: thread 0 copies them itself (counted)
        and publishes no run."""
        q = self._publish(3)
        if s.func == "memset":
            p = self._publish_double(1)
            solo = g.args(s.args, lambda v: (
                f"zb_set_region(S, {v[0]}, {v[1]}, {v[2]}, &zq[{q}], "
                f"&zp[{p}])")) + ";"
            team = (f"ZB_STEPS(team, zb_blk_set(S, zq[{q}], zq[{q + 1}], "
                    f"zp[{p}], t, nt));")
        else:
            solo = g.args(s.args, lambda v: (
                f"zb_copy_region(S, {v[0]}, {v[1]}, {v[2]}, &zq[{q}])")) + ";"
            team = (f"ZB_STEPS(team, zb_blk_copy(S, zq[{q}], zq[{q + 1}], "
                    f"zq[{q + 2}], t, nt));")
        return Phase("copy", s.func, solo, team, 1)

    def _inline(self, g: _SectionC, s: CallExpr,
                fns: Tuple[str, ...]) -> List[Phase]:
        """A user function called as a statement, its body's phases in
        place: thread 0 binds the arguments in the shared row (the golden
        drops extra ones unevaluated and pads with 0), the locals keep
        their var slots."""
        proto = self.P.fn_defs[s.func]
        k = len(proto.params)
        p = self._publish_double(k)
        binds = [f"zp[{p + i}] = ({g.ex(a)});"
                 for i, a in enumerate(s.args[:k])]
        binds += [f"zp[{p + i}] = 0.0;" for i in range(len(binds), k)]
        g.known.clear()
        gf = _SectionC(self, (), in_function=True)
        gf.params = {name: f"zp[{p + i}]"
                     for i, name in enumerate(proto.params)}
        body = proto.body.items if isinstance(proto.body, Block) \
            else [proto.body]
        phases = self._phases_of(gf, body, fns + (s.func,))
        if binds:
            phases.insert(0, Phase("serial", f"{s.func}'s arguments",
                                   " ".join(binds), ""))
        return phases

    def _repeat_phase(self, g: _SectionC, s: Node,
                      fns: Tuple[str, ...]) -> Phase:
        """A while or loop(n) whose body holds block work: thread 0 runs
        the loop's own control (the condition, or the count and the pass
        counter) and publishes each pass's decision in the shared row;
        every thread reads it after the barrier, so all take the same
        branch, and the body's phases run inside."""
        k = self._publish(2)
        head = s.pred if isinstance(s, WhileStmt) else None
        # the one-thread form's order: a loop's count once, then the
        # passes (a while's condition each pass)
        count = g.ex(s.count) if head is None else ""
        g.forget(head)
        g.forget(s.body)
        g.repeats += 1
        try:
            if head is not None:
                solo = again = f"zq[{k}] = z_true({g.ex(head)}) ? 1 : 0;"
                test = f"zq[{k}]"
                label = f"while at line {s.pos[0]}"
            else:
                solo = f"zq[{k}] = zt_i64({count}); zq[{k + 1}] = 0;"
                again = f"zq[{k + 1}] += 1;"
                test = f"zq[{k + 1}] < zq[{k}]"
                label = f"loop at line {s.pos[0]}"
            items = s.body.items if isinstance(s.body, Block) else [s.body]
            body = self._phases_of(g, items, fns)
        finally:
            g.repeats -= 1
        g.forget(head)
        g.forget(s.body)
        kind = "while" if head is not None else "repeat"
        return Phase(kind, label, solo, "", 0, tuple(body), test, again)

    def _print_functions(self) -> Dict[str, str]:
        """{C name: definition} of every user function the body reaches."""
        out: Dict[str, str] = {}
        done: Set[str] = set()
        while self._used_fns - done:
            fn = sorted(self._used_fns - done)[0]
            done.add(fn)
            proto = self.P.fn_defs[fn]
            # a function's temporaries are its own: it prints the same in
            # every section that calls it
            self._ntmp = 0
            g = _SectionC(self, proto.params, in_function=True)
            args = "".join(f", double p_{i}" for i in range(len(proto.params)))
            name = f"uf_{_mangle_c(fn)}"
            out[name] = (f"{self.fn_kw} double {name}({self.view}{args}) "
                         f"{{ return ({g.ex(proto.body)}); }}")
        return out

    @property
    def perm_sizes(self) -> List[int]:
        return sorted(self._perm_sizes)

    # -- values ----------------------------------------------------------------

    def _frozen_value(self, key) -> float:
        """A key no section writes: its value in the snapshot."""
        if key[0] == "builtin":
            return float(getattr(self.snap, key[1]))
        return self._snap_value(key)

    def _snap_value(self, key) -> float:
        kind = key[0]
        if kind == "spl":
            return float(self.snap.spl[key[1]])
        if kind == "slider":
            return float(self.snap.sliders[key[1]])
        if kind == "var":
            return float(self.snap.V.get(key[1], 0.0))
        if kind == "param":
            return 0.0
        raise AssertionError(key)

    def initial_vars(self) -> np.ndarray:
        out = np.zeros(self.n_vars, dtype=np.float64)
        for key, slot in self.slots.items():
            out[slot] = self._snap_value(key)
        return out

    def initial_mem(self) -> np.ndarray:
        self.snap.mem_ensure(1)
        out = np.zeros(self.total_mem, dtype=np.float64)
        n = min(len(self.snap.mem), self.mem_size)
        out[:n] = self.snap.mem[:n]
        if self.gmem_cells:
            out[self.gmem_base:self.gmem_base + self.gmem_cells] = \
                self.snap.gmem[:self.gmem_cells]
        return out
