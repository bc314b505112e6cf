"""Golden CPU executor: compiles plugin ASTs to exact-semantics Python.

Each @section and specialized user function is code-generated into a Python
function (three-address style so EEL2 evaluation order is preserved), then
exec'd against the numeric helpers in semantics.scalar.  This executor is
the platform's correctness anchor: the JAX/TPU lowerings are null-tested
against it (like the reference's WDL/EEL2 shadow interpreter, ref:
src/JSFXCorrectnessCheck.h).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..frontend.astnodes import (
    Asn, Bin, Block, CallExpr, Cond, Const, IfStmt, LoopExpr, Mem, Name,
    Node, Str, Un, WhileStmt,
)
from ..ir.program import PluginProgram
from ..ir.symbols import dollar_const, slider_index, spl_index
from ..semantics import scalar as SC
from .state import HostServices, MidiEvent, ShadowState

_SLIDER_VAR_RE = re.compile(r"slider([1-9][0-9]?)$")

_MATH_ONE_ARG = {
    "sin": "eel_sin", "cos": "eel_cos", "tan": "eel_tan",
    "asin": "eel_asin", "acos": "eel_acos", "atan": "eel_atan",
    "exp": "eel_exp", "log": "eel_log", "log10": "eel_log10",
    "sqrt": "eel_sqrt", "abs": "eel_abs", "fabs": "eel_abs",
    "floor": "eel_floor", "ceil": "eel_ceil", "invsqrt": "eel_invsqrt",
}
_MATH_TWO_ARG = {"pow": "eel_pow", "atan2": "eel_atan2"}

_INERT_FUNCS = frozenset({
    "sprintf", "printf", "strcpy", "strcat", "strcmp", "str_setchar",
    "str_insert", "str_delete", "str_mid", "strncpy",
    "file_read", "file_write", "file_string",
})

_BIN_HELPERS = {
    "|": "eel_or", "&": "eel_and", "<<": "eel_shl", ">>": "eel_shr",
    "%": "eel_mod", "^": "eel_pow", "/": "eel_div",
    "<": "cmp_lt", "<=": "cmp_le", ">": "cmp_gt", ">=": "cmp_ge",
    "==": "cmp_eq", "!=": "cmp_ne",
}

# compound-assign op -> scalar function (cur, rhs) -> out
_COMPOUND = {
    "+=": lambda c, r: c + r,
    "-=": lambda c, r: c - r,
    "*=": lambda c, r: c * r,
    "/=": SC.eel_div,
    "%=": SC.eel_mod,
    "^=": SC.eel_pow,
    "|=": SC.eel_or,
    "&=": SC.eel_and,
    "~=": SC.eel_xor,
}


# ---------------------------------------------------------------------------
# runtime helpers referenced by generated code


def _mget(S, base, idx):
    a = SC.mem_address(base, idx)
    if a >= len(S.mem):
        S.mem_ensure(a + 1)
    return float(S.mem[a])


def _mset(S, val, base, idx):
    a = SC.mem_address(base, idx)
    if a >= len(S.mem):
        S.mem_ensure(a + 1)
    S.mem[a] = val
    return val


def _mrmw(S, rhs, base, idx, op):
    a = SC.mem_address(base, idx)
    if a >= len(S.mem):
        S.mem_ensure(a + 1)
    out = _COMPOUND[op](float(S.mem[a]), rhs)
    S.mem[a] = out
    return out


def _maddr(S, base, idx):
    """Resolve-and-ensure an address (for out-param pointers)."""
    a = SC.mem_address(base, idx)
    if a >= len(S.mem):
        S.mem_ensure(a + 1)
    return a


def _dyn_index(is_slider, idx):
    try:
        i = int(idx + 1.0e-5)
    except (ValueError, OverflowError):
        return None
    if is_slider:
        i -= 1
    return i if 0 <= i < 64 else None


def _dynget(S, is_slider, idx):
    i = _dyn_index(is_slider, idx)
    if i is None:
        return 0.0
    return (S.sliders if is_slider else S.spl)[i]


def _dynset(S, is_slider, idx, rhs, op):
    i = _dyn_index(is_slider, idx)
    if op == "=":
        if i is not None:
            (S.sliders if is_slider else S.spl)[i] = rhs
        return rhs
    cur = (S.sliders if is_slider else S.spl)[i] if i is not None else 0.0
    out = _COMPOUND[op](cur, rhs)
    if i is not None:
        (S.sliders if is_slider else S.spl)[i] = out
    return out


def _mask_bits(mask):
    try:
        m = int(mask)
    except (ValueError, OverflowError):
        return 0
    return m & ((1 << 64) - 1) if m > 0 else 0


def _sliderchange(S, mask):
    S.pending_change_mask |= _mask_bits(mask)
    return 0.0


def _slider_automate(S, mask, end_touch):
    bits = _mask_bits(mask)
    if SC.truthy(end_touch):
        S.pending_automate_end_mask |= bits
    else:
        S.pending_automate_mask |= bits
    return 0.0


def _slider_show(S, mask, mode, have_mode):
    if S.slider_vis_init == 0:
        S.slider_visible_mask = (1 << 64) - 1
        S.slider_vis_init = 1
    bits = _mask_bits(max(0.0, mask) if mask == mask else 0.0)
    vis = S.slider_visible_mask & ((1 << 64) - 1)
    if have_mode:
        if mode == -1.0:
            vis ^= bits
        elif mode == 0.0:
            vis &= ~bits & ((1 << 64) - 1)
        else:
            vis |= bits
        S.slider_visible_mask = vis
    return float(vis & bits)


def _slider_next_chg(S, idx, _unused=None):
    return -1.0


def _memset(S, dest_v, value, length):
    d = SC.blob_address(dest_v)
    n = max(0, SC.trunc_i64(length))
    if n > 0:
        S.mem_ensure(d + n)
        S.mem[d:d + n] = value
    return dest_v


def _memcpy(S, dest_v, src_v, length):
    d = SC.blob_address(dest_v)
    s = SC.blob_address(src_v)
    n = max(0, SC.trunc_i64(length))
    if n > 0:
        S.mem_ensure(max(d, s) + n)
        S.mem[d:d + n] = S.mem[s:s + n].copy()  # overlap-safe
    return dest_v


def _fft_call(S, which, a0, a1):
    from ..runtime import fftops
    return fftops.dispatch(S, which, a0, a1)


def _convolve_c(S, dest, src, size):
    from ..runtime import fftops
    return fftops.convolve_c(S, dest, src, size)


def _gfx_call(S, fn, args):
    """gfx_* dispatch: no-op in the DSP shadow, recorded by the UI canvas
    when one is attached to the host (gfx/interpreter.py)."""
    canvas = getattr(S.host, "gfx", None)
    if canvas is None:
        if fn == "gfx_measurestr":
            return (0.0, 0.0)
        if fn in ("gfx_getpixel", "gfx_getimgdim"):
            return (0.0, 0.0, 0.0)
        return 0.0
    return canvas.call(S, fn, args)


def _midirecv4(S):
    if S.midi_in_pos < len(S.midi_in):
        ev = S.midi_in[S.midi_in_pos]
        S.midi_in_pos += 1
        return (float(ev.offset), float(ev.b1), float(ev.b2), float(ev.b3))
    return None


def _midisend(S, ofs, b1, b2, b3):
    S.midi_out.append(MidiEvent(
        max(0, SC.trunc_i64(ofs)),
        SC.trunc_i64(b1) & 0xFF, SC.trunc_i64(b2) & 0xFF, SC.trunc_i64(b3) & 0xFF))
    return b1


# -- variable-length MIDI forms (ref JSFXJuceProcessor.cpp:2280-2433) --------

def _midi_round(v) -> int:
    """std::llround semantics: round half AWAY FROM ZERO (ref
    jsfxRoundToInt) — differs from floor(v+0.5) at negative halves
    (-1.5 -> -2, not -1)."""
    import math
    try:
        f = float(v)
        return int(math.copysign(math.floor(abs(f) + 0.5), f))
    except (ValueError, OverflowError):
        return 0


def _midi_clamp_byte(v) -> int:
    return min(255, max(0, _midi_round(v)))


def _mem_index(v) -> int:
    """ref jsfxClampMemIndex: rounded, floored at 0."""
    return max(0, _midi_round(v))


def _prepare_var_midi(bts, force_sysex: bool):
    """ref jsfxPrepareVariableMidiBytes: messages that look like sysex
    (len>3 or F0/F7 framing) get the missing F0/F7 added."""
    if not bts:
        return []
    if force_sysex or len(bts) > 3 or bts[0] == 0xF0 or bts[-1] == 0xF7:
        if bts[0] != 0xF0:
            bts = [0xF0] + bts
        if bts[-1] != 0xF7:
            bts = bts + [0xF7]
    return bts


def _queue_midi_bytes(S, ofs, bts) -> float:
    blk = int(getattr(S, "samplesblock", 0.0) or 0.0)
    off = min(max(0, _midi_round(ofs)), max(0, blk - 1))
    head = (list(bts) + [0, 0, 0])[:3]
    from .state import midi_short_length
    data = (tuple(bts) if len(bts) > 3
            or len(bts) != midi_short_length(bts[0]) else None)
    S.midi_out.append(MidiEvent(off, head[0], head[1], head[2], data))
    return float(len(bts))


def _midirecv_buf(S, buf, maxlen):
    """Pop the next input event into mem[buf..]; events longer than
    maxlen pass through to the output queue (ref :2280-2308).  Returns
    (offset, length) or None when the queue drains."""
    maxn = _midi_round(maxlen)
    if maxn <= 0:
        return None
    while S.midi_in_pos < len(S.midi_in):
        ev = S.midi_in[S.midi_in_pos]
        S.midi_in_pos += 1
        bts = ev.payload()
        if not bts:
            continue
        if len(bts) > maxn:
            S.midi_out.append(ev)
            continue
        base = _mem_index(buf)
        S.mem_ensure(base + len(bts))
        for i, b in enumerate(bts):
            S.mem[base + i] = float(b)
        return (float(ev.offset), float(len(bts)))
    return None


DYN_STRING_BASE = 1 << 41  # above the literal-table handles (1<<40 + k)


def _midirecv_str(S, handle):
    """Pop the next input event into the string variable (ref :2311-2333
    — jsfxAssignStringBytes ASSIGNS a string into the slot, so the var
    receives a handle).  A dynamic (mutable) handle already held is
    reused; otherwise a fresh one is allocated.  Returns
    (offset, length, handle) or None."""
    try:
        h = int(handle)
    except (ValueError, OverflowError):
        h = 0
    while S.midi_in_pos < len(S.midi_in):
        ev = S.midi_in[S.midi_in_pos]
        S.midi_in_pos += 1
        bts = ev.payload()
        if not bts:
            continue
        if h < DYN_STRING_BASE or S.string_for_handle(h) is None:
            h = 1 + max((k for k in S.strings_by_handle
                         if k >= DYN_STRING_BASE), default=DYN_STRING_BASE - 1)
        S.strings_by_handle[h] = "".join(chr(b & 0xFF) for b in bts)
        return (float(ev.offset), float(len(bts)), float(h))
    return None


def _midisend_buf(S, ofs, buf, ln, force_sysex=False):
    """Queue mem[buf..buf+len) as one event (ref :2361-2378 and
    midisyx :2407-2433).  The read does NOT grow the heap."""
    req = _midi_round(ln)
    if req <= 0:
        return 0.0
    base = _mem_index(buf)
    if base + req > len(S.mem):
        return 0.0
    bts = _prepare_var_midi(
        [_midi_clamp_byte(S.mem[base + i]) for i in range(req)], force_sysex)
    if not bts:
        return 0.0
    return _queue_midi_bytes(S, ofs, bts)


def _midisend_str(S, ofs, handle):
    """Queue the string's bytes as one event (ref :2380-2405)."""
    text = S.string_for_handle(handle)
    if not text:
        return 0.0
    bts = _prepare_var_midi([ord(c) & 0xFF for c in text], False)
    return _queue_midi_bytes(S, ofs, bts)


# ---------------------------------------------------------------------------
# code generator


class _Gen:
    def __init__(self, program: PluginProgram, params: Sequence[str] = ()):
        self.program = program
        self.params = {p: f"p_{i}" for i, p in enumerate(params)}
        self.lines: List[str] = []
        self.depth = 1
        self._n = 0

    def tmp(self) -> str:
        self._n += 1
        return f"_t{self._n}"

    def put(self, text: str) -> None:
        self.lines.append("    " * self.depth + text)

    # -- lvalue helpers ------------------------------------------------------

    def name_ref(self, ident: str) -> str:
        """Python expression for reading a variable (no side effects)."""
        if ident in self.params:
            return self.params[ident]
        if ident == "mem":
            return "0.0"
        if ident == "gmem":
            raise ValueError("gmem may only be used as gmem[index]")
        c = dollar_const(ident)
        if c is not None:
            return repr(c)
        i = spl_index(ident)
        if i is not None:
            return f"spl[{i}]"
        i = slider_index(ident)
        if i is not None:
            return f"sl[{i}]"
        if ident == "srate":
            return "S.srate"
        if ident == "samplesblock":
            return "S.samplesblock"
        if ident == "midi_bus":
            return "S.midi_bus"
        if ident == "ext_midi_bus":
            return "S.ext_midi_bus"
        return f"V[{ident!r}]"

    def _is_gmem(self, node: Node) -> bool:
        return isinstance(node, Mem) and isinstance(node.base, Name) \
            and node.base.ident == "gmem"

    # -- expressions ---------------------------------------------------------

    def ex(self, n: Node) -> str:
        """Emit code computing node value; return a Python expr (temp/literal)."""
        if isinstance(n, Const):
            return repr(float(n.value))
        if isinstance(n, Str):
            return repr(float(self.program.string_handle(n.text)))
        if isinstance(n, Name):
            ref = self.name_ref(n.ident)
            if ref[0].isdigit() or ref[0] in "-+.":  # literal
                return ref
            t = self.tmp()
            self.put(f"{t} = {ref}")
            return t
        if isinstance(n, Mem):
            if self._is_gmem(n):
                idx = self.ex(n.index)
                t = self.tmp()
                self.put(f"{t} = S.host.gmem_load(S, {idx})")
                return t
            b = self.ex(n.base)
            i = self.ex(n.index)
            t = self.tmp()
            self.put(f"{t} = _mget(S, {b}, {i})")
            return t
        if isinstance(n, Un):
            a = self.ex(n.operand)
            t = self.tmp()
            if n.op == "+":
                return a
            if n.op == "-":
                self.put(f"{t} = 0.0 - {a}")
            elif n.op == "!":
                self.put(f"{t} = eel_not({a})")
            else:
                raise ValueError(f"unsupported unary {n.op!r}")
            return t
        if isinstance(n, Cond):
            return self._ternary(n)
        if isinstance(n, LoopExpr):
            return self._loop(n)
        if isinstance(n, Bin):
            if n.op in ("&&", "||"):
                return self._logical(n)
            l = self.ex(n.lhs)
            r = self.ex(n.rhs)
            t = self.tmp()
            if n.op in ("+", "-", "*"):
                self.put(f"{t} = {l} {n.op} {r}")
            elif n.op in _BIN_HELPERS:
                self.put(f"{t} = {_BIN_HELPERS[n.op]}({l}, {r})")
            else:
                raise ValueError(f"unsupported binary {n.op!r}")
            return t
        if isinstance(n, Asn):
            return self._assign(n)
        if isinstance(n, CallExpr):
            return self._call(n)
        if isinstance(n, Block):
            last = "0.0"
            for item in n.items:
                if isinstance(item, IfStmt):
                    self._if(item)
                    last = "0.0"
                elif isinstance(item, WhileStmt):
                    self._while(item)
                    last = "0.0"
                else:
                    last = self.ex(item)
            return last
        if isinstance(n, IfStmt):
            self._if(n)
            return "0.0"
        if isinstance(n, WhileStmt):
            self._while(n)
            return "0.0"
        raise TypeError(f"unhandled node {type(n).__name__}")

    def _logical(self, n: Bin) -> str:
        t = self.tmp()
        l = self.ex(n.lhs)
        if n.op == "&&":
            self.put(f"if truthy({l}):")
            self.depth += 1
            r = self.ex(n.rhs)
            self.put(f"{t} = 1.0 if truthy({r}) else 0.0")
            self.depth -= 1
            self.put("else:")
            self.put(f"    {t} = 0.0")
        else:
            self.put(f"if truthy({l}):")
            self.put(f"    {t} = 1.0")
            self.put("else:")
            self.depth += 1
            r = self.ex(n.rhs)
            self.put(f"{t} = 1.0 if truthy({r}) else 0.0")
            self.depth -= 1
        return t

    def _ternary(self, n: Cond) -> str:
        t = self.tmp()
        c = self.ex(n.pred)
        self.put(f"if truthy({c}):")
        self.depth += 1
        v = self.ex(n.then)
        self.put(f"{t} = {v}")
        self.depth -= 1
        self.put("else:")
        self.depth += 1
        v = self.ex(n.other)
        self.put(f"{t} = {v}")
        self.depth -= 1
        return t

    def _loop(self, n: LoopExpr) -> str:
        t = self.tmp()
        cnt = self.ex(n.count)
        ci = self.tmp()
        self.put(f"{ci} = trunc_i64({cnt})")
        self.put(f"{t} = 0.0")
        self.put(f"for _ in range({ci} if {ci} > 0 else 0):")
        self.depth += 1
        v = self.ex(n.body)
        self.put(f"{t} = {v}")
        self.depth -= 1
        return t

    def _if(self, n: IfStmt) -> None:
        c = self.ex(n.pred)
        self.put(f"if truthy({c}):")
        self.depth += 1
        self.ex(n.then)
        self.put("pass")
        self.depth -= 1
        if n.other is not None:
            self.put("else:")
            self.depth += 1
            self.ex(n.other)
            self.put("pass")
            self.depth -= 1

    def _while(self, n: WhileStmt) -> None:
        self.put("while True:")
        self.depth += 1
        c = self.ex(n.pred)
        self.put(f"if not truthy({c}): break")
        self.ex(n.body)
        self.depth -= 1

    # -- assignment ----------------------------------------------------------

    def _assign(self, n: Asn) -> str:
        rhs = self.ex(n.value)  # rhs evaluates FIRST (ref: dsp_jsfx_aot.py:4414)
        tgt = n.target

        if isinstance(tgt, Name):
            if tgt.ident == "mem":
                raise ValueError("cannot assign to mem")
            if tgt.ident in ("gmem",):
                raise ValueError("cannot assign to gmem directly")
            ref = self.name_ref(tgt.ident)
            if n.op == "=":
                self.put(f"{ref} = {rhs}")
                return rhs
            t = self.tmp()
            if n.op in ("+=", "-=", "*="):
                self.put(f"{t} = {ref} {n.op[0]} {rhs}")
            else:
                helper = {"/=": "eel_div", "%=": "eel_mod", "^=": "eel_pow",
                          "|=": "eel_or", "&=": "eel_and", "~=": "eel_xor"}[n.op]
                self.put(f"{t} = {helper}({ref}, {rhs})")
            self.put(f"{ref} = {t}")
            return t

        if isinstance(tgt, Mem):
            if self._is_gmem(tgt):
                idx = self.ex(tgt.index)
                t = self.tmp()
                if n.op == "=":
                    self.put(f"{t} = S.host.gmem_store(S, {idx}, {rhs})")
                else:
                    cur = self.tmp()
                    self.put(f"{cur} = S.host.gmem_load(S, {idx})")
                    out = self.tmp()
                    self.put(f"{out} = _COMPOUND[{n.op!r}]({cur}, {rhs})")
                    self.put(f"{t} = S.host.gmem_store(S, {idx}, {out})")
                return t
            b = self.ex(tgt.base)
            i = self.ex(tgt.index)
            t = self.tmp()
            if n.op == "=":
                self.put(f"{t} = _mset(S, {rhs}, {b}, {i})")
            else:
                self.put(f"{t} = _mrmw(S, {rhs}, {b}, {i}, {n.op!r})")
            return t

        if isinstance(tgt, CallExpr) and tgt.func in ("slider", "spl") and len(tgt.args) == 1:
            idx = self.ex(tgt.args[0])
            t = self.tmp()
            is_slider = tgt.func == "slider"
            self.put(f"{t} = _dynset(S, {is_slider}, {idx}, {rhs}, {n.op!r})")
            return t

        raise ValueError("invalid assignment target")

    # -- out-parameter (lvalue) plumbing ------------------------------------

    def _lv_prepare(self, node: Node, api: str):
        """Resolve an out-lvalue before a call; returns a store callback."""
        if isinstance(node, Name):
            if node.ident in ("mem", "gmem"):
                raise ValueError(f"{api} output arguments must be assignable variables or mem[] slots")
            ref = self.name_ref(node.ident)
            return lambda val_expr: self.put(f"{ref} = {val_expr}")
        if isinstance(node, Mem):
            if self._is_gmem(node):
                raise ValueError(f"{api} output arguments must be assignable variables or mem[] slots")
            b = self.ex(node.base)
            i = self.ex(node.index)
            addr = self.tmp()
            self.put(f"{addr} = _maddr(S, {b}, {i})")
            return lambda val_expr: self.put(f"S.mem[{addr}] = {val_expr}")
        raise ValueError(f"{api} output arguments must be assignable variables or mem[] slots")

    def _slider_mask_arg(self, arg: Node) -> str:
        if isinstance(arg, Name):
            m = _SLIDER_VAR_RE.fullmatch(arg.ident)
            if m is not None:
                idx1 = int(m.group(1))
                if 1 <= idx1 <= 64:
                    return repr(float(1 << (idx1 - 1)))
        return self.ex(arg)

    # -- calls ---------------------------------------------------------------

    def _call(self, n: CallExpr) -> str:  # noqa: C901 (big dispatch, mirrors ref)
        fn = n.func
        P = self.program

        if fn in ("slider", "spl"):
            if len(n.args) != 1:
                raise ValueError(f"{fn} expects 1 arg")
            idx = self.ex(n.args[0])
            t = self.tmp()
            self.put(f"{t} = _dynget(S, {fn == 'slider'}, {idx})")
            return t

        if fn == "instance_id":
            t = self.tmp()
            self.put(f"{t} = float(S.host.instance_id(S))")
            return t

        if fn in ("instance_uid", "instance_get_name"):
            store = self._lv_prepare(n.args[0], fn)
            r = self.tmp()
            self.put(f"{r} = S.host.{fn}(S)")
            store(f"{r}[1]")
            t = self.tmp()
            self.put(f"{t} = float({r}[0])")
            return t

        if fn == "instance_set_name":
            a0 = self.ex(n.args[0])
            t = self.tmp()
            self.put(f"{t} = float(S.host.instance_set_name(S, {a0}))")
            return t

        if fn in ("track_name", "host_track_name"):
            store = self._lv_prepare(n.args[0], "track_name")
            r = self.tmp()
            self.put(f"{r} = S.host.track_name(S)")
            store(f"{r}[1]")
            t = self.tmp()
            self.put(f"{t} = float({r}[0])")
            return t

        if fn in ("track_name_available", "host_track_name_available"):
            t = self.tmp()
            self.put(f"{t} = float(S.host.track_name_available(S))")
            return t

        if fn in ("track_name_seq", "host_track_name_seq"):
            t = self.tmp()
            self.put(f"{t} = float(S.host.track_name_seq(S))")
            return t

        simple_host = {
            "comm_join": 1, "gmem_attach": 1, "gmem_attach_size": 2,
            "gmem_size": 0, "gmem_get": 3, "gmem_put": 3, "gmem_fill": 3,
            "gmem_zero": 2, "gmem_copy": 3, "gmem_seq": 1, "gmem_page": 1,
            "msg_subscribe": 1, "msg_unsubscribe": 1, "msg_advertise": 2,
            "msg_send": 6, "msg_sendto": 7, "msg_avail": 1, "msg_kind": 1,
            "msg_length": 1, "msg_dropped": 1, "msg_clear": 1,
            "msg_peer_count": 2, "msg_peer_id": 3, "msg_peer_caps": 1,
            "msg_peer_alive": 1, "msg_send_buf": 4, "msg_sendto_buf": 5,
        }
        if fn in simple_host:
            argc = simple_host[fn]
            if len(n.args) != argc:
                raise ValueError(f"{fn} expects {argc} args")
            args = [self.ex(a) for a in n.args]
            t = self.tmp()
            self.put(f"{t} = float(S.host.{fn}(S{''.join(', ' + a for a in args)}))")
            return t

        if fn in ("msg_peer_name", "msg_peer_uid"):
            if len(n.args) != 2:
                raise ValueError(f"{fn} expects 2 args")
            peer = self.ex(n.args[0])
            store = self._lv_prepare(n.args[1], fn)
            r = self.tmp()
            self.put(f"{r} = S.host.{fn}(S, {peer})")
            t = self.tmp()
            self.put(f"if {r} is None:")
            self.put(f"    {t} = 0.0")
            self.put("else:")
            self.depth += 1
            store(f"float({r}[1])")
            self.put(f"{t} = float({r}[0])")
            self.depth -= 1
            return t

        if fn == "msg_recv":
            if len(n.args) != 7:
                raise ValueError("msg_recv expects 7 args")
            chan = self.ex(n.args[0])
            stores = [self._lv_prepare(a, "msg_recv") for a in n.args[1:]]
            r = self.tmp()
            self.put(f"{r} = S.host.msg_recv(S, {chan})")
            t = self.tmp()
            self.put(f"if {r} is None:")
            self.put(f"    {t} = 0.0")
            self.put("else:")
            self.depth += 1
            for k, store in enumerate(stores):
                store(f"float({r}[{k}])")
            self.put(f"{t} = 1.0")
            self.depth -= 1
            return t

        if fn == "msg_recv_buf":
            if len(n.args) != 5:
                raise ValueError("msg_recv_buf expects 5 args")
            chan = self.ex(n.args[0])
            s_src = self._lv_prepare(n.args[1], "msg_recv_buf")
            s_tag = self._lv_prepare(n.args[2], "msg_recv_buf")
            buf = self.ex(n.args[3])
            maxlen = self.ex(n.args[4])
            r = self.tmp()
            self.put(f"{r} = S.host.msg_recv_buf(S, {chan}, {buf}, {maxlen})")
            t = self.tmp()
            self.put(f"if {r} is None:")
            self.put(f"    {t} = 0.0")
            self.put("else:")
            self.depth += 1
            s_src(f"float({r}[0])")
            s_tag(f"float({r}[1])")
            self.put(f"{t} = float({r}[2])")
            self.depth -= 1
            return t

        if fn == "midirecv":
            if len(n.args) not in (3, 4):
                raise ValueError("midirecv expects 3 or 4 args")
            stores = [self._lv_prepare(a, "midirecv") for a in n.args]
            r = self.tmp()
            self.put(f"{r} = _midirecv4(S)")
            t = self.tmp()
            self.put(f"if {r} is None:")
            self.put(f"    {t} = 0.0")
            self.put("else:")
            self.depth += 1
            if len(n.args) == 4:
                for k, store in enumerate(stores):
                    store(f"{r}[{k}]")
            else:
                stores[0](f"{r}[0]")
                stores[1](f"{r}[1]")
                stores[2](f"{r}[2] + {r}[3] * 256.0")
            self.put(f"{t} = 1.0")
            self.depth -= 1
            return t

        if fn == "midisend":
            if len(n.args) not in (3, 4):
                raise ValueError("midisend expects 3 or 4 args")
            args = [self.ex(a) for a in n.args]
            t = self.tmp()
            if len(n.args) == 4:
                self.put(f"{t} = _midisend(S, {args[0]}, {args[1]}, {args[2]}, {args[3]})")
            else:
                m23 = self.tmp()
                self.put(f"{m23} = trunc_i64({args[2]})")
                self.put(f"{t} = _midisend(S, {args[0]}, {args[1]}, "
                         f"float({m23} & 255), float(({m23} >> 8) & 255))")
            return t

        if fn in ("midirecv_buf", "midirecv_str"):
            if len(n.args) != (3 if fn == "midirecv_buf" else 2):
                raise ValueError(f"{fn} arg count")
            stores = [self._lv_prepare(n.args[0], fn)]
            if fn == "midirecv_str":
                # the string slot RECEIVES a handle (assignment semantics)
                stores.append(self._lv_prepare(n.args[1], fn))
                args = [self.ex(n.args[1])]
            else:
                args = [self.ex(a) for a in n.args[1:]]
            r = self.tmp()
            self.put(f"{r} = _{fn}(S, {', '.join(args)})")
            t = self.tmp()
            self.put(f"if {r} is None:")
            self.put(f"    {t} = 0.0")
            self.put("else:")
            self.depth += 1
            stores[0](f"{r}[0]")
            if fn == "midirecv_str":
                stores[1](f"{r}[2]")
            self.put(f"{t} = {r}[1]")
            self.depth -= 1
            return t

        if fn in ("midisend_buf", "midisend_str", "midisyx"):
            if len(n.args) != (2 if fn == "midisend_str" else 3):
                raise ValueError(f"{fn} arg count")
            args = [self.ex(a) for a in n.args]
            t = self.tmp()
            if fn == "midisend_str":
                self.put(f"{t} = _midisend_str(S, {args[0]}, {args[1]})")
            else:
                sysex = "True" if fn == "midisyx" else "False"
                self.put(f"{t} = _midisend_buf(S, {args[0]}, {args[1]}, "
                         f"{args[2]}, {sysex})")
            return t

        if fn == "strlen":
            a0 = self.ex(n.args[0])
            t = self.tmp()
            self.put(f"{t} = float(S.host.strlen(S, {a0}))")
            return t

        if fn == "str_getchar":
            a0 = self.ex(n.args[0])
            a1 = self.ex(n.args[1])
            t = self.tmp()
            self.put(f"{t} = float(S.host.str_getchar(S, {a0}, {a1}))")
            return t

        if fn == "__memtop":
            return repr(float(P.memtop))

        from ..ir.analyses import FUNSETS
        if fn in FUNSETS.POOL_ALL:
            if fn in ("sample_read2", "sample_read2_interp") and len(n.args) == 5:
                pool_a = self.ex(n.args[0])
                sid = self.ex(n.args[1])
                phase = self.ex(n.args[2])
                s_l = self._lv_prepare(n.args[3], fn)
                s_r = self._lv_prepare(n.args[4], fn)
                interp = fn.endswith("interp")
                r = self.tmp()
                self.put(f"{r} = S.host.sample_read2(S, {pool_a}, {sid}, "
                         f"{phase}, {interp})")
                t = self.tmp()
                self.put(f"if {r} is None:")
                self.depth += 1
                s_l("0.0")
                s_r("0.0")
                self.put(f"{t} = 0.0")
                self.depth -= 1
                self.put("else:")
                self.depth += 1
                s_l(f"float({r}[0])")
                s_r(f"float({r}[1])")
                self.put(f"{t} = 1.0")
                self.depth -= 1
                return t
            if fn == "sample_preview_read" and len(n.args) == 6:
                pool_a = self.ex(n.args[0])
                sid = self.ex(n.args[1])
                b = self.ex(n.args[2])
                stores = [self._lv_prepare(a, fn) for a in n.args[3:]]
                r = self.tmp()
                self.put(f"{r} = S.host.sample_preview_read(S, {pool_a}, {sid}, {b})")
                t = self.tmp()
                self.put(f"if {r} is None:")
                self.put(f"    {t} = 0.0")
                self.put("else:")
                self.depth += 1
                for k, store in enumerate(stores):
                    store(f"float({r}[{k}])")
                self.put(f"{t} = 1.0")
                self.depth -= 1
                return t
            if fn == "sample_name" and len(n.args) >= 2:
                idx = self.ex(n.args[0])
                self._lv_prepare(n.args[1], "sample_name")
                rest = [self.ex(a) for a in n.args[2:]]
                t = self.tmp()
                self.put(f"{t} = float(S.host.sample_pool_call(S, {fn!r}, "
                         f"[{idx}{''.join(', ' + a for a in rest)}]))")
                return t
            args = [self.ex(a) for a in n.args]
            t = self.tmp()
            self.put(f"{t} = float(S.host.sample_pool_call(S, {fn!r}, [{', '.join(args)}]))")
            return t

        if fn in FUNSETS.LEGACY_FILE:
            if fn == "file_var" and len(n.args) == 2:
                h = self.ex(n.args[0])
                store = self._lv_prepare(n.args[1], "file_var")
                r = self.tmp()
                self.put(f"{r} = S.host.file_var_read(S, {h})")
                t = self.tmp()
                self.put(f"if {r} is None:")
                self.put(f"    {t} = 0.0")
                self.put("else:")
                self.depth += 1
                store(f"float({r}[1])")
                self.put(f"{t} = float({r}[0])")
                self.depth -= 1
                return t
            if fn == "file_riff" and len(n.args) == 3:
                h = self.ex(n.args[0])
                s_nch = self._lv_prepare(n.args[1], "file_riff")
                s_sr = self._lv_prepare(n.args[2], "file_riff")
                r = self.tmp()
                self.put(f"{r} = S.host.file_riff_read(S, {h})")
                t = self.tmp()
                self.put(f"if {r} is None:")
                self.put(f"    {t} = 0.0")
                self.put("else:")
                self.depth += 1
                s_nch(f"float({r}[0])")
                s_sr(f"float({r}[1])")
                self.put(f"{t} = 1.0")
                self.depth -= 1
                return t
            args = [self.ex(a) for a in n.args]
            t = self.tmp()
            self.put(f"{t} = float(S.host.file_call(S, {fn!r}, [{', '.join(args)}]))")
            return t

        if fn == "gfx_measurestr" and len(n.args) == 3:
            # out-params (w, h); dispatched to the UI canvas when attached
            h = self.ex(n.args[0])
            s_w = self._lv_prepare(n.args[1], "gfx_measurestr")
            s_h = self._lv_prepare(n.args[2], "gfx_measurestr")
            r = self.tmp()
            self.put(f"{r} = _gfx_call(S, 'gfx_measurestr', [{h}])")
            s_w(f"float({r}[0])")
            s_h(f"float({r}[1])")
            return "0.0"
        if fn in ("gfx_getpixel", "gfx_getimgdim") and len(n.args) >= 2:
            # out-params: (r,g,b) at gfx_x/gfx_y, or (w,h) of an image
            lead = 1 if fn == "gfx_getimgdim" else 0
            first = [self.ex(a) for a in n.args[:lead]]
            stores = [self._lv_prepare(a, fn) for a in n.args[lead:]]
            r = self.tmp()
            self.put(f"{r} = _gfx_call(S, {fn!r}, "
                     f"[{', '.join(first)}])")
            self.put(f"if isinstance({r}, tuple):")
            self.depth += 1
            for k, store in enumerate(stores):
                store(f"float({r}[{k}]) if len({r}) > {k} else 0.0")
            self.depth -= 1
            return "0.0"
        if fn.startswith("gfx_"):
            # inert in DSP sections; recorded when a UI canvas is attached
            args = [self.ex(a) for a in n.args]
            t = self.tmp()
            self.put(f"{t} = _gfx_call(S, {fn!r}, [{', '.join(args)}])")
            return t
        if fn in _INERT_FUNCS:
            for a in n.args:
                self.ex(a)
            return "0.0"

        if fn in P.fn_defs:
            proto = P.fn_defs[fn]
            args = [self.ex(a) for a in n.args]
            # pad/trim to the declared arity
            args = (args + ["0.0"] * len(proto.params))[: len(proto.params)]
            t = self.tmp()
            self.put(f"{t} = {_py_fn_name(fn)}(S{''.join(', ' + a for a in args)})")
            return t

        if fn in ("min", "max"):
            if len(n.args) != 2:
                raise ValueError(f"{fn} expects 2 args")
            a = self.ex(n.args[0])
            b = self.ex(n.args[1])
            t = self.tmp()
            self.put(f"{t} = eel_{fn}({a}, {b})")
            return t

        if fn == "sqr":
            a = self.ex(n.args[0])
            t = self.tmp()
            self.put(f"{t} = {a} * {a}")
            return t

        if fn == "sign":
            a = self.ex(n.args[0])
            t = self.tmp()
            self.put(f"{t} = eel_sign({a})")
            return t

        if fn in _MATH_ONE_ARG:
            if len(n.args) != 1:
                raise ValueError(f"{fn} expects 1 arg")
            a = self.ex(n.args[0])
            t = self.tmp()
            self.put(f"{t} = {_MATH_ONE_ARG[fn]}({a})")
            return t

        if fn in _MATH_TWO_ARG:
            if len(n.args) != 2:
                raise ValueError(f"{fn} expects 2 args")
            a = self.ex(n.args[0])
            b = self.ex(n.args[1])
            t = self.tmp()
            self.put(f"{t} = {_MATH_TWO_ARG[fn]}({a}, {b})")
            return t

        if fn == "rand":
            if len(n.args) > 1:
                raise ValueError("rand expects 0 or 1 args")
            t = self.tmp()
            if n.args:
                a = self.ex(n.args[0])
                self.put(f"{t} = S.rng.rand({a})")
            else:
                self.put(f"{t} = S.rng.rand(1.0)")
            return t

        if fn == "freembuf":
            self.ex(n.args[0])
            return "0.0"

        if fn == "sliderchange":
            mask = self._slider_mask_arg(n.args[0])
            t = self.tmp()
            self.put(f"{t} = _sliderchange(S, {mask})")
            return t

        if fn == "slider_automate":
            if len(n.args) not in (1, 2):
                raise ValueError("slider_automate expects 1 or 2 args")
            mask = self._slider_mask_arg(n.args[0])
            end = self.ex(n.args[1]) if len(n.args) == 2 else "0.0"
            t = self.tmp()
            self.put(f"{t} = _slider_automate(S, {mask}, {end})")
            return t

        if fn == "slider_next_chg":
            if len(n.args) != 2:
                raise ValueError("slider_next_chg expects 2 args")
            idx = self.ex(n.args[0])
            # out receives the current value; minimal host behavior writes none
            if isinstance(n.args[1], (Name, Mem)) and not self._is_gmem(n.args[1]):
                store = self._lv_prepare(n.args[1], "slider_next_chg")
                cur = self.tmp()
                self.put(f"{cur} = _dynget(S, True, {idx})")
                store(cur)
            else:
                self.ex(n.args[1])
            t = self.tmp()
            self.put(f"{t} = _slider_next_chg(S, {idx})")
            return t

        if fn == "slider_show":
            if len(n.args) not in (1, 2):
                raise ValueError("slider_show expects 1 or 2 args")
            mask = self._slider_mask_arg(n.args[0])
            t = self.tmp()
            if len(n.args) == 2:
                mode = self.ex(n.args[1])
                self.put(f"{t} = _slider_show(S, {mask}, {mode}, True)")
            else:
                self.put(f"{t} = _slider_show(S, {mask}, 0.0, False)")
            return t

        if fn == "memset":
            if len(n.args) != 3:
                raise ValueError("memset expects 3 args")
            d = self.ex(n.args[0])
            v = self.ex(n.args[1])
            ln = self.ex(n.args[2])
            t = self.tmp()
            self.put(f"{t} = _memset(S, {d}, {v}, {ln})")
            return t

        if fn == "memcpy":
            if len(n.args) != 3:
                raise ValueError("memcpy expects 3 args")
            d = self.ex(n.args[0])
            s = self.ex(n.args[1])
            ln = self.ex(n.args[2])
            t = self.tmp()
            self.put(f"{t} = _memcpy(S, {d}, {s}, {ln})")
            return t

        if fn in ("fft", "ifft", "fft_real", "ifft_real", "fft_permute", "fft_ipermute"):
            if len(n.args) != 2:
                raise ValueError(f"{fn} expects 2 args")
            a0 = self.ex(n.args[0])
            a1 = self.ex(n.args[1])
            t = self.tmp()
            self.put(f"{t} = _fft_call(S, {fn!r}, {a0}, {a1})")
            return t

        if fn == "convolve_c":
            if len(n.args) != 3:
                raise ValueError("convolve_c expects 3 args")
            a0 = self.ex(n.args[0])
            a1 = self.ex(n.args[1])
            a2 = self.ex(n.args[2])
            t = self.tmp()
            self.put(f"{t} = _convolve_c(S, {a0}, {a1}, {a2})")
            return t

        if fn in ("time", "time_precise"):
            # deterministic virtual clock (host-advanced)
            t = self.tmp()
            self.put(f"{t} = S.host.now({fn == 'time_precise'})")
            if n.args:
                store = self._lv_prepare(n.args[0], fn)
                store(t)
            return t

        raise ValueError(f"Unknown function call {fn}")


def _py_fn_name(spec_name: str) -> str:
    return "uf_" + re.sub(r"[^0-9A-Za-z_]", "_", spec_name)


# ---------------------------------------------------------------------------
# compilation driver


def _exec_namespace(program: PluginProgram) -> Dict[str, object]:
    ns: Dict[str, object] = {
        "truthy": SC.truthy, "trunc_i64": SC.trunc_i64,
        "eel_or": SC.eel_or, "eel_and": SC.eel_and, "eel_xor": SC.eel_xor,
        "eel_shl": SC.eel_shl, "eel_shr": SC.eel_shr, "eel_mod": SC.eel_mod,
        "eel_div": SC.eel_div, "eel_pow": SC.eel_pow,
        "cmp_lt": SC.cmp_lt, "cmp_le": SC.cmp_le, "cmp_gt": SC.cmp_gt,
        "cmp_ge": SC.cmp_ge, "cmp_eq": SC.cmp_eq, "cmp_ne": SC.cmp_ne,
        "eel_not": SC.eel_not, "eel_min": SC.eel_min, "eel_max": SC.eel_max,
        "eel_sign": SC.eel_sign, "eel_abs": SC.eel_abs,
        "eel_floor": SC.eel_floor, "eel_ceil": SC.eel_ceil,
        "eel_sqrt": SC.eel_sqrt, "eel_exp": SC.eel_exp, "eel_log": SC.eel_log,
        "eel_log10": SC.eel_log10, "eel_sin": SC.eel_sin, "eel_cos": SC.eel_cos,
        "eel_tan": SC.eel_tan, "eel_asin": SC.eel_asin, "eel_acos": SC.eel_acos,
        "eel_atan": SC.eel_atan, "eel_atan2": SC.eel_atan2,
        "eel_invsqrt": SC.eel_invsqrt,
        "_mget": _mget, "_mset": _mset, "_mrmw": _mrmw, "_maddr": _maddr,
        "_dynget": _dynget, "_dynset": _dynset, "_COMPOUND": _COMPOUND,
        "_sliderchange": _sliderchange, "_slider_automate": _slider_automate,
        "_slider_show": _slider_show, "_slider_next_chg": _slider_next_chg,
        "_memset": _memset, "_memcpy": _memcpy,
        "_fft_call": _fft_call, "_convolve_c": _convolve_c,
        "_midirecv4": _midirecv4, "_midisend": _midisend,
        "_midirecv_buf": _midirecv_buf, "_midirecv_str": _midirecv_str,
        "_midisend_buf": _midisend_buf, "_midisend_str": _midisend_str,
        "_gfx_call": _gfx_call,
    }
    return ns


def _compile_callable(program: PluginProgram, ns: Dict[str, object],
                      fn_name: str, params: Sequence[str],
                      body_stmts: Sequence[Node],
                      return_last: bool) -> Callable:
    g = _Gen(program, params)
    last = "0.0"
    for stmt in body_stmts:
        if isinstance(stmt, IfStmt):
            g._if(stmt)
            last = "0.0"
        elif isinstance(stmt, WhileStmt):
            g._while(stmt)
            last = "0.0"
        else:
            last = g.ex(stmt)
    sig_params = "".join(f", p_{i}" for i in range(len(params)))
    header = [
        f"def {fn_name}(S{sig_params}):",
        "    V = S.V; spl = S.spl; sl = S.sliders",
    ]
    tail = [f"    return {last}"] if return_last else []
    src = "\n".join(header + (g.lines or ["    pass"]) + tail) + "\n"
    code = compile(src, f"<shadow:{fn_name}>", "exec")
    exec(code, ns)  # noqa: S102 — our own generated code
    fn = ns[fn_name]
    fn.__shadow_source__ = src  # type: ignore[attr-defined]
    return fn  # type: ignore[return-value]


class ShadowPlugin:
    """Executable golden plugin: init/slider/block/sample + process_block."""

    def __init__(self, program: PluginProgram,
                 host: Optional[HostServices] = None) -> None:
        self.program = program
        ns = _exec_namespace(program)
        # user functions first (sections call them)
        for spec_name, proto in program.fn_defs.items():
            _compile_callable(program, ns, _py_fn_name(spec_name),
                              proto.params, [proto.body], return_last=True)
        self._sections: Dict[str, Callable] = {}
        for sec in ("init", "slider", "block", "sample", "serialize"):
            self._sections[sec] = _compile_callable(
                program, ns, f"jsfx_{sec}", (), program.sections.get(sec, []),
                return_last=False)
        self.state = ShadowState(program.user_vars, program.memtop,
                                 dict(program.string_literals), host=host)

    # -- section entry points ------------------------------------------------

    def run_init(self) -> None:
        self._sections["init"](self.state)

    def run_slider(self) -> None:
        self._sections["slider"](self.state)

    def run_block(self) -> None:
        self._sections["block"](self.state)

    def run_sample(self) -> None:
        self._sections["sample"](self.state)

    def run_serialize(self) -> None:
        """@serialize runs in the golden executor only (host-side state
        persistence hook, mirroring the reference's shadow-VM-only
        compilation of this section)."""
        self._sections["serialize"](self.state)

    # -- host-block driver (ref: dsp_jsfx_aot.py:5713-5905) ------------------

    def process_block(self, inputs: np.ndarray, outputs: np.ndarray,
                      num_channels: Optional[int] = None) -> None:
        """inputs/outputs: float32 arrays [channels, samples]."""
        S = self.state
        n = int(inputs.shape[1]) if inputs.size else int(outputs.shape[1])
        ch = num_channels if num_channels is not None else max(
            inputs.shape[0], outputs.shape[0])
        ch = max(0, min(64, int(ch)))

        S.samplesblock = float(n)
        self.run_block()

        if (S.pending_change_mask or S.pending_automate_mask
                or S.pending_automate_end_mask):
            self.run_slider()
            # the host consumes (publishes + clears) the pending masks
            # each block (ref: JSFXJuceProcessor.cpp:5667-5737)
            S.pending_change_mask = 0
            S.pending_automate_mask = 0
            S.pending_automate_end_mask = 0

        if not self.program.has_sample_section:
            return

        spl = S.spl
        sample_fn = self._sections["sample"]
        in32 = np.ascontiguousarray(inputs, dtype=np.float32)
        n_in = in32.shape[0]
        out32 = outputs
        n_out = out32.shape[0]
        for i in range(n):
            for c in range(ch):
                spl[c] = float(in32[c, i]) if c < n_in else 0.0
            sample_fn(S)
            for c in range(min(ch, n_out)):
                out32[c, i] = np.float32(spl[c])

    # -- debug ---------------------------------------------------------------

    def section_source(self, sec: str) -> str:
        return getattr(self._sections[sec], "__shadow_source__", "")


def compile_shadow(program: PluginProgram,
                   host: Optional[HostServices] = None) -> ShadowPlugin:
    return ShadowPlugin(program, host=host)
