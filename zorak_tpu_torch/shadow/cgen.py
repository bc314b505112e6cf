"""Native golden executor: plugin AST -> C -> gcc -> ctypes.

The CPU counterpart of the reference's AOT object path (ref:
dsp_jsfx_aot.py emits LLVM IR; here we emit C with identical numeric
semantics and compile with the system toolchain).  Used as the fast
golden reference for long null-test renders — it must agree bit-for-bit
with the Python shadow executor (two independent implementations of
semantics/scalar.py's contract).

Host services (comm/midi/pool/file/fft/gmem) route through one generic
callback into the SAME Python HostServices object, so comm graphs work
identically under either executor.  Generated code uses GCC statement
expressions so EEL2's value-producing blocks map 1:1.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..frontend.astnodes import (
    Asn, Bin, Block, CallExpr, Cond, Const, IfStmt, LoopExpr, Mem, Name,
    Node, Str, Un, WhileStmt,
)
from ..ir.program import PluginProgram
from ..ir.symbols import dollar_const, slider_index, spl_index
from .state import HostServices, MidiEvent, ShadowState

_SLIDER_VAR_RE = re.compile(r"slider([1-9][0-9]?)$")

CACHE_DIR = Path(os.environ.get("ZORAK_TPU_CACHE",
                                os.path.expanduser("~/.cache/zorak_tpu"))) / "cgen"

# host-callback opcodes (shared with the Python dispatcher below)
_OPS = [
    "comm_join", "msg_subscribe", "msg_unsubscribe", "msg_advertise",
    "msg_send", "msg_sendto", "msg_send_buf", "msg_sendto_buf",
    "msg_recv", "msg_recv_buf", "msg_avail", "msg_kind", "msg_length",
    "msg_dropped", "msg_clear", "msg_peer_count", "msg_peer_id",
    "msg_peer_name", "msg_peer_uid", "msg_peer_caps", "msg_peer_alive",
    "instance_id", "instance_uid", "instance_set_name", "instance_get_name",
    "track_name", "track_name_available", "track_name_seq",
    "gmem_attach", "gmem_attach_size", "gmem_size", "gmem_load", "gmem_store",
    "gmem_get", "gmem_put", "gmem_fill", "gmem_zero", "gmem_copy",
    "gmem_seq", "gmem_page",
    "midirecv", "midisend",
    "strlen", "str_getchar",
    "pool_call", "file_call", "file_var", "file_riff",
    "fft", "ifft", "fft_real", "ifft_real", "fft_permute", "fft_ipermute",
    "convolve_c",
    "pool_read2", "pool_read2i", "pool_preview",
    # appended (cached .so opcode stability): variable-length MIDI forms
    "midirecv_buf", "midirecv_str", "midisend_buf", "midisend_str",
    "midisyx",
]
OPCODES = {name: i for i, name in enumerate(_OPS)}

_PRELUDE = r"""
#include <stdint.h>
#include <string.h>
#include <stdlib.h>
#include <math.h>

typedef double (*host_fn)(void* ctx, int op, const double* args, int nargs,
                          double* outs, int nouts);

typedef struct {
    double spl[64];
    double sliders[64];
    double* vars;
    double* mem;
    int64_t memN;
    double srate;
    double samplesblock;
    double midi_bus;
    double ext_midi_bus;
    uint32_t mt[624];
    uint32_t mt_idx;
    uint64_t pend_change;
    uint64_t pend_automate;
    uint64_t pend_automate_end;
    uint64_t slider_visible;
    int32_t vis_init;
    void* host_ctx;
    host_fn host;
} ZState;

static inline int64_t zt_i64(double x) {
    if (!(x == x)) return 0;
    if (x >= 4.611686018427387904e18) return (int64_t)1 << 62;
    if (x <= -4.611686018427387904e18) return -((int64_t)1 << 62);
    return (int64_t)x;
}
static inline int32_t zt_i32(double x) { return (int32_t)(uint32_t)(uint64_t)zt_i64(x); }
static inline double z_or(double a, double b)  { return (double)(zt_i32(a) | zt_i32(b)); }
static inline double z_and(double a, double b) { return (double)(zt_i32(a) & zt_i32(b)); }
static inline double z_xor(double a, double b) { return (double)(zt_i32(a) ^ zt_i32(b)); }
static inline double z_shl(double a, double b) {
    return (double)(int32_t)((uint32_t)zt_i32(a) << (zt_i32(b) & 31));
}
static inline double z_shr(double a, double b) { return (double)(zt_i32(a) >> (zt_i32(b) & 31)); }
static inline double z_mod(double a, double b) {
    int32_t li = zt_i32(a), ri = zt_i32(b);
    if (ri == 0) return 0.0;
    if (ri == -1) return 0.0; /* avoid INT_MIN/-1 UB; remainder is 0 anyway */
    return (double)(li % ri);
}
static inline int z_true(double x) { return x < 0.0 || x > 0.0; }
static inline double z_not(double x) { return x == 0.0 ? 1.0 : 0.0; }
static inline double z_lt(double a, double b) { return a < b ? 1.0 : 0.0; }
static inline double z_le(double a, double b) { return a <= b ? 1.0 : 0.0; }
static inline double z_gt(double a, double b) { return a > b ? 1.0 : 0.0; }
static inline double z_ge(double a, double b) { return a >= b ? 1.0 : 0.0; }
static inline double z_eq(double a, double b) { return a == b ? 1.0 : 0.0; }
static inline double z_ne(double a, double b) {
    return (a == a && b == b && a != b) ? 1.0 : 0.0;
}
static inline double z_min(double a, double b) { return a < b ? a : b; }
static inline double z_max(double a, double b) { return a > b ? a : b; }
static inline double z_sign(double a) { return a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : 0.0); }
static inline double z_invsqrt(double x) {
    float xf = (float)x;
    int32_t bits;
    memcpy(&bits, &xf, 4);
    int32_t ap = (int32_t)(0x5f3759df - (bits >> 1));
    float y0f;
    memcpy(&y0f, &ap, 4);
    double y0 = (double)y0f;
    return y0 * (1.5 - 0.5 * x * y0 * y0);
}

/* The heap buffer is owned by the host (numpy); growth goes through the
   host callback which reallocates and pokes the new pointer/size back
   into the struct before returning. */
#define OP_ENSURE_MEM 1000
static void z_ensure_mem(ZState* S, int64_t needed) {
    if (needed <= S->memN) return;
    double a = (double)needed;
    (void)S->host(S->host_ctx, OP_ENSURE_MEM, &a, 1, 0, 0);
}
static inline int64_t z_addr(ZState* S, double base, double idx) {
    int64_t a = zt_i64(base + idx + 1.0e-5);
    if (a < 0) a = 0;
    if (a >= S->memN) z_ensure_mem(S, a + 1);
    return a;
}
static inline double z_mget(ZState* S, double base, double idx) {
    /* sequence the address computation BEFORE loading S->mem: z_addr may
       grow the heap through the host callback, which can move the buffer
       (S->mem[z_addr(...)] has unspecified evaluation order in C) */
    int64_t a = z_addr(S, base, idx);
    return S->mem[a];
}
static inline double z_mset(ZState* S, double v, double base, double idx) {
    int64_t a = z_addr(S, base, idx);
    S->mem[a] = v;
    return v;
}
static inline double z_blob_addr(double x) {
    int64_t a = zt_i64(x + 1.0e-5);
    return a < 0 ? 0 : (double)a;
}
static double z_memset(ZState* S, double dest, double val, double len) {
    int64_t d = (int64_t)z_blob_addr(dest);
    int64_t n = zt_i64(len);
    if (n > 0) {
        z_ensure_mem(S, d + n);
        for (int64_t i = 0; i < n; i++) S->mem[d + i] = val;
    }
    return dest;
}
static double z_memcpy(ZState* S, double dest, double src, double len) {
    int64_t d = (int64_t)z_blob_addr(dest);
    int64_t s = (int64_t)z_blob_addr(src);
    int64_t n = zt_i64(len);
    if (n > 0) {
        z_ensure_mem(S, (d > s ? d : s) + n);
        memmove(S->mem + d, S->mem + s, (size_t)n * sizeof(double));
    }
    return dest;
}

/* MT19937 with EEL2's fixed seed; idx 0 = uninitialized. */
static uint32_t z_rand_u32(ZState* S) {
    uint32_t* mt = S->mt;
    if (S->mt_idx == 0) {
        mt[0] = 0x4141F00Du;
        for (int i = 1; i < 624; i++)
            mt[i] = 1812433253u * (mt[i-1] ^ (mt[i-1] >> 30)) + (uint32_t)i;
        S->mt_idx = 624;
    }
    uint32_t y;
    if (S->mt_idx >= 624) {
        for (int k = 0; k < 623; k++) {
            y = (mt[k] & 0x80000000u) | (mt[k+1] & 0x7fffffffu);
            int src = k < 227 ? k + 397 : k - 227;
            mt[k] = mt[src] ^ (y >> 1) ^ ((y & 1u) ? 0x9908B0DFu : 0u);
        }
        y = (mt[623] & 0x80000000u) | (mt[0] & 0x7fffffffu);
        mt[623] = mt[396] ^ (y >> 1) ^ ((y & 1u) ? 0x9908B0DFu : 0u);
        S->mt_idx = 1;
        y = mt[0];
    } else {
        y = mt[S->mt_idx];
        S->mt_idx++;
    }
    y ^= y >> 11;
    y ^= (y << 7) & 0x9D2C5680u;
    y ^= (y << 15) & 0xEFC60000u;
    y ^= y >> 18;
    return y;
}
static double z_rand(ZState* S, double limit) {
    double top = floor(limit);
    if (!(top >= 1.0)) top = 1.0;
    return (double)z_rand_u32(S) * (1.0 / 4294967295.0) * top;
}

static inline uint64_t z_mask_bits(double m) {
    int64_t i = zt_i64(m);
    return i > 0 ? (uint64_t)i : 0;
}
static double z_sliderchange(ZState* S, double mask) {
    S->pend_change |= z_mask_bits(mask);
    return 0.0;
}
static double z_slider_automate(ZState* S, double mask, double end_touch) {
    if (z_true(end_touch)) S->pend_automate_end |= z_mask_bits(mask);
    else S->pend_automate |= z_mask_bits(mask);
    return 0.0;
}
static double z_slider_show(ZState* S, double mask, double mode, int have_mode) {
    if (!S->vis_init) { S->slider_visible = ~(uint64_t)0; S->vis_init = 1; }
    uint64_t bits = (mask == mask && mask > 0.0) ? z_mask_bits(mask) : 0;
    uint64_t vis = S->slider_visible;
    if (have_mode) {
        if (mode == -1.0) vis ^= bits;
        else if (mode == 0.0) vis &= ~bits;
        else vis |= bits;
        S->slider_visible = vis;
    }
    return (double)(vis & bits);
}
static inline double* z_dyn_ptr(ZState* S, int is_slider, double idx, int* ok) {
    int64_t i = zt_i64(idx + 1.0e-5);
    if (is_slider) i -= 1;
    if (i < 0 || i >= 64) { *ok = 0; return &S->spl[0]; }
    *ok = 1;
    return is_slider ? &S->sliders[i] : &S->spl[i];
}
"""


class CGenError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# codegen


class _CGen:
    def __init__(self, program: PluginProgram, params: Sequence[str] = ()):
        self.P = program
        self.params = {p: f"p_{i}" for i, p in enumerate(params)}
        self.var_index = program.user_vars

    def name_ref(self, ident: str) -> str:
        if ident in self.params:
            return self.params[ident]
        if ident == "mem":
            return "0.0"
        if ident == "gmem":
            raise CGenError("gmem may only be used as gmem[index]")
        c = dollar_const(ident)
        if c is not None:
            return _cf(c)
        i = spl_index(ident)
        if i is not None:
            return f"S->spl[{i}]"
        i = slider_index(ident)
        if i is not None:
            return f"S->sliders[{i}]"
        if ident == "srate":
            return "S->srate"
        if ident == "samplesblock":
            return "S->samplesblock"
        if ident == "midi_bus":
            return "S->midi_bus"
        if ident == "ext_midi_bus":
            return "S->ext_midi_bus"
        return f"S->vars[{self.var_index[ident]}]"

    def _is_gmem(self, node: Node) -> bool:
        return isinstance(node, Mem) and isinstance(node.base, Name) \
            and node.base.ident == "gmem"

    # -- expression -> C expression (statement expressions for blocks) -------

    def ex(self, n: Node) -> str:  # noqa: C901
        if isinstance(n, Const):
            return _cf(n.value)
        if isinstance(n, Str):
            return _cf(float(self.P.string_handle(n.text)))
        if isinstance(n, Name):
            return self.name_ref(n.ident)
        if isinstance(n, Mem):
            if self._is_gmem(n):
                return self._host("gmem_load", [self.ex(n.index)])
            return f"z_mget(S, {self.ex(n.base)}, {self.ex(n.index)})"
        if isinstance(n, Un):
            a = self.ex(n.operand)
            if n.op == "+":
                return a
            if n.op == "-":
                return f"(0.0 - {a})"
            return f"z_not({a})"
        if isinstance(n, Bin):
            if n.op == "&&":
                return f"(z_true({self.ex(n.lhs)}) ? (z_true({self.ex(n.rhs)}) ? 1.0 : 0.0) : 0.0)"
            if n.op == "||":
                return f"(z_true({self.ex(n.lhs)}) ? 1.0 : (z_true({self.ex(n.rhs)}) ? 1.0 : 0.0))"
            l, r = self.ex(n.lhs), self.ex(n.rhs)
            op = n.op
            if op in ("+", "-", "*"):
                return f"({l} {op} {r})"
            table = {"/": None, "^": "pow", "%": "z_mod", "|": "z_or",
                     "&": "z_and", "<<": "z_shl", ">>": "z_shr",
                     "<": "z_lt", "<=": "z_le", ">": "z_gt", ">=": "z_ge",
                     "==": "z_eq", "!=": "z_ne"}
            if op == "/":
                return f"({l} / {r})"
            return f"{table[op]}({l}, {r})"
        if isinstance(n, Cond):
            return (f"(z_true({self.ex(n.pred)}) ? ({self.ex(n.then)}) "
                    f": ({self.ex(n.other)}))")
        if isinstance(n, LoopExpr):
            return ("({ double _lv = 0.0; int64_t _ln = zt_i64(%s); "
                    "for (int64_t _li = 0; _li < _ln; _li++) { _lv = (%s); } _lv; })"
                    % (self.ex(n.count), self.ex(n.body)))
        if isinstance(n, Block):
            if not n.items:
                return "0.0"
            parts = []
            for item in n.items[:-1]:
                parts.append(self.stmt(item))
            last = n.items[-1]
            if isinstance(last, (IfStmt, WhileStmt)):
                parts.append(self.stmt(last))
                parts.append("_bv = 0.0;")
            else:
                parts.append(f"_bv = ({self.ex(last)});")
            return "({ double _bv = 0.0; " + " ".join(parts) + " _bv; })"
        if isinstance(n, IfStmt):
            return "({ " + self.stmt(n) + " 0.0; })"
        if isinstance(n, WhileStmt):
            return "({ " + self.stmt(n) + " 0.0; })"
        if isinstance(n, Asn):
            return self._assign(n)
        if isinstance(n, CallExpr):
            return self._call(n)
        raise CGenError(f"unhandled node {type(n).__name__}")

    def stmt(self, n: Node) -> str:
        if isinstance(n, IfStmt):
            s = f"if (z_true({self.ex(n.pred)})) {{ (void)({self.ex(n.then)}); }}"
            if n.other is not None:
                s += f" else {{ (void)({self.ex(n.other)}); }}"
            return s
        if isinstance(n, WhileStmt):
            return (f"while (z_true({self.ex(n.pred)})) "
                    f"{{ (void)({self.ex(n.body)}); }}")
        return f"(void)({self.ex(n)});"

    # -- assignment ----------------------------------------------------------

    _COMPOUND_EXPR = {
        "+=": "({cur} + {rhs})", "-=": "({cur} - {rhs})",
        "*=": "({cur} * {rhs})", "/=": "({cur} / {rhs})",
        "%=": "z_mod({cur}, {rhs})", "^=": "pow({cur}, {rhs})",
        "|=": "z_or({cur}, {rhs})", "&=": "z_and({cur}, {rhs})",
        "~=": "z_xor({cur}, {rhs})",
    }

    def _assign(self, n: Asn) -> str:
        tgt = n.target
        if isinstance(tgt, Name):
            if tgt.ident in ("mem", "gmem"):
                raise CGenError(f"cannot assign to {tgt.ident}")
            ref = self.name_ref(tgt.ident)
            rhs = self.ex(n.value)
            if n.op == "=":
                return f"({ref} = ({rhs}))"
            expr = self._COMPOUND_EXPR[n.op].format(cur=ref, rhs="_rv")
            return f"({{ double _rv = ({rhs}); {ref} = {expr}; {ref}; }})"
        if isinstance(tgt, Mem):
            if self._is_gmem(tgt):
                rhs = self.ex(n.value)
                idx = self.ex(tgt.index)
                if n.op == "=":
                    return ("({ double _rv = (%s); double _gi = (%s); "
                            "%s; _rv; })"
                            % (rhs, idx,
                               self._host_stmt("gmem_store", ["_gi", "_rv"])))
                expr = self._COMPOUND_EXPR[n.op].format(cur="_cur", rhs="_rv")
                return ("({ double _rv = (%s); double _gi = (%s); "
                        "double _cur = %s; double _out = %s; %s; _out; })"
                        % (rhs, idx, self._host("gmem_load", ["_gi"]), expr,
                           self._host_stmt("gmem_store", ["_gi", "_out"])))
            rhs = self.ex(n.value)
            b = self.ex(tgt.base)
            i = self.ex(tgt.index)
            if n.op == "=":
                return f"z_mset(S, ({rhs}), ({b}), ({i}))"
            expr = self._COMPOUND_EXPR[n.op].format(cur="S->mem[_ma]", rhs="_rv")
            return ("({ double _rv = (%s); int64_t _ma = z_addr(S, (%s), (%s)); "
                    "double _out = %s; S->mem[_ma] = _out; _out; })"
                    % (rhs, b, i, expr))
        if isinstance(tgt, CallExpr) and tgt.func in ("slider", "spl"):
            is_slider = 1 if tgt.func == "slider" else 0
            rhs = self.ex(n.value)
            idx = self.ex(tgt.args[0])
            if n.op == "=":
                return ("({ double _rv = (%s); int _ok; "
                        "double* _p = z_dyn_ptr(S, %d, (%s), &_ok); "
                        "if (_ok) *_p = _rv; _rv; })" % (rhs, is_slider, idx))
            expr = self._COMPOUND_EXPR[n.op].format(cur="_cur", rhs="_rv")
            return ("({ double _rv = (%s); int _ok; "
                    "double* _p = z_dyn_ptr(S, %d, (%s), &_ok); "
                    "double _cur = _ok ? *_p : 0.0; double _out = %s; "
                    "if (_ok) *_p = _out; _out; })" % (rhs, is_slider, idx, expr))
        raise CGenError("invalid assignment target")

    # -- host calls ----------------------------------------------------------

    def _host(self, op: str, args: List[str], nouts: int = 0,
              outs_decl: str = "0") -> str:
        argv = ", ".join(args) if args else ""
        n = len(args)
        arr = f"(double[]){{{argv}}}" if n else "0"
        return (f"S->host(S->host_ctx, {OPCODES[op]}, {arr}, {n}, "
                f"{outs_decl}, {nouts})")

    def _host_stmt(self, op: str, args: List[str]) -> str:
        return f"(void){self._host(op, args)}"

    def _host_with_outs(self, op: str, args: List[str],
                        out_targets: List[Node],
                        always_store: bool = False) -> str:
        """Host call writing out-params back through resolved lvalues."""
        nouts = len(out_targets)
        pre: List[str] = [f"double _o[{max(1, nouts)}] = {{0}};"]
        post: List[str] = []
        for k, t in enumerate(out_targets):
            if isinstance(t, Name):
                if t.ident in ("mem", "gmem"):
                    raise CGenError(f"{op} output arguments must be assignable")
                post.append(f"{self.name_ref(t.ident)} = _o[{k}];")
            elif isinstance(t, Mem) and not self._is_gmem(t):
                pre.append(f"int64_t _oa{k} = z_addr(S, ({self.ex(t.base)}), "
                           f"({self.ex(t.index)}));")
                post.append(f"S->mem[_oa{k}] = _o[{k}];")
            else:
                raise CGenError(f"{op} output arguments must be assignable")
        call = self._host(op, args, nouts=nouts, outs_decl="_o")
        body = " ".join(pre) + f" double _hr = {call}; "
        if always_store:
            body += " ".join(post) + " "
        else:
            body += f"if (_hr != 0.0) {{ {' '.join(post)} }} "
        return "({ " + body + "_hr; })"

    # -- calls ---------------------------------------------------------------

    def _call(self, n: CallExpr) -> str:  # noqa: C901
        fn = n.func
        P = self.P

        if fn in ("slider", "spl"):
            is_slider = 1 if fn == "slider" else 0
            return ("({ int _ok; double* _p = z_dyn_ptr(S, %d, (%s), &_ok); "
                    "_ok ? *_p : 0.0; })" % (is_slider, self.ex(n.args[0])))

        if fn in P.fn_defs:
            proto = P.fn_defs[fn]
            args = [self.ex(a) for a in n.args]
            args = (args + ["0.0"] * len(proto.params))[: len(proto.params)]
            return f"uf_{_mangle_c(fn)}(S{''.join(', ' + a for a in args)})"

        simple = {
            "comm_join": 1, "msg_subscribe": 1, "msg_unsubscribe": 1,
            "msg_advertise": 2, "msg_send": 6, "msg_sendto": 7,
            "msg_send_buf": 4, "msg_sendto_buf": 5,
            "msg_avail": 1, "msg_kind": 1, "msg_length": 1, "msg_dropped": 1,
            "msg_clear": 1, "msg_peer_count": 2, "msg_peer_id": 3,
            "msg_peer_caps": 1, "msg_peer_alive": 1,
            "instance_id": 0, "instance_set_name": 1,
            "track_name_available": 0, "track_name_seq": 0,
            "gmem_attach": 1, "gmem_attach_size": 2, "gmem_size": 0,
            "gmem_get": 3, "gmem_put": 3, "gmem_fill": 3, "gmem_zero": 2,
            "gmem_copy": 3, "gmem_seq": 1, "gmem_page": 1,
            "strlen": 1, "str_getchar": 2,
        }
        # host_track aliases
        alias = {"host_track_name_available": "track_name_available",
                 "host_track_name_seq": "track_name_seq"}
        if fn in alias:
            fn = alias[fn]
        if fn in simple:
            if len(n.args) != simple[fn]:
                raise CGenError(f"{fn} expects {simple[fn]} args")
            return self._host(fn, [self.ex(a) for a in n.args])

        if fn in ("instance_uid", "instance_get_name"):
            return self._host_with_outs(fn, [], [n.args[0]])
        if fn in ("track_name", "host_track_name"):
            return self._host_with_outs("track_name", [], [n.args[0]])
        if fn in ("msg_peer_name", "msg_peer_uid"):
            return self._host_with_outs(fn, [self.ex(n.args[0])], [n.args[1]])
        if fn == "msg_recv":
            return self._host_with_outs("msg_recv", [self.ex(n.args[0])],
                                        list(n.args[1:]))
        if fn == "msg_recv_buf":
            return self._host_with_outs(
                "msg_recv_buf",
                [self.ex(n.args[0]), self.ex(n.args[3]), self.ex(n.args[4])],
                [n.args[1], n.args[2]])
        if fn == "midirecv":
            if len(n.args) == 4:
                return self._host_with_outs("midirecv", ["4.0"], list(n.args))
            if len(n.args) == 3:
                return self._host_with_outs("midirecv", ["3.0"], list(n.args))
            raise CGenError("midirecv expects 3 or 4 args")
        if fn == "midisend":
            if len(n.args) not in (3, 4):
                raise CGenError("midisend expects 3 or 4 args")
            args = [self.ex(a) for a in n.args]
            return self._host("midisend", [str(float(len(n.args)))] + args)
        if fn == "midirecv_buf":
            if len(n.args) != 3:
                raise CGenError("midirecv_buf arg count")
            return self._host_with_outs(
                fn, [self.ex(a) for a in n.args[1:]], [n.args[0]])
        if fn == "midirecv_str":
            if len(n.args) != 2:
                raise CGenError("midirecv_str arg count")
            # outs: offset + the string slot (it receives a handle)
            return self._host_with_outs(
                fn, [self.ex(n.args[1])], [n.args[0], n.args[1]])
        if fn in ("midisend_buf", "midisend_str", "midisyx"):
            if len(n.args) != (2 if fn == "midisend_str" else 3):
                raise CGenError(f"{fn} arg count")
            return self._host(fn, [self.ex(a) for a in n.args])

        from ..ir.analyses import FUNSETS
        if fn in FUNSETS.POOL_ALL:
            if fn in ("sample_read2", "sample_read2_interp") and len(n.args) == 5:
                op = "pool_read2i" if fn.endswith("interp") else "pool_read2"
                # reference zeroes the outs on failure, so always store
                return self._host_with_outs(
                    op, [self.ex(n.args[0]), self.ex(n.args[1]),
                         self.ex(n.args[2])], [n.args[3], n.args[4]],
                    always_store=True)
            if fn == "sample_preview_read" and len(n.args) == 6:
                return self._host_with_outs(
                    "pool_preview",
                    [self.ex(n.args[0]), self.ex(n.args[1]), self.ex(n.args[2])],
                    list(n.args[3:]))
            args = [self.ex(a) for a in n.args
                    if not (fn == "sample_name" and a is n.args[1])]
            return self._host("pool_call",
                              [str(float(_pool_code(fn)))] + args)
        if fn in FUNSETS.LEGACY_FILE:
            if fn == "file_var" and len(n.args) == 2:
                return self._host_with_outs("file_var", [self.ex(n.args[0])],
                                            [n.args[1]])
            if fn == "file_riff" and len(n.args) == 3:
                return self._host_with_outs("file_riff", [self.ex(n.args[0])],
                                            [n.args[1], n.args[2]])
            return self._host("file_call",
                              [str(float(_file_code(fn)))]
                              + [self.ex(a) for a in n.args])

        if fn.startswith("gfx_") or fn in (
                "sprintf", "printf", "strcpy", "strcat", "strcmp",
                "str_setchar", "str_insert", "str_delete", "str_mid",
                "strncpy", "file_read", "file_write", "file_string"):
            if not n.args:
                return "0.0"
            return "(" + ", ".join(f"(void)({self.ex(a)})" for a in n.args) + ", 0.0)"

        if fn in ("min", "max"):
            return f"z_{fn}({self.ex(n.args[0])}, {self.ex(n.args[1])})"
        if fn == "sqr":
            return f"({{ double _sq = ({self.ex(n.args[0])}); _sq * _sq; }})"
        if fn == "sign":
            return f"z_sign({self.ex(n.args[0])})"
        if fn in ("abs", "fabs"):
            return f"fabs({self.ex(n.args[0])})"
        if fn == "invsqrt":
            return f"z_invsqrt({self.ex(n.args[0])})"
        if fn in ("sin", "cos", "tan", "asin", "acos", "atan", "exp", "log",
                  "log10", "sqrt", "floor", "ceil"):
            return f"{fn}({self.ex(n.args[0])})"
        if fn in ("pow", "atan2"):
            return f"{fn}({self.ex(n.args[0])}, {self.ex(n.args[1])})"
        if fn == "rand":
            arg = self.ex(n.args[0]) if n.args else "1.0"
            return f"z_rand(S, {arg})"
        if fn == "freembuf":
            return f"((void)({self.ex(n.args[0])}), 0.0)"
        if fn == "sliderchange":
            return f"z_sliderchange(S, {self._mask_arg(n.args[0])})"
        if fn == "slider_automate":
            end = self.ex(n.args[1]) if len(n.args) == 2 else "0.0"
            return f"z_slider_automate(S, {self._mask_arg(n.args[0])}, {end})"
        if fn == "slider_show":
            if len(n.args) == 2:
                return (f"z_slider_show(S, {self._mask_arg(n.args[0])}, "
                        f"{self.ex(n.args[1])}, 1)")
            return f"z_slider_show(S, {self._mask_arg(n.args[0])}, 0.0, 0)"
        if fn == "slider_next_chg":
            idx = self.ex(n.args[0])
            t = n.args[1]
            if isinstance(t, Name) and t.ident not in ("mem", "gmem"):
                ref = self.name_ref(t.ident)
                return ("({ int _ok; double* _p = z_dyn_ptr(S, 1, (%s), &_ok); "
                        "%s = _ok ? *_p : 0.0; -1.0; })" % (idx, ref))
            return f"((void)({self.ex(n.args[1])}), -1.0)"
        if fn == "memset":
            return (f"z_memset(S, {self.ex(n.args[0])}, {self.ex(n.args[1])}, "
                    f"{self.ex(n.args[2])})")
        if fn == "memcpy":
            return (f"z_memcpy(S, {self.ex(n.args[0])}, {self.ex(n.args[1])}, "
                    f"{self.ex(n.args[2])})")
        if fn in ("fft", "ifft", "fft_real", "ifft_real", "fft_permute",
                  "fft_ipermute"):
            return self._host(fn, [self.ex(n.args[0]), self.ex(n.args[1])])
        if fn == "convolve_c":
            return self._host("convolve_c",
                              [self.ex(a) for a in n.args])
        if fn == "__memtop":
            return _cf(float(P.memtop))

        raise CGenError(f"Unknown function call {fn}")

    def _mask_arg(self, arg: Node) -> str:
        if isinstance(arg, Name):
            m = _SLIDER_VAR_RE.fullmatch(arg.ident)
            if m is not None:
                idx1 = int(m.group(1))
                if 1 <= idx1 <= 64:
                    return _cf(float(1 << (idx1 - 1)))
        return self.ex(arg)


def _cf(v: float) -> str:
    if v != v:
        return "(0.0/0.0)"
    if v == float("inf"):
        return "(1.0/0.0)"
    if v == float("-inf"):
        return "(-1.0/0.0)"
    return repr(float(v))


def _mangle_c(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z_]", "_", name)


def _stable_codes(names) -> Dict[str, int]:
    return {name: i for i, name in enumerate(sorted(names))}


def _init_code_tables():
    from ..ir.analyses import FUNSETS
    return (_stable_codes(FUNSETS.POOL_ALL), _stable_codes(FUNSETS.LEGACY_FILE))


_POOL_CODES, _FILE_CODES = _init_code_tables()
_POOL_INV = {v: k for k, v in _POOL_CODES.items()}
_FILE_INV = {v: k for k, v in _FILE_CODES.items()}


def _pool_code(fn: str) -> int:
    return _POOL_CODES[fn]


def _file_code(fn: str) -> int:
    return _FILE_CODES[fn]


# ---------------------------------------------------------------------------
# module assembly + build


def generate_c(program: PluginProgram) -> str:
    gen_protos = []
    gen_bodies = []

    for spec_name, proto in program.fn_defs.items():
        g = _CGen(program, proto.params)
        args = "".join(f", double p_{i}" for i in range(len(proto.params)))
        gen_protos.append(f"static double uf_{_mangle_c(spec_name)}(ZState* S{args});")
        body = g.ex(proto.body)
        gen_bodies.append(
            f"static double uf_{_mangle_c(spec_name)}(ZState* S{args}) "
            f"{{ return ({body}); }}")

    sec_bodies = []
    for sec in ("init", "slider", "block", "sample"):
        g = _CGen(program)
        stmts = " ".join(g.stmt(s) for s in program.sections.get(sec, []))
        sec_bodies.append(f"void jsfx_{sec}(ZState* S) {{ {stmts} }}")

    has_sample = "1" if program.has_sample_section else "0"
    process = r"""
void jsfx_process_block(ZState* S, const float* const* in,
                        float* const* out, int nch, int n) {
    if (nch < 0) nch = 0;
    if (nch > 64) nch = 64;
    S->samplesblock = (double)n;
    jsfx_block(S);
    if (S->pend_change | S->pend_automate | S->pend_automate_end) {
        jsfx_slider(S);
        /* the host consumes (publishes + clears) the pending masks each
           block (ref: JSFXJuceProcessor.cpp:5667-5737) */
        S->pend_change = 0;
        S->pend_automate = 0;
        S->pend_automate_end = 0;
    }
    if (!HAS_SAMPLE) return;
    for (int i = 0; i < n; i++) {
        for (int c = 0; c < nch; c++) S->spl[c] = (double)in[c][i];
        jsfx_sample(S);
        for (int c = 0; c < nch; c++) out[c][i] = (float)S->spl[c];
    }
}
""".replace("HAS_SAMPLE", has_sample)

    return "\n".join([_PRELUDE,
                      f"#define VAR_COUNT {max(1, len(program.user_vars))}",
                      *gen_protos, *gen_bodies, *sec_bodies, process])


def build_shared_object(c_source: str) -> Path:
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(c_source.encode()).hexdigest()[:24]
    so_path = CACHE_DIR / f"plug_{digest}.so"
    if so_path.exists():
        return so_path
    c_path = CACHE_DIR / f"plug_{digest}.c"
    c_path.write_text(c_source)
    tmp = so_path.with_suffix(".so.tmp")
    cmd = ["gcc", "-O2", "-fPIC", "-shared", "-std=gnu11",
           "-o", str(tmp), str(c_path), "-lm"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise CGenError(f"gcc failed:\n{r.stderr[:4000]}")
    os.replace(tmp, so_path)
    return so_path


# ---------------------------------------------------------------------------
# ctypes bridge

_HOST_FN = ctypes.CFUNCTYPE(
    ctypes.c_double, ctypes.c_void_p, ctypes.c_int,
    ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ctypes.POINTER(ctypes.c_double), ctypes.c_int)


class _CState(ctypes.Structure):
    _fields_ = [
        ("spl", ctypes.c_double * 64),
        ("sliders", ctypes.c_double * 64),
        ("vars", ctypes.POINTER(ctypes.c_double)),
        ("mem", ctypes.POINTER(ctypes.c_double)),
        ("memN", ctypes.c_int64),
        ("srate", ctypes.c_double),
        ("samplesblock", ctypes.c_double),
        ("midi_bus", ctypes.c_double),
        ("ext_midi_bus", ctypes.c_double),
        ("mt", ctypes.c_uint32 * 624),
        ("mt_idx", ctypes.c_uint32),
        ("pend_change", ctypes.c_uint64),
        ("pend_automate", ctypes.c_uint64),
        ("pend_automate_end", ctypes.c_uint64),
        ("slider_visible", ctypes.c_uint64),
        ("vis_init", ctypes.c_int32),
        ("host_ctx", ctypes.c_void_p),
        ("host", _HOST_FN),
    ]


class NativeShadowPlugin:
    """C-compiled golden plugin, API-compatible with ShadowPlugin."""

    def __init__(self, program: PluginProgram,
                 host: Optional[HostServices] = None):
        self.program = program
        src = generate_c(program)
        self.so_path = build_shared_object(src)
        self.lib = ctypes.CDLL(str(self.so_path))
        for sec in ("init", "slider", "block", "sample"):
            getattr(self.lib, f"jsfx_{sec}").argtypes = [ctypes.POINTER(_CState)]
        self.lib.jsfx_process_block.argtypes = [
            ctypes.POINTER(_CState),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int, ctypes.c_int]

        # python-side state owns vars/mem buffers + services
        self.state = ShadowState(program.user_vars, program.memtop,
                                 dict(program.string_literals), host=host)
        nvars = max(1, len(program.user_vars))
        self._vars = np.zeros(nvars, dtype=np.float64)
        self._var_names = sorted(program.user_vars, key=program.user_vars.get)
        self.state.mem_ensure(65536)

        self.cst = _CState()
        self.cst.vars = self._vars.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        self._bind_mem()
        self.cst.srate = self.state.srate
        self._host_cb = _HOST_FN(self._dispatch)
        self.cst.host = self._host_cb
        self.cst.host_ctx = None

    # -- buffer sync ---------------------------------------------------------

    def _bind_mem(self) -> None:
        self.cst.mem = self.state.mem.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        self.cst.memN = len(self.state.mem)

    def _sync_to_c(self) -> None:
        st = self.state
        for i in range(64):
            self.cst.spl[i] = st.spl[i]
            self.cst.sliders[i] = st.sliders[i]
        for i, name in enumerate(self._var_names):
            self._vars[i] = st.V[name]
        self.cst.srate = st.srate
        self.cst.samplesblock = st.samplesblock
        self.cst.midi_bus = st.midi_bus
        self.cst.ext_midi_bus = st.ext_midi_bus
        self.cst.pend_change = st.pending_change_mask
        self.cst.pend_automate = st.pending_automate_mask
        self.cst.pend_automate_end = st.pending_automate_end_mask
        self.cst.slider_visible = st.slider_visible_mask & ((1 << 64) - 1)
        self.cst.vis_init = st.slider_vis_init
        self._bind_mem()

    def _sync_from_c(self) -> None:
        st = self.state
        st.spl = [self.cst.spl[i] for i in range(64)]
        st.sliders = [self.cst.sliders[i] for i in range(64)]
        for i, name in enumerate(self._var_names):
            st.V[name] = self._vars[i]
        st.samplesblock = self.cst.samplesblock
        st.srate = self.cst.srate
        st.midi_bus = self.cst.midi_bus
        st.ext_midi_bus = self.cst.ext_midi_bus
        st.pending_change_mask = int(self.cst.pend_change)
        st.pending_automate_mask = int(self.cst.pend_automate)
        st.pending_automate_end_mask = int(self.cst.pend_automate_end)
        st.slider_visible_mask = int(self.cst.slider_visible)
        st.slider_vis_init = int(self.cst.vis_init)
        # the heap is shared (host-owned buffer); growth rebinds via callback

    # -- host dispatch -------------------------------------------------------

    def _dispatch(self, _ctx, op, args, nargs, outs, nouts) -> float:
        a = [args[i] for i in range(nargs)] if nargs else []
        st = self.state
        h = st.host
        if op == 1000:  # OP_ENSURE_MEM
            self._ensure_mem_cb(int(a[0]))
            return 0.0
        name = _OPS[op]
        try:
            if name == "gmem_load":
                return h.gmem_load(st, a[0])
            if name == "gmem_store":
                return h.gmem_store(st, a[0], a[1])
            if name == "midirecv":
                r = _midirecv_native(st)
                if r is None:
                    return 0.0
                want = int(a[0])
                if want == 4:
                    for k in range(4):
                        outs[k] = r[k]
                else:
                    outs[0] = r[0]
                    outs[1] = r[1]
                    outs[2] = r[2] + r[3] * 256.0
                return 1.0
            if name == "midisend":
                want = int(a[0])
                vals = a[1:]
                if want == 3:
                    m23 = int(vals[2])
                    vals = [vals[0], vals[1], float(m23 & 255),
                            float((m23 >> 8) & 255)]
                from ..semantics import scalar as SC
                st.midi_out.append(MidiEvent(
                    max(0, SC.trunc_i64(vals[0])), SC.trunc_i64(vals[1]) & 0xFF,
                    SC.trunc_i64(vals[2]) & 0xFF, SC.trunc_i64(vals[3]) & 0xFF))
                return vals[1]
            if name == "midirecv_buf":
                from .pyexec import _midirecv_buf
                r = _midirecv_buf(st, a[0], a[1])
                self._bind_mem()  # recv_buf may have grown the shared heap
                if r is None:
                    return 0.0
                outs[0] = float(r[0])
                return float(r[1])
            if name == "midirecv_str":
                from .pyexec import _midirecv_str
                r = _midirecv_str(st, a[0])
                if r is None:
                    return 0.0
                outs[0] = float(r[0])
                outs[1] = float(r[2])
                return float(r[1])
            if name in ("midisend_buf", "midisyx"):
                from .pyexec import _midisend_buf
                return float(_midisend_buf(st, a[0], a[1], a[2],
                                           name == "midisyx"))
            if name == "midisend_str":
                from .pyexec import _midisend_str
                return float(_midisend_str(st, a[0], a[1]))
            if name == "msg_recv":
                r = h.msg_recv(st, a[0])
                if r is None:
                    return 0.0
                for k in range(6):
                    outs[k] = float(r[k])
                return 1.0
            if name == "msg_recv_buf":
                r = h.msg_recv_buf(st, a[0], a[1], a[2])
                if r is None:
                    return 0.0
                outs[0] = float(r[0])
                outs[1] = float(r[1])
                return float(r[2])
            if name in ("instance_uid", "instance_get_name", "track_name",
                        "msg_peer_name", "msg_peer_uid"):
                r = getattr(h, name)(st, *a)
                if r is None:
                    return 0.0
                outs[0] = float(r[1])
                return float(r[0])
            if name == "file_var":
                r = h.file_var_read(st, a[0])
                if r is None:
                    return 0.0
                outs[0] = float(r[1])
                return float(r[0])
            if name == "file_riff":
                r = h.file_riff_read(st, a[0])
                if r is None:
                    return 0.0
                outs[0] = float(r[0])
                outs[1] = float(r[1])
                return 1.0
            if name == "pool_call":
                return float(h.sample_pool_call(st, _POOL_INV[int(a[0])], a[1:]))
            if name in ("pool_read2", "pool_read2i"):
                r = h.sample_read2(st, a[0], a[1], a[2], name.endswith("i"))
                if r is None:
                    outs[0] = 0.0
                    outs[1] = 0.0
                    return 0.0
                outs[0] = float(r[0])
                outs[1] = float(r[1])
                return 1.0
            if name == "pool_preview":
                r = h.sample_preview_read(st, a[0], a[1], a[2])
                if r is None:
                    return 0.0
                for k in range(3):
                    outs[k] = float(r[k])
                return 1.0
            if name == "file_call":
                return float(h.file_call(st, _FILE_INV[int(a[0])], a[1:]))
            if name in ("fft", "ifft", "fft_real", "ifft_real", "fft_permute",
                        "fft_ipermute"):
                from ..runtime import fftops
                r = fftops.dispatch(st, name, a[0], a[1])
                self._bind_mem()  # fftops may have grown the shared heap
                return float(r)
            if name == "convolve_c":
                from ..runtime import fftops
                r = fftops.convolve_c(st, a[0], a[1], a[2])
                self._bind_mem()
                return float(r)
            fn = getattr(h, name)
            return float(fn(st, *a))
        except Exception:
            return 0.0

    def _ensure_mem_cb(self, needed: int) -> None:
        self.state.mem_ensure(needed)
        self._bind_mem()

    # -- API -----------------------------------------------------------------

    def run_init(self) -> None:
        self._sync_to_c()
        self.lib.jsfx_init(ctypes.byref(self.cst))
        self._sync_from_c()

    def run_slider(self) -> None:
        self._sync_to_c()
        self.lib.jsfx_slider(ctypes.byref(self.cst))
        self._sync_from_c()

    def run_block(self) -> None:
        self._sync_to_c()
        self.lib.jsfx_block(ctypes.byref(self.cst))
        self._sync_from_c()

    def process_block(self, inputs: np.ndarray, outputs: np.ndarray,
                      num_channels: Optional[int] = None) -> None:
        self._sync_to_c()
        n = int(inputs.shape[1]) if inputs.size else int(outputs.shape[1])
        # the C entry sets S->samplesblock itself, but host callbacks that
        # fire mid-block (midisend_* offset clamping) read the PYTHON
        # mirror — keep it current for the whole block
        self.state.samplesblock = float(n)
        ch = num_channels if num_channels is not None else max(
            inputs.shape[0], outputs.shape[0])
        in32 = np.ascontiguousarray(inputs, dtype=np.float32)
        out32 = np.ascontiguousarray(outputs, dtype=np.float32)
        # pad channel pointers up to ch with zero/scratch rows
        need = max(int(ch), in32.shape[0], out32.shape[0])
        if in32.shape[0] < need:
            in32 = np.concatenate(
                [in32, np.zeros((need - in32.shape[0], n), np.float32)])
        if out32.shape[0] < need:
            out32 = np.concatenate(
                [out32, np.zeros((need - out32.shape[0], n), np.float32)])
        in_ptrs = (ctypes.POINTER(ctypes.c_float) * need)(
            *[r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for r in in32])
        out_ptrs = (ctypes.POINTER(ctypes.c_float) * need)(
            *[r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for r in out32])
        self.lib.jsfx_process_block(ctypes.byref(self.cst), in_ptrs, out_ptrs,
                                    int(ch), n)
        outputs[:, :] = out32[: outputs.shape[0]]
        self._sync_from_c()


def _midirecv_native(st: ShadowState):
    if st.midi_in_pos < len(st.midi_in):
        ev = st.midi_in[st.midi_in_pos]
        st.midi_in_pos += 1
        return (float(ev.offset), float(ev.b1), float(ev.b2), float(ev.b3))
    return None


def compile_native_shadow(program: PluginProgram,
                          host: Optional[HostServices] = None) -> NativeShadowPlugin:
    return NativeShadowPlugin(program, host=host)
