"""@gfx interpreter: the UI VM of the framework.

Mirrors the reference's portable-EEL2 gfx VM (ref:
src/YSFXGfxInterpreter.h — GfxVm :507, DrawCmd :438, Interpreter :2042):
@init + @gfx compile with the SAME EEL2 pipeline as the DSP sections and
run against state snapshots; the gfx API records DrawCmds for the host
to replay (the reference replays into a juce::Image; offline consumers
use the command list directly for metering/regression).

State synchronization follows the ownership analysis (ir/gfxsync.py):
TO_GFX vars copy DSP -> VM before a frame, FROM_GFX writes collect after
a frame for application at the next block start (ref: gfx snapshots
JSFXJuceProcessor.cpp:221-380, applyQueuedGfxStateWrites :9409)."""
from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..frontend.parser import parse_section
from ..ir.funcsl import extract_function_defs, specialize_user_functions
from ..ir.gfxsync import FROM_GFX, TO_GFX, analyze_gfx_var_sync
from ..ir.program import PluginProgram
from ..ir.symbols import collect_user_vars
from ..shadow.pyexec import _compile_callable, _exec_namespace, _py_fn_name
from ..shadow.state import ShadowState

_GFX_DIMS_RE = re.compile(r"^@gfx[ \t]+(\d+)(?:[ \t]+(\d+))?", re.MULTILINE)

# mem prefix mirrored into the UI VM when mem is shared across the
# boundary (ref: 256k-double snapshot prefix, JSFXJuceProcessor.cpp:221)
GFX_MEM_PREFIX = 1 << 18


@dataclass
class DrawCmd:
    op: str
    args: Tuple[float, ...] = ()
    color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    text: str = ""
    mode: int = 0


# proportional advance ratios (fraction of font size) for a typical UI
# sans face — closer to the reference's JUCE font metrics than a flat
# monospace estimate; unknown glyphs take the average ratio
_CHAR_RATIO = {}
for _chars, _r in (
        ("iljI.,:;'|!", 0.24), ("ftr()[]{}-\"/ ", 0.30),
        ("abcdeghknopqsuvxyz", 0.52), ("w", 0.72), ("m", 0.82),
        ("ABCDEFGHKNPRSTUVXYZ", 0.66), ("MW", 0.86), ("OQ", 0.74),
        ("JL", 0.52), ("0123456789", 0.556), ("@", 1.0), ("%", 0.85),
        ("+=<>~^*#&", 0.58), ("_", 0.5)):
    for _c in _chars:
        _CHAR_RATIO[_c] = _r
_AVG_RATIO = 0.55


def text_width(text: str, size: float) -> float:
    return float(size) * sum(_CHAR_RATIO.get(c, _AVG_RATIO) for c in text)


class GfxCanvas:
    """Records the gfx call stream of one frame AND rasterizes it.

    Color/position state lives in the VM's EEL vars (gfx_r/g/b/a/x/y/...)
    exactly as in JSFX; the canvas snapshots them per command and draws
    the primitive into the current gfx_dest surface (gfx/raster.py) so
    gfx_getpixel / gfx_blit read real pixels."""

    def __init__(self) -> None:
        from .raster import Raster

        self.cmds: List[DrawCmd] = []
        self.char_queue: List[float] = []
        self.menu_choice = 0.0
        self.raster = Raster()

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _v(S, name: str) -> float:
        return float(S.V.get(name, 0.0))

    def _color(self, S):
        return (self._v(S, "gfx_r"), self._v(S, "gfx_g"),
                self._v(S, "gfx_b"), self._v(S, "gfx_a"))

    def _rec(self, S, op: str, args: Sequence[float], text: str = "") -> None:
        self.cmds.append(DrawCmd(op, tuple(float(a) for a in args),
                                 self._color(S), text,
                                 int(self._v(S, "gfx_mode"))))

    @staticmethod
    def _text_of(S, handle: float) -> str:
        return S.strings_by_handle.get(int(handle), "")

    def _surf(self, S):
        dest = int(self._v(S, "gfx_dest") if "gfx_dest" in S.V else -1.0)
        if dest < 0:
            return self.raster.main(int(self._v(S, "gfx_w") or 0),
                                    int(self._v(S, "gfx_h") or 0))
        return self.raster.image(dest, create=True)

    def _rgb(self, S):
        return (self._v(S, "gfx_r"), self._v(S, "gfx_g"),
                self._v(S, "gfx_b"))

    def _additive(self, S) -> bool:
        return bool(int(self._v(S, "gfx_mode")) & 1)

    def _texth(self, S) -> float:
        return float(S.V.get("gfx_texth", 10.0) or 10.0)

    # -- dispatch --------------------------------------------------------------

    def call(self, S, fn: str, args: List[float]):
        a = list(args)

        def arg(i, default=0.0):
            return float(a[i]) if i < len(a) else default

        if fn == "gfx_set":
            # r [g b a mode dest a2] — g/b default to r (ref gfx_set)
            S.V["gfx_r"] = arg(0)
            S.V["gfx_g"] = arg(1, arg(0))
            S.V["gfx_b"] = arg(2, arg(0))
            if len(a) > 3:
                S.V["gfx_a"] = arg(3)
            if len(a) > 4:
                S.V["gfx_mode"] = arg(4)
            if len(a) > 5:
                S.V["gfx_dest"] = arg(5)
            if len(a) > 6:
                S.V["gfx_a2"] = arg(6)
            return 0.0
        if fn == "gfx_line":
            self._rec(S, "line", a[:4] + [arg(4, 1.0)])
            self.raster.line(self._surf(S), arg(0), arg(1), arg(2), arg(3),
                             self._rgb(S), self._v(S, "gfx_a"),
                             self._additive(S))
            S.V["gfx_x"], S.V["gfx_y"] = arg(2), arg(3)
            return 0.0
        if fn == "gfx_lineto":
            x0, y0 = self._v(S, "gfx_x"), self._v(S, "gfx_y")
            self._rec(S, "line", (x0, y0, arg(0), arg(1), arg(2, 1.0)))
            self.raster.line(self._surf(S), x0, y0, arg(0), arg(1),
                             self._rgb(S), self._v(S, "gfx_a"),
                             self._additive(S))
            S.V["gfx_x"], S.V["gfx_y"] = arg(0), arg(1)
            return 0.0
        if fn == "gfx_rect":
            self._rec(S, "rect", a[:4] + [arg(4, 1.0)])
            self.raster.fill_rect(self._surf(S), arg(0), arg(1), arg(2),
                                  arg(3), self._rgb(S), self._v(S, "gfx_a"),
                                  self._additive(S),
                                  fill=bool(arg(4, 1.0)))
            return 0.0
        if fn == "gfx_rectto":
            x0, y0 = self._v(S, "gfx_x"), self._v(S, "gfx_y")
            rx, ry = min(x0, arg(0)), min(y0, arg(1))
            rw, rh = abs(arg(0) - x0), abs(arg(1) - y0)
            self._rec(S, "rect", (rx, ry, rw, rh, 1.0))
            self.raster.fill_rect(self._surf(S), rx, ry, rw, rh,
                                  self._rgb(S), self._v(S, "gfx_a"),
                                  self._additive(S))
            S.V["gfx_x"], S.V["gfx_y"] = arg(0), arg(1)
            return 0.0
        if fn == "gfx_circle":
            self._rec(S, "circle", (arg(0), arg(1), arg(2), arg(3),
                                    arg(4, 1.0)))
            self.raster.circle(self._surf(S), arg(0), arg(1), arg(2),
                               self._rgb(S), self._v(S, "gfx_a"),
                               self._additive(S), fill=bool(arg(3)))
            return 0.0
        if fn == "gfx_arc":
            self._rec(S, "arc", (arg(0), arg(1), arg(2), arg(3), arg(4),
                                 arg(5, 1.0)))
            return 0.0
        if fn == "gfx_roundrect":
            self._rec(S, "roundrect", (arg(0), arg(1), arg(2), arg(3),
                                       arg(4), arg(5, 1.0)))
            self.raster.fill_rect(self._surf(S), arg(0), arg(1), arg(2),
                                  arg(3), self._rgb(S), self._v(S, "gfx_a"),
                                  self._additive(S),
                                  fill=bool(arg(5, 1.0)))
            return 0.0
        if fn == "gfx_triangle":
            self._rec(S, "triangle", a[:6])
            self.raster.triangle(self._surf(S),
                                 ((arg(0), arg(1)), (arg(2), arg(3)),
                                  (arg(4), arg(5))),
                                 self._rgb(S), self._v(S, "gfx_a"),
                                 self._additive(S))
            return 0.0
        if fn == "gfx_setpixel":
            self._rec(S, "setpixel", (self._v(S, "gfx_x"),
                                      self._v(S, "gfx_y"),
                                      arg(0), arg(1), arg(2)))
            self.raster.set_pixel(self._surf(S), self._v(S, "gfx_x"),
                                  self._v(S, "gfx_y"),
                                  (arg(0), arg(1), arg(2)))
            return 0.0
        if fn == "gfx_getpixel":
            r, g, b = self.raster.get_pixel(self._surf(S),
                                            self._v(S, "gfx_x"),
                                            self._v(S, "gfx_y"))
            return (r, g, b)
        if fn == "gfx_setimgdim":
            img = self.raster.image(int(arg(0)), create=True)
            img.resize(arg(1), arg(2))
            return 1.0
        if fn == "gfx_getimgdim":
            img = self.raster.image(int(arg(0)))
            if img is None:
                return (0.0, 0.0)
            return (float(img.w), float(img.h))
        if fn == "gfx_loadimg":
            # no image decoding in the offline engine: honest failure like
            # a missing file (ref returns -1 on load failure)
            return -1.0
        if fn == "gfx_blit" or fn == "gfx_blitext":
            src = self.raster.image(int(arg(0)))
            self._rec(S, "blit", a)
            if src is None:
                return 0.0
            scale = arg(1, 1.0) or 1.0
            if len(a) > 3:
                sx, sy = arg(3), arg(4)
                sw = arg(5, float(src.w))
                sh = arg(6, float(src.h))
                dx = arg(7, self._v(S, "gfx_x"))
                dy = arg(8, self._v(S, "gfx_y"))
                dw = arg(9, sw * scale)
                dh = arg(10, sh * scale)
            else:
                sx, sy, sw, sh = 0.0, 0.0, float(src.w), float(src.h)
                dx, dy = self._v(S, "gfx_x"), self._v(S, "gfx_y")
                dw, dh = sw * scale, sh * scale
            self.raster.blit(self._surf(S), src, dx, dy, dw, dh,
                             sx, sy, sw, sh, self._v(S, "gfx_a"),
                             self._additive(S))
            return 0.0
        if fn == "gfx_setfont":
            name = self._text_of(S, arg(1)) if len(a) > 1 else ""
            sz = arg(2, 10.0)
            self._rec(S, "setfont", (arg(0), sz, arg(3)), text=name)
            if sz > 0:
                S.V["gfx_texth"] = sz
            return 0.0
        if fn == "gfx_measurestr":
            text = self._text_of(S, arg(0))
            return (text_width(text, self._texth(S)), self._texth(S))
        if fn == "gfx_drawstr":
            text = self._text_of(S, arg(0))
            self._rec(S, "drawstr",
                      (self._v(S, "gfx_x"), self._v(S, "gfx_y"),
                       arg(1), arg(2), arg(3)), text=text)
            S.V["gfx_x"] = self._v(S, "gfx_x") \
                + text_width(text, self._texth(S))
            return 0.0
        if fn == "gfx_drawnumber":
            nd = max(0, int(arg(1)))
            text = f"{arg(0):.{nd}f}"
            self._rec(S, "drawstr", (self._v(S, "gfx_x"),
                                     self._v(S, "gfx_y")), text=text)
            S.V["gfx_x"] = self._v(S, "gfx_x") \
                + text_width(text, self._texth(S))
            return 0.0
        if fn == "gfx_drawchar":
            text = chr(int(arg(0))) if 0 < arg(0) < 0x110000 else ""
            self._rec(S, "drawstr", (self._v(S, "gfx_x"),
                                     self._v(S, "gfx_y")), text=text)
            S.V["gfx_x"] = self._v(S, "gfx_x") \
                + text_width(text or " ", self._texth(S))
            return 0.0
        if fn == "gfx_getchar":
            return self.char_queue.pop(0) if self.char_queue else 0.0
        if fn in ("gfx_showmenu", "gfx_showmenu_nonblocking"):
            self._rec(S, "showmenu", (), text=self._text_of(S, arg(0)))
            return self.menu_choice
        if fn == "gfx_clienttoscreen" or fn == "gfx_screentoclient":
            return 0.0
        # blit/getpixel/muldest/... : record generically, return 0
        self._rec(S, fn[4:] if fn.startswith("gfx_") else fn, a)
        return 0.0


class GfxVM:
    """Compiles @init + @gfx of a plugin into a standalone UI VM."""

    def __init__(self, program: PluginProgram,
                 canvas: Optional[GfxCanvas] = None):
        raw = program.raw_sections
        sections: Dict[str, List] = {}
        for sec in ("init", "gfx"):
            if sec in raw:
                body, first = raw[sec]
                sections[sec] = parse_section(body, first_line=first)
            else:
                sections[sec] = []
        fn_defs, sections = extract_function_defs(sections)
        sections, fn_defs = specialize_user_functions(sections, fn_defs)
        user_vars = collect_user_vars(sections, fn_defs)

        self.program = replace(program, sections=sections, fn_defs=fn_defs,
                               user_vars=user_vars)
        # @gfx is outside the DSP sections, so its string literals were not
        # interned at plugin compile; intern them now (handles stay shared
        # with the DSP program — same dict)
        from ..frontend.astnodes import Str, walk as _walk

        for sec_prog in sections.values():
            for stmt in sec_prog:
                for nd in _walk(stmt):
                    if isinstance(nd, Str):
                        self.program.string_handle(nd.text)
        for f in fn_defs.values():
            for nd in _walk(f.body):
                if isinstance(nd, Str):
                    self.program.string_handle(nd.text)
        self.canvas = canvas or GfxCanvas()
        self.state = ShadowState(user_vars, program.memtop,
                                 program.string_literals)
        self.state.host.gfx = self.canvas
        for text, handle in program.string_literals.items():
            self.state.strings_by_handle[handle] = text
            self.state.handles_by_string[text] = handle

        m = _GFX_DIMS_RE.search(program.source)
        self.width = float(m.group(1)) if m else 400.0
        self.height = float(m.group(2)) if m and m.group(2) else 300.0

        ns = _exec_namespace(self.program)
        for spec_name, proto in fn_defs.items():
            _compile_callable(self.program, ns, _py_fn_name(spec_name),
                              proto.params, [proto.body], return_last=True)
        self._init_fn = _compile_callable(self.program, ns, "__sec_init",
                                          (), sections["init"], False)
        self._gfx_fn = _compile_callable(self.program, ns, "__sec_gfx",
                                         (), sections["gfx"], False)
        self._inited = False

    def run_frame(self, width: Optional[float] = None,
                  height: Optional[float] = None,
                  mouse: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                  chars: Sequence[float] = ()) -> List[DrawCmd]:
        st = self.state
        st.V["gfx_w"] = float(width if width is not None else self.width)
        st.V["gfx_h"] = float(height if height is not None else self.height)
        st.V["mouse_x"], st.V["mouse_y"], st.V["mouse_cap"] = (
            float(mouse[0]), float(mouse[1]), float(mouse[2]))
        st.V.setdefault("gfx_texth", 10.0)
        self.canvas.cmds = []
        self.canvas.char_queue = list(chars)
        if not self._inited:
            self._init_fn(st)
            self._inited = True
        self._gfx_fn(st)
        return self.canvas.cmds


class GfxSession:
    """DSP <-> UI state bridge for one plugin instance.

    frame() pulls a snapshot from the DSP state (sliders always; vars and
    mem per the ownership flags), runs one @gfx frame, and returns
    (draw commands, queued FROM_GFX writes) — the writes are what the
    engine applies at the next block start."""

    def __init__(self, program: PluginProgram):
        from ..ir.gfxsync import FROM_GFX as _FG, parse_gfx_sync_mem_ranges

        self.sync = analyze_gfx_var_sync(program)
        self.vm = GfxVM(program)
        flags = self.sync["flags"]
        self.to_gfx = sorted(n for n, f in flags.items() if f & TO_GFX)
        self.from_gfx = sorted(n for n, f in flags.items() if f & FROM_GFX)
        self.mem_shared = bool(self.sync["mem_shared"])
        self.mem_ranges = list(self.sync.get("mem_ranges", ()))
        self.from_gfx_mem = [(b, c) for b, c, f in self.mem_ranges
                             if f & _FG]

    def _mirror_ranges(self, dsp_state):
        from ..ir.gfxsync import build_gfx_mirror_ranges

        mem_n = max(int(getattr(dsp_state, "mem_used", 0)),
                    min(len(dsp_state.mem), GFX_MEM_PREFIX))
        mem_n = min(mem_n, len(dsp_state.mem))
        return build_gfx_mirror_ranges(mem_n, self.mem_ranges)

    def frame(self, dsp_state, **kw) -> Tuple[List[DrawCmd],
                                              Dict[str, float]]:
        vst = self.vm.state
        vst.sliders = list(dsp_state.sliders)
        vst.srate = dsp_state.srate
        for name in self.to_gfx:
            vst.V[name] = float(dsp_state.V.get(name, 0.0))
        if self.mem_shared:
            # bounded prefix + suffix + explicit sparse ranges
            # (ref: JSFXJuceProcessor.cpp:221-380, 9682)
            for base, count in self._mirror_ranges(dsp_state):
                vst.mem_ensure(base + count)
                vst.mem[base:base + count] = dsp_state.mem[base:base + count]
        before = {name: float(vst.V.get(name, 0.0))
                  for name in self.from_gfx}
        mem_before = {}
        for b, c in self.from_gfx_mem:
            vst.mem_ensure(b + c)
            mem_before[(b, c)] = np.array(vst.mem[b:b + c])
        cmds = self.vm.run_frame(**kw)
        writes = {name: float(vst.V.get(name, 0.0))
                  for name in self.from_gfx
                  if float(vst.V.get(name, 0.0)) != before[name]}
        mem_writes = {}
        for (b, c), old in mem_before.items():
            cur = np.asarray(vst.mem[b:b + c])
            idx = np.nonzero(cur != old)[0]
            if idx.size:
                mem_writes[(b, c)] = (idx + b, cur[idx].copy())
        if mem_writes:
            writes = dict(writes)
            writes["__mem__"] = mem_writes  # type: ignore[assignment]
        return cmds, writes

    @staticmethod
    def apply_writes(dsp_state, writes: Dict[str, float]) -> None:
        """Apply queued UI-authored var (and FROM_GFX-range mem) writes at
        a block boundary (ref: applyQueuedGfxStateWrites,
        JSFXJuceProcessor.cpp:9396-9420)."""
        mem_writes = writes.get("__mem__")
        for name, value in writes.items():
            if name == "__mem__":
                continue
            dsp_state.V[name] = value
        if mem_writes:
            for (_b, _c), (addrs, vals) in mem_writes.items():
                dsp_state.mem_ensure(int(addrs.max()) + 1)
                dsp_state.mem[addrs] = vals
