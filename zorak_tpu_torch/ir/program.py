"""PluginProgram: the fully-analyzed compilation unit every backend consumes.

Pipeline (mirrors ref: dsp_jsfx_aot.py:2275-2400):
    source text -> import preprocessing -> section split -> parse ->
    function extraction -> section/namespace specialization ->
    section-legality validation -> user-var table -> capability analyses.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..frontend import directives as D
from ..frontend.astnodes import FuncDef, Node, Str, walk
from ..frontend.parser import parse_section
from ..frontend.sections import header_text, preprocess_imports, split_sections
from . import analyses as A
from .funcsl import extract_function_defs, specialize_user_functions
from .symbols import collect_user_vars

# Sections the DSP engines compile. @serialize is compiled for the golden
# executors only (the reference AOT likewise leaves it to the shadow VM,
# ref: dsp_jsfx_aot.py _OPT_DEBUG_SECTION_ORDER); @gfx is a UI concern
# analyzed separately (ir/gfxsync.py).
DSP_SECTIONS = ("init", "slider", "block", "sample")
SHADOW_SECTIONS = DSP_SECTIONS + ("serialize",)

STRING_HANDLE_BASE = 1 << 40  # opaque string-literal handles (ref: dsp_jsfx_aot.py:3694)


@dataclass
class PluginProgram:
    source: str
    path: Optional[Path]
    sections: Dict[str, List[Node]]            # post-lowering DSP statements
    fn_defs: Dict[str, FuncDef]                # specialized (params only)
    user_vars: Dict[str, int]
    options: Dict[str, str]
    memtop: int
    desc: str
    slider_decls: List[D.SliderDecl] = field(default_factory=list)
    fileslot_decls: List[D.FileSlotDecl] = field(default_factory=list)
    pin_hints: Dict[str, Optional[int]] = field(default_factory=dict)
    io_channels: Dict[str, int] = field(default_factory=dict)
    midi: Dict[str, bool] = field(default_factory=dict)
    comm: Dict[str, Any] = field(default_factory=dict)
    sample_pool: Dict[str, bool] = field(default_factory=dict)
    plugin_kind: str = "audio_effect"
    help_text: str = ""
    string_literals: Dict[str, int] = field(default_factory=dict)
    raw_sections: Dict[str, Any] = field(default_factory=dict)

    @property
    def has_sample_section(self) -> bool:
        return bool(self.sections.get("sample"))

    def string_handle(self, text: str) -> int:
        if text not in self.string_literals:
            self.string_literals[text] = STRING_HANDLE_BASE + len(self.string_literals)
        return self.string_literals[text]

    def capabilities(self) -> Dict[str, Any]:
        return {
            "io_channels": dict(self.io_channels),
            "midi": dict(self.midi),
            "comm": dict(self.comm),
            "sample_pool": dict(self.sample_pool),
            "plugin_kind": self.plugin_kind,
            "memtop": self.memtop,
            "sections_present": {s: bool(self.sections.get(s)) for s in DSP_SECTIONS},
        }


def _infer_plugin_kind(midi: Dict[str, bool], io: Dict[str, int]) -> str:
    # ref: dsp_jsfx_aot.py:2367-2376
    if not midi["uses_midi"]:
        return "audio_effect"
    if io["inputs"] == 0 and io["outputs"] == 0:
        return "midi_effect"
    if io["inputs"] == 0 and io["outputs"] > 0 and midi["accepts_midi_input"]:
        return "instrument"
    if io["inputs"] > 0 or io["outputs"] > 0:
        return "hybrid"
    return "midi_effect"


def compile_plugin_source(text: str, path: Optional[Path] = None) -> PluginProgram:
    text = preprocess_imports(text, path)

    raw_sections = split_sections(text)
    programs: Dict[str, List[Node]] = {}
    for sec in SHADOW_SECTIONS:
        if sec in raw_sections:
            body, first_line = raw_sections[sec]
            programs[sec] = parse_section(body, first_line=first_line)
        else:
            programs[sec] = []

    fn_defs, programs = extract_function_defs(programs)
    programs, fn_defs = specialize_user_functions(programs, fn_defs)
    A.validate_builtin_sections({k: v for k, v in programs.items()
                                 if k in DSP_SECTIONS})

    user_vars = collect_user_vars(programs, fn_defs)

    head = header_text(text)
    options = D.parse_options(text)
    slider_decls, help_txt = D.parse_slider_decls(text)
    fileslots = D.parse_fileslot_decls(head)
    pin_hints = D.parse_pin_decls(text)
    io = A.infer_spl_io(programs, fn_defs, pin_hints=pin_hints)
    midi = A.detect_midi_usage(programs, fn_defs)
    comm = A.detect_comm_usage(programs, fn_defs)
    pool = A.detect_sample_pool_usage(programs, fn_defs)

    prog = PluginProgram(
        source=text,
        path=path,
        sections=programs,
        fn_defs=fn_defs,
        user_vars=user_vars,
        options=options,
        memtop=D.memtop_slots(options),
        desc=D.parse_desc(head),
        slider_decls=slider_decls,
        fileslot_decls=fileslots,
        pin_hints=pin_hints,
        io_channels=io,
        midi=midi,
        comm=comm,
        sample_pool=pool,
        plugin_kind=_infer_plugin_kind(midi, io),
        help_text=help_txt,
        raw_sections=raw_sections,
    )

    # Intern every string literal up front so all backends agree on handles.
    for sec_prog in programs.values():
        for stmt in sec_prog:
            for n in walk(stmt):
                if isinstance(n, Str):
                    prog.string_handle(n.text)
    for f in fn_defs.values():
        for n in walk(f.body):
            if isinstance(n, Str):
                prog.string_handle(n.text)

    return prog


def load_plugin_file(path: str | Path) -> PluginProgram:
    p = Path(path)
    return compile_plugin_source(p.read_text(encoding="utf-8", errors="replace"), p)
