"""The JAX-free layers the port copies: each copy equals its source file
byte for byte, and both packages compile the same plugin text to the same
program (printed sections, symbols, sliders)."""
from pathlib import Path

import pytest

from zorak_tpu.frontend.printer import program_text as jax_text
from zorak_tpu.ir import compile_plugin_source as jax_compile

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.frontend.printer import program_text
from zorak_tpu_torch.ir import compile_plugin_source

ROOT = Path(__file__).resolve().parents[1]

VERBATIM = [
    *(f"frontend/{m}.py" for m in ("__init__", "astnodes", "directives",
                                   "lexer", "parser", "printer", "sections")),
    *(f"ir/{m}.py" for m in ("__init__", "analyses", "funcsl", "gfxsync",
                             "program", "symbols")),
    *(f"semantics/{m}.py" for m in ("__init__", "scalar", "mt19937np")),
    "shadow/state.py", "shadow/pyexec.py", "runtime/fftops.py",
    "shadow/__init__.py", "shadow/cgen.py",
]

PLUGINS = {
    "fallback": builtin_plugins.FALLBACK_SRC,
    "wide": builtin_plugins.wide_delay_network(24, buf=4096, max_delay=3000),
    "functions": (
        "desc:helpers\nslider1:0.5<0,1,0.01>Mix\nslider2:3<0,4,1{a,b,c,d,e}>Mode\n"
        "@init\nfunction clamp(x a b) ( x < a ? a : (x > b ? b : x) );\n"
        "function lp(x) instance(z) ( z = 0.9*z + 0.1*x; z );\n"
        "@slider\nmix = slider1;\n"
        "@block\nc += 1; c == 3 ? ( slider1 = 5; sliderchange(slider1); );\n"
        "@sample\nspl0 = f.lp(clamp(spl0, -0.5, 0.5)) * mix;\n"
        "while (spl1 > 1) ( spl1 -= 2; );\n"),
    "midi": (
        "desc:midi thru\n@block\n"
        "while (midirecv(ofs, m1, m2, m3)) ( midisend(ofs, m1, m2, m3); );\n"
        "@sample\nspl0 = spl0;\n"),
}


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_is_byte_identical(rel):
    ours = (ROOT / "zorak_tpu_torch" / rel).read_bytes()
    theirs = (ROOT / "zorak_tpu" / rel).read_bytes()
    assert ours == theirs


@pytest.mark.parametrize("name", sorted(PLUGINS))
def test_both_packages_compile_the_same_program(name):
    prog, jprog = compile_plugin_source(PLUGINS[name]), jax_compile(PLUGINS[name])
    assert sorted(prog.sections) == sorted(jprog.sections)
    for sec, stmts in prog.sections.items():
        assert program_text(stmts) == jax_text(jprog.sections[sec]), sec
    assert prog.desc == jprog.desc
    assert prog.capabilities() == jprog.capabilities()
    assert [(d.index0, d.default, d.label) for d in prog.slider_decls] == \
        [(d.index0, d.default, d.label) for d in jprog.slider_decls]
    assert sorted(prog.fn_defs) == sorted(jprog.fn_defs)
    assert prog.memtop == jprog.memtop
