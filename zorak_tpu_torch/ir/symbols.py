"""Symbol model: spl registers, slider registers, builtins, user variables.

Mirrors the reference's symbol rules (ref: dsp_jsfx_aot.py:981-1099):
spl0..spl63 and slider1..slider64 are registers (an identifier like
`splitSamp` or `sliderGain` is an ordinary variable); `mem` is numeric base
0 of the heap; `$pi`/`$e`/`$phi`/`$x...` are constants, not variables.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Set

from ..frontend.astnodes import FuncDef, Name, Node, walk

BUILTINS = frozenset({"mem", "gmem", "srate", "samplesblock", "midi_bus", "ext_midi_bus"})


def spl_index(ident: str) -> Optional[int]:
    if ident.startswith("spl") and ident[3:].isdigit():
        idx = int(ident[3:])
        if 0 <= idx < 64:
            return idx
        raise ValueError(f"invalid spl register {ident!r}")
    return None


def slider_index(ident: str) -> Optional[int]:
    """0-based index for slider1..slider64, else None."""
    if ident.startswith("slider") and ident[6:].isdigit():
        n = int(ident[6:])
        if 1 <= n <= 64:
            return n - 1
        raise ValueError(f"invalid slider register {ident!r}")
    return None


def is_spl(ident: str) -> bool:
    return ident.startswith("spl") and ident[3:].isdigit()


def is_slider_reg(ident: str) -> bool:
    return ident.startswith("slider") and ident[6:].isdigit()


def dollar_const(ident: str) -> Optional[float]:
    if ident == "$pi":
        return math.pi
    if ident == "$e":
        return math.e
    if ident == "$phi":
        return (1.0 + math.sqrt(5.0)) * 0.5
    if ident.startswith("$x") and len(ident) > 2:
        try:
            return float(int(ident[2:], 16))
        except ValueError:
            return None
    if ident.startswith("$'") or ident.startswith("$"):
        return None
    return None


def is_user_var(ident: str, local_names: Set[str] = frozenset()) -> bool:
    if ident in local_names or ident in BUILTINS:
        return False
    if is_spl(ident) or is_slider_reg(ident):
        return False
    if ident.startswith("$"):
        return False
    return True


def collect_user_vars(section_programs: Dict[str, List[Node]],
                      fn_defs: Dict[str, FuncDef]) -> Dict[str, int]:
    """Stable name -> index map over every user variable mentioned anywhere."""
    names: Set[str] = set()

    def scan(root: Node, locals_: Set[str]) -> None:
        for n in walk(root):
            if isinstance(n, Name) and is_user_var(n.ident, locals_):
                names.add(n.ident)

    for prog in section_programs.values():
        for stmt in prog:
            scan(stmt, set())
    for f in fn_defs.values():
        scan(f.body, set(f.params) | set(f.local_names))

    return {name: i for i, name in enumerate(sorted(names))}
