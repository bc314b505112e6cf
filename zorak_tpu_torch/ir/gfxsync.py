"""@gfx variable-ownership analysis.

The reference's hybrid gfx/DSP state sync needs per-variable direction
flags: TO_GFX (audio writes it, the UI VM reads it) and FROM_GFX (the UI
VM writes it, audio reads it), plus whether mem[] is shared across the
boundary (ref: dsp_jsfx_aot.py analyze_gfx_var_sync / 1142-1358).  The
offline engine uses the same flags to decide which state a UI/metering
snapshot must carry and which UI writes must be applied at block starts.

Ownership mode comes from `options: ownership=` — legacy (everything
both ways), auto/hybrid (analyzed flags), ui_only (nothing synced).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Set

from ..frontend.astnodes import Asn, CallExpr, Mem, Name, walk
from ..frontend.parser import parse_section
from ..ir.funcsl import extract_function_defs, specialize_user_functions
from ..ir.symbols import is_user_var

TO_GFX = 1
FROM_GFX = 2

AUDIO_SECTIONS = ("slider", "block", "sample", "serialize")


class _Usage:
    def __init__(self) -> None:
        self.reads: Set[str] = set()
        self.writes: Set[str] = set()
        self.reads_mem = False
        self.writes_mem = False

    def merge(self, other: "_Usage") -> None:
        self.reads |= other.reads
        self.writes |= other.writes
        self.reads_mem |= other.reads_mem
        self.writes_mem |= other.writes_mem


def _usage_of(stmts, fn_defs) -> _Usage:
    u = _Usage()

    def scan(root) -> None:
        for n in walk(root):
            if isinstance(n, Name) and is_user_var(n.ident):
                u.reads.add(n.ident)
            if isinstance(n, Mem):
                if isinstance(n.base, Name) and n.base.ident == "gmem":
                    continue
                u.reads_mem = True
            if isinstance(n, Asn):
                t = n.target
                if isinstance(t, Name) and is_user_var(t.ident):
                    u.writes.add(t.ident)
                elif isinstance(t, Mem) and not (
                        isinstance(t.base, Name) and t.base.ident == "gmem"):
                    u.writes_mem = True
            if isinstance(n, CallExpr):
                if n.func in ("memset", "memcpy", "fft", "ifft", "fft_real",
                              "ifft_real", "fft_permute", "fft_ipermute",
                              "convolve_c", "freembuf"):
                    u.writes_mem = True
                if n.func in fn_defs:
                    pass  # bodies are specialized into the section programs

    for s in stmts:
        scan(s)
    return u


def analyze_gfx_var_sync(program) -> Dict[str, Any]:
    """Analyze a PluginProgram's gfx/audio variable traffic."""
    # parse the gfx section with the same lowering pipeline
    raw = program.raw_sections
    sections = {}
    for sec in ("init",) + AUDIO_SECTIONS + ("gfx",):
        if sec in raw:
            body, first = raw[sec]
            sections[sec] = parse_section(body, first_line=first)
        else:
            sections[sec] = []
    fn_defs, sections = extract_function_defs(sections)
    sections, fn_defs = specialize_user_functions(sections, fn_defs)

    gfx = _usage_of(sections.get("gfx", []), fn_defs)
    audio = _Usage()
    for sec in AUDIO_SECTIONS:
        audio.merge(_usage_of(sections.get(sec, []), fn_defs))
    # function bodies (specialized per section name prefix) contribute too
    for name, f in fn_defs.items():
        target = gfx if name.startswith("__fn__gfx__") else audio
        target.merge(_usage_of([f.body], fn_defs))

    mode = str(program.options.get("ownership", "legacy") or "legacy").lower()
    all_vars = set(program.user_vars)

    if mode == "ui_only":
        flags = {name: 0 for name in all_vars}
        mem_shared = False
    elif mode in ("auto", "hybrid"):
        flags = {}
        for name in all_vars:
            f = 0
            if name in audio.writes and name in gfx.reads:
                f |= TO_GFX
            if name in gfx.writes and name in audio.reads:
                f |= FROM_GFX
            flags[name] = f
        mem_shared = (gfx.reads_mem or gfx.writes_mem) and \
            (audio.reads_mem or audio.writes_mem)
        mode = "hybrid"
    else:
        mode = "legacy"
        flags = {name: TO_GFX | FROM_GFX for name in all_vars}
        mem_shared = True

    return {
        "mode": mode,
        "flags": flags,
        "gfx_reads": gfx.reads,
        "gfx_writes": gfx.writes,
        "audio_reads": audio.reads,
        "audio_writes": audio.writes,
        "mem_shared": mem_shared,
        "mem_ranges": parse_gfx_sync_mem_ranges(program.source),
    }


# explicit sparse mem mirror ranges: `// @za:gfx_sync_mem: base, count
# [, direction]`, direction in TO_GFX (default) / FROM_GFX / GFX_TO_DSP /
# BIDIR(ECTIONAL) / BOTH (ref: JSFXJuceProcessor.cpp:590-628)
_SYNC_RE = re.compile(
    r"^\s*//\s*@za:gfx_sync_mem\s*:?\s*([0-9]+)\s*(?:,|\s)\s*([0-9]+)"
    r"(?:\s*(?:,|\s)\s*([A-Za-z0-9_\-]+))?.*$",
    re.IGNORECASE)


def parse_gfx_sync_mem_ranges(source: str):
    """[(base, count, flags)] with flags bits TO_GFX/FROM_GFX."""
    out = []
    for line in (source or "").splitlines():
        m = _SYNC_RE.match(line)
        if not m:
            continue
        base, count = int(m.group(1)), int(m.group(2))
        if base < 0 or count <= 0:
            continue
        tok = (m.group(3) or "").upper()
        if tok in ("FROM_GFX", "GFX_TO_DSP"):
            flags = FROM_GFX
        elif tok in ("BIDIR", "BIDIRECTIONAL", "BOTH"):
            flags = TO_GFX | FROM_GFX
        else:
            flags = TO_GFX
        out.append((base, count, flags))
    return out


def build_gfx_mirror_ranges(mem_n: int, extra=(),
                            prefix: int = 1 << 18,
                            suffix: int = 1 << 21):
    """Bounded automatic prefix + suffix mirror of the logical heap plus
    explicit TO_GFX sparse ranges, sorted and merged
    (ref: JSFXJuceProcessor.cpp:339-379 buildGfxMirrorRanges + :9682)."""
    ranges = []
    if mem_n > 0:
        pc = min(mem_n, prefix)
        ranges.append((0, pc))
        if mem_n > pc:
            sc = min(mem_n - pc, suffix)
            if sc > 0:
                ranges.append((mem_n - sc, sc))
    for base, count, flags in extra:
        if not (flags & TO_GFX) or count <= 0 or base < 0:
            continue
        if base >= mem_n:
            continue
        ranges.append((base, min(count, mem_n - base)))
    ranges.sort()
    merged = []
    for base, count in ranges:
        if merged and base <= merged[-1][0] + merged[-1][1]:
            pb, pc = merged[-1]
            merged[-1] = (pb, max(pb + pc, base + count) - pb)
        else:
            merged.append((base, count))
    return merged[:16]  # kMaxGfxMemSpans
