"""Section extraction and textual `import` preprocessing.

JSFX source is divided by `@section` marker lines (@init/@slider/@block/
@sample/@gfx/@serialize/...).  `import "file.jsfx-inc"` lines are merged
section-aware: imported text for a section is appended to the importer's
same-named section (ref: dsp_jsfx_aot.py:844-982).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_MARKER_RE = re.compile(r"^\s*@([A-Za-z_][A-Za-z0-9_]*)\b.*$")
_IMPORT_RE = re.compile(
    r"^\s*import\s+(?:\"([^\"]+)\"|'([^']+)'|([^\s;]+))\s*;?\s*(?://.*)?$"
)


def split_sections(text: str) -> Dict[str, Tuple[str, int]]:
    """Return {section: (body_text, first_line)} with 1-based line numbers.

    Lines before the first marker (the description/slider header) are NOT a
    section; retrieve them by slicing the original text.  A section repeated
    later in the file appends to the earlier body.
    """
    bodies: Dict[str, List[str]] = {}
    first_lines: Dict[str, int] = {}
    current: Optional[str] = None

    for lineno, line in enumerate(text.splitlines(True), start=1):
        m = _MARKER_RE.match(line)
        if m:
            current = m.group(1)
            bodies.setdefault(current, [])
            first_lines.setdefault(current, lineno + 1)
            continue
        if current is not None:
            bodies[current].append(line)

    return {sec: ("".join(chunks), first_lines.get(sec, 1))
            for sec, chunks in bodies.items()}


def header_text(text: str) -> str:
    """Everything before the first @section marker (desc/sliders/options)."""
    out: List[str] = []
    for line in text.splitlines(True):
        if _MARKER_RE.match(line):
            break
        out.append(line)
    return "".join(out)


class _Bundle:
    """Section-ordered accumulation of one file (plus its imports)."""

    def __init__(self) -> None:
        self.preamble: List[str] = []
        self.order: List[str] = []
        self.sections: Dict[str, List[str]] = {}
        self.markers: Dict[str, str] = {}

    def section(self, name: str) -> List[str]:
        if name not in self.sections:
            self.sections[name] = []
            self.order.append(name)
        return self.sections[name]

    def absorb(self, other: "_Bundle") -> None:
        self.preamble.extend(other.preamble)
        for sec in other.order:
            if sec not in self.markers and sec in other.markers:
                self.markers[sec] = other.markers[sec]
            self.section(sec).extend(other.sections.get(sec, []))


def _load_bundle(path: Path, stack: List[Path]) -> _Bundle:
    text = path.read_text(encoding="utf-8", errors="replace")
    out = _Bundle()
    current: Optional[str] = None

    for line in text.splitlines(True):
        m_imp = _IMPORT_RE.match(line)
        if m_imp:
            token = next((g for g in m_imp.groups() if g), "")
            if not token:
                (out.preamble if current is None else out.section(current)).append(line)
                continue
            target = (path.parent / token).resolve()
            if not target.exists():
                raise FileNotFoundError(f"cannot resolve JSFX import {token!r} from {path}")
            if target in stack:
                chain = " -> ".join(str(p) for p in stack + [target])
                raise ValueError(f"cyclic JSFX import chain: {chain}")
            child = _load_bundle(target, stack + [target])
            if current is None:
                out.absorb(child)
            else:
                # imported text inside a section: same-section bodies splice
                # in place, other sections append at their own markers
                out.section(current).extend(child.preamble)
                for sec in child.order:
                    if sec == current:
                        out.section(current).extend(child.sections.get(sec, []))
                    else:
                        if sec not in out.markers and sec in child.markers:
                            out.markers[sec] = child.markers[sec]
                        out.section(sec).extend(child.sections.get(sec, []))
            continue

        m_sec = _MARKER_RE.match(line)
        if m_sec:
            current = m_sec.group(1)
            out.markers[current] = line
            out.section(current)
            continue

        (out.preamble if current is None else out.section(current)).append(line)

    return out


def preprocess_imports(text: str, source_path: Optional[Path]) -> str:
    """Resolve `import` lines (needs a filesystem anchor); no-op without one."""
    if source_path is None:
        return text
    src = Path(source_path).resolve()
    bundle = _load_bundle(src, [src])
    lines: List[str] = list(bundle.preamble)
    for sec in bundle.order:
        marker = bundle.markers.get(sec, f"@{sec}\n")
        lines.append(marker if marker.endswith("\n") else marker + "\n")
        lines.extend(bundle.sections.get(sec, []))
        if lines and not lines[-1].endswith("\n"):
            lines.append("\n")
    return "".join(lines)
