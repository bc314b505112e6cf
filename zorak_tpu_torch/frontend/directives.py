"""Header-directive parsing: desc, sliders, pins, options, file slots.

These live in the pre-@section header of a JSFX file.  Grammar follows the
reference host's metadata parsers (ref: src/JSFXJuceProcessor.cpp:526-1084):

  slider<N>:[var=]<default><min,max,step[:log|:sqr[=mod]][{A,B,C}]>Label
  slider<N>:#var="default"<string>Label          (string slider)
  filename:<N>,<token>                           (file slot declaration)
  in_pin:<name> / out_pin:<name> / *_pin:none    (channel pin counts)
  options: key=value key=value ...               (maxmem, ownership, gmem=..)
  desc:<text>
  // #TOOLTIP: ... (attaches to next slider)   // #HELP: ... (accumulates)

A label starting with '-' marks the slider hidden.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEFAULT_MEMTOP_SLOTS = 8 * 1024 * 1024  # ref: dsp_jsfx_aot.py:1140

_SLIDER_RE = re.compile(r"^\s*slider\s*([0-9]{1,2})\s*:\s*([^<\r\n;]+)\s*(?:<\s*([^>]*)\s*>)?\s*(.*)$")
_TOOLTIP_RE = re.compile(r"^\s*//\s*#TOOLTIP:\s*(.*)$")
_HELP_RE = re.compile(r"^\s*//\s*#HELP:\s*(.*)$")
_FILESLOT_RE = re.compile(r"^\s*filename\s*:\s*([0-9]+)\s*,\s*([^\r\n;]*?)\s*(?://.*)?$")
_PIN_RE = re.compile(r"^\s*(in_pin|out_pin)\s*:\s*(.*?)\s*$", re.IGNORECASE)
_OPTIONS_RE = re.compile(r"^\s*options\s*:\s*(.*)$", re.IGNORECASE)
_DESC_RE = re.compile(r"^\s*desc\s*:\s*(.*?)\s*$")


@dataclass
class SliderDecl:
    index0: int
    label: str
    var_name: str = ""
    default: float = 0.0
    lo: float = 0.0
    hi: float = 1.0
    step: float = 0.001
    shape: str = "linear"          # linear | log | sqr
    shape_mod: float = 0.0
    choices: List[str] = field(default_factory=list)
    is_choice: bool = False
    is_string: bool = False
    string_default: str = ""
    hidden: bool = False
    tooltip: str = ""

    @property
    def ident(self) -> str:
        return f"slider{self.index0 + 1}"


@dataclass
class FileSlotDecl:
    index0: int
    token: str


def _to_float(tok: str) -> Optional[float]:
    try:
        return float(tok.strip())
    except (TypeError, ValueError):
        return None


def _split_outside_braces(text: str) -> List[str]:
    """Split on commas not inside {...} (enum choices contain commas)."""
    parts: List[str] = []
    depth = 0
    cur: List[str] = []
    for ch in text:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _string_default_token(tok: str) -> str:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == '"' and tok[-1] == '"':
        return tok[1:-1]
    return tok


def parse_slider_decls(text: str) -> Tuple[List[SliderDecl], str]:
    """Return (sorted unique slider declarations, accumulated #HELP text)."""
    decls: List[SliderDecl] = []
    pending_tooltip = ""
    help_lines: List[str] = []

    for line in text.splitlines():
        m = _HELP_RE.match(line)
        if m:
            part = m.group(1).rstrip()
            if part:
                help_lines.append(part)
            continue
        m = _TOOLTIP_RE.match(line)
        if m:
            pending_tooltip = m.group(1).strip()
            continue

        m = _SLIDER_RE.match(line)
        if not m:
            continue
        n = int(m.group(1))
        if not (1 <= n <= 64):
            continue

        d = SliderDecl(index0=n - 1, label="")

        head = m.group(2).strip()
        var_tok, def_tok = "", head
        eq = head.rfind("=")
        if eq != -1:
            var_tok = head[:eq].strip()
            def_tok = head[eq + 1:].strip()
        d.var_name = var_tok
        d.default = _to_float(def_tok) or 0.0

        range_part = m.group(3)
        if range_part is not None:
            kind = range_part.strip().lower()
            if kind in ("string", "str", "text"):
                d.is_string = True
                d.string_default = _string_default_token(def_tok)
        if not d.is_string and var_tok.startswith("#"):
            d.is_string = True
            d.string_default = _string_default_token(def_tok)

        if not d.is_string and range_part is not None:
            parts = _split_outside_braces(range_part)
            lo, hi, step = 0.0, 1.0, 0.001
            if len(parts) >= 2:
                lo = _to_float(parts[0]) if _to_float(parts[0]) is not None else 0.0
                hi = _to_float(parts[1]) if _to_float(parts[1]) is not None else 1.0
            if len(parts) >= 3:
                step_tok = parts[2]
                brace = step_tok.find("{")
                if brace != -1:
                    close = step_tok.find("}", brace + 1)
                    if close != -1:
                        labels = [s.strip() for s in step_tok[brace + 1:close].split(",")]
                        labels = [s for s in labels if s]
                        if labels:
                            d.choices = labels
                            d.is_choice = True
                    step_tok = step_tok[:brace].strip()
                # optional curve tag: "0.001:sqr", "1:log=1000"
                if ":" in step_tok:
                    num_tok, tag = step_tok.split(":", 1)
                    tag = tag.strip()
                    step_tok = num_tok.strip()
                    tag_base, _, tag_val = tag.partition("=")
                    mod = _to_float(tag_val)
                    if mod is not None:
                        d.shape_mod = mod
                    tag_base = tag_base.strip()
                    if tag_base == "log":
                        d.shape = "log"
                    elif tag_base == "sqr":
                        d.shape = "sqr"
                step = 1.0 if not step_tok else (_to_float(step_tok) if _to_float(step_tok) is not None else 1.0)
            if hi < lo:
                lo, hi = hi, lo
            d.lo, d.hi = lo, hi
            d.step = step if step > 0 else 0.001
            d.default = min(max(d.default, d.lo), d.hi)

        label = m.group(4).strip()
        if not label:
            label = f"Slider {n}"
        if label.startswith("-"):
            d.hidden = True
            label = label[1:].lstrip() or f"Slider {n}"
        d.label = label
        d.tooltip = pending_tooltip
        pending_tooltip = ""
        decls.append(d)

    decls.sort(key=lambda s: s.index0)
    unique: List[SliderDecl] = []
    seen = set()
    for d in decls:
        if d.index0 in seen:
            continue
        seen.add(d.index0)
        unique.append(d)
    return unique, "\n".join(help_lines)


def parse_fileslot_decls(text: str) -> List[FileSlotDecl]:
    out: List[FileSlotDecl] = []
    seen = set()
    for line in text.splitlines():
        m = _FILESLOT_RE.match(line)
        if not m:
            continue
        idx = int(m.group(1))
        if idx in seen:
            continue
        seen.add(idx)
        out.append(FileSlotDecl(index0=idx, token=m.group(2).strip()))
    out.sort(key=lambda f: f.index0)
    return out


def parse_pin_decls(text: str) -> Dict[str, Optional[int]]:
    """Count in_pin:/out_pin: lines; 'none' declares zero; absent -> None."""
    declared = {"inputs": False, "outputs": False}
    counts = {"inputs": 0, "outputs": 0}
    for raw in text.splitlines():
        line = raw.split("//", 1)[0].split(";", 1)[0]
        m = _PIN_RE.match(line)
        if not m:
            continue
        key = "inputs" if m.group(1).lower() == "in_pin" else "outputs"
        declared[key] = True
        if m.group(2).strip().lower() == "none":
            counts[key] = 0
        else:
            counts[key] += 1
    return {k: (counts[k] if declared[k] else None) for k in ("inputs", "outputs")}


def parse_options(text: str) -> Dict[str, str]:
    opts: Dict[str, str] = {}
    for raw in text.splitlines():
        m = _OPTIONS_RE.match(raw)
        if not m:
            continue
        for tok in re.split(r"[\s,]+", m.group(1).strip()):
            if tok and "=" in tok:
                key, val = tok.split("=", 1)
                if key.strip():
                    opts[key.strip().lower()] = val.strip()
    return opts


def memtop_slots(options: Dict[str, str]) -> int:
    raw = str(options.get("maxmem", "") or "").strip()
    if not raw:
        return DEFAULT_MEMTOP_SLOTS
    try:
        slots = int(float(raw))
    except ValueError:
        return DEFAULT_MEMTOP_SLOTS
    return slots if slots > 0 else DEFAULT_MEMTOP_SLOTS


def parse_desc(text: str) -> str:
    for line in text.splitlines():
        m = _DESC_RE.match(line)
        if m:
            return m.group(1)
    return ""
