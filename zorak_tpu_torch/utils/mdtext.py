"""Terminal markdown renderer for the plugin help surface.

The reference embeds each leaf's README.md and renders it in the
editor's '?' panel (ref: src/PluginMarkdownHelp.h:28-59 markdown source
selection and fallback, :560-700 span styling).  Offline, the same
content renders to the terminal: headings, emphasis, inline/fenced
code, lists, quotes, rules and links over ANSI styles, with plain-text
degradation for non-TTY output.
"""
from __future__ import annotations

import re
import textwrap
from typing import List

_BOLD = "\x1b[1m"
_DIM = "\x1b[2m"
_ITAL = "\x1b[3m"
_UNDER = "\x1b[4m"
_CYAN = "\x1b[36m"
_RESET = "\x1b[0m"

_FENCE = re.compile(r"^(```|~~~)\s*(\w+)?\s*$")
_HEADING = re.compile(r"^(#{1,6})\s+(.*?)\s*#*\s*$")
_BULLET = re.compile(r"^(\s*)([-*+]|\d+[.)])\s+(.*)$")
_QUOTE = re.compile(r"^\s*>\s?(.*)$")
_RULE = re.compile(r"^\s*([-*_])\s*(?:\1\s*){2,}$")
_LINK = re.compile(r"\[([^\]]+)\]\(([^)\s]+)(?:\s+\"[^\"]*\")?\)")
_CODE = re.compile(r"`([^`]+)`")
_STRONG = re.compile(r"\*\*([^*]+)\*\*|__([^_]+)__")
_EM = re.compile(r"(?<!\*)\*([^*\s][^*]*)\*(?!\*)|(?<!_)_([^_\s][^_]*)_(?!_)")


def _inline(text: str, ansi: bool) -> str:
    def strong(m):
        s = m.group(1) or m.group(2)
        return f"{_BOLD}{s}{_RESET}" if ansi else s

    def em(m):
        s = m.group(1) or m.group(2)
        return f"{_ITAL}{s}{_RESET}" if ansi else s

    def code(m):
        return f"{_CYAN}{m.group(1)}{_RESET}" if ansi else m.group(1)

    def link(m):
        label, url = m.group(1), m.group(2)
        if url.startswith("#") or label == url:
            return f"{_UNDER}{label}{_RESET}" if ansi else label
        tail = f" <{url}>"
        return (f"{_UNDER}{label}{_RESET}{_DIM}{tail}{_RESET}"
                if ansi else label + tail)

    text = _LINK.sub(link, text)
    text = _CODE.sub(code, text)
    text = _STRONG.sub(strong, text)
    text = _EM.sub(em, text)
    return text


def _wrap(text: str, width: int, indent: str = "",
          first_indent: str = "") -> List[str]:
    if not text.strip():
        return []
    # ANSI escapes confuse wrap widths only marginally for doc prose;
    # wrap on the styled text with a small slack instead of stripping
    return textwrap.wrap(
        text, width=width, initial_indent=first_indent or indent,
        subsequent_indent=indent, break_long_words=False,
        break_on_hyphens=False) or [indent + text.strip()]


def render_markdown(md: str, width: int = 78, ansi: bool = True) -> str:
    """Render markdown to terminal text (ANSI styled when ansi=True)."""
    out: List[str] = []
    lines = md.replace("\r\n", "\n").replace("\r", "\n").split("\n")
    i = 0
    para: List[str] = []

    def flush_para():
        if para:
            out.extend(_wrap(_inline(" ".join(para), ansi), width))
            out.append("")
            para.clear()

    while i < len(lines):
        ln = lines[i]
        fence = _FENCE.match(ln)
        if fence:
            flush_para()
            i += 1
            block: List[str] = []
            while i < len(lines) and not _FENCE.match(lines[i]):
                block.append(lines[i])
                i += 1
            i += 1  # closing fence
            for b in block:
                out.append(f"    {_DIM}{b}{_RESET}" if ansi else "    " + b)
            out.append("")
            continue
        h = _HEADING.match(ln)
        if h:
            flush_para()
            level, text = len(h.group(1)), _inline(h.group(2), ansi)
            if ansi:
                text = f"{_BOLD}{text}{_RESET}"
            out.append(text)
            if level <= 2:
                out.append(("=" if level == 1 else "-")
                           * min(width, max(3, len(h.group(2)))))
            out.append("")
            i += 1
            continue
        if _RULE.match(ln):
            flush_para()
            out.append("-" * min(width, 40))
            out.append("")
            i += 1
            continue
        b = _BULLET.match(ln)
        if b:
            flush_para()
            lead, marker, rest = b.groups()
            bullet = "•" if not marker[0].isdigit() else marker
            ind = " " * (len(lead) + len(bullet) + 1)
            out.extend(_wrap(_inline(rest, ansi), width, indent=ind,
                             first_indent=f"{lead}{bullet} "))
            i += 1
            continue
        q = _QUOTE.match(ln)
        if q:
            flush_para()
            body = _inline(q.group(1), ansi)
            bar = f"{_DIM}│{_RESET} " if ansi else "| "
            out.extend(_wrap(body, width - 2, indent=bar, first_indent=bar))
            i += 1
            continue
        if not ln.strip():
            flush_para()
            i += 1
            continue
        if ln.startswith("    ") and not para:
            out.append(f"    {_DIM}{ln[4:]}{_RESET}" if ansi
                       else ln)
            i += 1
            continue
        para.append(ln.strip())
        i += 1
    flush_para()
    while out and not out[-1]:
        out.pop()
    return "\n".join(out) + "\n"


# the reference's fallback when a leaf ships no README
# (ref: src/PluginMarkdownHelp.h:40-41)
NO_README_FALLBACK = (
    "No embedded `README.md` was found for this plugin.\n\n"
    "Each leaf plugin folder should ship a `README.md`; the `?` panel "
    "renders that markdown directly.\n")
