"""EEL2/JSFX tokenizer, table-driven.

One compiled master alternation classifies every lexeme; positions come
from a precomputed newline index instead of per-character cursor
bookkeeping.  The accepted dialect is the EEL2 grammar the reference
catalog is written in:

* newlines are significant (returned as NEWLINE tokens; the parser
  decides when they separate statements vs. continue an expression),
* identifiers may contain '$', '#', and dots (u.next_bank is ONE token),
* numbers are decimal with optional fraction/exponent (hex goes via $x..),
* both '//' and '/* */' comments,
* single- or double-quoted strings with C-style escapes,
* two-char operators including the compound assigns and shifts.
"""
from __future__ import annotations

import re
from bisect import bisect_right
from dataclasses import dataclass
from typing import Tuple

class LexError(SyntaxError):
    pass


# token kinds
NUMBER = "number"
IDENT = "ident"
KEYWORD = "keyword"
OP = "op"
PUNCT = "punct"
SEMI = "semi"
NEWLINE = "newline"
STRING = "string"
EOF = "eof"

_KEYWORDS = frozenset({"if", "else", "while"})

# one alternation, ordered so longer/more-specific lexemes win: comments
# before the '/' operators, two-char operators before their one-char
# prefixes.  Group names double as the dispatch table keys.
_MASTER = re.compile(
    r"""
      (?P<ws>[ \t\r]+)
    | (?P<nl>\n)
    | (?P<lcom>//[^\n]*)
    | (?P<bcom>/\*.*?\*/)
    | (?P<op2>==|!=|<=|>=|\+=|-=|\*=|/=|%=|\^=|\|=|&=|~=|&&|\|\||<<|>>)
    | (?P<num>[0-9]+(?:\.[0-9]*)?(?:[eE][+-]?[0-9]+)?
             |\.[0-9]+(?:[eE][+-]?[0-9]+)?)
    | (?P<word>[#$A-Za-z_][#$A-Za-z0-9_]*
               (?:\.[#$A-Za-z_][#$A-Za-z0-9_]*)*)
    | (?P<dstr>"(?:\\.|[^"\\\n\r])*")
    | (?P<sstr>'(?:\\.|[^'\\\n\r])*')
    | (?P<semi>;)
    | (?P<punct>[()\[\]{},])
    | (?P<op1>[+\-*/=<>&|!?:%~^])
    """,
    re.VERBOSE | re.DOTALL,
)

# C-style escapes; \xHH handled separately, unknown escapes keep the char
_ESCAPES = {"n": "\n", "r": "\r", "t": "\t", "\\": "\\", "0": "\0"}

_HEX2 = re.compile(r"[0-9A-Fa-f]{2}")


def _decode_string(body: str) -> str:
    """Unescape the INSIDE of a matched string literal."""
    if "\\" not in body:
        return body
    out = []
    i = 0
    n = len(body)
    while i < n:
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        i += 2
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
        elif e in ("x", "X") and _HEX2.match(body, i):
            out.append(chr(int(body[i:i + 2], 16)))
            i += 2
        else:
            out.append(e)  # includes quotes and unknown escapes verbatim
    return "".join(out)


@dataclass(frozen=True)
class Token:
    kind: str
    text: str
    pos: Tuple[int, int]  # (line, col)


class Lexer:
    def __init__(self, text: str, first_line: int = 1):
        self._text = text
        self._n = len(text)
        self._i = 0
        self._first = first_line
        # newline index -> O(log n) line/col for any offset
        self._nl = [m.start() for m in re.finditer(r"\n", text)]

    def _pos(self, i: int) -> Tuple[int, int]:
        k = bisect_right(self._nl, i - 1)
        line_start = (self._nl[k - 1] + 1) if k else 0
        return (self._first + k, i - line_start + 1)

    def next_token(self) -> Token:
        text, n = self._text, self._n
        while self._i < n:
            m = _MASTER.match(text, self._i)
            if m is None:
                self._fail(self._i)
            kind = m.lastgroup
            i0 = self._i
            self._i = m.end()
            if kind in ("ws", "lcom", "bcom"):
                continue
            lexeme = m.group(0)
            pos = self._pos(i0)
            if kind == "nl":
                return Token(NEWLINE, "\n", pos)
            if kind == "num":
                return Token(NUMBER, lexeme, pos)
            if kind == "word":
                return Token(KEYWORD if lexeme in _KEYWORDS else IDENT,
                             lexeme, pos)
            if kind in ("dstr", "sstr"):
                return Token(STRING, _decode_string(lexeme[1:-1]), pos)
            if kind == "semi":
                return Token(SEMI, ";", pos)
            if kind == "punct":
                return Token(PUNCT, lexeme, pos)
            return Token(OP, lexeme, pos)  # op2 / op1
        return Token(EOF, "", self._pos(n))

    def _fail(self, i: int) -> None:
        """No alternative matched: classify the error like a scanner would."""
        text = self._text
        ch = text[i]
        line, col = self._pos(i)
        if text.startswith("/*", i):
            raise LexError("unterminated block comment")
        if ch in ('"', "'"):
            # a quote with no well-formed literal: diagnose what broke it
            j = i + 1
            while j < self._n:
                c = text[j]
                if c in ("\n", "\r"):
                    raise LexError(
                        f"newline inside string literal at {line}:{col}")
                if c == "\\":
                    if j + 1 >= self._n:
                        raise LexError("unterminated string escape")
                    j += 2
                    continue
                j += 1  # closing quote unreachable here or master had matched
            raise LexError(
                f"unterminated string literal at {line}:{col}")
        raise LexError(f"unexpected character {ch!r} at {line}:{col}")
