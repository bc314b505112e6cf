"""Precedence-climbing parser for the JSFX/EEL2 dialect.

The grammar (operator table, newline-continuation rules, ternary and
loop() quirks) is DICTATED by the dialect the catalog is written in —
those rules must match the reference frontend exactly (ref:
dsp_jsfx_aot.py:393-842) or the catalog stops parsing; everything
structural around them (token stream, statement dispatch, diagnostics)
is this implementation's own.  The dialect quirks:

* newlines usually terminate statements, but an expression continues across
  a newline when the next token is an infix operator that cannot start a
  statement (so `a\n|| b` joins, `a\n-b` does not),
* ternary may appear on the line after its condition; a missing ':' branch
  means "else 0",
* loop(count, body...) accepts an un-comma'd multi-statement body,
* function definitions carry local()/instance() qualifier lists; global()
  is accepted and ignored,
* `(a; b; c)` is a value-producing sequence; empty parens are legal,
* assignment targets are names, bracket indexes, or slider(i)/spl(i).

Operator precedence (higher binds tighter), matching the reference table
(dsp_jsfx_aot.py:365-383):

    1  = += -= *= /= %= ^= |= &= ~=      (right assoc)
    2  ?:
    3  ||  |
    4  &&
    5  == != &
    6  < <= > >= << >>
    7  + -
    8  * / %
    9  ^
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

from . import lexer as L
from .astnodes import (
    Asn, Bin, Block, CallExpr, Cond, Const, FuncDef, IfStmt, LoopExpr, Mem,
    Name, Node, Str, Un, WhileStmt,
)


class ParseError(SyntaxError):
    pass


_PREC = {
    "=": 1, "+=": 1, "-=": 1, "*=": 1, "/=": 1, "%=": 1, "^=": 1,
    "|=": 1, "&=": 1, "~=": 1,
    "||": 3, "|": 3,
    "&&": 4,
    "==": 5, "!=": 5, "&": 5,
    "<": 6, "<=": 6, ">": 6, ">=": 6, "<<": 6, ">>": 6,
    "+": 7, "-": 7,
    "*": 8, "/": 8, "%": 8,
    "^": 9,
}
_TERNARY_PREC = 2
_ASSIGN_OPS = frozenset({"=", "+=", "-=", "*=", "/=", "%=", "^=", "|=", "&=", "~="})


class _TokenStream:
    """Buffered token source with arbitrary lookahead.

    Tokens are pulled from the lexer on demand into a deque window;
    `peek(k)` fills the window as needed, so grammar decisions that want
    deeper context cost nothing extra in the common path."""

    def __init__(self, lex: "L.Lexer"):
        self._lex = lex
        self._window: deque = deque()

    def peek(self, k: int = 0) -> L.Token:
        while len(self._window) <= k:
            self._window.append(self._lex.next_token())
        return self._window[k]

    def pop(self) -> L.Token:
        tok = self.peek(0)
        self._window.popleft()
        return tok


class Parser:
    def __init__(self, text: str, first_line: int = 1):
        self._src = text
        self._first_line = first_line
        self._ts = _TokenStream(L.Lexer(text, first_line=first_line))

    # ------------------------------------------------------------------ util

    @property
    def _tok(self) -> L.Token:
        return self._ts.peek(0)

    @property
    def _look(self) -> L.Token:
        return self._ts.peek(1)

    def _advance(self) -> None:
        self._ts.pop()

    def _expect(self, kind: str, text: Optional[str] = None) -> L.Token:
        tok = self._tok
        if tok.kind != kind or (text is not None and tok.text != text):
            want = text if text is not None else kind
            raise ParseError(self._diag(f"expected {want!r}, found {tok.kind} {tok.text!r}"))
        self._advance()
        return tok

    def _diag(self, message: str) -> str:
        line, col = self._tok.pos
        rows = self._src.splitlines()
        rel = line - self._first_line
        snippet = rows[rel] if 0 <= rel < len(rows) else ""
        marker = ""
        if snippet:
            c = max(1, min(col, len(snippet) + 1))
            marker = "\n" + snippet + "\n" + " " * (c - 1) + "^"
        return f"{message} at {line}:{col}{marker}"

    def _skip_separators(self) -> None:
        while self._tok.kind in (L.NEWLINE, L.SEMI):
            self._advance()

    def _skip_newlines(self) -> None:
        while self._tok.kind == L.NEWLINE:
            self._advance()

    # --------------------------------------------------------------- program

    def parse_program(self) -> List[Node]:
        items: List[Node] = []
        self._skip_separators()
        while self._tok.kind != L.EOF:
            items.append(self._statement())
            self._skip_separators()
        return items

    def _statement(self) -> Node:
        if self._tok.kind == L.KEYWORD and self._tok.text == "if":
            return self._if_statement()
        if self._tok.kind == L.KEYWORD and self._tok.text == "while":
            return self._while_statement()
        if self._tok.kind == L.IDENT and self._tok.text == "function":
            return self._function_def()
        return self._expression(0)

    def _if_statement(self) -> Node:
        head = self._expect(L.KEYWORD, "if")
        self._expect(L.PUNCT, "(")
        pred = self._expression(0)
        self._expect(L.PUNCT, ")")
        self._skip_separators()
        then = self._expression(0)
        self._skip_separators()
        other = None
        if self._tok.kind == L.KEYWORD and self._tok.text == "else":
            self._advance()
            self._skip_separators()
            other = self._expression(0)
            self._skip_separators()
        return IfStmt(head.pos, pred, then, other)

    def _while_statement(self) -> Node:
        head = self._expect(L.KEYWORD, "while")
        self._expect(L.PUNCT, "(")
        pred = self._expression(0)
        self._expect(L.PUNCT, ")")
        self._skip_separators()
        body = self._expression(0)
        return WhileStmt(head.pos, pred, body)

    def _function_def(self) -> Node:
        head = self._expect(L.IDENT, "function")
        if self._tok.kind != L.IDENT:
            raise ParseError(self._diag("expected a function name"))
        fname = self._expect(L.IDENT).text

        def name_list(label: str) -> List[str]:
            names: List[str] = []
            self._expect(L.PUNCT, "(")
            self._skip_separators()
            if not (self._tok.kind == L.PUNCT and self._tok.text == ")"):
                while True:
                    self._skip_separators()
                    if self._tok.kind == L.PUNCT and self._tok.text == ")":
                        break
                    if self._tok.kind != L.IDENT:
                        raise ParseError(self._diag(f"expected {label} name"))
                    names.append(self._expect(L.IDENT).text)
                    self._skip_separators()
                    # names may be separated by commas OR whitespace
                    if self._tok.kind == L.PUNCT and self._tok.text == ",":
                        self._advance()
                        continue
                    if self._tok.kind == L.IDENT:
                        continue
                    break
            self._skip_separators()
            self._expect(L.PUNCT, ")")
            return names

        params = name_list("parameter")
        local_names: List[str] = []
        instance_names: List[str] = []
        self._skip_separators()
        while self._tok.kind == L.IDENT and self._tok.text in ("local", "instance", "global"):
            qual = self._tok.text
            self._advance()
            names = name_list(qual)
            if qual == "local":
                local_names.extend(names)
            elif qual == "instance":
                instance_names.extend(names)
            # global(): accepted, no lowering needed (plain vars are global)
            self._skip_separators()

        if not (self._tok.kind == L.PUNCT and self._tok.text == "("):
            raise ParseError(self._diag("expected '(' opening the function body"))
        body = self._primary()

        self._skip_separators()
        if self._tok.kind == L.SEMI:
            self._advance()

        return FuncDef(head.pos, fname, params, local_names, instance_names, body)

    # ------------------------------------------------------------ expressions

    @staticmethod
    def _is_lvalue(node: Node) -> bool:
        if isinstance(node, (Name, Mem)):
            return True
        return (isinstance(node, CallExpr)
                and node.func in ("slider", "spl")
                and len(node.args) == 1)

    def _continues_expression(self, tok: L.Token, min_prec: int) -> bool:
        """Would `tok`, after a newline, continue the expression being built?

        Mirrors the reference's rule: only join lines on infix/ternary tokens
        that cannot begin a statement; '+', '-', '!' are valid prefixes so a
        newline before them ends the statement.
        """
        if tok.kind != L.OP:
            return False
        if tok.text == "?":
            return _TERNARY_PREC >= min_prec
        if tok.text in (":", "+", "-", "!"):
            return False
        prec = _PREC.get(tok.text)
        return prec is not None and prec >= min_prec

    def _skip_continuation_newlines(self, min_prec: int) -> None:
        while (self._tok.kind == L.NEWLINE
               and (self._look.kind == L.NEWLINE
                    or self._continues_expression(self._look, min_prec))):
            self._advance()

    def _expression(self, min_prec: int) -> Node:
        lhs = self._prefix()
        while True:
            self._skip_continuation_newlines(min_prec)

            if self._tok.kind != L.OP:
                break
            op = self._tok.text
            if op in ("?", ":"):
                break
            prec = _PREC.get(op)
            if prec is None or prec < min_prec:
                break

            self._advance()
            if op in _ASSIGN_OPS:
                rhs = self._expression(prec)  # right associative
                if not self._is_lvalue(lhs):
                    raise ParseError(self._diag(
                        "assignment target must be a variable, index, or slider()/spl() reference"))
                lhs = Asn(lhs.pos, op, lhs, rhs)
            else:
                rhs = self._expression(prec + 1)
                lhs = Bin(lhs.pos, op, lhs, rhs)

        # a '?' may open on the following line
        while (self._tok.kind == L.NEWLINE
               and (self._look.kind == L.NEWLINE
                    or (self._look.kind == L.OP and self._look.text == "?"))):
            self._advance()

        if self._tok.kind == L.OP and self._tok.text == "?" and _TERNARY_PREC >= min_prec:
            qpos = self._tok.pos
            self._advance()
            self._skip_separators()
            then = self._expression(0)
            self._skip_separators()
            if self._tok.kind == L.OP and self._tok.text == ":":
                self._advance()
                self._skip_separators()
                other = self._expression(0)
            else:
                other = Const(qpos, 0.0)
            lhs = Cond(qpos, lhs, then, other)

        return lhs

    def _prefix(self) -> Node:
        self._skip_newlines()
        if self._tok.kind == L.OP and self._tok.text in ("+", "-", "!"):
            tok = self._tok
            self._advance()
            return Un(tok.pos, tok.text, self._prefix())
        return self._postfix()

    def _postfix(self) -> Node:
        node = self._primary()
        while True:
            if self._tok.kind == L.PUNCT and self._tok.text == "(":
                pos = self._tok.pos
                self._advance()
                if not isinstance(node, Name):
                    raise ParseError(self._diag("only a named function can be called"))
                fname = node.ident

                if fname == "loop":
                    node = self._loop_call(pos)
                    continue

                args: List[Node] = []
                self._skip_separators()
                if not (self._tok.kind == L.PUNCT and self._tok.text == ")"):
                    while True:
                        self._skip_separators()
                        args.append(self._expression(0))
                        self._skip_separators()
                        if self._tok.kind == L.PUNCT and self._tok.text == ",":
                            self._advance()
                            continue
                        break
                self._skip_separators()
                self._expect(L.PUNCT, ")")
                node = CallExpr(pos, fname, args)
                continue

            if self._tok.kind == L.PUNCT and self._tok.text == "[":
                pos = self._tok.pos
                self._advance()
                self._skip_separators()
                if self._tok.kind == L.PUNCT and self._tok.text == "]":
                    index: Node = Const(pos, 0.0)
                else:
                    index = self._expression(0)
                    self._skip_separators()
                self._expect(L.PUNCT, "]")
                node = Mem(pos, node, index)
                continue

            break
        return node

    def _loop_call(self, pos) -> Node:
        # loop(count [,] stmt; stmt; ...) — body statements need no commas
        self._skip_separators()
        count = self._expression(0)
        self._skip_separators()
        if self._tok.kind == L.PUNCT and self._tok.text == ",":
            self._advance()
        self._skip_separators()

        if self._tok.kind == L.PUNCT and self._tok.text == ")":
            self._advance()
            return LoopExpr(pos, count, Const(pos, 0.0))

        items = [self._seq_item()]
        while True:
            self._skip_separators()
            if self._tok.kind == L.PUNCT and self._tok.text == ")":
                self._advance()
                break
            items.append(self._seq_item())
        body: Node = items[0] if len(items) == 1 else Block(pos, items)
        return LoopExpr(pos, count, body)

    def _primary(self) -> Node:
        tok = self._tok
        if tok.kind == L.NUMBER:
            self._advance()
            return Const(tok.pos, float(tok.text))

        if tok.kind == L.STRING:
            self._advance()
            return Str(tok.pos, tok.text)

        if tok.kind == L.IDENT:
            self._advance()
            return Name(tok.pos, tok.text)

        if tok.kind == L.PUNCT and tok.text == "(":
            pos = tok.pos
            self._advance()
            self._skip_separators()

            if self._tok.kind == L.PUNCT and self._tok.text == ")":
                self._advance()
                return Block(pos, [])

            first = self._seq_item()
            if self._tok.kind == L.PUNCT and self._tok.text == ")":
                self._advance()
                return first
            items = [first]
            while True:
                self._skip_separators()
                if self._tok.kind == L.PUNCT and self._tok.text == ")":
                    self._advance()
                    break
                items.append(self._seq_item())
            return Block(pos, items)

        raise ParseError(self._diag("expected a number, identifier, or '('"))

    def _seq_item(self) -> Node:
        if self._tok.kind == L.KEYWORD and self._tok.text == "if":
            return self._if_statement()
        if self._tok.kind == L.KEYWORD and self._tok.text == "while":
            return self._while_statement()
        return self._expression(0)


def parse_section(text: str, first_line: int = 1) -> List[Node]:
    return Parser(text, first_line=first_line).parse_program()
