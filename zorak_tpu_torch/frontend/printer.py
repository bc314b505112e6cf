"""AST -> JSFX-ish text, for staged-lowering dumps and diagnostics."""
from __future__ import annotations

import json

from .astnodes import (
    Asn, Bin, Block, CallExpr, Cond, Const, FuncDef, IfStmt, LoopExpr, Mem,
    Name, Node, Str, Un, WhileStmt,
)


def fmt_num(v: float) -> str:
    if v != v:
        return "nan"
    if v == float("inf"):
        return "inf"
    if v == float("-inf"):
        return "-inf"
    txt = format(float(v), ".17g")
    return "0" if txt == "-0" else txt


def to_text(node: Node, indent: int = 0) -> str:
    pad = "  " * indent
    if isinstance(node, Const):
        return fmt_num(node.value)
    if isinstance(node, Str):
        return json.dumps(node.text)
    if isinstance(node, Name):
        return node.ident
    if isinstance(node, Mem):
        return f"{to_text(node.base, indent)}[{to_text(node.index, indent)}]"
    if isinstance(node, Un):
        return f"({node.op}{to_text(node.operand, indent)})"
    if isinstance(node, Bin):
        return f"({to_text(node.lhs, indent)} {node.op} {to_text(node.rhs, indent)})"
    if isinstance(node, Asn):
        return f"{to_text(node.target, indent)} {node.op} {to_text(node.value, indent)}"
    if isinstance(node, CallExpr):
        return f"{node.func}({', '.join(to_text(a, indent) for a in node.args)})"
    if isinstance(node, LoopExpr):
        return f"loop({to_text(node.count, indent)}, {to_text(node.body, indent)})"
    if isinstance(node, Cond):
        return (f"({to_text(node.pred, indent)} ? {to_text(node.then, indent)}"
                f" : {to_text(node.other, indent)})")
    if isinstance(node, Block):
        if not node.items:
            return "()"
        inner = "\n".join("  " * (indent + 1) + stmt_text(it, indent + 1) + ";"
                          for it in node.items)
        return "(\n" + inner + "\n" + pad + ")"
    if isinstance(node, IfStmt):
        txt = f"if ({to_text(node.pred, indent)}) {to_text(node.then, indent)}"
        if node.other is not None:
            txt += f" else {to_text(node.other, indent)}"
        return txt
    if isinstance(node, WhileStmt):
        return f"while ({to_text(node.pred, indent)}) {to_text(node.body, indent)}"
    if isinstance(node, FuncDef):
        return (f"function {node.name}({' '.join(node.params)}) "
                f"( {to_text(node.body, indent)} )")
    raise TypeError(type(node))


def stmt_text(node: Node, indent: int = 0) -> str:
    return to_text(node, indent)


def program_text(stmts, indent: int = 0) -> str:
    return "\n".join(stmt_text(s, indent) + ";" for s in stmts)
