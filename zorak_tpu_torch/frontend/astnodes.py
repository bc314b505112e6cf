"""AST for the JSFX/EEL2 dialect accepted by the platform.

The node inventory matches the language subset the reference AOT compiler
accepts (ref: dsp_jsfx_aot.py:257-391): numbers, string literals, variables
(dotted names allowed), bracket indexing into mem, unary +/-/!, binary
arithmetic/comparison/bitwise/shift ops, assignments (= and compound),
calls, loop(count, body), ternary with implicit else-0, sequences,
if/while statements, and user function definitions with
local()/instance()/global() qualifier lists.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# (line, col) of the token that introduced the node; used in diagnostics.
Pos = Tuple[int, int]

_counter = [0]


def _nid() -> int:
    _counter[0] += 1
    return _counter[0]


@dataclass
class Node:
    pos: Pos
    nid: int = field(default_factory=_nid, init=False, compare=False)


@dataclass
class Const(Node):
    value: float = 0.0


@dataclass
class Str(Node):
    text: str = ""


@dataclass
class Name(Node):
    ident: str = ""


@dataclass
class Mem(Node):
    """base[index] — always heap indexing; `mem` itself is numeric base 0.

    gmem[...] is also represented as Mem with base Name('gmem') and handled
    specially by backends (ref: dsp_jsfx_aot.py:4120-4124).
    """
    base: Node = None  # type: ignore[assignment]
    index: Node = None  # type: ignore[assignment]


@dataclass
class Un(Node):
    op: str = ""
    operand: Node = None  # type: ignore[assignment]


@dataclass
class Bin(Node):
    op: str = ""
    lhs: Node = None  # type: ignore[assignment]
    rhs: Node = None  # type: ignore[assignment]


@dataclass
class Asn(Node):
    op: str = ""           # '=', '+=', '-=', '*=', '/=', '%=', '^=', '|=', '&=', '~='
    target: Node = None    # Name | Mem | CallExpr(slider/spl, 1 arg)  # type: ignore[assignment]
    value: Node = None     # type: ignore[assignment]


@dataclass
class CallExpr(Node):
    func: str = ""
    args: List[Node] = field(default_factory=list)


@dataclass
class LoopExpr(Node):
    count: Node = None  # type: ignore[assignment]
    body: Node = None   # type: ignore[assignment]


@dataclass
class Cond(Node):
    """Ternary cond ? then : else.  Missing ':' gives else == Const(0)."""
    pred: Node = None  # type: ignore[assignment]
    then: Node = None  # type: ignore[assignment]
    other: Node = None  # type: ignore[assignment]


@dataclass
class Block(Node):
    """Parenthesized statement sequence; evaluates to the last item (or 0)."""
    items: List[Node] = field(default_factory=list)


@dataclass
class IfStmt(Node):
    pred: Node = None   # type: ignore[assignment]
    then: Node = None   # type: ignore[assignment]
    other: Optional[Node] = None


@dataclass
class WhileStmt(Node):
    pred: Node = None  # type: ignore[assignment]
    body: Node = None  # type: ignore[assignment]


@dataclass
class FuncDef(Node):
    name: str = ""
    params: List[str] = field(default_factory=list)
    local_names: List[str] = field(default_factory=list)
    instance_names: List[str] = field(default_factory=list)
    body: Node = None  # type: ignore[assignment]


def walk(node: Node):
    """Yield node and all descendants (pre-order)."""
    yield node
    for child in children(node):
        yield from walk(child)


def children(node: Node):
    if isinstance(node, (Const, Str, Name)):
        return ()
    if isinstance(node, Mem):
        return (node.base, node.index)
    if isinstance(node, Un):
        return (node.operand,)
    if isinstance(node, Bin):
        return (node.lhs, node.rhs)
    if isinstance(node, Asn):
        return (node.target, node.value)
    if isinstance(node, CallExpr):
        return tuple(node.args)
    if isinstance(node, LoopExpr):
        return (node.count, node.body)
    if isinstance(node, Cond):
        return (node.pred, node.then, node.other)
    if isinstance(node, Block):
        return tuple(node.items)
    if isinstance(node, IfStmt):
        return (node.pred, node.then) + ((node.other,) if node.other is not None else ())
    if isinstance(node, WhileStmt):
        return (node.pred, node.body)
    if isinstance(node, FuncDef):
        return (node.body,)
    raise TypeError(f"unknown node {type(node)!r}")
