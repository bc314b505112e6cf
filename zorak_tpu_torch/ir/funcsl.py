"""User-function lowering: section/namespace specialization.

JSFX user functions carry local()/instance() qualifier lists and pseudo-OO
namespace call syntax (`monLP.process(x)` binds instance vars to `monLP.*`,
`this.` refers to the caller's namespace).  Following the reference's
strategy (ref: dsp_jsfx_aot.py:1804-2057):

* local() vars become PERSISTENT state variables mangled per
  (caller-section, function) — repeated calls don't reset them,
* instance() vars become namespaced persistent vars `<ns>.<name>`,
* functions are specialized per caller section, and per namespace when the
  body uses instance vars or `this.`,
* a namespace-needing function called without a prefix uses its own name
  as the namespace.

After lowering, specialized functions have only params (fresh per call,
initialized from arguments) — no locals, no instances.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..frontend.astnodes import (
    Asn, Bin, Block, CallExpr, Cond, Const, FuncDef, IfStmt, LoopExpr, Mem,
    Name, Node, Str, Un, WhileStmt, walk,
)


def extract_function_defs(section_programs: Dict[str, List[Node]],
                          ) -> Tuple[Dict[str, FuncDef], Dict[str, List[Node]]]:
    """Pull FuncDef statements out of every section; last definition wins."""
    defs: Dict[str, FuncDef] = {}
    remaining: Dict[str, List[Node]] = {}
    for sec, prog in section_programs.items():
        kept: List[Node] = []
        for stmt in prog:
            if isinstance(stmt, FuncDef):
                defs[stmt.name] = stmt
            else:
                kept.append(stmt)
        remaining[sec] = kept
    return defs, remaining


def _mangle(text: str) -> str:
    out: List[str] = []
    for ch in text:
        out.append(ch if (ch.isalnum() or ch == "_") else f"_x{ord(ch):02X}_")
    if not out:
        return "_"
    if out[0][0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _spec_fn_name(section: str, fn: str, namespace: Optional[str]) -> str:
    base = f"__fn__{_mangle(section)}__{_mangle(fn)}"
    return base + (f"__ns__{_mangle(namespace)}" if namespace else "")


def _persistent_local(section: str, fn: str, name: str) -> str:
    return f"__fnlocal__{_mangle(section)}__{_mangle(fn)}__{_mangle(name)}"


def _uses_this(root: Node) -> bool:
    for n in walk(root):
        if isinstance(n, Name) and (n.ident == "this" or n.ident.startswith("this.")):
            return True
        if isinstance(n, CallExpr) and (n.func == "this" or n.func.startswith("this.")):
            return True
    return False


def _resolve_this_prefix(prefix: str, current_ns: Optional[str]) -> Optional[str]:
    if prefix == "this":
        return current_ns
    if prefix.startswith("this."):
        tail = prefix[5:]
        if current_ns:
            return f"{current_ns}.{tail}" if tail else current_ns
        return tail or current_ns
    return prefix


def specialize_user_functions(section_programs: Dict[str, List[Node]],
                              fn_defs: Dict[str, FuncDef],
                              ) -> Tuple[Dict[str, List[Node]], Dict[str, FuncDef]]:
    if not fn_defs:
        return section_programs, {}

    needs_ns = {name: bool(f.instance_names) or _uses_this(f.body)
                for name, f in fn_defs.items()}

    specialized: Dict[str, FuncDef] = {}
    name_cache: Dict[Tuple[str, str, Optional[str]], str] = {}
    active: Set[Tuple[str, str, Optional[str]]] = set()

    def resolve_call(fn_name: str, current_ns: Optional[str]
                     ) -> Tuple[Optional[str], Optional[str]]:
        if fn_name in fn_defs:
            return fn_name, None
        parts = fn_name.split(".")
        if len(parts) >= 2 and parts[-1] in fn_defs:
            return parts[-1], _resolve_this_prefix(".".join(parts[:-1]), current_ns)
        return None, None

    def specialize(section: str, base_fn: str, call_ns: Optional[str]) -> str:
        proto = fn_defs[base_fn]
        ns_key = call_ns if needs_ns.get(base_fn) else None
        if needs_ns.get(base_fn) and not ns_key:
            ns_key = base_fn

        key = (section, base_fn, ns_key)
        if key in name_cache:
            return name_cache[key]
        if key in active:
            raise ValueError(f"recursive user-function specialization for {base_fn!r}")

        spec = _spec_fn_name(section, base_fn, ns_key)
        name_cache[key] = spec
        active.add(key)

        local_map = {n: _persistent_local(section, base_fn, n) for n in proto.local_names}
        inst_map = ({n: f"{ns_key}.{n}" for n in proto.instance_names} if ns_key else {})
        params = set(proto.params)

        body = rewrite(proto.body, section, ns_key, params, local_map, inst_map)
        specialized[spec] = FuncDef(proto.pos, spec, list(proto.params), [], [], body)
        active.discard(key)
        return spec

    def rewrite_name(ident: str, params: Set[str], local_map: Dict[str, str],
                     inst_map: Dict[str, str], current_ns: Optional[str]) -> str:
        if ident in params:
            return ident
        if ident in local_map:
            return local_map[ident]
        if ident in inst_map:
            return inst_map[ident]
        if ident == "this":
            return current_ns or ident
        if ident.startswith("this."):
            tail = ident[5:]
            if current_ns:
                return f"{current_ns}.{tail}" if tail else current_ns
            return tail or ident
        return ident

    def rewrite_callee(fn_name: str, section: str, current_ns: Optional[str]) -> str:
        base, call_ns = resolve_call(fn_name, current_ns)
        if base is None:
            return fn_name
        return specialize(section, base, call_ns)

    def rewrite(n: Node, section: str, ns: Optional[str], params: Set[str],
                local_map: Dict[str, str], inst_map: Dict[str, str]) -> Node:
        r = lambda c: rewrite(c, section, ns, params, local_map, inst_map)
        if isinstance(n, (Const, Str)):
            return n
        if isinstance(n, Name):
            new = rewrite_name(n.ident, params, local_map, inst_map, ns)
            return n if new == n.ident else Name(n.pos, new)
        if isinstance(n, Mem):
            return Mem(n.pos, r(n.base), r(n.index))
        if isinstance(n, Un):
            return Un(n.pos, n.op, r(n.operand))
        if isinstance(n, Bin):
            return Bin(n.pos, n.op, r(n.lhs), r(n.rhs))
        if isinstance(n, Asn):
            return Asn(n.pos, n.op, r(n.target), r(n.value))
        if isinstance(n, CallExpr):
            return CallExpr(n.pos, rewrite_callee(n.func, section, ns),
                            [r(a) for a in n.args])
        if isinstance(n, LoopExpr):
            return LoopExpr(n.pos, r(n.count), r(n.body))
        if isinstance(n, Cond):
            return Cond(n.pos, r(n.pred), r(n.then), r(n.other))
        if isinstance(n, Block):
            return Block(n.pos, [r(it) for it in n.items])
        if isinstance(n, IfStmt):
            return IfStmt(n.pos, r(n.pred), r(n.then),
                          r(n.other) if n.other is not None else None)
        if isinstance(n, WhileStmt):
            return WhileStmt(n.pos, r(n.pred), r(n.body))
        if isinstance(n, FuncDef):
            raise TypeError("nested FuncDef should have been extracted")
        raise TypeError(type(n))

    lowered = {sec: [rewrite(stmt, sec, None, set(), {}, {}) for stmt in prog]
               for sec, prog in section_programs.items()}
    return lowered, specialized
