"""Static capability analyses and section-legality validation.

Diagnostic strings intentionally match the reference compiler so the
negative compile tests are portable (ref: dsp_jsfx_aot.py:1544-1606, e.g.
"msg_send() is only valid in @block").
"""
from __future__ import annotations

from typing import Any, Dict, List, Set

from ..frontend.astnodes import Asn, CallExpr, Mem, Name, Node, Str, walk


class SectionLegalityError(SyntaxError):
    pass


class _FunSets:
    MIDI_RECV = frozenset({"midirecv", "midirecv_buf", "midirecv_str"})
    MIDI_SEND = frozenset({"midisend", "midisend_buf", "midisend_str", "midisyx"})
    GMEM_SETUP = frozenset({"gmem_attach", "gmem_attach_size"})
    GMEM_BULK = frozenset({"gmem_get", "gmem_put", "gmem_fill", "gmem_zero", "gmem_copy"})
    GMEM_QUERY = frozenset({"gmem_size", "gmem_seq", "gmem_page"})
    COMM_SETUP = frozenset({"comm_join", "msg_subscribe", "msg_unsubscribe",
                            "msg_advertise", "instance_set_name"})
    COMM_BLOCK = frozenset({
        "msg_send", "msg_sendto", "msg_recv",
        "msg_send_buf", "msg_sendto_buf", "msg_recv_buf",
        "msg_avail", "msg_kind", "msg_length", "msg_dropped", "msg_clear",
        "msg_peer_count", "msg_peer_id", "msg_peer_name", "msg_peer_uid",
        "msg_peer_caps", "msg_peer_alive",
    })
    COMM_MISC = frozenset({"instance_id", "instance_uid", "instance_get_name"})
    HOST_TRACK = frozenset({
        "track_name", "track_name_available", "track_name_seq",
        "host_track_name", "host_track_name_available", "host_track_name_seq",
    })
    POOL_SETUP = frozenset({"sample_pool_from_slot", "sample_pool_set_mode",
                            "sample_pool_set_budget_mb", "sample_pool_commit"})
    POOL_QUERY = frozenset({
        "sample_pool_state", "sample_pool_selected", "sample_pool_loaded",
        "sample_pool_failed", "sample_pool_ram_mb", "sample_pool_generation",
        "sample_get", "sample_len", "sample_channels", "sample_srate",
        "sample_peak", "sample_rms", "sample_preview_bins",
    })
    POOL_READ = frozenset({
        "sample_read", "sample_read_interp", "sample_read2",
        "sample_read2_interp", "sample_preview_read", "sample_name",
    })
    POOL_EXPORT = frozenset({"sample_export_mem", "sample_export_mem2"})
    LEGACY_FILE = frozenset({
        "file_open", "file_open_multi", "file_close", "file_rewind",
        "file_seek", "file_avail", "file_text", "file_riff", "file_var",
        "file_mem", "file_multi_count", "file_multi_select",
    })
    COMM_SEND = frozenset({"msg_send", "msg_sendto", "msg_send_buf", "msg_sendto_buf"})
    COMM_RECV = frozenset({"msg_recv", "msg_recv_buf"})
    COMM_DISCOVERY = frozenset({"msg_peer_count", "msg_peer_id", "msg_peer_name",
                                "msg_peer_uid", "msg_peer_caps", "msg_peer_alive"})

    @property
    def POOL_ALL(self) -> frozenset:
        return self.POOL_SETUP | self.POOL_QUERY | self.POOL_READ | self.POOL_EXPORT


FUNSETS = _FunSets()


def _all_nodes(section_programs: Dict[str, List[Node]], fn_defs: Dict[str, Any]):
    for prog in section_programs.values():
        for stmt in prog:
            yield from walk(stmt)
    for f in fn_defs.values():
        yield from walk(f.body)


def detect_comm_usage(section_programs: Dict[str, List[Node]],
                      fn_defs: Dict[str, Any]) -> Dict[str, Any]:
    fs = FUNSETS
    uses_msg = uses_gmem = uses_msg_buffers = False
    channels: Set[str] = set()
    gmem_names: Set[str] = set()
    msg_api = (fs.COMM_SEND | fs.COMM_RECV | fs.COMM_DISCOVERY
               | {"msg_subscribe", "msg_unsubscribe", "msg_advertise", "msg_avail",
                  "msg_kind", "msg_length", "msg_dropped", "msg_clear",
                  "instance_id", "instance_uid", "instance_get_name",
                  "instance_set_name", "comm_join"}
               | fs.HOST_TRACK)

    def literal0(args: List[Node], idx: int, into: Set[str]) -> None:
        if 0 <= idx < len(args) and isinstance(args[idx], Str):
            into.add(args[idx].text)

    for n in _all_nodes(section_programs, fn_defs):
        if isinstance(n, Mem) and isinstance(n.base, Name) and n.base.ident == "gmem":
            uses_gmem = True
        if isinstance(n, Asn) and isinstance(n.target, Mem) \
                and isinstance(n.target.base, Name) and n.target.base.ident == "gmem":
            uses_gmem = True
        if isinstance(n, CallExpr):
            fn = n.func
            if fn in msg_api:
                uses_msg = True
            if fn in ("msg_send_buf", "msg_sendto_buf", "msg_recv_buf"):
                uses_msg_buffers = True
            if fn in fs.GMEM_SETUP | fs.GMEM_BULK | fs.GMEM_QUERY:
                uses_gmem = True
            if fn in {"msg_subscribe", "msg_unsubscribe", "msg_advertise", "msg_send",
                      "msg_send_buf", "msg_recv", "msg_recv_buf", "msg_avail",
                      "msg_kind", "msg_dropped", "msg_clear", "msg_peer_count",
                      "msg_peer_id"}:
                literal0(n.args, 0, channels)
            if fn in ("msg_sendto", "msg_sendto_buf"):
                literal0(n.args, 1, channels)
            if fn in fs.GMEM_SETUP:
                literal0(n.args, 0, gmem_names)

    return {
        "uses_comm": uses_msg or uses_gmem,
        "uses_msg": uses_msg,
        "uses_gmem": uses_gmem,
        "uses_msg_buffers": uses_msg_buffers,
        "channels_static": sorted(channels),
        "gmem_names_static": sorted(gmem_names),
    }


def detect_sample_pool_usage(section_programs: Dict[str, List[Node]],
                             fn_defs: Dict[str, Any]) -> Dict[str, bool]:
    fs = FUNSETS
    flags = {"uses_sample_pool": False, "uses_raw_sample_read": False,
             "uses_export_mem": False, "uses_legacy_file_io": False}
    for n in _all_nodes(section_programs, fn_defs):
        if isinstance(n, CallExpr):
            if n.func in fs.POOL_ALL:
                flags["uses_sample_pool"] = True
            if n.func in fs.POOL_EXPORT:
                flags["uses_export_mem"] = True
            if n.func in {"sample_read", "sample_read_interp", "sample_read2",
                          "sample_read2_interp"}:
                flags["uses_raw_sample_read"] = True
            if n.func in fs.LEGACY_FILE:
                flags["uses_legacy_file_io"] = True
    return flags


def detect_midi_usage(section_programs: Dict[str, List[Node]],
                      fn_defs: Dict[str, Any]) -> Dict[str, bool]:
    fs = FUNSETS
    recv = send = False
    for n in _all_nodes(section_programs, fn_defs):
        if isinstance(n, CallExpr):
            if n.func in fs.MIDI_RECV:
                recv = True
            elif n.func in fs.MIDI_SEND:
                send = True
    return {"uses_midi": recv or send,
            "accepts_midi_input": recv,
            "produces_midi_output": send}


def infer_spl_io(section_programs: Dict[str, List[Node]],
                 fn_defs: Dict[str, Any],
                 pin_hints: Dict[str, Any] | None = None) -> Dict[str, int]:
    """Channel counts from splN usage: read -> input, write -> output.

    Pin declarations (in_pin/out_pin) override inference when present
    (ref: dsp_jsfx_aot.py:1662-1803).
    """
    reads: Set[int] = set()
    writes: Set[int] = set()

    def scan(node: Node, write_ctx: bool) -> None:
        if isinstance(node, Name):
            if node.ident.startswith("spl") and node.ident[3:].isdigit():
                idx = int(node.ident[3:])
                if 0 <= idx < 64:
                    (writes if write_ctx else reads).add(idx)
            return
        if isinstance(node, Asn):
            scan(node.target, True)
            # compound assignment also reads the target
            if node.op != "=" and isinstance(node.target, Name):
                scan(node.target, False)
            scan(node.value, False)
            return
        from ..frontend.astnodes import children
        for c in children(node):
            scan(c, False)

    for prog in section_programs.values():
        for stmt in prog:
            scan(stmt, False)
    for f in fn_defs.values():
        scan(f.body, False)

    n_in = (max(reads) + 1) if reads else 0
    n_out = (max(writes) + 1) if writes else 0
    hints = pin_hints or {}
    if hints.get("inputs") is not None:
        n_in = int(hints["inputs"])
    if hints.get("outputs") is not None:
        n_out = int(hints["outputs"])
    n_in = max(0, min(64, n_in))
    n_out = max(0, min(64, n_out))
    process = max(n_in, n_out, 1)
    return {"inputs": n_in, "outputs": n_out, "process": process}


def validate_builtin_sections(section_programs: Dict[str, List[Node]]) -> None:
    """Raise SectionLegalityError for builtins called from illegal sections.

    Diagnostic text matches the reference exactly, e.g.
    "msg_send() is only valid in @block at 12:3"
    (ref: dsp_jsfx_aot.py:1544-1606).
    """
    fs = FUNSETS
    block_only = (fs.COMM_BLOCK | fs.GMEM_BULK | fs.POOL_EXPORT)
    setup_sections = ({"comm_join", "msg_subscribe", "msg_unsubscribe", "msg_advertise",
                       "instance_set_name", "instance_get_name", "instance_uid"}
                      | fs.GMEM_SETUP | fs.HOST_TRACK | fs.POOL_SETUP)
    isb_only = {"instance_id"}
    pool_runtime = fs.POOL_QUERY | fs.POOL_READ

    for section, prog in section_programs.items():
        for stmt in prog:
            for n in walk(stmt):
                if not isinstance(n, CallExpr):
                    continue
                fn = n.func
                line, col = n.pos
                if fn in block_only and section != "block":
                    raise SectionLegalityError(
                        f"{fn}() is only valid in @block at {line}:{col}")
                if fn in setup_sections and section not in ("init", "slider", "block"):
                    raise SectionLegalityError(
                        f"{fn}() is only valid in @init, @slider, or @block at {line}:{col}")
                if fn in isb_only and section not in ("init", "slider", "block"):
                    raise SectionLegalityError(
                        f"{fn}() is only valid in @init, @slider, or @block at {line}:{col}")
                if fn in pool_runtime and section not in ("init", "slider", "block", "sample"):
                    raise SectionLegalityError(
                        f"{fn}() is only valid in @init, @slider, @block, or @sample at {line}:{col}")
