"""Shadow (golden CPU) plugin state and host-service interface.

The state mirrors the reference's DSPJSFX_State contract (ref:
dsp_jsfx_aot.py:3321-3387): 64 spl registers, 64 sliders, named user vars,
a grow-on-demand f64 heap, srate/samplesblock, MIDI queues, pending
slider-change masks, per-instance MT19937, slider visibility mask, and the
midi_bus/ext_midi_bus registers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..semantics.scalar import EelRng

MAX_CHANNELS = 64
MAX_SLIDERS = 64


def midi_short_length(status: int) -> int:
    """Byte count of a short MIDI message from its status byte (ref
    jsfxShortMessageLength, JSFXJuceProcessor.cpp:1522-1528: JUCE's
    per-status length, floored to 1, capped at 3)."""
    s = int(status) & 0xFF
    if s < 0x80:
        return 1
    hi = s & 0xF0
    if hi in (0xC0, 0xD0):
        return 2
    if hi != 0xF0:
        return 3
    return {0xF1: 2, 0xF2: 3, 0xF3: 2}.get(s, 1)


@dataclass
class MidiEvent:
    """One MIDI event.  Short messages live in b1..b3 (their length is
    implied by the status byte); variable-length messages (sysex, the
    midisend_buf/_str family) carry their full byte string in `data`
    with b1..b3 mirroring the first three bytes (ref
    JsfxRuntimeMidiEvent, JSFXJuceProcessor.cpp:1530-1558)."""
    offset: int
    b1: int
    b2: int
    b3: int
    data: Optional[Tuple[int, ...]] = None

    def key(self) -> Tuple[int, int, int, int]:
        return (self.offset, self.b1, self.b2, self.b3)

    def payload(self) -> Tuple[int, ...]:
        """The event's byte string."""
        if self.data is not None:
            return self.data
        return (self.b1, self.b2, self.b3)[:midi_short_length(self.b1)]


class HostServices:
    """Runtime service surface the DSP can call into.

    Defaults are inert (return 0) so scripts using comm/pool/file APIs run
    standalone; the render engine wires real implementations (comm bus,
    gmem, sample pool, file slots) per instance.
    """

    def __init__(self) -> None:
        self.instance_id_value = 0.0
        # deterministic virtual clock (seconds); the engine/UI advances it
        self.time_seconds = 0.0

    def now(self, precise: bool) -> float:
        return float(self.time_seconds)

    # --- comm / message bus -------------------------------------------------
    def comm_join(self, st, domain) -> float: return 0.0
    def msg_subscribe(self, st, chan) -> float: return 0.0
    def msg_unsubscribe(self, st, chan) -> float: return 0.0
    def msg_advertise(self, st, chan, kind) -> float: return 0.0
    def msg_send(self, st, chan, tag, a, b, c, d) -> float: return 0.0
    def msg_sendto(self, st, dest, chan, tag, a, b, c, d) -> float: return 0.0
    def msg_recv(self, st, chan): return None  # or (src, tag, a, b, c, d)
    def msg_send_buf(self, st, chan, tag, buf, length) -> float: return 0.0
    def msg_sendto_buf(self, st, dest, chan, tag, buf, length) -> float: return 0.0
    def msg_recv_buf(self, st, chan, buf, maxlen): return None  # or (src, tag, n)
    def msg_avail(self, st, chan) -> float: return 0.0
    def msg_kind(self, st, chan) -> float: return 0.0
    def msg_length(self, st, chan) -> float: return 0.0
    def msg_dropped(self, st, chan) -> float: return 0.0
    def msg_clear(self, st, chan) -> float: return 0.0
    def msg_peer_count(self, st, chan, role) -> float: return 0.0
    def msg_peer_id(self, st, chan, role, idx) -> float: return 0.0
    def msg_peer_name(self, st, peer): return None  # or (ret, name_handle)
    def msg_peer_uid(self, st, peer): return None   # or (ret, uid_handle)
    def msg_peer_caps(self, st, peer) -> float: return 0.0
    def msg_peer_alive(self, st, peer) -> float: return 0.0
    def instance_id(self, st) -> float: return self.instance_id_value
    def instance_uid(self, st) -> Tuple[float, float]: return (0.0, 0.0)
    def instance_set_name(self, st, handle) -> float: return 0.0
    def instance_get_name(self, st) -> Tuple[float, float]: return (0.0, 0.0)
    def track_name(self, st) -> Tuple[float, float]: return (0.0, 0.0)
    def track_name_available(self, st) -> float: return 0.0
    def track_name_seq(self, st) -> float: return 0.0

    # --- gmem ---------------------------------------------------------------
    def gmem_attach(self, st, handle) -> float: return 0.0
    def gmem_attach_size(self, st, handle, size) -> float: return 0.0
    def gmem_size(self, st) -> float: return float(len(st.gmem))
    def gmem_load(self, st, idx: float) -> float:
        i = _gmem_index(idx)
        return float(st.gmem[i]) if 0 <= i < len(st.gmem) else 0.0
    def gmem_store(self, st, idx: float, val: float) -> float:
        i = _gmem_index(idx)
        if 0 <= i < len(st.gmem):
            st.gmem[i] = val
        return val
    # bulk signatures follow the runtime shims (ref: DspJsfxRuntimeBuiltins.cpp:180-218):
    #   gmem_get(dstMemBase, srcGmemIdx, count), gmem_put(dstGmemIdx, srcMemBase, count)
    def gmem_get(self, st, dst_mem, src_gmem, count) -> float:
        return _gmem_bulk(st, dst_mem, src_gmem, count, to_mem=True)
    def gmem_put(self, st, dst_gmem, src_mem, count) -> float:
        return _gmem_bulk(st, src_mem, dst_gmem, count, to_mem=False)
    def gmem_fill(self, st, dst, value, count) -> float:
        i = _gmem_index(dst); n = _gmem_index(count)
        end = min(len(st.gmem), i + max(0, n))
        if i < end:
            st.gmem[i:end] = value
        return float(max(0, end - i))
    def gmem_zero(self, st, dst, count) -> float:
        return self.gmem_fill(st, dst, 0.0, count)
    def gmem_copy(self, st, dst, src, count) -> float:
        d = _gmem_index(dst); s = _gmem_index(src); n = max(0, _gmem_index(count))
        n = min(n, len(st.gmem) - max(d, s))
        if n > 0:
            st.gmem[d:d + n] = st.gmem[s:s + n].copy()
        return float(max(0, n))
    def gmem_seq(self, st, page) -> float: return 0.0
    def gmem_page(self, st, idx) -> float: return 0.0

    # --- sample pool / legacy files (inert until runtime wires them) --------
    def sample_pool_call(self, st, fn: str, args: List[float]) -> float: return 0.0
    def sample_name(self, st, index, out_lv_write, maxlen) -> float: return 0.0
    def sample_read2(self, st, pool, sid, phase, interp): return None
    def sample_preview_read(self, st, *args): return None
    def file_call(self, st, fn: str, args: List[float]) -> float:
        # no file slots attached: opening fails with -1 like the reference
        # host with an unassigned slot (ref: JSFXJuceProcessor.cpp:4948-4967
        # rt_file_open_common); other calls are inert
        if fn in ("file_open", "file_open_multi"):
            return -1.0
        return 0.0
    def file_var_read(self, st, handle, *rest): return None
    def file_riff_read(self, st, handle, *rest): return None

    # --- strings ------------------------------------------------------------
    def strlen(self, st, handle) -> float:
        text = st.string_for_handle(handle)
        return float(len(text)) if text is not None else 0.0
    def str_getchar(self, st, handle, idx) -> float:
        text = st.string_for_handle(handle)
        if text is None:
            return 0.0
        i = int(idx)
        return float(ord(text[i])) if 0 <= i < len(text) else 0.0


def _gmem_index(x: float) -> int:
    try:
        i = int(x + 1.0e-5)
    except (ValueError, OverflowError):
        return 0
    return max(0, i)


def _gmem_bulk(st, mem_addr, start, count, *, to_mem: bool) -> float:
    m = _gmem_index(mem_addr)
    g = _gmem_index(start)
    n = max(0, _gmem_index(count))
    n = min(n, len(st.gmem) - g)
    if n <= 0:
        return 0.0
    st.mem_ensure(m + n)
    if to_mem:
        st.mem[m:m + n] = st.gmem[g:g + n]
    else:
        st.gmem[g:g + n] = st.mem[m:m + n]
    return float(n)


DEFAULT_GMEM_CELLS = 1 << 20  # ref: src/DspJsfxGmem.h:17


class ShadowState:
    __slots__ = (
        "spl", "sliders", "V", "mem", "mem_used", "srate", "samplesblock",
        "midi_bus", "ext_midi_bus", "rng", "pending_change_mask",
        "pending_automate_mask", "pending_automate_end_mask",
        "slider_visible_mask", "slider_vis_init", "host", "gmem",
        "midi_in", "midi_in_pos", "midi_out", "strings_by_handle",
        "handles_by_string", "memtop",
    )

    def __init__(self, user_vars: Dict[str, int], memtop: int,
                 string_literals: Dict[str, int],
                 host: Optional[HostServices] = None) -> None:
        self.spl = [0.0] * MAX_CHANNELS
        self.sliders = [0.0] * MAX_SLIDERS
        self.V: Dict[str, float] = {name: 0.0 for name in user_vars}
        self.mem = np.zeros(0, dtype=np.float64)
        self.mem_used = 0
        self.srate = 48000.0
        self.samplesblock = 0.0
        self.midi_bus = 0.0
        self.ext_midi_bus = 0.0
        self.rng = EelRng()
        self.pending_change_mask = 0
        self.pending_automate_mask = 0
        self.pending_automate_end_mask = 0
        self.slider_visible_mask = -1
        self.slider_vis_init = 0
        self.host = host or HostServices()
        self.gmem = np.zeros(DEFAULT_GMEM_CELLS, dtype=np.float64)
        self.midi_in: List[MidiEvent] = []
        self.midi_in_pos = 0
        self.midi_out: List[MidiEvent] = []
        self.handles_by_string = dict(string_literals)
        self.strings_by_handle = {h: s for s, h in string_literals.items()}
        self.memtop = memtop

    # -- heap ---------------------------------------------------------------

    def mem_ensure(self, needed: int) -> None:
        if needed <= len(self.mem):
            if needed > self.mem_used:
                self.mem_used = needed
            return
        new_size = max(needed, 2 * len(self.mem), 65536)
        grown = np.zeros(new_size, dtype=np.float64)
        grown[: len(self.mem)] = self.mem
        self.mem = grown
        self.mem_used = needed

    def string_for_handle(self, handle: float) -> Optional[str]:
        try:
            return self.strings_by_handle.get(int(handle))
        except (ValueError, OverflowError):
            return None

    def clone(self) -> "ShadowState":
        """Deep copy for host-side trajectory interpretation (shares the
        host services object — block-rate service calls are host-side)."""
        c = ShadowState.__new__(ShadowState)
        c.spl = list(self.spl)
        c.sliders = list(self.sliders)
        c.V = dict(self.V)
        c.mem = self.mem.copy()
        c.mem_used = self.mem_used
        c.srate = self.srate
        c.samplesblock = self.samplesblock
        c.midi_bus = self.midi_bus
        c.ext_midi_bus = self.ext_midi_bus
        c.rng = EelRng()
        c.rng.restore(self.rng.snapshot())
        c.pending_change_mask = self.pending_change_mask
        c.pending_automate_mask = self.pending_automate_mask
        c.pending_automate_end_mask = self.pending_automate_end_mask
        c.slider_visible_mask = self.slider_visible_mask
        c.slider_vis_init = self.slider_vis_init
        c.host = self.host
        c.gmem = self.gmem
        c.midi_in = list(self.midi_in)
        c.midi_in_pos = self.midi_in_pos
        c.midi_out = list(self.midi_out)
        c.strings_by_handle = dict(self.strings_by_handle)
        c.handles_by_string = dict(self.handles_by_string)
        c.memtop = self.memtop
        return c
