"""Inter-instance communication: message bus + gmem.

The reference implements these over named shared-memory segments for
cross-process DAW use (ref: src/DspJsfxMessageBus.cpp:17-23,
src/DspJsfxGmem.h:15-38).  In the TPU offline engine all instances are
colocated, so the equivalents are in-process structures with the SAME
semantics (ref: docs/DSP-JSFX-Communication.md):

* block-synchronous delivery — sends enqueue at end-of-block, receivers
  materialize inboxes at begin-of-block,
* FIFO per sender+channel, no global ordering guarantee,
* bounded ring (4096 slots, 64-double payload cap) with per-channel drop
  accounting when unread slots are overwritten,
* broadcast is no-self; direct sends target instance ids,
* peer registry with roles (subscriber/publisher), names, uids, caps,
* gmem: named 1M-cell segments in 1024-cell pages carrying a sequence
  number + last-writer id per page for change detection.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from ..shadow.state import HostServices

RING_CAPACITY = 4096        # ref: DspJsfxMessageBus.cpp:19
PAYLOAD_CAP = 64            # doubles per buffer message
MAX_INSTANCES = 256
MAX_CHANNELS = 24           # per instance subscriptions
GMEM_DEFAULT_CELLS = 1 << 20
GMEM_PAGE_CELLS = 1024

KIND_EMPTY = 0.0
KIND_SCALAR = 1.0
KIND_BUFFER = 2.0


@dataclass
class Message:
    seq: int
    sender: int
    dest: Optional[int]          # None = broadcast
    channel: str
    tag: float
    kind: float                  # KIND_SCALAR | KIND_BUFFER
    scalars: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    buffer: Optional[np.ndarray] = None

    @property
    def length(self) -> float:
        if self.kind == KIND_BUFFER and self.buffer is not None:
            return float(len(self.buffer))
        return 4.0


class GmemSegment:
    """Named shared array with per-page sequence numbers."""

    def __init__(self, name: str, cells: int = GMEM_DEFAULT_CELLS):
        self.name = name
        self.cells = np.zeros(max(GMEM_PAGE_CELLS, int(cells)), dtype=np.float64)
        n_pages = (len(self.cells) + GMEM_PAGE_CELLS - 1) // GMEM_PAGE_CELLS
        self.page_seq = np.zeros(n_pages, dtype=np.int64)
        self.page_writer = np.zeros(n_pages, dtype=np.int64)
        self.global_seq = 0

    def bump(self, first_cell: int, last_cell: int, writer: int) -> None:
        p0 = first_cell // GMEM_PAGE_CELLS
        p1 = min(last_cell // GMEM_PAGE_CELLS, len(self.page_seq) - 1)
        self.global_seq += 1
        self.page_seq[p0:p1 + 1] = self.global_seq
        self.page_writer[p0:p1 + 1] = writer


class CommDomain:
    """One communication domain: peer registry + message ring + gmem spaces."""

    def __init__(self, name: str = ""):
        self.name = name
        self.instances: Dict[int, "InstanceComm"] = {}
        self.ring: Deque[Message] = deque()
        self.next_seq = itertools.count(1)
        self.gmem_spaces: Dict[str, GmemSegment] = {}

    def register(self, inst: "InstanceComm") -> None:
        if len(self.instances) >= MAX_INSTANCES:
            raise RuntimeError(f"domain {self.name!r}: instance limit reached")
        self.instances[inst.instance_id_int] = inst

    def unregister(self, inst: "InstanceComm") -> None:
        self.instances.pop(inst.instance_id_int, None)

    def gmem(self, namespace: str, cells: Optional[int] = None) -> GmemSegment:
        seg = self.gmem_spaces.get(namespace)
        if seg is None:
            seg = GmemSegment(namespace, cells or GMEM_DEFAULT_CELLS)
            self.gmem_spaces[namespace] = seg
        elif cells and cells > len(seg.cells):
            grown = np.zeros(int(cells), dtype=np.float64)
            grown[: len(seg.cells)] = seg.cells
            seg.cells = grown
            n_pages = (len(grown) + GMEM_PAGE_CELLS - 1) // GMEM_PAGE_CELLS
            seg.page_seq = np.resize(seg.page_seq, n_pages)
            seg.page_writer = np.resize(seg.page_writer, n_pages)
        return seg

    def publish(self, msg: Message) -> None:
        self.ring.append(msg)
        while len(self.ring) > RING_CAPACITY:
            evicted = self.ring.popleft()
            # drop accounting: any reader that had not consumed this slot
            for inst in self.instances.values():
                if inst.cursor < evicted.seq and inst._matches(evicted):
                    inst.dropped[evicted.channel] = \
                        inst.dropped.get(evicted.channel, 0) + 1

    def peers_for(self, channel: str, role: int = 3,
                  exclude: Optional[int] = None) -> List[int]:
        """role: 1=subscribers, 2=publishers, 3=either
        (ref: docs/DSP-JSFX-Communication.md 'Roles')."""
        out = []
        for iid, inst in self.instances.items():
            if iid == exclude:
                continue
            is_sub = channel in inst.subscriptions
            is_pub = channel in inst.advertised
            if (role == 1 and is_sub) or (role == 2 and is_pub) \
                    or (role not in (1, 2) and (is_sub or is_pub)):
                out.append(iid)
        return sorted(out)


class CommWorld:
    """Engine-scoped registry of domains (the shared-memory namespace root)."""

    def __init__(self) -> None:
        self.domains: Dict[str, CommDomain] = {}
        self._next_id = itertools.count(1)

    def domain(self, name: str) -> CommDomain:
        d = self.domains.get(name)
        if d is None:
            d = CommDomain(name)
            self.domains[name] = d
        return d

    def new_instance_id(self) -> int:
        return next(self._next_id)


class InstanceComm(HostServices):
    """Per-instance comm host: implements the msg_*/gmem_*/instance_* API."""

    def __init__(self, world: CommWorld, name: str = ""):
        super().__init__()
        self.world = world
        self.instance_id_int = world.new_instance_id()
        self.instance_id_value = float(self.instance_id_int)
        self.uid = f"za-{self.instance_id_int:08x}"
        self.display_name = name
        self.caps = 0.0
        self.domain: CommDomain = world.domain("")
        self.domain.register(self)
        self.subscriptions: Set[str] = set()
        self.advertised: Set[str] = set()
        self.cursor = 0                       # ring seq consumed up to
        self.inbox: Dict[str, Deque[Message]] = {}
        self.outbox: List[Message] = []
        self.dropped: Dict[str, int] = {}
        self.attached_gmem: Optional[GmemSegment] = None

    # -- plumbing ------------------------------------------------------------

    def _chan_name(self, st, handle: float) -> str:
        text = st.string_for_handle(handle)
        return text if text is not None else repr(float(handle))

    def _matches(self, msg: Message) -> bool:
        if msg.sender == self.instance_id_int and msg.dest is None:
            return False  # broadcast is no-self
        if msg.dest is not None:
            return msg.dest == self.instance_id_int
        return msg.channel in self.subscriptions

    def begin_block(self, st=None) -> None:
        """Materialize the inbox from the ring (ref: DspJsfxRuntime.cpp:161)."""
        for msg in self.domain.ring:
            if msg.seq > self.cursor and self._matches(msg):
                self.inbox.setdefault(msg.channel, deque()).append(msg)
        if self.domain.ring:
            self.cursor = max(self.cursor, self.domain.ring[-1].seq)

    def end_block(self, st=None) -> None:
        """Flush the outbox into the ring (ref: DspJsfxRuntime.cpp:187)."""
        for msg in self.outbox:
            self.domain.publish(msg)
        self.outbox.clear()

    # -- identity / domain ---------------------------------------------------

    def comm_join(self, st, domain_handle) -> float:
        name = self._chan_name(st, domain_handle)
        if self.domain.name != name:
            self.domain.unregister(self)
            self.domain = self.world.domain(name)
            self.domain.register(self)
            self.cursor = max((m.seq for m in self.domain.ring), default=0)
            self.inbox.clear()
        return 1.0

    def instance_id(self, st) -> float:
        return self.instance_id_value

    def instance_uid(self, st):
        return (1.0, self._intern(st, self.uid))

    def instance_set_name(self, st, handle) -> float:
        self.display_name = self._chan_name(st, handle)
        return 1.0

    def instance_get_name(self, st):
        return (1.0, self._intern(st, self.display_name))

    # -- subscriptions / sends -----------------------------------------------

    def msg_subscribe(self, st, chan) -> float:
        if len(self.subscriptions) >= MAX_CHANNELS:
            return 0.0
        self.subscriptions.add(self._chan_name(st, chan))
        return 1.0

    def msg_unsubscribe(self, st, chan) -> float:
        self.subscriptions.discard(self._chan_name(st, chan))
        return 1.0

    def msg_advertise(self, st, chan, kind) -> float:
        self.advertised.add(self._chan_name(st, chan))
        self.caps = float(kind)
        return 1.0

    def _mk_msg(self, st, dest, chan, tag, kind, scalars=(0.0,) * 4, buffer=None):
        return Message(
            seq=next(self.domain.next_seq), sender=self.instance_id_int,
            dest=dest, channel=self._chan_name(st, chan), tag=float(tag),
            kind=kind, scalars=tuple(float(v) for v in scalars), buffer=buffer)

    def msg_send(self, st, chan, tag, a, b, c, d) -> float:
        self.outbox.append(self._mk_msg(st, None, chan, tag, KIND_SCALAR, (a, b, c, d)))
        return 1.0

    def msg_sendto(self, st, dest, chan, tag, a, b, c, d) -> float:
        try:
            dest_i = int(dest)
        except (ValueError, OverflowError):
            return 0.0
        self.outbox.append(self._mk_msg(st, dest_i, chan, tag, KIND_SCALAR, (a, b, c, d)))
        return 1.0

    def msg_send_buf(self, st, chan, tag, buf, length) -> float:
        data = self._read_mem(st, buf, length)
        if data is None:
            return 0.0
        self.outbox.append(self._mk_msg(st, None, chan, tag, KIND_BUFFER, buffer=data))
        return float(len(data))

    def msg_sendto_buf(self, st, dest, chan, tag, buf, length) -> float:
        try:
            dest_i = int(dest)
        except (ValueError, OverflowError):
            return 0.0
        data = self._read_mem(st, buf, length)
        if data is None:
            return 0.0
        self.outbox.append(self._mk_msg(st, dest_i, chan, tag, KIND_BUFFER, buffer=data))
        return float(len(data))

    @staticmethod
    def _read_mem(st, base, length) -> Optional[np.ndarray]:
        try:
            b = max(0, int(base + 1e-5))
            n = int(length)
        except (ValueError, OverflowError):
            return None
        n = max(0, min(n, PAYLOAD_CAP))
        st.mem_ensure(b + n)
        return np.array(st.mem[b: b + n], dtype=np.float64)

    # -- receives ------------------------------------------------------------

    def _queue(self, st, chan) -> Deque[Message]:
        return self.inbox.setdefault(self._chan_name(st, chan), deque())

    def msg_recv(self, st, chan):
        q = self._queue(st, chan)
        while q:
            m = q.popleft()
            if m.kind == KIND_SCALAR:
                return (float(m.sender), m.tag) + m.scalars[:4]
        return None

    def msg_recv_buf(self, st, chan, buf, maxlen):
        q = self._queue(st, chan)
        while q:
            m = q.popleft()
            if m.kind == KIND_BUFFER and m.buffer is not None:
                try:
                    b = max(0, int(buf + 1e-5))
                    cap = max(0, int(maxlen))
                except (ValueError, OverflowError):
                    return None
                n = min(len(m.buffer), cap)
                st.mem_ensure(b + n)
                st.mem[b: b + n] = m.buffer[:n]
                return (float(m.sender), m.tag, float(n))
        return None

    def msg_avail(self, st, chan) -> float:
        return float(len(self._queue(st, chan)))

    def msg_kind(self, st, chan) -> float:
        q = self._queue(st, chan)
        return q[0].kind if q else KIND_EMPTY

    def msg_length(self, st, chan) -> float:
        q = self._queue(st, chan)
        return q[0].length if q else 0.0

    def msg_dropped(self, st, chan) -> float:
        return float(self.dropped.get(self._chan_name(st, chan), 0))

    def msg_clear(self, st, chan) -> float:
        q = self._queue(st, chan)
        n = len(q)
        q.clear()
        return float(n)

    # -- discovery -----------------------------------------------------------

    def msg_peer_count(self, st, chan, role) -> float:
        try:
            r = int(role)
        except (ValueError, OverflowError):
            r = 3
        return float(len(self.domain.peers_for(self._chan_name(st, chan), r,
                                               exclude=self.instance_id_int)))

    def msg_peer_id(self, st, chan, role, idx) -> float:
        try:
            r = int(role)
            i = int(idx)
        except (ValueError, OverflowError):
            return 0.0
        peers = self.domain.peers_for(self._chan_name(st, chan), r,
                                      exclude=self.instance_id_int)
        return float(peers[i]) if 0 <= i < len(peers) else 0.0

    def _peer(self, peer_id) -> Optional["InstanceComm"]:
        try:
            return self.domain.instances.get(int(peer_id))
        except (ValueError, OverflowError):
            return None

    def _intern(self, st, text: str) -> float:
        h = st.handles_by_string.get(text)
        if h is None:
            h = max(st.handles_by_string.values(), default=1 << 40) + 1
            st.handles_by_string[text] = h
        st.strings_by_handle[h] = text
        return float(h)

    def msg_peer_name(self, st, peer):
        p = self._peer(peer)
        if p is None:
            return None
        return (1.0, self._intern(st, p.display_name))

    def msg_peer_uid(self, st, peer):
        p = self._peer(peer)
        if p is None:
            return None
        return (1.0, self._intern(st, p.uid))

    def msg_peer_caps(self, st, peer) -> float:
        p = self._peer(peer)
        return p.caps if p is not None else 0.0

    def msg_peer_alive(self, st, peer) -> float:
        return 1.0 if self._peer(peer) is not None else 0.0

    # -- gmem ----------------------------------------------------------------

    def gmem_attach(self, st, handle) -> float:
        return self.gmem_attach_size(st, handle, 0.0)

    def gmem_attach_size(self, st, handle, size) -> float:
        name = self._chan_name(st, handle)
        try:
            cells = max(0, int(size))
        except (ValueError, OverflowError):
            cells = 0
        seg = self.domain.gmem(name, cells or None)
        self.attached_gmem = seg
        st.gmem = seg.cells  # scalar gmem[] reads/writes hit the shared array
        return 1.0

    def gmem_store(self, st, idx, val) -> float:
        out = super().gmem_store(st, idx, val)
        seg = self.attached_gmem
        if seg is not None:
            try:
                i = max(0, int(idx + 1e-5))
            except (ValueError, OverflowError):
                return out
            if i < len(seg.cells):
                seg.bump(i, i, self.instance_id_int)
        return out

    def gmem_put(self, st, dst_gmem, src_mem, count) -> float:
        n = super().gmem_put(st, dst_gmem, src_mem, count)
        seg = self.attached_gmem
        if seg is not None and n > 0:
            d = max(0, int(dst_gmem + 1e-5))
            seg.bump(d, d + int(n) - 1, self.instance_id_int)
        return n

    def gmem_fill(self, st, dst, value, count) -> float:
        n = super().gmem_fill(st, dst, value, count)
        seg = self.attached_gmem
        if seg is not None and n > 0:
            d = max(0, int(dst + 1e-5))
            seg.bump(d, d + int(n) - 1, self.instance_id_int)
        return n

    def gmem_copy(self, st, dst, src, count) -> float:
        n = super().gmem_copy(st, dst, src, count)
        seg = self.attached_gmem
        if seg is not None and n > 0:
            d = max(0, int(dst + 1e-5))
            seg.bump(d, d + int(n) - 1, self.instance_id_int)
        return n

    def gmem_seq(self, st, page) -> float:
        seg = self.attached_gmem
        if seg is None:
            return 0.0
        try:
            p = int(page)
        except (ValueError, OverflowError):
            return 0.0
        return float(seg.page_seq[p]) if 0 <= p < len(seg.page_seq) else 0.0

    def gmem_page(self, st, idx) -> float:
        try:
            i = max(0, int(idx + 1e-5))
        except (ValueError, OverflowError):
            return 0.0
        return float(i // GMEM_PAGE_CELLS)
