"""Multi-instance render graph: colocated plugin instances exchanging
messages and gmem block-synchronously, the offline analog of several
plugin instances in one DAW session (ref: docs/DSP-JSFX-Communication.md).

Counterpart of zorak_tpu/runtime/graph.py.  Processing order per block
mirrors the host: for each instance, begin_block (materialise the inbox),
process_block (@block and the samples), end_block (flush the outbox).
Messages sent in block k reach every instance later in the order in block
k and every earlier one in block k + 1.

Device mode (prefer="auto", "vector" or "tpu", read as "vector"): the
same schedule on the card.  Phase 1 is the host lockstep: each uncoupled
vector node's @block and @slider run a block at a time through its host
trajectory against the shared CommWorld, in processing order, and the
nodes the vectorizer rejects render their whole shadow inline.  Phase 2
renders the uncoupled vector nodes and the comm-free coupled nodes on the
card, independently.  Last, the coupled nodes that share a gmem segment or
the message bus (`torch-lockstep`) render jointly: one loop over blocks,
each member's K10 launch and segment in node order on one stream, K10
reading and writing the shared segment in place and staging the bus
through a ring window on the card (`lowering.specialize.lockstep_gmem_run`,
`kernels.block_section.Stage`).  On the card a block of all the members
is one CUDA graph, captured the second time its key is seen and replayed
(K5, `kernels/segment_graph.py`), on the static buffers of the
lockstep's `StepGraphs`, which the graph keeps across renders as the
reference keeps its jitted joint scans; `lockstep_dispatch` says how the
last render's blocks ran, and names the member whose plan K5 refuses
where the lockstep runs eagerly.  The host reads the window, the
segments and the carries once, at the end.

Engines: `torch-vector`, `torch-lockstep`, `cpu-shadow`.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..comm import CommWorld, InstanceComm
from ..ir.program import PluginProgram
from ..shadow import compile_native_shadow, compile_shadow


def _comm_touch(program: PluginProgram) -> "tuple[bool, bool]":
    """(touches the message bus, touches gmem) in the DSP sections
    (slider, block, sample): @init's joins and attaches already ran on the
    host before the kernels build."""
    from ..lowering.devgen import bus_touch

    return bus_touch(program)


def _msg_in_section(program: PluginProgram, section: str) -> bool:
    """Does `section` (or a function it calls) touch the message bus?"""
    from ..lowering.devgen import bus_touch

    return bus_touch(program, (section,))[0]


@dataclass
class GraphNode:
    name: str
    program: PluginProgram
    sliders: Dict[int, float] = field(default_factory=dict)
    input_key: Optional[str] = None     # which named input feeds this node


class RenderGraph:
    """Instances in processing order over one CommWorld.

    prefer: "shadow" renders every node through the golden; "auto" (or
    "vector", "tpu") puts what the vectorizer takes on the card.  device:
    the card's device for the device nodes (None: CUDA; the tests pass
    "cpu").  golden: "python" (shadow/pyexec.py) or "native"
    (shadow/cgen.py, the same host callbacks into the same InstanceComm)."""

    def __init__(self, srate: float = 48000.0, block_size: int = 512,
                 prefer: str = "shadow", device=None,
                 golden: str = "python"):
        if prefer not in ("shadow", "auto", "vector", "tpu"):
            raise ValueError(f"prefer is shadow, auto or vector, not "
                             f"{prefer!r}")
        if golden not in ("python", "native"):
            raise ValueError(f"golden is python or native, not {golden!r}")
        self.srate = float(srate)
        self.block_size = int(block_size)
        self.prefer = "vector" if prefer == "tpu" else prefer
        self.device = device
        self.golden = golden
        self.world = CommWorld()
        self.nodes: List[GraphNode] = []
        self.plugins = []
        self.hosts: List[InstanceComm] = []
        self.kernels: List[Optional[object]] = []
        self.node_engines: List[str] = []
        self.spec_errors: Dict[str, str] = {}
        # the lockstep's ring window after the last render: rows, count,
        # overflow, rows compacted away, each bus member's drops
        self.last_ring: Optional[dict] = None
        # how the last render's lockstep blocks ran (`k5_step_mode`:
        # "graph", "static: ..." or "eager: why"), None without a lockstep
        self.lockstep_dispatch: Optional[str] = None
        # the locksteps' StepGraphs (K5) by the reference's key of its
        # joint scans less what changes from render to render (see
        # `_run_gmem_lockstep`), dropped when the kernels are rebuilt; and
        # the last render's
        self._lockstep_graphs: Dict[tuple, object] = {}
        self.lockstep_k5 = None

    def add(self, name: str, program: PluginProgram,
            sliders: Optional[Dict[int, float]] = None,
            input_key: Optional[str] = None,
            string_sliders: Optional[Dict[int, str]] = None) -> InstanceComm:
        from ..verify.nulltest import apply_slider_state

        node = GraphNode(name, program, dict(sliders or {}), input_key)
        host = InstanceComm(self.world, name=name)
        compile_ = compile_native_shadow if self.golden == "native" \
            else compile_shadow
        plug = compile_(program, host=host)
        plug.state.srate = self.srate
        apply_slider_state(plug.state, program, node.sliders, string_sliders)
        self.nodes.append(node)
        self.plugins.append(plug)
        self.hosts.append(host)
        self.kernels.append(None)
        self.node_engines.append("cpu-shadow")
        return host

    def init_all(self) -> None:
        for plug in self.plugins:
            plug.run_init()
            plug.run_slider()
        if self.prefer != "shadow":
            self._build_kernels()

    def _build_kernels(self) -> None:
        """Specialize every vectorizable node against its state after
        @init, which already joined buses and attached gmem against the
        shared world in node order, so instance ids and segments are the
        all-shadow graph's.  The specializer's @block probes run on cloned
        states and never end a block: their sends stay in the outbox, which
        is dropped here to keep the ring as the render starts it."""
        from ..lowering import SpecializeError, specialize_sample_kernel

        # the locksteps' captures and static buffers are the old kernels'
        self._lockstep_graphs.clear()
        self.lockstep_k5 = None
        # the specializer's @block probes run on cloned states with the live
        # host: their sends take sequence numbers and their gmem writes
        # bump the segments' page sequence numbers.  Give both back, so
        # that the render numbers its messages and pages as the all-shadow
        # graph does
        counters, pages = {}, []
        for dom in self.world.domains.values():
            counters[dom] = next(dom.next_seq)
            dom.next_seq = itertools.count(counters[dom])
            for seg in dom.gmem_spaces.values():
                pages.append((seg, seg.global_seq, seg.page_seq.copy(),
                              seg.page_writer.copy()))
        for i, (node, plug, host) in enumerate(
                zip(self.nodes, self.plugins, self.hosts)):
            nch = max(1, node.program.io_channels["process"])
            try:
                kern = specialize_sample_kernel(
                    node.program, plug.state, nch,
                    block_size=self.block_size, device=self.device)
                msg_t, gmem_t = _comm_touch(node.program)
                if kern.coupled and msg_t:
                    # the lockstep stages the bus at block rate, where the
                    # kernel printed the staging (a live bus host)
                    if _msg_in_section(node.program, "sample"):
                        raise SpecializeError(
                            "coupled node touches the bus in @sample: "
                            "lockstep stages msg planes at block rate "
                            "only")
                    if kern._devblock.msg_out_cells == 0:
                        raise SpecializeError(
                            "coupled @block touching the bus: kernel "
                            "built without device msg staging")
                if kern.coupled and gmem_t and not kern._devblock.uses_gmem:
                    raise SpecializeError(
                        "coupled node touches gmem outside the device "
                        "@block: joint lockstep scan cannot thread it")
                self.kernels[i] = kern
                if kern.coupled and (msg_t or (
                        gmem_t and host.attached_gmem is not None)):
                    self.node_engines[i] = "torch-lockstep"
                else:
                    self.node_engines[i] = "torch-vector"
            except SpecializeError as exc:
                self.spec_errors[node.name] = str(exc)
            # drop (not flush) the probes' sends
            host.outbox.clear()
        for dom, first in counters.items():
            dom.next_seq = itertools.count(first)
        for seg, global_seq, page_seq, page_writer in pages:
            seg.global_seq = global_seq
            seg.page_seq, seg.page_writer = page_seq, page_writer
        # a gmem demotion can strand a bus group and the other way round:
        # alternate the passes until neither demotes
        while True:
            c1 = self._resolve_gmem_groups()
            c2 = self._resolve_msg_groups()
            if not (c1 or c2):
                break

    def _demote(self, i: int, why: str) -> None:
        self.kernels[i] = None
        self.node_engines[i] = "cpu-shadow"
        self.spec_errors[self.nodes[i].name] = why

    def _resolve_gmem_groups(self) -> bool:
        """Per segment: either every node that touches it in a DSP section
        renders in the lockstep, or none does (a host-path node would
        interleave its gmem in phase 1 while the lockstep replays every
        block after it)."""
        seg_touchers: Dict[int, List[int]] = {}
        seg_outside: Dict[int, bool] = {}
        for i, (node, host) in enumerate(zip(self.nodes, self.hosts)):
            seg = host.attached_gmem
            if seg is None or not _comm_touch(node.program)[1]:
                continue
            if self.node_engines[i] == "torch-lockstep":
                seg_touchers.setdefault(id(seg), []).append(i)
            else:
                seg_outside[id(seg)] = True
        changed = False
        for sid, members in seg_touchers.items():
            if seg_outside.get(sid):
                for i in members:
                    self._demote(i, "shared gmem segment also touched by a "
                                 "host-path node: joint lockstep scan cannot "
                                 "include it")
                    changed = True
        return changed

    def _resolve_msg_groups(self) -> bool:
        """Per comm domain: either every node that touches the bus in a DSP
        section renders in the lockstep, or none does; and the lockstep
        threads one ring window, the first live domain's (node order)."""
        dom_members: Dict[int, List[int]] = {}
        dom_outside: Dict[int, bool] = {}
        for i, (node, host) in enumerate(zip(self.nodes, self.hosts)):
            if not _comm_touch(node.program)[0]:
                continue
            kern = self.kernels[i]
            if self.node_engines[i] == "torch-lockstep" and kern is not None \
                    and kern._devblock.msg_out_cells > 0:
                dom_members.setdefault(id(host.domain), []).append(i)
            else:
                dom_outside[id(host.domain)] = True
        changed = False
        for did, members in dom_members.items():
            if dom_outside.get(did):
                for i in members:
                    self._demote(i, "message bus also touched by a host-path "
                                 "node: joint lockstep scan cannot include it")
                    changed = True
        live = [d for d in dom_members if not dom_outside.get(d)]
        for did in live[1:]:
            for i in dom_members[did]:
                self._demote(i, "second comm domain with device msg members: "
                             "the joint scan threads one ring window per "
                             "render")
                changed = True
        return changed

    # -- render ------------------------------------------------------------------

    def _node_input(self, node, ch: int, inputs, start: int, stop: int
                    ) -> np.ndarray:
        src = inputs.get(node.input_key or node.name)
        x = np.zeros((ch, stop - start), dtype=np.float32)
        if src is not None:
            c = min(ch, src.shape[0])
            seg = np.asarray(src[:c, start:stop])
            x[:c, : seg.shape[1]] = seg
        return x

    def run(self, inputs: Dict[str, np.ndarray], total: Optional[int] = None
            ) -> Dict[str, np.ndarray]:
        """inputs: name -> float32 [ch, samples]; returns per-node outputs."""
        return self._run_as(None, inputs, total)

    def _run_as(self, step, inputs: Dict[str, np.ndarray],
                total: Optional[int] = None) -> Dict[str, np.ndarray]:
        """`run` with the lockstep's blocks run as `step` says
        (`lowering.specialize.k5_step_mode`): None as `run`, "eager"
        the eager loop (the yardstick), "graph" K5's graph blocks, refused
        with a SpecializeError before anything renders where K5 refuses a
        member's plan."""
        if total is None:
            total = max((a.shape[1] for a in inputs.values()), default=0)
        if any(k is not None for k in self.kernels):
            return self._run_device(inputs, total, step)
        return self._run_shadow(inputs, total)

    def _lockstep(self) -> List[int]:
        return [i for i, e in enumerate(self.node_engines)
                if e == "torch-lockstep"]

    def _outputs(self, total: int):
        outs: Dict[str, np.ndarray] = {}
        chans: Dict[str, int] = {}
        for node in self.nodes:
            ch = max(1, node.program.io_channels["process"])
            chans[node.name] = ch
            outs[node.name] = np.zeros((ch, total), dtype=np.float32)
        return outs, chans

    def _run_shadow(self, inputs, total: int) -> Dict[str, np.ndarray]:
        outs, chans = self._outputs(total)
        bs = self.block_size
        for start in range(0, total, bs):
            stop = min(start + bs, total)
            for node, plug, host in zip(self.nodes, self.plugins, self.hosts):
                x = self._node_input(node, chans[node.name], inputs,
                                     start, stop)
                host.begin_block(plug.state)
                plug.process_block(x, outs[node.name][:, start:stop])
                host.end_block(plug.state)
        return outs

    def _run_device(self, inputs, total: int, step=None
                    ) -> Dict[str, np.ndarray]:
        """The host lockstep, the independent device renders, then the
        lockstep members' joint render (its blocks as `step` says)."""
        from ..lowering.specialize import k5_step_mode

        lock = self._lockstep()
        # a refused `step` raises here, before any state moves
        k5_step_mode([self.kernels[i] for i in lock], step,
                     [self.nodes[i].name for i in lock])
        outs, chans = self._outputs(total)
        bs = self.block_size
        steppers = [kern.trajectory_stepper()
                    if kern is not None and not kern.coupled else None
                    for kern in self.kernels]
        # phase 1: the host lockstep, in the all-shadow loop's order, so
        # that the ring and the segments evolve as there; shadow nodes
        # render inline.  A coupled device node runs its @block on the card
        # later: only its begin/end bookkeeping runs here, and a bus member
        # none (its ring traffic is the joint render's)
        msg_lock = [self.node_engines[i] == "torch-lockstep"
                    and self.kernels[i]._devblock.msg_out_cells > 0
                    for i in range(len(self.nodes))]
        for start in range(0, total, bs):
            stop = min(start + bs, total)
            for ni, (node, plug, host, kern, stp) in enumerate(zip(
                    self.nodes, self.plugins, self.hosts, self.kernels,
                    steppers)):
                if stp is not None:
                    host.begin_block(stp.state)
                    stp.step(stop - start)
                    host.end_block(stp.state)
                elif kern is not None:
                    if msg_lock[ni]:
                        continue
                    host.begin_block(plug.state)
                    host.end_block(plug.state)
                else:
                    x = self._node_input(node, chans[node.name], inputs,
                                         start, stop)
                    host.begin_block(plug.state)
                    plug.process_block(x, outs[node.name][:, start:stop])
                    host.end_block(plug.state)
        # phase 2: the independent device renders
        for i, (node, plug, kern, stp) in enumerate(
                zip(self.nodes, self.plugins, self.kernels, steppers)):
            if kern is None or self.node_engines[i] == "torch-lockstep":
                continue
            x = self._node_input(node, chans[node.name], inputs, 0, total)
            if stp is not None:
                y, carry = kern.render(x, ctrl=stp.finish())
            else:
                y, carry = kern.render(x)    # the coupled @block on the card
            outs[node.name][:, :] = y
            kern.writeback(carry, plug.state)
        self._run_gmem_lockstep(inputs, total, outs, chans, step)
        return outs

    def _run_gmem_lockstep(self, inputs, total: int, outs, chans,
                           step=None) -> None:
        """The joint render of the `torch-lockstep` members (see
        `lockstep_gmem_run`; its blocks as `step` says, through the
        lockstep's StepGraphs), then the host's state from its end: the
        members' states, the segments (page sequence numbers bumped once a
        member over the changed span, the reference's coarse attribution),
        the ring, the cursors and the inboxes."""
        from types import SimpleNamespace

        from ..comm.bus import KIND_SCALAR
        from ..kernels.segment_graph import StepGraphs
        from ..lowering.specialize import lockstep_gmem_run

        lock = self._lockstep()
        self.lockstep_dispatch = self.lockstep_k5 = None
        if not lock:
            return
        kerns = [self.kernels[i] for i in lock]
        seg_objs: List[object] = []
        seg_ids: List[int] = []
        for i in lock:
            seg = self.hosts[i].attached_gmem
            if seg is None or not _comm_touch(self.nodes[i].program)[1]:
                seg_ids.append(-1)
                continue
            if seg not in seg_objs:
                seg_objs.append(seg)
            seg_ids.append(seg_objs.index(seg))

        msg_members = [j for j, k in enumerate(kerns)
                       if k._devblock.msg_out_cells > 0]
        msg = m0 = dom = None
        ring0 = None
        if msg_members:
            from ..lowering.devgen import MSG_OUT_CAP

            dom = self.hosts[lock[msg_members[0]]].domain
            reg = getattr(self.world, "msg_chan_ids", None)
            if reg is None:
                reg = self.world.msg_chan_ids = {}

            def intern(name: str) -> int:
                return reg.setdefault(name, len(reg))

            init = list(dom.ring)
            for m in init:
                if m.kind != KIND_SCALAR:
                    raise RuntimeError(
                        "buffer message pending in a device-lockstep "
                        "domain: render via prefer='shadow'")
                intern(m.channel)
            for j in msg_members:
                for ch in sorted(self.hosts[lock[j]].subscriptions):
                    intern(ch)
            nc = max(1, len(reg))
            W = 2 * len(msg_members) * MSG_OUT_CAP + len(init)
            my_ids = [float(self.hosts[lock[j]].instance_id_value)
                      if j in msg_members else 0.0
                      for j in range(len(kerns))]
            sub_masks = np.zeros((len(kerns), nc), dtype=bool)
            for j in msg_members:
                for ch in self.hosts[lock[j]].subscriptions:
                    sub_masks[j, reg[ch]] = True
            msg = SimpleNamespace(W=W, nc=nc, my_ids=my_ids,
                                  sub_masks=sub_masks)
            marr0 = np.zeros((len(init), 9), dtype=np.float64)
            for g, m in enumerate(init):
                marr0[g] = [float(m.sender),
                            1.0 if m.dest is None else 0.0,
                            0.0 if m.dest is None else float(m.dest),
                            float(reg[m.channel]), m.tag, *m.scalars[:4]]
            mc0 = [sum(1 for m in init if m.seq <= self.hosts[lock[j]].cursor)
                   for j in msg_members]
            m0 = (marr0, len(init), mc0)
            # the seq the next send takes, and where the cursors start
            first = next(dom.next_seq)
            dom.next_seq = itertools.count(first)
            ring0 = SimpleNamespace(
                seqs=[m.seq for m in init], first=first,
                cursors=[self.hosts[lock[j]].cursor for j in msg_members])

        xs, rands, planes, carries = [], [], [], []
        for j, i in enumerate(lock):
            node, kern = self.nodes[i], kerns[j]
            xs.append(self._node_input(node, chans[node.name], inputs, 0,
                                       total))
            rands.append(kern._rand_streams(total, reset=True))
            planes.append(kern._midi_planes(None, total)
                          if kern._block_prog.uses_midi_in else None)
            carry = kern.initial_carry()
            if j in msg_members:
                self._stage_inbox(kern, self.hosts[i], carry[2])
            carries.append(carry)
        g0 = [np.asarray(s.cells, dtype=np.float64) for s in seg_objs]
        # the reference's key of its jitted joint scans, less what changes
        # from render to render (the length, the window's rows W and the
        # channels interned nc): a graph block's key holds those, so one
        # StepGraphs, its static buffers sized once, serves every render
        key = (tuple(lock), tuple(seg_ids), None if msg is None else
               (tuple(msg.my_ids),
                tuple(tuple(np.flatnonzero(row).tolist())
                      for row in msg.sub_masks)))
        k5 = self._lockstep_graphs.get(key)
        if k5 is None:
            k5 = self._lockstep_graphs[key] = StepGraphs(kerns[0].device)
        ys, fcarries, gfin, mos, msg_fin, self.lockstep_dispatch = \
            lockstep_gmem_run(kerns, seg_ids, carries, xs, rands, planes, g0,
                              msg=msg, m0=m0, step=step, graphs=k5,
                              names=[self.nodes[i].name for i in lock])
        self.lockstep_k5 = k5

        # the host reads the card once, and refuses a render that lost a
        # message before it changes any host state
        fin_np = None
        if msg_fin is not None:
            window, ctl = (t.cpu().numpy() for t in msg_fin)
            drops = [float(fcarries[j][2][kerns[j]._devblock.msg_in_base])
                     for j in msg_members]
            self.last_ring = {"rows": int(window.shape[0]),
                              "count": int(ctl[0]), "overflow": float(ctl[1]),
                              "compacted": int(ctl[2]), "drops": drops}
            if ctl[1] > 0.0:
                raise RuntimeError(
                    "device msg lockstep: ring window overflow "
                    f"({ctl[1]:.0f} entries) — raise MSG_OUT_CAP/window")
            for j, d in zip(msg_members, drops):
                if d > 0.0:
                    raise RuntimeError(
                        f"device msg lockstep: node "
                        f"{self.nodes[lock[j]].name} dropped {d:.0f} "
                        "staged messages — raise MSG_QUEUE_CAP/MSG_OUT_CAP")
            fin_np = (window, ctl)
        for j, i in enumerate(lock):
            node, plug, kern = self.nodes[i], self.plugins[i], kerns[j]
            outs[node.name][:, :] = ys[j].cpu().numpy()
            # the joint render owns a shared segment; a member's heap
            # window holds its own gmem only where it has no segment
            kern.writeback(fcarries[j], plug.state,
                           sync_gmem=seg_ids[j] < 0)
            if mos[j] is not None:
                kern.last_midi_out = kern._decode_midi_out(
                    mos[j].cpu().numpy())
            if j in msg_members:
                self._unstage_inbox(kern, self.hosts[i], fcarries[j][2])
        for seg, gf in zip(seg_objs, gfin):
            gnp = gf.cpu().numpy()
            old = np.asarray(seg.cells, dtype=np.float64)
            n = min(len(old), len(gnp))
            changed = np.nonzero(old[:n] != gnp[:n])[0]
            seg.cells[:n] = gnp[:n]
            if changed.size:
                # coarse, as the reference: the per-writer, per-block
                # cadence is not recoverable after one joint render, so
                # each member bumps once over the changed span, in node
                # order (page_writer ends as the last member)
                for i in lock:
                    seg.bump(int(changed.min()), int(changed.max()),
                             getattr(self.hosts[i], "instance_id_int", 0))
        if fin_np is not None:
            self._msg_lockstep_writeback(dom, lock, msg_members, fin_np,
                                         ring0)

    @staticmethod
    def _queues(kern):
        """(channel name, queue base) of a bus member's receive queues."""
        reg = {cid: name for name, cid in
               kern._devblock.msg_cfg.chan_ids.items()}
        return [(reg[cid], qb) for cid, qb in
                sorted(kern._devblock.msg_queues.items())]

    def _stage_inbox(self, kern, host, bmem: np.ndarray) -> None:
        """The member's pending inbox -> its heap queues, so that a render
        resumes with what the last one left unread (the golden's inbox
        outlives a block)."""
        from ..comm.bus import KIND_SCALAR
        from ..lowering.devgen import MSG_QENT, MSG_QUEUE_CAP

        for name, qb in self._queues(kern):
            q = host.inbox.get(name) or []
            if len(q) > MSG_QUEUE_CAP or any(m.kind != KIND_SCALAR for m in q):
                raise RuntimeError(
                    f"device msg lockstep: {len(q)} messages pending on "
                    f"{name!r} for {host.display_name} do not fit a device "
                    "queue of scalar messages")
            bmem[qb], bmem[qb + 1] = 0.0, float(len(q))
            for k, m in enumerate(q):
                r = qb + 2 + MSG_QENT * k
                bmem[r:r + MSG_QENT] = (float(m.sender), m.tag,
                                        *m.scalars[:4])

    def _unstage_inbox(self, kern, host, bmem) -> None:
        """The member's heap queues after the render -> its inbox."""
        from collections import deque

        from ..comm.bus import KIND_SCALAR, Message
        from ..lowering.devgen import MSG_QENT, MSG_QUEUE_CAP

        base = kern._devblock.msg_in_base
        M = bmem[base:base + kern._devblock.msg_in_cells]
        M = M.cpu().numpy() if hasattr(M, "cpu") else np.asarray(M)
        for name, qb in self._queues(kern):
            qb -= base                          # the IN region alone
            head, cnt = int(M[qb]), int(M[qb + 1])
            q = deque()
            for k in range(cnt):
                r = qb + 2 + MSG_QENT * ((head + k) % MSG_QUEUE_CAP)
                row = M[r:r + MSG_QENT]
                q.append(Message(seq=0, sender=int(row[0]), dest=None,
                                 channel=name, tag=float(row[1]),
                                 kind=KIND_SCALAR,
                                 scalars=tuple(float(v) for v in row[2:])))
            host.inbox[name] = q

    def _msg_lockstep_writeback(self, dom, lock, msg_members, fin,
                                ring0) -> None:
        """The ring and the cursors as the all-shadow graph leaves them:
        the final window replayed into the host ring with the sequence
        numbers the golden gave its messages (a send takes the next one, in
        processing order, as the window lists them), the domain's counter
        past every message the render sent, each member's cursor at the
        last message it had seen (`begin_block`)."""
        from ..comm.bus import KIND_SCALAR, Message

        window, ctl = fin
        reg = getattr(self.world, "msg_chan_ids", {})
        names = {cid: name for name, cid in reg.items()}
        n, compacted = int(ctl[0]), int(ctl[2])
        n_init = len(ring0.seqs)

        def seq_of(a: int) -> int:
            return ring0.seqs[a] if a < n_init else ring0.first + a - n_init
        sent = compacted + n - n_init
        dom.next_seq = itertools.count(ring0.first + sent)
        dom.ring.clear()
        for g in range(n):
            row = window[g]
            dom.ring.append(Message(
                seq=seq_of(compacted + g), sender=int(row[0]),
                dest=None if row[1] > 0.5 else int(row[2]),
                channel=names.get(int(row[3]), repr(float(row[3]))),
                tag=float(row[4]), kind=KIND_SCALAR,
                scalars=(float(row[5]), float(row[6]),
                         float(row[7]), float(row[8]))))
        for pos, j in enumerate(msg_members):
            seen = compacted + int(ctl[3 + pos])
            host = self.hosts[lock[j]]
            host.cursor = max(ring0.cursors[pos], seq_of(seen - 1)) \
                if seen > 0 else ring0.cursors[pos]
