"""The port's render graph (runtime/graph.py), three ways on the same
seeded inputs: the port's graph on the CPU (prefer="auto", device="cpu":
K10's plain version with the lockstep's staging, the segment programs'
plain versions), the JAX package's graph (prefer="auto") and the
all-shadow graph (the golden, comm/bus.py).

The cases: every case of tests/test_graph_msg_lockstep.py, the cases of
tests/test_graph_device.py that need no catalog, those that need the
catalog's IPC probes with test_comm.py's sender and receiver in their
place, and builtin_plugins.crossmix_declutter on 4 nodes.  Each holds:
the engines (the JAX graph's `tpu-*` are the port's `torch-*`), the audio
equal to the shadow graph's, the vars equal to the shadow's and within
1e-12 of the JAX graph's (XLA fuses multiply-adds), the gmem segments
equal to the shadow's, their page sequence numbers as the reference's
coarse attribution leaves them (each lockstep member bumps the changed
span once a render; the JAX graph's also carry its specializer probes'
bumps, which the port gives back), the ring's tail (with its sequence
numbers) and the cursors equal to the shadow's."""
import numpy as np
import pytest

import test_comm as ref_comm
import test_graph_device as ref_device
import test_graph_msg_lockstep as ref_msg
from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.runtime.graph import RenderGraph as JaxGraph

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.runtime.graph import RenderGraph

MSG_SRC = ref_msg.MSG_SRC
STATE_VARS = ref_msg.STATE_VARS
COUPLED_SRC = ref_device.TestCoupledNodesInGraph.COUPLED_SRC
LOCKSTEP_SRC = ref_device.TestCoupledNodesInGraph.LOCKSTEP_SRC
# the catalog's IPCProbeA / IPCProbeB: a sender and a receiver of one bus,
# uncoupled, so they render as torch-vector through the host lockstep
PROBE_TX, PROBE_RX = ref_comm.SENDER_SRC, ref_comm.RECEIVER_SRC
HARD_SRC = ("@init\nn = 0;\n@sample\n"
            "k = abs(spl0) * 4;\ni = 0;\nacc = 0;\n"
            "while (i < k) ( acc += 0.1; i += 1; );\n"
            "spl0 = spl0 + acc * 0.001;\nspl1 = spl1;\n")


@pytest.fixture(autouse=True)
def _trace_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path / "traces"))


def build(which, nodes, inputs, block=64):
    """A graph of `nodes` [(name, source, sliders)] rendered over each dict
    of `inputs` in turn: (graph, the last render's outputs).  A source
    named twice compiles once, as the reference's tests add one program
    to two nodes."""
    if which == "jax":
        g, comp = JaxGraph(block_size=block, prefer="auto"), jax_compile
    elif which == "port":
        g = RenderGraph(block_size=block, prefer="auto", device="cpu")
        comp = compile_plugin_source
    else:
        g, comp = RenderGraph(block_size=block), compile_plugin_source
    progs = {}
    for name, src, sliders in nodes:
        if src not in progs:
            progs[src] = comp(src)
        g.add(name, progs[src], sliders=sliders)
    g.init_all()
    outs = None
    for x in inputs:
        outs = g.run(x)
    return g, outs


def three_ways(nodes, inputs, block=64):
    return {w: build(w, nodes, inputs, block)
            for w in ("shadow", "port", "jax")}


def noise(names, n, seed, scale, renders=1):
    """The reference tests' inputs: one seeded stream, a block of [2, n]
    a render, the same for every node."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(renders):
        x = (rng.randn(2, n) * scale).astype(np.float32)
        out.append({name: x for name in names})
    return out


def held(res, var_tol=0.0, renders=1, audio_tol=0.0):
    """The checks every case makes (see the module's docstring); var_tol
    is the vars' and the segments' tolerance against the shadow, audio_tol
    the audio's (0: equal)."""
    gs, outs_s = res["shadow"]
    gp, outs_p = res["port"]
    gj, _outs_j = res["jax"]
    assert gp.node_engines == [e.replace("tpu-", "torch-")
                               for e in gj.node_engines], \
        (gp.node_engines, gj.node_engines, gp.spec_errors, gj.spec_errors)
    for name in outs_s:
        if audio_tol:
            assert np.abs(outs_s[name] - outs_p[name]).max() <= audio_tol
        else:
            assert np.array_equal(outs_s[name], outs_p[name]), name
    for i in range(len(gs.plugins)):
        vs, vp = gs.plugins[i].state.V, gp.plugins[i].state.V
        vj = gj.plugins[i].state.V
        for k, v in vs.items():
            if v >= (1 << 40) or v != v:
                continue                    # string handles, NaN
            assert abs(vp[k] - v) <= var_tol * max(1.0, abs(v)), (i, k)
            assert abs(vp[k] - vj[k]) <= 1e-12 * max(1.0, abs(v)), (i, k)
    lock = [i for i, e in enumerate(gp.node_engines)
            if e == "torch-lockstep"]
    for i, (hs, hp) in enumerate(zip(gs.hosts, gp.hosts)):
        seg_s, seg_p = hs.attached_gmem, hp.attached_gmem
        if seg_s is None:
            continue
        assert np.allclose(seg_p.cells, seg_s.cells, rtol=var_tol, atol=0.0) \
            if var_tol else np.array_equal(seg_p.cells, seg_s.cells)
        if i in lock and seg_p.cells.any():
            pages = np.nonzero(seg_p.cells)[0] // 1024
            assert seg_p.global_seq == len(lock) * renders
            assert (seg_p.page_seq[pages] == seg_p.global_seq).all()
            assert (seg_p.page_writer[pages]
                    == gp.hosts[lock[-1]].instance_id_int).all()
    def ring(g):
        return [((m.seq, m.sender, m.dest, m.channel, m.tag), m.scalars)
                for m in g.hosts[0].domain.ring]
    ring_p = ring(gp)
    if ring_p:
        ring_s = ring(gs)[-len(ring_p):]
        # the JAX graph's numbers count its specializer probes' sends
        ring_j = [((0,) + h[1:], v) for h, v in ring(gj)][-len(ring_p):]
        assert [h for h, _v in ring_p] == [h for h, _v in ring_s]
        assert [h[1:] for h, _v in ring_p] == [h[1:] for h, _v in ring_j]
        for (_h, v), (_hs, vs), (_hj, vj) in zip(ring_p, ring_s, ring_j):
            assert np.allclose(v, vs, rtol=var_tol, atol=0.0) if var_tol \
                else v == vs
            assert np.allclose(v, vj, rtol=1e-12, atol=0.0)
    assert [h.cursor for h in gp.hosts] == [h.cursor for h in gs.hosts]
    return gs, gp, gj


# -- tests/test_graph_msg_lockstep.py ------------------------------------------

def test_msg_coupled_pair_joint_lockstep_scan():
    n = 64 * 6 + 17          # the remainder block too
    res = three_ways([("a", MSG_SRC, None), ("b", MSG_SRC, None)],
                     noise("ab", n, 11, 0.4))
    gs, gp, _gj = held(res)
    assert gp.node_engines == ["torch-lockstep", "torch-lockstep"]
    assert np.abs(res["port"][1]["a"]).max() > 0.0
    # b hears a in the same block, a hears b a block late
    assert gp.plugins[1].state.V["nrecv"] == 7.0
    assert gp.plugins[0].state.V["nrecv"] == 6.0
    for i in range(2):
        for k in STATE_VARS:
            assert gp.plugins[i].state.V.get(k, 0.0) == \
                gs.plugins[i].state.V.get(k, 0.0), (i, k)


def test_msg_lockstep_resumes_across_renders():
    res = three_ways([("a", MSG_SRC, None), ("b", MSG_SRC, None)],
                     noise("ab", 64 * 3, 11, 0.4, renders=2))
    _gs, gp, _gj = held(res, renders=2)
    assert gp.node_engines == ["torch-lockstep", "torch-lockstep"]


def test_msg_sendto_direct():
    src = MSG_SRC.replace(
        'msg_send("meter", 7, avg, instance_id(), 0, 0);',
        'tgt = instance_id() == 1 ? 2 : 1;\n'
        'msg_sendto(tgt, "meter", 9, avg, instance_id(), 0, 0);')
    res = three_ways([("a", src, None), ("b", src, None)],
                     noise("ab", 64 * 4, 11, 0.4))
    _gs, gp, _gj = held(res)
    assert gp.node_engines == ["torch-lockstep", "torch-lockstep"]
    assert gp.plugins[1].state.V["nrecv"] > 0.0


def test_msg_host_path_node_demotes():
    uncoupled = ("@init\nmsg_subscribe(\"meter\");\n"
                 "@block\nwhile (msg_recv(\"meter\", s, t, a, b, c, d)) "
                 "( heard += 1; );\n"
                 "@sample\nspl0 = spl0 * 0.5;\nspl1 = spl1 * 0.5;\n")
    res = three_ways([("a", MSG_SRC, None), ("w", uncoupled, None)],
                     noise("aw", 64 * 3, 13, 0.3))
    gs, gp, _gj = held(res)
    assert gp.node_engines[0] == "cpu-shadow"
    assert "host-path" in gp.spec_errors["a"]
    assert gs.plugins[1].state.V["heard"] == gp.plugins[1].state.V["heard"] \
        > 0.0


def test_solo_msg_member_rides_lockstep():
    src = """\
@init
x = 0;
@block
avg = acc / max(samplesblock, 1);
msg_send("tap", 1, avg, 0, 0, 0);
g = 1 / (1 + avg);
acc = 0;
@sample
acc += abs(spl0);
spl0 = spl0 * g;
spl1 = spl1 * g;
"""
    res = three_ways([("solo", src, None)], noise(["solo"], 64 * 5, 7, 0.3))
    _gs, gp, _gj = held(res)
    assert gp.node_engines == ["torch-lockstep"]
    # the window compacts at every block's start what its member has seen:
    # the last two blocks' sends are left
    assert len(gp.hosts[0].domain.ring) == 2


# -- tests/test_graph_device.py, the cases that need no catalog ---------------

def test_gmem_coupled_pair_joint_lockstep_scan():
    n = 64 * 6 + 17
    res = three_ways([("a", LOCKSTEP_SRC, {0: 0.0}),
                      ("b", LOCKSTEP_SRC, {0: 1.0})],
                     noise("ab", n, 3, 0.4))
    gs, gp, _gj = held(res)
    assert gp.node_engines == ["torch-lockstep", "torch-lockstep"]
    assert gs.hosts[0].attached_gmem.cells[:2].any()


def test_gmem_segment_shared_with_host_node_demotes():
    watcher = ("@init\ngmem_attach(\"lockbus\");\n"
               "@block\nw = gmem[0];\n@sample\nspl0 = spl0 * (1 + 0*w);\n"
               "spl1 = spl1;\n")
    res = three_ways([("a", LOCKSTEP_SRC, {0: 0.0}), ("w", watcher, None)],
                     noise("aw", 64 * 4, 4, 0.3))
    _gs, gp, _gj = held(res)
    assert gp.node_engines[0] == "cpu-shadow"
    assert "host-path" in gp.spec_errors["a"]


def test_coupled_node_touching_bus_rides_lockstep():
    src = COUPLED_SRC.replace("acc = 0;",
                              "acc = 0;\nmsg_send(1, 1, g, 0, 0, 0);")
    res = three_ways([("node", src, None)], noise(["node"], 64 * 4, 5, 0.3))
    _gs, gp, _gj = held(res)
    assert gp.node_engines == ["torch-lockstep"]


# -- the IPC-probe cases with the in-repo sender and receiver -----------------

def test_device_graph_matches_shadow():
    res = three_ways([("tx", PROBE_TX, None), ("rx", PROBE_RX, None)],
                     noise(["tx", "rx"], 64 * 6, 5, 0.1))
    gs, gp, _gj = held(res)
    # both take the vector path, their @block on the host in lockstep
    assert gp.node_engines == ["torch-vector", "torch-vector"]
    assert gp.plugins[0].state.V["seq"] == 6.0
    assert gp.plugins[1].state.V["rx_count"] == 6.0
    assert gs.hosts[0].attached_gmem.cells[5] == 6.0


def test_mixed_graph_shadow_fallback_nodes():
    res = three_ways([("tx", PROBE_TX, None), ("rx", PROBE_RX, None),
                      ("hard", HARD_SRC, None)],
                     noise(["tx", "rx", "hard"], 64 * 4, 5, 0.1))
    _gs, gp, _gj = held(res)
    assert gp.node_engines[0] == "torch-vector"
    assert gp.node_engines[2] == "cpu-shadow"


def test_coupled_node_rides_device_beside_ipc_pair():
    res = three_ways([("tx", PROBE_TX, None), ("rx", PROBE_RX, None),
                      ("meter", COUPLED_SRC, None)],
                     noise(["tx", "rx", "meter"], 64 * 6, 5, 0.3))
    _gs, gp, _gj = held(res)
    assert gp.node_engines == ["torch-vector"] * 3
    assert gp.kernels[2].coupled
    assert np.abs(res["port"][1]["meter"]).max() > 0.0


# -- the stand-in ---------------------------------------------------------------

def test_crossmix_declutter_four_nodes():
    n = 64 * 6 + 17
    nodes = [(f"n{i}", builtin_plugins.crossmix_declutter(i, 4), None)
             for i in range(4)]
    rng = np.random.RandomState(23)
    x = {f"n{i}": (rng.randn(2, n) * 0.3).astype(np.float32)
         for i in range(4)}
    res = three_ways(nodes, [x])
    # its energy meters and the gain's one-pole are the segment program's
    # chunked sums (K2's order), an ulp or so from the golden's loop: the
    # vars hold within 1e-12 of the shadow, the audio within one f32 ulp
    # of its largest sample (the golden contract's AUDIO_EPS is 1e-5)
    gs, gp, _gj = held(res, var_tol=1e-12, audio_tol=1e-7)
    assert gp.node_engines == ["torch-lockstep"] * 4
    for i in range(4):
        v = gp.plugins[i].state.V
        assert v["heard"] == gs.plugins[i].state.V["heard"] > 0.0
        assert v["lsrc"] == gs.plugins[i].state.V["lsrc"]
    assert gs.hosts[0].attached_gmem.cells[:4].all()
