"""The port's copy of the comm layer (comm/bus.py) and its render graph, on
the cases of tests/test_comm.py: block-synchronous delivery, shared gmem,
peers, isolated buses, direct sends, buffer messages, the ring's drop
accounting and peer names.  Each graph case runs on the all-shadow graph
(prefer="shadow") and on the device graph on the CPU (prefer="auto",
device="cpu": the uncoupled nodes' @block on the host in lockstep, their
samples through the segment program), and both hold every var the JAX
package's shadow graph holds."""
import numpy as np
import pytest

import test_comm as ref
from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.runtime.graph import RenderGraph as JaxGraph

from zorak_tpu_torch.comm import CommWorld, InstanceComm, RING_CAPACITY
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.runtime.graph import RenderGraph

PREFERS = ["shadow", "auto"]


def run_both(prefer, nodes, block, n, setup=None, nch=1):
    """The port's graph (prefer) and the JAX package's shadow graph of
    `nodes` [(name, source)] on n samples of silence; setup(graph, hosts)
    runs after init_all.  Returns (port graph, JAX graph, port hosts)."""
    out = []
    for which in ("port", "jax"):
        if which == "port":
            g = RenderGraph(block_size=block, prefer=prefer, device="cpu")
            comp = compile_plugin_source
        else:
            g, comp = JaxGraph(block_size=block), jax_compile
        hosts = [g.add(name, comp(src)) for name, src in nodes]
        g.init_all()
        if setup is not None:
            setup(g, hosts)
        x = np.zeros((nch, n), dtype=np.float32)
        g.run({name: x for name, _src in nodes})
        out.append((g, hosts))
    (gp, hosts), (gj, _hj) = out
    for i in range(len(nodes)):
        vp, vj = gp.plugins[i].state.V, gj.plugins[i].state.V
        for k, v in vj.items():
            if v < (1 << 40):                   # not a string handle
                assert vp.get(k) == v, (i, k, vp.get(k), v)
    return gp, gj, hosts


@pytest.mark.parametrize("prefer", PREFERS)
def test_block_synchronous_delivery(prefer):
    g, _gj, (tx, _rx) = run_both(
        prefer, [("tx", ref.SENDER_SRC), ("rx", ref.RECEIVER_SRC)], 64, 64 * 4)
    if prefer == "auto":
        assert g.node_engines == ["torch-vector", "torch-vector"], \
            g.spec_errors
    rx_state, tx_state = g.plugins[1].state, g.plugins[0].state
    assert tx_state.V["seq"] == 4.0
    assert rx_state.V["rx_count"] == 4.0
    assert rx_state.V["rx_seq"] == 4.0
    assert rx_state.V["rx_tag"] == 42.0
    assert rx_state.V["last_b"] == 8.0
    assert rx_state.V["sender_id"] == tx.instance_id_value


@pytest.mark.parametrize("prefer", PREFERS)
def test_gmem_shared_and_peers(prefer):
    g, gj, _hosts = run_both(
        prefer, [("tx", ref.SENDER_SRC), ("rx", ref.RECEIVER_SRC)], 32, 32 * 3)
    assert g.plugins[1].state.V["g5"] == 3.0
    assert g.plugins[0].state.V["peers"] == 1.0
    assert g.plugins[1].state.V["dropped"] == 0.0
    assert np.array_equal(g.hosts[0].attached_gmem.cells,
                          gj.hosts[0].attached_gmem.cells)


@pytest.mark.parametrize("prefer", PREFERS)
def test_different_bus_isolated(prefer):
    other = ref.RECEIVER_SRC.replace('"probe"', '"other"')
    g, _gj, _hosts = run_both(
        prefer, [("tx", ref.SENDER_SRC), ("rx", other)], 32, 96)
    assert g.plugins[1].state.V["rx_count"] == 0.0


@pytest.mark.parametrize("prefer", PREFERS)
def test_sendto_direct(prefer):
    src_tx = ("@init\ncomm_join(\"d\");\n"
              "@block\ntarget > 0 ? msg_sendto(target, \"x\", 7, 1, 2, 3, 4);\n")
    src_rx = ("@init\ncomm_join(\"d\");\nmsg_subscribe(\"x\");\n"
              "@block\nwhile (msg_recv(\"x\", s, t, a, b, c, d)) ( got = t; );\n")

    def setup(g, hosts):
        g.plugins[0].state.V["target"] = hosts[1].instance_id_value
    g, _gj, _hosts = run_both(prefer, [("tx", src_tx), ("rx", src_rx)], 16,
                              48, setup)
    assert g.plugins[1].state.V["got"] == 7.0


@pytest.mark.parametrize("prefer", PREFERS)
def test_buffer_messages(prefer):
    src_tx = ("@init\ncomm_join(\"d\");\nbuf = 100;\n"
              "i = 0; loop(8, buf[i] = 10 + i; i += 1;);\n"
              "@block\nmsg_send_buf(\"data\", 3, buf, 8);\n")
    src_rx = ("@init\ncomm_join(\"d\");\nmsg_subscribe(\"data\");\nrb = 500;\n"
              "@block\n"
              "k = msg_kind(\"data\");\n"
              "n = msg_recv_buf(\"data\", s, t, rb, 64);\n"
              "n > 0 ? ( got_n = n; got_first = rb[0]; got_last = rb[7]; "
              "got_kind = k; );\n")
    g, _gj, _hosts = run_both(prefer, [("tx", src_tx), ("rx", src_rx)], 16,
                              48)
    rx = g.plugins[1].state
    assert rx.V["got_n"] == 8.0
    assert rx.V["got_first"] == 10.0 and rx.V["got_last"] == 17.0
    assert rx.V["got_kind"] == 2.0


def test_ring_overflow_drop_accounting():
    world = CommWorld()
    a = InstanceComm(world)
    b = InstanceComm(world)

    class FakeState:
        strings_by_handle = {1 << 40: "ch"}
        handles_by_string = {"ch": 1 << 40}

        def string_for_handle(self, h):
            return self.strings_by_handle.get(int(h))

    st = FakeState()
    b.msg_subscribe(st, float(1 << 40))
    for i in range(RING_CAPACITY + 100):
        a.msg_send(st, float(1 << 40), 1.0, float(i), 0, 0, 0)
    a.end_block()
    b.begin_block()
    assert b.dropped.get("ch", 0) == 100
    assert b.msg_avail(st, float(1 << 40)) == float(RING_CAPACITY)


@pytest.mark.parametrize("prefer", PREFERS)
def test_peer_name_uid(prefer):
    src_a = ('@init\ncomm_join("d");\ninstance_set_name("alpha");\n'
             'msg_subscribe("c");\n')
    src_b = ('@init\ncomm_join("d");\nmsg_subscribe("c");\n'
             "@block\n"
             'pid = msg_peer_id("c", 1, 0);\n'
             "pid > 0 ? (\n"
             "  ok_name = msg_peer_name(pid, #pname);\n"
             "  ok_uid = msg_peer_uid(pid, #puid);\n"
             "  nlen = strlen(#pname);\n"
             "  alive = msg_peer_alive(pid);\n"
             ");\n")
    g, _gj, _hosts = run_both(prefer, [("a", src_a), ("b", src_b)], 16, 16)
    st = g.plugins[1].state
    assert st.V["ok_name"] == 1.0 and st.V["ok_uid"] == 1.0
    assert st.V["nlen"] == 5.0  # "alpha"
    assert st.V["alive"] == 1.0
