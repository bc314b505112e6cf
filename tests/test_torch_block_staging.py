"""K10's staging for a graph's lockstep members, without a GPU: the
generated text (the staged prologue and epilogue, gmem through the view,
the bus builtins) compiled with g++ -O2 -ffp-contract=off
(`block_section_host`, with 0, 3 and 128 threads, either order) held bit
for bit to the plain version (`block_section_plain`, the golden's host
calls as K10 makes them) on every output: the sample side, the vars, the
heap (queues, OUT table, gmem window), the control row, the shared
segment, the ring window and its control row.  The edges: 33 sends in a
block (the OUT table's overflow), 65 pending messages on one channel (a
queue's overflow), a broadcast that does not reach its sender, direct
sends to this member and to another, a channel nobody here subscribed,
a direct send to an infinite address, gmem at index -1 and at the
segment's size, gmem_fill, gmem_zero and gmem_copy with counts past the
segment, gmem_get and gmem_put across its end, a window that compacts to
empty, a window too small for the block's sends, the remainder block,
and the lone instance's window.  Then the refusals: what the reference's
device sections do not take is refused by name in both packages (the
same routing), K11 takes gmem and a lone instance's bus and refuses what
the reference refuses, and a JAX carry of a member with gmem resumes in
the port."""
import numpy as np
import pytest
import torch

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.runtime.graph import RenderGraph as JaxGraph

from zorak_tpu_torch import convert
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import block_section as BS
from zorak_tpu_torch.lowering import SpecializeError
from zorak_tpu_torch.lowering.devexec import DeviceExecKernel
from zorak_tpu_torch.lowering.devgen import (
    MSG_OUT_CAP, MSG_QUEUE_CAP, DevgenError, DeviceSection,
    section_dynamic_keys)
from zorak_tpu_torch.runtime.graph import RenderGraph
from zorak_tpu_torch.verify import make_initialized_shadow


def _have_host_compiler() -> bool:
    try:
        _build.find_host_compiler()
    except RuntimeError:
        return False
    return True


needs_cxx = pytest.mark.skipif(not _have_host_compiler(),
                               reason="no host C++ compiler (g++, gcc, cc)")

SIZE = 2048
EDGE_SRC = f"""\
@init
gmem_attach_size("edge", {SIZE});
msg_subscribe("a");
SIZE = {SIZE}; NSEND = {MSG_OUT_CAP + 1};
PEER = 2; BAD = 1e308 * 10;
@block
g = 1 / (1 + acc);
acc = 0;
k = 0;
loop(NSEND, msg_send("a", k, k * 2, g, 0, 0); k += 1;);
d1 = msg_sendto(PEER, "b", 5, 1, 2, 3, 4);
d2 = msg_sendto(BAD, "b", 6, 0, 0, 0, 0);
n = 0;
while (msg_recv("a", s, t, p, q, u, v)) ( n += 1; last = p; lsrc = s; );
rb = msg_recv("b", mem[20], mem[21], mem[22], mem[23], mem[24], mem[25]);
av = msg_avail("b"); kd = msg_kind("b"); ln = msg_length("b");
cl = msg_clear("b");
gm1 = gmem[-1]; gmem[-1] = gm1 + 7;
gn = gmem[SIZE]; gmem[SIZE] = 9; gmem[SIZE - 1] += 3;
f1 = gmem_fill(SIZE - 3, 1.5, 10);
z1 = gmem_zero(SIZE - 2, 10);
c1 = gmem_copy(SIZE - 5, 0, 10);
t1 = gmem_get(100, SIZE - 4, 8);
t2 = gmem_put(SIZE - 2, 100, 8);
id = instance_id(); pc = msg_peer_count("a", 3);
p0 = msg_peer_id("a", 3, k - NSEND); al = msg_peer_alive(PEER);
ca = msg_peer_caps(PEER); dr = msg_dropped("a");
@sample
acc += abs(spl0);
spl0 *= g;
"""


@pytest.fixture(scope="module")
def member():
    """The edge plugin's first node in a two-node graph on the CPU: (its
    kernel, the graph)."""
    g = RenderGraph(block_size=64, prefer="auto", device="cpu")
    prog = compile_plugin_source(EDGE_SRC)
    g.add("e", prog)
    g.add("p", prog)
    g.init_all()
    assert g.node_engines == ["torch-lockstep"] * 2, g.spec_errors
    return g.kernels[0], g


def row(sender, bc, dest, cid, tag, a=0.0):
    return [float(sender), float(bc), float(dest), float(cid), float(tag),
            float(a), 1.0, 2.0, 3.0]


def stage_case(kern, g, case):
    """(Stage, samplesblock) of one edge case, on CPU tensors."""
    reg = g.world.msg_chan_ids
    a, b = reg["a"], reg["b"]
    zz = reg.setdefault("zz", len(reg))
    rows = []
    if case in ("queues", "remainder", "small_window"):
        rows += [row(2, 1, 0, a, 10 + i, 0.5 * i) for i in range(65)]
        rows += [row(1, 1, 0, a, 99), row(1, 1, 0, a, 98)]   # its own
        rows += [row(2, 0, 1, b, 7, 4.0), row(2, 0, 2, b, 8)]
        rows += [row(2, 1, 0, zz, 5)]
        cursors = [0.0, float(len(rows))]
    elif case == "compact_empty":
        rows += [row(2, 1, 0, a, i) for i in range(5)]
        cursors = [5.0, 5.0]
    else:
        raise AssertionError(case)
    W = len(rows) + (5 if case == "small_window" else 2 * 2 * MSG_OUT_CAP)
    window = torch.zeros((W, BS.WINDOW_ENT), dtype=torch.float64)
    window[:len(rows)] = torch.tensor(rows, dtype=torch.float64)
    ctl = torch.tensor([float(len(rows)), 0.0, 0.0] + cursors,
                       dtype=torch.float64)
    sub = torch.zeros(len(reg), dtype=torch.float64)
    sub[a] = 1.0
    seg = torch.from_numpy(np.linspace(-1.0, 1.0, SIZE))
    st = BS.Stage(seg, window, ctl, 0, True, sub,
                  float(g.hosts[0].instance_id_value))
    return st, (17.0 if case == "remainder" else 64.0)


def inputs(kern, seed=1):
    (svec, rings), bvars, bmem = kern.device_carry(kern.initial_carry())
    svec = svec.clone()[None]
    svec += torch.from_numpy(np.random.RandomState(seed).rand(
        svec.shape[1]))
    return (svec, [rings[r].clone()[None] for r in kern._block_prog.regions],
            bvars.clone()[None], bmem.clone()[None])


def copies(args, stage):
    svec, rings, bvars, bmem = args
    st = None
    if stage is not None:
        st = stage._replace(**{k: getattr(stage, k).clone() for k in
                               ("gseg", "window", "ctl", "sub")
                               if getattr(stage, k) is not None})
    return (svec.clone(), [r.clone() for r in rings], bvars.clone(),
            bmem.clone()), st


def outputs(args, st, ctrl):
    svec, rings, bvars, bmem = args
    out = [svec, *rings, bvars, bmem, ctrl]
    if st is not None:
        out += [t for t in (st.gseg, st.window, st.ctl) if t is not None]
    return out


def same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))


@needs_cxx
@pytest.mark.parametrize("case", ["queues", "compact_empty", "small_window",
                                  "remainder", "lone_window"])
def test_staging_host_form_equals_plain(member, case):
    kern, g = member
    prog = kern._block_prog
    assert prog.staged and prog.uses_msg and prog.uses_gmem
    if case == "lone_window":
        stage, sb = None, 64.0      # a render outside a graph: the window
    else:
        stage, sb = stage_case(kern, g, case)
    args = inputs(kern)
    plain_args, plain_st = copies(args, stage)
    ctrl, _ = BS.block_section_plain(prog, *plain_args, sb, stage=plain_st)
    want = outputs(plain_args, plain_st, ctrl)
    for threads, desc in ((0, False), (3, False), (128, True)):
        host_args, host_st = copies(args, stage)
        ctrl_h, _m, _runs = BS.block_section_host(
            prog, *host_args, sb, threads=threads, descending=desc,
            stage=host_st)
        got = outputs(host_args, host_st, ctrl_h)
        for k, (x, y) in enumerate(zip(got, want)):
            assert same_bits(x, y), (case, threads, k)
    dev = prog.block
    M = plain_args[3][0]
    if case in ("queues", "remainder"):
        ctl = plain_st.ctl
        # 32 of 34 sends published (33 broadcasts, then the direct one),
        # two in the drop cell; 65 broadcasts on "a" for a queue of 64: one
        # more there; the member's own broadcasts, the send to node 2 and
        # the unsubscribed channel pass it by
        assert float(ctl[0]) == 70 + MSG_OUT_CAP
        assert float(M[dev.msg_in_base]) == 3.0
        v = {k[1]: float(plain_args[2][0][s]) for k, s in dev.slots.items()
             if k[0] == "var"}
        assert v["n"] == MSG_QUEUE_CAP and v["lsrc"] == 2.0
        assert v["rb"] == 1.0 and float(M[22]) == 4.0     # the direct one
        assert v["d1"] == 1.0 and v["d2"] == 0.0
        assert v["gn"] == 0.0 and v["f1"] == 3.0 and v["z1"] == 2.0
        assert v["c1"] == 5.0 and v["t1"] == 4.0 and v["t2"] == 2.0
        assert float(plain_st.window[70, 0]) == 1.0        # the sender id
        assert float(plain_args[3][0][dev.gmem_base]) == 0.0  # the window
        assert float(plain_st.gseg[0]) == 6.0               # gmem[-1]
    if case == "compact_empty":
        # the five seen rows dropped, then this block's 32 sends
        assert plain_st.ctl.tolist() == [float(MSG_OUT_CAP), 0.0, 5.0, 0.0,
                                         0.0]
    if case == "small_window":
        assert float(plain_st.ctl[1]) == MSG_OUT_CAP - 5


REFUSED = [
    ("n = msg_recv_buf(\"a\", s, t, 0, 8);", "msg_recv_buf"),
    ("r = msg_peer_name(2, #nm);", "msg_peer_name"),
    ("r = msg_peer_uid(2, #nm);", "msg_peer_uid"),
    ("r = instance_uid(#nm);", "instance_uid"),
    ("r = instance_get_name(#nm);", "instance_get_name"),
    ("r = gmem_seq(0);", "gmem_seq"),
    ("r = gmem_page(5000);", "gmem_page"),
    ("msg_subscribe(\"b\");", "msg_subscribe"),
]


@pytest.mark.parametrize("line,fn", REFUSED, ids=[f for _l, f in REFUSED])
def test_refused_in_a_lockstep_member_as_in_the_reference(tmp_path,
                                                           monkeypatch,
                                                           line, fn):
    # the reference's device sections do not take these: the node renders
    # through the golden in both packages, and the port says why
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))
    src = ("@init\ngmem_attach(\"bus\");\nmsg_subscribe(\"a\");\n"
           "@block\ng = 1 / (1 + acc);\nacc = 0;\nmsg_send(\"a\", 1, g, 0, 0, 0);\n"
           f"{line}\n@sample\nacc += abs(spl0);\nspl0 *= g;\n")
    engines = []
    for G, comp, kw in ((RenderGraph, compile_plugin_source,
                         {"device": "cpu"}), (JaxGraph, jax_compile, {})):
        g = G(block_size=64, prefer="auto", **kw)
        g.add("a", comp(src))
        g.init_all()
        engines.append(g.node_engines)
        if G is RenderGraph:
            why = g.spec_errors["a"]
            assert fn in why and "through the golden" in why, why
    assert engines == [["cpu-shadow"], ["cpu-shadow"]]


def test_refusals_name_their_reason():
    # a lone instance: the same constructs raise DevgenError by name; K11
    # takes gmem and the lone instance's bus, as the reference's
    # sequential executor does
    for line, fn in REFUSED[:-1]:
        prog = compile_plugin_source(f"@block\nx = x + 1;\n{line}\n")
        snap = make_initialized_shadow(prog, 48000.0).state
        with pytest.raises(DevgenError, match=f"{fn}.*through the golden"):
            DeviceSection(prog, snap, "block",
                          section_dynamic_keys(prog, ("block",)), 1 << 12)
    for body in ("gmem[0] = x;", "msg_send(1, 2, 3, 4, 5, 6);"):
        prog = compile_plugin_source(
            f"@block\nx += 1;\n{body}\n@sample\nk = abs(spl0) * 3; i = 0;\n"
            f"while (i < k) ( i += 1; );\n")
        kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                                device="cpu")
        assert kern.engine == "devexec"
        assert ("gmem_set" in kern.program.source) == (body[0] == "g")
    # what the reference refuses stays refused on K11, in its words
    for line, fn in REFUSED[:-1]:
        bad = compile_plugin_source(
            f"@block\nx += 1;\n{line}\n@sample\nk = abs(spl0) * 3; "
            "i = 0;\nwhile (i < k) ( i += 1; );\n")
        with pytest.raises(SpecializeError, match=f"{fn}.*through the golden"):
            DeviceExecKernel(bad, make_initialized_shadow(bad).state, 1,
                             device="cpu")


def test_a_lone_instances_bus_folds_inert():
    # the golden's host of a lone instance sends nothing and receives
    # nothing: the section prints the calls inert, arguments evaluated
    src = ("@block\ng = 1 / (1 + acc);\nacc = 0;\n"
           "r = msg_send(\"a\", (c += 1), g, 0, 0, 0);\n"
           "h = msg_recv(\"a\", s, t, p, q, u, v);\n"
           "i = instance_id(); j = comm_join(\"x\"); m = msg_avail(\"a\");\n"
           "@sample\nacc += abs(spl0);\nspl0 *= g;\n")
    prog = compile_plugin_source(src)
    st = make_initialized_shadow(prog).state
    from zorak_tpu_torch.lowering import specialize_sample_kernel
    kern = specialize_sample_kernel(prog, st, 1, device="cpu")
    assert kern.coupled and not kern._block_prog.staged
    x = (np.random.RandomState(4).randn(1, 700) * 0.3).astype(np.float32)
    y, carry = kern.render(x)
    kern.writeback(carry, st)
    gold = make_initialized_shadow(prog)
    y_g = np.zeros_like(x)
    for b in range(0, x.shape[1], kern.B):
        gold.process_block(x[:, b:b + kern.B], y_g[:, b:b + kern.B])
    assert np.array_equal(y, y_g)
    for k in ("c", "r", "h", "i", "j", "m", "g"):
        assert st.V[k] == gold.state.V[k], k
    assert st.V["c"] == 2.0


def test_jax_carry_of_a_gmem_member_resumes(tmp_path, monkeypatch):
    # the heap is the reference's: [plugin heap | gmem window | ...], so a
    # JAX member's carry converts directly and renders on as the JAX
    # kernel does (each solo: its gmem the heap's window)
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))
    import test_graph_device as ref_device

    src = ref_device.TestCoupledNodesInGraph.LOCKSTEP_SRC
    kerns = []
    for G, comp, kw in ((RenderGraph, compile_plugin_source,
                         {"device": "cpu"}), (JaxGraph, jax_compile, {})):
        g = G(block_size=64, prefer="auto", **kw)
        g.add("a", comp(src), sliders={0: 0.0})
        g.add("b", comp(src), sliders={0: 1.0})
        g.init_all()
        kerns.append(g.kernels[0])
    pk, jk = kerns
    rng = np.random.RandomState(8)
    x1 = (rng.randn(2, 64 * 5) * 0.3).astype(np.float32)
    x2 = (rng.randn(2, 64 * 4 + 9) * 0.3).astype(np.float32)
    _y, jc = jk.render(x1)
    jc = ((np.asarray(jc[0][0]), {r: np.asarray(a)
                                  for r, a in jc[0][1].items()}),
          np.asarray(jc[1]), np.asarray(jc[2]))
    dev = pk._devblock
    assert jc[2][dev.gmem_base] != 0.0          # the member wrote gmem[0]
    pc = convert.carry_from_numpy(pk, jc)
    yj, cj = jk.render(x2, carry=jc)
    yp, cp = pk.render(x2, carry=pc)
    assert np.abs(np.asarray(yj) - yp).max() <= 1e-6
    tail = slice(dev.gmem_base, dev.gmem_base + dev.gmem_cells)
    assert np.allclose(cp[2].numpy()[tail], np.asarray(cj[2])[tail],
                       rtol=1e-12, atol=0.0)
    assert np.allclose(cp[1].numpy(), np.asarray(cj[1]), rtol=1e-12,
                       atol=1e-300)
