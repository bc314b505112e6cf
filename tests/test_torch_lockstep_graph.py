"""K5 on a render graph's lockstep without a GPU: the graph block the CUDA
graph replays, run on CPU tensors.

On the card `lowering.specialize.lockstep_gmem_run` renders a lockstep a
graph block at a time (every member's K10 with its staging, then its
segment, in node order), captured as one CUDA graph the second time its
key is seen and replayed (`_lockstep_graph_blocks`, the lockstep's
`StepGraphs`, kept on the `RenderGraph`).  The CPU has no graphs, so these
tests run the same graph block uncaptured on its static buffers
(`RenderGraph._run_as("graph", ...)`, `lockstep_dispatch` "static") and
hold it:

- to the eager lockstep (`_run_as("eager", ...)`) bit for bit on every
  lockstep case of tests/test_torch_graph.py, on a pair whose members'
  channel counts differ and on pairs that draw rand() (rows and the gated
  pool): audio, carries (svec, rings, K10's vars and heap), the shared
  segments, the ring window and its control row, every NaN one value;
- three ways, as tests/test_torch_graph.py holds the graph (`held`):
  against the all-shadow graph and the JAX package's `RenderGraph`;
- and the static buffers across renders, the refusal of a lockstep with a
  MIDI member, and the joint capture keys of members whose cursors
  cycle with different periods.
"""
import numpy as np
import pytest
import torch

import test_torch_graph as TG
from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.lowering import SpecializeError
from zorak_tpu_torch.lowering import specialize as SP
from zorak_tpu_torch.runtime.graph import RenderGraph

BLOCK = 64

SOLO_SRC = """\
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

# a member whose coupled @block reads MIDI: K5 refuses its plan
MIDI_LOCKSTEP_SRC = TG.LOCKSTEP_SRC.replace(
    "@block\n", "@block\nwhile (midirecv(ofs, m1, m2, m3)) ( nmidi += 1; );\n")


# the gmem pair's member on one channel: a lockstep whose members' channel
# counts differ copies each member's audio on its own
MONO_LOCKSTEP_SRC = TG.LOCKSTEP_SRC.replace("spl1 = spl1 * g;\n", "")


# the gmem pair's member drawing rand() every sample (its draw rows go in
# with each graph block), or only above a level (the gated regime's pool)
DRAWING_SRC = TG.LOCKSTEP_SRC.replace(
    "spl0 = spl0 * g;", "spl0 = spl0 * g + rand(1) * 1e-3;")
GATED_DRAWING_SRC = TG.LOCKSTEP_SRC.replace(
    "spl0 = spl0 * g;", "spl0 > 0.2 ? r = rand(1);\nspl0 = spl0 * g + r * 1e-3;")


def counter_src(period: int) -> str:
    """The gmem pair's member with a modular counter of `period` samples
    in its output: its cursor shapes the segment, so its block keys cycle
    with period / gcd(period, BLOCK) blocks."""
    return TG.LOCKSTEP_SRC.replace(
        "spl0 = spl0 * g;",
        f"p += 1; p >= {period} ? p = 0;\nspl0 = spl0 * g + p * 1e-6;")


# the msg pair's member sending a second message in a loud block: each
# member reads one a block, so the ring's backlog as a render starts
# follows the audio
BACKLOG_SRC = TG.MSG_SRC.replace(
    "rx = msg_recv(",
    'avg > 0.3 ? msg_send("meter", 8, avg, instance_id(), 0, 0);\n'
    "rx = msg_recv(")


def crossmix_nodes():
    return [(f"n{i}", builtin_plugins.crossmix_declutter(i, 4), None)
            for i in range(4)]


def crossmix_input(n=BLOCK * 6 + 17):
    rng = np.random.RandomState(23)
    return [{f"n{i}": (rng.randn(2, n) * 0.3).astype(np.float32)
             for i in range(4)}]


# name -> (nodes, the inputs of each render): every lockstep case of
# tests/test_torch_graph.py, a pair whose channel counts differ and pairs
# that draw rand()
CASES = {
    "msg_pair": ([("a", TG.MSG_SRC, None), ("b", TG.MSG_SRC, None)],
                 TG.noise("ab", BLOCK * 6 + 17, 11, 0.4)),
    "msg_pair_resumed": ([("a", TG.MSG_SRC, None), ("b", TG.MSG_SRC, None)],
                         TG.noise("ab", BLOCK * 3, 11, 0.4, renders=2)),
    "solo_msg_member": ([("solo", SOLO_SRC, None)],
                        TG.noise(["solo"], BLOCK * 5, 7, 0.3)),
    "gmem_pair": ([("a", TG.LOCKSTEP_SRC, {0: 0.0}),
                   ("b", TG.LOCKSTEP_SRC, {0: 1.0})],
                  TG.noise("ab", BLOCK * 6 + 17, 3, 0.4)),
    "gmem_pair_mono_and_stereo": ([("a", TG.LOCKSTEP_SRC, {0: 0.0}),
                                   ("b", MONO_LOCKSTEP_SRC, {0: 1.0})],
                                  TG.noise("ab", BLOCK * 5 + 3, 4, 0.4)),
    "gmem_pair_drawing": ([("a", DRAWING_SRC, {0: 0.0}),
                           ("b", DRAWING_SRC, {0: 1.0})],
                          TG.noise("ab", BLOCK * 5 + 9, 3, 0.4)),
    "gmem_pair_gated_draws": ([("a", GATED_DRAWING_SRC, {0: 0.0}),
                               ("b", TG.LOCKSTEP_SRC, {0: 1.0})],
                              TG.noise("ab", BLOCK * 5 + 9, 3, 0.4)),
    "coupled_node_touching_bus": (
        [("node", TG.COUPLED_SRC.replace(
            "acc = 0;", "acc = 0;\nmsg_send(1, 1, g, 0, 0, 0);"), None)],
        TG.noise(["node"], BLOCK * 4, 5, 0.3)),
    "crossmix_declutter_x4": (crossmix_nodes(), crossmix_input()),
}


@pytest.fixture(autouse=True)
def _trace_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path / "traces"))


def port_graph(nodes, block=BLOCK):
    g = RenderGraph(block_size=block, prefer="auto", device="cpu")
    progs = {}
    for name, src, sliders in nodes:
        if src not in progs:
            progs[src] = compile_plugin_source(src)
        g.add(name, progs[src], sliders=sliders)
    g.init_all()
    return g


def same_values(a, b) -> bool:
    """Equal as bit patterns (integer views), every NaN one value."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    iv = torch.int64 if a.dtype == torch.float64 else torch.int32
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros_like(a)
    return bool(torch.equal(nan_a, nan_b) and torch.equal(
        torch.where(nan_a, zero, a).view(iv),
        torch.where(nan_b, zero, b).view(iv)))


def lockstep_tensors(res):
    """`lockstep_gmem_run`'s results as (name, tensor) pairs: each
    member's audio and carry (svec, rings by region, K10's vars and heap),
    the segments, the ring window and its control row."""
    ys, fin, gfin, _mos, msg_fin, _dispatch = res
    out = [(f"audio {j}", y) for j, y in enumerate(ys)]
    for j, ((svec, rings), bvars, bmem) in enumerate(fin):
        out += [(f"svec {j}", svec), (f"vars {j}", bvars),
                (f"heap {j}", bmem)]
        out += [(f"ring {j} {r}", rings[r]) for r in sorted(rings)]
    out += [(f"segment {s}", g) for s, g in enumerate(gfin)]
    if msg_fin is not None:
        out += [("window", msg_fin[0]), ("ctl", msg_fin[1])]
    return out


@pytest.fixture
def recorded(monkeypatch):
    """Every `lockstep_gmem_run` call's results, in order."""
    got = []
    real = SP.lockstep_gmem_run

    def spy(*args, **kwargs):
        got.append(real(*args, **kwargs))
        return got[-1]
    monkeypatch.setattr(SP, "lockstep_gmem_run", spy)
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_static_graph_block_equals_eager(name, recorded):
    nodes, inputs = CASES[name]
    ge, gs = port_graph(nodes), port_graph(nodes)
    assert set(ge.node_engines) == {"torch-lockstep"}, ge.spec_errors
    for x in inputs:
        out_e = ge._run_as("eager", x)
        assert ge.lockstep_dispatch == "eager: the eager step, asked for"
        out_s = gs._run_as("graph", x)
        assert gs.lockstep_dispatch.startswith("static")
        res_e, res_s = recorded[-2:]
        te, ts = lockstep_tensors(res_e), lockstep_tensors(res_s)
        assert [n for n, _t in te] == [n for n, _t in ts]
        for (what, a), (_w, b) in zip(te, ts):
            assert same_values(a, b), (name, what)
        for node in out_e:
            assert np.array_equal(out_e[node], out_s[node]), (name, node)
    ring = [[(m.seq, m.sender, m.dest, m.channel, m.tag, m.scalars)
             for m in g.hosts[0].domain.ring] for g in (ge, gs)]
    assert ring[0] == ring[1]
    assert [h.cursor for h in ge.hosts] == [h.cursor for h in gs.hosts]
    # a graph block a block of each render, all in the lockstep's one
    # StepGraphs
    blocks = sum(-(-x[nodes[0][0]].shape[1] // BLOCK) for x in inputs)
    assert gs.lockstep_k5.stats()["steps"] == blocks
    assert list(gs._lockstep_graphs.values()) == [gs.lockstep_k5]


@pytest.mark.parametrize("name", ["crossmix_declutter_x4", "msg_pair"])
def test_static_graph_block_held_three_ways(name):
    nodes, inputs = CASES[name]
    gp = port_graph(nodes)
    outs = None
    for x in inputs:
        outs = gp._run_as("graph", x)
        assert gp.lockstep_dispatch.startswith("static")
    res = {"port": (gp, outs),
           "shadow": TG.build("shadow", nodes, inputs),
           "jax": TG.build("jax", nodes, inputs)}
    if name == "crossmix_declutter_x4":
        # tests/test_torch_graph.py's tolerances for the stand-in
        TG.held(res, var_tol=1e-12, audio_tol=1e-7)
        assert gp.node_engines == ["torch-lockstep"] * 4
    else:
        TG.held(res)
        assert gp.plugins[1].state.V["nrecv"] == 7.0


def test_static_buffers_kept_across_renders_and_dropped_on_rebuild():
    nodes, inputs = CASES["gmem_pair"]
    g = port_graph(nodes)
    x = inputs[0]
    g._run_as("graph", x)
    k5 = g.lockstep_k5
    ptrs = {name: b.data_ptr() for name, b in k5.buffers.items()}
    assert ("gseg", 0) in ptrs and (0, "bmem") in ptrs and (1, "svec") in ptrs
    for _ in range(2):
        g._run_as("graph", x)
        assert g.lockstep_k5 is k5
        assert {name: b.data_ptr() for name, b in k5.buffers.items()} == ptrs
    blocks = -(-x["a"].shape[1] // BLOCK)
    assert k5.stats()["steps"] == 3 * blocks
    assert k5.regrowths == 0
    assert list(g._lockstep_graphs.values()) == [k5]
    # kernels rebuilt: the lockstep's StepGraphs go with the old kernels
    g._build_kernels()
    assert g._lockstep_graphs == {} and g.lockstep_k5 is None
    g._run_as("graph", x)
    assert g.lockstep_k5 is not k5 and g.lockstep_k5.stats()["steps"] == blocks


def test_one_step_graphs_whatever_backlog_a_render_starts_with(recorded):
    # the ring's backlog as a render starts sets the window's rows W, three
    # values of it here: the lockstep keeps one StepGraphs, W in its graph
    # blocks' keys, the window one storage sized once
    nodes = [("a", BACKLOG_SRC, None), ("b", BACKLOG_SRC, None)]
    renders = [TG.noise("ab", BLOCK * n + 5, 11 + n, 0.4)[0]
               for n in (2, 3, 1, 4)]
    g, ge = port_graph(nodes), port_graph(nodes)
    sizes, ws = [], []
    for x in renders:
        outs = g._run_as("graph", x)
        ws.append(recorded[-1][4][0].shape[0])
        out_e = ge._run_as("eager", x)
        assert recorded[-1][4][0].shape[0] == ws[-1]
        for node in outs:
            assert np.array_equal(outs[node], out_e[node]), node
        assert len(g._lockstep_graphs) == 1
        sizes.append(g.lockstep_k5.buffer_bytes())
    assert len(set(ws)) >= 3, ws
    k5 = g.lockstep_k5
    assert list(g._lockstep_graphs.values()) == [k5]
    assert len(set(sizes)) == 1 and k5.regrowths == 0
    assert {key[2] for key in k5.keys_seen} == set(ws)


def test_lockstep_with_a_midi_member_is_eager_and_says_why():
    nodes = [("a", TG.LOCKSTEP_SRC, {0: 0.0}), ("b", MIDI_LOCKSTEP_SRC,
                                                {0: 1.0})]
    x = TG.noise("ab", BLOCK * 4 + 9, 3, 0.4)[0]
    g = port_graph(nodes)
    assert g.node_engines == ["torch-lockstep", "torch-lockstep"]
    assert g.kernels[1].k5_refusal.startswith("MIDI in the coupled @block")
    with pytest.raises(SpecializeError, match="node b: MIDI"):
        g._run_as("graph", x)
    # refused before anything rendered: the default run is the first
    outs = g.run(x)
    assert g.lockstep_dispatch == "eager: node b: " + g.kernels[1].k5_refusal
    gs = TG.build("shadow", nodes, [x])[1]
    for node in outs:
        assert np.array_equal(outs[node], gs[node]), node


def test_joint_keys_follow_the_least_common_multiple_of_the_periods():
    # counters of 40 and 48 samples at blocks of 64: the members' block
    # keys cycle every 5 and 3 blocks, the graph block's every 15
    nodes = [("a", counter_src(40), {0: 0.0}), ("b", counter_src(48),
                                                {0: 1.0})]
    x = TG.noise("ab", BLOCK * 20, 9, 0.4)[0]
    g, ge = port_graph(nodes), port_graph(nodes)
    outs = g._run_as("graph", x)
    keys = list(g.lockstep_k5.keys_seen)
    assert len({key[4] for key in keys}) == 5
    assert len({key[5] for key in keys}) == 3
    assert len(keys) == 15
    # no bus: no window rows W and no channels nc in the key
    assert all(key[:4] == ("lockstep", BLOCK, None, None) for key in keys)
    out_e = ge._run_as("eager", x)
    for node in outs:
        assert np.array_equal(outs[node], out_e[node]), node


def test_step_values_as_the_kernels_take_them():
    nodes, inputs = CASES["gmem_pair"]
    g = port_graph(nodes)
    with pytest.raises(ValueError, match="step must be"):
        g._run_as("replay", inputs[0])
    g.run(inputs[0])
    assert g.lockstep_dispatch == "eager: CPU tensors take the eager step"
