"""K5 without a GPU: the step the CUDA graph replays, run on CPU tensors.

`kernels/segment_graph.py` captures one step of a render (a segment, or a
coupled block: K10 then the block's segment) and replays it.  The CPU has
no graphs, so these tests run the same step uncaptured on its static
buffers (`_render_device_as("graph", ...)`, dispatch "static") and hold it
three ways on seeded numpy input:

- to today's eager step (`_render_device_as("eager", ...)`) bit for bit,
  audio, svec and rings (and K10's vars and heap), every NaN one value;
- to the JAX package's render within the tolerances the existing tests
  use: the f32 audio within 1e-9 or one f32 ulp of the sample, carries
  within 1e-8 (the coupled regime: audio 1e-5 and the written-back state
  1e-8, as tests/test_torch_coupled.py holds it);
- and the host mirror, the capture keys and the plans K5 refuses at build.

The hop regime's steps (a hop's segment, then K10) are held the same way
across a render resumed mid-hop, with their keys by the counter's phase.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import SCAN_GROUP_SRC
from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.parallel import BatchRenderer as JaxBatchRenderer
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import segment_graph as K5
from zorak_tpu_torch.lowering import SpecializeError, specialize_sample_kernel
from zorak_tpu_torch.lowering.specialize import _f64_bits
from zorak_tpu_torch.parallel import BatchRenderer
from zorak_tpu_torch.runtime.engine import PluginInstance
from zorak_tpu_torch.verify import make_initialized_shadow

REPO = Path(__file__).resolve().parents[1]
JAX_EPS = 1e-9       # the port's f32 audio against the JAX render's
CARRY_EPS = 1e-8     # carried scalars and rings against JAX's
COUPLED_AUDIO_TOL = 1e-5


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def noise(nch, n, scale=0.3, seed=3):
    return (np.random.RandomState(seed).randn(nch, n) * scale).astype(
        np.float32)


# name -> (source, channels, kernel options, samples): a remainder segment
# in each
CASES = {
    "wide_delay_network": (builtin_plugins.wide_delay_network(
        24, buf=1024, max_delay=900), 2, {"segment_len": 2048}, 9000),
    "cross_fed_delay_network": (builtin_plugins.cross_fed_delay_network(
        16, buf=1024, max_delay=900), 2, {"segment_len": 1024}, 5000),
    "scan_group_follower": (SCAN_GROUP_SRC, 2, {"segment_len": 1024}, 5000),
    # the stand-in at a small size, the segment cut to 1,024
    "gated_fdn_tank": (builtin_plugins.gated_fdn_tank(4), 2,
                       {"segment_len": 1 << 17, "block_size": 512}, 6000),
    "modulated_delay_chorus": (builtin_plugins.modulated_delay_chorus(
        2, 512), 2, {"segment_len": 1024}, 4000),
    "tpdf_dither": (builtin_plugins.tpdf_dither(16), 2,
                    {"segment_len": 1024}, 4000),
}

# an induction counter that only enters arithmetic (n), a modular counter
# (p) and a ring cursor (w)
MIRROR_SRC = """@init
MASK = 1023;
@sample
buf[w & MASK] = spl0;
n += 1;
p += 1; p >= 100 ? p = 0;
spl0 = 0.5*spl0 + buf[(w - 300) & MASK] + n*1e-9 + p*1e-6;
w += 1;
"""

# @block rewrites the ring cursor w, so the host cannot follow it
REWRITES_CURSOR_SRC = """@block
acc > 100 ? (w = 0; acc = 0;);
@sample
acc += abs(spl0);
buf[w & 255] = spl0;
spl0 = spl0*0.5 + buf[(w - 64) & 255]*0.5;
w += 1;
"""


def port_kernel(src, nch, **opts):
    prog = compile_plugin_source(src)
    return prog, specialize_sample_kernel(
        prog, make_initialized_shadow(prog).state, nch, device="cpu", **opts)


def jax_kernel(src, nch, **opts):
    jprog = jax_compile(src)
    jstate = jax_shadow(jprog).state
    return jax_specialize(jprog, jstate, nch, **opts), jstate


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


def carry_tensors(kern, carry):
    """A carry's tensors in a fixed order: svec, the rings by region,
    then K10's vars and heap where the kernel has them."""
    if kern.has_device_view:
        (svec, rings), bvars, bmem = carry
        return [svec] + [rings[r] for r in sorted(rings)] + [bvars, bmem]
    svec, rings = carry
    return [svec] + [rings[r] for r in sorted(rings)]


def held_to_eager(kern, x, carry=None):
    """The static step's render of x against the eager step's, bit for bit
    (audio and carry); returns the static render."""
    ye, ce = kern._render_device_as("eager", x, carry)
    assert kern.dispatch == "eager: the eager step, asked for"
    ys, cs = kern._render_device_as("graph", x, carry)
    assert kern.dispatch.startswith("static")
    assert same_values(ye, ys), "audio"
    te, ts = carry_tensors(kern, ce), carry_tensors(kern, cs)
    assert len(te) == len(ts)
    for i, (a, b) in enumerate(zip(te, ts)):
        assert same_values(a, b), f"carry tensor {i}"
    return ys, cs


def audio_excess(y, yj):
    """How far the port's f32 audio lies outside JAX_EPS or one f32 ulp of
    the JAX render's sample (<= 0 means inside)."""
    y = np.asarray(y, np.float32)
    yj = np.asarray(yj, np.float32)
    d = np.abs(y.astype(np.float64) - yj.astype(np.float64))
    return float(np.max(d - np.maximum(JAX_EPS, np.spacing(np.abs(yj))),
                        initial=-1.0))


def carry_delta(carry, jcarry):
    svec, rings = carry
    jsvec, jrings = jcarry
    worst = float(np.max(np.abs(svec.numpy() - np.asarray(jsvec)),
                         initial=0.0))
    assert sorted(rings) == sorted(jrings)
    for region, arr in rings.items():
        worst = max(worst, float(np.max(np.abs(
            arr.numpy() - np.asarray(jrings[region])), initial=0.0)))
    return worst


@pytest.mark.parametrize("name", sorted(CASES))
def test_static_step_equals_eager_and_jax(name):
    src, nch, opts, n = CASES[name]
    _prog, kern = port_kernel(src, nch, **opts)
    assert kern.k5_refusal is None
    x = noise(nch, n, seed=11)
    y, carry = held_to_eager(kern, x)
    # a second render replays the same keys: the same render again
    y2, _c = kern._render_device_as("graph", x)
    assert same_values(y, y2)
    jkern, _js = jax_kernel(src, nch, **opts)
    assert kern.carried_vars == jkern.carried_vars
    yj, jcarry = jkern.render(x)
    assert audio_excess(y.numpy(), yj) <= 0.0, "static step vs JAX render"
    assert carry_delta(carry, jcarry) <= CARRY_EPS


def test_resumed_static_render_equals_eager():
    src, nch, opts, _n = CASES["wide_delay_network"]
    _prog, kern = port_kernel(src, nch, **opts)
    x = noise(nch, 7000, seed=12)
    _y, carry = kern._render_device_as("eager", x[:, :2600])
    held_to_eager(kern, x[:, 2600:], carry)


def test_coupled_leveler_static_step_equals_eager_and_jax():
    src = builtin_plugins.spectral_tilt_leveler(256)
    prog, kern = port_kernel(src, 2, segment_len=4096)
    assert kern.coupled and kern.k5_refusal is None
    x = noise(2, 3 * 512 + 100, scale=0.3, seed=5)
    y, carry = held_to_eager(kern, x)
    state = make_initialized_shadow(prog).state
    kern.writeback(carry, state)
    jkern, jstate = jax_kernel(src, 2, segment_len=4096)
    yj, jcarry = jkern.render(x)
    jkern.writeback(jcarry, jstate)
    assert float(np.max(np.abs(y.numpy().astype(np.float64)
                               - np.asarray(yj, np.float64)))) \
        <= COUPLED_AUDIO_TOL
    names = set(state.V) | set(jstate.V)
    worst = max(abs(state.V.get(k, 0.0) - jstate.V.get(k, 0.0))
                for k in names)
    n_mem = kern._devblock.mem_size
    m, jm = np.zeros(n_mem), np.zeros(n_mem)
    m[:min(n_mem, len(state.mem))] = state.mem[:n_mem]
    jm[:min(n_mem, len(jstate.mem))] = jstate.mem[:n_mem]
    worst = max(worst, float(np.max(np.abs(m - jm))))
    assert worst <= CARRY_EPS


@pytest.mark.parametrize("name", ["wide_delay_network", "gated_fdn_tank"])
def test_three_file_batch_static_equals_eager_and_jax(name):
    src, nch, opts, n = CASES[name]
    prog = compile_plugin_source(src)
    br = BatchRenderer(prog, device="cpu", **opts)
    xs = np.stack([noise(nch, n, seed=30 + f) for f in range(3)])
    ye = br._render_as("eager", xs)
    ys = br._render_as("graph", xs)
    assert br.kernel.dispatch.startswith("static")
    assert same_values(ye, ys)
    yj = JaxBatchRenderer(jax_compile(src), **opts).render_files(xs)
    assert audio_excess(ys.numpy(), yj) <= 0.0


def test_coupled_batch_static_equals_eager():
    prog = compile_plugin_source(builtin_plugins.spectral_tilt_leveler(256))
    br = BatchRenderer(prog, segment_len=4096, device="cpu")
    xs = np.stack([noise(2, 1300, seed=40 + f) for f in range(3)])
    assert same_values(br._render_as("eager", xs), br._render_as("graph", xs))


def test_value_slots_equal_the_host_mirror_at_the_end():
    _prog, kern = port_kernel(MIRROR_SRC, 1, segment_len=512)
    n_slot, p_slot, w_slot = (kern.scalar_index[("var", v)]
                              for v in ("n", "p", "w"))
    # w and p shape the segment; n only enters arithmetic
    assert kern.cursor_slots() == {p_slot, w_slot}
    assert set(kern.mirrored_slots()) == {n_slot, p_slot, w_slot}
    _y, (svec, _rings) = held_to_eager(kern, noise(1, 5 * 512 + 77, seed=4))
    mirror = kern._k5_mirror
    for i in kern.mirrored_slots():
        assert mirror[i] is not None
        assert _f64_bits(float(svec[i])) == _f64_bits(mirror[i])
    assert mirror[n_slot] == 5 * 512 + 77
    assert mirror[p_slot] == (5 * 512 + 77) % 100


def test_shaping_key_one_for_a_ring_that_divides_the_segment():
    # a ring of 1,024 and segments of 2,048: every full segment starts the
    # cursor at the same place
    src, nch, opts, _n = CASES["wide_delay_network"]
    _prog, kern = port_kernel(src, nch, **opts)
    kern._render_device_as("graph", noise(nch, 5 * 2048, seed=6))
    keys = kern._k5.keys_seen
    assert len(keys) == 1
    (kind, L, nf, pool, cursors), = keys
    assert (kind, L, nf, pool) == ("seg", 2048, 1, None)
    assert {mod for _i, mod, _c in cursors} == {1024}
    assert {c for _i, _mod, c in cursors} == {0}


def test_shaping_key_follows_a_cursor_that_does_not_divide():
    # the modular counter p wraps at 100 and advances 512 a segment: the
    # keys are its starts mod 100, one a segment until they repeat
    _prog, kern = port_kernel(MIRROR_SRC, 1, segment_len=512)
    kern._render_device_as("graph", noise(1, 6 * 512, seed=7))
    p_slot = kern.scalar_index[("var", "p")]
    starts = sorted(c for key in kern._k5.keys_seen
                    for i, mod, c in key[4] if (i, mod) == (p_slot, 100))
    assert starts == sorted((s * 512) % 100 for s in range(6))
    assert len(kern._k5.keys_seen) == 6


def test_block_rewriting_a_ring_cursor_is_eager_at_build():
    _prog, kern = port_kernel(REWRITES_CURSOR_SRC, 1, segment_len=512)
    assert kern.coupled
    assert kern.k5_refusal == ("@block rewrites the ring cursor ('var', "
                               "'w'), which shapes the segment")
    x = noise(1, 3000, seed=8, scale=0.5)
    with pytest.raises(SpecializeError, match="'w'"):
        kern._render_device_as("graph", x)
    # the default render runs eager and says why
    kern.render_device(x)
    assert kern.dispatch == "eager: " + kern.k5_refusal


@pytest.mark.parametrize("src", [
    "@sample\nph = spl0 * 7;\nwhile (ph > 1) ( ph -= 2; );\n"
    "spl0 = ph * 0.5;\n",
    # a scan group walks the loop, and the output emits it again
    "@sample\nph += 0.37 + spl0;\nwhile (ph > 1) ( ph -= 2; );\n"
    "spl0 = ph * 0.5;\n"])
def test_normloop_is_eager_at_build(src):
    _prog, kern = port_kernel(src, 1, segment_len=512)
    assert kern.k5_refusal == ("a range-normalization loop (normloop) "
                               "reads the device each pass")
    with pytest.raises(SpecializeError, match="normloop"):
        kern._render_device_as("graph", noise(1, 1500, seed=9))


def test_hop_regime_is_eager_and_says_so():
    # the hop plan has no refusal: a hop's step (its segment, then K10)
    # goes through K5 on the card; on CPU tensors the default render is
    # the eager step, and says so
    _prog, kern = port_kernel(builtin_plugins.hop_convolver(128, 4), 2,
                              segment_len=512, block_size=32)
    assert kern._hop is not None and kern.k5_refusal is None
    kern.render_device(noise(2, 1100, seed=10))
    assert kern.dispatch == "eager: CPU tensors take the eager step"


def hop_kernel():
    return port_kernel(builtin_plugins.hop_convolver(128, 4), 2,
                       segment_len=512, block_size=32)


def test_hop_static_step_equals_the_eager_loop_across_a_resumed_render():
    """The hop render's K5 steps, uncaptured on their static buffers, bit
    for bit to the eager loop (audio, svec, rings, K10's vars and heap):
    a fresh render that ends mid-hop, then a render resumed from its
    carry, whose lead finishes the hop and fires."""
    _prog, kern = hop_kernel()
    x = noise(2, 1100 + 700, seed=14)
    _y, carry = held_to_eager(kern, x[:, :1100])
    phase = kern._hop_phase
    assert phase == 1100 % 128
    spans = kern._hop_spans(700, phase)
    assert spans[0] == (128 - phase, True) and spans[-1][1] is False
    # a resumed render starts from the counter's phase the last one left
    ye, ce = kern._render_device_as("eager", x[:, 1100:], carry)
    assert kern._hop_phase == (1100 + 700) % 128
    kern._hop_phase = phase
    y, cs = kern._render_device_as("graph", x[:, 1100:], carry)
    assert kern.dispatch.startswith("static")
    assert kern._hop_phase == (1100 + 700) % 128
    assert same_values(ye, y)
    for a, b in zip(carry_tensors(kern, ce), carry_tensors(kern, cs)):
        assert same_values(a, b)
    assert float(y.abs().max()) > 0.0
    jkern, _js = jax_kernel(builtin_plugins.hop_convolver(128, 4), 2,
                            segment_len=512, block_size=32)
    yj, _jc = jkern.render(x[:, :1100])
    ys, _c = kern._render_device_as("graph", x[:, :1100])
    assert float(np.max(np.abs(ys.numpy().astype(np.float64)
                               - np.asarray(yj, np.float64)))) \
        <= COUPLED_AUDIO_TOL


def test_hop_keys_change_with_the_hop_phase():
    # every full hop of a fresh render starts at phase 0 and shares one
    # key; the lead of a render resumed mid-hop and the tail take keys of
    # their own, each with the counter's phase at its start
    _prog, kern = hop_kernel()
    x = noise(2, 5 * 128 + 40, seed=15)
    _y, carry = kern._render_device_as("graph", x)
    keys = list(kern._k5.keys_seen)
    hops = [k for k in keys if k[0] == "hop"]
    assert len(hops) == 1 and hops[0][1] == 128 and hops[0][-1] == 0
    tails = [k for k in keys if k[0] == "seg"]
    assert len(tails) == 1 and tails[0][1] == 40 and tails[0][-1] == 0
    assert kern._k5.steps == 6
    kern._render_device_as("graph", x[:, :300], carry)
    new = [k for k in kern._k5.keys_seen if k not in keys]
    # the lead from phase 40 (88 samples, fires), a hop, the tail from 0
    assert sorted((k[0], k[1], k[-1]) for k in new) == [
        ("hop", 88, 40), ("seg", 84, 0)]
    assert kern.dispatch.startswith("static")


def test_hop_batch_static_equals_eager():
    prog = compile_plugin_source(builtin_plugins.hop_convolver(128, 4))
    br = BatchRenderer(prog, segment_len=512, block_size=32, device="cpu")
    xs = np.stack([noise(2, 700, seed=50 + f) for f in range(3)])
    assert same_values(br._render_as("eager", xs), br._render_as("graph", xs))
    assert br.kernel.dispatch.startswith("static")


def test_engine_details_report_the_dispatch():
    src, nch, opts, _n = CASES["tpdf_dither"]
    inst = PluginInstance(compile_plugin_source(src), device="cpu")
    res = inst.render(noise(nch, 3000, seed=13))
    assert res.details["dispatch"] == "eager: CPU tensors take the eager step"
    assert inst.kernel.dispatch == res.details["dispatch"]


def test_step_graphs_buffers_and_uncaptured_steps():
    k5 = K5.StepGraphs("cpu")
    a = k5.static("svec", (2, 3), torch.float64)
    assert torch.equal(a, torch.zeros(2, 3, dtype=torch.float64))
    # a smaller shape is a prefix of the same storage
    b = k5.static("svec", (2, 2), torch.float64)
    assert b.data_ptr() == a.data_ptr() and b.is_contiguous()
    assert k5.static("svec", (2, 3), torch.float64).data_ptr() == a.data_ptr()
    with pytest.raises(ValueError, match="static buffer"):
        k5.static("svec", (2, 3), torch.float32)
    ran = []
    k5.step(lambda: ("seg", len(ran)), lambda: ran.append(1), False)
    k5.step(lambda: ("seg", 9), lambda: ran.append(1), False)
    assert ran == [1, 1] and set(k5.keys_seen) == {("seg", 1), ("seg", 9)}
    assert k5.stats()["captures"] == 0 and k5.pool_bytes() is None
    assert K5.LAUNCHES == 0


class _FakeGraph:
    def __init__(self, log):
        self.log = log

    def replay(self):
        self.log.append("replay")


def _policy_graphs(monkeypatch, max_graphs):
    """StepGraphs on the CPU with `capture` honoured: the capture made by a
    stand-in that runs the step and keeps a graph that logs its replays."""
    monkeypatch.setattr(K5, "MAX_GRAPHS", max_graphs)
    monkeypatch.setattr(K5, "KEEP_SEEN", 4 * max_graphs)
    k5 = K5.StepGraphs("cpu")
    log = []

    def capture(key_fn, body):
        body()
        log.append("capture")
        return key_fn(), _FakeGraph(log), (0, 0, 0, 0)

    monkeypatch.setattr(k5, "_capture", capture)
    return k5, log


def test_a_key_is_captured_the_second_time_it_is_seen(monkeypatch):
    k5, log = _policy_graphs(monkeypatch, 8)
    before = K5.LAUNCHES
    for key in ["a", "b", "a", "a", "c", "b", "a"]:
        k5.step(lambda key=key: key, lambda key=key: log.append(key), True)
    assert log == ["a", "b", "a", "capture", "replay", "c", "b", "capture",
                   "replay"]
    assert K5.LAUNCHES - before == 2
    K5.LAUNCHES = before
    st = k5.stats()
    assert (st["captures"], st["replays"], st["uncaptured"], st["steps"]) \
        == (2, 2, 3, 7)


def test_more_recurring_keys_than_captures_do_not_thrash(monkeypatch):
    # a cycle of 5 keys and room for 2 captures: the first two captured
    # stay and replay, the other three run uncaptured, none captured twice
    k5, log = _policy_graphs(monkeypatch, 2)
    before = K5.LAUNCHES
    for _cycle in range(6):
        for key in range(5):
            k5.step(lambda key=key: key, lambda: log.append("run"), True)
    K5.LAUNCHES = before
    assert log.count("capture") == 2 and sorted(k5.graphs) == [0, 1]
    assert log.count("replay") == 2 * 4
    # a capture left unreplayed for KEEP_SEEN steps gives way to a new key
    for _ in range(K5.KEEP_SEEN):
        for key in (7, 8):
            k5.step(lambda key=key: key, lambda: log.append("run"), True)
    K5.LAUNCHES = before
    assert sorted(k5.graphs) == [7, 8]


def test_buffers_stay_bounded_over_many_render_lengths():
    # idle spans, block-by-block and resumed renders give a new remainder
    # length a render: the static buffers stay those of the longest step
    src, nch, opts, _n = CASES["wide_delay_network"]
    _prog, kern = port_kernel(src, nch, **opts)
    L = opts["segment_len"]
    rng = np.random.RandomState(21)
    lengths = [int(n) for n in rng.randint(1, 3 * L, size=50)]
    x = noise(nch, max(lengths), seed=22)
    kern._render_device_as("graph", x[:, :3 * L])
    names = set(kern._k5.buffers)
    nbytes = kern._k5.buffer_bytes()
    for n in lengths:
        kern._render_device_as("graph", x[:, :n])
        assert set(kern._k5.buffers) == names
        assert kern._k5.buffer_bytes() == nbytes
    assert kern._k5.regrowths == 0
    y, _c = held_to_eager(kern, x[:, :lengths[-1]])
    assert y.shape == (nch, lengths[-1])


def test_segment_graph_imports_neither_jax_nor_zorak_tpu():
    code = ("import sys\nimport zorak_tpu_torch.kernels.segment_graph\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'zorak_tpu' or "
            "m.startswith('zorak_tpu.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
