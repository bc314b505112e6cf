"""The planner's remaining paths in the port, on the CPU, against the JAX
package and the native golden: the time-blocked ring cycles, dynamic
delays, ungated and gated rand(), a sysex payload sent from @block, the
smart-idle modes, the fresh-render draw cache, and the two stand-ins
`builtin_plugins.modulated_delay_chorus` and `builtin_plugins.tpdf_dither`.

The sources, inputs and seeds are those of tests/test_ring_cycle.py,
tests/test_dynamic_delay.py, tests/test_rand_vector.py,
tests/test_midi_extended.py and tests/test_engine.py.  Each case renders
three ways: the port's kernel on CPU tensors, the JAX kernel, and the
native C golden (`null_test_plugin(golden="native")`, state and heap).
Bounds: against the golden audio 1e-5 on f32-rounded samples, vars and
heap 1e-8; against the JAX render the port's f32 audio within 1e-9 or one
f32 ulp of the sample, the carried scalars and rings within 1e-8
(`test_torch_specialize`'s helpers).
"""
import numpy as np
import pytest
import torch

from test_torch_specialize import (
    CARRY_EPS, audio_excess, carry_delta, kernels_for)
from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import SpecializeError as JaxSpecializeError
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.lowering.devexec import DeviceExecKernel as JaxDeviceExec
from zorak_tpu.runtime.engine import PluginInstance as JaxInstance
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.lowering import SpecializeError, specialize_sample_kernel
from zorak_tpu_torch.lowering import specialize as SP
from zorak_tpu_torch.lowering.devexec import DeviceExecKernel
from zorak_tpu_torch.runtime.engine import PluginInstance
from zorak_tpu_torch.shadow import compile_native_shadow
from zorak_tpu_torch.verify import (
    compare_audio, make_initialized_shadow, null_test_plugin)
from zorak_tpu_torch.verify.nulltest import apply_slider_state


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def randn(nch, n, scale, seed):
    return (np.random.RandomState(seed).randn(nch, n) * scale).astype(
        np.float32)


# tests/test_ring_cycle.py: two rings each read the other's delayed output
def ring_cycle(delay: int) -> str:
    return f"""\
@init
M = 512;
D = {delay};
A = 4096;
B = 8192;
@sample
ra = ia - D; ra < 0 ? ra += M;
rb = ib - D; rb < 0 ? rb += M;
A[ia] = spl0 + 0.5 * B[rb];
B[ib] = spl1 + 0.4 * A[ra];
spl0 = A[ia] - 0.25 * B[rb];
spl1 = B[ib];
ia += 1; ia >= M ? ia = 0;
ib += 1; ib >= M ? ib = 0;
"""


# tests/test_dynamic_delay.py, TestRingRingCycles
RING_RING = ("@init\nbufA = 0; bufB = 4096;\n"
             "@sample\n"
             "ia += 1; ia >= 1024 ? ia = 0;\n"
             "ib += 1; ib >= 1024 ? ib = 0;\n"
             "ra = ia - 600; ra < 0 ? ra += 1024;\n"
             "rb = ib - 700; rb < 0 ? rb += 1024;\n"
             "bufA[ia] = spl0 * 0.5 + bufB[rb] * 0.4;\n"
             "bufB[ib] = spl0 * 0.3 + bufA[ra] * 0.45;\n"
             "spl0 = bufA[ra] * 0.5 + bufB[rb] * 0.5;\n")
UNBREAKABLE = ("@init\nbufA = 0; bufB = 256;\n"
               "@sample\n"
               "i += 1; i >= 64 ? i = 0;\n"
               "p = i - 1; p < 0 ? p += 64;\n"
               "bufA[i] = spl0 + bufB[p] * 0.4;\n"
               "bufB[i] = spl0 - bufA[p] * 0.3;\n"
               "spl0 = bufA[p];\n")
RAND_IN_BRANCH = \
    "@sample\nspl0 > 0 ? ( spl0 = rand(1) * 0.5; ) : ( spl0 *= 2; );\n"
NOISE_SOURCE = "@sample\nspl0 = rand(2) - 1;\n"
# tests/test_midi_extended.py
SYSEX_FROM_BLOCK = """\
@init
p = 32; p[0] = 65; p[1] = 16; p[2] = 99;
cnt = 0;
@block
cnt += 1;
cnt == 2 ? midisyx(5, p, 3);
@sample
spl0 = spl0 * 0.5;
spl1 = spl1 * 0.5;
"""

# name -> (source, input, kernel options, the segment length a ring cycle
# cuts the plan to, or None)
CASES = {
    # coupling delay 300 >= block 64: the segment time-blocks to
    # (300 // 64) * 64 = 256, bit-exact with state and heap
    "ring_cycle_delay_300": (
        ring_cycle(300), randn(2, 4000, 0.3, 3),
        {"block_size": 64, "segment_len": 4096}, 256),
    # A reads B 700 samples old, B reads A 600 old: shrunk to 512
    "ring_ring_cycle": (
        RING_RING, randn(1, 5000, 0.4, 9), {"segment_len": 1 << 14}, 512),
    "modulated_delay": (
        "@init\nMASK = 1023;\n@sample\nbuf[w & MASK] = spl0;\n"
        "ph += 0.01;\nd = (40 + 30*sin(ph)) | 0;\n"
        "spl0 = 0.5*spl0 + 0.5*buf[(w - d) & MASK];\nw += 1;\n",
        randn(1, 5000, 0.4, 9), {"segment_len": 1024}, None),
    "signal_dependent_delay": (
        "@init\nMASK = 511;\n@sample\nbuf[w & MASK] = spl0;\n"
        "d = (10 + abs(spl1)*200) | 0;\nspl0 = buf[(w - d) & MASK];\n"
        "w += 1;\n",
        randn(2, 4000, 0.4, 9), {"segment_len": 512}, None),
    "wavetable_lookup": (
        "@init\ntab = 100;\n"
        "i = 0; loop(256, tab[i] = sin(i * $pi / 128); i += 1;);\n"
        "@sample\nph += 0.3 + 0.2*spl0;\nspl0 = tab[(ph | 0) & 255];\n",
        randn(1, 4000, 0.4, 9), {"segment_len": 1024}, None),
    "delay_crossing_segments": (
        "@init\nMASK = 255;\n@sample\nbuf[w & MASK] = spl0;\n"
        "d = 100 + ((w >> 5) & 63);\nspl0 = buf[(w - d) & MASK];\n"
        "w += 1;\n",
        randn(1, 2000, 0.4, 9), {"segment_len": 256}, None),
    "read_before_write_same_slot": (
        "@init\nMASK = 63;\n@sample\nold = buf[w & MASK];\n"
        "buf[w & MASK] = spl0;\nspl0 = old;\nw += 1;\n",
        randn(1, 500, 0.4, 9), {"segment_len": 128}, None),
    # tests/test_rand_vector.py
    "rand_noise_source": (
        NOISE_SOURCE, np.zeros((1, 3000), np.float32),
        {"segment_len": 1024}, None),
    "rand_several_draws_a_sample": (
        "@sample\na = rand(1);\nb = rand(10);\n"
        "spl0 = a*0.1 + b*0.01 + spl0*0.5;\n",
        randn(1, 2000, 0.2, 0), {"segment_len": 512}, None),
    "rand_after_init_draws": (
        "@init\nseed_burn = rand(1) + rand(1);\n@sample\nspl0 = rand(1);\n",
        np.zeros((1, 1500), np.float32), {"segment_len": 512}, None),
    "rand_with_dynamic_limit": (
        "@sample\nlim = 1 + abs(spl0)*5;\nspl0 = rand(lim) * 0.1;\n",
        randn(1, 2000, 0.4, 1), {"segment_len": 512}, None),
    "rand_in_branch": (
        RAND_IN_BRANCH, randn(1, 1500, 0.4, 5), {"segment_len": 512}, None),
    "rand_state_after_render": (
        "@sample\nspl0 = rand(1);\n", np.zeros((1, 700), np.float32),
        {"segment_len": 256}, None),
    # tests/test_midi_extended.py: a sysex payload sent from @block
    "sysex_from_block": (
        SYSEX_FROM_BLOCK, randn(2, 2048, 0.25, 3),
        {"segment_len": 1024, "block_size": 512}, None),
    # the stand-ins at a small size
    "modulated_delay_chorus": (
        builtin_plugins.modulated_delay_chorus(2, 512),
        randn(2, 4000, 0.25, 11), {"segment_len": 1024}, None),
    "tpdf_dither": (
        builtin_plugins.tpdf_dither(16), randn(2, 4000, 0.25, 12),
        {"segment_len": 1024}, None),
}


def native_golden(prog, x, block):
    """The native golden after init and slider, and its render of x in
    blocks of `block`."""
    gold = compile_native_shadow(prog)
    gold.state.srate = 48000.0
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y = np.zeros_like(x)
    for s in range(0, x.shape[1], block):
        e = min(s + block, x.shape[1])
        gold.process_block(x[:, s:e], y[:, s:e])
    return gold, y


def python_golden(prog, x, block):
    """The Python golden's state after its render of x (the native
    golden keeps its generator on the C side)."""
    gold = make_initialized_shadow(prog, 48000.0)
    y = np.zeros_like(x)
    for s in range(0, x.shape[1], block):
        e = min(s + block, x.shape[1])
        gold.process_block(x[:, s:e], y[:, s:e])
    return gold.state


def next_draws(rng, n=5):
    return [rng.gen_u32() for _ in range(n)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax_and_golden(name):
    src, x, opts, seg = CASES[name]
    opts = {"block_size": 512, **opts}
    prog, kern, jkern = kernels_for(src, x.shape[0], **opts)
    assert kern.L == jkern.L and (seg is None or kern.L == seg)
    assert kern.carried_vars == jkern.carried_vars
    assert {k: p.kind for k, p in kern.plans.items()} == \
        {k: p.kind for k, p in jkern.plans.items()}
    assert (kern.n_rand, kern.rand_gated) == (jkern.n_rand, jkern.rand_gated)
    y, carry = kern.render(x)
    yj, jcarry = jkern.render(x)
    assert y.dtype == np.float32 and y.shape == x.shape
    d = float(np.abs(y.astype(np.float64) - np.asarray(yj, np.float64)).max())
    print(f"{name}: L {kern.L}, max |port - JAX| audio {d:.3e}, carry "
          f"{carry_delta(carry, jcarry):.3e}")
    assert audio_excess(y, yj) <= 0.0, "port vs JAX render"
    assert carry_delta(carry, jcarry) <= CARRY_EPS
    rep = null_test_plugin(prog, x, golden="native", device="cpu",
                           compare_state=True, compare_mem=True, **opts)
    assert rep.passed, rep.summary()


def test_dynamic_reads_are_planned_as_such():
    # the chorus's voices read both rings twice at a slot that moves every
    # sample: twelve dynamic ring reads at 3 voices, none folded into a
    # static tap, in both packages; PluginInstance renders it on the vector
    # path
    src = builtin_plugins.modulated_delay_chorus(3, 4096)
    _prog, kern, jkern = kernels_for(src, 2, segment_len=4096)
    kinds = [n.kind for n in kern._all_nodes(kern.sym)]
    jkinds = [n.kind for n in jkern._all_nodes(jkern.sym)]
    assert kinds.count("dynringref") == jkinds.count("dynringref") == 12
    assert sorted(kern.sym.ring_writes) == [(0, 4096), (4096, 4096)]
    inst = PluginInstance(compile_plugin_source(src), device="cpu")
    assert inst.engine == "torch-vector", inst.spec_error


def test_dynamic_reads_run_in_the_k3b_range():
    # K3b (the cursors' positions, the dynamic reads' slot arithmetic,
    # last-writer choice and gathers) runs inside K3B_RANGE while a
    # profiler runs, and the audio is the same with and without it; the
    # LFO's sin and the ring writes' own streams stay outside
    from torch.profiler import ProfilerActivity, profile

    prog = compile_plugin_source(builtin_plugins.modulated_delay_chorus(2, 512))
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    2, segment_len=1024, device="cpu")
    x = randn(2, 2048, 0.25, 11)
    y_off = kern.render_device(x)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y_on = kern.render_device(x)[0]
    assert torch.equal(y_on, y_off)
    ranges = [e for e in prof.events() if e.name == SP.K3B_RANGE]
    # 8 dynamic reads a segment, 2 segments
    assert len(ranges) >= 8 * 2

    def inside(e):
        for ch in e.cpu_children:
            yield ch
            yield from inside(ch)

    names = set()
    for r in ranges:
        got = {ch.name for ch in inside(r)}
        assert SP.K3B_RANGE not in got and SP.K6_RANGE not in got
        assert not {"aten::sin", "aten::floor"} & got, got
        names |= got
    assert "aten::remainder" in names


@pytest.mark.parametrize("delay,nch,n,block,seed,src", [
    pytest.param(3, 2, 1024, 512, 3, None, id="cross_ring_delay_3"),
    pytest.param(None, 1, 0, 512, 0, UNBREAKABLE, id="unbreakable_cycle"),
])
def test_refused_in_both(delay, nch, n, block, seed, src):
    # a coupling delay below one block is sample-rate feedback across the
    # rings: both packages refuse it (the engine renders it on devexec)
    src = src or ring_cycle(delay)
    prog = compile_plugin_source(src)
    jprog = jax_compile(src)
    opts = {"segment_len": 1 << 14, "block_size": block}
    with pytest.raises(SpecializeError, match="cyclic|coupling"):
        specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                 nch, device="cpu", **opts)
    with pytest.raises(JaxSpecializeError, match="cyclic|coupling"):
        jax_specialize(jprog, jax_shadow(jprog).state, nch, **opts)
    if n:
        with pytest.raises(SpecializeError, match="cyclic|coupling"):
            null_test_plugin(prog, randn(nch, n, 0.3, seed), golden="native",
                             block_size=block, device="cpu")


def test_subblock_cycle_renders_on_devexec():
    # the refused shape's fallback: the sequential executor, the port's
    # against the JAX DeviceExecKernel and the native golden, state and heap
    src = ring_cycle(3)
    prog = compile_plugin_source(src)
    x = randn(2, 256, 0.3, 9)
    rep = null_test_plugin(prog, x, block_size=64, golden="native",
                           compare_state=True, compare_mem=True,
                           engine="devexec", device="cpu")
    assert rep.passed, rep.summary()
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 2,
                            block_size=64, device="cpu")
    y, _carry = kern.render(x)
    jprog = jax_compile(src)
    jkern = JaxDeviceExec(jprog, jax_shadow(jprog).state, 2, block_size=64)
    yj, _jcarry = jkern.render(x)
    d = float(np.abs(np.asarray(y, np.float64)
                     - np.asarray(yj, np.float64)).max())
    print(f"sub-block cycle on devexec: max |port - JAX| audio {d:.3e}")
    assert audio_excess(np.asarray(y, np.float32), yj) <= 0.0


@pytest.mark.parametrize("src,seed", [
    pytest.param(RAND_IN_BRANCH, 6, id="gated_branch"),
    pytest.param(NOISE_SOURCE, 6, id="ungated_noise")])
def test_streamed_over_two_resumed_renders(src, seed):
    # the generator continues across resumed renders (gated: only the
    # consumed draws advance it), against the native golden and JAX
    x = randn(1, 1400, 0.4, seed)
    prog, kern, jkern = kernels_for(src, 1, segment_len=512)
    _gold, y_ref = native_golden(prog, x, 512)
    y1, carry = kern.render(x[:, :700])
    y2, carry = kern.render(x[:, 700:], carry)
    y = np.concatenate([y1, y2], axis=1)
    assert compare_audio(y_ref, y).audio_passed
    yj1, jcarry = jkern.render(x[:, :700])
    yj2, jcarry = jkern.render(x[:, 700:], jcarry)
    yj = np.concatenate([np.asarray(yj1), np.asarray(yj2)], axis=1)
    print(f"streamed: max |port - JAX| audio "
          f"{float(np.abs(y.astype(np.float64) - yj).max()):.3e}")
    assert audio_excess(y, yj) <= 0.0
    assert carry_delta(carry, jcarry) <= CARRY_EPS
    st = make_initialized_shadow(prog).state
    kern.writeback(carry, st)
    jst = jax_shadow(jax_compile(src)).state
    jkern.writeback(jcarry, jst)
    assert next_draws(st.rng) == next_draws(
        python_golden(prog, x, 512).rng) == next_draws(jst.rng)


def test_generator_state_after_a_render():
    # the ungated generator after a render has advanced by every draw, as
    # the golden's and JAX's have
    src, x, opts, _seg = CASES["rand_state_after_render"]
    prog, kern, jkern = kernels_for(src, 1, **opts)
    _y, carry = kern.render(x)
    st = make_initialized_shadow(prog).state
    kern.writeback(carry, st)
    _yj, jcarry = jkern.render(x)
    jst = jax_shadow(jax_compile(src)).state
    jkern.writeback(jcarry, jst)
    assert next_draws(st.rng) == next_draws(
        python_golden(prog, x, 512).rng) == next_draws(jst.rng)


def test_sysex_payload_from_block_like_jax():
    # the host trajectory surfaces the whole byte string, in the port as in
    # the JAX kernel
    src, x, opts, _seg = CASES["sysex_from_block"]
    _prog, kern, jkern = kernels_for(src, 2, **opts)
    kern.render(x)
    jkern.render(x)
    (ev,) = kern.last_midi_out
    assert ev == (512 + 5, 0xF0, 65, 16, (0xF0, 65, 16, 99, 0xF7))
    assert list(kern.last_midi_out) == [tuple(e) for e in jkern.last_midi_out]


# tests/test_engine.py, TestIdleModes and TestMonitorModes
IDLE_SRC = "@block\nblocks += 1;\n@sample\nspl0 = spl0 * 0.5;\n"
MIDI_EFFECT = "@block\nwhile (midirecv(o, a, b, c)) ( q += 1; );\n"
TAIL_SRC = ("@block\nblocks += 1;\n"
            "@sample\nz = 0.999*z + spl0;\nspl0 = z;\n")


def both_instances(src, **kw):
    """The port's PluginInstance on the CPU and the JAX one, same
    arguments."""
    return (PluginInstance(compile_plugin_source(src), device="cpu", **kw),
            JaxInstance(jax_compile(src), **kw))


@pytest.mark.parametrize("src,mode", [
    pytest.param(IDLE_SRC, "input_driven", id="audio_plugin"),
    pytest.param(MIDI_EFFECT, "event_driven", id="midi_effect")])
def test_idle_mode_inference_like_jax(src, mode):
    inst, jinst = both_instances(src, prefer="none")
    assert inst.effective_idle_mode == jinst.effective_idle_mode == mode


@pytest.mark.parametrize("name", ["free_running", "keep_awake",
                                  "output_tail"])
def test_idle_sleep_rules_like_jax(name):
    x = np.zeros((1, 256 * 12), dtype=np.float32)
    if name == "free_running":
        src, kw = IDLE_SRC, {"smart_idle": "free_running",
                             "idle_hold_ms": 1.0}
    elif name == "keep_awake":
        src, kw = ("@init\nza_keep_awake = 1;\n" + IDLE_SRC,
                   {"smart_idle": "input_driven", "idle_hold_ms": 1.0})
    else:
        # decaying feedback keeps the output hot after the input's silence
        src, kw = TAIL_SRC, {"smart_idle": "input_driven",
                             "idle_hold_ms": 5.0, "idle_threshold": 1e-4}
        x = np.zeros((1, 256 * 30), dtype=np.float32)
        x[0, :256] = 0.5
    inst, jinst = both_instances(src, prefer="none", **kw)
    y = inst.render(x, block_size=256).audio
    yj = jinst.render(x, block_size=256).audio
    blocks = inst.shadow.state.V["blocks"]
    assert blocks == jinst.shadow.state.V["blocks"]
    assert blocks > 10.0 if name == "output_tail" else blocks == 12.0
    assert np.array_equal(y, np.asarray(yj))


def test_bad_mode_rejected_like_jax():
    src = "@init\nz = 0;\n@sample\nz = 0.99 * z + 0.01 * spl0; spl0 = z;\n"
    inst, jinst = both_instances(src, prefer="none")
    x = randn(1, 256, 0.3, 7)
    for i in (inst, jinst):
        with pytest.raises(ValueError):
            i.render(x, monitor="diff")


# the fresh-render draw cache: an uncoupled, a hop and a coupled kernel with
# ungated rand() in @sample
HOP_RAND = """@init
H = 64; INBUF = 0; OUTBUF = 256; ctr = 0; rpos = 0;
function do_hop() local(i) (
  i = 0;
  while (i < H) ( OUTBUF[i] = INBUF[i] * 0.5 + 0.1; i += 1; );
  hops += 1;
);
@sample
y = OUTBUF[rpos];
INBUF[ctr] = spl0;
spl0 = y + spl0 * 0.25 + (rand(1) - 0.5) * 0.001;
rpos += 1; rpos >= H ? rpos = 0;
ctr += 1;
ctr >= H ? ( do_hop(); ctr = 0; );
"""
COUPLED_RAND = """@sample
mem[w] = spl0; w = (w + 1) & 63;
spl0 *= g + rand(1) * 0.001;
@block
s = 0; i = 0; loop(64, s += abs(mem[i]); i += 1;);
g = 1 / (1 + s * 0.01);
"""
# a guessed loop(n) bound (the count follows the input) and an ungated rand
LADDER_RAND = """@sample
n = abs(spl0) * 10;
acc = 0; i = 0;
loop(n, acc += spl0 * (i + 1); i += 1;);
spl0 = acc * 0.1 + rand(1) * 0.001;
"""
CACHED = {
    "uncoupled": (builtin_plugins.tpdf_dither(16), 2, {"segment_len": 1024}),
    "hop": (HOP_RAND, 1, {"segment_len": 512, "block_size": 32}),
    "coupled": (COUPLED_RAND, 1, {"segment_len": 512, "block_size": 128}),
}


def port_kernel(src, nch, **opts):
    prog = compile_plugin_source(src)
    return prog, specialize_sample_kernel(
        prog, make_initialized_shadow(prog).state, nch, device="cpu", **opts)


def rng_equal(a, b):
    return np.array_equal(a[0], b[0]) and int(a[1]) == int(b[1])


def written_back(kern, carry, prog):
    """The generator (mt, idx) that `writeback` leaves in a fresh state."""
    st = make_initialized_shadow(prog).state
    kern.writeback(carry, st)
    return np.asarray(st.rng.mt, np.uint32), st.rng.idx


@pytest.mark.parametrize("name", sorted(CACHED))
def test_cache_hit_renders_as_the_miss(name):
    # two fresh renders of one length, a miss then a hit, against a kernel
    # whose cache is emptied before each render: the same audio, generator
    # state and written-back state; the matrix is kept on the kernel's
    # device as f64 and no render writes into it
    src, nch, opts = CACHED[name]
    prog, kern = port_kernel(src, nch, **opts)
    _prog, bare = port_kernel(src, nch, **opts)
    assert kern.n_rand and not kern.rand_gated
    assert (kern._hop is not None, kern.coupled) == (
        name == "hop", name == "coupled")
    x = randn(nch, 1000, 0.4, 3)
    y_miss, c_miss = kern.render(x)
    assert list(kern._rand_cache) == [1000]
    cached, state = kern._rand_cache[1000]
    assert cached.dtype == torch.float64 and cached.device == kern.device
    assert cached.shape == (1000, kern.n_rand)
    kept = cached.clone()
    assert rng_equal(state, kern._rng_state)
    after_miss = kern._rng_state
    y_hit, c_hit = kern.render(x)
    assert kern._rand_cache[1000][0] is cached
    assert torch.equal(cached, kept)
    bare._rand_cache.clear()
    y_bare, c_bare = bare.render(x)
    assert np.array_equal(y_miss, y_bare) and np.array_equal(y_hit, y_bare)
    assert rng_equal(kern._rng_state, after_miss)
    assert rng_equal(kern._rng_state, bare._rng_state)
    assert rng_equal(written_back(kern, c_hit, prog),
                     written_back(bare, c_bare, prog))
    assert rng_equal(written_back(kern, c_miss, prog),
                     written_back(bare, c_bare, prog))
    block = opts.get("block_size", 512)
    _gold, y_ref = native_golden(prog, x, block)
    assert compare_audio(y_ref, y_hit).audio_passed
    st = make_initialized_shadow(prog).state
    kern.writeback(c_hit, st)
    assert next_draws(st.rng) == next_draws(python_golden(prog, x, block).rng)


def test_cache_keeps_four_lengths():
    # past four lengths the cache stops storing, as the reference's does;
    # a length it did not store renders as before
    src, nch, opts = CACHED["uncoupled"]
    prog, kern = port_kernel(src, nch, **opts)
    x = randn(nch, 600, 0.4, 4)
    for n in (100, 200, 300, 400):
        kern.render(x[:, :n])
    assert sorted(kern._rand_cache) == [100, 200, 300, 400]
    y5, _ = kern.render(x[:, :500])
    assert sorted(kern._rand_cache) == [100, 200, 300, 400]
    y5b, _ = kern.render(x[:, :500])
    assert np.array_equal(y5, y5b)
    _y, y_ref = native_golden(prog, x[:, :500], 512)
    assert compare_audio(y_ref, y5).audio_passed


def test_resumed_and_gated_renders_bypass_the_cache():
    # a resumed render draws on from the generator, a gated render from a
    # pool sized by what it consumes: neither reads or fills the cache
    src, nch, opts = CACHED["uncoupled"]
    prog, kern = port_kernel(src, nch, **opts)
    x = randn(nch, 1400, 0.4, 6)
    y1, carry = kern.render(x[:, :700])
    assert list(kern._rand_cache) == [700]
    cached = kern._rand_cache[700][0].clone()
    y2, carry = kern.render(x[:, 700:], carry)
    assert list(kern._rand_cache) == [700]
    assert torch.equal(kern._rand_cache[700][0], cached)
    _gold, y_ref = native_golden(prog, x, 512)
    assert compare_audio(y_ref, np.concatenate([y1, y2], axis=1)).audio_passed
    gprog, gated = port_kernel(RAND_IN_BRANCH, 1, segment_len=512)
    assert gated.rand_gated
    xg = randn(1, 1500, 0.4, 5)
    ya, _ = gated.render(xg)
    yb, _ = gated.render(xg)
    assert gated._rand_cache == {} and np.array_equal(ya, yb)


def test_ladder_replays_identically_after_a_hit():
    # a guessed loop(n) bound with ungated rand(): a quiet render fills the
    # cache at K = 2; a loud render of the same length hits it, overflows,
    # rebuilds and replays from the generator state it started from.  The
    # same loud render after a miss climbs to the same K and leaves the
    # same audio, generator and written-back state
    prog, kern = port_kernel(LADDER_RAND, 1, segment_len=512,
                             masked_loop_k=2)
    _prog, bare = port_kernel(LADDER_RAND, 1, segment_len=512,
                              masked_loop_k=2)
    assert kern.sym.masked_loops and kern.masked_loop_k == 2
    quiet = randn(1, 1000, 0.01, 3)
    loud = randn(1, 1000, 0.6, 4)
    kern.render(quiet)
    assert kern.masked_loop_k == 2 and list(kern._rand_cache) == [1000]
    y_hit, c_hit = kern.render(loud)
    y_miss, c_miss = bare.render(loud)
    assert kern.masked_loop_k == bare.masked_loop_k > 2
    assert np.array_equal(y_hit, y_miss)
    assert rng_equal(kern._rng_state, bare._rng_state)
    assert rng_equal(written_back(kern, c_hit, prog),
                     written_back(bare, c_miss, prog))
    _gold, y_ref = native_golden(prog, loud, 512)
    assert compare_audio(y_ref, y_hit).audio_passed


def test_second_fresh_render_of_an_instance_like_jax():
    # PluginInstance writes each render's generator back into its state,
    # which the kernel plans from; a second fresh render of a cached length
    # still draws the planned matrix, as the reference's does, so both
    # packages give the first render's audio again, and the generator
    # written back is the same
    src = builtin_plugins.tpdf_dither(16)
    x = randn(2, 3000, 0.25, 13)
    inst, jinst = both_instances(src, smart_idle="always_awake")
    assert inst.engine == "torch-vector" and jinst.kernel is not None
    ys = [inst.render(x).audio for _ in range(2)]
    yjs = [np.asarray(jinst.render(x).audio) for _ in range(2)]
    assert np.array_equal(ys[0], ys[1]) and np.array_equal(yjs[0], yjs[1])
    assert audio_excess(ys[1], yjs[1]) <= 0.0
    assert next_draws(inst.shadow.state.rng) == next_draws(
        jinst.shadow.state.rng)
