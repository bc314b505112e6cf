"""The gated regime of the port's specializer on the CPU: gated ring cursors
and taps, gated rand(), and guessed loop(n) bounds with their overflow
ladder, against the JAX kernel and the native golden.

Every case of tests/test_gated_ring.py, tests/test_masked_loop.py and the
gated cases of tests/test_rand_vector.py renders the same seeded numpy
input three ways: the port's kernel (CPU tensors), the JAX kernel and the
native C golden (`null_test_plugin(golden="native")`).  Bounds: the
JAX tests' against the golden (the null contract, `rep.passed`: audio
within 1e-5 after f32 rounding, vars and heap within 1e-8, or 1e-5 where
the JAX test holds the audio alone); against the JAX render, the port's
f32 audio within 1e-9 or one f32 ulp of the sample, the carried scalars
and rings within 1e-8.  Each case prints its largest difference from the
JAX render (`pytest -s`).
"""
import numpy as np
import pytest
import torch

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import SpecializeError as JaxSpecializeError
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.parallel import BatchRenderer as JaxBatchRenderer
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.lowering import SpecializeError, specialize_sample_kernel
from zorak_tpu_torch.lowering.specialize import K6_RANGE
from zorak_tpu_torch.parallel import BatchRenderer, catalog_stacked_render
from zorak_tpu_torch.shadow import compile_native_shadow
from zorak_tpu_torch.verify import (
    compare_audio, make_initialized_shadow, null_test_plugin)
from zorak_tpu_torch.verify.nulltest import apply_slider_state

JAX_EPS = 1e-9      # the port's f32 audio against the JAX render's
CARRY_EPS = 1e-8    # carried scalars and rings against JAX's


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def noise(ch, n, scale=0.4, seed=9):
    return (np.random.RandomState(seed).randn(ch, n) * scale).astype(
        np.float32)


def tank_noise():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((2, 12288)) * 0.25).astype(np.float32)


# tests/test_gated_ring.py
TANK_SRC = """\
desc:gated delay tank (synthetic)
@init
MASK = 8191;
w = 0; lp = 0;
@sample
g = abs(spl0) > 0.1;
g ? (
  t1 = 0[(w - 4096) & MASK];
  t2 = 0[(w - 4100) & MASK];
  lp = 0.6*lp + 0.4*(t1 - 0.5*t2);
  0[w] = spl0*0.5 + lp*0.3;
  w = (w + 1) & MASK;
);
spl0 = spl0 + lp * 0.2;
spl1 = spl1;
"""

DYN_SRC = """\
desc:gated tank with ctrl-derived dynamic taps
@init
MASK = 8191;
w = 0; lp = 0; bsize = 0;
@block
bsize = bsize + 0.013;
bsize > 1 ? bsize = 0;
@sample
sz = bsize;
sz < 0 ? sz = 0;
sz > 1 ? sz = 1;
d = floor(4096 + 500*sz);
g = abs(spl0) > 0.1;
g ? (
  t1 = 0[(w - d) & MASK];
  lp = 0.6*lp + 0.4*t1;
  0[w] = spl0*0.5 + lp*0.3;
  w = (w + 1) & MASK;
);
spl0 = spl0 + lp * 0.2;
spl1 = spl1;
"""

RAND_IN_BRANCH = \
    "@sample\nspl0 > 0 ? ( spl0 = rand(1) * 0.5; ) : ( spl0 *= 2; );\n"
UNBOUNDED_LADDER = ("@block\n"
                    "blk += 1;\n"
                    "reps = blk;\n"
                    "@sample\n"
                    "acc = 0; i = 0;\n"
                    "loop(reps,\n"
                    "  acc += spl0 * 0.25 + i * 0.001;\n"
                    "  i += 1;\n"
                    ");\n"
                    "spl0 = acc * 0.2;\n")

# name -> (source, input, kernel options, the JAX test's bound: "passed"
# (the null contract with state and heap) or "audio" (audio alone))
CASES = {
    "audio_gated_tank_bit_exact": (
        TANK_SRC, tank_noise(),
        {"segment_len": 131072, "block_size": 512}, "passed"),
    "gate_never_fires_ring_frozen": (
        TANK_SRC, np.full((2, 4096), 0.01, dtype=np.float32),
        {"segment_len": 131072, "block_size": 512}, "passed"),
    "ctrl_derived_dynamic_tap_bit_exact": (
        DYN_SRC, tank_noise(),
        {"segment_len": 131072, "block_size": 512}, "passed"),
    "clamped_count_static_bound": (
        "@sample\n"
        "n = abs(spl0) * 10;\n"
        "n > 6 ? n = 6;\n"
        "acc = 0; i = 0;\n"
        "loop(n,\n"
        "  acc += spl0 * (i + 1);\n"
        "  i += 1;\n"
        ");\n"
        "spl0 = acc * 0.1;\n", noise(1, 4000), {"segment_len": 1024},
        "passed"),
    "loop_value_and_state": (
        "@init\nhist = 100;\n"
        "@sample\n"
        "n = abs(spl0) * 8;\n"
        "n > 5 ? n = 5;\n"
        "s = 0;\n"
        "v = loop(n, s += 1; s * 2;);\n"
        "hist[0] = v;\n"
        "spl0 = v * 0.05 + hist[0] * 0.01;\n", noise(1, 3000),
        {"segment_len": 512}, "passed"),
    "expansion_scan_shape": (
        "@init\ntab = 200;\n"
        "i = 0; loop(64, tab[i] = sin(i * 0.37); i += 1;);\n"
        "@sample\n"
        "n = abs(spl0) * 12;\n"
        "n > 8 ? n = 8;\n"
        "left = 32; cont = 1;\n"
        "loop(n,\n"
        "  cont ? (\n"
        "    left > 0 ? (\n"
        "      tab[left - 1] > 0 ? left -= 1 : cont = 0;\n"
        "    ) : cont = 0;\n"
        "  );\n"
        ");\n"
        "spl0 = left * 0.01 + tab[left] * 0.2;\n", noise(1, 3000),
        {"segment_len": 512}, "passed"),
    "unbounded_null_harness": (
        "@block\n"
        "r = r + 1; r > 9 ? r = 3;\n"
        "@sample\n"
        "acc = 0;\n"
        "loop(r, acc = acc * 0.5 + spl0;);\n"
        "spl1 = acc * 0.3;\n", noise(2, 4000), {"segment_len": 512},
        "passed"),
    "clamped_address_gather": (
        "@init\ntex = 500; nfr = 64;\n"
        "i = 0; loop(128, tex[i] = sin(i * 0.21); i += 1;);\n"
        "@sample\n"
        "frame = abs(spl0) * 100;\n"
        "lim = nfr - 2;\n"
        "frame > lim ? frame = lim;\n"
        "frame < 0 ? frame = 0;\n"
        "i0 = floor(frame);\n"
        "frac = frame - i0;\n"
        "s0 = tex[i0 * 2];\n"
        "s1 = tex[i0 * 2 + 2];\n"
        "spl0 = s0 + (s1 - s0) * frac;\n", noise(1, 3000),
        {"segment_len": 512}, "passed"),
    "rand_in_branch": (
        RAND_IN_BRANCH,
        (np.random.RandomState(5).randn(1, 1500) * 0.4).astype(np.float32),
        {"segment_len": 512}, "passed"),
    # a decimated metering history: a gated cursor whose region no tap
    # reads, so its write takes the gated dynamic-write path
    "decimated_meter_history": (
        "@init\nHIST = 900;\n"
        "@sample\npeak = max(peak, abs(spl0));\ncnt += 1;\n"
        "cnt >= 37 ? (\n  HIST[wpos] = peak;\n"
        "  wpos += 1; wpos >= 50 ? wpos = 0;\n  cnt = 0; peak = 0;\n"
        ");\nspl0 = spl0 * 0.5;\n", noise(1, 6000, seed=4),
        {"segment_len": 1024}, "passed"),
    # a sequential scan group (K4 on the card) fed by a gated tap whose
    # delay comes from the control
    "scan_group_reads_gated_tap": (
        "@init\nMASK = 2047; bs = 0;\n"
        "@block\nbs += 0.01; bs > 1 ? bs = 0;\n"
        "@sample\nsz = bs; sz < 0 ? sz = 0; sz > 1 ? sz = 1;\n"
        "d = floor(700 + 300*sz);\ng = abs(spl0) > 0.1;\ng ? (\n"
        "  r = abs(mem[(w - d) & MASK]);\n"
        "  env = r > env ? 0.6*env + 0.4*r : 0.999*env + 0.001*r;\n"
        "  mem[w] = spl0*0.5 + 0.3*env;\n  w = (w + 1) & MASK;\n);\n"
        "spl0 = spl0 + env*0.1;\n", noise(1, 6000, seed=1),
        {"segment_len": 4096}, "passed"),
    # the stand-in at its width on 2 s: 8 lines, the segment cut to 1,024
    "gated_fdn_tank": (
        builtin_plugins.gated_fdn_tank(8), noise(2, 96000, 0.25, seed=21),
        {"segment_len": 1 << 17, "block_size": 512}, "passed"),
}

REJECTED = {
    # the write must fire exactly when the cursor advances
    "write_outside_gate_rejected": (
        TANK_SRC.replace("  0[w] = spl0*0.5 + lp*0.3;\n", "").replace(
            "spl0 = spl0 + lp * 0.2;",
            "0[w] = spl0*0.5 + lp*0.3;\nspl0 = spl0 + lp * 0.2;"),
        2, {"segment_len": 131072, "block_size": 512}),
    # a 300-sample tap cannot clear any block-multiple segment
    "short_feedback_rejected": (
        TANK_SRC.replace("4096", "300").replace("4100", "310"), 2,
        {"segment_len": 131072, "block_size": 512}),
    "too_heavy_rejects": (
        "@block\nn = n + 100;\n@sample\n"
        f"loop(n * 100000, {'x += spl0;' * 200});\nspl0 = x * 1e-6;\n",
        1, {"segment_len": 512, "masked_loop_k": 4096}),
    "span_overlapping_written_cell_rejects": (
        "@init\ntab = 100;\n"
        "@sample\n"
        "tab[3] = spl0;\n"
        "j = abs(spl1) * 10; j > 7 ? j = 7;\n"
        "spl0 = tab[j | 0];\n", 2, {"segment_len": 512}),
}


def kernels_for(src, nch, **opts):
    """The port's kernel (CPU) and the JAX kernel from one source text."""
    prog = compile_plugin_source(src)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    nch, device="cpu", **opts)
    jprog = jax_compile(src)
    jkern = jax_specialize(jprog, jax_shadow(jprog).state, nch, **opts)
    return prog, kern, jkern


def jax_delta(y, yj, carry, jcarry):
    """(largest |port - JAX| of the audio, how far it lies outside 1e-9 or
    one f32 ulp (<= 0 inside), largest |port - JAX| of the carry)."""
    yj = np.asarray(yj, np.float32)
    d = np.abs(y.astype(np.float64) - yj.astype(np.float64))
    excess = float(np.max(d - np.maximum(JAX_EPS, np.spacing(np.abs(yj))),
                          initial=-1.0))
    svec, rings = carry
    jsvec, jrings = jcarry
    worst = float(np.max(np.abs(svec.numpy() - np.asarray(jsvec)),
                         initial=0.0))
    assert sorted(rings) == sorted(jrings)
    for region, arr in rings.items():
        worst = max(worst, float(np.max(np.abs(
            arr.numpy() - np.asarray(jrings[region])), initial=0.0)))
    return float(d.max(initial=0.0)), excess, worst


@pytest.mark.parametrize("name", sorted(CASES))
def test_gated_port_matches_jax_and_golden(name):
    src, x, opts, bound = CASES[name]
    prog, kern, jkern = kernels_for(src, x.shape[0], **opts)
    assert kern.L == jkern.L and kern.carried_vars == jkern.carried_vars
    assert {k: p.kind for k, p in kern.plans.items()} == \
        {k: p.kind for k, p in jkern.plans.items()}
    assert kern.rand_gated == jkern.rand_gated
    assert kern.scan_groups or name != "scan_group_reads_gated_tap"
    assert bool(kern.sym.masked_loops) == bool(jkern.sym.masked_loops)
    y, carry = kern.render(x)
    yj, jcarry = jkern.render(x)
    assert y.dtype == np.float32 and y.shape == x.shape
    d_audio, excess, d_carry = jax_delta(y, yj, carry, jcarry)
    print(f"{name}: max |port - JAX| audio {d_audio:.3e}, carry "
          f"{d_carry:.3e}")
    assert excess <= 0.0, f"port vs JAX render: {d_audio}"
    assert d_carry <= CARRY_EPS
    rep = null_test_plugin(prog, x, golden="native", device="cpu",
                           compare_state=True, compare_mem=True, **{
                               k: v for k, v in opts.items()
                               if k in ("segment_len", "block_size")})
    assert rep.passed if bound == "passed" else rep.audio_passed, \
        rep.summary()


def test_tank_plan_is_the_reference_s():
    # the 4100-tap forces the time-blocked shrink: L <= M - d_max; the
    # cursor is a gated wrapped counter the host does not mirror
    src, _x, opts, _ = CASES["audio_gated_tank_bit_exact"]
    _prog, kern, jkern = kernels_for(src, 2, **opts)
    assert kern.L == jkern.L == 3584
    assert kern.plans[("var", "w")].kind == "gmodind"
    assert kern.scalar_index[("var", "w")] not in kern.mirrored_slots()
    tank = specialize_sample_kernel(
        compile_plugin_source(builtin_plugins.gated_fdn_tank(8)),
        make_initialized_shadow(compile_plugin_source(
            builtin_plugins.gated_fdn_tank(8))).state, 2, device="cpu")
    # taps 1,500 to 4,000 cells behind the cursor in rings of 8,192
    assert tank.L == 1024 and tank.rand_gated
    assert len(tank.sym.gring_writes) == 8


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_gated_rejected_in_both(name):
    src, nch, opts = REJECTED[name]
    prog = compile_plugin_source(src)
    with pytest.raises(SpecializeError):
        specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                 nch, device="cpu", **opts)
    jprog = jax_compile(src)
    with pytest.raises(JaxSpecializeError):
        jax_specialize(jprog, jax_shadow(jprog).state, nch, **opts)


def native_render(prog, x, block):
    """The native golden's render of x in blocks of `block`."""
    gold = compile_native_shadow(prog)
    gold.state.srate = 48000.0
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y = np.zeros_like(x)
    for s in range(0, x.shape[1], block):
        e = min(s + block, x.shape[1])
        gold.process_block(x[:, s:e], y[:, s:e])
    return y


def test_unbounded_count_overflow_ladder():
    # ctrl-derived n with no static bound: a guess of K = 2 makes the
    # overflow monitor fire, and the kernel rebuilds with K doubled past
    # the realised count (8 blocks: reps reaches 8) and replays
    prog = compile_plugin_source(UNBOUNDED_LADDER)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    1, segment_len=512, block_size=128,
                                    masked_loop_k=2, device="cpu")
    assert kern.sym.masked_loops
    assert kern.scalar_index[("mloop", "ovf")] not in kern.mirrored_slots()
    x = noise(1, 1024)
    y, carry = kern.render(x)
    assert kern.masked_loop_k >= 8
    assert float(carry[0][kern.scalar_index[("mloop", "ovf")]]) <= 0.0
    rep = compare_audio(native_render(prog, x, 128), y)
    assert rep.audio_passed, rep.summary()
    jprog = jax_compile(UNBOUNDED_LADDER)
    jkern = jax_specialize(jprog, jax_shadow(jprog).state, 1,
                           segment_len=512, block_size=128, masked_loop_k=2)
    yj, _ = jkern.render(x)
    assert kern.masked_loop_k == jkern.masked_loop_k
    d = float(np.max(np.abs(y.astype(np.float64) - np.asarray(yj, np.float64))))
    print(f"unbounded_count_overflow_ladder: K {kern.masked_loop_k}, "
          f"max |port - JAX| audio {d:.3e}")
    assert d <= JAX_EPS


@pytest.mark.parametrize("path", ["batch", "catalog"])
def test_batch_and_catalog_renders_climb_the_ladder(path, monkeypatch):
    # a guess of K = 2 (the env default a renderer takes) for a count that
    # reaches 8: BatchRenderer.render_files and catalog_stacked_render
    # rebuild with K doubled past it and replay, as the solo render does,
    # and never return the overflowed audio
    monkeypatch.setenv("ZORAK_MASKED_LOOP_K", "2")
    prog = compile_plugin_source(UNBOUNDED_LADDER)
    br = BatchRenderer(prog, segment_len=512, block_size=128, device="cpu")
    assert br.kernel.masked_loop_k == 2
    x = np.stack([noise(1, 1024), noise(1, 1024, seed=10)])
    if path == "batch":
        y = br.render_files(x)
        jy = JaxBatchRenderer(jax_compile(UNBOUNDED_LADDER), segment_len=512,
                              block_size=128).render_files(x)
    else:
        x = x[:1]
        outs, groups = catalog_stacked_render({"Ladder": br}, x[0])
        assert groups == 1
        y = outs["Ladder"][None]
        jprog = jax_compile(UNBOUNDED_LADDER)
        jy = jax_specialize(jprog, jax_shadow(jprog).state, 1,
                            segment_len=512, block_size=128,
                            masked_loop_k=2).render(x[0])[0][None]
    assert br.kernel.masked_loop_k >= 8
    solo = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    1, segment_len=512, block_size=128,
                                    masked_loop_k=2, device="cpu")
    for f in range(x.shape[0]):
        assert torch.equal(y[f], torch.from_numpy(solo.render(x[f])[0]))
        rep = compare_audio(native_render(prog, x[f], 128), y[f].numpy())
        assert rep.audio_passed, rep.summary()
    assert solo.masked_loop_k == br.kernel.masked_loop_k
    d = float(np.max(np.abs(y.numpy().astype(np.float64)
                            - np.asarray(jy, np.float64))))
    print(f"{path} ladder: K {br.kernel.masked_loop_k}, max |port - JAX| "
          f"audio {d:.3e}")
    assert d <= JAX_EPS


def test_k6_ops_run_in_their_profiler_range():
    # K6 (gate masks, prefix sums, cursor arithmetic, the gathers and the
    # gated scatter) runs inside K6_RANGE while a profiler runs, so that
    # the smoke reads its device time from the range: no range nests in
    # another, and none holds the gate's or the delays' own expressions
    # (abs, floor) or a recurrence
    from torch.profiler import ProfilerActivity, profile

    src = builtin_plugins.gated_fdn_tank(2)
    prog = compile_plugin_source(src)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    2, segment_len=1 << 17, device="cpu")
    x = noise(2, 2048, 0.25, seed=21)
    y_off = kern.render_device(x)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y_on = kern.render_device(x)[0]
    assert torch.equal(y_on, y_off)
    ranges = [e for e in prof.events() if e.name == K6_RANGE]
    assert len(ranges) >= 2 * 5

    def inside(e):
        for ch in e.cpu_children:
            yield ch
            yield from inside(ch)

    for r in ranges:
        names = {ch.name for ch in inside(r)}
        assert K6_RANGE not in names
        assert not {"aten::abs", "aten::floor"} & names, names
        assert not any("linrec" in n for n in names), names
    assert {"aten::cumsum", "aten::scatter_"} <= {
        ch.name for r in ranges for ch in inside(r)}


def python_render(prog, x, block):
    """The Python golden's render of x; returns (y, its state)."""
    gold = make_initialized_shadow(prog, 48000.0)
    y = np.zeros_like(x)
    for s in range(0, x.shape[1], block):
        e = min(s + block, x.shape[1])
        gold.process_block(x[:, s:e], y[:, s:e])
    return y, gold.state


def next_draws(rng, n=5):
    return [rng.gen_u32() for _ in range(n)]


def test_rand_in_branch_generator_state_after_a_render():
    # the generator after a gated render has advanced by the draws the
    # gate let through, as the golden's has
    src = RAND_IN_BRANCH
    x = (np.random.RandomState(5).randn(1, 1500) * 0.4).astype(np.float32)
    prog, kern, jkern = kernels_for(src, 1, segment_len=512)
    assert kern.rand_gated
    y_ref, gstate = python_render(prog, x, 512)
    y, carry = kern.render(x)
    assert compare_audio(y_ref, y).audio_passed
    st = make_initialized_shadow(prog).state
    kern.writeback(carry, st)
    used = int(carry[0][kern.scalar_index[("rand", "used")]])
    assert 0 < used < x.shape[1]
    _yj, jcarry = jkern.render(x)
    jprog = jax_compile(src)
    jst = jax_shadow(jprog).state
    jkern.writeback(jcarry, jst)
    want = next_draws(gstate.rng)
    assert next_draws(st.rng) == want == next_draws(jst.rng)


def test_rand_in_branch_streamed():
    # the generator rebases between resumed renders: only the draws a
    # render consumed advance it (one device read of `used` a resume)
    src = RAND_IN_BRANCH
    x = (np.random.RandomState(6).randn(1, 1400) * 0.4).astype(np.float32)
    prog, kern, jkern = kernels_for(src, 1, segment_len=512)
    y_ref = native_render(prog, x, 512)
    y1, carry = kern.render(x[:, :700])
    y2, carry = kern.render(x[:, 700:], carry)
    y = np.concatenate([y1, y2], axis=1)
    assert np.abs(y.astype(np.float64) - y_ref).max() <= 1e-5
    yj1, jcarry = jkern.render(x[:, :700])
    yj2, jcarry = jkern.render(x[:, 700:], jcarry)
    yj = np.concatenate([np.asarray(yj1), np.asarray(yj2)], axis=1)
    d = float(np.max(np.abs(y.astype(np.float64) - yj.astype(np.float64))))
    print(f"rand_in_branch_streamed: max |port - JAX| audio {d:.3e}")
    assert d <= JAX_EPS
    # the generator after the resumed render, against the golden's
    _y, gstate = python_render(prog, x, 512)
    st = make_initialized_shadow(prog).state
    kern.writeback(carry, st)
    jst = jax_shadow(jax_compile(src)).state
    jkern.writeback(jcarry, jst)
    want = next_draws(gstate.rng)
    assert next_draws(st.rng) == want == next_draws(jst.rng)


def test_int64_and_f64_prefix_sums_are_equal():
    # the port takes the gate prefix sums in int64, the reference in f64
    # (exact below 2^53): the two are equal, gate patterns long and short
    rng = np.random.default_rng(0)
    for n, p in ((1, 0.5), (17, 0.0), (4096, 1.0), (1 << 20, 0.3)):
        g = torch.from_numpy(rng.random((3, n)) < p)
        as_i64 = torch.cumsum(g.to(torch.int64), dim=1)
        as_f64 = torch.cumsum(g.to(torch.float64), dim=1)
        assert torch.equal(as_i64, as_f64.to(torch.int64))
        assert float(as_f64[:, -1].max()) == float(as_i64[:, -1].max())
