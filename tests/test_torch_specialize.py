"""The port's vectorizing specializer on the CPU against the JAX kernel and
the golden, on the synthetic plugins of tests/test_specialize.py that need
no catalog and no coupled @block.

Every case renders the same seeded numpy input three ways: the port's
kernel (CPU tensors: the linear recurrences take the doubling ladders,
the tap sums the plain fold), the JAX kernel, and the port's Python
golden.  Tolerances: audio within 1e-5 of the golden on f32-rounded
samples (the reference's contract); the port's f32 audio within 1e-9 of
the JAX render, or one f32 ulp of the sample where the two f64 values
straddle an f32 rounding boundary (XLA's CPU backend fuses a multiply
into the add that follows, the port keeps two roundings as the golden
does); the carried f64 scalars and rings within 1e-8 of JAX's.
"""
import numpy as np
import pytest
import torch

import __graft_entry__ as graft_entry
from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import SpecializeError as JaxSpecializeError
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins, convert
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import linrec_scan as LS
from zorak_tpu_torch.kernels import ring_taps as RT
from zorak_tpu_torch.kernels import scan_group as SG
from zorak_tpu_torch.lowering import SpecializeError, specialize_sample_kernel
from zorak_tpu_torch.verify import (
    compare_audio, make_initialized_shadow, null_test_plugin)

JAX_EPS = 1e-9      # the port's f32 audio against the JAX render's
CARRY_EPS = 1e-8    # carried scalars and rings against JAX's


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def host_compiler():
    try:
        return _build.find_host_compiler()
    except RuntimeError:
        return None


def noise(nch, n, scale=0.5, seed=3):
    return (np.random.RandomState(seed).randn(nch, n) * scale).astype(np.float32)


MULTI_WRITER = """@init
function idel(x, ds) instance(buf, pos) local(rp, o) (
  buf[pos] = x;
  rp = pos - ds;
  rp < 0 ? rp += 64;
  o = buf[rp];
  pos = (pos + 1) & 63;
  o;
);
@sample
a = d1.idel(spl0 * 0.9, 13);
b = d2.idel(spl0 - 0.2, 29);
spl0 = 0.5 * a + 0.25 * b;
"""

# name -> (source, input, kernel options, hold state to the golden too)
CASES = {
    "pure_gain": (
        "@init\ng = 0.5;\n@sample\nspl0 *= g;\nspl1 *= g;\n",
        noise(2, 3000), {}, True),
    "elementwise_math": (
        "@sample\nx = spl0;\n"
        "spl0 = sin(x) + 0.25*sqrt(abs(x)) - min(x, 0.3);\n"
        "spl1 = max(spl1, -0.2) + sign(x)*0.01;\n",
        noise(2, 2000), {}, False),
    "data_dependent_select": (
        "@sample\n"
        "spl0 > 0.5 ? spl0 = 0.5 : (spl0 < -0.5 ? spl0 = -0.5);\n"
        "spl1 = spl1 > 0 ? spl1*2 : spl1*0.5;\n",
        noise(2, 2000, scale=1.0), {}, True),
    "one_pole_recurrence": (
        "@init\na = 0.995;\n@sample\nz = (1-a)*spl0 + a*z;\nspl0 = z;\n",
        noise(1, 6000), {}, True),
    "time_varying_coefficient_recurrence": (
        "@sample\na = 0.9 + 0.05*min(abs(spl0), 1);\n"
        "z = (1-a)*spl0 + a*z;\nspl0 = z;\n",
        noise(1, 4000), {}, False),
    "induction_counter": (
        "@sample\nn += 1;\nspl0 = n;\n",
        np.zeros((1, 5000), dtype=np.float32), {}, True),
    "ring_buffer_delay": (
        "@init\nBUFLEN = 1024; MASK = BUFLEN - 1; d = 300;\n"
        "@sample\nbuf[w & MASK] = spl0;\n"
        "spl0 = 0.5*spl0 + 0.5*buf[(w - d) & MASK];\nw += 1;\n",
        noise(1, 5000), {"segment_len": 1536}, True),
    "ring_delay_crossing_segments": (
        "@init\nMASK = 255; d = 200;\n"
        "@sample\nbuf[w & MASK] = spl0;\nspl0 = buf[(w - d) & MASK];\n"
        "w += 1;\n",
        noise(1, 1000), {"segment_len": 128}, True),
    "unrolled_tap_loop": (
        "@init\ntap = 1000; g = 1100; buf = 0;\n"
        "i = 0;\nloop(8, tap[i] = 16 + i*7; g[i] = 0.1 + 0.05*i; i += 1;);\n"
        "MASK = 511;\n@sample\nbuf[w & MASK] = spl0;\nacc = 0;\ni = 0;\n"
        "loop(8, acc += g[i]*buf[(w - tap[i]) & MASK]; i += 1;);\n"
        "spl0 = acc;\nw += 1;\n",
        noise(1, 3000), {}, True),
    "mem_cell_accumulator": (
        "@sample\nmem[7] += spl0;\nspl0 = mem[7];\n",
        noise(1, 2000, scale=0.01), {}, False),
    "int_ops_on_series": (
        "@sample\nq = (spl0 * 1000) | 0;\n"
        "spl0 = (q & 15) / 16 + (q % 7) * 0.001;\n",
        noise(1, 2000), {}, True),
    "user_functions_inline": (
        "@init\nfunction clamp(x a b) ( x < a ? a : (x > b ? b : x) );\n"
        "function lp(x) instance(z) ( z = 0.9*z + 0.1*x; z );\n"
        "@sample\nspl0 = f.lp(clamp(spl0, -0.5, 0.5));\n",
        noise(1, 3000), {}, False),
    "countdown_while_vectorizes": (
        "@sample\ni = spl0*10;\nwhile (i > 0) ( i -= 1; );\nspl0 = i;\n",
        noise(1, 1200, scale=0.4, seed=31), {"segment_len": 512}, True),
    "block_counter_stream": (
        "@block\nc += 1;\n@sample\nspl0 = c;\n",
        np.zeros((1, 2048), dtype=np.float32),
        {"block_size": 256, "segment_len": 512}, True),
    "block_modulated_gain": (
        "@block\nphase += 0.1;\ng = 0.5 + 0.4*sin(phase);\n"
        "@sample\nspl0 *= g;\n",
        noise(1, 4096), {"block_size": 512, "segment_len": 1024}, True),
    "block_with_linrec_in_sample": (
        "@block\ntarget = (blk += 1) % 7;\n"
        "@sample\nz = 0.99*z + 0.01*target;\nspl0 = spl0 + z*0.1;\n",
        noise(1, 3000), {"block_size": 128, "segment_len": 1024}, False),
    "sliderchange_retriggers_slider_in_trajectory": (
        "@slider\nd = slider1 * 2;\n"
        "@block\nc += 1; c == 3 ? ( slider1 = 5; sliderchange(slider1); );\n"
        "@sample\nspl0 = d;\n",
        np.zeros((1, 2048), dtype=np.float32),
        {"block_size": 256, "segment_len": 512}, False),
    "delay_feedforward_through_ring_supported": (
        "@init\nMASK=255;\n"
        "@sample\nz = z*z*0.5 + spl0*0.1;\nbuf[w & MASK] = z;\n"
        "spl0 = buf[(w-10) & MASK];\nw += 1;\n",
        noise(1, 3000, scale=0.3), {}, False),
    "nonpow2_wrapped_counter_delay": (
        "@init\nM = 100;\n@sample\nbuf[p] = spl0;\n"
        "r = p - 37; r < 0 ? r += M;\nspl0 = 0.5*spl0 + buf[r];\n"
        "p += 1; p >= M ? p = 0;\n",
        noise(1, 6000), {"segment_len": 2048}, False),
    "wrap_by_subtract": (
        "@init\nM = 77;\n@sample\nbuf[p] = spl0;\n"
        "r = p - 11; r < 0 ? r += M;\nspl0 = buf[r];\n"
        "p += 1; p >= M ? p -= M;\n",
        noise(1, 5000), {"segment_len": 1024}, False),
    "masked_update_counter": (
        "@sample\nbuf[p] = spl0;\nq = p - 5; q < 0 ? q += 8;\n"
        "spl0 = buf[q];\np = (p + 1) & 7;\n",
        noise(1, 4000), {"segment_len": 512}, False),
    "slewed_dynamic_tap": (
        "@init\nMASK = 1023;\n@sample\nmem[w & MASK] = spl0;\n"
        "d += (200 - d) * 0.001;\ndi = floor(d + 0.5);\n"
        "spl0 = mem[(w - di) & MASK];\nw += 1;\n",
        noise(1, 6000), {"segment_len": 2048}, False),
    "every_sample_dynamic_write": (
        "@init\nTAB = 400;\n@sample\nTAB[p] = spl0;\n"
        "p += 1; p >= 100 ? p = 0;\nspl0 = 0.25 * spl0;\n",
        noise(1, 4000), {"segment_len": 1024}, True),
    "nonlinear_self_recurrence": (
        "@sample\nz = z*0.9 + z*z*0.01 + spl0*0.1;\nspl0 = z;\n",
        noise(1, 3000, scale=0.3), {}, False),
    "attack_release_envelope": (
        "@init\na_att = 0.6; a_rel = 0.999;\n@sample\nr = abs(spl0);\n"
        "env = r > env ? a_att*env + (1-a_att)*r : a_rel*env + (1-a_rel)*r;\n"
        "spl0 = env;\n",
        noise(1, 4000), {}, False),
    "mutually_recursive_pair": (
        "@sample\na2 = 0.95*b + 0.05*spl0;\nb = 0.9*a2 + 0.1*abs(spl0);\n"
        "spl0 = a2 - b;\n",
        noise(1, 2500), {}, False),
    "group_feeding_from_vectorized_delay": (
        "@init\nMASK = 511; d = 100;\n@sample\nbuf[w & MASK] = spl0;\n"
        "late = buf[(w - d) & MASK];\n"
        "pk = abs(late) > pk ? abs(late) : pk*0.995;\n"
        "spl0 = late * (1 - 0.5*pk);\nw += 1;\n",
        noise(1, 3000), {"segment_len": 1024}, True),
    "dead_reinit_guard_folds": (
        "@init\nlast = srate;\ng = 0.25;\n@sample\nsrate != last ? (\n"
        "  last = srate;\n"
        "  while (spl0 > 0) ( spl0 = spl0 * 0.5 - 1; );\n  g = 0.5;\n);\n"
        "spl0 = spl0 * g;\n",
        noise(1, 3000, scale=0.4), {"segment_len": 1024}, True),
    "two_writers_null": (
        MULTI_WRITER, noise(1, 2000, scale=0.4, seed=11),
        {"segment_len": 512}, True),
    "zero_delay_reads_own_write": (
        MULTI_WRITER.replace("13)", "0)"), noise(1, 1500, scale=0.4, seed=12),
        {"segment_len": 512}, True),
    "angle_wrap_null": (
        "@sample\na = spl0 * 1000;\nwhile (a > 180) ( a -= 360; );\n"
        "while (a < -180) ( a += 360; );\nspl0 = a / 360;\n",
        noise(1, 3000, scale=0.9, seed=21), {"segment_len": 1024}, True),
    "wrap_feeding_recurrence": (
        "@sample\nph += 0.37 + spl0;\nwhile (ph > 1) ( ph -= 2; );\n"
        "spl0 = ph * 0.5;\n",
        noise(1, 2500, scale=0.3, seed=22), {"segment_len": 1024}, True),
    "clamp_helper_param_mutation": (
        "@init\n"
        "function cl(v, lo, hi) ( v < lo ? v = lo; v > hi ? v = hi; v; );\n"
        "@sample\ne = 0.9*e + 0.1*abs(spl0);\ng = cl(e, 0.2, 1);\n"
        "spl0 = spl0 * (0.5 + 0.1*g);\n",
        noise(1, 3000), {}, True),
    "branch_assign_in_logical_and": (
        "@init\nfunction f(v) ( (v > 0.1) && (v = v * 2; 1); v; );\n"
        "@sample\ne = 0.9*e + 0.1*abs(spl0);\n"
        "spl0 = spl0 * (0.5 + 0.1*f(e));\n",
        noise(1, 3000), {}, True),
    "cond_expr_over_params": (
        "@init\nfunction pick(v, w) ( v > w ? v : w; );\n"
        "@sample\ne = 0.9*e + 0.1*abs(spl0);\n"
        "spl0 = spl0 * (0.5 + 0.1*pick(e, 0.3));\n",
        noise(1, 3000), {}, True),
    "ungated_rand_draws": (
        "@sample\nspl0 = spl0 + (rand(2) - 1) * 0.01;\n"
        "spl1 = spl1 * (0.5 + rand(1) * 0.1);\n",
        noise(2, 3000, seed=14), {"segment_len": 1024}, True),
    "cursor_value_as_signal": (
        "@init\nMASK = 127;\n@sample\npos = w & MASK;\nbuf[pos] = spl0;\n"
        "spl0 = buf[(w - 5) & MASK] + pos * 0.001;\nw += 1;\n",
        noise(1, 2000, seed=15), {"segment_len": 512}, True),
    # the delay network at catalog scale, crossing segments
    "wide_delay_network_192_taps": (
        builtin_plugins.wide_delay_network(192),
        noise(2, 5000, scale=0.25, seed=5), {"segment_len": 2048}, True),
    # the right ring written from the left tap sum: two tap launches
    "cross_fed_delay_network": (
        builtin_plugins.cross_fed_delay_network(16),
        noise(2, 5000, scale=0.25, seed=7), {"segment_len": 2048}, True),
    "wide_delay_network_long_delays_only": (
        builtin_plugins.wide_delay_network(24, buf=4096, max_delay=4000)
        .replace("32 + ((i*317) % 3968)", "700 + ((i*317) % 3000)"),
        noise(2, 3000, scale=0.25, seed=6), {"segment_len": 512}, True),
}

REJECTED = {
    "general_while_loop_rejected":
        "@sample\ni = spl0*10;\nwhile (i > 1) ( i = i * 0.25; );\nspl0 = i;\n",
    "delay_feedback_into_scan_group_rejected":
        "@init\nMASK=255;\n@sample\nd = buf[(w-10) & MASK];\n"
        "z = z*z*0.5 + spl0 + 0.3*d;\nbuf[w & MASK] = z;\n"
        "spl0 = d;\nw += 1;\n",
    "read_of_dyn_region_rejected":
        "@init\nTAB = 400;\n@sample\ncnt += 1;\n"
        "cnt >= 7 ? (TAB[w] = spl0; w += 1; w >= 16 ? w = 0; cnt = 0;);\n"
        "spl0 = TAB[3];\n",
    "live_guard_still_carries":
        "@init\nlast = 0;\ng = 0.25;\n@sample\nsrate != last ? (\n"
        "  last = srate;\n"
        "  while (spl0 > 0) ( spl0 = spl0 * 0.5 - 1; );\n  g = 0.5;\n);\n"
        "spl0 = spl0 * g;\n",
}


def kernels_for(src, nch, **opts):
    """The port's kernel (CPU) and the JAX kernel from one source text."""
    prog = compile_plugin_source(src)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    nch, device="cpu", **opts)
    jprog = jax_compile(src)
    jkern = jax_specialize(jprog, jax_shadow(jprog).state, nch, **opts)
    return prog, kern, jkern


def audio_excess(y, yj):
    """How far the port's f32 audio lies outside its tolerance against
    the JAX render (<= 0 means inside): JAX_EPS, or one f32 ulp."""
    yj = np.asarray(yj, np.float32)
    d = np.abs(y.astype(np.float64) - yj.astype(np.float64))
    return float(np.max(d - np.maximum(JAX_EPS, np.spacing(np.abs(yj))),
                        initial=-1.0))


def carry_delta(carry, jcarry):
    """Max |delta| over the carried scalars and rings, port against JAX."""
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
def test_port_matches_jax_and_golden(name):
    src, x, opts, hold_state = CASES[name]
    opts = {"segment_len": 4096, "block_size": 512, **opts}
    prog, kern, jkern = kernels_for(src, x.shape[0], **opts)
    assert kern.L == jkern.L and kern.carried_vars == jkern.carried_vars
    assert {k: p.kind for k, p in kern.plans.items()} == \
        {k: p.kind for k, p in jkern.plans.items()}
    y, carry = kern.render(x)
    yj, jcarry = jkern.render(x)
    assert y.dtype == np.float32 and y.shape == x.shape
    assert audio_excess(y, yj) <= 0.0, "port vs JAX render"
    assert carry_delta(carry, jcarry) <= CARRY_EPS
    rep = null_test_plugin(prog, x, device="cpu", compare_mem=hold_state,
                           **opts)
    assert rep.audio_passed, rep.summary()
    if hold_state:
        assert rep.passed, rep.summary()


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_rejected_in_both(name):
    src = REJECTED[name]
    prog = compile_plugin_source(src)
    with pytest.raises(SpecializeError):
        specialize_sample_kernel(prog, make_initialized_shadow(prog).state, 1,
                                 device="cpu")
    jprog = jax_compile(src)
    with pytest.raises(JaxSpecializeError):
        jax_specialize(jprog, jax_shadow(jprog).state, 1)


def test_coupled_block_is_refused_with_its_slice():
    # the JAX package runs this through its device @block compiler; the
    # port names the work that brings it and leaves it to the golden
    src = ("@sample\nacc += abs(spl0);\nspl0 *= g;\n"
           "@block\ng = 1/(1 + acc*0.001);\n")
    prog = compile_plugin_source(src)
    with pytest.raises(SpecializeError, match="slice 6"):
        specialize_sample_kernel(prog, make_initialized_shadow(prog).state, 1,
                                 device="cpu")


def test_gated_regime_is_refused_with_its_slice():
    # a decimated metering history: a gated cursor and a gated dynamic
    # write, which the JAX package plans with gate prefix sums
    src = ("@init\nHIST = 900;\n"
           "@sample\npeak = max(peak, abs(spl0));\ncnt += 1;\n"
           "cnt >= 37 ? (\n  HIST[wpos] = peak;\n"
           "  wpos += 1; wpos >= 50 ? wpos = 0;\n  cnt = 0; peak = 0;\n"
           ");\nspl0 = spl0 * 0.5;\n")
    prog = compile_plugin_source(src)
    with pytest.raises(SpecializeError, match="gated regime.*slice 5"):
        specialize_sample_kernel(prog, make_initialized_shadow(prog).state, 1,
                                 device="cpu")
    jprog = jax_compile(src)
    jkern = jax_specialize(jprog, jax_shadow(jprog).state, 1)
    assert any(p.kind == "gmodind" for p in jkern.plans.values())


@pytest.mark.parametrize("name", ["attack_release_envelope",
                                  "group_feeding_from_vectorized_delay",
                                  "mutually_recursive_pair",
                                  "nonlinear_self_recurrence"])
def test_scan_group_plans_are_accepted_off_the_cpu(name, monkeypatch):
    # a kernel for a CUDA device takes a sequential scan group (its level
    # becomes a generated CUDA kernel); the device check is stood in for,
    # since no card is here, so the kernel is planned but not run.  The
    # level as the CPU kernel lowers it prints to a source that a host
    # compiler accepts and that repeats the plain loop bit for bit.
    import zorak_tpu_torch.device as device_mod

    src, x, opts, _ = CASES[name]
    prog = compile_plugin_source(src)
    with monkeypatch.context() as m:
        m.setattr(device_mod, "resolve_device",
                  lambda device=None: torch.device("cuda"))
        kern = specialize_sample_kernel(
            prog, make_initialized_shadow(prog).state, x.shape[0])
    assert kern.device.type == "cuda"
    # the linear pair folds into one linear recurrence (`linrec_scan`'s);
    # the other three keep a sequential scan group
    assert bool(kern.scan_groups) == (name != "mutually_recursive_pair")
    cpu = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                   x.shape[0], device="cpu", **opts)
    assert cpu.scan_groups == kern.scan_groups
    assert sorted(cpu.scan_level_programs()) == sorted(set(
        cpu.scan_levels.get(i, 0) for i in range(len(cpu.scan_groups))))
    if not host_compiler():
        pytest.skip("no host C++ compiler for the generated source")
    rng = np.random.RandomState(7)
    for _keys, externals, program, _idx in cpu.scan_level_programs().values():
        assert "scan_group_launch" in program.source
        xs = torch.from_numpy(rng.randn(257, len(externals)) * 0.5)
        c0 = torch.from_numpy(rng.uniform(0.1, 0.9, program.n_carry))
        got = SG.scan_group_host(program, xs, c0)
        ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
        assert torch.equal(got.view(torch.int64), ref.view(torch.int64))


def test_fallback_source_is_the_entry_scripts():
    assert builtin_plugins.FALLBACK_SRC == graft_entry._FALLBACK_SRC


def test_fallback_network_matches_jax_exactly_and_shares_its_divergence():
    # the in-repo text leaves dT and gT unset: both tap tables alias
    # mem[0..15], inside the left ring, so the golden reads audio where
    # the planner folded constants.  The JAX package differs from its
    # golden by the same amount; the port is held to the JAX render.
    x = noise(2, 5000, scale=0.25, seed=0)
    prog, kern, jkern = kernels_for(builtin_plugins.FALLBACK_SRC, 2,
                                    segment_len=2048)
    y, carry = kern.render(x)
    yj, jcarry = jkern.render(x)
    assert audio_excess(y, yj) <= 0.0
    assert carry_delta(carry, jcarry) <= CARRY_EPS
    rep = null_test_plugin(prog, x, device="cpu", segment_len=2048)
    gold = jax_shadow(jax_compile(builtin_plugins.FALLBACK_SRC))
    y_gold = np.zeros_like(x)
    for s in range(0, x.shape[1], 512):
        gold.process_block(x[:, s:s + 512], y_gold[:, s:s + 512])
    rep_jax = compare_audio(y_gold, np.asarray(yj))
    assert not rep_jax.audio_passed            # the reference's own miss
    assert abs(rep.max_abs_delta - rep_jax.max_abs_delta) <= 1e-6


@pytest.mark.parametrize("src,launches", [
    pytest.param(builtin_plugins.FALLBACK_SRC, [(16, 16)], id="16"),
    pytest.param(builtin_plugins.wide_delay_network(192), [(192, 192)],
                 id="192"),
    pytest.param(builtin_plugins.cross_fed_delay_network(16), [(16,), (16,)],
                 id="cross_fed")])
def test_tap_sums_and_recurrences_go_through_the_wrappers(src, launches,
                                                           monkeypatch):
    # the emitter hands the tap chains to ring_tap_sum, one call a segment
    # holding both channels' chains (the cross-fed network: one call a
    # channel, since its right ring is written from the left sum), the
    # rings in place, and the one-pole wave to linrec_scan (one call a
    # segment), and the result equals the node-by-node emission bit for bit
    x = noise(2, 2048 * 2 + 300, scale=0.25, seed=9)
    prog = compile_plugin_source(src)
    calls = {"taps": [], "linrec": []}
    import zorak_tpu_torch.kernels.linrec_scan as ls_mod
    import zorak_tpu_torch.kernels.ring_taps as rt_mod
    plain_taps, plain_linrec = rt_mod.ring_tap_sum, ls_mod.linrec_scan

    def spy_taps(tables, rings, cursors, streams, inits, length):
        # the rings themselves, not a [history | stream] buffer: one row
        # a file, here the solo render's one
        assert all(r.shape in ((1, 4096), (1, 16384)) for r in rings)
        calls["taps"].append(tuple(tables.counts))
        return plain_taps(tables, rings, cursors, streams, inits, length)

    def spy_linrec(a, b, z0):
        calls["linrec"].append(tuple(b.shape))
        return plain_linrec(a, b, z0)

    monkeypatch.setattr(rt_mod, "ring_tap_sum", spy_taps)
    monkeypatch.setattr(ls_mod, "linrec_scan", spy_linrec)
    kern = specialize_sample_kernel(
        prog, make_initialized_shadow(prog).state, 2, segment_len=2048,
        device="cpu")
    y, _ = kern.render(x)
    assert calls["taps"] == launches * 3          # 3 segments
    assert calls["linrec"] == [(2, 2048), (2, 2048), (2, 300)]

    # node by node: no chain is recognised when a chain needs more taps
    # than the plugin has
    monkeypatch.setattr(rt_mod, "ring_tap_sum", None)
    kern2 = specialize_sample_kernel(
        prog, make_initialized_shadow(prog).state, 2, segment_len=2048,
        device="cpu")
    monkeypatch.setattr(kern2, "MIN_CHAIN_TAPS", 10 ** 9)
    y2, _ = kern2.render(x)
    assert np.array_equal(y.view(np.int32), y2.view(np.int32))


def test_resumed_renders_continue_like_jax_and_the_golden():
    # @block state (counters/LFOs) persists across separate render calls
    src = ("@init\ng = 0;\n@block\nbc += 1;\ng = 0.5 + 0.4 * sin(bc * 0.1);\n"
           "@sample\nspl0 *= g;\n")
    x = noise(1, 2048)
    xx = np.concatenate([x, x, x], axis=1)
    prog, kern, jkern = kernels_for(src, 1, segment_len=2048, block_size=512)
    gold = make_initialized_shadow(prog)
    y_ref = np.zeros_like(xx)
    for s in range(0, xx.shape[1], 512):
        gold.process_block(xx[:, s:s + 512], y_ref[:, s:s + 512])
    ys, c, jc = [], None, None
    for _ in range(3):
        y, c = kern.render(x, carry=c)
        yj, jc = jkern.render(x, carry=jc)
        assert audio_excess(y, yj) <= 0.0
        ys.append(y)
    assert np.abs(np.concatenate(ys, axis=1) - y_ref).max() == 0.0
    snap = make_initialized_shadow(prog)
    kern.writeback(c, snap.state)
    assert snap.state.V.get("bc") == gold.state.V.get("bc")


@pytest.mark.parametrize("segment_len", [512, 2048])
def test_resumed_ring_render_from_a_converted_jax_carry(segment_len):
    # a render cut in two: JAX renders the first part, its carry crosses
    # over as numpy, and both packages continue identically
    src = builtin_plugins.wide_delay_network(48, buf=4096, max_delay=3000)
    x = noise(2, 6000, scale=0.25, seed=17)
    prog, kern, jkern = kernels_for(src, 2, segment_len=segment_len)
    y_whole, c_whole = kern.render(x)
    _, jc = jkern.render(x[:, :3500])
    carry = convert.carry_from_numpy(
        kern, np.asarray(jc[0]), {r: np.asarray(a) for r, a in jc[1].items()})
    y2, c2 = kern.render(x[:, 3500:], carry=carry)
    yj2, jc2 = jkern.render(x[:, 3500:], carry=jc)
    assert audio_excess(y2, yj2) <= 0.0
    assert audio_excess(y2, y_whole[:, 3500:]) <= 0.0
    assert carry_delta(c2, jc2) <= CARRY_EPS
    assert carry_delta(c2, (c_whole[0].numpy(),
                            {r: a.numpy() for r, a in c_whole[1].items()})) \
        <= CARRY_EPS


def test_wrappers_counted_nothing_on_the_cpu():
    # a launch count moves only where a kernel is launched
    assert LS.LAUNCHES == 0 and RT.LAUNCHES == 0 and SG.LAUNCHES == 0
