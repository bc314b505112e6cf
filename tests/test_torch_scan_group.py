"""Sequential scan groups of the port: the generated kernel text, its
operations and its plain Python loop, on the CPU.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it to
the plain loop there).  Here the same generated source is compiled in its
host form with a host C++ compiler (`-O2 -ffp-contract=off`) and run
through ctypes, which shows that the text repeats the plain loop:

* bit for bit, transcendentals included (both sides call glibc here),
  every NaN counted as one value (no EEL2 operation reads a NaN's sign or
  payload, and Python hands out its own NaN where C's libm makes one);
* where the scalar and the vector EEL2 tables differ (`floor`/`ceil` of a
  value in (-1, 0], `%` with the left operand at INT32_MIN) the text
  follows the scalar tables, as the plain loop and the golden do, and the
  JAX render, which evaluates its scan body with the vector tables,
  differs by the amount stated in the test.

The scan-group plugins then render three ways (port on the CPU, JAX
kernel, golden) from a non-zero start carry that crosses over as numpy:
audio within one f32 ulp of the JAX render (or 1e-9), carries within 1e-8,
the golden within 1e-5 on f32 audio.
"""
import difflib
import math
import struct

import numpy as np
import pytest
import torch

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import convert
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import scan_group as SG
from zorak_tpu_torch.lowering import scan_codegen as CG
from zorak_tpu_torch.lowering import specialize_sample_kernel
from zorak_tpu_torch.lowering.specialize import (
    _SC_BINARY, _SC_UNARY, _norm_loop)
from zorak_tpu_torch.semantics import scalar as SC
from zorak_tpu_torch.verify import compare_audio, make_initialized_shadow

JAX_EPS = 1e-9      # the port's f32 audio against the JAX render's
CARRY_EPS = 1e-8    # carried scalars and rings against JAX's


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def host_cxx():
    try:
        return _build.find_host_compiler()
    except RuntimeError:
        pytest.skip("no host C++ compiler for the generated source")


# name -> (source, channels)
BODIES = {
    "attack_release_envelope": (
        "@init\na_att = 0.6; a_rel = 0.999;\n@sample\nr = abs(spl0);\n"
        "env = r > env ? a_att*env + (1-a_att)*r : a_rel*env + (1-a_rel)*r;\n"
        "spl0 = env;\n", 1),
    # tests/test_torch_specialize.py's mutually_recursive_pair is linear
    # and folds into one linear recurrence; this pair does not
    "coupled_pair": (
        "@sample\nx = abs(spl0);\n"
        "fast = x > slow ? x : fast*0.9 + slow*0.1;\n"
        "slow = fast > slow ? slow + (fast - slow)*0.01 : slow*0.9995;\n"
        "spl0 = fast - slow;\n", 1),
    "nonlinear_self_recurrence": (
        "@sample\nz = z*0.9 + z*z*0.01 + spl0*0.1;\nspl0 = z;\n", 1),
    "group_feeding_from_vectorized_delay": (
        "@init\nMASK = 511; d = 100;\n@sample\nbuf[w & MASK] = spl0;\n"
        "late = buf[(w - d) & MASK];\n"
        "pk = abs(late) > pk ? abs(late) : pk*0.995;\n"
        "spl0 = late * (1 - 0.5*pk);\nw += 1;\n", 1),
    "wrap_feeding_recurrence": (
        "@sample\nph += 0.37 + spl0;\nwhile (ph > 1) ( ph -= 2; );\n"
        "spl0 = ph * 0.5;\n", 1),
    "transcendental_in_the_loop": (
        "@sample\nz = sin(z*0.9 + spl0);\nspl0 = z;\n", 1),
    "stereo_envelopes": (
        "@init\nup = 0.9; dn = 0.999;\n@sample\n"
        "x0 = abs(spl0); x1 = abs(spl1);\n"
        "e0 = x0 > e0 ? x0 + (e0 - x0)*up : x0 + (e0 - x0)*dn;\n"
        "e1 = x1 > e1 ? x1 + (e1 - x1)*up : x1 + (e1 - x1)*dn;\n"
        "spl0 = spl0*(1 - 0.5*e0); spl1 = spl1*(1 - 0.5*e1);\n", 2),
    "integer_ops_in_the_loop": (
        "@sample\nq = (z*1000 + spl0*4096) | 0;\n"
        "z = z*0.5 + (q & 250)/512 + ((q >> 3) % 7)*0.01 "
        "+ (q << 2)*0.0000001 + invsqrt(1 + abs(z))*0.01;\nspl0 = z;\n",
        1),
}

# floor and ceil of values in (-1, 0] and `%` at INT32_MIN, all inside the
# group: g = 1 + z*0 ties each operand to the carry without changing it
EDGE_SRC = """@sample
g = 1 + z*0;
k = ceil(spl1 * g);
f = floor(spl1 * g);
s = atan2(k, -1) + atan2(f, -1);
m = (spl0 * 2147483648 * g) % 7;
z = z*0.5 + s*0.01 + m*0.001;
spl0 = z;
"""


def port_kernel(src, nch, **opts):
    prog = compile_plugin_source(src)
    opts = {"segment_len": 1024, **opts}
    return prog, specialize_sample_kernel(
        prog, make_initialized_shadow(prog).state, nch, device="cpu", **opts)


def lowered_level(src, nch):
    """(externals, ScanGroupProgram) of the plugin's one scan level."""
    _prog, kern = port_kernel(src, nch)
    ((_keys, externals, program, _idx),) = kern.scan_level_programs().values()
    return externals, program


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns, every NaN counted as one value."""
    if a.shape != b.shape:
        return False
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    ai = torch.where(nan_a, torch.zeros_like(a), a).view(torch.int64)
    bi = torch.where(nan_b, torch.zeros_like(b), b).view(torch.int64)
    return bool(torch.equal(nan_a, nan_b) and torch.equal(ai, bi))


def seeded_inputs(program, n, seed, specials):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, program.n_ext) * 0.5
    if specials and n >= 7 and program.n_ext:
        xs[n // 3, 0] = -0.0
        xs[n // 2, -1] = np.nan        # NaN reaches the carry and stays
        xs[2, 0] = 0.0
    c0 = rng.uniform(0.1, 0.9, program.n_carry)        # non-zero start
    return torch.from_numpy(xs), torch.from_numpy(c0)


# (a) the generated body, host-compiled, against the plain loop -------------


@pytest.mark.parametrize("specials", [False, True],
                         ids=["noise", "nan_and_negzero"])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_generated_body_equals_the_plain_loop(name, specials, host_cxx):
    src, nch = BODIES[name]
    _externals, program = lowered_level(src, nch)
    assert program.transcendental == (name == "transcendental_in_the_loop")
    for n in (1, 7, 1500):
        xs, c0 = seeded_inputs(program, n, 11 + n, specials)
        got = SG.scan_group_host(program, xs, c0)
        ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
        assert ref.shape == (n, program.n_carry)
        assert same_values(got, ref), f"{name} L={n}"
        # the wrapper on CPU tensors is the plain loop, and counts nothing
        via = SG.scan_group(program, xs, c0)
        assert same_values(via, ref)
    assert SG.LAUNCHES == 0


def burst_into_silence(program, n, seed):
    """Noise, then exact zeros from a tenth of the way on: two followers
    started from other carries keep a fixed ratio and never meet."""
    xs, c0 = seeded_inputs(program, n, seed, False)
    xs[n // 10:] = 0.0
    return xs, c0


SPEC = {"chunk": 64, "warmup": 256}     # many chunks at a small L


@pytest.mark.parametrize("kind", ["noise", "nan_and_negzero",
                                  "burst_into_silence"])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_speculation_equals_the_plain_loop(name, kind, host_cxx):
    # the host form runs the kernels' two phases (speculate every chunk
    # from the start carries after a warm-up, then the bitwise fix-up),
    # one chunk after another: bit for bit the plain loop, whether the
    # body's walks meet or not, and on the call after a fallback too
    src, nch = BODIES[name]
    _externals, program = lowered_level(src, nch)
    n = 3001
    if kind == "burst_into_silence":
        xs, c0 = burst_into_silence(program, n, 5)
    else:
        xs, c0 = seeded_inputs(program, n, 5, kind == "nan_and_negzero")
    ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
    for _call in range(2):
        got = SG.scan_group_host(program, xs, c0, **SPEC)
        assert same_values(got, ref), f"{name} {kind} {program.host_last}"
    assert SG.LAUNCHES == 0


def test_chunks_rerun_and_the_flag_turns_speculation_off_for_one_call(
        host_cxx):
    n = 3001
    # the wrap never contracts: every chunk after the warm-up's reach is
    # walked again, more than half the samples, so the next call walks in
    # series, and the one after speculates again
    _e, wrap = lowered_level(*BODIES["wrap_feeding_recurrence"])
    xs, c0 = seeded_inputs(wrap, n, 8, False)
    seen = []
    for _call in range(4):
        SG.scan_group_host(wrap, xs, c0, **SPEC)
        seen.append(wrap.host_last)
    assert [s for s, _r in seen] == [True, False, True, False]
    assert seen[0][1] > n // 2 and seen[0][1] == seen[2][1]
    assert seen[1][1] == seen[3][1] == 0
    # a contracting body meets its speculated walk within the chunk: some
    # chunks re-run a few steps, and speculation stays on
    _e, nonlin = lowered_level(*BODIES["nonlinear_self_recurrence"])
    xs, c0 = seeded_inputs(nonlin, n, 8, False)
    ref = SG.scan_group_plain(nonlin.steps, nonlin.outs, xs, c0)
    for _call in range(3):
        assert same_values(
            SG.scan_group_host(nonlin, xs, c0, chunk=128, warmup=320), ref)
        speculated, reruns = nonlin.host_last
        assert speculated and 0 < reruns <= n // 2
    # a follower after a burst into silence: walks keep their ratio
    _e, env = lowered_level(*BODIES["attack_release_envelope"])
    xs, c0 = burst_into_silence(env, n, 8)
    SG.scan_group_host(env, xs, c0, **SPEC)
    assert env.host_last[0] and env.host_last[1] > n // 2
    # the flag is the program's: another program is not held back by it
    _e, env2 = lowered_level(*BODIES["attack_release_envelope"])
    SG.scan_group_host(env2, xs, c0, **SPEC)
    assert env2.host_last[0]


@pytest.mark.parametrize("n", [1, 7, 320, 321])
def test_a_short_segment_is_one_walk(n, host_cxx):
    # L <= warmup + chunk: no speculation, the walk in series from c0
    _e, program = lowered_level(*BODIES["coupled_pair"])
    xs, c0 = seeded_inputs(program, n, 3, True)
    ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
    got = SG.scan_group_host(program, xs, c0, **SPEC)
    assert same_values(got, ref)
    if n <= 320:
        assert program.host_last == (False, 0)
    else:
        assert program.host_last[0]
    assert SG.chunk_plan(n, 64, 256) == ((max(n, 1), 0, 1) if n <= 320
                                         else (64, 256, 6))


def test_the_speculate_kernel_stages_a_single_external_stream():
    # one stream: the warp's coalesced loads pass through a shared tile;
    # more: each thread loads its own in register blocks; the host form
    # is the same either way
    _e, one = lowered_level(*BODIES["nonlinear_self_recurrence"])
    _e, three = lowered_level(*BODIES["attack_release_envelope"])
    assert (one.n_ext, three.n_ext) == (1, 3)
    assert "extern __shared__" in one.source
    assert "extern __shared__" not in three.source
    forced = SG.ScanGroupProgram(three.steps, three.outs, three.n_ext,
                                 staged=True)
    assert "extern __shared__" in forced.source
    host = forced.source.split("#else")[1]
    assert host == three.source.split("#else")[1]


def test_chunk_plan():
    assert SG.chunk_plan(131072, SG.CHUNK, SG.WARMUP) == (1024, 16384, 128)
    assert SG.chunk_plan(SG.CHUNK + SG.WARMUP, SG.CHUNK, SG.WARMUP) == (
        SG.CHUNK + SG.WARMUP, 0, 1)
    # the warm-up never reaches back before t = 0 for every chunk
    assert SG.chunk_plan(1000, 100, 899) == (100, 899, 10)
    assert SG.chunk_plan(1000, 100, 950) == (1000, 0, 1)
    assert SG.chunk_plan(1051, 100, 950) == (100, 950, 11)
    for bad in ({"chunk": 0}, {"warmup": -1}, {"chunk": 1.5},
                {"chunk": True}):
        kw = {"chunk": 64, "warmup": 64, **bad}
        with pytest.raises(ValueError):
            SG.chunk_plan(100, kw["chunk"], kw["warmup"])


def test_components_split_independent_groups_only():
    _e, stereo = lowered_level(*BODIES["stereo_envelopes"])
    assert stereo.components == [[0], [1]] and stereo.n_ext == 2
    assert "ZS_COMPONENTS 2" in stereo.source
    assert "zs_walk_1" in stereo.source
    # a block each, for every file of a batch
    assert "<<<dim3(ZS_COMPONENTS, files), 1, 0," in stereo.source
    _e, pair = lowered_level(*BODIES["coupled_pair"])
    assert pair.components == [[0, 1]] and pair.n_carry == 2
    # steps shared between two carries, or a read of the other's value,
    # join them; a carry that is a constant stands alone
    steps = [("bin", "+", {}, [("p", 0), ("x", 0)]),
             ("bin", "*", {}, [("s", 0), ("c", 0.5)]),
             ("bin", "-", {}, [("s", 0), ("c", 1.0)])]
    assert CG.components(steps, [("s", 1), ("s", 2), ("c", 3.0)]) \
        == [[0, 1], [2]]
    assert CG.components(steps[:1], [("s", 0), ("p", 0), ("x", 0)]) \
        == [[0, 1], [2]]
    assert CG.block_rows(steps, [("s", 1), ("s", 2)]) == CG.MAX_UNROLL
    wide = [("bin", "+", {}, [("x", j), ("p", 0)]) for j in range(9)]
    wide_outs = [("s", j) for j in range(9)]
    assert CG.block_rows(wide, wide_outs) == 4 * CG.MAX_UNROLL // 9
    assert CG.block_rows(wide, wide_outs, unroll=32) == 4 * 32 // 9
    assert "#define ZS_U 8\n" in CG.emit_scan_source(
        steps, [("s", 1), ("s", 2)], 2, 1, unroll=8)


def test_the_chain_probe_is_in_the_source_only_when_asked_for():
    # a render's library holds the scan kernel alone; the timing probe is
    # the same text plus its own kernel and entry point
    _e, program = lowered_level(*BODIES["coupled_pair"])
    assert not program.probe
    assert "scan_group_launch" in program.source
    assert "zs_chain" not in program.source
    assert "scan_group_chain" not in program.source
    probed = SG.ScanGroupProgram(program.steps, program.outs, program.n_ext,
                                 probe=True)
    assert probed.probe and probed.block_rows == program.block_rows
    assert "zs_chain_kernel" in probed.source
    assert 'extern "C" int scan_group_chain(' in probed.source
    # the probe adds lines and changes none
    edits = difflib.SequenceMatcher(
        None, program.source.splitlines(), probed.source.splitlines(),
        autojunk=False).get_opcodes()
    assert {tag for tag, *_ in edits} == {"equal", "insert"}
    xc = torch.zeros(program.block_rows, program.n_ext, dtype=torch.float64)
    with pytest.raises(ValueError, match="without the probe"):
        SG.scan_group_chain_probe(program, xc, torch.zeros(2).double(), 64)


def test_a_level_is_lowered_once_for_a_kernels_life(monkeypatch):
    # the text is printed at the first segment and never again: two
    # segment lengths (full and remainder) and a second render share it
    src, nch = BODIES["attack_release_envelope"]
    _prog, kern = port_kernel(src, nch, segment_len=512)
    made = []
    plain_emit = CG.emit_scan_source

    def spy(*a, **kw):
        made.append(1)
        return plain_emit(*a, **kw)

    monkeypatch.setattr(CG, "emit_scan_source", spy)
    x = (np.random.RandomState(2).randn(1, 512 * 2 + 100) * 0.3).astype(
        np.float32)
    y1, _ = kern.render(x)
    y2, _ = kern.render(x)
    assert made == [1] and np.array_equal(y1, y2)
    # by (segment length, files): the solo render is one file
    assert sorted(kern._seg_fns) == [(100, 1), (512, 1)]


def test_the_start_carries_are_gathered_on_the_device(monkeypatch):
    # no segment reads a scan carry back to the host: the wrapper gets
    # svec[idx], and the host mirror leaves those entries unknown
    src, nch = BODIES["coupled_pair"]
    _prog, kern = port_kernel(src, nch, segment_len=256)
    seen = []
    plain = SG.scan_group

    def spy(program, xs, c0):
        seen.append(c0.clone())
        return plain(program, xs, c0)

    monkeypatch.setattr(SG, "scan_group", spy)
    x = (np.random.RandomState(4).randn(1, 768) * 0.3).astype(np.float32)
    _y, (svec, _rings) = kern.render(x)
    # one row a file: the solo render is one file
    assert len(seen) >= 2 and all(c.shape == (1, 2) for c in seen)
    assert torch.equal(seen[0], torch.zeros((1, 2), dtype=torch.float64))
    assert float(seen[1].abs().min()) > 0.0
    idx = [kern.scalar_index[k] for k in kern.scan_groups[0]]
    assert float(svec[idx].abs().min()) > 0.0


# (b) where the scalar and the vector tables differ --------------------------


def edge_audio(n=600, seed=9):
    rng = np.random.RandomState(seed)
    x = np.zeros((2, n), dtype=np.float32)
    x[0] = -1.0                              # spl0 * 2^31 = INT32_MIN
    x[0, ::5] = rng.uniform(-0.9, 0.9, len(x[0, ::5]))
    x[1] = rng.uniform(-0.999, -0.001, n)    # floor -1, ceil -0.0 in C
    x[1, ::4] = -0.0                         # floor(-0.0) is -0.0 in C
    x[1, ::7] = 0.25
    return x


def golden_state(prog, x):
    gold = make_initialized_shadow(prog)
    y = np.zeros_like(x)
    for s in range(0, x.shape[1], 200):
        gold.process_block(x[:, s:s + 200], y[:, s:s + 200])
    return gold.state, y


def test_edge_values_follow_the_scalar_tables(host_cxx, monkeypatch):
    # the level's inputs as a render of the edge audio hands them over
    _prog, kern = port_kernel(EDGE_SRC, 2)
    calls = []
    plain = SG.scan_group

    def spy(program, xs, c0):
        calls.append((program, xs.clone(), c0.clone()))
        return plain(program, xs, c0)

    monkeypatch.setattr(SG, "scan_group", spy)
    x = edge_audio()
    kern.render(x)
    program, xs, _c0 = calls[0]               # the first segment
    xs = xs[0]                                # of the solo render's file
    ops = {(k, o) for k, o, _m, _a in program.steps}
    assert {("call", "floor"), ("call", "ceil"), ("bin", "%"),
            ("bin", "atan2")} <= ops
    c0 = torch.tensor([0.375], dtype=torch.float64)
    got = SG.scan_group_host(program, xs, c0)
    ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
    assert same_values(got, ref)
    # the draws are really there: per sample, what the scalar tables give
    k = [SC.eel_ceil(float(v)) for v in x[1]]
    f = [SC.eel_floor(float(v)) for v in x[1]]
    assert any(v == 0.0 and math.copysign(1.0, v) > 0 and w < 0.0
               for v, w in zip(k, x[1]))                  # ceil(-0.5) = +0.0
    assert any(math.copysign(1.0, w) < 0 and w == 0.0
               and math.copysign(1.0, v) > 0
               for v, w in zip(f, x[1]))                  # floor(-0.0) = +0.0
    assert SC.eel_mod(-2147483648.0, 7.0) == -2.0
    assert SC.to_i32(-1.0 * 2147483648) == -(1 << 31)
    assert float((xs == -2147483648.0).sum()) > 100


@pytest.mark.parametrize("n", [150, 301, 600])
def test_edge_values_carry_like_the_golden_and_unlike_jax(n):
    x = edge_audio()[:, :n]
    prog, kern = port_kernel(EDGE_SRC, 2)
    y, (svec, _rings) = kern.render(x)
    z = float(svec[kern.scalar_index[("var", "z")]])
    state, y_gold = golden_state(prog, x)
    assert abs(z - state.V["z"]) <= CARRY_EPS
    # The JAX kernel evaluates the group with the vector tables: ceil(-0.5)
    # and floor(-0.0) keep their -0.0, so atan2(-0.0, -1) is -pi where the
    # scalar tables give +pi, and |INT32_MIN| overflows int32 in its `%`
    # (-2^31 % 7 gives -5 where C's srem and the golden give -2).  Through
    # this plugin's gains (0.01 and 0.001, the carry halving each sample)
    # its carry misses the golden's by up to
    # (2 * 2pi * 0.01 + 3 * 0.001) * 2 = 0.257; measured 0.136 to 0.195
    # at these three lengths (the port's carry: 0.0).
    jprog = jax_compile(EDGE_SRC)
    jkern = jax_specialize(jprog, jax_shadow(jprog).state, 2,
                           segment_len=1024)
    yj, (jsvec, _jr) = jkern.render(x)
    zj = float(np.asarray(jsvec)[jkern.scalar_index[("var", "z")]])
    assert 0.05 < abs(zj - state.V["z"]) < 0.26, abs(zj - state.V["z"])
    # Outside the group both packages emit `spl0 = z` as a stream over the
    # carry of the sample before, with the vector tables: the port's audio
    # then differs from the golden's where the tables differ, as the JAX
    # render's does (a known divergence of the reference's vector ops),
    # though each sample starts from the golden's own carry (measured
    # 0.129 for the port, 0.198 for the JAX render)
    d_port = float(np.max(np.abs(y[0] - y_gold[0])))
    d_jax = float(np.max(np.abs(np.asarray(yj[0]) - y_gold[0])))
    assert 0.05 < d_port < 0.26 and d_port <= d_jax + 1e-6, (d_port, d_jax)


# (c) each operation of csrc/scan_ops.cuh against semantics/scalar.py --------

EDGE_VALUES = [
    0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 0.3, -0.999, 2.5, -2.5, 3.0, 7.0, -7.0,
    31.0, 32.0, 33.0, -33.0, 255.75, 4.9e-324, -4.9e-324, 1e-310,
    2.2250738585072014e-308, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 1,
    2.0 ** 31 + 0.5, -(2.0 ** 31) - 1, 2.0 ** 32, 2.0 ** 32 + 5,
    -(2.0 ** 32) - 3, 2.0 ** 53, 2.0 ** 62, -(2.0 ** 62), 1.5 * 2.0 ** 62,
    -1.5 * 2.0 ** 62, 2.0 ** 63, -(2.0 ** 63), 1e300, -1e300, 3.5e38,
    float("inf"), float("-inf"), float("nan"),
]
BINARY_OPS = sorted(_SC_BINARY)
UNARY_OPS = sorted(_SC_UNARY)


@pytest.fixture(scope="module")
def op_tables(host_cxx):
    """Every binary op on every pair of edge values, every unary op on
    every value, one select: (names, host-compiled result, plain loop's)."""
    steps = [("bin", op, {}, [("x", 0), ("x", 1)]) for op in BINARY_OPS]
    steps += [("call", op, {}, [("x", 0)]) for op in UNARY_OPS]
    steps += [("select", None, {}, [("x", 0), ("x", 1), ("c", -3.25)])]
    names = [f"bin {op}" for op in BINARY_OPS] \
        + [f"call {op}" for op in UNARY_OPS] + ["select"]
    outs = [("s", i) for i in range(len(steps))]
    program = SG.ScanGroupProgram(steps, outs, 2)
    pairs = [(a, b) for a in EDGE_VALUES for b in EDGE_VALUES]
    xs = torch.tensor(pairs, dtype=torch.float64)
    c0 = torch.zeros(len(outs), dtype=torch.float64)
    got = SG.scan_group_host(program, xs, c0)
    ref = SG.scan_group_plain(steps, outs, xs, c0)
    return names, xs, got, ref


@pytest.mark.parametrize(
    "name", [f"bin {op}" for op in BINARY_OPS]
    + [f"call {op}" for op in UNARY_OPS] + ["select"])
def test_op_matches_the_scalar_contract(name, op_tables):
    names, xs, got, ref = op_tables
    i = names.index(name)
    bad = [(tuple(xs[r].tolist()), float(got[r, i]), float(ref[r, i]))
           for r in range(xs.shape[0])
           if not same_values(got[r:r + 1, i], ref[r:r + 1, i])]
    assert not bad, f"{name}: (operands, C, Python) {bad[:5]}"


def test_int_conversions_at_the_edges(host_cxx):
    # trunc_i64 saturates at +-2^62 and maps NaN and +-inf to 0; after the
    # wrap to int32 every value from 2^62 up is 0.  `x | 0` shows to_i32.
    steps = [("bin", "|", {}, [("x", 0), ("c", 0.0)])]
    program = SG.ScanGroupProgram(steps, [("s", 0)], 1)
    vals = [float("inf"), float("-inf"), float("nan"), 2.0 ** 62,
            2.0 ** 62 + 1024, 2.0 ** 63 - 1024, 2.0 ** 63, -(2.0 ** 62),
            -(2.0 ** 62) - 1024, 2.0 ** 62 - 512, 2.0 ** 31, 2.0 ** 32 + 7.9,
            -(2.0 ** 31) - 0.9, -0.9]
    xs = torch.tensor(vals, dtype=torch.float64)[:, None]
    got = SG.scan_group_host(program, xs, torch.zeros(1, dtype=torch.float64))
    want = [float(SC.to_i32(v)) for v in vals]
    assert got[:, 0].tolist() == want
    assert want[:9] == [0.0] * 9 and want[9] == -512.0 and want[10] == -(2.0 ** 31)


@pytest.mark.parametrize("op,limit,step", [(">", 1.0, -2.0), (">=", 180.0, -360.0),
                                          ("<", -180.0, 360.0), ("<=", 0.0, 0.1)])
def test_normloop_matches_the_golden_loop(op, limit, step, host_cxx):
    meta = {"op": op, "C": limit, "S": step}
    steps = [("bin", "+", {}, [("p", 0), ("x", 0)]),
             ("normloop", None, meta, [("s", 0)])]
    program = SG.ScanGroupProgram(steps, [("s", 1)], 1)
    rng = np.random.RandomState(3)
    x = rng.uniform(-40.0, 40.0, 400) * abs(step)
    x[5], x[9], x[13] = np.nan, limit, -0.0
    xs = torch.from_numpy(x)[:, None]
    c0 = torch.tensor([0.25], dtype=torch.float64)
    got = SG.scan_group_host(program, xs, c0)
    ref = SG.scan_group_plain(steps, [("s", 1)], xs, c0)
    assert same_values(got, ref)
    past = limit - 3 * step              # three steps on the looping side
    assert _norm_loop(past, meta) != past


# (d) constants round-trip -----------------------------------------------------

CONSTANTS = [0.1, 1e-300, -0.0, 0.0, float("nan"), float("inf"),
             float("-inf"), 4.9e-324, -2.2250738585072014e-308,
             1.7976931348623157e308, -2.5, 1.0 / 3.0,
             struct.unpack("<d", struct.pack("<Q", 0x7FF8000000000123))[0],
             struct.unpack("<d", struct.pack("<Q", 0xFFF0000000000001))[0]]


def bits(v: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", v))[0]


def test_constants_print_exactly():
    for v in CONSTANTS:
        text = CG.c_double(v)
        if "zt_from_bits" in text:
            assert int(text.split("(")[1].rstrip("ULL)"), 16) == bits(v)
        else:
            assert bits(float.fromhex(text.strip("()"))) == bits(v)


def test_constants_compile_to_the_same_bits(host_cxx):
    outs = [("c", v) for v in CONSTANTS]
    program = SG.ScanGroupProgram([], outs, 0)
    xs = torch.zeros((3, 0), dtype=torch.float64)
    c0 = torch.ones(len(outs), dtype=torch.float64)
    got = SG.scan_group_host(program, xs, c0)
    for row in got.view(torch.int64).tolist():
        assert [r & 0xFFFFFFFFFFFFFFFF for r in row] == [bits(v) for v in CONSTANTS]
    assert same_values(got, SG.scan_group_plain([], outs, xs, c0))


def test_unknown_operations_are_refused_in_the_text():
    with pytest.raises(ValueError, match="no C body"):
        CG.emit_scan_source([("bin", "**", {}, [("p", 0), ("p", 0)])],
                            [("s", 0)], 1, 0)
    with pytest.raises(ValueError, match="no C body"):
        CG.emit_scan_source([("ringref", None, {}, [])], [("s", 0)], 1, 0)
    with pytest.raises(ValueError, match="external 1 of 1"):
        CG.emit_scan_source([("call", "abs", {}, [("x", 1)])], [("s", 0)], 1, 1)
    with pytest.raises(ValueError):
        CG.emit_scan_source([], [("c", 1.0)], 2, 0)


# (e) where a generated kernel is built ----------------------------------------


def test_generated_build_is_named_by_text_and_flags(monkeypatch):
    _e, program = lowered_level(*BODIES["attack_release_envelope"])
    cu, lib = _build.generated_paths(program.source)
    assert cu.parent == lib.parent == _build.BUILD_DIR
    assert cu.name.startswith("gen-") and cu.suffix == ".cu"
    assert lib.name == f"lib{cu.stem}.so" and len(cu.stem) == 4 + 16
    assert _build.generated_paths(program.source) == (cu, lib)
    assert _build.generated_paths(program.source + "\n")[0] != cu
    assert "--fmad=false" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        tuple(f for f in _build.NVCC_FLAGS
                              if f != "--fmad=false"))
    assert _build.generated_paths(program.source)[0] != cu


def test_a_failed_build_is_not_a_specialize_error():
    # the engine turns a SpecializeError into a render by the golden; a
    # kernel that does not build must surface instead
    from zorak_tpu_torch.lowering import SpecializeError

    assert not issubclass(RuntimeError, SpecializeError)
    with pytest.raises(RuntimeError):
        _build.load_generated("this is not CUDA C++ (")
    with pytest.raises(RuntimeError, match="host build"):
        _build.load_generated_host("this is not C++ (")


def test_plugin_instance_takes_a_scan_group_plan_for_the_card(monkeypatch):
    # the device check is stood in for, since no card is here: the engine
    # plans the plugin for CUDA, keeps the vector engine and records no
    # refusal (it used to render such a plugin through the golden)
    import zorak_tpu_torch.device as device_mod
    import zorak_tpu_torch.runtime.engine as engine_mod

    for mod in (device_mod, engine_mod):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda device=None: torch.device("cuda"))
    for name in ("attack_release_envelope", "stereo_envelopes"):
        src, _nch = BODIES[name]
        inst = engine_mod.PluginInstance(compile_plugin_source(src))
        assert inst.engine == "torch-vector" and inst.spec_error is None
        assert inst.kernel.device.type == "cuda" and inst.kernel.scan_groups


# (f) three ways from a non-zero start carry -----------------------------------

RESUMED = {
    "attack_release_envelope": BODIES["attack_release_envelope"][0],
    "coupled_pair": BODIES["coupled_pair"][0],
    "group_feeding_from_vectorized_delay":
        BODIES["group_feeding_from_vectorized_delay"][0],
    "mutually_recursive_pair":
        "@sample\na2 = 0.95*b + 0.05*spl0;\nb = 0.9*a2 + 0.1*abs(spl0);\n"
        "spl0 = a2 - b;\n",
    "nonlinear_self_recurrence": BODIES["nonlinear_self_recurrence"][0],
    "wrap_feeding_recurrence": BODIES["wrap_feeding_recurrence"][0],
}


def audio_excess(y, yj):
    """How far the port's f32 audio lies outside its tolerance against
    the JAX render (<= 0 means inside): JAX_EPS, or one f32 ulp."""
    yj = np.asarray(yj, np.float32)
    d = np.abs(y.astype(np.float64) - yj.astype(np.float64))
    return float(np.max(d - np.maximum(JAX_EPS, np.spacing(np.abs(yj))),
                        initial=-1.0))


@pytest.mark.parametrize("name", sorted(RESUMED))
def test_resumed_from_a_converted_jax_carry_three_ways(name):
    src = RESUMED[name]
    x = (np.random.RandomState(23).randn(1, 3000) * 0.3).astype(np.float32)
    cut = 1300
    prog, kern = port_kernel(src, 1, segment_len=1024)
    jprog = jax_compile(src)
    jkern = jax_specialize(jprog, jax_shadow(jprog).state, 1,
                           segment_len=1024)
    assert kern.scan_groups == jkern.scan_groups
    assert bool(kern.scan_groups) == (name != "mutually_recursive_pair")
    # JAX renders the first part; its carry crosses over as numpy
    _, jc = jkern.render(x[:, :cut])
    jsvec = np.asarray(jc[0])
    carry = convert.carry_from_numpy(
        kern, jsvec, {r: np.asarray(a) for r, a in jc[1].items()})
    for g in (k for grp in kern.scan_groups for k in grp):
        assert jsvec[kern.scalar_index[g]] != 0.0      # a non-zero start
    y2, c2 = kern.render(x[:, cut:], carry=carry)
    yj2, jc2 = jkern.render(x[:, cut:], carry=jc)
    assert audio_excess(y2, yj2) <= 0.0
    assert float(np.max(np.abs(c2[0].numpy() - np.asarray(jc2[0])))) \
        <= CARRY_EPS
    for region, arr in c2[1].items():
        assert float(np.max(np.abs(
            arr.numpy() - np.asarray(jc2[1][region])))) <= CARRY_EPS
    # the golden, started from the same carry
    gold = make_initialized_shadow(prog)
    kern.writeback(carry, gold.state)
    y_gold = np.zeros_like(x[:, cut:])
    for s in range(0, y_gold.shape[1], 512):
        gold.process_block(x[:, cut + s:cut + s + 512], y_gold[:, s:s + 512])
    rep = compare_audio(y_gold, y2)
    assert rep.audio_passed, rep.summary()


@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("name", ["attack_release_envelope",
                                  "stereo_envelopes",
                                  "group_feeding_from_vectorized_delay"])
def test_files_walk_as_each_would_alone(name, nf, host_cxx):
    # a batch of files (xs [nf, L, n_ext], c0 [nf, n]): other data and
    # start carries a file, NaN and -0.0 in the second, and the last
    # bursting into silence, so that its fix-up walks again and marks its
    # own flag; every file equals its solo call and the plain loop bit for
    # bit, the re-run steps sum over the files, the flags are the solo
    # calls' flags, and on the next call only the marked file walks in
    # series
    src, nch = BODIES[name]
    _e, program = lowered_level(src, nch)
    n = 3001
    parts = [burst_into_silence(program, n, 40 + f) if f == nf - 1
             else seeded_inputs(program, n, 40 + f, f == 1)
             for f in range(nf)]
    xs = torch.stack([x for x, _c in parts])
    c0 = torch.stack([c for _x, c in parts])
    ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
    assert ref.shape == (nf, n, program.n_carry)
    solo_reruns, solo_marks = 0, []
    for f, (x, c) in enumerate(parts):
        assert same_values(ref[f], SG.scan_group_plain(
            program.steps, program.outs, x, c))
        _e, alone = lowered_level(src, nch)
        assert same_values(SG.scan_group_host(alone, x, c, **SPEC), ref[f])
        solo_reruns += alone.host_last[1]
        solo_marks += alone.host_marks
    got = SG.scan_group_host(program, xs, c0, **SPEC)
    assert same_values(got, ref)
    assert program.host_last == (nf, solo_reruns)
    assert program.host_marks == solo_marks
    if name == "group_feeding_from_vectorized_delay":
        # the peak hold meets its speculated walk on noise at once; only
        # the silent file re-walks, and only it walks in series next
        assert solo_marks == [-1] * (nf - 1) + [1]
    got = SG.scan_group_host(program, xs, c0, **SPEC)
    assert same_values(got, ref)
    assert program.host_last[0] == nf - solo_marks.count(1)
    assert SG.LAUNCHES == 0
