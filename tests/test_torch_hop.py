"""The hop pipeline of the port's specializer on the CPU: FFT block work
fired every N samples from inside @sample, extracted as the device section
"sample-hop" and run by K10 after each hop's segment (`_hop_run`), against
the JAX kernel and the native golden.

The four cases of tests/test_hop.py that need no catalog render the same
seeded numpy input three ways: the port's kernel (CPU tensors, K10's
plain version `block_section_plain` between segments), the JAX kernel and
the native C golden.  Bounds, the JAX tests': exactly 0.0 against the
golden where they assert equality, 1e-9 for the case with gated rand();
the vars and heap within 1e-8 (the null contract); against the JAX render
the audio within the same bound, the carry within 1e-8.  Each case prints
its largest difference from the JAX render (`pytest -s`).  The hop
section of the convolver stand-in goes through K10's host form (g++)
with 1, 3 and 128 threads in both orders (its phases: the body of
process() printed in place), bit for bit to the one-thread form, and
that form within FFT_TOL_REL of the plain version.
"""
import json

import numpy as np
import pytest
import torch

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.parallel import build_catalog_renderers as jax_build
from zorak_tpu.parallel import catalog_stacked_render as jax_stacked
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins, convert
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import block_section as BS
from zorak_tpu_torch.lowering import specialize_sample_kernel
from zorak_tpu_torch.parallel import (
    BatchRenderer, build_catalog_renderers, catalog_stacked_render)
from zorak_tpu_torch.shadow import compile_native_shadow
from zorak_tpu_torch.verify import make_initialized_shadow, null_test_plugin
from zorak_tpu_torch.verify.nulltest import apply_slider_state

STATE_TOL = 1e-8


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


# tests/test_hop.py
HOP_SRC = """@init
H = 64;
INBUF = 0;
OUTBUF = 256;
ctr = 0;
rpos = 0;
function do_hop() local(i) (
  i = 0;
  while (i < H) (
    OUTBUF[i] = INBUF[i] * 0.5 + 0.1;
    i += 1;
  );
  hops += 1;
);
@sample
y = OUTBUF[rpos];
INBUF[ctr] = spl0;
spl0 = y + spl0 * 0.25;
rpos += 1;
rpos >= H ? rpos = 0;
ctr += 1;
ctr >= H ? (
  do_hop();
  ctr = 0;
);
"""

GATED_RAND_HOP_SRC = """@init
H = 32;
BUF = 0;
OUT = 64;
ctr = 0;
rp = 0;
function work() local(i) (
  i = 0;
  while (i < H) ( OUT[i] = BUF[i] * 0.25; i += 1; );
);
@sample
y = OUT[rp];
BUF[ctr] = spl0;
spl0 > 0.5 ? ( nz = rand(1) * 0.01; ) : ( nz = 0; );
spl0 = y + nz;
rp += 1;
rp >= H ? rp = 0;
ctr += 1;
ctr >= H ? ( work(); ctr = 0; );
"""

MULTIWRITER_HOP_SRC = """@init
H = 16;
BUF = 0;
OUT = 32;
ctr = 0;
rp = 0;
function put(x) instance(dummy) ( BUF[ctr] = x; );
function work() local(i) (
  i = 0;
  while (i < H) ( OUT[i] = BUF[i] * 0.5; i += 1; );
);
@sample
y = OUT[rp];
a.put(spl0 * 2);
b.put(spl0);
spl0 = y;
rp += 1;
rp >= H ? rp = 0;
ctr += 1;
ctr >= H ? ( work(); ctr = 0; );
"""


def noise(nch, n, scale=0.4, seed=3):
    return (np.random.RandomState(seed).randn(nch, n) * scale).astype(
        np.float32)


# name -> (source, input, segment length, block, audio bound against the
# golden and the JAX render)
CASES = {
    "synthetic_hop_null": (HOP_SRC, noise(1, 1000, seed=3), 512, 32, 0.0),
    "hop_with_gated_rand": (GATED_RAND_HOP_SRC, noise(1, 800, 0.6, seed=41),
                            256, 32, 1e-9),
    "hop_reads_multiwriter_ring": (MULTIWRITER_HOP_SRC,
                                   noise(1, 400, seed=43), 128, 16, 0.0),
    # the stand-in at a small width: 8 hops of 128 samples, 4 partitions
    "hop_convolver_small": (builtin_plugins.hop_convolver(128, 4),
                            noise(2, 1100, 0.3, seed=44), 512, 32, 0.0),
}


def kernels_for(src, nch, seg, block):
    prog = compile_plugin_source(src)
    state = make_initialized_shadow(prog).state
    kern = specialize_sample_kernel(prog, state, nch, segment_len=seg,
                                    block_size=block, device="cpu")
    jprog = jax_compile(src)
    jstate = jax_shadow(jprog).state
    jkern = jax_specialize(jprog, jstate, nch, segment_len=seg,
                           block_size=block)
    return prog, (kern, state), (jkern, jstate)


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


def carry_delta(carry, jcarry):
    """Largest |port - JAX| over the sample side, the hop's vars and the
    port's heap (the head of the JAX one)."""
    (svec, rings), hv, hm = carry
    (jsvec, jrings), jhv, jhm = jcarry
    assert sorted(rings) == sorted(jrings)
    worst = float(np.max(np.abs(svec.numpy() - np.asarray(jsvec)),
                         initial=0.0))
    for r, a in rings.items():
        worst = max(worst, float(np.max(np.abs(
            a.numpy() - np.asarray(jrings[r])), initial=0.0)))
    worst = max(worst, float(np.max(np.abs(hv.numpy() - np.asarray(jhv)),
                                    initial=0.0)))
    n = hm.shape[0]
    return max(worst, float(np.max(np.abs(
        hm.numpy() - np.asarray(jhm)[:n]), initial=0.0)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_hop_port_matches_jax_and_golden(name):
    src, x, seg, block, bound = CASES[name]
    prog, (kern, state), (jkern, _js) = kernels_for(src, x.shape[0], seg,
                                                     block)
    assert kern._hop is not None and jkern._hop is not None
    assert kern._hop_len == jkern._hop_len
    assert kern.carried_vars == jkern.carried_vars
    assert kern._hop.slots == jkern._hop.slots
    assert kern.rand_gated == jkern.rand_gated == (name == "hop_with_gated_rand")
    y_ref = native_render(prog, x, block)
    y, carry = kern.render(x)
    yj, jcarry = jkern.render(x)
    assert y.dtype == np.float32 and y.shape == x.shape
    assert np.abs(y.astype(np.float64) - y_ref).max() <= bound
    d = float(np.max(np.abs(y.astype(np.float64)
                            - np.asarray(yj, np.float64))))
    dc = carry_delta(carry, jcarry)
    print(f"{name}: max |port - JAX| audio {d:.3e}, carry {dc:.3e}")
    assert d <= bound and dc <= STATE_TOL
    rep = null_test_plugin(prog, x, segment_len=seg, block_size=block,
                           golden="native", compare_state=True,
                           compare_mem=True, device="cpu")
    assert rep.passed, rep.summary()


def test_synthetic_hop_counts_its_hops(monkeypatch):
    # state parity including the hop's own counter, and K10 once a hop
    src, x, seg, block, _ = CASES["synthetic_hop_null"]
    prog = compile_plugin_source(src)
    state = make_initialized_shadow(prog).state
    kern = specialize_sample_kernel(prog, state, 1, segment_len=seg,
                                    block_size=block, device="cpu")
    calls = []
    plain = BS.block_section_plain

    def spy(*a, **k):
        calls.append(a[5])          # samplesblock: the kernel's B
        return plain(*a, **k)

    monkeypatch.setattr(BS, "block_section_plain", spy)
    _y, carry = kern.render(x)
    monkeypatch.setattr(BS, "block_section_plain", plain)
    assert calls == [float(block)] * (1000 // 64)
    kern.writeback(carry, state)
    assert state.V["hops"] == float(1000 // 64)
    assert BS.LAUNCHES == 0          # the plain version is no launch


def test_hop_streaming_resume():
    # a resumed render segments from the counter's phase (300 % 64 != 0)
    prog = compile_plugin_source(HOP_SRC)
    x = noise(1, 700, seed=5)
    y_ref = native_render(prog, x, 32)
    _p, (kern, _s), (jkern, _js) = kernels_for(HOP_SRC, 1, 512, 32)
    y1, carry = kern.render(x[:, :300])
    assert kern._hop_phase == 300 % 64
    y2, carry = kern.render(x[:, 300:], carry)
    y = np.concatenate([y1, y2], axis=1)
    assert np.abs(y.astype(np.float64) - y_ref).max() == 0.0
    yj1, jcarry = jkern.render(x[:, :300])
    yj2, _ = jkern.render(x[:, 300:], jcarry)
    d = float(np.max(np.abs(y - np.concatenate(
        [np.asarray(yj1), np.asarray(yj2)], axis=1))))
    print(f"hop_streaming_resume: max |port - JAX| audio {d:.3e}")
    assert d == 0.0
    # a fresh render starts again at the planned phase
    y_again, _ = kern.render(x[:, :300])
    assert kern._hop_phase == 300 % 64
    assert np.array_equal(y_again, y1)


def test_converted_jax_hop_carry_resumes_to_the_same_audio():
    _p, (kern, _s), (jkern, _js) = kernels_for(HOP_SRC, 1, 512, 32)
    x = noise(1, 900, seed=7)
    _yj, jcarry = jkern.render(x[:, :320])
    (svec, rings), hv, hm = jcarry
    as_numpy = ((np.asarray(svec), {r: np.asarray(a) for r, a in rings.items()}),
                np.asarray(hv), np.asarray(hm))
    kern._hop_phase = jkern._hop_phase
    y, _ = kern.render(x[:, 320:], carry=convert.carry_from_numpy(kern,
                                                                  as_numpy))
    yj, _ = jkern.render(x[:, 320:], carry=jcarry)
    assert np.array_equal(y, np.asarray(yj))


def test_hop_convolver_stand_in_against_the_golden():
    # the stand-in at its width (hops of 1,024 samples, 8 partitions of
    # 1,024) on 2 s of stereo: audio, vars and heap against the golden
    src = builtin_plugins.hop_convolver(1024, 8)
    prog = compile_plugin_source(src)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    2, segment_len=1 << 16, device="cpu")
    assert kern._hop_len == 1024 and kern._hop.fft_max == 2048
    x = noise(2, 96000, 0.25, seed=12)
    rep = null_test_plugin(prog, x, segment_len=1 << 16, golden="native",
                           compare_state=True, compare_mem=True, device="cpu")
    assert rep.passed, rep.summary()
    y, _ = kern.render(x)
    # the convolution is audible: the wet path is not silent
    wet = y - 0.5 * x
    assert float(np.abs(wet).max()) > 1e-3


def test_batch_of_three_files_equals_the_solo_renders():
    src, _x, seg, block, _ = CASES["hop_convolver_small"]
    br = BatchRenderer(compile_plugin_source(src), segment_len=seg,
                       block_size=block, device="cpu")
    assert br.kernel._hop is not None
    xs = np.stack([noise(2, 1100, 0.3, seed=70 + f) for f in range(3)])
    y = br.render_files(xs)
    assert torch.equal(y, br.render_files(xs))   # the staging stays fresh
    for f in range(3):
        solo, _ = br.kernel.render_device(xs[f])
        assert torch.equal(y[f], solo)


def test_k10_host_form_runs_the_hop_section_as_the_plain_version(monkeypatch):
    """K10's inputs at every hop of a 2-file CPU render of the convolver
    stand-in through the host form: its phases with 1, 3 and 128 threads,
    each block step's shares in ascending and in descending order, equal
    the one-thread form bit for bit (the body of process(), called as a
    statement, runs as phases in place: its copies, transforms and
    counted while loops across the block, the delay line's shift and the
    partition loop as loops every thread follows), and no block loop or
    copy runs on thread 0; the one-thread form equals the plain version
    bit for bit in the sample side's scalars and the hop's vars, and
    within FFT_TOL_REL in the heap and the rings."""
    from zorak_tpu_torch.kernels import _build

    try:
        _build.find_host_compiler()
    except RuntimeError:
        pytest.skip("no host C++ compiler (g++, gcc, c++, cc) for K10's "
                    "host form")
    src, _x, seg, block, _ = CASES["hop_convolver_small"]
    br = BatchRenderer(compile_plugin_source(src), segment_len=seg,
                       block_size=block, device="cpu")
    k10 = br.kernel._hop_prog
    assert k10.block.section == "sample-hop" and not k10.inter
    kinds = [(ph.kind, [b.kind for b in ph.body]) if ph.body else ph.kind
             for ph in k10.block.phases]
    assert kinds == [
        "copy", "copy", "fft", "fft", "serial", ("while", ["copy", "serial"]),
        "copy", "copy", "serial",
        ("while", ["copy", "fft", "serial", "loop", "serial"]),
        "fft", "fft", "serial", "loop", "serial"]
    assert not k10.block.serial_loops
    seen = []
    plain = BS.block_section_plain

    def spy(program, svec, rings, bvars, bmem, sb, *a, **k):
        seen.append((svec.clone(), [r.clone() for r in rings], bvars.clone(),
                     bmem.clone(), sb))
        return plain(program, svec, rings, bvars, bmem, sb, *a, **k)

    monkeypatch.setattr(BS, "block_section_plain", spy)
    x = np.stack([noise(2, 1100, 0.3, seed=80 + f) for f in range(2)])
    br.render_files(x)
    monkeypatch.setattr(BS, "block_section_plain", plain)
    assert len(seen) == 1100 // 128

    def run(inputs, **kw):
        svec, rings, bvars, bmem, sb = (
            t.clone() if isinstance(t, torch.Tensor) else t
            for t in inputs)
        rings = [r.clone() for r in rings]
        _ctrl, _mo, runs = BS.block_section_host(k10, svec, rings, bvars,
                                                 bmem, sb, **kw)
        return [svec, *rings, bvars, bmem], runs

    def bits(t):
        return t.numpy().view(np.int64)

    for inputs in seen[:3] + seen[-1:]:
        one, runs = run(inputs)
        assert runs == 0
        for threads in (1, 3, 128):
            for desc in (False, True):
                team, runs = run(inputs, threads=threads, descending=desc)
                assert runs == 0
                for a, b in zip(one, team):
                    assert np.array_equal(bits(a), bits(b)), (threads, desc)
        svec, rings, bvars, bmem, sb = (
            t.clone() if isinstance(t, torch.Tensor) else t
            for t in inputs)
        rings = [r.clone() for r in rings]
        plain(k10, svec, rings, bvars, bmem, sb)
        assert torch.equal(one[0], svec)
        assert torch.equal(one[-2], bvars)
        assert BS.fft_excess(one[-1], bmem, one[-2], bvars) <= 0.0
        # the rings the sample path reads back: the output ring holds the
        # inverse transform's overlap-add, so within FFT_TOL_REL too
        assert BS.fft_excess(torch.cat(one[1:-2], 1), torch.cat(rings, 1),
                             one[-2], bvars) <= 0.0
        for (o, m), r in zip(k10.regions, one[1:-2]):
            assert torch.equal(r, one[-1][:, o:o + m])


def test_k10_host_form_runs_the_full_size_hop_section_in_phases(monkeypatch):
    """hop_convolver(1024, 8), the stand-in at the size chip_smoke.py
    renders: K10's inputs at the second hop of a CPU render through the
    host form's phases with 1, 3 and 128 threads in both orders, bit for
    bit to the one-thread form, no block loop or copy on thread 0, and the
    barriers the phases pass (chip_smoke.py's chain bound counts them)."""
    from zorak_tpu_torch.kernels import _build

    try:
        _build.find_host_compiler()
    except RuntimeError:
        pytest.skip("no host C++ compiler (g++, gcc, c++, cc) for K10's "
                    "host form")
    br = BatchRenderer(compile_plugin_source(
        builtin_plugins.hop_convolver(1024, 8)), device="cpu")
    k10 = br.kernel._hop_prog
    assert sum(ph.kind != "serial" for ph in k10.block.phases) == 11
    seen = []
    plain = BS.block_section_plain

    def spy(program, svec, rings, bvars, bmem, sb, *a, **k):
        seen.append((svec.clone(), [r.clone() for r in rings], bvars.clone(),
                     bmem.clone(), sb))
        return plain(program, svec, rings, bvars, bmem, sb, *a, **k)

    monkeypatch.setattr(BS, "block_section_plain", spy)
    br.render_files(noise(2, 2 * 1024 + 100, 0.25, seed=90)[None])
    monkeypatch.setattr(BS, "block_section_plain", plain)
    assert len(seen) == 2
    svec, rings, bvars, bmem, sb = seen[1]

    def run(**kw):
        out = [svec.clone(), [r.clone() for r in rings], bvars.clone(),
               bmem.clone()]
        bars = []
        runs = BS.block_section_host(k10, out[0], out[1], out[2], out[3], sb,
                                     barriers=bars, **kw)[2]
        return [out[0], *out[1], out[2], out[3]], runs, bars[0]

    one, runs, _bars = run()
    assert runs == 0
    for threads in (1, 3, 128):
        for desc in (False, True):
            team, runs, bars = run(threads=threads, descending=desc)
            assert runs == 0 and bars == 132, (threads, desc)
            for a, b in zip(one, team):
                assert torch.equal(a.view(torch.int64), b.view(torch.int64)), \
                    (threads, desc)
    assert BS.barriers_a_launch(k10, 132) == 135


LEAVES = {
    ("Delay", "Echo"): ("Echo", "Zech", "@sample\nspl0 *= 0.5;\n"),
    # a hop on the catalog's block grid (512)
    ("Spatialization", "Conv"): ("Conv", "Zcnv", HOP_SRC.replace(
        "H = 64;", "H = 512;").replace("OUTBUF = 256;", "OUTBUF = 1024;")),
}


@pytest.fixture
def catalog(tmp_path):
    root = tmp_path / "catalog"
    for (category, slug), (name, code, src) in LEAVES.items():
        leaf = root / "plugins" / category / slug
        (leaf / "src").mkdir(parents=True)
        (leaf / "plugin.json").write_text(json.dumps({
            "name": name, "slug": slug, "pluginCode": code,
            "pluginType": "jsfx"}))
        (leaf / "src" / f"{slug}.jsfx").write_text(f"desc:{name}\n{src}")
    return root


def test_catalog_puts_a_hop_kernel_in_a_group_of_its_own(catalog):
    x = noise(2, 2600, 0.25, seed=4)
    rend, skipped = build_catalog_renderers(str(catalog), segment_len=512,
                                            device="cpu")
    jrend, jskipped = jax_build(str(catalog), segment_len=512)
    assert sorted(rend) == ["Conv", "Echo"] and not skipped and not jskipped
    assert rend["Conv"].kernel._hop is not None
    outs, n_groups = catalog_stacked_render(rend, x)
    jouts, jn_groups = jax_stacked({s: jrend[s] for s in rend}, x)
    assert n_groups == jn_groups == 2
    for slug in outs:
        assert np.array_equal(outs[slug].numpy(), np.asarray(jouts[slug]))
