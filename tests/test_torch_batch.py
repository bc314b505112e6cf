"""The port's JSFX batch path (zorak_tpu_torch/parallel/batch.py) on the CPU
against the JAX package's `BatchRenderer` and against the port's own solo
renders, and the catalog functions on a temporary catalog.

Every case renders the same seeded numpy files.  Tolerances: the port's
f32 audio within 1e-9 of the JAX render's, or one f32 ulp of the sample
(the solo slice's bound, tests/test_torch_specialize.py); each file of a
port batch equal to the port's solo render of that file (`torch.equal`):
a file's rows go through the same operations in the same order.  Segment
lengths are multiples of 16, as the solo tests' are.
"""
import json

import numpy as np
import pytest
import torch

from chip_smoke import SCAN_GROUP_SRC, STEREO_FOLLOWERS_SRC
from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.parallel import BatchRenderer as JaxBatchRenderer
from zorak_tpu.parallel import build_catalog_renderers as jax_build
from zorak_tpu.parallel import catalog_batch_render as jax_catalog_batch
from zorak_tpu.parallel import catalog_stacked_render as jax_stacked

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import linrec_scan as LS
from zorak_tpu_torch.kernels import ring_taps as RT
from zorak_tpu_torch.kernels import scan_group as SG
from zorak_tpu_torch.lowering import SpecializeError
from zorak_tpu_torch.parallel import (
    BatchRenderer, FaustBatchRenderer, build_catalog_renderers,
    catalog_batch_render, catalog_stacked_render, render_batch)
from zorak_tpu_torch.verify import compare_audio

JAX_EPS = 1e-9

SRC = ("@init\nMASK = 255;\n"
       "@sample\nbuf[w & MASK] = spl0;\n"
       "z = 0.99*z + 0.01*buf[(w - 100) & MASK];\n"
       "spl0 = z;\nw += 1;\n")

# name -> (source, channels, segment length)
CASES = {
    "test_batch_src": (SRC, 1, 512),
    "wide_delay_network": (builtin_plugins.wide_delay_network(
        24, buf=1024, max_delay=900), 2, 2048),
    "cross_fed_delay_network": (builtin_plugins.cross_fed_delay_network(
        16, buf=1024, max_delay=900), 2, 1024),
    "scan_group": (SCAN_GROUP_SRC, 2, 1024),
    "stereo_followers": (STEREO_FOLLOWERS_SRC, 2, 2048),
    "ungated_rand_draws": (
        "@sample\nspl0 = spl0 + (rand(2) - 1) * 0.01;\n"
        "spl1 = spl1 * (0.5 + rand(1) * 0.1);\n", 2, 1024),
    "block_control": (
        "@block\nphase += 0.1;\ng = 0.5 + 0.4*sin(phase);\n"
        "@sample\nspl0 *= g;\nspl1 *= 1 - g;\n", 2, 512),
    # a read at a slot that moves every sample, a write every sample at a
    # wrapped counter, a read behind a wrapped (non power of two) cursor
    "slewed_dynamic_tap": (
        "@init\nMASK = 1023;\n@sample\nmem[w & MASK] = spl0;\n"
        "d += (200 - d) * 0.001;\ndi = floor(d + 0.5);\n"
        "spl0 = mem[(w - di) & MASK];\nw += 1;\n", 1, 2048),
    "every_sample_dynamic_write": (
        "@init\nTAB = 400;\n@sample\nTAB[p] = spl0;\n"
        "p += 1; p >= 100 ? p = 0;\nspl0 = 0.25 * spl0;\n", 1, 1024),
    "nonpow2_wrapped_counter_delay": (
        "@init\nM = 100;\n@sample\nbuf[p] = spl0;\n"
        "r = p - 37; r < 0 ? r += M;\nspl0 = 0.5*spl0 + buf[r];\n"
        "p += 1; p >= M ? p = 0;\n", 1, 2048),
}

COUPLED_SRC = ("@sample\nacc += abs(spl0);\nspl0 *= g;\n"
               "@block\ng = 1/(1 + acc*0.001);\n")
# an audio-coupled @block that reads a gmem page's sequence number: left to
# the golden, as the reference leaves it
COUPLED_GMEM_SRC = COUPLED_SRC + "y = gmem_seq(0);\n"
# one that writes gmem: each file's gmem is its heap's window
COUPLED_GMEM_WRITE_SRC = COUPLED_SRC + "gmem[0] = g;\n"
GATED_SRC = ("@init\nHIST = 900;\n"
             "@sample\npeak = max(peak, abs(spl0));\ncnt += 1;\n"
             "cnt >= 37 ? (\n  HIST[wpos] = peak;\n"
             "  wpos += 1; wpos >= 50 ? wpos = 0;\n  cnt = 0; peak = 0;\n"
             ");\nspl0 = spl0 * 0.5;\n")
HOP_SRC = """@init
H = 64;
INBUF = 0;
OUTBUF = 256;
function do_hop() local(i) (
  i = 0;
  while (i < H) ( OUTBUF[i] = INBUF[i] * 0.5 + 0.1; i += 1; );
);
@sample
y = OUTBUF[rpos];
INBUF[ctr] = spl0;
spl0 = y + spl0 * 0.25;
rpos += 1; rpos >= H ? rpos = 0;
ctr += 1; ctr >= H ? ( do_hop(); ctr = 0; );
"""


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def files(nf, nch, n, seed=0):
    return (np.random.RandomState(seed).randn(nf, nch, n) * 0.3
            ).astype(np.float32)


def audio_excess(y, yj):
    """How far the port's f32 audio lies outside its tolerance against
    the JAX render (<= 0 means inside): JAX_EPS, or one f32 ulp."""
    yj = np.asarray(yj, np.float32)
    d = np.abs(y.astype(np.float64) - yj.astype(np.float64))
    return float(np.max(d - np.maximum(JAX_EPS, np.spacing(np.abs(yj))),
                        initial=-1.0))


def port_batch(name, **kw):
    src, _nch, seg = CASES[name]
    return BatchRenderer(compile_plugin_source(src), segment_len=seg,
                         device="cpu", **kw)


def assert_solo_equal(br, x, y):
    """Each file of the batch equals the kernel's solo render of it."""
    for f in range(x.shape[0]):
        solo, _ = br.kernel.render_device(x[f])
        assert torch.equal(y[f], solo), f"file {f}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_matches_jax_and_the_solo_renders(name):
    src, nch, seg = CASES[name]
    x = files(3, nch, 4096, seed=len(name))
    br = port_batch(name)
    y = br.render_files(x)
    assert y.dtype == torch.float32 and y.shape == x.shape
    yj = np.asarray(JaxBatchRenderer(jax_compile(src), segment_len=seg)
                    .render_files(x))
    assert audio_excess(y.numpy(), yj) <= 0.0, "port vs JAX batch"
    assert_solo_equal(br, x, y)
    # staged once per (files, T): a second call reuses it and agrees
    assert torch.equal(br.render_files(torch.from_numpy(x)), y)
    assert list(br._staged) == [(3, 4096)]
    # the carry each file ends with is its solo render's
    kern = br.kernel
    carry, ctrl, rand = br.staged(3, 4096)
    y2, (svec, rings) = kern._run(carry, torch.from_numpy(x), ctrl, rand,
                                  kern.segment_length(4096))
    assert torch.equal(y2, y)
    for f in range(3):
        _y, (sv, rg) = kern.render_device(x[f])
        assert torch.equal(svec[f], sv) and sorted(rings) == sorted(rg)
        for r, a in rg.items():
            assert torch.equal(rings[r][f], a), (f, r)


@pytest.mark.parametrize("name", ["wide_delay_network", "scan_group"])
def test_one_file_is_the_solo_render(name):
    x = files(1, 2, 4096 + 300, seed=3)
    br = port_batch(name)
    y = br.render_files(x)
    solo, _ = br.kernel.render_device(x[0])
    assert torch.equal(y[0], solo)


@pytest.mark.parametrize("name", ["wide_delay_network", "stereo_followers",
                                  "cross_fed_delay_network"])
def test_files_that_differ_after_the_first_segment(name):
    _src, nch, seg = CASES[name]
    x = np.repeat(files(1, nch, 4096, seed=5), 4, axis=0)
    rng = np.random.RandomState(6)
    for f in range(1, 4):
        x[f, :, seg + 100 * f:] = (rng.randn(nch, 4096 - seg - 100 * f)
                                   * 0.3).astype(np.float32)
    br = port_batch(name)
    y = br.render_files(x)
    assert_solo_equal(br, x, y)
    for f in range(1, 4):
        assert torch.equal(y[f, :, :seg], y[0, :, :seg])
        assert not torch.equal(y[f], y[0])


def test_launches_do_not_grow_with_the_files(monkeypatch):
    # each kernel is called as often for 4 files as for 1
    calls = {"taps": 0, "linrec": 0, "scan": 0}
    for mod, fn, key in ((RT, "ring_tap_sum", "taps"),
                         (LS, "linrec_scan", "linrec"),
                         (SG, "scan_group", "scan")):
        plain = getattr(mod, fn)

        def spy(*a, _plain=plain, _key=key, **kw):
            calls[_key] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(mod, fn, spy)
    counts = {}
    for name in ("wide_delay_network", "scan_group"):
        for nf in (1, 4):
            for k in calls:
                calls[k] = 0
            port_batch(name).render_files(files(nf, 2, 4096, seed=nf))
            counts[(name, nf)] = dict(calls)
        assert counts[(name, 1)] == counts[(name, 4)]
    assert counts[("wide_delay_network", 1)]["taps"] == 2
    assert counts[("wide_delay_network", 1)]["linrec"] == 2
    assert counts[("scan_group", 1)]["scan"] == 4


def test_the_mirror_check_refuses_files_whose_cursors_differ():
    br = port_batch("test_batch_src")
    kern = br.kernel
    x = torch.from_numpy(files(2, 1, 2048, seed=8))
    carry, ctrl, rand = br.staged(2, 2048)
    svec, rings = carry
    w = kern.scalar_index[("var", "w")]
    z = kern.scalar_index[("var", "z")]
    assert w in kern.mirrored_slots() and z not in kern.mirrored_slots()
    bad = svec.clone()
    bad[1, w] = 7.0
    with pytest.raises(SpecializeError, match="host-mirrored"):
        kern._run((bad, rings), x, ctrl, rand, 512)
    # a slot the host does not mirror may differ: each file then renders
    # as it would alone from its own carry
    ok = svec.clone()
    ok[1, z] = 0.25
    y, _ = kern._run((ok, rings), x, ctrl, rand, 512)
    for f in range(2):
        solo, _ = kern.render_device(
            x[f], carry=(ok[f], {r: a[f] for r, a in rings.items()}))
        assert torch.equal(y[f], solo)


@pytest.mark.parametrize("src,match", [
    (COUPLED_GMEM_SRC, "coupled @block.*through the golden"),
])
def test_unported_regimes_raise_the_solo_error(src, match):
    prog = compile_plugin_source(src)
    with pytest.raises(SpecializeError, match=match):
        BatchRenderer(prog, device="cpu")
    with pytest.raises(SpecializeError, match=match):
        render_batch(prog, files(2, 1, 512), device="cpu")


def test_coupled_gmem_files_keep_their_own_window():
    # a batch's files are separate instances: each writes the gmem of its
    # own heap window, and each equals its solo render
    prog = compile_plugin_source(COUPLED_GMEM_WRITE_SRC)
    br = BatchRenderer(prog, device="cpu")
    assert br.kernel._block_prog.uses_gmem
    x = files(3, 1, 1300, seed=9)
    y = br.render_files(x)
    for f in range(3):
        solo, _ = br.kernel.render_device(x[f])
        assert torch.equal(y[f], solo), f"file {f}"


# the hop and gated regimes, refused before they were ported, render as a
# batch: against the JAX BatchRenderer and each file's solo render
@pytest.mark.parametrize("src,block", [(HOP_SRC, 32), (GATED_SRC, 512)],
                         ids=["hop", "gated"])
def test_hop_and_gated_regimes_render_as_a_batch(src, block):
    prog = compile_plugin_source(src)
    br = BatchRenderer(prog, segment_len=512, block_size=block, device="cpu")
    kern = br.kernel
    assert (kern._hop is not None) == (src is HOP_SRC)
    assert any(p.kind == "gmodind" for p in kern.plans.values()) == \
        (src is GATED_SRC)
    x = files(3, 1, 1500, seed=21)
    y = br.render_files(x)
    yj = JaxBatchRenderer(jax_compile(src), segment_len=512,
                          block_size=block).render_files(x)
    assert audio_excess(y.numpy(), yj) <= 0.0
    for f in range(3):
        solo, _ = kern.render_device(x[f])
        assert torch.equal(y[f], solo)
    assert torch.equal(render_batch(prog, x, segment_len=512,
                                    block_size=block, device="cpu"), y)


def test_files_whose_gated_cursors_differ_render_as_alone():
    # a gated cursor moves with each file's audio: the device holds it, a
    # value a file, so files that start apart (and drift further apart)
    # render as they would alone, and the mirror never lists it
    src = ("@init\nMASK = 2047;\n@sample\ng = abs(spl0) > 0.2;\n"
           "g ? (\n  t = mem[(w - 600) & MASK];\n  z = 0.5*z + 0.5*t;\n"
           "  mem[w] = spl0 + 0.4*z;\n  w = (w + 1) & MASK;\n);\n"
           "spl0 = spl0 + z;\n")
    br = BatchRenderer(compile_plugin_source(src), segment_len=1024,
                       device="cpu")
    kern = br.kernel
    w = kern.scalar_index[("var", "w")]
    assert kern.plans[("var", "w")].kind == "gmodind"
    assert w not in kern.mirrored_slots() and kern.L == 512
    x = torch.from_numpy(files(3, 1, 2048, seed=9))
    carry, ctrl, rand = br.staged(3, 2048)
    svec, rings = carry
    start = svec.clone()
    start[1, w] = 700.0
    start[2, w] = 2047.0
    y, (end, _r) = kern._run((start, rings), x, ctrl, rand, 512)
    assert len({float(v) for v in end[:, w]}) == 3
    for f in range(3):
        solo, (solo_end, _) = kern.render_device(
            x[f], carry=(start[f], {r: a[f] for r, a in rings.items()}))
        assert torch.equal(y[f], solo)
        assert torch.equal(end[f], solo_end)


def test_mesh_is_refused():
    br = port_batch("test_batch_src")
    with pytest.raises(ValueError, match="one GPU"):
        br.render_files(files(2, 1, 512), mesh=object())
    with pytest.raises(ValueError, match=r"\[nf, 1, T\]"):
        br.render_files(files(2, 2, 512))
    y = render_batch(compile_plugin_source(SRC), files(2, 1, 600),
                     segment_len=512, device="cpu")
    assert y.shape == (2, 1, 600) and torch.isfinite(y).all()


# the catalog ------------------------------------------------------------------

LEAVES = {
    ("Dynamics", "GTS"): ("Gaussian Transient Shaper", "Zgts", "faust",
                          "import(\"stdfaust.lib\");\nprocess = _, _;\n"),
    ("Delay", "Echo"): ("Echo", "Zech", "jsfx", "desc:Echo\n" + SRC),
    ("Dynamics", "Follow"): ("Follower", "Zfol", "jsfx", SCAN_GROUP_SRC),
    ("Dynamics", "Pump"): ("Pump", "Zpmp", "jsfx", "desc:Pump\n" + COUPLED_SRC),
}


@pytest.fixture
def catalog(tmp_path):
    root = tmp_path / "catalog"
    for (category, slug), (name, code, ptype, src) in LEAVES.items():
        leaf = root / "plugins" / category / slug
        (leaf / "src").mkdir(parents=True)
        (leaf / "plugin.json").write_text(json.dumps({
            "name": name, "slug": slug, "pluginCode": code,
            "pluginType": ptype}))
        ext = ".dsp" if ptype == "faust" else ".jsfx"
        (leaf / "src" / f"{slug}{ext}").write_text(src)
    return root


def assert_audio_like_jax(slug, got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, slug
    if slug == "GTS":       # the Faust module, held as the Faust slice is
        rep = compare_audio(want.reshape(-1, want.shape[-1]),
                            got.reshape(-1, got.shape[-1]))
        assert rep.audio_passed, f"{slug}: {rep.summary()}"
    else:
        assert audio_excess(got, want) <= 0.0, slug


def test_catalog_functions_match_jax(catalog):
    x = (np.random.RandomState(4).randn(2, 2048) * 0.25).astype(np.float32)
    rend, skipped = build_catalog_renderers(str(catalog), segment_len=1024,
                                            device="cpu")
    jrend, jskipped = jax_build(str(catalog), segment_len=1024)
    assert sorted(rend) == ["Echo", "Follow", "GTS", "Pump"]
    assert isinstance(rend["GTS"], FaustBatchRenderer) and rend["GTS"].is_faust
    # both packages render the coupled plugin on their device @block
    assert rend["Pump"].kernel.coupled and not skipped and not jskipped

    outs, n_groups = catalog_stacked_render(rend, x)
    jouts, jn_groups = jax_stacked({s: jrend[s] for s in rend}, x)
    # the coupled kernel is a group of its own in both
    assert n_groups == jn_groups == 2 and sorted(outs) == sorted(jouts)
    for slug in outs:
        assert outs[slug].shape == (rend[slug].nch, 2048)
        assert_audio_like_jax(slug, outs[slug], jouts[slug])

    plan = {}
    again, _ = catalog_stacked_render(rend, x, plan=plan)
    again2, n2 = catalog_stacked_render(rend, x, groups=[["Echo"], ["GTS"]],
                                        plan=plan)
    assert n2 == 2 and sorted(again2) == ["Echo", "GTS"]
    for slug in again2:
        assert torch.equal(again2[slug], again[slug])

    bouts, bskipped = catalog_batch_render(str(catalog), x, segment_len=1024,
                                           device="cpu")
    jbouts, _ = jax_catalog_batch(str(catalog), x, segment_len=1024,
                                  renderers={s: jrend[s] for s in rend})
    assert sorted(bouts) == sorted(outs) and not bskipped
    for slug in bouts:
        assert bouts[slug].shape == (1, rend[slug].nch, 2048)
        assert_audio_like_jax(slug, bouts[slug], jbouts[slug])
        assert torch.equal(bouts[slug][0], outs[slug])
