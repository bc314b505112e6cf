"""The port's offline render engine on the CPU against the JAX engine and
the golden: `PluginInstance.render` (oversampling, smart idle, monitor
modes, MIDI into @block), the device policy, the CLI's JSFX render and the
state converters.

Tolerances: audio against the JAX engine within 1e-9 or one f32 ulp of the
sample (two f64 values that straddle an f32 rounding boundary; the box
downsample's f32 mean is taken in another order); against the golden
within the audio epsilon 1e-5.
"""
import json

import numpy as np
import pytest
import torch

from zorak_tpu.cli.main import main as jax_main
from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.runtime import wavio as jax_wavio
from zorak_tpu.runtime.engine import PluginInstance as JaxInstance
from zorak_tpu.runtime.engine import downsample_box as jax_down
from zorak_tpu.runtime.engine import upsample_linear as jax_up
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins, convert
from zorak_tpu_torch.cli.main import main
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.lowering import SpecializeError, specialize_sample_kernel
from zorak_tpu_torch.runtime import wavio
from zorak_tpu_torch.runtime.engine import (
    PluginInstance, downsample_box, render_file, upsample_linear)
from zorak_tpu_torch.verify import (
    AUDIO_EPS, compare_audio, compare_memory_pages, compare_states,
    make_initialized_shadow)

SR = 48000
JAX_EPS = 1e-9

DELAY = builtin_plugins.wide_delay_network(24, buf=4096, max_delay=3000)
BLOCK_LFO = ("slider1:5<0,10,1>Depth\n@slider\ndepth = slider1 / 10;\n"
             "@block\nblocks += 1;\ng = 0.5 + 0.4 * depth * sin(blocks * 0.3);\n"
             "@sample\nz = 0.99*z + 0.01*spl0;\nspl0 = spl0 * g + z;\n"
             "spl1 = spl1 * g;\n")
MIDI_BLOCK = ("@block\n"
              "while (midirecv(ofs, m1, m23)) ( notes += ((m1 & 240) == 144); );\n"
              "g = 0.2 + 0.1 * notes;\n@sample\nspl0 = spl0 * g;\n")
FOLLOWER = ("@init\nenv = 0;\n@sample\nx = abs(spl0);\n"
            "env = x > env ? x + (env - x)*0.9 : x + (env - x)*0.999;\n"
            "spl0 = env;\n")
PLUGINS = {"delay": DELAY, "block_lfo": BLOCK_LFO, "follower": FOLLOWER}


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def noise(nch, n, scale=0.25, seed=3):
    return (np.random.RandomState(seed).randn(nch, n) * scale).astype(np.float32)


def excess(y, yj):
    """<= 0 when y is within JAX_EPS, or one f32 ulp, of yj everywhere."""
    yj = np.asarray(yj, np.float32)
    d = np.abs(np.asarray(y, np.float64) - yj.astype(np.float64))
    return float(np.max(d - np.maximum(JAX_EPS, np.spacing(np.abs(yj))),
                        initial=-1.0))


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_up_and_downsample_match_jax(factor):
    x = noise(2, 700, seed=factor)
    tail = noise(2, 1, seed=9)
    for prev in (None, tail):
        got = upsample_linear(torch.from_numpy(x), factor,
                              None if prev is None else torch.from_numpy(prev))
        want = jax_up(x, factor, prev)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
    # the box mean sums `factor` f32 samples; the port sums them in f64 and
    # rounds once, numpy in f32 pairs: within 2^-22 of the largest sample
    y = noise(2, 700 * factor + 3, seed=factor + 20)
    got = downsample_box(torch.from_numpy(y), factor).numpy()
    assert got.dtype == np.float32 and got.shape == (2, (700 * factor + 3) // factor)
    assert float(np.abs(got - jax_down(y, factor)).max()) \
        <= 2.0 ** -22 * float(np.abs(y).max())


@pytest.mark.parametrize("name", sorted(PLUGINS))
@pytest.mark.parametrize("oversample", [1, 2])
def test_render_matches_jax_engine_and_golden(name, oversample):
    src = PLUGINS[name]
    x = noise(2, 5000)
    inst = PluginInstance(compile_plugin_source(src), srate=SR,
                          oversample=oversample, segment_len=2048,
                          sliders={0: 7.0}, device="cpu")
    jinst = JaxInstance(jax_compile(src), srate=SR, oversample=oversample,
                        segment_len=2048, sliders={0: 7.0})
    assert inst.engine == "torch-vector" and jinst.engine == "tpu-vector"
    res, jres = inst.render(x), jinst.render(x)
    assert res.engine == "torch-vector" and res.audio.dtype == np.float32
    assert res.audio.shape == jres.audio.shape == (inst.nch, 5000)
    # at oversample 2 `downsample_box` averages in f64 and rounds once
    # where the JAX engine averages in f32: the bound that covers both
    # factors is one f32 ulp of the sample (or 1e-9), which `excess` holds
    assert excess(res.audio, jres.audio) <= 0.0
    gold = PluginInstance(compile_plugin_source(src), srate=SR,
                          oversample=oversample, sliders={0: 7.0},
                          prefer="none", device="cpu")
    assert gold.engine == "cpu-shadow" and gold.kernel is None
    # the golden's @block runs every block_size host samples, the
    # kernel's every 512 engine samples: the same cadence
    rg = gold.render(x, block_size=512 // oversample)
    assert rg.engine == "cpu-shadow"
    rep = compare_audio(rg.audio, res.audio)
    assert rep.audio_passed, rep.summary()
    # the instance's state followed the render, like the golden's
    rep = compare_states(gold.shadow.state, inst.shadow.state)
    compare_memory_pages(gold.shadow.state, inst.shadow.state, report=rep)
    assert rep.passed, rep.summary()
    # a second render starts fresh in both engines
    assert excess(inst.render(x).audio, jinst.render(x).audio) <= 0.0


def test_smart_idle_sleeps_and_freezes_block_state_like_jax():
    src = "@block\nblocks += 1;\n@sample\nspl0 = spl0 * 0.5;\n"
    n = 512 * 40
    x = np.zeros((1, n), dtype=np.float32)
    x[0, 512 * 30 + 5] = 0.5
    inst = PluginInstance(compile_plugin_source(src), device="cpu",
                          smart_idle="input_driven", idle_hold_ms=10.0)
    jinst = JaxInstance(jax_compile(src), smart_idle="input_driven",
                        idle_hold_ms=10.0)
    res, jres = inst.render(x), jinst.render(x)
    assert res.details["awake_blocks"] == jres.details["awake_blocks"]
    assert res.details["awake_blocks"] < res.details["blocks"]
    assert inst.shadow.state.V["blocks"] == res.details["awake_blocks"]
    assert np.array_equal(res.audio, jres.audio)


def test_gated_vector_path_equals_always_awake_on_active_audio():
    prog = compile_plugin_source(BLOCK_LFO)
    x = noise(2, 4096, scale=0.4, seed=0)
    a = PluginInstance(prog, smart_idle="always_awake", device="cpu")
    b = PluginInstance(prog, smart_idle="input_driven", device="cpu")
    ya, rb = a.render(x).audio, b.render(x)
    assert rb.details.get("idle_mode") == "input_driven"
    assert np.array_equal(ya, rb.audio)


@pytest.mark.parametrize("monitor", ["shadow", "delta"])
def test_monitor_modes_match_jax(monitor):
    x = noise(2, 3000, seed=4)
    inst = PluginInstance(compile_plugin_source(DELAY), segment_len=1024,
                          device="cpu")
    jinst = JaxInstance(jax_compile(DELAY), segment_len=1024)
    res = inst.render(x, monitor=monitor)
    jres = jinst.render(x, monitor=monitor)
    assert res.details["monitor"] == monitor and res.engine == "torch-vector"
    assert res.details["max_delta"] <= AUDIO_EPS
    assert excess(res.audio, jres.audio) <= 0.0
    if monitor == "delta":
        assert float(np.abs(res.audio).max()) <= AUDIO_EPS
    with pytest.raises(ValueError):
        inst.render(x, monitor="both")


def test_midi_reaches_block_through_the_vector_kernel():
    x = noise(1, 4000, scale=0.4, seed=31)
    midi = [(150, 144, 60, 90), (2100, 144, 62, 80)]
    inst = PluginInstance(compile_plugin_source(MIDI_BLOCK), device="cpu")
    assert inst.engine == "torch-vector" and inst.kernel.accepts_midi
    rv = inst.render(x, midi=midi)
    rs = PluginInstance(compile_plugin_source(MIDI_BLOCK), prefer="none",
                        device="cpu").render(x, midi=midi)
    assert rv.engine == "torch-vector" and rs.engine == "cpu-shadow"
    assert float(np.abs(rv.audio - rs.audio).max()) <= JAX_EPS
    rj = JaxInstance(jax_compile(MIDI_BLOCK)).render(x, midi=midi)
    assert excess(rv.audio, rj.audio) <= 0.0


def test_fetch_audio_false_keeps_the_audio_on_the_device():
    x = noise(2, 3000, seed=8)
    inst = PluginInstance(compile_plugin_source(DELAY), device="cpu",
                          smart_idle="always_awake")
    full = inst.render(x)
    res = inst.render(x, fetch_audio=False)
    assert res.audio is None and res.details["all_finite"]
    y_dev = res.details["audio_device"]
    assert isinstance(y_dev, torch.Tensor)
    assert np.array_equal(y_dev.numpy(), full.audio)
    assert res.details["peak"] == pytest.approx(float(np.abs(full.audio).max()))


def test_save_and_load_state_respecialize():
    src = ("slider1:5<0,10,1>Gain\n@slider\ng = slider1 * 2;\n"
           "@sample\nspl0 = g;\n")
    prog = compile_plugin_source(src)
    a = PluginInstance(prog, sliders={0: 7.0}, device="cpu")
    blob = a.save_state()
    assert blob["sliders"][0] == 7.0 and json.dumps(blob)
    b = PluginInstance(prog, device="cpu")
    b.load_state(blob)
    assert b.engine == "torch-vector"
    y = b.render(np.zeros((1, 16), dtype=np.float32)).audio
    assert np.allclose(y, 14.0)


def test_device_none_needs_a_gpu_and_unported_engines_say_so():
    prog = compile_plugin_source(DELAY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PluginInstance(prog)
        with pytest.raises(RuntimeError, match="CUDA"):
            specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                     2)
    # prefer="devexec" skips the vectorizer: the sequential executor renders
    # the delay network, equal to the golden
    dev = PluginInstance(prog, prefer="devexec", smart_idle="always_awake",
                         device="cpu")
    assert dev.engine == "torch-devexec" and dev.spec_error == \
        "devexec requested"
    x = noise(2, 1100)
    rd = dev.render(x)
    assert rd.engine == "torch-devexec"
    gold = PluginInstance(prog, prefer="none", device="cpu")
    rep = compare_audio(gold.render(x, block_size=512).audio, rd.audio)
    compare_states(gold.shadow.state, dev.shadow.state, report=rep)
    compare_memory_pages(gold.shadow.state, dev.shadow.state, report=rep)
    assert rep.passed and rep.max_abs_delta <= 1e-6, rep.summary()
    # an audio-coupled @block that reads a gmem page's sequence number: both
    # device engines refuse it (the reference's sections leave it to the
    # golden, its sequential executor's too), and the golden renders it
    coupled = compile_plugin_source(
        "@sample\nacc += abs(spl0);\nspl0 *= g;\n"
        "@block\ng = 1/(1 + acc*0.001);\ny = gmem_seq(0);\n")
    inst = PluginInstance(coupled, device="cpu")
    assert inst.engine == "cpu-shadow" and \
        "through the golden" in inst.spec_error
    assert inst.spec_error.count("gmem") >= 2 and "; devexec: " in \
        inst.spec_error
    with pytest.raises(SpecializeError, match="devexec: .*gmem"):
        PluginInstance(coupled, prefer="devexec", device="cpu")
    res = inst.render(noise(1, 1200))
    assert res.engine == "cpu-shadow"
    assert res.details["spec_error"] == inst.spec_error
    with pytest.raises(SpecializeError, match="through the golden"):
        PluginInstance(coupled, prefer="vector", device="cpu")
    # one that writes gmem renders on the card now (the heap's window), on
    # K11 too, as the reference's sequential executor takes it
    writes = compile_plugin_source(
        "@sample\nacc += abs(spl0);\nspl0 *= g;\n"
        "@block\ng = 1/(1 + acc*0.001);\ngmem[0] = g;\n")
    on_card = PluginInstance(writes, device="cpu")
    assert on_card.engine == "torch-vector"
    on_k11 = PluginInstance(writes, prefer="devexec", device="cpu")
    assert on_k11.engine == "torch-devexec"
    r_vec, r_k11 = on_card.render(x), on_k11.render(x)
    assert r_k11.engine == "torch-devexec"
    assert np.abs(r_vec.audio - r_k11.audio).max() <= 1e-6
    assert on_k11.shadow.state.gmem[0] == on_card.shadow.state.gmem[0] > 0


def _jsfx_catalog(root, src):
    leaf = root / "plugins" / "Delay" / "Net"
    (leaf / "src").mkdir(parents=True)
    (leaf / "plugin.json").write_text(json.dumps({
        "name": "Net", "slug": "Net", "pluginCode": "Znet",
        "pluginType": "jsfx"}))
    (leaf / "src" / "Net.jsfx").write_text(src)
    return root


@pytest.mark.parametrize("monitor", ["compiled", "delta"])
def test_cli_jsfx_render_round_trips_a_wav_like_jax_cli(tmp_path, capsys,
                                                        monitor):
    root = _jsfx_catalog(tmp_path / "catalog", DELAY)
    x = noise(2, 3000, seed=5)
    wav_in = tmp_path / "in.wav"
    wavio.write_wav(wav_in, x, SR, float_fmt=True)
    out_p, out_j = tmp_path / "port.wav", tmp_path / "jax.wav"
    common = ["render", "--catalog", str(root), "--only", "Net", "--in",
              str(wav_in), "--slider", "1=65", "--monitor", monitor]
    assert main([*common, "--out", str(out_p), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "via torch-vector" in out
    assert jax_main([*common, "--out", str(out_j)]) == 0
    y_p, rate = wavio.read_wav(out_p)
    y_j, _ = jax_wavio.read_wav(out_j)
    assert rate == SR and y_p.shape == y_j.shape == (2, 3000)
    # 16-bit PCM files: one quantisation step
    assert float(np.abs(y_p - y_j).max()) <= 1.0 / 32768 + 1e-9
    if monitor == "compiled":
        inst = PluginInstance(compile_plugin_source(DELAY), srate=SR,
                              sliders={0: 65.0}, device="cpu")
        assert float(np.abs(y_p - inst.render(x).audio).max()) <= 1.0 / 32768
    else:
        assert "monitor=delta max_delta=" in out
    assert main(["inspect", "--catalog", str(root)]) == 0
    assert "slider1" in capsys.readouterr().out


def test_cli_shadow_engine_and_render_file(tmp_path, capsys):
    root = _jsfx_catalog(tmp_path / "catalog", FOLLOWER)
    x = noise(1, 2000, seed=6)
    wav_in = tmp_path / "in.wav"
    wavio.write_wav(wav_in, x, SR, float_fmt=True)
    assert main(["render", "--catalog", str(root), "--only", "Net", "--in",
                 str(wav_in), "--out", str(tmp_path / "s.wav"), "--engine",
                 "shadow", "--device", "cpu"]) == 0
    assert "via cpu-shadow" in capsys.readouterr().out
    res = render_file(compile_plugin_source(FOLLOWER), wav_in,
                      tmp_path / "v.wav", device="cpu")
    assert res.engine == "torch-vector"
    y_s, _ = wavio.read_wav(tmp_path / "s.wav")
    y_v, _ = wavio.read_wav(tmp_path / "v.wav")
    assert float(np.abs(y_s - y_v).max()) <= 1.0 / 32768


@pytest.mark.parametrize("segment_len", [512, 2048])
def test_convert_carries_a_jax_carry_and_state_across(segment_len):
    x = noise(2, 4000, seed=12)
    jprog = jax_compile(DELAY)
    jshadow = jax_shadow(jprog, SR, {0: 30.0})
    jkern = jax_specialize(jprog, jshadow.state, 2, segment_len=segment_len)
    prog = compile_plugin_source(DELAY)
    # the port's state is built from the JAX package's numbers, not by
    # running @init on its own
    from zorak_tpu_torch.shadow import compile_shadow

    plug = compile_shadow(prog)
    plug.state.srate = float(SR)
    convert.shadow_state_from_numpy(
        plug.state, jshadow.state.V, jshadow.state.sliders,
        np.asarray(jshadow.state.mem), jshadow.state.spl)
    kern = specialize_sample_kernel(prog, plug.state, 2,
                                    segment_len=segment_len, device="cpu")
    jsvec, jrings = jkern.initial_carry()
    carry = convert.carry_from_numpy(kern, jsvec, jrings)
    assert np.array_equal(carry[0].numpy(), kern.initial_carry()[0])
    y, c = kern.render(x[:, :2500], carry=carry)
    yj, jc = jkern.render(x[:, :2500])
    assert excess(y, yj) <= 0.0
    # hand the JAX carry over mid-render: both continue identically
    carry = convert.carry_from_numpy(
        kern, np.asarray(jc[0]), {r: np.asarray(a) for r, a in jc[1].items()})
    y2, _ = kern.render(x[:, 2500:], carry=carry)
    yj2, _ = jkern.render(x[:, 2500:], carry=jc)
    assert excess(y2, yj2) <= 0.0
    with pytest.raises(ValueError):
        convert.carry_from_numpy(kern, np.zeros(3), jrings)
    with pytest.raises(ValueError):
        convert.carry_from_numpy(kern, jsvec, {})
