"""The port's native C golden (zorak_tpu_torch/shadow/cgen.py, a byte-for-
byte copy of the JAX package's) and `null_test_plugin(golden="native",
export_dir=...)`, on the CPU.

- The port's `generate_c` emits the C text the JAX package's emits.
- The native golden renders the in-repo delay networks and the
  scan-group plugins exactly as the port's Python golden does: audio,
  vars and heap equal (the two executors implement one scalar contract).
- `null_test_plugin` with the native golden passes where the Python one
  does, and writes the export bundle.

Every compiled library goes to the test's tmp_path (`cgen.CACHE_DIR`; the
module reads ZORAK_TPU_CACHE once, when it is imported).
"""
import json

import numpy as np
import pytest

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.shadow import cgen as jax_cgen

from zorak_tpu_torch import builtin_plugins as BP
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.runtime import wavio
from zorak_tpu_torch.shadow import CGenError, NativeShadowPlugin, cgen
from zorak_tpu_torch.shadow import compile_native_shadow
from zorak_tpu_torch.verify import (
    apply_slider_state, compare_memory_pages, compare_states,
    make_initialized_shadow, null_test_plugin)

SR = 48000.0

FOLLOWER_SRC = """\
desc:attack/release follower
@init
env = 0; up = 0.9; dn = 0.999;
@sample
x = abs(spl0);
env = x > env ? x + (env - x)*up : x + (env - x)*dn;
spl0 = env; spl1 = env;
"""

STEREO_FOLLOWERS_SRC = """\
desc:two attack/release followers
@init
up = 0.9; dn = 0.999;
@sample
x0 = abs(spl0); x1 = abs(spl1);
e0 = x0 > e0 ? x0 + (e0 - x0)*up : x0 + (e0 - x0)*dn;
e1 = x1 > e1 ? x1 + (e1 - x1)*up : x1 + (e1 - x1)*dn;
spl0 = spl0*(1 - 0.5*e0); spl1 = spl1*(1 - 0.5*e1);
"""

WRAP_SRC = ("@sample\nph += 0.37 + spl0;\nwhile (ph > 1) ( ph -= 2; );\n"
            "z = sin(z*0.9 + spl0);\nspl0 = ph * 0.5 + z;\n")

PLUGINS = {
    "fallback": BP.FALLBACK_SRC,
    "wide": BP.wide_delay_network(48, buf=4096, max_delay=3000),
    "cross_fed": BP.cross_fed_delay_network(16),
    "follower": FOLLOWER_SRC,
    "stereo_followers": STEREO_FOLLOWERS_SRC,
    "wrap_and_sin": WRAP_SRC,
}


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("ZORAK_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(cgen, "CACHE_DIR", tmp_path / "cgen")


def _noise(n, seed=11, ch=2):
    return (np.random.RandomState(seed).randn(ch, n) * 0.25).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PLUGINS))
def test_generate_c_emits_the_jax_packages_text(name):
    src = PLUGINS[name]
    assert cgen.generate_c(compile_plugin_source(src)) == \
        jax_cgen.generate_c(jax_compile(src))


def _golden(prog, native):
    if native:
        gold = compile_native_shadow(prog)
        gold.state.srate = SR
        apply_slider_state(gold.state, prog, None)
        gold.run_init()
        gold.run_slider()
        return gold
    return make_initialized_shadow(prog, SR, None)


def _render(gold, x, block=512):
    y = np.zeros_like(x)
    for s in range(0, x.shape[1], block):
        gold.process_block(x[:, s:s + block], y[:, s:s + block])
    return y


@pytest.mark.parametrize("name", sorted(PLUGINS))
def test_native_golden_renders_as_the_python_golden(name, tmp_path):
    prog = compile_plugin_source(PLUGINS[name])
    x = _noise(6000)
    native, python = _golden(prog, True), _golden(prog, False)
    assert isinstance(native, NativeShadowPlugin)
    assert native.so_path.parent == tmp_path / "cgen"
    y_n, y_p = _render(native, x), _render(python, x)
    assert np.array_equal(y_n.view(np.int32), y_p.view(np.int32))
    rep = compare_states(python.state, native.state, eps=0.0)
    compare_memory_pages(python.state, native.state, eps=0.0, report=rep)
    assert rep.passed, rep.summary()


@pytest.mark.parametrize("name", ["wide", "cross_fed", "stereo_followers"])
@pytest.mark.parametrize("golden", ["native", "python"])
def test_null_test_plugin_holds_the_vector_render_to_either_golden(
        name, golden):
    prog = compile_plugin_source(PLUGINS[name])
    rep = null_test_plugin(prog, _noise(5000, seed=3), golden=golden,
                           device="cpu", compare_mem=True)
    assert rep.passed, rep.summary()
    assert rep.n_samples == 5000 and rep.n_channels == 2


def test_null_test_plugin_writes_the_export_bundle(tmp_path):
    prog = compile_plugin_source(PLUGINS["follower"])
    x = _noise(3000, seed=4)
    out = tmp_path / "bundle"
    rep = null_test_plugin(prog, x, golden="native", device="cpu",
                           export_dir=out, name="follower")
    assert rep.passed
    names = sorted(p.name for p in out.iterdir())
    assert names == ["follower_compiled.wav", "follower_delta.wav",
                     "follower_report.json", "follower_shadow.wav"]
    report = json.loads((out / "follower_report.json").read_text())
    assert report["samples"] == 3000 and report["channels"] == 2
    assert report["passed"] is True and report["audio_eps"] == 1e-5
    assert report["max_abs_delta"] == rep.max_abs_delta
    shadow, rate = wavio.read_wav(out / "follower_shadow.wav")
    assert rate == SR and shadow.shape == x.shape
    delta, _ = wavio.read_wav(out / "follower_delta.wav")
    assert np.abs(delta).max() <= 2.0 ** -23 + rep.max_abs_delta


def test_null_test_plugin_refuses_an_unknown_golden():
    prog = compile_plugin_source(PLUGINS["follower"])
    with pytest.raises(ValueError, match="golden"):
        null_test_plugin(prog, _noise(100), golden="c", device="cpu")


def test_cgen_error_is_the_packages_error_type():
    assert issubclass(CGenError, RuntimeError)
