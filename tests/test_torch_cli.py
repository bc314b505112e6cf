"""zorak_tpu_torch CLI, catalog, WAV IO and the port's rules, on the CPU.

The CLI runs on a minimal catalog built in tmp_path to the leaf schema of
catalog/discovery.py, beside zorak_tpu's own CLI on the same files.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from zorak_tpu.catalog import discover as jax_discover
from zorak_tpu.cli.main import main as jax_main
from zorak_tpu.runtime import wavio as jax_wavio
from zorak_tpu_torch.catalog import discover
from zorak_tpu_torch.cli.main import main
from zorak_tpu_torch.convert import state_from_numpy
from zorak_tpu_torch.parallel import FaustBatchRenderer
from zorak_tpu_torch.runtime import wavio
from zorak_tpu_torch.verify import compare_audio

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 48000

LEAVES = {
    ("Restoration", "VAR"): ("Vocal Air Recovery", "Zvar", "faust", ".dsp"),
    ("Dynamics", "GTS"): ("Gaussian Transient Shaper", "Zgts", "faust", ".dsp"),
    ("Dynamics", "RED"): ("Reverb Expanding Downwards", "Zred", "faust", ".dsp"),
    ("Delay", "Echo"): ("Echo", "Zech", "jsfx", ".jsfx"),
}


@pytest.fixture
def catalog(tmp_path):
    root = tmp_path / "catalog"
    for (category, slug), (name, code, ptype, ext) in LEAVES.items():
        leaf = root / "plugins" / category / slug
        (leaf / "src").mkdir(parents=True)
        (leaf / "plugin.json").write_text(json.dumps({
            "name": name, "slug": slug, "pluginCode": code,
            "pluginType": ptype}))
        src = ("import(\"stdfaust.lib\");\nprocess = _, _;\n" if ext == ".dsp"
               else "desc:Echo\n@sample\nspl0 = spl0;\n")
        (leaf / "src" / f"{slug}{ext}").write_text(src)
    (root / "plugins" / "Restoration" / "VAR" / "README.md").write_text("# VAR\n")
    return root


def _run(fn, argv, capsys):
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("cmd", ["list", "inspect"])
@pytest.mark.parametrize("only", ["", "VAR", "Dynamics"])
def test_list_and_inspect_match_jax_cli(catalog, capsys, cmd, only):
    argv = [cmd, "--catalog", str(catalog), "--only", only]
    rc, out, _ = _run(main, argv, capsys)
    assert rc == 0
    rc_j, out_j, _ = _run(jax_main, argv, capsys)    # JSFX entries too
    assert rc_j == 0 and out == out_j
    if cmd == "inspect" and not only:
        assert "desc: Echo" in out


@pytest.mark.parametrize("slug", ["VAR", "GTS", "RED"])
def test_render_cpu_round_trips_a_wav_like_jax_cli(catalog, capsys, tmp_path,
                                                   slug):
    x = (np.random.RandomState(5).randn(2, 3000) * 0.25).astype(np.float32)
    wav_in = tmp_path / "in.wav"
    wavio.write_wav(wav_in, x, SR, float_fmt=True)
    out_p, out_j = tmp_path / "port.wav", tmp_path / "jax.wav"
    common = ["--catalog", str(catalog), "--only", slug, "--in", str(wav_in)]
    rc, out, _ = _run(main, ["render", *common, "--out", str(out_p),
                             "--device", "cpu"], capsys)
    assert rc == 0 and "via cpu-faust" in out
    assert _run(jax_main, ["render", *common, "--out", str(out_j)],
                capsys)[0] == 0
    y_p, rate = wavio.read_wav(out_p)
    y_j, _ = jax_wavio.read_wav(out_j)
    assert rate == SR and y_p.shape == y_j.shape
    assert y_p.shape[0] == (6 if slug == "RED" else 2)
    rep = compare_audio(y_j, y_p)
    assert rep.audio_passed, rep.summary()


def test_render_jsfx_on_torch_vector_or_cpu_shadow(catalog, capsys, tmp_path):
    # a JSFX plugin whose regime the vector engine does not carry yet (an
    # audio-coupled @block) renders through the golden, and the CLI says
    # so with the reason; one the engine carries says torch-vector
    x = (np.random.RandomState(2).randn(2, 1500) * 0.25).astype(np.float32)
    wav_in = tmp_path / "in.wav"
    wavio.write_wav(wav_in, x, SR, float_fmt=True)
    common = ["render", "--catalog", str(catalog), "--only", "Echo", "--in",
              str(wav_in), "--out", str(tmp_path / "o.wav"), "--device", "cpu"]
    rc, out, _ = _run(main, common, capsys)
    assert rc == 0 and "via torch-vector" in out
    echo = catalog / "plugins" / "Delay" / "Echo" / "src" / "Echo.jsfx"
    echo.write_text("desc:Echo\n@sample\nacc += abs(spl0);\nspl0 *= g;\n"
                    "@block\ng = 1/(1 + acc*0.001);\n")
    rc, out, _ = _run(main, common, capsys)
    assert rc == 0 and "via cpu-shadow" in out
    assert "vector engine refused the plugin" in out and "slice 6" in out
    with pytest.raises(Exception, match="slice 6"):
        main([*common, "--engine", "vector"])


def _echo_source(catalog, text):
    (catalog / "plugins" / "Delay" / "Echo" / "src" / "Echo.jsfx").write_text(
        text)


ECHO_FOLLOWER = ("desc:Echo\n@init\nup = 0.9; dn = 0.999;\n@sample\n"
                 "x = abs(spl0);\n"
                 "env = x > env ? x + (env - x)*up : x + (env - x)*dn;\n"
                 "spl0 = env; spl1 = spl1*0.5;\n")


@pytest.mark.parametrize("golden", ["python", "native"])
def test_verify_null_tests_jsfx_entries_against_either_golden(
        catalog, capsys, tmp_path, monkeypatch, golden):
    from zorak_tpu_torch.shadow import cgen

    monkeypatch.setattr(cgen, "CACHE_DIR", tmp_path / "cgen")
    _echo_source(catalog, ECHO_FOLLOWER)
    rc, out, _ = _run(main, ["verify", "--catalog", str(catalog), "--seconds",
                             "0.1", "--golden", golden, "--device", "cpu"],
                      capsys)
    assert rc == 0
    lines = out.splitlines()
    assert sum("faust module (no shadow null test)" in ln for ln in lines) == 3
    echo = [ln for ln in lines if ln.startswith("Echo: ")]
    assert len(echo) == 1 and "PASS" in echo[0]
    # the JAX package's CLI prints the same lines for the Faust entries
    rc_j, out_j, _ = _run(jax_main, ["verify", "--catalog", str(catalog),
                                     "--only", "VAR", "--golden", golden],
                          capsys)
    assert rc_j == 0 and out_j == "VAR: faust module (no shadow null test)\n"


def test_verify_writes_the_export_bundle(catalog, capsys, tmp_path,
                                         monkeypatch):
    from zorak_tpu_torch.shadow import cgen

    monkeypatch.setattr(cgen, "CACHE_DIR", tmp_path / "cgen")
    _echo_source(catalog, ECHO_FOLLOWER)
    out_dir = tmp_path / "bundle"
    rc, out, _ = _run(main, ["verify", "--catalog", str(catalog), "--only",
                             "Echo", "--seconds", "0.05", "--export-dir",
                             str(out_dir), "--device", "cpu"], capsys)
    assert rc == 0 and out.startswith("Echo: ") and "PASS" in out
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "Echo_compiled.wav", "Echo_delta.wav", "Echo_report.json",
        "Echo_shadow.wav"]
    report = json.loads((out_dir / "Echo_report.json").read_text())
    assert report["passed"] is True and report["samples"] == 2400


def test_verify_prints_skip_where_the_vector_engine_refuses(catalog, capsys,
                                                            tmp_path,
                                                            monkeypatch):
    from zorak_tpu_torch.shadow import cgen

    monkeypatch.setattr(cgen, "CACHE_DIR", tmp_path / "cgen")
    # an audio-coupled @block: the coupled regime is not ported yet
    _echo_source(catalog, "desc:Echo\n@sample\nacc += abs(spl0);\n"
                 "spl0 *= g;\n@block\ng = 1/(1 + acc*0.001);\n")
    rc, out, _ = _run(main, ["verify", "--catalog", str(catalog), "--only",
                             "Echo", "--seconds", "0.05", "--device", "cpu"],
                      capsys)
    assert rc == 0
    assert out.startswith("Echo: SKIP vector engine (") and "slice 6" in out
    assert out.rstrip().endswith(") — shadow-only")


def test_render_needs_exactly_one_plugin(catalog, capsys, tmp_path):
    rc, _, err = _run(main, ["render", "--catalog", str(catalog), "--only",
                             "Dynamics", "--in", "x.wav", "--out", "y.wav",
                             "--device", "cpu"], capsys)
    assert rc == 2 and "exactly one plugin" in err


def test_discovery_matches_jax(catalog):
    fields = ("category", "key", "name", "slug", "plugin_code", "bundle_id",
              "clap_id", "clap_features", "plugin_type", "entry_path",
              "readme_path")
    port = [{f: getattr(s, f) for f in fields} for s in discover(catalog)]
    ref = [{f: getattr(s, f) for f in fields} for s in jax_discover(catalog)]
    assert port == ref and len(port) == len(LEAVES)


@pytest.mark.parametrize("bits,float_fmt", [(16, False), (24, False),
                                            (32, False), (32, True)])
def test_wavio_matches_jax(tmp_path, bits, float_fmt):
    x = np.clip(np.random.RandomState(bits).randn(3, 500) * 0.3, -1, 1)
    for writer, reader in ((wavio, jax_wavio), (jax_wavio, wavio)):
        p = tmp_path / f"{writer.__name__}.wav"
        writer.write_wav(p, x, SR, bits=bits, float_fmt=float_fmt)
        got, rate = reader.read_wav(p)
        want, _ = writer.read_wav(p)
        assert rate == SR and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the port's rules

_IMPORT_ALL = """
import importlib, pkgutil, sys
import zorak_tpu_torch
names = [m.name for m in pkgutil.walk_packages(zorak_tpu_torch.__path__,
                                                "zorak_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "zorak_tpu" or m.startswith("zorak_tpu."))
print(len(names), bad, sorted(names))
"""

# every module of the JSFX path must be among those the fresh process imports
_JSFX_MODULES = [
    "builtin_plugins", "convert", "frontend.lexer", "frontend.parser",
    "frontend.sections", "frontend.directives", "frontend.printer",
    "ir.program", "ir.analyses", "ir.funcsl", "ir.gfxsync", "ir.symbols",
    "semantics.scalar", "semantics.mt19937np", "shadow.state",
    "shadow.pyexec", "lowering.eelmath", "lowering.specialize",
    "runtime.engine", "runtime.fftops", "kernels.linrec_scan",
    "kernels.ring_taps", "kernels.scan_group",
    "kernels._build", "lowering.scan_codegen", "verify.nulltest", "cli.main",
]

# every module of the spectral and convolution slice and of the native golden
_SPECTRAL_MODULES = ["kernels.stft", "kernels.convolution", "bench",
                     "shadow.cgen"]

# the batch path and the catalog it sweeps
_BATCH_MODULES = ["parallel", "parallel.batch", "catalog.discovery",
                  "models.faustmods"]


def test_port_imports_neither_jax_nor_zorak_tpu():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, rest = res.stdout.split(" ", 1)
    bad, names = rest.split("] [", 1)
    assert int(n) >= 52 and bad.strip() == "["
    for mod in _JSFX_MODULES + _SPECTRAL_MODULES + _BATCH_MODULES:
        assert f"'zorak_tpu_torch.{mod}'" in names, mod


def test_entry_points_without_device_need_a_gpu(catalog, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        FaustBatchRenderer("VAR")
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(np.zeros(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["render", "--catalog", str(catalog), "--only", "Echo",
              "--in", str(tmp_path / "in.wav"), "--out",
              str(tmp_path / "o.wav")])
    wav_in = tmp_path / "in.wav"
    wavio.write_wav(wav_in, np.zeros((2, 100), np.float32), SR)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["render", "--catalog", str(catalog), "--only", "VAR",
              "--in", str(wav_in), "--out", str(tmp_path / "o.wav")])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["verify", "--catalog", str(catalog), "--only", "Echo"])


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
