"""The host services on the port: the JAX-free copies and what the device
sections make of them.

* The cases of tests/test_services.py, tests/test_import_recipes.py and
  tests/test_gfx.py that need neither JAX nor the catalog, run as they are
  written against the port's verbatim copies (`runtime/services.py`,
  `runtime/import_recipes.py`, `gfx/`): each test file's text with the
  package renamed, collected here case by case.
* The Faust modules against their NumPy goldens (`models/faust_golden.py`),
  as tests/test_faust_golden.py holds the JAX modules: audio within 1e-5.
* FILES, the recents and the import recipes through `save_state` and
  `load_state` (tests/test_engine.py's case against the port's instance).
* The sample pool's gathers (`csrc/block_ops.cuh` zb_pool_*) on their edge
  cases: a mono and a stereo entry, frames at half-way points, -0.5, the
  last frame and past it, NaN and +-inf phases, channels and sample ids
  out of range; K11's and K10's generated text compiled with g++
  -O2 -ffp-contract=off (their host forms) bit for bit to their plain
  versions (the Python golden answering through the host), at 1 and 3
  files.  Those skip with a reason where no host compiler is found.
* What stays refused, in the reference's words.
"""
import inspect
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import block_section as BS
from zorak_tpu_torch.kernels import device_exec as DX
from zorak_tpu_torch.lowering import specialize_sample_kernel
from zorak_tpu_torch.lowering.devexec import DeviceExecKernel
from zorak_tpu_torch.lowering.devgen import (DeviceSection, DevgenError,
                                             section_dynamic_keys)
from zorak_tpu_torch.models import get_faust_module
from zorak_tpu_torch.models.faust_golden import GOLDENS
from zorak_tpu_torch.runtime.engine import PluginInstance
from zorak_tpu_torch.runtime.services import EngineHost
from zorak_tpu_torch.verify import compare_audio, make_initialized_shadow

ROOT = Path(__file__).resolve().parents[1]
SR = 48000.0


# -- the reference's JAX-free cases, against the port's copies ----------------------

def _port_module(name: str) -> types.ModuleType:
    text = (ROOT / "tests" / f"{name}.py").read_text()
    mod = types.ModuleType(f"port_{name}")
    exec(compile(text.replace("zorak_tpu.", "zorak_tpu_torch."),
                 f"port_{name}.py", "exec"), mod.__dict__)
    return mod


def _cases():
    """(file, class or None, test) of every case that needs no catalog."""
    out = []
    for name in ("test_services", "test_import_recipes", "test_gfx"):
        mod = _port_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("test_") and callable(obj):
                out.append((name, None, attr, obj))
            elif attr.startswith("Test") and isinstance(obj, type):
                for meth, fn in vars(obj).items():
                    if meth.startswith("test_"):
                        out.append((name, obj, meth, fn))
    # the catalog is absent: its cases are the reference's own to run
    return [c for c in out if "reference_root" not in
            inspect.signature(c[3]).parameters
            and c[2] != "test_catalog_gfx_smoke"]


CASES = _cases()


@pytest.mark.parametrize(
    "case", CASES, ids=[f"{f}::{c.__name__ + '::' if c else ''}{t}"
                        for f, c, t, _fn in CASES])
def test_reference_case_on_the_port(case, tmp_path):
    _name, cls, _test, fn = case
    kwargs = {p: tmp_path for p in inspect.signature(fn).parameters
              if p == "tmp_path"}
    if cls is None:
        fn(**kwargs)
    else:
        fn(cls(), **kwargs)


def test_reference_cases_are_collected():
    # the services, recipes and gfx files hold 28 such cases
    assert len(CASES) >= 28


# -- the Faust goldens ---------------------------------------------------------------

def _faust_input(mod, seed=7, T=2500):
    rs = np.random.RandomState(seed)
    x = rs.randn(mod.n_in, T) * 0.25
    if mod.slug == "RED":
        x[4:] *= (np.arange(T) % 1200 < 700)
        x[:2] *= 0.5
    if mod.slug == "ClickBeGoneSG":
        x *= 0.05
        for pos in (400, 1100, 1900):
            x[:, pos] += 0.9
    return x


@pytest.mark.parametrize("perturbed", [False, True], ids=["defaults",
                                                          "perturbed"])
@pytest.mark.parametrize("slug", sorted(GOLDENS))
def test_faust_module_nulls_against_its_golden(slug, perturbed):
    mod = get_faust_module(slug)
    x = _faust_input(mod)
    over = {}
    if perturbed:
        for p in mod.params:
            v = p.lo + 0.37 * (p.hi - p.lo)
            over[p.name] = min(p.hi, max(p.lo, round(v) if p.step >= 1.0
                                         else v))
    v = mod.values(over)
    y = mod.render(torch.from_numpy(x), v, SR).numpy()
    rep = compare_audio(GOLDENS[slug](x, v, SR), y)
    assert rep.audio_passed, f"{slug}: {rep.summary()}"


# -- FILES through save_state / load_state -------------------------------------------

def test_save_restores_file_slots_and_recents(tmp_path):
    from zorak_tpu_torch.runtime import wavio

    wav = tmp_path / "probe.wav"
    wavio.write_wav(wav, np.zeros((1, 256), np.float32), 48000)
    src = "@sample\nspl0 *= 0.5;\n"
    inst = PluginInstance(compile_plugin_source(src), prefer="none",
                          host=EngineHost(), device="cpu")
    inst.load_file(0, wav)
    inst.import_recipes.append('{"action": 1}')
    blob = inst.save_state()
    assert blob["files"][0]["paths"] == [str(wav)]
    assert blob["recent_files"] == [str(wav)]
    assert blob["import_recipes"] == ['{"action": 1}']

    inst2 = PluginInstance(compile_plugin_source(src), prefer="none",
                           host=EngineHost(), device="cpu")
    inst2.load_state(blob)
    svc = inst2.shadow.state.host.files
    assert [e.path for e in svc.slots[0]] == [str(wav)]
    assert inst2.recent_files == [str(wav)]
    assert inst2.import_recipes == ['{"action": 1}']


def test_load_file_needs_a_file_service():
    inst = PluginInstance(compile_plugin_source("@sample\nspl0 *= 0.5;\n"),
                          prefer="none", device="cpu")
    with pytest.raises(RuntimeError, match="no file service"):
        inst.load_file(0, np.zeros((1, 8)))


# -- the pool's gathers on their edge cases, host forms against plain ------------------

def host_compiler_or_skip():
    try:
        _build.find_host_compiler()
    except RuntimeError as exc:
        pytest.skip(f"the host forms need a host C++ compiler: {exc}")


STEREO = np.random.RandomState(3).randn(2, 9) * 0.5
MONO = np.random.RandomState(4).randn(1, 6) * 0.5


def pool_host():
    h = EngineHost()
    h.files.load_slot(0, STEREO, srate=48000.0, name="st")
    h.files.load_slot(0, MONO, srate=48000.0, name="mono")
    return h


# heap cells the edge values lie in: sample ids, channels, phases
IDS, CHS, PHS = 100, 200, 300
EDGE_IDS = [1.0, 2.0, 0.0, 3.0, 1.7, -0.5, math.nan, math.inf]
EDGE_CHS = [0.0, 1.0, 1.9, 2.0, -1.0, 7.0, math.nan, -math.inf, math.inf]
EDGE_PHS = [0.0, 2.5, 3.5, 0.5, -0.5, -0.4, 4.5, 5.0, 5.5, 8.0, 8.5, 9.0,
            -1.0, 1e300, math.nan, math.inf, -math.inf, 7.25]

POOL_READS = """\
k = cnt % {ni}; j = (cnt + 3) % {nc}; q = (cnt * 7) % {np};
sid = IDS[k]; ch = CHS[j]; ph = PHS[q];
a = sample_read(pool, sid, ch, ph);
b = sample_read_interp(pool, sid, ch, ph);
o2 = sample_read2(pool, sid, ph, l2, r2);
o3 = sample_read2_interp(pool, sid, ph, l3, r3);
pv = sample_preview_read(pool, sid, ph, pmin, pmax, prms);
meta = sample_len(pool, sid) + sample_channels(pool, sid) * 1000
       + sample_srate(pool, sid) + sample_peak(pool, sid)
       + sample_rms(pool, sid) + sample_preview_bins(pool, sid)
       + sample_get(pool, ph) * 3;
acc += a + b * 2 + (l2 + r2) * 3 + (l3 + r3) * 5 + o2 + o3 * 7
       + (pv + pmin + pmax + prms) * 11 + meta * 1e-6;
OUT[cnt % 64] = a + b;
cnt += 1;
"""


def _edge_state(prog):
    snap = make_initialized_shadow(prog, SR, None, host=pool_host())
    st = snap.state
    st.mem_ensure(400)
    for base, vals in ((IDS, EDGE_IDS), (CHS, EDGE_CHS), (PHS, EDGE_PHS)):
        st.mem[base:base + len(vals)] = vals
    return snap


def _reads():
    return POOL_READS.format(ni=len(EDGE_IDS), nc=len(EDGE_CHS),
                             np=len(EDGE_PHS))


K11_SRC = ("@init\npool = sample_pool_from_slot(0, \"edges\");\n"
           "IDS = 100; CHS = 200; PHS = 300; OUT = 1000;\n"
           "@sample\n" + _reads() + "spl0 = spl0 * 0.5 + acc * 1e-9;\n")

K10_SRC = ("@init\npool = sample_pool_from_slot(0, \"edges\");\n"
           "IDS = 100; CHS = 200; PHS = 300; OUT = 1000;\n"
           "@block\nm = meter; meter = 0;\nloop(37,\n" + _reads() + ");\n"
           "@sample\nmeter += abs(spl0);\nspl0 = spl0 * 0.5 + acc * 1e-9;\n")


@pytest.mark.parametrize("nf", [1, 3])
def test_k11_pool_gathers_host_form_bit_for_bit(nf):
    host_compiler_or_skip()
    prog = compile_plugin_source(K11_SRC)
    snap = _edge_state(prog)
    kern = DeviceExecKernel(prog, snap.state, 1, block_size=64, device="cpu")
    assert kern.tables.pool is not None
    assert "zb_pool_read2" in kern.program.source
    T = 3 * 64 + 19            # every edge value, blocks and a remainder
    x = torch.from_numpy(np.random.RandomState(1).randn(nf, 1, T)
                         .astype(np.float32))
    bv, bm = kern.initial_carry()
    bv = bv.expand(nf, -1).contiguous()
    bm = bm.expand(nf, -1).contiguous()
    bv2, bm2 = bv.clone(), bm.clone()
    y = DX.device_exec_plain(kern.program, x, bv, bm)
    y2, _ = DX.device_exec_host(kern.program, x, bv2, bm2)
    assert torch.equal(y, y2)
    # the edge values hold NaN: compared as one value
    assert torch.equal(bv.nan_to_num(7.0), bv2.nan_to_num(7.0))
    assert torch.equal(bm.nan_to_num(7.0), bm2.nan_to_num(7.0))
    assert kern.tables.stagings == 1   # the host form's CPU copy, once


@pytest.mark.parametrize("nf", [1, 3])
def test_k10_pool_gathers_host_form_bit_for_bit(nf):
    host_compiler_or_skip()
    prog = compile_plugin_source(K10_SRC)
    snap = _edge_state(prog)
    kern = specialize_sample_kernel(prog, snap.state, 1, segment_len=512,
                                    device="cpu")
    assert kern.coupled and kern._block_prog.tabled
    bp = kern._block_prog
    bv0 = torch.from_numpy(bp.block.initial_vars())
    bm0 = torch.from_numpy(bp.block.initial_mem())
    outs = []
    for threads in (None, 0, 3):
        svec = torch.full((nf, bp.n_svec), 0.25, dtype=torch.float64)
        rings = [torch.zeros((nf, m), dtype=torch.float64)
                 for _o, m in bp.regions]
        bv = bv0.expand(nf, -1).contiguous().clone()
        bm = bm0.expand(nf, -1).contiguous().clone()
        for _block in range(3):
            if threads is None:
                BS.block_section_plain(bp, svec, rings, bv, bm, 512.0)
            else:
                BS.block_section_host(bp, svec, rings, bv, bm, 512.0,
                                      threads=threads)
        outs.append((bv.nan_to_num(7.0), bm.nan_to_num(7.0), svec))
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(a, b)


# -- what stays refused ---------------------------------------------------------------

def _section(src, sec, host=None, size=8192, reduced=False):
    prog = compile_plugin_source(src)
    snap = make_initialized_shadow(prog, SR, None, host=host)
    return DeviceSection(prog, snap.state, sec,
                         section_dynamic_keys(prog, (sec, "sample")), size,
                         reduced_heap=reduced)


@pytest.mark.parametrize("src, words", [
    ("@init\npool = sample_pool_from_slot(0, \"p\");\n@block\n"
     "sample_pool_commit(pool);\n@sample\nspl0 = spl0;\n",
     "cannot re-commit generations"),
    ("@init\npool = sample_pool_from_slot(0, \"p\");\n@block\n"
     "n = sample_export_mem(pool, 1, 100, 0, 8);\n@sample\nspl0 = spl0;\n",
     "device heap export not implemented"),
    ("@block\nx = file_string(0, s);\n@sample\nspl0 = spl0;\n",
     "does not run it on the device"),
    ("@block\nx = track_name(s);\n@sample\nspl0 = spl0;\n",
     "does not run it on the device"),
    ("@block\nh = file_open(slot);\n@sample\nslot = spl0;\n",
     "file_open with non-static arguments"),
    ("@block\nh = file_open(0);\nloop(2, file_var(h, v));\n@sample\n"
     "spl0 = spl0;\n", "inside a loop or a user function"),
    ("@block\nh = file_open(0);\nspl0 > 0 ? file_var(h, v);\n@sample\n"
     "spl0 = spl0;\n", "diverges across a data-dependent branch"),
    ("@block\nh = file_open(0);\nfile_mem(h, 8190, 400);\n@sample\n"
     "spl0 = spl0;\n", "static mem address 8208 beyond device heap"),
], ids=["commit", "export", "file_string", "track_name", "traced_slot",
        "file_in_loop", "file_in_branch", "past_the_heap"])
def test_refusals_keep_the_reference_words(src, words):
    with pytest.raises(DevgenError, match=words):
        _section(src, "block", host=pool_host())


def test_empty_pool_folds_to_the_golden_host():
    # no loaded generation: every pool call is the golden host's constant
    src = ("@init\npool = 0;\n@block\nv = sample_read(pool, 1, 0, x);\n"
           "ok = sample_read2(pool, 1, x, l, r);\nn = sample_pool_loaded(pool);\n"
           "@sample\nx = spl0;\n")
    sec = _section(src, "block", host=EngineHost())
    assert "zb_pool" not in sec.body_source and not sec.tables.used


def test_strings_and_clock():
    # static handles fold; a traced handle gathers over the literal pool;
    # time() reads the host's virtual clock
    host = EngineHost()
    host.time_seconds = 12.5
    src = ("@block\na = strlen(\"hello\");\nb = str_getchar(\"hello\", 1);\n"
           "c = strlen(h);\nd = str_getchar(h, i);\nt = time_precise();\n"
           "t2 = 0;\ntime(t2);\n@sample\nh = spl0; i = spl1;\n")
    sec = _section(src, "block", host=host)
    text = sec.body_source
    assert "zb_strlen(&S->H" in text and "zb_str_getchar(&S->H" in text
    assert "0x1.4000000000000p+2" in text      # strlen("hello") = 5
    assert "0x1.9000000000000p+3" in text      # the clock, 12.5
    assert sec.tables.strings is not None


def test_a_loop_of_pool_reads_runs_across_the_block():
    # a pool read is a pure gather: K10 runs such a loop across the
    # file's threads, and its host form agrees with the one-thread form
    src = ("@init\npool = sample_pool_from_slot(0, \"p\");\nOUT = 500;\n"
           "@block\ni = 0;\nloop(16, OUT[i] = sample_read_interp(pool, 1, 1, "
           "i * 0.5 + ph) + sample_len(pool, 2); i += 1;);\n"
           "@sample\nph = abs(spl0);\n")
    sec = _section(src, "block", host=pool_host())
    assert [p.kind for p in sec.phases] == ["serial", "loop"]
    assert not sec.serial_loops and sec.tables.pool is not None
