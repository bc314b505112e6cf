"""The sequential device executor (devexec, K11) on the CPU: the port's
plain version and K11's generated text in its host form, against the JAX
package's DeviceExecKernel and the native golden.

Each case of tests/test_devexec.py that needs no host service renders the
same seeded numpy input three ways: the port's `DeviceExecKernel` on CPU
tensors (K11's plain version: the Python golden with the reduced heap and
the staged draw pool), the JAX `DeviceExecKernel` and the native C golden
(state and heap compared).  Tolerances, the reference's: audio within
1e-5 after f32 rounding and at most 1e-6, vars and heap within 1e-8.  The
largest port-against-JAX audio difference prints under `-s`.  The host
form (K11's text compiled with g++ -O2 -ffp-contract=off) is held bit for
bit to the plain version on the same cases; it skips with a reason where
no host compiler is found.  JAX builds stay narrow (the stand-in at 2
grains and rings of 1,024, at most 3,000 samples).
"""
import numpy as np
import pytest
import torch

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import SpecializeError as JaxSpecializeError
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.lowering.devexec import DeviceExecKernel as JaxDeviceExec
from zorak_tpu.runtime.engine import PluginInstance as JaxInstance
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins, convert
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import block_section as BS
from zorak_tpu_torch.kernels import device_exec as DX
from zorak_tpu_torch.lowering import SpecializeError, specialize_sample_kernel
from zorak_tpu_torch.lowering.devexec import DeviceExecKernel
from zorak_tpu_torch.runtime.engine import PluginInstance
from zorak_tpu_torch.semantics import mt19937np as MT
from zorak_tpu_torch.shadow import compile_native_shadow
from zorak_tpu_torch.shadow.state import MidiEvent
from zorak_tpu_torch.verify import apply_slider_state, compare_audio
from zorak_tpu_torch.verify.nulltest import (
    compare_memory_pages, compare_midi_out, compare_states,
    make_initialized_shadow, null_test_plugin)

SR = 48000.0
AUDIO_MAX = 1e-6


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def noise(ch, n, seed=5, scale=0.6):
    return (np.random.RandomState(seed).randn(ch, n) * scale).astype(
        np.float32)


def host_compiler_or_skip():
    try:
        _build.find_host_compiler()
    except RuntimeError as exc:
        pytest.skip(f"K11's host form needs a host C++ compiler: {exc}")


def _while_src():
    body = ["vi = 0;", "acc = 0;", "while (vi < 16) (",
            "  v = 100 + vi * 8;"]
    for k in range(10):
        c = f"buf[v + {k % 8}]"
        body.append(f"  {c} > 0.5 ? (acc += {c} * 0.01; {c} -= 0.1;)"
                    f" : ({c} += abs(spl0) * 0.03;);")
    body += ["  vi += 1;", ");"]
    return ("options: maxmem=4096\n@init\nbuf = 1000;\n@sample\n"
            + "\n".join(body) + "\nspl0 = spl0 * 0.7 + acc;\n")


MIDI_SRC = ("@init\nlast = 0;\n"
            "@block\n"
            "while (midirecv(ofs, m1, m23)) (\n"
            "  last = m23 & 127;\n"
            "  midisend(ofs, m1, m23);\n"
            ");\n"
            "@sample\nspl0 = spl0 * 0.5 + last / 254;\n")

# K11 keeps the heap's first 4,096 cells on chip: cells 4,090 to 4,100
# read and written, statically and dynamically, and memcpy, memset and the
# FFT family on runs inside that page, past it and across cell 4,096
PAGE_EDGE_SRC = (
    "options:maxmem=16384\n"
    "@init\n"
    "e = 4090; A = 3000; B = 8000; C = 4080; D = 4088;\n"
    "n = 0;\n"
    "@sample\n"
    "k = 0;\n"
    "loop(11, e[k] = e[k] * 0.5 + spl0 * (k + 1) * 0.1; k += 1;);\n"
    "acc = e[2] + e[7] + e[k - 1];\n"
    "n += 1;\n"
    "m = n % 128;\n"
    "m == 10 ? ( memcpy(1000, 4088, 16); memset(6000, acc, 16);\n"
    "            memcpy(4070, 6000, 40); memcpy(5200, 6000, 16); );\n"
    "m == 20 ? ( memcpy(5000, 4085, 24); memset(4091, spl0, 8);\n"
    "            memcpy(2000, 1000, 16); memset(5100, acc * 2, 8);\n"
    "            memset(2100, acc, 8); );\n"
    "m == 30 ? ( i = 0; loop(32, A[i] = e[i % 11] * 0.01 + i * 0.001;\n"
    "            B[i] = A[i] * 2; C[i] = A[i] * 3; i += 1;);\n"
    "            fft(A, 16); ifft(A, 16); fft(B, 16); ifft(B, 16);\n"
    "            fft(C, 16); ifft(C, 16); );\n"
    "m == 40 ? ( convolve_c(D, A, 8); fft_real(C, 32); );\n"
    "spl0 = spl0 * 0.5 + acc * 0.01;\n")

# the cases whose heap holds FFT results: K11's radix-2 against NumPy's
# FFT, within FFT_TOL_REL
FFT_CASES = ("fft_traced_base", "page_edge")

# name -> (source, input, renders, MIDI in)
CASES = {
    "voice_loop": (
        "@init\nbuf = 1000;\nn_active = 0;\n"
        "@block\nctr += 1;\n"
        "@sample\n"
        "x = abs(spl0);\n"
        "x > 0.5 ? n_active = min(n_active + 2, 8) :"
        " (n_active > 0 ? n_active -= 1);\n"
        "acc = 0; i = 0;\n"
        "loop(n_active,\n"
        "  acc += buf[i] * 0.1 + x * 0.01;\n"
        "  buf[i] = x;\n"
        "  i += 1;\n"
        ");\n"
        "spl0 = spl0 * 0.7 + acc * 0.05;\n"
        "spl1 = spl1 * 0.7;\n", noise(2, 3000), 1, None),
    "rand_resumed": (
        "@init\nnz = 0;\n"
        "@block\n"
        "want = 2 + (bc % 3);\nbc += 1;\ni = 0;\n"
        "loop(want, noise[i] = rand(2) - 1; i += 1; );\n"
        "@sample\n"
        "p = abs(spl0) > 0.4 ? rand() * 0.1 : 0;\n"
        "spl0 = spl0 * 0.8 + p + noise[0] * 0.01;\n", noise(1, 3000), 3,
        None),
    "pending_retrigger": (
        "slider1:10<0,100,1>Amt\n"
        "@init\nq = 0;\n"
        "@slider\ng = slider1 / 100;\n"
        "@block\n"
        "bc += 1;\n"
        "bc == 3 ? ( slider1 = 50; sliderchange(slider1); );\n"
        "@sample\nspl0 *= g;\n", noise(1, 4000), 1, None),
    "fft_traced_base": (
        "@init\nbufA = 1024; bufB = 2048;\nacc = 0;\n"
        "@sample\n"
        "sel = spl0 > 0 ? bufA : bufB;\n"
        "sel[w] = spl0;\n"
        "w += 1;\n"
        "w >= 64 ? (\n"
        "  w = 0;\n"
        "  fft_real(sel, 64);\n"
        "  fft_permute(sel, 16);\n"
        "  acc = sel[0] * 0.01 + sel[2] * 0.005;\n"
        "  j = 0; loop(64, sel[j] = 0; j += 1;);\n"
        ");\n"
        "spl0 = spl0 * 0.5 + acc * 0.001;\n", noise(1, 2000), 1, None),
    "growing_heap": (
        "@init\nbuf = 100;\nctr = 0;\n"
        "@sample\n"
        "n = abs(spl0) > 0.2 ? 3 : 1;\n"
        "loop(n, buf[ctr] = spl0; ctr += 1; );\n"
        "spl0 = spl0 * 0.5 + buf[ctr > 3000 ? ctr - 3000 : 0]"
        " * 0.1;\n", noise(1, 6000), 1, None),
    "static_while": (_while_src(), noise(1, 2000), 1, None),
    "midi_in_and_out": (MIDI_SRC, noise(1, 1024), 1,
                        [(10, 0x90, 60, 100), (600, 0x80, 60, 0)]),
    "page_edge": (PAGE_EDGE_SRC, noise(1, 3000), 1, None),
}


def golden_render(prog, x, midi=None, B=512):
    """The native golden over x in blocks of B with the host's MIDI:
    (golden, audio, MIDI out)."""
    gold = compile_native_shadow(prog)
    gold.state.srate = SR
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y = np.zeros_like(x)
    out = []
    for s in range(0, x.shape[1], B):
        e = min(s + B, x.shape[1])
        gold.state.midi_in = [MidiEvent(int(v[0]) - s, v[1], v[2], v[3])
                              for v in midi or () if s <= v[0] < e]
        gold.state.midi_in_pos = 0
        gold.process_block(x[:, s:e], y[:, s:e])
        out += [(s + int(ev.offset), ev.b1, ev.b2, ev.b3)
                for ev in gold.state.midi_out]
        gold.state.midi_out = []
    return gold, y, out


def split_render(kern, x, renders, midi=None):
    """x in `renders` parts (whole blocks but the last), each resuming from
    the last one's carry: (audio, final carry)."""
    cut = max(512, (x.shape[1] // renders // 512) * 512)
    parts, carry, pos = [], None, 0
    while pos < x.shape[1]:
        stop = x.shape[1] if len(parts) == renders - 1 \
            else min(pos + cut, x.shape[1])
        y, carry = kern.render(x[:, pos:stop], carry=carry, midi=midi)
        parts.append(np.asarray(y))
        pos = stop
    return np.concatenate(parts, axis=1), carry


def held(gold_state, y_ref, y, state, what):
    rep = compare_audio(y_ref, y)
    assert rep.audio_passed and rep.max_abs_delta <= AUDIO_MAX, \
        f"{what}: {rep.summary()}"
    rep = compare_states(gold_state, state)
    compare_memory_pages(gold_state, state, report=rep)
    assert rep.passed, f"{what}: {rep.summary()}"


def three_ways(src, x, renders=1, midi=None):
    """The port's plain version, the JAX kernel and the native golden on
    one input; returns (port kernel, port audio, JAX audio, golden)."""
    prog = compile_plugin_source(src)
    gold, y_ref, mout_ref = golden_render(prog, x, midi)
    owner = make_initialized_shadow(prog, SR, None)
    kern = DeviceExecKernel(prog, owner.state, x.shape[0], device="cpu")
    assert kern.engine == "devexec" and kern.coupled
    y, carry = split_render(kern, x, renders, midi)
    kern.writeback(carry, owner.state)
    held(gold.state, y_ref, y, owner.state, "port")
    if mout_ref or kern.last_midi_out:
        rep = compare_midi_out(mout_ref, kern.last_midi_out)
        assert rep.passed, rep.summary()

    jprog = jax_compile(src)
    jowner = jax_shadow(jprog, SR, None)
    jkern = JaxDeviceExec(jprog, jowner.state, x.shape[0], block_size=512)
    y_jax, jcarry = split_render(jkern, x, renders, midi)
    jkern.writeback(jcarry, jowner.state)
    rep = compare_audio(y_ref, y_jax)
    assert rep.audio_passed and rep.max_abs_delta <= AUDIO_MAX, rep.summary()
    if midi:
        assert kern.last_midi_out == list(jkern.last_midi_out)
    delta = float(np.abs(y.astype(np.float64) - y_jax).max())
    print(f"port vs JAX: max |audio delta| {delta:.3e}, heap "
          f"{kern.mem_size} and {jkern.sample.mem_size} cells")
    assert delta <= AUDIO_MAX
    for name, v in owner.state.V.items():
        w = jowner.state.V.get(name, 0.0)
        assert abs(v - w) <= 1e-8 * max(1.0, abs(w)) or (v != v and w != w), \
            (name, v, w)
    return kern, y, y_jax, gold


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_ways(name, monkeypatch):
    from zorak_tpu.lowering import devgen as JDG

    # the JAX trace of the 16-voice while: the reference's test sets the
    # merge budget that keeps it one loop body (its TPU compile limit)
    monkeypatch.setattr(JDG.DeviceSection, "_UNROLL_MERGE_BUDGET", 48)
    src, x, renders, midi = CASES[name]
    kern, _y, _yj, _gold = three_ways(src, x, renders, midi)
    if name == "midi_in_and_out":
        assert kern.last_midi_out
    if name == "growing_heap":
        assert kern.mem_size > 4096 and kern.heap_climbs
    if name == "rand_resumed":
        assert kern.uses_rand and kern.last_draws > 0
    if name == "page_edge":
        assert kern.mem_size == 8192 and "S->P[4092]" in \
            kern.program.source and "S->M[4097]" in kern.program.source


def test_engine_falls_back_to_devexec():
    src = ("@init\nbuf = 0;\n"
           "@sample\n"
           "n = abs(spl0) > 0.3 ? 3 : 1;\n"
           "s = 0; i = 0;\n"
           "loop(n, s += buf[i]; buf[i] = spl0 * 0.5; i += 1; );\n"
           "spl0 = spl0 * 0.6 + s * 0.1;\n")
    inst = PluginInstance(compile_plugin_source(src),
                          smart_idle="always_awake", device="cpu")
    jinst = JaxInstance(jax_compile(src), smart_idle="always_awake")
    assert inst.engine == "torch-devexec" and jinst.engine == "tpu-devexec"
    assert isinstance(inst.kernel, DeviceExecKernel)
    assert "devexec" not in inst.spec_error      # the vectorizer's reason
    x = noise(1, 2048)
    res, jres = inst.render(x), jinst.render(x)
    assert res.engine == "torch-devexec"
    _gold, y_ref, _ = golden_render(compile_plugin_source(src), x)
    assert np.abs(res.audio.astype(np.float64) - y_ref).max() <= AUDIO_MAX
    assert np.abs(res.audio.astype(np.float64) - jres.audio).max() <= AUDIO_MAX


POOL_SRC = ("@init\n"
            "pool = sample_pool_from_slot(0, #nm);\n"
            "sample_pool_commit(pool);\n"
            "nsel = sample_pool_loaded(pool);\n"
            "sid = sample_get(pool, 0);\n"
            "len0 = sample_len(pool, sid);\n"
            "pk = sample_peak(pool, sid);\n"
            "pos = 0;\n"
            "@sample\n"
            "sid2 = abs(spl0) > 0.3 ? sid : sample_get(pool, 1);\n"
            "v = sample_read(pool, sid2, 0, pos);\n"
            "vi = sample_read_interp(pool, sid2, 1, pos * 0.5 + 0.25);\n"
            "ok = sample_read2_interp(pool, sid2, pos * 0.33, l, r);\n"
            "spl0 = spl0 * 0.5 + v * 0.3 + vi * 0.1 + l * 0.05"
            " + ok * 0.001 + pk * 0.001;\n"
            "spl1 = spl1 * 0.5 + r * 0.2;\n"
            "pos += 1;\n"
            "pos >= len0 ? pos = 0;\n")


def pool_hosts(services):
    """A host of `services` (either package's runtime.services) whose slot
    0 holds tests/test_devexec.py's two waves: a stereo one at 44.1 kHz,
    which the pool resamples, and a mono one."""
    rng = np.random.RandomState(9)
    wave_a = rng.randn(2, 220) * 0.4
    wave_b = rng.randn(1, 97) * 0.7
    h = services.EngineHost()
    h.files.load_slot(0, wave_a, srate=44100.0, name="a")
    h.files.load_slot(0, wave_b, srate=48000.0, name="b")
    return h


def pool_three_ways(src, x, renders=1):
    """A plugin over a loaded sample pool three ways, each with a host of
    its own: the port's DeviceExecKernel (the plain version answering the
    pool's calls through the port's EngineHost), the JAX kernel and the
    native golden; returns the port's kernel."""
    from zorak_tpu.runtime import services as jax_services
    from zorak_tpu_torch.runtime import services

    prog = compile_plugin_source(src)
    gold = compile_native_shadow(prog, host=pool_hosts(services))
    gold.state.srate = SR
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y_ref = np.zeros_like(x)
    for s0 in range(0, x.shape[1], 512):
        e = min(s0 + 512, x.shape[1])
        gold.process_block(x[:, s0:e], y_ref[:, s0:e])
    owner = make_initialized_shadow(prog, SR, None,
                                    host=pool_hosts(services))
    assert owner.state.host.pool.generation is not None
    kern = DeviceExecKernel(prog, owner.state, x.shape[0], device="cpu")
    y, carry = split_render(kern, x, renders)
    kern.writeback(carry, owner.state)
    held(gold.state, y_ref, y, owner.state, "port")
    assert kern.tables.pool is not None and "zb_pool_" in \
        kern.program.source

    jprog = jax_compile(src)
    jowner = jax_shadow(jprog, SR, None, host=pool_hosts(jax_services))
    jkern = JaxDeviceExec(jprog, jowner.state, x.shape[0], block_size=512)
    y_jax, jcarry = split_render(jkern, x, renders)
    jkern.writeback(jcarry, jowner.state)
    delta = float(np.abs(y.astype(np.float64) - y_jax).max())
    print(f"port vs JAX over the loaded pool: max |audio delta| {delta:.3e}")
    assert delta <= AUDIO_MAX
    for name, v in owner.state.V.items():
        w = jowner.state.V.get(name, 0.0)
        assert abs(v - w) <= 1e-8 * max(1.0, abs(w)) or (v != v and w != w), \
            (name, v, w)
    return kern


def test_loaded_pool_device_gathers():
    # the reference's case: reads over a loaded generation are gathers
    # over its packed tables, bit for bit with the golden's host; two
    # renders, the second resumed
    pool_three_ways(POOL_SRC, noise(2, 2500), renders=2)


def test_pool_calls_are_refused_with_the_services_slice():
    # once refused until the services copy came; now the engine takes the
    # plugin to devexec (the vectorizer rejects its traced pool reads) and
    # K11 gathers the pool: held to the golden and the JAX kernel
    from zorak_tpu_torch.runtime import services

    src = ("@init\n"
           "pool = sample_pool_from_slot(0, #nm);\n"
           "sid = sample_get(pool, 0);\n"
           "pos = 0;\n"
           "@sample\n"
           "v = sample_read(pool, sid, 0, pos);\n"
           "spl0 = spl0 * 0.5 + v * 0.3;\n"
           "pos += 1;\n")
    prog = compile_plugin_source(src)
    inst = PluginInstance(prog, host=pool_hosts(services), device="cpu",
                          smart_idle="always_awake")
    assert inst.engine == "torch-devexec" and "devexec" not in \
        inst.spec_error
    pool_three_ways(src, noise(1, 1500))
    # with no host services the pool is empty: every call folds inert
    assert PluginInstance(prog, device="cpu").engine == "torch-devexec"


def test_pool_sampler_stand_in_against_the_golden():
    # the stand-in at 4 voices over 5 entries of 0.05 s (every entry
    # retriggered in 0.3 s): a vectorizer reject, K11's plain version
    # equal to the native golden; 3 files equal to their solo renders
    from zorak_tpu_torch.runtime import services

    def host():
        h = services.EngineHost()
        for audio, rate in builtin_plugins.sampler_slot(5, 0.05, seed=2):
            h.files.load_slot(0, audio, srate=rate)
        return h

    prog = compile_plugin_source(builtin_plugins.pool_sampler(4, 5))
    x = noise(2, 14400, seed=3)
    gold = compile_native_shadow(prog, host=host())
    gold.state.srate = SR
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y_ref = np.zeros_like(x)
    for s0 in range(0, x.shape[1], 512):
        e = min(s0 + 512, x.shape[1])
        gold.process_block(x[:, s0:e], y_ref[:, s0:e])
    inst = PluginInstance(prog, host=host(), device="cpu",
                          smart_idle="always_awake")
    assert inst.engine == "torch-devexec", inst.spec_error
    res = inst.render(x)
    held(gold.state, y_ref, res.audio, inst.shadow.state, "sampler")
    assert gold.state.V["trig"] > 4 + 5      # every entry retriggered
    xs = np.stack([noise(2, 1100, seed=k) for k in range(3)])
    ys, _ = inst.kernel.render_files(xs)
    stagings = inst.kernel.tables.stagings
    for k in range(3):
        solo, _ = inst.kernel.render_device(xs[k])
        assert torch.equal(ys[k], solo)
    assert inst.kernel.tables.stagings == stagings == 0   # CPU: none


def _program_and_inputs(kern, nf, T, seed):
    """K11's inputs for nf files of T samples from the kernel's initial
    carry: (x, vars, heap, pool)."""
    x = torch.from_numpy(np.stack([noise(kern.nch, T, seed=seed + f)
                                   for f in range(nf)]))
    bv, bm = kern.initial_carry()
    bv = bv.expand(nf, -1).contiguous()
    bm = bm.expand(nf, -1).contiguous()
    pool = None
    if kern.uses_rand:
        pool = kern._stage_rand_pool(None)
        bv[:, kern._rpos] = 0.0
    return x, bv, bm, pool


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_form_bit_for_bit(name):
    # 3 files, 2 blocks and a remainder of 76; the heap at the rung the
    # case's render climbed to
    host_compiler_or_skip()
    src, x0, _renders, midi = CASES[name]
    prog = compile_plugin_source(src)
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog, SR).state,
                            x0.shape[0], device="cpu")
    kern.render(x0)
    T = 1100
    x, bv, bm, pool = _program_and_inputs(kern, 3, T, seed=11)
    planes = None
    if kern.accepts_midi:
        mev, mn = kern._midi_planes(midi, T)
        planes = (torch.from_numpy(mev), torch.from_numpy(mn))
    bv2, bm2 = bv.clone(), bm.clone()
    y, mo = DX.device_exec(kern.program, x, bv, bm, pool, planes)
    y2, mo2 = DX.device_exec_host(kern.program, x, bv2, bm2, pool, planes)
    assert torch.equal(y, y2) and torch.equal(bv, bv2)
    if name in FFT_CASES:
        # the FFT regions: radix-2 against NumPy's FFT
        assert BS.fft_excess(bm2, bm, bv2, bv) <= 0.0
    else:
        assert torch.equal(bm, bm2)
    if mo is not None:
        assert torch.equal(mo, mo2) and float(mo[:, :, 0].sum()) > 0


@pytest.mark.parametrize("rung", [2048, 4096, 8192])
def test_host_form_overflow_stop_equals_plain(rung):
    # a growing heap overflows its rung inside the render: the host form
    # stops at the end of that block as the plain version does, leaving
    # the same var row (the high water stored from its register) and the
    # same heap (the on-chip page and the row past it written back; a
    # heap smaller than the page keeps the page's cells past it at 0)
    host_compiler_or_skip()
    # the growing heap, reading back the cell it wrote last: 0 once the
    # write fell past the heap
    src = CASES["growing_heap"][0].replace(
        "buf[ctr > 3000 ? ctr - 3000 : 0]", "buf[ctr - 1]")
    prog = compile_plugin_source(src)
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog, SR).state, 1,
                            heap_size=rung, device="cpu")
    assert kern.mem_size == rung
    T = 6000
    x, bv, bm, pool = _program_and_inputs(kern, 2, T, seed=21)
    bv2, bm2 = bv.clone(), bm.clone()
    y, _ = DX.device_exec(kern.program, x, bv, bm, pool)
    y2, _ = DX.device_exec_host(kern.program, x, bv2, bm2, pool)
    hw = bv[:, kern._hw]
    assert bool((hw >= rung).all()) and torch.equal(bv, bv2) \
        and torch.equal(bm, bm2)
    ctr = kern.sample.slots[("var", "ctr")]
    assert float(bv[:, ctr].min()) > rung - 100   # the heap was full
    for f in range(2):
        # the samples up to the end of the block that overflowed
        stop = int(np.nonzero(np.asarray(y[f, 0]) != 0.0)[0].max()) + 1
        assert stop % kern.B == 0 and stop < T
        assert torch.equal(y[f, :, :stop], y2[f, :, :stop])


def test_host_form_heap_address_equals_the_plain_version():
    # K11's branch-free address (zx_raddr) against the plain version's
    # SC.mem_address on the edges: NaN, the infinities, 2^62 and past it,
    # negatives, the 1e-5 bias, the page's edge
    import ctypes

    from zorak_tpu_torch.semantics import scalar as SC

    host_compiler_or_skip()
    prog = compile_plugin_source(CASES["voice_loop"][0])
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog, SR).state, 2,
                            device="cpu")
    lib = _build.load_generated_host(kern.program.source)
    fn, fk = lib.device_exec_raddr, lib.device_exec_raddr_k
    fn.argtypes = [ctypes.c_double, ctypes.c_double]
    fk.argtypes = [ctypes.c_double, ctypes.c_longlong]
    fn.restype = fk.restype = ctypes.c_longlong
    big = float(1 << 62)
    edges = [0.0, -0.0, 1e-6, -1e-6, -0.99999, -1.0, 4095.99999, 4095.999991,
             4096.0, 4095.0, 1e300, -1e300, big, np.nextafter(big, 0.0),
             np.nextafter(big, np.inf), 2.0 ** 63, -big, float("nan"),
             float("inf"), float("-inf"), 3.5, 2.0 ** 53, -2.0 ** 53,
             2.0 ** 31, 2.0 ** 31 - 1.0, 2.0 ** 31 - 0.5, 2.0 ** 32 + 3.0,
             2.0 ** 51 + 1.0, 2.0 ** 52 - 1.0]
    for b in edges:
        for i in (0.0, 1.0, -1.0, 0.5, 4090.0, float("inf"), float("nan")):
            assert fn(b, i) == SC.mem_address(b, i), (b, i)
        # a whole constant operand, added as an integer
        for k in (0, 1, -1, 18, 4095, -4096, 2 ** 31 - 1, -(2 ** 31 - 1)):
            assert fk(b, k) == SC.mem_address(b, float(k)), (b, k)


def wide_src(n):
    """A chain through n vars: a var row past the static shared memory
    beside K11's page once n passes about 2,040."""
    body = "".join(f"v{k} = v{k - 1} * 0.999 + {k} * 0.000001;\n"
                   for k in range(1, n))
    return f"@sample\nv0 = spl0 * 0.5;\n{body}spl0 = v{n - 1};\n"


def test_a_var_row_past_the_static_limit_takes_dynamic_shared_memory():
    # chosen when the text is printed: 2,100 slots and the page pass 48 KB
    small = DeviceExecKernel(compile_plugin_source(wide_src(8)),
                             make_initialized_shadow(
                                 compile_plugin_source(wide_src(8))).state, 1,
                             device="cpu").program
    assert not small.dynamic_smem and "#define ZX_DYN 0" in small.source
    prog = compile_plugin_source(wide_src(2100))
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog, SR).state, 1,
                            device="cpu")
    p = kern.program
    assert p.dynamic_smem and p.smem_bytes > DX.SMEM_STATIC
    assert "#define ZX_DYN 1" in p.source
    host_compiler_or_skip()
    x, bv, bm, pool = _program_and_inputs(kern, 2, 700, seed=4)
    bv2, bm2 = bv.clone(), bm.clone()
    y, _ = DX.device_exec(p, x, bv, bm, pool)
    y2, _ = DX.device_exec_host(p, x, bv2, bm2, pool)
    assert torch.equal(y, y2) and torch.equal(bv, bv2) and torch.equal(bm, bm2)


def test_host_form_stand_in_eight_files():
    host_compiler_or_skip()
    src = builtin_plugins.grain_texture(2, 1024)
    prog = compile_plugin_source(src)
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog, SR).state, 2,
                            device="cpu")
    kern.grow_to(8192)
    T = 2100                                   # 4 blocks and 52
    x, bv, bm, pool = _program_and_inputs(kern, 8, T, seed=30)
    x = x * 0.5
    mev, mn = kern._midi_planes([(5, 0x90, 60, 100), (700, 0x90, 64, 80)], T)
    planes = (torch.from_numpy(mev), torch.from_numpy(mn))
    bv2, bm2 = bv.clone(), bm.clone()
    y, _ = DX.device_exec(kern.program, x, bv, bm, pool, planes)
    y2, _ = DX.device_exec_host(kern.program, x, bv2, bm2, pool, planes)
    assert torch.equal(y, y2) and torch.equal(bv, bv2) and torch.equal(bm, bm2)
    assert float(bv[:, kern._rpos].min()) > 0          # every file drew
    assert float(bv[:, kern._hw].max()) < kern.mem_size


def test_stand_in_three_ways_and_both_vectorizers_reject():
    src = builtin_plugins.grain_texture(2, 1024)
    x = noise(2, 3000, seed=8, scale=0.25)
    midi = [(100, 0x90, 60, 100), (1500, 0x90, 67, 90)]
    prog = compile_plugin_source(src)
    with pytest.raises(SpecializeError, match="rand"):
        specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                 2, device="cpu")
    jprog = jax_compile(src)
    with pytest.raises(JaxSpecializeError):
        jax_specialize(jprog, jax_shadow(jprog).state, 2)
    kern, y, _yj, gold = three_ways(src, x, 1, midi)
    assert kern.heap_climbs and kern.mem_size == 8192
    assert gold.state.V["spawned"] >= 2 and kern.last_draws > 0
    inst = PluginInstance(prog, device="cpu")
    assert inst.engine == "torch-devexec"
    res = inst.render(x, midi=midi)
    assert res.engine == "torch-devexec"
    assert np.array_equal(res.audio, y)


def test_draw_pool_exhaustion_raises():
    src = CASES["rand_resumed"][0]
    prog = compile_plugin_source(src)
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                            rand_pool=16, device="cpu")
    x = noise(1, 2048)
    _y, carry = kern.render(x)
    assert kern.last_draws > 16
    with pytest.raises(SpecializeError, match="exhausted"):
        kern.render(x, carry=carry)
    with pytest.raises(SpecializeError, match="exhausted"):
        kern.writeback(carry, make_initialized_shadow(prog).state)


def test_resumed_generator_equals_the_golden():
    src = CASES["rand_resumed"][0]
    prog = compile_plugin_source(src)
    x = noise(1, 3000)
    gold, _y, _ = golden_render(prog, x)
    owner = make_initialized_shadow(prog)
    kern = DeviceExecKernel(prog, owner.state, 1, device="cpu")
    _yp, carry = split_render(kern, x, 3)
    kern.writeback(carry, owner.state)
    got = MT.eelrng_state_tuple(owner.state.rng)
    # the Python golden over the same blocks
    py = make_initialized_shadow(prog)
    y_ref = np.zeros_like(x)
    for s in range(0, x.shape[1], 512):
        py.process_block(x[:, s:s + 512], y_ref[:, s:s + 512])
    want = MT.eelrng_state_tuple(py.state.rng)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    assert compare_states(gold.state, owner.state).passed


def test_render_files_equals_solo_renders_and_refuses_mixed_generators():
    src = CASES["rand_resumed"][0]
    prog = compile_plugin_source(src)
    xs = np.stack([noise(1, 1300, seed=40 + f) for f in range(3)])
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                            device="cpu")
    y3, (bv3, bm3) = kern.render_files(xs)
    for f in range(3):
        solo = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                                device="cpu")
        y, (bv, bm) = solo.render_device(xs[f])
        assert torch.equal(y3[f], y) and torch.equal(bv3[f], bv) \
            and torch.equal(bm3[f], bm)
    assert len(set(bv3[:, kern._rpos].tolist())) > 1
    with pytest.raises(SpecializeError, match="generator"):
        kern.render_files(xs, carries=(bv3, bm3))
    # carries that agree resume together, each file as its solo resumed
    # render
    lead = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                            device="cpu")
    _y, (bv0, bm0) = lead.render_files(xs[:1])
    y, _ = lead.render_files(xs, carries=(bv0[[0, 0, 0]], bm0[[0, 0, 0]]))
    for f in range(3):
        solo = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                                device="cpu")
        _y, carry = solo.render_device(xs[0])
        y1, _ = solo.render_device(xs[f], carry=carry)
        assert torch.equal(y[f], y1)


def test_resume_from_a_converted_jax_carry():
    src = CASES["rand_resumed"][0]
    x = noise(1, 3000)
    cut = 1536
    jprog = jax_compile(src)
    jkern = JaxDeviceExec(jprog, jax_shadow(jprog).state, 1, block_size=512)
    _y1, jcarry = jkern.render(x[:, :cut])
    jstate = jkern._rng_prestate
    y2_jax, _ = jkern.render(x[:, cut:], carry=jcarry)

    prog = compile_plugin_source(src)
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                            device="cpu")
    carry = convert.devexec_carry_from_numpy(
        kern, (np.asarray(jcarry[0]), np.asarray(jcarry[1])),
        jkern.sample.mem_size, rng_state=jstate)
    y2, _ = kern.render(x[:, cut:], carry=carry)
    assert np.abs(y2.astype(np.float64) - np.asarray(y2_jax)).max() \
        <= AUDIO_MAX
    _gold, y_ref, _ = golden_render(prog, x)
    assert compare_audio(y_ref[:, cut:], y2).audio_passed


def test_heap_ladder_moves_the_carry_across():
    src = CASES["growing_heap"][0]
    prog = compile_plugin_source(src)
    x = noise(1, 6000)
    gold, y_ref, _ = golden_render(prog, x)
    owner = make_initialized_shadow(prog)
    kern = DeviceExecKernel(prog, owner.state, 1, device="cpu")
    y1, carry = kern.render(x[:, :1536])
    assert kern.mem_size == 4096 and not kern.heap_climbs
    y2, carry = kern.render(x[:, 1536:], carry=carry)
    assert kern.heap_climbs and kern.mem_size > 4096
    assert carry[1].shape[0] == kern.sample.total_mem
    kern.writeback(carry, owner.state)
    held(gold.state, y_ref, np.concatenate([y1, y2], axis=1), owner.state,
         "ladder")


def test_null_test_plugin_devexec_engine():
    src = CASES["voice_loop"][0]
    rep = null_test_plugin(compile_plugin_source(src), noise(2, 1500),
                           golden="native", compare_mem=True, device="cpu",
                           engine="devexec")
    assert rep.passed, rep.summary()
    with pytest.raises(ValueError, match="engine"):
        null_test_plugin(compile_plugin_source(src), noise(2, 100),
                         device="cpu", engine="tpu")


def test_device_sections_refuse_rand_without_a_pool():
    from zorak_tpu_torch.lowering.devgen import (
        DeviceSection, DevgenError, section_dynamic_keys)

    prog = compile_plugin_source(CASES["rand_resumed"][0])
    snap = make_initialized_shadow(prog).state
    dyn = section_dynamic_keys(prog, ("block", "sample"))
    with pytest.raises(DevgenError, match="sequential executor"):
        DeviceSection(prog, snap, "block", dyn, 4096)
    sec = DeviceSection(prog, snap, "block", dyn, 4096, reduced_heap=True,
                        rand_pool=64)
    assert sec.uses_rand and "zx_rand(" in sec.body_source
    assert ("var", "__mem_hiwater__") in sec.slots


def test_sample_chain_ops_counts_the_longest_path():
    # acc's chain: i * 2 then the compound add, a link more each iteration
    src = ("@sample\nacc = 0; i = 0;\nloop(n, acc += i * 2; i += 1;);\n"
           "x = buf[acc] + rand(3);\nspl0 = acc;\n")
    prog = compile_plugin_source(src)
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                            device="cpu")
    # three iterations: acc at 4, its address 6, the load 6, the add 7
    assert DX.sample_chain_ops(kern.program, {"n": 3}) == 7.0
    assert DX.sample_chain_ops(kern.program, {"n": 2}) == 6.0
    assert DX.sample_chain_ops(kern.program, {"n": 2.5}) == 6.5


def test_k10_sources_stay_as_they_were():
    # the reduced heap's printing (K11) leaves K10's sections alone: the
    # generated K10 text of the coupled and hop stand-ins, byte for byte
    # (both as K10's design note and the hop's phases through process()
    # print them)
    import hashlib

    want = {
        "spectral_tilt_leveler(2048)": (
            builtin_plugins.spectral_tilt_leveler(2048), "_block_prog",
            "59854630e91feca89561f06dc600bc0abf9a0c0e9b29415d5153d3b986581750"),
        "hop_convolver(1024, 8)": (
            builtin_plugins.hop_convolver(1024, 8), "_hop_prog",
            "455fde3bab766060af3af0d04bcd2442e68725a252aa8bc822dc9287e6fce657"),
    }
    for name, (src, attr, digest) in want.items():
        inst = PluginInstance(compile_plugin_source(src), device="cpu")
        k10 = getattr(inst.kernel, attr)
        got = hashlib.sha256(k10.source.encode()).hexdigest()
        assert got == digest, name
