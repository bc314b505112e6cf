"""The audio-coupled @block through the port's fused block/sample loop on the
CPU (K10's plain version between segments), against the JAX package's
coupled pipeline and the native golden.

Each case of tests/test_coupled_block.py renders the same seeded numpy
input three ways: the port's kernel (CPU tensors), the JAX kernel and
the native C golden (`null_test_plugin(golden="native")`, state and heap
compared).  Tolerances, the reference's null contract
(verify/nulltest.py): audio within 1e-5 after f32 rounding, vars and heap
within 1e-8, against the golden and against the JAX render.
"""
import numpy as np
import pytest
import torch

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins, convert
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import block_section as BS
from zorak_tpu_torch.lowering import specialize_sample_kernel
from zorak_tpu_torch.parallel import BatchRenderer
from zorak_tpu_torch.verify import make_initialized_shadow, null_test_plugin

AUDIO_TOL = 1e-5
STATE_TOL = 1e-8


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


def noise(nch, n, scale=0.4, seed=3):
    return (np.random.RandomState(seed).randn(nch, n) * scale).astype(
        np.float32)


_MIDI_BLOCK_BODY = """while (midirecv(ofs, m1, m23)) (
  st = m1 & 240;
  st == 144 ? notes += 1;
  st == 128 ? notes -= 1;
  last_vel = (m23 / 256) & 127;
);
"""
MIDI_EVENTS = [(100, 144, 60, 100), (700, 144, 64, 90), (1800, 128, 60, 0),
               (2600, 144, 67, 70), (4400, 128, 64, 0)]

# name -> (source, input, segment length, MIDI in)
CASES = {
    "hot_meter_read": ("""
@init
g = 1;
@block
avg = acc / max(samplesblock, 1);
g = 1 / (1 + avg*avg);
acc = 0;
@sample
acc += abs(spl0);
spl0 = spl0 * g;
""", noise(1, 6100), 4096, None),
    "block_rewrites_audio_state": ("""
@block
env = env * 0.5;
@sample
env = max(abs(spl0), env * 0.999);
spl0 = spl0 / (1 + env);
""", noise(1, 6100), 4096, None),
    "shared_mem_ring_and_table": ("""
@init
MASK = 255; tab = 1000;
@block
s = 0; i = 0;
while(i < 16) ( s += buf[i]; i += 1; );
tab[0] = s / 16;
@sample
buf[w & MASK] = spl0;
w += 1;
spl0 = spl0 - tab[0];
""", noise(1, 6100), 2048, None),
    "fft_in_coupled_block": ("""
@init
FS = 64; buf = 4096; spec = 8192;
@block
i = 0;
loop(FS, spec[2*i] = buf[i]; spec[2*i+1] = 0; i += 1;);
fft(spec, FS);
fft_permute(spec, FS);
mag0 = sqrt(spec[2]*spec[2] + spec[3]*spec[3]);
@sample
buf[wp] = spl0;
wp += 1; wp >= FS ? wp = 0;
spl0 = spl0 * 0.5 + mag0 * 0.001;
""", noise(1, 5000), 2048, None),
    "coupled_retrigger_runs_device_slider": ("""@slider
g = 0.2 + slider1 * 0.1;
@block
acc_b = acc;
acc > 40 && slider1 < 3 ? (
  slider1 = slider1 + 1;
  sliderchange(slider1);
  acc = 0;
);
@sample
acc += abs(spl0);
spl0 = spl0 * g + 0.001 * acc_b;
""", noise(1, 6000, seed=19, scale=0.5), 2048, None),
    "block_midirecv_coupled_staged_planes": (
        "@block\n" + _MIDI_BLOCK_BODY
        + "g = 0.1 + 0.2 * notes + 0.001 * last_vel + acc * 0.0001;\n"
        + "acc = 0;\n"
        + "@sample\nacc += abs(spl0);\nenv += 0.01 * (g - env);\n"
        + "spl0 = spl0 * env;\n",
        noise(1, 5000, seed=24, scale=0.5), 2048, MIDI_EVENTS),
    "block_midisend_staged_out": ("""@block
acc > thr ? (
  midisend(3, 144, 60 + 256 * 100);
  sent += 1;
);
thr = 5 + sent;
acc = 0;
@sample
acc += abs(spl0);
spl0 = spl0 * 0.5;
""", noise(1, 4000, seed=29, scale=0.6), 2048, None),
    # the in-repo stand-in for the catalog's coupled plugins, at a small
    # FFT: three full blocks and a remainder
    "spectral_tilt_leveler": (
        builtin_plugins.spectral_tilt_leveler(256),
        noise(2, 3 * 512 + 100, scale=0.3, seed=5), 4096, None),
}


def kernels_for(src, nch, seg):
    prog = compile_plugin_source(src)
    state = make_initialized_shadow(prog).state
    kern = specialize_sample_kernel(prog, state, nch, segment_len=seg,
                                    device="cpu")
    jprog = jax_compile(src)
    jstate = jax_shadow(jprog).state
    jkern = jax_specialize(jprog, jstate, nch, segment_len=seg)
    return prog, (kern, state), (jkern, jstate)


def state_delta(st, jst, n_mem):
    """Max |delta| over vars (by name), sliders and the first n_mem heap
    cells of two writebacks."""
    names = set(st.V) | set(jst.V)
    worst = max((abs(st.V.get(k, 0.0) - jst.V.get(k, 0.0)) for k in names),
                default=0.0)
    worst = max(worst, max(abs(a - b) for a, b in zip(st.sliders,
                                                      jst.sliders)))
    m = np.zeros(n_mem)
    jm = np.zeros(n_mem)
    m[:min(n_mem, len(st.mem))] = st.mem[:n_mem]
    jm[:min(n_mem, len(jst.mem))] = jst.mem[:n_mem]
    return max(worst, float(np.max(np.abs(m - jm))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_coupled_port_matches_jax_and_golden(name):
    src, x, seg, midi = CASES[name]
    prog, (kern, state), (jkern, jstate) = kernels_for(src, x.shape[0], seg)
    assert kern.coupled and jkern.coupled
    assert kern.accepts_midi == jkern.accepts_midi == bool(midi)
    assert kern.carried_vars == jkern.carried_vars
    assert kern._devblock.slots == jkern._devblock.slots
    assert kern._devblock.mem_size == jkern._devblock.mem_size
    y, carry = kern.render(x, midi=midi)
    yj, jcarry = jkern.render(x, midi=midi)
    assert y.dtype == np.float32 and y.shape == x.shape
    assert np.max(np.abs(y.astype(np.float64) - np.asarray(yj, np.float64))) \
        <= AUDIO_TOL
    assert kern.last_midi_out == jkern.last_midi_out
    kern.writeback(carry, state)
    jkern.writeback(jcarry, jstate)
    assert state_delta(state, jstate, kern._devblock.mem_size) <= STATE_TOL
    rep = null_test_plugin(prog, x, segment_len=seg, golden="native",
                           compare_state=True, compare_mem=True, midi=midi,
                           device="cpu")
    assert rep.passed, rep.summary()


def test_coupled_retrigger_writes_back_the_slider():
    src, x, seg, _ = CASES["coupled_retrigger_runs_device_slider"]
    prog = compile_plugin_source(src)
    state = make_initialized_shadow(prog, 48000.0).state
    kern = specialize_sample_kernel(prog, state, 1, segment_len=seg,
                                    device="cpu")
    assert kern._devslider is not None and kern._block_prog.slider is not None
    _y, carry = kern.render(x)
    kern.writeback(carry, state)
    assert state.sliders[0] == 3.0 and state.pending_change_mask == 0


def test_block_midisend_decodes_to_absolute_offsets():
    src, x, seg, _ = CASES["block_midisend_staged_out"]
    prog = compile_plugin_source(src)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    1, segment_len=seg, device="cpu")
    assert kern._devblock.uses_midi_out and not kern.accepts_midi
    kern.render(x)
    sent = kern.last_midi_out
    assert sent and all(o % 512 == 3 and tuple(ev) == (144, 60, 100)
                        for o, *ev in sent)


FILE_SRC = """
@init
TAB = 5000;
@block
g = acc / max(samplesblock, 1); acc = 0;
bc += 1;
bc % RELOAD == 1 ? need = 1;
need ? (
  h = file_open(0);
  h > 0 ? (
    nch = 0; sr = 0;
    file_riff(h, nch, sr);
    n = min(file_avail(h), 64);
    file_mem(h, TAB, n);
    loaded = n;
    file_close(h);
  );
  need = 0;
);
@sample
acc += abs(spl0);
spl0 = spl0 * (1/(1+g)) + 0.1 * TAB[0] + 0.01 * TAB[37];
"""


def file_hosts(services, audio):
    h = services.EngineHost()
    h.files.load_slot(0, audio, srate=48000.0)
    return h


def native_golden(prog, x, host, need=None):
    """The native golden with `host` over x in blocks of 512 (the reload
    flag set first where `need` is given): (golden, audio f64)."""
    from zorak_tpu_torch.shadow import compile_native_shadow
    from zorak_tpu_torch.verify import apply_slider_state

    plug = compile_native_shadow(prog, host=host)
    plug.state.srate = 48000.0
    apply_slider_state(plug.state, prog, None, None)
    plug.run_init()
    plug.run_slider()
    if need is not None:
        plug.state.V["need"] = need
    yg = np.zeros_like(x, dtype=np.float64)
    for i in range(0, x.shape[1], 512):
        n = min(512, x.shape[1] - i)
        out = np.zeros((x.shape[0], n), dtype=np.float64)
        plug.process_block(x[:, i:i + n].astype(np.float64), out,
                           x.shape[0])
        yg[:, i:i + n] = out
    return plug, yg


def file_three_ways(src, x, audio, renders=1, need=1.0, seg=2048):
    """A plugin loading file slot 0 in its coupled @block three ways, each
    with a host of its own: the port's kernel (CPU tensors), the JAX kernel
    and the native golden; `need` the reload flag set before the render.
    Audio within 1e-6 of the golden as the reference's test holds it,
    vars and heap within 1e-8; returns the port's kernel."""
    from zorak_tpu.runtime import services as jax_services
    from zorak_tpu_torch.runtime import services

    prog = compile_plugin_source(src)
    owner = make_initialized_shadow(prog, 48000.0,
                                    host=file_hosts(services, audio))
    owner.state.V["need"] = need
    kern = specialize_sample_kernel(prog, owner.state, x.shape[0],
                                    segment_len=seg, device="cpu")
    assert kern.coupled and kern._block_prog.tabled
    assert "zb_file_copy(S, 5000, 0, 64)" in kern._block_prog.source
    jprog = jax_compile(src)
    jowner = jax_shadow(jprog, 48000.0, host=file_hosts(jax_services, audio))
    jowner.state.V["need"] = need
    jkern = jax_specialize(jprog, jowner.state, x.shape[0], segment_len=seg)
    assert jkern.coupled

    plug, yg = native_golden(prog, x, file_hosts(services, audio), need)
    T = x.shape[1]
    cut = (T // renders // 512) * 512
    ys, yjs, carry, jcarry = [], [], None, None
    for r in range(renders):
        a, b = r * cut, (T if r == renders - 1 else (r + 1) * cut)
        y, carry = kern.render(x[:, a:b], carry=carry)
        yj, jcarry = jkern.render(x[:, a:b], carry=jcarry)
        ys.append(y)
        yjs.append(np.asarray(yj))
    y, y_jax = np.concatenate(ys, axis=1), np.concatenate(yjs, axis=1)
    assert np.abs(y.astype(np.float64) - yg).max() <= 1e-6
    assert np.abs(y.astype(np.float64) - y_jax).max() <= 1e-6
    kern.writeback(carry, owner.state)
    jkern.writeback(jcarry, jowner.state)
    for name, v in plug.state.V.items():
        assert abs(owner.state.V.get(name, 0.0) - v) <= STATE_TOL, name
    n = kern._block_prog.mem_size
    got = np.zeros(n)
    got[:min(n, len(owner.state.mem))] = owner.state.mem[:n]
    want = np.zeros(n)
    want[:min(n, len(plug.state.mem))] = plug.state.mem[:n]
    assert np.abs(got - want).max() <= STATE_TOL
    assert state_delta(owner.state, jowner.state, n) <= STATE_TOL
    return kern


def test_file_load_folds_into_coupled_block():
    # the reference's case: a reload-gated open/riff/file_mem/close in
    # @block folds while K10's text prints; the chunk is a copy from the
    # program's file table, not literals
    audio = np.sin(np.arange(200) * 0.21)[None, :] * 0.7
    kern = file_three_ways(FILE_SRC.replace("RELOAD", "1000000"),
                           noise(1, 5000, seed=7, scale=0.3), audio)
    assert kern._block_prog.tables.file_cells == 64


def test_file_reload_copies_the_same_chunk_in_each_render():
    # the file cursor lives in one print: every reload, in one render and
    # in the next, copies the same chunk again, as the golden's open and
    # close leave it; the flag is set every 3 blocks over 2 renders
    audio = np.cos(np.arange(300) * 0.13)[None, :] * 0.5
    kern = file_three_ways(FILE_SRC.replace("RELOAD", "3"),
                           noise(1, 6000, seed=11, scale=0.3), audio,
                           renders=2, need=0.0)
    assert kern._block_prog.tables.file_cells == 64


def test_slot_table_leveler_stand_in_against_the_golden():
    # the stand-in at a 256-value table, reloaded at the first block and
    # every 2,048 after: on K10 (coupled), equal to the native golden,
    # with the table in the heap
    from zorak_tpu_torch.runtime import services
    from zorak_tpu_torch.runtime.engine import PluginInstance

    table = builtin_plugins.table_slot(256, seed=4)
    prog = compile_plugin_source(builtin_plugins.slot_table_leveler(256))
    inst = PluginInstance(prog, host=file_hosts(services, table),
                          device="cpu", smart_idle="always_awake")
    assert inst.engine == "torch-vector" and inst.kernel.coupled
    x = noise(2, 3 * 512 + 77, seed=8)
    res = inst.render(x)
    plug, yg = native_golden(prog, x, file_hosts(services, table))
    assert np.abs(res.audio.astype(np.float64) - yg).max() <= 1e-6
    for name, v in plug.state.V.items():
        assert abs(inst.shadow.state.V.get(name, 0.0) - v) <= STATE_TOL, name
    assert np.array_equal(inst.shadow.state.mem[:256], table[0])


def test_uncoupled_stays_on_host_trajectory():
    src = """
@block
t += 1;
g = 0.5 + 0.4 * sin(t * 0.1);
@sample
spl0 = spl0 * g;
"""
    prog = compile_plugin_source(src)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    1, segment_len=2048, device="cpu")
    assert not kern.coupled and kern._block_prog is None
    rep = null_test_plugin(prog, noise(1, 5000), segment_len=2048,
                           golden="native", compare_state=True, device="cpu")
    assert rep.passed, rep.summary()


def test_k10_launches_once_a_block_on_the_cpu_path(monkeypatch):
    src, x, seg, _ = CASES["spectral_tilt_leveler"]
    prog = compile_plugin_source(src)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    2, segment_len=seg, device="cpu")
    calls = []
    plain = BS.block_section_plain

    def spy(*a, **k):
        calls.append(a[5])          # samplesblock
        return plain(*a, **k)

    monkeypatch.setattr(BS, "block_section_plain", spy)
    kern.render(x)
    assert calls == [512.0, 512.0, 512.0, 100.0]
    assert BS.LAUNCHES == 0        # the plain version is no launch


def test_k10_phases_on_the_stand_in_equal_the_one_thread_form(monkeypatch):
    """K10's inputs at every block of the stand-in's CPU render, 2 files,
    through the host form: its phases with 1, 3 and 128 threads, each
    block step's shares in ascending and in descending order, equal the
    one-thread form bit for bit (vars, heap with the FFT buffer, the
    sample side, the control row), and no loop runs on thread 0; the
    one-thread form stays within FFT_TOL_REL of the plain version, the
    sample side bit for bit."""
    from zorak_tpu_torch.kernels import _build

    try:
        _build.find_host_compiler()
    except RuntimeError:
        pytest.skip("no host C++ compiler (g++, gcc, c++, cc) for K10's "
                    "host form")
    src, _x, seg, _ = CASES["spectral_tilt_leveler"]
    br = BatchRenderer(compile_plugin_source(src), segment_len=seg,
                       device="cpu")
    k10 = br.kernel._block_prog
    assert [ph.kind for ph in k10.block.phases] == [
        "serial", "loop", "fft", "fft", "serial"]
    seen = []
    plain = BS.block_section_plain

    def spy(program, svec, rings, bvars, bmem, sb, *a, **k):
        seen.append((svec.clone(), [r.clone() for r in rings], bvars.clone(),
                     bmem.clone(), sb))
        return plain(program, svec, rings, bvars, bmem, sb, *a, **k)

    monkeypatch.setattr(BS, "block_section_plain", spy)
    x = np.stack([noise(2, 3 * 512 + 100, scale=0.3, seed=60 + f)
                  for f in range(2)])
    br.render_files(x)
    monkeypatch.setattr(BS, "block_section_plain", plain)
    assert len(seen) == 4

    def run(inputs, **kw):
        svec, rings, bvars, bmem, sb = (
            t.clone() if isinstance(t, torch.Tensor) else t
            for t in inputs)
        rings = [r.clone() for r in rings]
        ctrl, _mo, runs = BS.block_section_host(k10, svec, rings, bvars,
                                                bmem, sb, **kw)
        return [svec, *rings, bvars, bmem, ctrl], runs

    def bits(t):
        return t.numpy().view(np.int64)

    for inputs in seen:
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
        ctrl = plain(k10, svec, rings, bvars, bmem, sb)[0]
        assert torch.equal(one[0], svec)
        assert all(torch.equal(a, b) for a, b in zip(one[1:-3], rings))
        assert BS.fft_excess(one[-2], bmem, torch.cat([one[-3], one[-1]], 1),
                             torch.cat([bvars, ctrl], 1)) <= 0.0


def test_batch_of_three_files_equals_the_solo_renders():
    src, _x, seg, _ = CASES["spectral_tilt_leveler"]
    prog = compile_plugin_source(src)
    br = BatchRenderer(prog, segment_len=seg, device="cpu")
    assert br.kernel.coupled
    xs = np.stack([noise(2, 1300, scale=0.3, seed=40 + f) for f in range(3)])
    y = br.render_files(xs)
    again = br.render_files(xs)        # the staged carry stays fresh
    assert torch.equal(y, again)
    for f in range(3):
        solo, _ = br.kernel.render_device(xs[f])
        assert torch.equal(y[f], solo)


def test_converted_jax_carry_resumes_to_the_same_audio():
    src, x, seg, _ = CASES["shared_mem_ring_and_table"]
    _prog, (kern, _st), (jkern, _jst) = kernels_for(src, 1, seg)
    head, tail = x[:, :2560], x[:, 2560:]
    _yj, jcarry = jkern.render(head)
    as_numpy = jax_tree_to_numpy(jcarry)    # the JAX render donates jcarry
    carry = convert.carry_from_numpy(kern, as_numpy)
    y, _ = kern.render(tail, carry=carry)
    yj, _ = jkern.render(tail, carry=jcarry)
    assert np.max(np.abs(y.astype(np.float64) - np.asarray(yj, np.float64))) \
        <= AUDIO_TOL
    with pytest.raises(ValueError, match="coupled"):
        uncoupled = specialize_sample_kernel(
            compile_plugin_source("@sample\nspl0 *= 0.5;\n"),
            make_initialized_shadow(compile_plugin_source(
                "@sample\nspl0 *= 0.5;\n")).state, 1, device="cpu")
        convert.carry_from_numpy(uncoupled, as_numpy)


def jax_tree_to_numpy(carry):
    (svec, rings), bvars, bmem = carry
    return ((np.asarray(svec), {r: np.asarray(a) for r, a in rings.items()}),
            np.asarray(bvars), np.asarray(bmem))
