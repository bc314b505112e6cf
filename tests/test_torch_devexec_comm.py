"""gmem and a lone instance's bus in the sequential device executor (K11)
on the CPU, as the reference's DeviceExecKernel takes them.

Each case renders one seeded numpy input three ways: the port's
`DeviceExecKernel` on CPU tensors (K11's plain version: the Python golden
with the reduced heap, its gmem the heap row's window), the JAX
`DeviceExecKernel` and the native C golden.  Tolerances, the golden
contract: audio within 1e-5 after f32 rounding (and at most 1e-6), vars,
heap and `state.gmem` within 1e-8.  K11's generated text in its host form
(g++ -O2 -ffp-contract=off) is held bit for bit to the plain version; it
skips with a reason where no host compiler is found.  The JAX carry holds
the 1,048,576-cell window, so the JAX renders stay at about 1,100 samples.
"""
import numpy as np
import pytest
import torch

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering.devexec import DeviceExecKernel as JaxDeviceExec
from zorak_tpu.runtime.engine import PluginInstance as JaxInstance
from zorak_tpu.runtime.services import EngineHost as JaxEngineHost
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins, convert
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import device_exec as DX
from zorak_tpu_torch.lowering import SpecializeError
from zorak_tpu_torch.lowering.devexec import DeviceExecKernel
from zorak_tpu_torch.runtime.engine import PluginInstance
from zorak_tpu_torch.runtime.services import EngineHost
from zorak_tpu_torch.shadow import compile_native_shadow
from zorak_tpu_torch.verify import apply_slider_state, compare_audio
from zorak_tpu_torch.verify.nulltest import (
    compare_memory_pages, compare_states, make_initialized_shadow)

SR = 48000.0
AUDIO_MAX = 1e-6
SCALAR_TOL = 1e-8
T = 1100          # two blocks of 512 and a remainder of 76


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
        pytest.skip(str(exc))


# a voice count that follows the input's level: the vectorizers reject it
VOICES = ("n = abs(spl0) > 0.3 ? 3 : 1; i = 0;\n"
          "loop(n, 200[i] = 200[i] * 0.5 + spl0; i += 1;);\n")

CASES = {
    # static and dynamic gmem[]: -1 and NaN are cell 0, an index past the
    # segment reads 0 and drops its write, compound stores, a dynamic index
    # reaching past the end
    "gmem_index_edges": (
        "@init\ngmem[3] = 0.25; gmem[1048575] = 2; big = 1048576 + 10;\n"
        "@block\ngmem[-1] += 1;\ngmem[0/0] += 0.5;\ngmem[log(-1)] += 0.125;\n"
        "gmem[sqrt(-1)] -= 0.0625;\ngmem[big] = 7;\n"
        "q = gmem[big] + gmem[1048575] + gmem[-1];\nbc += 1;\n"
        "@sample\nk = abs(spl0) * 8;\n" + VOICES +
        "j = 0; loop(n, acc += gmem[k + j] * 0.01; "
        "gmem[k + j - 0.5] = acc * 0.1 + spl0; j += 1;);\n"
        "gmem[floor(abs(spl0) * 2000000)] += 0.001;\n"
        "spl0 = spl0 * 0.5 + acc * 0.001 + q * 0.0001 + 200[1] * 0.1;\n"),
    # gmem_get and gmem_put across cell 4,096 (K11's on-chip page), inside
    # the page and past it; gmem_fill, gmem_zero and gmem_copy (forward and
    # both overlaps); counts cut at the segment's end
    "gmem_bulk": (
        "options:maxmem=65536\n@init\nk = 0;\n"
        "loop(64, gmem[1000 + k] = k * 0.5 + 1; k += 1;);\n"
        "@block\ngmem_get(4070, 1000, 40);\ngmem_get(100, 1010, 8);\n"
        "gmem_get(5000, 1000, 16);\n"
        "4075[0] += bc; 4100[0] -= bc * 0.5; 5003[0] *= 1.5; 101[0] += 0.25;\n"
        "gmem_put(2000, 4080, 30);\ngmem_put(2100, 5000, 16);\n"
        "gmem_put(2200, 96, 8);\ngmem_fill(3000, bc * 0.1, 10);\n"
        "gmem_zero(3004, 3);\ngmem_copy(3100, 3000, 10);\n"
        "gmem_copy(2005, 2000, 20);\ngmem_copy(2200, 2203, 6);\n"
        "r = gmem_put(1048570, 4090, 20) + gmem_get(4085, 1048572, 8);\n"
        "s = gmem_size();\n"
        "att = gmem_attach(\"x\") + gmem_attach_size(\"y\", 8);\n"
        "bc += 1;\n"
        "@sample\n" + VOICES +
        "acc = acc * 0.99 + 4090[0] * 0.001 + gmem[2010] * 0.001"
        " + gmem[3102] * 0.01 + 4100[0] * 0.0001;\n"
        "spl0 = spl0 * 0.5 + acc + r * 0.0001 + 200[1] * 0.1;\n"),
    # a lone instance's bus: nothing is sent or received, out-params stay,
    # every call gives 0 but instance_id
    "lone_bus": (
        "@init\nme = instance_id(); comm_join(\"d\"); msg_advertise(\"c\", 1);\n"
        "@block\nme2 = instance_id();\n"
        "r1 = msg_send(\"c\", 1, 2, 3, 4, 5);\n"
        "r2 = msg_sendto(3, \"c\", 1, 2, 3, 4, 5);\n"
        "sv = 11; tg = 12; pa = 13;\n"
        "r3 = msg_recv(\"c\", sv, tg, pa, 7000[0], 7001[0], 7002[bc % 3]);\n"
        "r4 = msg_avail(\"c\") + msg_kind(\"c\") + msg_length(\"c\")"
        " + msg_dropped(\"c\") + msg_clear(\"c\");\n"
        "r5 = msg_peer_count(\"c\", 1) + msg_peer_id(\"c\", 1, 0)"
        " + msg_peer_caps(2) + msg_peer_alive(2);\n"
        "r6 = comm_join(\"d\") + msg_subscribe(\"c\") + msg_unsubscribe(\"c\")"
        " + msg_advertise(\"c\", 2) + instance_set_name(\"x\");\n"
        "while (msg_recv(\"c\", sv, tg, pa, pb, pc, pd)) ( cnt += 1; );\n"
        "gmem[me2 + 10] = bc + r1 + r2 + r3 + r4 + r5 + r6;\nbc += 1;\n"
        "@sample\n" + VOICES +
        "acc += (sv + tg + pa + me2 + 7001[0] + cnt) * 1e-6;\n"
        "spl0 = spl0 * 0.5 + acc + 200[1] * 0.1 + gmem[10] * 0.001;\n"),
    "scene_voice_panner": builtin_plugins.scene_voice_panner(4, 64),
}


def golden_render(prog, x, B=512):
    """The native golden over x in blocks of B: (golden, audio)."""
    gold = compile_native_shadow(prog)
    gold.state.srate = SR
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y = np.zeros_like(x)
    for s in range(0, x.shape[1], B):
        gold.process_block(x[:, s:s + B], y[:, s:s + B])
    return gold, y


def held(gold_state, y_ref, y, state, what):
    rep = compare_audio(y_ref, y)
    assert rep.audio_passed and rep.max_abs_delta <= AUDIO_MAX, \
        f"{what}: {rep.summary()}"
    rep = compare_states(gold_state, state)
    compare_memory_pages(gold_state, state, report=rep)
    assert rep.passed, f"{what}: {rep.summary()}"
    g = np.asarray(gold_state.gmem, dtype=np.float64)
    assert np.abs(g - np.asarray(state.gmem)).max() <= SCALAR_TOL, what


def nch_of(src):
    return 2 if "spl1" in src else 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_ways(name):
    src = CASES[name]
    x = noise(nch_of(src), T, seed=7, scale=0.4)
    prog = compile_plugin_source(src)
    gold, y_ref = golden_render(prog, x)
    owner = make_initialized_shadow(prog, SR, None)
    kern = DeviceExecKernel(prog, owner.state, x.shape[0], device="cpu")
    assert kern.sample.gmem_cells == len(owner.state.gmem) == 1 << 20
    assert kern.sample.midi_out_base == kern.mem_size + (1 << 20)
    y, carry = kern.render(x)
    kern.writeback(carry, owner.state)
    held(gold.state, y_ref, y, owner.state, "port")
    assert float(np.abs(owner.state.gmem).sum()) > 0

    jprog = jax_compile(src)
    jowner = jax_shadow(jprog, SR, None)
    jkern = JaxDeviceExec(jprog, jowner.state, x.shape[0], block_size=512)
    y_jax, jcarry = jkern.render(x)
    jkern.writeback(jcarry, jowner.state)
    delta = float(np.abs(y.astype(np.float64) - np.asarray(y_jax)).max())
    print(f"{name}: port vs JAX max |audio delta| {delta:.3e}")
    assert delta <= AUDIO_MAX
    g_jax = np.asarray(jowner.state.gmem, dtype=np.float64)
    assert np.abs(g_jax - owner.state.gmem).max() <= SCALAR_TOL
    if "att" in owner.state.V:
        # gmem_attach in a device section: the golden's lone host answers
        # 0, the port with it; the reference's sections answer 1 where the
        # window is laid out
        assert owner.state.V["att"] == gold.state.V["att"] == 0.0
        assert jowner.state.V["att"] == 2.0
    for var, v in owner.state.V.items():
        if var == "att":
            continue
        w = jowner.state.V.get(var, 0.0)
        assert abs(v - w) <= SCALAR_TOL * max(1.0, abs(w)) \
            or (v != v and w != w), (var, v, w)


def _inputs(kern, nf, seed):
    x = torch.from_numpy(np.stack([noise(kern.nch, T, seed=seed + f,
                                         scale=0.4) for f in range(nf)]))
    bv, bm = kern.initial_carry()
    return x, bv.expand(nf, -1).contiguous(), bm.expand(nf, -1).contiguous()


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_form_bit_for_bit(name):
    # 3 files of 1,100 samples, each its own window in its heap row
    host_compiler_or_skip()
    src = CASES[name]
    prog = compile_plugin_source(src)
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog, SR).state,
                            nch_of(src), device="cpu")
    x, bv, bm = _inputs(kern, 3, seed=11)
    bv2, bm2 = bv.clone(), bm.clone()
    y, _ = DX.device_exec(kern.program, x, bv, bm)
    y2, _ = DX.device_exec_host(kern.program, x, bv2, bm2)
    # the high-water slot: the kernel marks dynamic writes only, as the
    # reference does; the plain version (the Python golden, which cannot
    # tell a frozen var's static address from a dynamic one) marks static
    # writes too, all inside the heap, so neither overflows
    rest = [i for i in range(bv.shape[1]) if i != kern._hw]
    assert torch.equal(y, y2) and torch.equal(bv[:, rest], bv2[:, rest]) \
        and torch.equal(bm, bm2)
    assert float(bv2[:, kern._hw].max()) <= float(bv[:, kern._hw].min())
    g0, G = kern.sample.gmem_base, kern.sample.gmem_cells
    assert not torch.equal(bm[:, g0:g0 + G], kern.initial_carry()[1][g0:g0 + G]
                           .expand(3, -1))
    # no gmem write moved the high water
    assert float(bv[:, kern._hw].max()) < kern.mem_size
    assert float(bv2[:, kern._hw].max()) < 1 << 20


def test_printed_gmem_goes_through_k11s_view():
    prog = compile_plugin_source(CASES["gmem_bulk"])
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                            device="cpu")
    src = kern.program.source
    # the segment side is the views' shared helpers, the heap side K11's
    assert "zx_gmem_bulk(S, 4070, " in src and "zb_gmem_copy(S, 2005, 2000" \
        in src and "zb_gmem_bulk" not in src
    assert "M + gmem_base, gmem_cells" in src
    # the window's size is an argument: a climb of the ladder builds the
    # same text
    kern.grow_to(1 << 15)
    assert kern.program.source == src and kern.mem_size == 1 << 15


def test_ladder_climb_carries_the_window():
    # the heap grows past its rung in the second render: the window and
    # the MIDI out table move to the new bases, the render replays
    src = ("@init\nbuf = 100; ctr = 0; gmem[5] = 3;\n"
           "@block\ngmem[7] += 1; gmem_put(20, 100, 4);\nmidisend(0, 144, 60, 90);\n"
           "@sample\nn = abs(spl0) > 0.2 ? 3 : 1;\n"
           "loop(n, buf[ctr] = spl0 + gmem[5]; ctr += 1; );\n"
           "gmem[6] += 0.001;\n"
           "spl0 = spl0 * 0.5 + buf[ctr > 3000 ? ctr - 3000 : 0] * 0.1"
           " + gmem[7] * 0.001;\n")
    prog = compile_plugin_source(src)
    x = noise(1, 6000)
    gold, y_ref = golden_render(prog, x)
    owner = make_initialized_shadow(prog)
    kern = DeviceExecKernel(prog, owner.state, 1, device="cpu")
    y1, carry = kern.render(x[:, :1536])
    assert kern.mem_size == 4096 and not kern.heap_climbs
    g_before = carry[1][kern.sample.gmem_base:kern.sample.gmem_base + 8]
    y2, carry = kern.render(x[:, 1536:], carry=carry)
    assert kern.heap_climbs and kern.mem_size > 4096
    assert carry[1].shape[0] == kern.sample.total_mem \
        == kern.mem_size + (1 << 20) + kern.sample.midi_out_cells
    assert float(g_before[7]) == 3.0 and kern.last_midi_out
    kern.writeback(carry, owner.state)
    held(gold.state, y_ref, np.concatenate([y1, y2], axis=1), owner.state,
         "ladder")


def test_eight_files_equal_their_solo_renders():
    # each file's row holds its own window: a batch of 8 renders as 8 lone
    # instances would
    src = CASES["lone_bus"]
    prog = compile_plugin_source(src)
    xs = np.stack([noise(1, T, seed=50 + f, scale=0.4) for f in range(8)])
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                            device="cpu")
    y8, (bv8, bm8) = kern.render_files(xs)
    assert bm8.shape == (8, kern.sample.total_mem)
    for f in range(8):
        solo = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                                device="cpu")
        y, (bv, bm) = solo.render_device(xs[f])
        assert torch.equal(y8[f], y) and torch.equal(bv8[f], bv) \
            and torch.equal(bm8[f], bm)
    g0 = kern.sample.gmem_base
    assert len({float(bm8[f, g0 + 10]) for f in range(8)}) == 1   # the bc
    assert len({float(bm8[f, 201]) for f in range(8)}) == 8   # the inputs


def test_resume_from_a_converted_jax_carry():
    # the JAX row [heap | gmem window | ...] converted: the window comes
    # across and the port's render resumes where JAX's would
    src = CASES["gmem_bulk"]
    x = noise(1, 1600, seed=9, scale=0.4)
    cut = 1024
    jprog = jax_compile(src)
    jkern = JaxDeviceExec(jprog, jax_shadow(jprog).state, 1, block_size=512)
    _y1, jcarry = jkern.render(x[:, :cut])
    # (the JAX render donates its carry: copy it out first)
    jcarry_np = (np.array(jcarry[0]), np.array(jcarry[1]))
    y2_jax, _ = jkern.render(x[:, cut:], carry=jcarry)

    prog = compile_plugin_source(src)
    kern = DeviceExecKernel(prog, make_initialized_shadow(prog).state, 1,
                            device="cpu")
    carry = convert.devexec_carry_from_numpy(kern, jcarry_np,
                                             jkern.sample.mem_size)
    g0, js = kern.sample.gmem_base, jkern.sample.gmem_base
    assert np.array_equal(carry[1][g0:g0 + 4096].numpy(),
                          jcarry_np[1][js:js + 4096])
    y2, _ = kern.render(x[:, cut:], carry=carry)
    assert np.abs(y2.astype(np.float64) - np.asarray(y2_jax)).max() \
        <= AUDIO_MAX
    _gold, y_ref = golden_render(prog, x)
    assert compare_audio(y_ref[:, cut:], y2).audio_passed


def test_writeback_bumps_an_attached_segment_as_the_reference():
    # an instance on an EngineHost attaches the segment in @init: the
    # window starts from it, and the writeback bumps the segment's pages
    # once over the span the render changed, as the reference's does
    src = ("@init\ngmem_attach(\"scene\");\ngmem[70000] = 1;\n"
           "@block\ngmem[5] += 1; gmem[70001] = bc; bc += 1;\n"
           "@sample\n" + VOICES + "spl0 = spl0 * 0.5 + gmem[70000] * 0.01;\n")
    x = noise(1, T)
    inst = PluginInstance(compile_plugin_source(src), host=EngineHost(),
                          device="cpu")
    jinst = JaxInstance(jax_compile(src), host=JaxEngineHost())
    assert inst.engine == "torch-devexec" and jinst.engine == "tpu-devexec"
    res, jres = inst.render(x), jinst.render(x)
    assert np.abs(res.audio.astype(np.float64) - jres.audio).max() <= AUDIO_MAX
    seg = inst.shadow.state.host.attached_gmem
    jseg = jinst.shadow.state.host.attached_gmem
    assert inst.shadow.state.gmem is seg.cells
    assert seg.cells[5] == 3.0 and seg.cells[70001] == 2.0
    assert np.array_equal(seg.cells, jseg.cells)
    assert np.array_equal(seg.page_seq, jseg.page_seq) \
        and seg.global_seq == jseg.global_seq
    assert int(seg.page_seq[0]) == seg.global_seq


def test_stand_in_is_devexec_only_in_both_packages():
    # both vectorizers reject the stand-in; prefer="tpu" (the reference's
    # name for the device engines) takes the sequential executor in both
    # packages, and the vectorizer where it takes the plugin
    src = builtin_plugins.scene_voice_panner(4, 64)
    for prefer in ("auto", "tpu"):
        inst = PluginInstance(compile_plugin_source(src), prefer=prefer,
                              device="cpu")
        jinst = JaxInstance(jax_compile(src), prefer=prefer)
        assert inst.engine == "torch-devexec" and jinst.engine == "tpu-devexec"
        assert "gmem in @sample" in inst.spec_error
    vec = "@sample\nspl0 *= 0.5;\n"
    assert PluginInstance(compile_plugin_source(vec), prefer="tpu",
                          device="cpu").engine == "torch-vector"
    assert JaxInstance(jax_compile(vec), prefer="tpu").engine == "tpu-vector"
    # where both refuse, prefer="tpu" raises in both packages
    both = "@block\nr = gmem_seq(0);\n@sample\n" + VOICES
    with pytest.raises(SpecializeError, match="devexec: .*gmem_seq"):
        PluginInstance(compile_plugin_source(both), prefer="tpu",
                       device="cpu")
    with pytest.raises(Exception, match="devexec"):
        JaxInstance(jax_compile(both), prefer="tpu")
    assert PluginInstance(compile_plugin_source(both),
                          device="cpu").engine == "cpu-shadow"
