"""The staged dumps (`zorak_tpu_torch.utils.dumps.dump_stages`) against the
JAX package's `zorak_tpu.utils.dumps` on the CPU: the source and the
lowered sections byte for byte, the plan's lines, and the port's own
stages (one segment's torch calls, the generated CUDA, nvcc's report or
the line that says why there is none)."""
import pytest

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.lowering.devexec import DeviceExecKernel as JaxDeviceExec
from zorak_tpu.utils.dumps import dump_stages as jax_dump_stages
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.lowering import specialize_sample_kernel
from zorak_tpu_torch.lowering.devexec import DeviceExecKernel
from zorak_tpu_torch.utils.dumps import dump_stages
from zorak_tpu_torch.verify.nulltest import make_initialized_shadow

FILES = ("01_source.jsfx", "02_sections_lowered.jsfx", "03_plan.txt",
         "04_ops.txt", "05_cuda.cu", "06_build.txt")

# a ring, two recurrences, an induction cursor and a scan group (K4)
VECTOR_SRC = """\
desc:dump me
slider1:40<0,100,1>Amount
@init
BUF = 2048; MASK = BUF - 1; a = 0.995;
@slider
wet = slider1 / 100;
@sample
BUF[w & MASK] = spl0;
d = BUF[(w - 300) & MASK];
z = (1 - a) * d + a * z;
x = abs(spl0);
env = x > env ? x + (env - x) * 0.9 : x + (env - x) * 0.999;
spl0 = spl0 * (1 - wet) + (z + env) * wet;
w += 1;
"""


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path / "traces"))


def build_report_expected(text):
    try:
        _build.find_nvcc()
    except RuntimeError:
        assert text.startswith("(build text unavailable: nvcc not found")
        return
    assert "registers" in text


def test_vector_kernel_stages_against_the_reference(tmp_path):
    prog = compile_plugin_source(VECTOR_SRC)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    1, segment_len=2048, device="cpu")
    paths = dump_stages(kern, tmp_path / "port", example_len=1024)
    assert set(paths) == set(FILES)
    jprog = jax_compile(VECTOR_SRC)
    jkern = jax_specialize(jprog, jax_shadow(jprog).state, 1,
                           segment_len=2048)
    jpaths = jax_dump_stages(jkern, tmp_path / "jax", example_len=1024)
    for name in FILES[:2]:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    plan = (tmp_path / "port" / "03_plan.txt").read_text()
    assert plan == open(jpaths["03_plan.txt"]).read()
    assert "induction" in plan and "linrec" in plan
    ops = (tmp_path / "port" / "04_ops.txt").read_text()
    head = ops.splitlines()[0]
    assert head.startswith("one segment of 1024 samples on the CPU: ")
    counts = [int(ln.split()[0]) for ln in ops.splitlines()[2:]]
    assert counts and sum(counts) == int(head.split(": ")[1].split()[0])
    cu = (tmp_path / "port" / "05_cuda.cu").read_text()
    assert cu.count("// ==== K4 scan_group, scan level") == \
        len(kern.scan_level_programs()) >= 1
    build_report_expected((tmp_path / "port" / "06_build.txt").read_text())
    assert not (tmp_path / "port" / "_build").exists()


def test_coupled_kernel_dumps_k10s_text(tmp_path):
    prog = compile_plugin_source(builtin_plugins.spectral_tilt_leveler(256))
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    2, device="cpu")
    dump_stages(kern, tmp_path, example_len=1024)
    cu = (tmp_path / "05_cuda.cu").read_text()
    assert "// ==== K10 block_section, the @block section ====" in cu
    assert kern._block_prog.source in cu
    assert "has_block=True" in (tmp_path / "03_plan.txt").read_text()


def test_devexec_kernel_stages(tmp_path):
    # the reference's dump writes 01 and 02 for its sequential executor and
    # then stops at the vector plan it lacks; the port's writes all six
    src = builtin_plugins.scene_voice_panner(4, 64)
    prog = compile_plugin_source(src)
    state = make_initialized_shadow(prog).state
    kern = DeviceExecKernel(prog, state, 2, device="cpu")
    before = (kern.mem_size, kern._rng_state)
    paths = dump_stages(kern, tmp_path / "port", example_len=600)
    assert set(paths) == set(FILES)
    assert (kern.mem_size, kern._rng_state) == before   # a CPU twin rendered
    jprog = jax_compile(src)
    jkern = JaxDeviceExec(jprog, jax_shadow(jprog).state, 2, block_size=512)
    with pytest.raises(AttributeError):
        jax_dump_stages(jkern, tmp_path / "jax", example_len=600)
    for name in FILES[:2]:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    plan = (tmp_path / "port" / "03_plan.txt").read_text()
    assert plan.startswith("engine=devexec block_size=512 nch=2 "
                           "sections=['block', 'sample']")
    assert f"gmem window [{kern.mem_size}, {kern.mem_size + (1 << 20)})" \
        in plan
    assert f"{kern._hw}: ('var', '__mem_hiwater__')" in plan
    ops = (tmp_path / "port" / "04_ops.txt").read_text()
    assert ops.startswith("one segment of 600 samples on the CPU: ")
    cu = (tmp_path / "port" / "05_cuda.cu").read_text()
    assert cu == f"// ==== K11 device_exec ====\n{kern.program.source}\n"
    build_report_expected((tmp_path / "port" / "06_build.txt").read_text())
