"""The port's BASELINE sections 2-4 (zorak_tpu_torch/bench.py) on the CPU,
at a cut size: they report `bench.py`'s metric names, draw `bench.py`'s
inputs, and refuse to run without a GPU unless asked for the CPU."""
import pathlib
import re

import numpy as np
import pytest
import torch

from zorak_tpu_torch import bench

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name,metric", [
    ("stft", "stft2048_overlap_add_rtx"),
    ("denoiser", "restoration_spectral_gate_rtx"),
    ("convolution", "partitioned_convolution_131072tap_rtx"),
])
def test_section_reports_the_bench_metric(name, metric):
    assert f'"{metric}"' in (REPO / "bench.py").read_text()
    out = bench.SECTIONS[name](device="cpu", lanes=2, seconds=0.05)
    assert list(out) == [metric]
    assert np.isfinite(out[metric]) and out[metric] > 0


def test_shapes_and_inputs_are_the_bench_files():
    text = (REPO / "bench.py").read_text()
    assert re.search(r"^_LANES = 32\b", text, re.M)
    assert re.search(r"^_KERNEL_SECONDS = 20\.0", text, re.M)
    assert "k = 131072" in text and "part_size=2048" in text
    assert (bench.LANES, bench.KERNEL_SECONDS, bench.IR_TAPS) == (32, 20.0,
                                                                 131072)
    rng = np.random.RandomState(11)
    rng.randn(2, 10)
    ir = bench.section_ir(rng, 1000)
    rng2 = np.random.RandomState(11)
    rng2.randn(2, 10)
    want = rng2.randn(1000) * np.exp(-np.arange(1000) / (1000 / 5))
    assert ir.dtype == np.float32 and np.array_equal(ir, want.astype(np.float32))


def test_sections_need_a_gpu_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    for fn in bench.SECTIONS.values():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(lanes=1, seconds=0.01)


def test_ddt_sections_report_the_bench_metrics():
    # config 1 at a cut size: one file at the bench's segment and at the
    # engine's, and a batch of files
    text = (REPO / "bench.py").read_text()
    for name in ("ddt_offline_render_rtx", "ddt_batched", "audio_s_per_s",
                 "per_file_rtx"):
        assert f'"{name}"' in text
    assert re.search(r"^SEG = \(1 << 15\) \* 11\b", text, re.M)
    assert re.search(r"^N_SAMPLES = SEG \* 8\b", text, re.M)
    assert (bench.DDT_SEG, bench.DDT_SAMPLES, bench.ENGINE_SEG) == (
        360448, 2883584, 1 << 17)
    out = bench.section_ddt(device="cpu", seconds=0.05)
    assert list(out) == ["ddt_offline_render_rtx",
                         "ddt_offline_render_rtx_engine_segment"]
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    out = bench.section_ddt_batched(device="cpu", seconds=0.05, files=2)
    assert list(out) == ["ddt_batched"]
    got = out["ddt_batched"]
    assert got["files"] == 2 and got["audio_s_per_s"] > 0
    assert got["per_file_rtx"] == round(got["audio_s_per_s"] / 2, 1)


def test_ddt_sections_need_a_gpu_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    for fn in bench.DDT_SECTIONS.values():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(seconds=0.01)
