"""BASELINE configs 1-4 on the port: the JSFX delay network (config 1, one
file and a batch of eight), the STFT overlap-add, the spectral-gate
denoiser and partitioned convolution with a 131,072-tap IR.

Config 1 is the repository `bench.py`'s DDT render (its main and
`_ddt_batched`): 60 s of 48 kHz stereo noise at 0.25 rms, `SEG =
(1 << 15) * 11` samples a segment, eight segments (2,883,584 samples),
through `builtin_plugins.wide_delay_network(192)`, the in-repo stand-in
for `DDT.jsfx` (not in the repository); `section_ddt` also times the
engine's default segment, 1 << 17 (22 segments).  Configs 2-4 are the
counterparts of `_section_stft`, `_section_denoiser` and
`_section_convolution`, at its shapes: 32 lanes x 20 s at 48 kHz of
seeded noise (`RandomState(11)`), size 2,048 and hop 512, the gate at
size 2,048, the decaying IR at part size 2,048.  Each section times a
warm-up call, then the best of three, and reports audio-seconds per
second under `bench.py`'s metric name:

    python -m zorak_tpu_torch.bench            # on the card

On the card a call is timed by CUDA events around it, the first
recorded after a synchronize and before the call starts (so the host's
work inside the call counts); on the CPU (`device="cpu"`, for the
tests) by the host clock.  The DDT sections draw a fresh seeded input on
the device before each call, and the audio stays there.  `lanes`,
`seconds` and `files` cut the shapes for a test.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .device import resolve_device

SRATE = 48000
LANES = 32
KERNEL_SECONDS = 20.0
IR_TAPS = 131072
DDT_SEG = (1 << 15) * 11          # bench.py's SEG
DDT_SAMPLES = DDT_SEG * 8         # bench.py's N_SAMPLES, 60.07 s
ENGINE_SEG = 1 << 17              # the engine's default segment
DDT_TAPS = 192
DDT_FILES = 8


def _timed(fn: Callable, audio_seconds: float, device: torch.device,
           runs: int = 3, inputs: Optional[Callable] = None) -> float:
    """Audio-seconds per second of fn(): a warm-up call, then the best of
    `runs`.  With `inputs`, call i (0 the warm-up) is fn(inputs(i)), its
    input made before its clock starts."""
    fn(*(() if inputs is None else (inputs(0),)))
    best = 0.0
    for i in range(1, runs + 1):
        args = () if inputs is None else (inputs(i),)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn(*args)
            secs = time.perf_counter() - t0
        best = max(best, audio_seconds / secs)
    return round(best, 1)


def _noise(rng: np.random.RandomState, lanes: int, n: int, scale: float,
           device: torch.device) -> torch.Tensor:
    return torch.from_numpy((rng.randn(lanes, n) * scale).astype(np.float32)
                            ).to(device)


def section_stft(device=None, lanes: int = LANES,
                 seconds: float = KERNEL_SECONDS) -> Dict[str, float]:
    from .kernels.stft import stft_process

    dev = resolve_device(device)
    n = int(seconds * SRATE)
    xb = _noise(np.random.RandomState(11), lanes, n, 0.25, dev)

    def bins(spec):
        w = torch.linspace(0.5, 1.5, spec.shape[-1], dtype=torch.float32,
                           device=spec.device)
        return spec * w

    return {"stft2048_overlap_add_rtx": _timed(
        lambda: stft_process(xb, bins, size=2048, hop=512),
        lanes * n / SRATE, dev)}


def section_denoiser(device=None, lanes: int = LANES,
                     seconds: float = KERNEL_SECONDS) -> Dict[str, float]:
    from .kernels.stft import spectral_gate

    dev = resolve_device(device)
    n = int(seconds * SRATE)
    xq = _noise(np.random.RandomState(11), lanes, n, 0.02, dev)
    return {"restoration_spectral_gate_rtx": _timed(
        lambda: spectral_gate(xq, size=2048), lanes * n / SRATE, dev)}


def section_ir(rng: np.random.RandomState, k: int = IR_TAPS) -> np.ndarray:
    """The bench's decaying IR, drawn after the input from the same stream."""
    return (rng.randn(k) * np.exp(-np.arange(k) / (k / 5))).astype(np.float32)


def section_convolution(device=None, lanes: int = LANES,
                        seconds: float = KERNEL_SECONDS) -> Dict[str, float]:
    from .kernels.convolution import partitioned_convolve

    dev = resolve_device(device)
    n = int(seconds * SRATE)
    rng = np.random.RandomState(11)
    xb = _noise(rng, lanes, n, 0.25, dev)
    ir = torch.from_numpy(section_ir(rng)).to(dev)
    return {"partitioned_convolution_131072tap_rtx": _timed(
        lambda: partitioned_convolve(xb, ir, part_size=2048),
        lanes * n / SRATE, dev)}


def _ddt_noise(device: torch.device, shape, seed: int) -> torch.Tensor:
    """Seeded stereo noise at 0.25 rms, made on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * 0.25


def ddt_program():
    """The config's plugin: the 192-tap widening of the in-repo network."""
    from .builtin_plugins import wide_delay_network
    from .ir import compile_plugin_source

    return compile_plugin_source(wide_delay_network(DDT_TAPS))


def section_ddt(device=None, seconds: Optional[float] = None
                ) -> Dict[str, float]:
    """`ddt_offline_render_rtx`: one file of 60 s stereo through
    `render_device` at bench.py's segment (8 segments), and beside it
    (`ddt_offline_render_rtx_engine_segment`) at the engine's default
    (22 segments)."""
    from .lowering import specialize_sample_kernel
    from .verify import make_initialized_shadow

    dev = resolve_device(device)
    n = DDT_SAMPLES if seconds is None else int(seconds * SRATE)
    prog = ddt_program()
    out = {}
    for name, seg in (("ddt_offline_render_rtx", DDT_SEG),
                      ("ddt_offline_render_rtx_engine_segment", ENGINE_SEG)):
        kern = specialize_sample_kernel(
            prog, make_initialized_shadow(prog, float(SRATE)).state, 2,
            segment_len=seg, device=dev)
        out[name] = _timed(lambda x: kern.render_device(x), n / SRATE, dev,
                           inputs=lambda i: _ddt_noise(dev, (2, n), i))
    return out


def section_ddt_batched(device=None, seconds: Optional[float] = None,
                        files: int = DDT_FILES) -> Dict[str, object]:
    """`ddt_batched`: `files` independent 60 s renders of the config as
    one batch through `BatchRenderer` at bench.py's segment."""
    from .parallel import BatchRenderer

    dev = resolve_device(device)
    n = DDT_SAMPLES if seconds is None else int(seconds * SRATE)
    br = BatchRenderer(ddt_program(), float(SRATE), segment_len=DDT_SEG,
                       device=dev)
    best = _timed(br.render_files, files * n / SRATE, dev,
                  inputs=lambda i: _ddt_noise(dev, (files, 2, n), 100 + i))
    return {"ddt_batched": {"files": files, "audio_s_per_s": best,
                            "per_file_rtx": round(best / files, 1)}}


SECTIONS = {"stft": section_stft, "denoiser": section_denoiser,
            "convolution": section_convolution}
DDT_SECTIONS = {"ddt": section_ddt, "ddt_batched": section_ddt_batched}


def main() -> int:
    """Run every section on the card and print one JSON line."""
    dev = resolve_device(None)
    out: Dict[str, object] = {"device": torch.cuda.get_device_name(dev)}
    for section in (*DDT_SECTIONS.values(), *SECTIONS.values()):
        out.update(section(dev))
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
