"""BASELINE configs 2-4 on the port: the STFT overlap-add, the spectral-gate
denoiser and partitioned convolution with a 131,072-tap IR.

The counterparts of `_section_stft`, `_section_denoiser` and
`_section_convolution` of the repository's `bench.py`, at its shapes:
32 lanes x 20 s at 48 kHz of seeded noise (`RandomState(11)`), size
2,048 and hop 512, the gate at size 2,048, the decaying IR at part size
2,048.  Each section times a warm-up call, then the best of three, and
reports audio-seconds per second under `bench.py`'s metric name:

    python -m zorak_tpu_torch.bench            # on the card

On the card a call is timed by CUDA events around it, after a
synchronize; on the CPU (`device="cpu"`, for the tests) by the host
clock.  `lanes` and `seconds` cut the shapes for a test.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from .device import resolve_device

SRATE = 48000
LANES = 32
KERNEL_SECONDS = 20.0
IR_TAPS = 131072


def _timed(fn: Callable, audio_seconds: float, device: torch.device,
           runs: int = 3) -> float:
    """Audio-seconds per second of fn(): a warm-up call, then the best of
    `runs`."""
    fn()
    best = 0.0
    for _ in range(runs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
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


SECTIONS = {"stft": section_stft, "denoiser": section_denoiser,
            "convolution": section_convolution}


def main() -> int:
    """Run the three sections on the card and print one JSON line."""
    dev = resolve_device(None)
    out: Dict[str, object] = {"device": torch.cuda.get_device_name(dev)}
    for section in SECTIONS.values():
        out.update(section(dev))
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
