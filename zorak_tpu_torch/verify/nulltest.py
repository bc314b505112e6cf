"""Audio comparator of the null-test harness (copy of zorak_tpu/verify/nulltest.py).

Reference correctness-check semantics (ref:
src/JSFXCorrectnessCheck.h:34-35): audio compared on f32-rounded samples
with epsilon 1e-5 (~ -100 dBFS).  Reports max |delta| in dBFS like the
reference's export bundle.  Only the audio comparison is ported so far.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

AUDIO_EPS = 1.0e-5   # ref: JSFXCorrectnessCheck.h:34
SCALAR_EPS = 1.0e-8  # ref: JSFXCorrectnessCheck.h:35


@dataclass
class NullReport:
    n_samples: int = 0
    n_channels: int = 0
    max_abs_delta: float = 0.0
    rms_delta: float = 0.0
    audio_passed: bool = True
    var_mismatches: List[Tuple[str, float, float]] = field(default_factory=list)
    # first mem-page mismatch, latched like the reference harness
    # (ref: JSFXCorrectnessCheck.h:991-1040 latchMismatch + freeze):
    # (address, page, ref_value, test_value)
    mem_mismatch: Optional[Tuple[int, int, float, float]] = None
    # ("midiOutCount", n_ref, n_test) or ("midiOut[i]", ref_ev, test_ev)
    midi_mismatch: Optional[Tuple[str, object, object]] = None
    # (mask_name, ref_mask, test_mask)
    mask_mismatch: Optional[Tuple[str, int, int]] = None
    # the scalar/mem epsilon this report was judged at
    scalar_eps_used: float = SCALAR_EPS

    @property
    def max_delta_dbfs(self) -> float:
        if self.max_abs_delta <= 0.0:
            return -math.inf
        return 20.0 * math.log10(self.max_abs_delta)

    @property
    def passed(self) -> bool:
        return (self.audio_passed and not self.var_mismatches
                and self.mem_mismatch is None and self.midi_mismatch is None
                and self.mask_mismatch is None)

    def summary(self) -> str:
        db = self.max_delta_dbfs
        db_s = f"{db:.1f} dBFS" if math.isfinite(db) else "-inf dBFS"
        status = "PASS" if self.passed else "FAIL"
        extra = ""
        if self.scalar_eps_used != SCALAR_EPS:
            extra += f", scalar_eps={self.scalar_eps_used:g}"
        if self.mem_mismatch is not None:
            a, page, rv, tv = self.mem_mismatch
            extra += f", mem[{a}] (page {page}): {rv!r} vs {tv!r}"
        if self.midi_mismatch is not None:
            extra += f", midi: {self.midi_mismatch}"
        if self.mask_mismatch is not None:
            extra += f", pending mask: {self.mask_mismatch}"
        return (f"[{status}] null test: {self.n_channels}ch x {self.n_samples} "
                f"samples, max |delta| = {self.max_abs_delta:.3e} ({db_s}), "
                f"rms = {self.rms_delta:.3e}, "
                f"var mismatches = {len(self.var_mismatches)}{extra}")


def compare_audio(reference: np.ndarray, test: np.ndarray,
                  eps: float = AUDIO_EPS) -> NullReport:
    """Both arrays f32 [channels, samples]; compared after f32 rounding."""
    a = np.asarray(reference, dtype=np.float32).astype(np.float64)
    b = np.asarray(test, dtype=np.float32).astype(np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    rep = NullReport(
        n_samples=a.shape[1] if a.ndim > 1 else a.shape[0],
        n_channels=a.shape[0] if a.ndim > 1 else 1,
        max_abs_delta=float(d.max(initial=0.0)),
        rms_delta=float(np.sqrt(np.mean(d * d))) if d.size else 0.0,
    )
    rep.audio_passed = rep.max_abs_delta <= eps
    return rep
