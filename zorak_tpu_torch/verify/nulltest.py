"""Null-test harness (counterpart of zorak_tpu/verify/nulltest.py).

Reference correctness-check semantics (ref:
src/JSFXCorrectnessCheck.h:34-35): audio compared on f32-rounded samples
with epsilon 1e-5 (~ -100 dBFS), scalar state with 1e-8.  Reports
max |delta| in dBFS like the reference's export bundle.  `null_test_plugin`
holds the vector engine to the package's Python golden or to its native C
golden (`shadow/cgen.py`), and can write the export bundle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

AUDIO_EPS = 1.0e-5   # ref: JSFXCorrectnessCheck.h:34
SCALAR_EPS = 1.0e-8  # ref: JSFXCorrectnessCheck.h:35
MEM_PAGE = 1024      # doubles per compared heap page


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


def compare_states(ref_state, test_state, eps: float = SCALAR_EPS,
                   report: Optional[NullReport] = None,
                   skip: frozenset = frozenset()) -> NullReport:
    """Compare user vars (+ spl registers) between two shadow states, by
    the reference's absolute compare (JSFXCorrectnessCheck.h nearlyEqual)."""
    rep = report or NullReport()
    for name, rv in ref_state.V.items():
        if name in skip:
            continue
        tv = test_state.V.get(name, 0.0)
        if _differs(rv, tv, eps):
            rep.var_mismatches.append((name, float(rv), float(tv)))
    for i in range(64):
        if _differs(ref_state.spl[i], test_state.spl[i], eps):
            rep.var_mismatches.append((f"spl{i}", ref_state.spl[i], test_state.spl[i]))
    return rep


def compare_memory_pages(ref_state, test_state, eps: float = SCALAR_EPS,
                         report: Optional[NullReport] = None) -> NullReport:
    """Compare mem[] in 1024-double pages up to max(used_ref, used_test),
    zero-filling past each side's extent; latch the FIRST mismatch with its
    page number (ref: JSFXCorrectnessCheck.h:991-1040)."""
    rep = report or NullReport()
    if rep.mem_mismatch is not None:
        return rep
    used = max(int(getattr(ref_state, "mem_used", 0)),
               int(getattr(test_state, "mem_used", 0)))
    if used <= 0:
        return rep
    a_full = np.asarray(ref_state.mem[:used], dtype=np.float64)
    b_full = np.asarray(test_state.mem[:used], dtype=np.float64)
    if a_full.size < used:
        a_full = np.concatenate([a_full, np.zeros(used - a_full.size)])
    if b_full.size < used:
        b_full = np.concatenate([b_full, np.zeros(used - b_full.size)])
    d = np.abs(a_full - b_full)
    both_nan = np.isnan(a_full) & np.isnan(b_full)
    one_nan = np.isnan(a_full) ^ np.isnan(b_full)
    idx = np.where(((d > eps) | one_nan) & ~both_nan)[0]
    if idx.size:
        a0 = int(idx[0])
        rep.mem_mismatch = (a0, a0 // MEM_PAGE,
                            float(a_full[a0]), float(b_full[a0]))
    return rep


def compare_midi_out(ref_events, test_events,
                     report: Optional[NullReport] = None) -> NullReport:
    """Stable-sort both sides by sample offset, then compare count and every
    (offset, b1, b2, b3) (ref: JSFXCorrectnessCheck.h:949-989).  Events with
    a variable-length payload (sysex / midisend_buf family — MidiEvent.data
    or a 5th tuple element) additionally compare the FULL byte string, so a
    path that truncates a long message to its first three bytes fails."""
    rep = report or NullReport()
    if rep.midi_mismatch is not None:
        return rep

    def norm(evs):
        out = []
        for e in evs:
            if hasattr(e, "offset"):
                data = (tuple(int(v) & 0xFF for v in e.data)
                        if e.data is not None else None)
                out.append((int(e.offset), int(e.b1) & 0xFF,
                            int(e.b2) & 0xFF, int(e.b3) & 0xFF, data))
            else:
                off, b1, b2, b3 = e[:4]
                data = (tuple(int(v) & 0xFF for v in e[4])
                        if len(e) > 4 and e[4] is not None else None)
                out.append((int(off), int(b1) & 0xFF,
                            int(b2) & 0xFF, int(b3) & 0xFF, data))
        out.sort(key=lambda t: t[0])  # python sort is stable
        return out

    a, b = norm(ref_events or []), norm(test_events or [])
    if len(a) != len(b):
        rep.midi_mismatch = ("midiOutCount", len(a), len(b))
        return rep
    for i, (ea, eb) in enumerate(zip(a, b)):
        if ea != eb:
            rep.midi_mismatch = (f"midiOut[{i}]", ea, eb)
            return rep
    return rep


def compare_pending_masks(ref_state, test_state,
                          report: Optional[NullReport] = None) -> NullReport:
    """Exact compare of the pending change/automate/automate-end slider
    masks (ref: JSFXCorrectnessCheck.h:915-948)."""
    rep = report or NullReport()
    if rep.mask_mismatch is not None:
        return rep
    for name in ("pending_change_mask", "pending_automate_mask",
                 "pending_automate_end_mask"):
        rv = int(getattr(ref_state, name, 0))
        tv = int(getattr(test_state, name, 0))
        if max(rv, 0) != max(tv, 0):
            rep.mask_mismatch = (name, rv, tv)
            return rep
    return rep


def _differs(a: float, b: float, eps: float) -> bool:
    if a != a and b != b:  # both NaN -> equal
        return False
    if a == b:
        return False
    return not (abs(a - b) <= eps)


def apply_slider_state(state, program,
                       slider_overrides: Optional[Dict[int, float]] = None,
                       string_overrides: Optional[Dict[int, str]] = None) -> None:
    """Push slider defaults/overrides into the state, including numeric
    alias variables and string-slider handles (ref: host pushes params and
    string sliders before @init, src/JSFXJuceProcessor.cpp:3297-3305)."""
    overrides = slider_overrides or {}
    strings = string_overrides or {}
    for d in program.slider_decls:
        if d.is_string:
            text = strings.get(d.index0, d.string_default)
            handle = state.handles_by_string.get(text)
            if handle is None:
                handle = max(state.handles_by_string.values(), default=1 << 40) + 1
                state.handles_by_string[text] = handle
            state.strings_by_handle[handle] = text
            state.sliders[d.index0] = float(handle)
            if d.var_name:
                state.V[d.var_name] = float(handle)
        else:
            val = overrides.get(d.index0, d.default)
            state.sliders[d.index0] = val
            if d.var_name and d.var_name in state.V:
                state.V[d.var_name] = val
    for idx0, val in overrides.items():
        state.sliders[idx0] = val


def make_initialized_shadow(program, srate: float = 48000.0,
                            slider_overrides: Optional[Dict[int, float]] = None,
                            string_overrides: Optional[Dict[int, str]] = None,
                            host=None):
    """Shadow with host-default slider push -> @init -> @slider
    (REAPER ordering, ref: src/JSFXJuceProcessor.cpp:3297-3305)."""
    from ..shadow import compile_shadow

    p = compile_shadow(program, host=host)
    p.state.srate = float(srate)
    apply_slider_state(p.state, program, slider_overrides, string_overrides)
    p.run_init()
    p.run_slider()
    return p


def export_bundle(out_dir, reference: np.ndarray, test: np.ndarray,
                  srate: float, report: NullReport,
                  name: str = "nulltest") -> Dict[str, str]:
    """Write compiled/shadow/delta WAVs + a JSON report, like the reference
    harness's export bundle (ref: src/JSFXCorrectnessCheck.h:1131-1250)."""
    import json
    from pathlib import Path

    from ..runtime import wavio

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    delta = (np.asarray(test, np.float64) - np.asarray(reference, np.float64))
    for tag, audio in (("shadow", reference), ("compiled", test),
                       ("delta", delta.astype(np.float32))):
        p = out / f"{name}_{tag}.wav"
        wavio.write_wav(p, audio, int(srate), bits=24)
        paths[tag] = str(p)
    rep_path = out / f"{name}_report.json"
    rep_path.write_text(json.dumps({
        "samples": report.n_samples,
        "channels": report.n_channels,
        "max_abs_delta": report.max_abs_delta,
        "max_delta_dbfs": (report.max_delta_dbfs
                           if math.isfinite(report.max_delta_dbfs) else None),
        "rms_delta": report.rms_delta,
        "audio_passed": report.audio_passed,
        "var_mismatches": report.var_mismatches[:100],
        "passed": report.passed,
        "audio_eps": AUDIO_EPS,
        "scalar_eps": SCALAR_EPS,
    }, indent=2))
    paths["report"] = str(rep_path)
    return paths


def null_test_plugin(program, x: np.ndarray, srate: float = 48000.0,
                     block_size: int = 512, segment_len: int = 4096,
                     slider_overrides: Optional[Dict[int, float]] = None,
                     compare_state: bool = True, golden: str = "python",
                     compare_mem: bool = False, midi=None,
                     export_dir=None, name: str = "nulltest",
                     device=None) -> NullReport:
    """Render x through the golden AND the vector kernel; compare.

    x: float32 [channels, samples].  golden: "python" (exact reference
    semantics, slow) or "native" (C-compiled, bit-identical, fast).
    compare_state adds var/spl + pending-mask + MIDI-out compares;
    compare_mem additionally diffs the whole heap in 1024-double pages
    (ref: JSFXCorrectnessCheck.h:915-1040).  midi: optional
    [(abs_offset, b1, b2, b3)] events fed to both sides.  export_dir: where
    to write the export bundle (`export_bundle`), named `name`.
    device: where the kernel runs (None means CUDA).
    """
    from ..lowering import specialize_sample_kernel

    nch, total = x.shape

    # golden render (block loop like a host would drive)
    if golden == "native":
        from ..shadow import compile_native_shadow

        gold = compile_native_shadow(program)
        gold.state.srate = float(srate)
        apply_slider_state(gold.state, program, slider_overrides)
        gold.run_init()
        gold.run_slider()
    elif golden == "python":
        gold = make_initialized_shadow(program, srate, slider_overrides)
    else:
        raise ValueError(f"golden must be 'python' or 'native', not {golden!r}")
    midi = sorted(midi or [], key=lambda e: e[0])
    y_ref = np.zeros_like(x)
    gold_midi_out = []
    for start in range(0, total, block_size):
        stop = min(start + block_size, total)
        if midi:
            from ..shadow.state import MidiEvent

            gold.state.midi_in = [
                MidiEvent(int(e[0]) - start, int(e[1]) & 0xFF,
                          int(e[2]) & 0xFF, int(e[3]) & 0xFF)
                for e in midi if start <= e[0] < stop]
            gold.state.midi_in_pos = 0
        gold.process_block(x[:, start:stop], y_ref[:, start:stop])
        for ev in gold.state.midi_out:
            et = (start + int(ev.offset), int(ev.b1),
                  int(ev.b2), int(ev.b3))
            if ev.data is not None:
                et += (tuple(int(v) & 0xFF for v in ev.data),)
            gold_midi_out.append(et)
        gold.state.midi_out = []

    # vectorized render from an identical snapshot
    snap_owner = make_initialized_shadow(program, srate, slider_overrides)
    kern = specialize_sample_kernel(program, snap_owner.state, nch,
                                    segment_len=segment_len,
                                    block_size=block_size, device=device)
    y_test, carry = kern.render(x, midi=midi if midi else None)

    rep = compare_audio(y_ref, y_test)
    if compare_state:
        kern.writeback(carry, snap_owner.state)
        compare_states(gold.state, snap_owner.state, report=rep)
        compare_pending_masks(gold.state, snap_owner.state, report=rep)
        if midi or gold_midi_out or kern.last_midi_out:
            compare_midi_out(gold_midi_out, kern.last_midi_out, report=rep)
        if compare_mem:
            compare_memory_pages(gold.state, snap_owner.state, report=rep)
    if export_dir is not None:
        export_bundle(export_dir, y_ref, y_test, srate, rep, name=name)
    return rep
