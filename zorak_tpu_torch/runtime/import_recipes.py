"""Non-destructive audio import recipes.

The deterministic file-ingress pipeline of the reference (ref:
src/ZAAudioImportRecipe.h — actions :47-55, rules :94-148, silence
analysis :638-750, segmentation :779-845, renderImportAction
:1504-1720): source files are decoded, optionally segmented by silence,
trimmed/pruned/normalized, and assembled into in-memory renders (never
temp files) that feed the file-slot and sample-pool services.  A recipe
(action + rules + source fingerprints + seed) is serialized and replays
byte-deterministically.

All analysis is numpy-vectorized host code: this runs once per import,
off the device render path.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, asdict
from enum import IntEnum
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ImportAction(IntEnum):
    # ref: ZAAudioImportRecipe.h:47-55
    LOAD_SEPARATE = 1
    APPEND_RAW_AS_SINGLE = 2
    BUILD_MEGA_TEXTURE = 3
    SEGMENT_LONG_FILE = 4
    MODIFY_EXISTING = 5
    SEGMENT_THEN_MEGA_TEXTURE = 6


@dataclass
class SegmentRegion:
    # ref: ZAAudioImportRecipe.h:71-83
    start: int = 0
    end: int = 0
    rms_db: float = -120.0
    peak_db: float = -120.0
    spectral_flux: float = 0.0
    novelty: float = 0.0
    enabled: bool = True

    @property
    def length(self) -> int:
        return max(0, self.end - self.start)


@dataclass
class ImportRules:
    # defaults mirror ref: ZAAudioImportRecipe.h:94-148
    version: int = 1
    trim_edges: bool = True
    strip_internal_silence: bool = False
    segment_by_silence: bool = False
    silence_threshold_db: float = -50.0
    silence_threshold_ratio: float = 0.10
    use_relative_rms_threshold: bool = False
    silence_analysis_window_ms: float = 5.0
    min_silence_ms: float = 100.0
    pre_roll_ms: float = 5.0
    post_roll_ms: float = 15.0
    min_segment_ms: float = 25.0
    max_segment_ms: float = 30000.0
    edge_fade_ms: float = 5.0
    remove_low_rms: bool = False
    min_rms_db: float = -65.0
    reject_near_duplicates: bool = False
    duplicate_similarity_threshold: float = 0.92
    prefer_novel_samples: bool = False
    min_spectral_flux: float = 0.0
    randomize: bool = False
    random_seed: int = 0
    gap_ms: float = 0.0
    crossfade_ms: float = 5.0
    normalize_clips_rms: bool = False
    clip_target_rms_db: float = -24.0
    normalize_final_rms: bool = False
    final_target_rms_db: float = -24.0
    output_channels: int = 2
    output_sample_rate: float = 0.0  # 0 == first source rate
    disabled_input_indices: List[int] = field(default_factory=list)
    manual_segments_by_input: List[List[SegmentRegion]] = field(
        default_factory=list)


def default_rules_for_action(action: ImportAction) -> ImportRules:
    """ref: makeDefaultRulesForAction, ZAAudioImportRecipe.h:1449-1466."""
    r = ImportRules()
    r.strip_internal_silence = action in (
        ImportAction.BUILD_MEGA_TEXTURE, ImportAction.MODIFY_EXISTING,
        ImportAction.SEGMENT_THEN_MEGA_TEXTURE)
    r.segment_by_silence = action in (
        ImportAction.SEGMENT_LONG_FILE,
        ImportAction.SEGMENT_THEN_MEGA_TEXTURE)
    r.trim_edges = True
    r.reject_near_duplicates = action in (
        ImportAction.BUILD_MEGA_TEXTURE,
        ImportAction.SEGMENT_THEN_MEGA_TEXTURE)
    r.prefer_novel_samples = action == ImportAction.BUILD_MEGA_TEXTURE
    r.random_seed = 0
    return r


@dataclass
class SourceFingerprint:
    path: str = ""
    size_bytes: int = 0
    modified_utc_ms: int = 0
    quick_hash: int = 0


@dataclass
class AudioClip:
    """In-memory render: audio [channels, frames] float32 + rate + name."""
    audio: np.ndarray
    sample_rate: float
    name: str = ""


@dataclass
class ImportRecipe:
    version: int = 1
    action: ImportAction = ImportAction.LOAD_SEPARATE
    inputs: List[SourceFingerprint] = field(default_factory=list)
    rules: ImportRules = field(default_factory=ImportRules)
    seed: int = 0
    display_name: str = ""

    def to_json(self) -> str:
        d = asdict(self)
        d["action"] = int(self.action)
        return json.dumps(d, indent=1, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "ImportRecipe":
        d = json.loads(text)
        rules_d = d.get("rules", {})
        manual = [[SegmentRegion(**s) for s in per_input]
                  for per_input in rules_d.pop("manual_segments_by_input", [])]
        rules = ImportRules(**rules_d)
        rules.manual_segments_by_input = manual
        return ImportRecipe(
            version=d.get("version", 1),
            action=ImportAction(d.get("action", 1)),
            inputs=[SourceFingerprint(**f) for f in d.get("inputs", [])],
            rules=rules,
            seed=int(d.get("seed", 0)),
            display_name=d.get("display_name", ""))


@dataclass
class RenderResult:
    ok: bool = False
    message: str = ""
    recipe: ImportRecipe = field(default_factory=ImportRecipe)
    rendered: List[AudioClip] = field(default_factory=list)
    files: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# primitives


def _db_to_lin(db: float) -> float:
    return 10.0 ** (db / 20.0)


def _lin_to_db(x: float) -> float:
    return 20.0 * np.log10(max(float(x), 1e-12))


def _rms(b: np.ndarray, start: int = 0, count: Optional[int] = None) -> float:
    if b.size == 0:
        return 0.0
    seg = b[:, start:(start + count) if count is not None else None]
    if seg.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(np.square(seg, dtype=np.float64))))


def _peak(b: np.ndarray, start: int = 0, count: Optional[int] = None) -> float:
    if b.size == 0:
        return 0.0
    seg = b[:, start:(start + count) if count is not None else None]
    return float(np.abs(seg).max(initial=0.0))


def rms_envelope(b: np.ndarray, sr: float, window_ms: float) -> np.ndarray:
    """Centered boxcar RMS envelope over the per-sample channel-mean square
    (ref: computeRmsEnvelopeLinear, ZAAudioImportRecipe.h:645-695)."""
    n = b.shape[1]
    if n == 0 or b.shape[0] == 0:
        return np.zeros(n)
    ms = np.mean(np.square(b, dtype=np.float64), axis=0)
    window = max(1, int(round(sr * min(max(window_ms, 0.0), 100.0) / 1000.0)))
    if window <= 1:
        return np.sqrt(ms)
    radius = max(0, window // 2)
    csum = np.concatenate([[0.0], np.cumsum(ms)])
    idx = np.arange(n)
    lo = np.maximum(0, idx - radius)
    hi = np.minimum(n, idx + radius + 1)
    counts = np.maximum(1, hi - lo)
    return np.sqrt(np.maximum(0.0, (csum[hi] - csum[lo]) / counts))


def analyse_silence(b: np.ndarray, rules: ImportRules, sr: float
                    ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(silent mask uint8, envelope, threshold) — ref: analyseSilence,
    ZAAudioImportRecipe.h:695-750, incl. the <=2ms spike-bridging pass."""
    n = b.shape[1]
    silent = np.ones(n, dtype=np.uint8)
    env = np.zeros(n)
    if n == 0:
        return silent, env, 0.0
    g_rms = _rms(b)
    g_peak = _peak(b)
    if g_rms <= 1e-10 and g_peak <= 1e-10:
        return silent, env, 0.0
    env = rms_envelope(b, sr, rules.silence_analysis_window_ms)
    thr = _db_to_lin(min(max(rules.silence_threshold_db, -120.0), 0.0))
    if rules.use_relative_rms_threshold:
        thr = max(thr, g_rms * min(max(rules.silence_threshold_ratio, 0.0),
                                   4.0))
    thr = min(max(thr, 1e-8), 4.0)
    silent = (env <= thr).astype(np.uint8)

    # bridge microscopic non-silent spikes inside a quiet run
    bridge = max(1, int(round(sr * 2.0 / 1000.0)))
    i = 0
    while i < n:
        if silent[i]:
            i += 1
            continue
        j = i
        while j < n and not silent[j]:
            j += 1
        surrounded = i > 0 and j < n and silent[i - 1] and silent[j]
        if surrounded and (j - i) <= bridge:
            silent[i:j] = 1
        i = j
    return silent, env, float(thr)


def detect_segments(b: np.ndarray, sr: float, rules: ImportRules
                    ) -> List[SegmentRegion]:
    """Silence-gap segmentation with quietest-cut boundaries, pre/post roll
    and min/max length (ref: detectSegmentsBySilence,
    ZAAudioImportRecipe.h:779-870)."""
    segments: List[SegmentRegion] = []
    n = b.shape[1]
    if n == 0 or sr <= 0:
        return segments
    silent, env, _thr = analyse_silence(b, rules, sr)
    min_sil = max(1, int(round(sr * rules.min_silence_ms / 1000.0)))
    pre = max(0, int(round(sr * rules.pre_roll_ms / 1000.0)))
    post = max(0, int(round(sr * rules.post_roll_ms / 1000.0)))
    min_len = max(1, int(round(sr * rules.min_segment_ms / 1000.0)))
    max_len = max(min_len, int(round(sr * rules.max_segment_ms / 1000.0)))

    def add(raw_start: int, raw_end: int) -> None:
        start = min(max(raw_start, 0), n)
        end = min(max(raw_end, start), n)
        if end - start < min_len:
            return
        while end - start > max_len:
            chunk_end = start + max_len
            rms_db = _lin_to_db(_rms(b, start, chunk_end - start))
            if not rules.remove_low_rms or rms_db >= rules.min_rms_db:
                segments.append(SegmentRegion(
                    start, chunk_end, rms_db,
                    _lin_to_db(_peak(b, start, chunk_end - start))))
            start = chunk_end
        if end - start >= min_len:
            rms_db = _lin_to_db(_rms(b, start, end - start))
            if not rules.remove_low_rms or rms_db >= rules.min_rms_db:
                segments.append(SegmentRegion(
                    start, end, rms_db,
                    _lin_to_db(_peak(b, start, end - start))))

    first_sound = int(np.argmax(silent == 0)) if (silent == 0).any() else n
    if first_sound >= n:
        return segments
    seg_start = max(0, first_sound - pre)
    i = first_sound
    while i < n:
        if not silent[i]:
            i += 1
            continue
        j = i
        while j < n and silent[j]:
            j += 1
        if j - i >= min_sil:
            run = env[i:j]
            cut = i + int(np.argmin(run)) if run.size else (i + j) // 2
            # hard boundary: neither roll may cross the quietest cut
            cut_cap = max(seg_start, cut)
            seg_end = min(max(i + post, seg_start), cut_cap)
            add(seg_start, seg_end)
            nxt = j
            while nxt < n and silent[nxt]:
                nxt += 1
            seg_start = max(cut, nxt - pre)
            i = nxt
            continue
        i = j
    add(seg_start, n)

    if not segments and _rms(b) > 0.0:
        rms_db = _lin_to_db(_rms(b))
        if not rules.remove_low_rms or rms_db >= rules.min_rms_db:
            segments.append(SegmentRegion(0, n, rms_db, _lin_to_db(_peak(b))))
    return segments


def _segments_for_input(rules: ImportRules, index: int, b: np.ndarray,
                        sr: float) -> List[SegmentRegion]:
    manual = rules.manual_segments_by_input
    if 0 <= index < len(manual) and manual[index]:
        return manual[index]
    return detect_segments(b, sr, rules)


# ---------------------------------------------------------------------------
# transforms


def apply_edge_fades(b: np.ndarray, sr: float, fade_ms: float) -> np.ndarray:
    n = b.shape[1]
    fade = min(max(int(round(sr * fade_ms / 1000.0)), 0), n // 2)
    if fade <= 1:
        return b
    out = b.copy()
    g_in = (np.arange(fade) / fade).astype(b.dtype)
    out[:, :fade] *= g_in
    out[:, n - fade:] *= g_in[::-1]
    return out


def convert_channels(b: np.ndarray, target: int) -> np.ndarray:
    target = min(max(target, 1), 32)
    src = b.shape[0]
    if src == target:
        return b
    if src == 0:
        return np.zeros((target, b.shape[1]), dtype=b.dtype)
    if target == 1:
        return np.mean(b, axis=0, keepdims=True).astype(b.dtype)
    if src == 1:
        return np.broadcast_to(b, (target, b.shape[1])).copy()
    idx = np.minimum(np.arange(target), src - 1)
    return b[idx].copy()


def resample_linear(b: np.ndarray, src_rate: float, dst_rate: float
                    ) -> np.ndarray:
    if src_rate <= 0 or dst_rate <= 0 or abs(src_rate - dst_rate) < 1e-6:
        return b
    n = b.shape[1]
    out_n = int(round(n * dst_rate / src_rate))
    pos = np.arange(out_n) * (src_rate / dst_rate)
    i0 = np.minimum(pos.astype(np.int64), n - 1)
    i1 = np.minimum(i0 + 1, n - 1)
    frac = (pos - i0).astype(b.dtype)
    return b[:, i0] + (b[:, i1] - b[:, i0]) * frac


def process_by_rules(b: np.ndarray, sr: float, rules: ImportRules
                     ) -> np.ndarray:
    """ref: processBufferByRules, ZAAudioImportRecipe.h:1015-1058."""
    if b.shape[1] == 0:
        return b
    if rules.strip_internal_silence:
        segs = detect_segments(b, sr, rules)
        parts = [b[:, s.start:s.end] for s in segs if s.enabled and s.length]
        out = (np.concatenate(parts, axis=1) if parts
               else np.zeros((b.shape[0], 0), dtype=b.dtype))
        out = apply_edge_fades(out, sr, rules.edge_fade_ms)
    elif rules.trim_edges:
        segs = detect_segments(b, sr, rules)
        if segs:
            out = b[:, segs[0].start:segs[-1].end].copy()
            out = apply_edge_fades(out, sr, rules.edge_fade_ms)
        else:
            out = b
    else:
        out = b
    if rules.normalize_clips_rms and out.size:
        r = _rms(out)
        if r > 1e-9:
            out = out * np.float32(_db_to_lin(rules.clip_target_rms_db) / r)
    return out


def append_with_transition(dest: Optional[np.ndarray], clip: np.ndarray,
                           sr: float, rules: ImportRules) -> np.ndarray:
    """Gap or linear crossfade append (ref: appendBuffer,
    ZAAudioImportRecipe.h:1307-1357; crossfade only when gap == 0)."""
    if clip.shape[1] == 0:
        return dest if dest is not None else clip
    if dest is None or dest.shape[1] == 0:
        return clip.copy()
    gap = max(0, int(round(sr * rules.gap_ms / 1000.0)))
    cross = 0 if gap > 0 else max(0, int(round(sr * rules.crossfade_ms
                                               / 1000.0)))
    overlap = min(cross, dest.shape[1], clip.shape[1])
    old_n = dest.shape[1]
    new_n = old_n + gap + clip.shape[1] - overlap
    chs = dest.shape[0]
    out = np.zeros((chs, new_n), dtype=np.float32)
    out[:, :old_n] = dest
    c = min(chs, clip.shape[0])
    if overlap:
        t = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1.0)
        region = slice(old_n - overlap, old_n)
        out[:c, region] = out[:c, region] * (1.0 - t) + clip[:c, :overlap] * t
    start = old_n + gap - overlap
    out[:c, start + overlap:start + clip.shape[1]] += clip[:c, overlap:]
    return out


# ---------------------------------------------------------------------------
# features (duplicate rejection / novelty ordering)


def _goertzel_power(x: np.ndarray, nf: np.ndarray) -> np.ndarray:
    """Batched Goertzel |X(f)|^2 for normalized frequencies nf (vectorized
    over bands via the complex recurrence as a filter; numerically the
    classic two-pole form)."""
    n = len(x)
    w = 2.0 * np.pi * nf
    coeff = 2.0 * np.cos(w)
    s1 = np.zeros_like(coeff)
    s2 = np.zeros_like(coeff)
    for v in x.astype(np.float64):
        s0 = v + coeff * s1 - s2
        s2 = s1
        s1 = s0
    return s1 * s1 + s2 * s2 - coeff * s1 * s2


def analyse_features(b: np.ndarray, sr: float) -> Dict[str, object]:
    """ref: analyseAudioFeatures, ZAAudioImportRecipe.h:1209-1274 —
    rms/peak dB, zero-crossing rate, 16 half-octave Goertzel bands from
    60 Hz, frame-differenced spectral flux, novelty = flux + 0.1*zcr."""
    f: Dict[str, object] = {"rms_db": _lin_to_db(_rms(b)),
                            "peak_db": _lin_to_db(_peak(b)),
                            "spectral_flux": 0.0, "novelty": 0.0,
                            "zcr": 0.0, "bands": np.zeros(16)}
    n = b.shape[1]
    if n == 0 or b.shape[0] == 0:
        return f
    x = np.mean(b, axis=0, dtype=np.float64)
    neg = x < 0.0
    zc = int(np.count_nonzero(neg[1:] != neg[:-1]))
    f["zcr"] = zc / (n - 1) if n > 1 else 0.0

    frame = min(max(n, 256), 4096)
    hop = max(128, frame // 2)
    hz = 60.0 * np.power(2.0, np.arange(16) * 0.5)
    nf = np.clip(hz / max(sr, 1.0), 0.0001, 0.49)
    bands = np.zeros(16)
    prev = None
    flux_sum = 0.0
    count = 0
    for start in range(0, n - frame + 1, hop):
        seg = x[start:start + frame]
        cur = np.sqrt(_goertzel_power(seg, nf) / frame)
        bands += cur
        if prev is not None:
            local = np.maximum(0.0, cur - prev).sum()
            denom = 1e-12 + (cur + prev).sum()
            flux_sum += local / denom
        prev = cur
        count += 1
    if count:
        f["bands"] = bands / count
        f["spectral_flux"] = flux_sum / max(1, count - 1)
        f["novelty"] = f["spectral_flux"] + 0.1 * f["zcr"]
    return f


def cosine_similarity(a: Dict[str, object], b: Dict[str, object]) -> float:
    va = np.concatenate([[_db_to_lin(a["rms_db"]), _db_to_lin(a["peak_db"]),
                          a["spectral_flux"], a["zcr"]], a["bands"]])
    vb = np.concatenate([[_db_to_lin(b["rms_db"]), _db_to_lin(b["peak_db"]),
                          b["spectral_flux"], b["zcr"]], b["bands"]])
    na = float(va @ va)
    nb = float(vb @ vb)
    if na <= 1e-20 or nb <= 1e-20:
        return 0.0
    return float(va @ vb) / np.sqrt(na * nb)


# ---------------------------------------------------------------------------
# fingerprints / seeds


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _fnv1a64(data: bytes, h: int = _FNV_OFFSET) -> int:
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def fingerprint_for_file(path: str) -> SourceFingerprint:
    p = Path(path)
    try:
        st = p.stat()
        size = st.st_size
        mtime = int(st.st_mtime * 1000)
        with open(p, "rb") as fh:
            head = fh.read(4096)
        quick = _fnv1a64(head)
    except OSError:
        size, mtime, quick = 0, 0, 0
    return SourceFingerprint(str(p), size, mtime, quick)


def deterministic_seed(fingerprints: Sequence[SourceFingerprint],
                       action: ImportAction) -> int:
    """32-bit fold of FNV over fingerprints; never 0 (ref:
    deterministicSeedForImport, ZAAudioImportRecipe.h:1425-1448)."""
    h = _fnv1a64(int(action).to_bytes(4, "little"))
    for fp in fingerprints:
        h = _fnv1a64(fp.path.encode("utf-8"), h)
        h = _fnv1a64(fp.size_bytes.to_bytes(8, "little", signed=True), h)
        h = _fnv1a64(fp.modified_utc_ms.to_bytes(8, "little", signed=True), h)
        h = _fnv1a64(fp.quick_hash.to_bytes(8, "little"), h)
    folded = (h ^ (h >> 32)) & 0xFFFFFFFF
    return folded if folded else 0x5EED1234


# ---------------------------------------------------------------------------
# render


def _read_source(src, target_channels: int, target_rate: float
                 ) -> Optional[AudioClip]:
    """src: path to a wav, or (audio [ch, n], rate, name) tuple."""
    if isinstance(src, tuple):
        audio, rate, name = src
        audio = np.asarray(audio, dtype=np.float32)
    else:
        from . import wavio

        try:
            audio, rate = wavio.read_wav(src)
        except Exception:
            return None
        audio = np.asarray(audio, dtype=np.float32)
        name = Path(str(src)).stem
    if audio.ndim == 1:
        audio = audio[None, :]
    if audio.shape[1] == 0:
        return None
    if target_channels > 0:
        audio = convert_channels(audio, target_channels)
    if target_rate > 0:
        audio = resample_linear(audio, rate, target_rate)
        rate = target_rate
    return AudioClip(np.ascontiguousarray(audio, np.float32), float(rate),
                     str(name))


def render_import(sources: Sequence, action: ImportAction,
                  rules: Optional[ImportRules] = None) -> RenderResult:
    """Run an import action over sources (paths or (audio, rate, name)
    tuples); deterministic given the recipe (ref: renderImportAction,
    ZAAudioImportRecipe.h:1504-1720)."""
    rules = rules if rules is not None else default_rules_for_action(action)
    result = RenderResult()
    if not sources:
        result.message = "No supported audio sources were provided."
        return result

    fps = [fingerprint_for_file(s) if not isinstance(s, tuple)
           else SourceFingerprint(str(s[2]), int(np.asarray(s[0]).size), 0,
                                  _fnv1a64(np.ascontiguousarray(
                                      s[0], np.float32).tobytes()[:4096]))
           for s in sources]
    if rules.random_seed == 0:
        rules.random_seed = deterministic_seed(fps, action)
    result.recipe = ImportRecipe(action=action, inputs=fps, rules=rules,
                                 seed=rules.random_seed,
                                 display_name="File Import Recipe")
    result.files = [fp.path for fp in fps]

    if action == ImportAction.LOAD_SEPARATE:
        result.ok = True
        result.message = "Loaded source files."
        return result

    tch = rules.output_channels if rules.output_channels > 0 else 2
    trate = rules.output_sample_rate

    def read(i):
        if i in rules.disabled_input_indices:
            return None
        return _read_source(sources[i], tch, trate)

    if trate <= 0:
        first = _read_source(sources[0], 0, 0.0)
        trate = first.sample_rate if first else 48000.0

    if action == ImportAction.APPEND_RAW_AS_SINGLE:
        raw = ImportRules(**{**asdict(rules),
                             "trim_edges": False,
                             "strip_internal_silence": False,
                             "remove_low_rms": False,
                             "reject_near_duplicates": False,
                             "prefer_novel_samples": False,
                             "crossfade_ms": 0.0, "gap_ms": 0.0,
                             "manual_segments_by_input": []})
        appended = None
        for i in range(len(sources)):
            clip = read(i)
            if clip is None:
                continue
            appended = append_with_transition(appended, clip.audio, trate,
                                              raw)
        if appended is None or appended.shape[1] == 0:
            result.message = "Raw append produced no audio."
            return result
        name = (Path(result.files[0]).stem if len(sources) == 1
                else "RawAppend")
        result.rendered.append(AudioClip(appended, trate, name))
        result.ok = True
        result.message = "Raw append rendered in memory."
        return result

    if action == ImportAction.MODIFY_EXISTING:
        idx = 1
        for i in range(len(sources)):
            clip = read(i)
            if clip is None:
                continue
            out = process_by_rules(clip.audio, clip.sample_rate, rules)
            if out.shape[1] == 0:
                continue
            feats = analyse_features(out, clip.sample_rate)
            if rules.remove_low_rms and feats["rms_db"] < rules.min_rms_db:
                continue
            result.rendered.append(AudioClip(
                out, clip.sample_rate, f"{idx:03d}_{clip.name}_modified"))
            idx += 1
        result.ok = bool(result.rendered)
        result.message = ("Modified files rendered in memory." if result.ok
                          else "Modify Existing produced no non-silent clips.")
        return result

    if action == ImportAction.SEGMENT_LONG_FILE:
        idx = 1
        for i in range(len(sources)):
            clip = read(i)
            if clip is None:
                continue
            for s in _segments_for_input(rules, i, clip.audio,
                                         clip.sample_rate):
                if not s.enabled or s.length <= 0:
                    continue
                part = apply_edge_fades(
                    clip.audio[:, s.start:s.end].copy(), clip.sample_rate,
                    rules.edge_fade_ms)
                result.rendered.append(AudioClip(
                    part, clip.sample_rate, f"{clip.name}_part{idx:03d}"))
                idx += 1
        result.ok = bool(result.rendered)
        result.message = ("Segments rendered in memory." if result.ok
                          else "No segments detected.")
        return result

    # mega-texture flows: gather clips, prune, order, append
    clips: List[Tuple[np.ndarray, float, str, Dict]] = []

    def passes(feats) -> bool:
        if rules.remove_low_rms and feats["rms_db"] < rules.min_rms_db:
            return False
        if rules.prefer_novel_samples \
                and feats["spectral_flux"] < rules.min_spectral_flux:
            return False
        if rules.reject_near_duplicates:
            for _a, _r, _n, other in clips:
                if cosine_similarity(feats, other) >= \
                        rules.duplicate_similarity_threshold:
                    return False
        return True

    if action == ImportAction.SEGMENT_THEN_MEGA_TEXTURE:
        for i in range(len(sources)):
            clip = read(i)
            if clip is None:
                continue
            part_i = 1
            for s in _segments_for_input(rules, i, clip.audio,
                                         clip.sample_rate):
                if not s.enabled or s.length <= 0:
                    continue
                part = apply_edge_fades(
                    clip.audio[:, s.start:s.end].copy(), clip.sample_rate,
                    rules.edge_fade_ms)
                feats = analyse_features(part, clip.sample_rate)
                if not passes(feats):
                    continue
                clips.append((part, clip.sample_rate,
                              f"{clip.name}_part{part_i:03d}", feats))
                part_i += 1
    else:  # BUILD_MEGA_TEXTURE
        for i in range(len(sources)):
            clip = read(i)
            if clip is None:
                continue
            out = process_by_rules(clip.audio, clip.sample_rate, rules)
            if out.shape[1] == 0:
                continue
            feats = analyse_features(out, clip.sample_rate)
            if not passes(feats):
                continue
            clips.append((out, clip.sample_rate, clip.name, feats))

    if rules.prefer_novel_samples:
        clips.sort(key=lambda c: -c[3]["novelty"])
    if rules.randomize:
        rng = np.random.RandomState(rules.random_seed or 0x5EED1234)
        rng.shuffle(clips)

    if not clips:
        result.message = "Mega Texture produced no clips after pruning."
        return result
    sr = clips[0][1] if clips[0][1] > 0 else 48000.0
    mega = None
    for audio, _r, _n, _f in clips:
        mega = append_with_transition(mega, audio, sr, rules)
    if rules.normalize_final_rms and mega is not None and mega.size:
        r = _rms(mega)
        if r > 1e-9:
            mega = mega * np.float32(_db_to_lin(rules.final_target_rms_db)
                                     / r)
    result.rendered.append(AudioClip(mega, sr, "MegaTexture"))
    result.ok = True
    result.message = "Mega texture rendered in memory."
    return result


def replay_recipe(recipe: ImportRecipe,
                  sources: Optional[Sequence] = None) -> RenderResult:
    """Re-render a persisted recipe deterministically; sources default to
    the fingerprinted paths."""
    srcs = sources if sources is not None else [fp.path
                                                for fp in recipe.inputs]
    rules = ImportRules(**{**asdict(recipe.rules)})
    rules.manual_segments_by_input = recipe.rules.manual_segments_by_input
    rules.random_seed = recipe.seed
    return render_import(srcs, recipe.action, rules)


def feed_services(result: RenderResult, file_service=None,
                  sample_pool=None, slot: int = 0) -> int:
    """Publish in-memory renders to the engine services (file slots and/or
    sample pool — the reference feeds both from one import, ref:
    makeCachedFileDataFromImportAudio / makeSamplePoolSourcesFromImportAudio,
    JSFXJuceProcessor.cpp:5834-5890); returns the entry count."""
    count = 0
    for clip in result.rendered:
        if file_service is not None:
            file_service.load_slot(slot, clip.audio, srate=clip.sample_rate,
                                   name=clip.name)
        count += 1
    if sample_pool is not None and result.rendered:
        from .services import LoadedAudio

        sample_pool.commit_sources([
            LoadedAudio(np.asarray(c.audio, np.float64), c.sample_rate,
                        c.name) for c in result.rendered])
    return count
