"""Engine host services: file slots + sample pool (+ comm via InstanceComm).

Offline analogs of the reference's async host services:

* File slots (ref: src/JSFXJuceProcessor.cpp:2559-2649, 8164): per-slot
  decoded audio as interleaved doubles with the legacy file_* cursor API
  (file_open/file_riff/file_var/file_mem/file_avail/...), multi-file
  slots with file_multi_count/select.  The offline engine loads slots
  synchronously before @init — the reference's atomic pending->active
  promotion exists to keep a realtime thread waitless, which an offline
  render does not need.
* Sample pool (ref: src/DspJsfxSamplePool.{h,cpp}): immutable generations
  of packed float32 banks with peak/rms/preview metadata; read/readInterp/
  read2 semantics matched to the reference (llround framing, channel
  clamp, zero out-of-range, read2's hard sample-boundary rule).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..comm import CommWorld, InstanceComm

SAMPLE_POOL_EMPTY = 0
SAMPLE_POOL_SCANNING = 1
SAMPLE_POOL_LOADING = 2
SAMPLE_POOL_READY = 3
SAMPLE_POOL_PARTIAL = 4
SAMPLE_POOL_FAILED = 5


@dataclass
class LoadedAudio:
    audio: np.ndarray          # [channels, frames] float64
    srate: float
    name: str = ""
    path: str = ""             # source path when loaded from disk (persisted
                               # in save_state, ref: JSFXJuceProcessor.cpp:3784)

    @property
    def frames(self) -> int:
        return self.audio.shape[1]

    @property
    def channels(self) -> int:
        return self.audio.shape[0]


@dataclass
class _OpenFile:
    slot: int
    files: List[LoadedAudio]
    selected: int = 0
    cursor: int = 0            # interleaved value cursor

    @property
    def current(self) -> Optional[LoadedAudio]:
        if 0 <= self.selected < len(self.files):
            return self.files[self.selected]
        return None


class FileSlotService:
    """Slot index -> list of decoded files (singular slots have one)."""

    def __init__(self) -> None:
        self.slots: Dict[int, List[LoadedAudio]] = {}
        self.open_handles: Dict[int, _OpenFile] = {}
        # handles are 1-based and reused LIFO (0 is reserved for
        # @serialize in REAPER JSFX; ref: JSFXJuceProcessor.cpp:4971-4989)
        self._next_handle = 1
        self._free_handles: List[int] = []

    def load_slot(self, index: int, source, srate: Optional[float] = None,
                  name: str = "") -> None:
        if isinstance(source, (str, Path)):
            from . import wavio

            audio, rate = wavio.read_wav(source)
            entry = LoadedAudio(np.asarray(audio, np.float64), float(rate),
                                name or Path(source).name, str(source))
        else:
            entry = LoadedAudio(np.asarray(source, np.float64),
                                float(srate or 48000.0), name)
        self.slots.setdefault(int(index), []).append(entry)

    def clear_slot(self, index: int) -> None:
        self.slots.pop(int(index), None)

    # -- legacy cursor API ---------------------------------------------------

    def open(self, slot: float) -> float:
        try:
            s = int(slot + 1.0e-5)
        except (ValueError, OverflowError):
            return -1.0
        files = self.slots.get(s)
        if not files:
            return -1.0
        if self._free_handles:
            h = self._free_handles.pop()
        else:
            h = self._next_handle
            self._next_handle += 1
        self.open_handles[h] = _OpenFile(s, files)
        return float(h)

    def _h(self, handle: float) -> Optional[_OpenFile]:
        try:
            return self.open_handles.get(int(handle))
        except (ValueError, OverflowError):
            return None

    def close(self, handle: float) -> float:
        try:
            h = int(handle)
        except (ValueError, OverflowError):
            return 0.0
        if self.open_handles.pop(h, None) is not None:
            self._free_handles.append(h)
        return 0.0

    def avail(self, handle: float) -> float:
        h = self._h(handle)
        if h is None or h.current is None:
            return 0.0
        total = h.current.frames * h.current.channels
        return float(max(0, total - h.cursor))

    def rewind(self, handle: float) -> float:
        h = self._h(handle)
        if h is not None:
            h.cursor = 0
        return 0.0

    def seek(self, handle: float, pos: float) -> float:
        h = self._h(handle)
        if h is not None:
            try:
                h.cursor = max(0, int(pos))
            except (ValueError, OverflowError):
                pass
        return 0.0

    def riff(self, handle: float) -> Optional[Tuple[float, float]]:
        h = self._h(handle)
        if h is None or h.current is None:
            return None
        return (float(h.current.channels), float(h.current.srate))

    def var_read(self, handle: float) -> Optional[Tuple[float, float]]:
        h = self._h(handle)
        if h is None or h.current is None:
            return None
        cur = h.current
        inter = cur.audio.T.reshape(-1)
        if h.cursor >= len(inter):
            return (0.0, 0.0)
        v = float(inter[h.cursor])
        h.cursor += 1
        return (1.0, v)

    def mem_read(self, st, handle: float, offset: float, length: float) -> float:
        h = self._h(handle)
        if h is None or h.current is None:
            return 0.0
        try:
            dst = max(0, int(offset + 1e-5))
            n = max(0, int(length))
        except (ValueError, OverflowError):
            return 0.0
        inter = h.current.audio.T.reshape(-1)
        n = min(n, max(0, len(inter) - h.cursor))
        if n:
            st.mem_ensure(dst + n)
            st.mem[dst:dst + n] = inter[h.cursor:h.cursor + n]
            h.cursor += n
        return float(n)

    def multi_count(self, handle: float) -> float:
        h = self._h(handle)
        return float(len(h.files)) if h is not None else 0.0

    def multi_select(self, handle: float, index: float) -> float:
        h = self._h(handle)
        if h is None:
            return 0.0
        try:
            i = int(index)
        except (ValueError, OverflowError):
            return 0.0
        if 0 <= i < len(h.files):
            h.selected = i
            h.cursor = 0
            return 1.0
        return 0.0


@dataclass
class PoolEntry:
    sample_id: int
    data: np.ndarray             # packed [frames, channels] float32
    srate: float
    name: str
    peak: float
    rms: float
    preview: np.ndarray          # [bins, 3] min/max/rms


@dataclass
class PoolGeneration:
    number: int
    entries: Dict[int, PoolEntry] = field(default_factory=dict)
    order: List[int] = field(default_factory=list)
    selected: int = 0            # sources requested (incl. skipped/failed)
    failed: int = 0              # per-generation failure/skip count

    def ram_mb(self) -> float:
        return sum(e.data.nbytes for e in self.entries.values()) / (1024.0 ** 2)


def _resample_linear(data: np.ndarray, src_rate: float,
                     target_rate: float) -> Tuple[np.ndarray, float]:
    """Linear resample [frames, ch] float32 to target_rate (ref
    DspJsfxSamplePool.cpp:34-108 shouldResampleToTarget /
    resampleInterleavedLinear): only when both rates > 1000 Hz and differ
    by > 1 Hz; dst frame f samples srcPos = f * src/target with clamped
    neighbour interpolation."""
    frames = data.shape[0]
    if (frames == 0 or not math.isfinite(src_rate)
            or not math.isfinite(target_rate)
            or src_rate <= 1000.0 or target_rate <= 1000.0
            or abs(src_rate - target_rate) <= 1.0):
        return data, src_rate
    ratio = target_rate / src_rate
    if not math.isfinite(ratio) or ratio <= 0.0:
        return data, src_rate
    dst = int(max(1.0, round(frames * ratio)))
    pos = np.arange(dst, dtype=np.float64) * (src_rate / target_rate)
    p0 = np.minimum(np.floor(pos), frames - 1).astype(np.int64)
    p1 = np.minimum(p0 + 1, frames - 1)
    frac = np.clip(pos - p0, 0.0, 1.0).astype(np.float32)[:, None]
    out = data[p0] + (data[p1] - data[p0]) * frac
    return np.ascontiguousarray(out, dtype=np.float32), \
        float(round(target_rate))


# modes (ref DspJsfxSamplePool.h:42-45)
SAMPLE_POOL_MODE_RESIDENT = 0
SAMPLE_POOL_MODE_BUDGETED = 1
SAMPLE_POOL_MODE_LAZY = 2
SAMPLE_POOL_MODE_STREAM = 3

PREVIEW_BINS_PER_SAMPLE = 256    # ref DspJsfxSamplePool.cpp:13


class SamplePoolService:
    """Offline equivalent of the reference's generation pipeline
    (ref DspJsfxSamplePool.cpp:473-800): budgeted skipping, linear
    resample to the engine rate, proportional preview bins, and
    generation publication.  Commits run synchronously by default (the
    deterministic offline-render contract); set `async_commits = True`
    for the reference's worker-thread publication (state polls
    LOADING -> READY/PARTIAL/FAILED)."""

    def __init__(self) -> None:
        self.mode = SAMPLE_POOL_MODE_RESIDENT
        self.budget_mb = 0.0
        self.target_srate = 0.0      # <= 0 keeps native source rates
        self.state = SAMPLE_POOL_EMPTY
        self.generation: Optional[PoolGeneration] = None
        self.gen_counter = 0
        self.failed = 0
        self.source_slot: Optional[int] = None
        self.async_commits = False
        self._worker = None

    # -- configuration (ref :165-195) -----------------------------------------

    def set_mode(self, mode: float) -> None:
        try:
            m = int(mode)
        except (ValueError, OverflowError):
            m = SAMPLE_POOL_MODE_RESIDENT
        if not (SAMPLE_POOL_MODE_RESIDENT <= m <= SAMPLE_POOL_MODE_STREAM):
            m = SAMPLE_POOL_MODE_RESIDENT
        self.mode = m

    def set_budget_mb(self, mb: float) -> None:
        self.budget_mb = mb if math.isfinite(mb) and mb > 0.0 else 0.0

    def set_target_srate(self, srate: float) -> None:
        self.target_srate = srate if math.isfinite(srate) \
            and srate > 1000.0 else 0.0

    # -- generation build (ref buildGeneration :493-750) ----------------------

    def _build_generation(self, sources: Sequence[LoadedAudio]) \
            -> PoolGeneration:
        self.gen_counter += 1
        gen = PoolGeneration(self.gen_counter)
        gen.selected = len(sources)
        budget_bytes = int(self.budget_mb * 1024.0 * 1024.0)
        budgeted = self.mode in (SAMPLE_POOL_MODE_BUDGETED,
                                 SAMPLE_POOL_MODE_LAZY,
                                 SAMPLE_POOL_MODE_STREAM) \
            and budget_bytes > 0
        used_bytes = 0
        for src in sources:
            data = np.ascontiguousarray(src.audio.T, dtype=np.float32)
            if data.shape[0] == 0 or data.shape[1] == 0:
                gen.failed += 1
                continue
            data, srate = _resample_linear(data, float(src.srate),
                                           self.target_srate)
            nbytes = data.shape[0] * data.shape[1] * 4
            # Budgeted/Lazy/Stream skip entries past the budget (ref :544)
            if budgeted and used_bytes + nbytes > budget_bytes:
                gen.failed += 1
                continue
            frames = data.shape[0]
            # proportional preview bins, <= 256 per sample (ref :110-150)
            bins = min(PREVIEW_BINS_PER_SAMPLE, max(1, frames))
            preview = np.zeros((bins, 3))
            mono = data.mean(axis=1, dtype=np.float64)
            for b in range(bins):
                start = (b * frames) // bins
                end = max(start + 1, ((b + 1) * frames) // bins)
                end = min(end, frames)
                seg = mono[start:end]
                if len(seg):
                    preview[b] = (float(seg.min()), float(seg.max()),
                                  float(np.sqrt(np.mean(seg ** 2))))
            sid = len(gen.entries) + 1   # kept entries only (ref :546)
            gen.entries[sid] = PoolEntry(
                sample_id=sid, data=data, srate=srate, name=src.name,
                peak=float(np.abs(data).max(initial=0.0)),
                rms=float(np.sqrt(np.mean(data.astype(np.float64) ** 2)))
                if data.size else 0.0,
                preview=preview)
            gen.order.append(sid)
            used_bytes += nbytes
        return gen

    def _publish(self, gen: PoolGeneration) -> None:
        """Final-state rules per ref publishGeneration :784-790."""
        self.generation = gen
        self.failed = gen.failed
        if not gen.entries:
            self.state = SAMPLE_POOL_FAILED if gen.selected > 0 \
                else SAMPLE_POOL_EMPTY
        elif gen.failed > 0 or len(gen.entries) < gen.selected:
            self.state = SAMPLE_POOL_PARTIAL
        else:
            self.state = SAMPLE_POOL_READY

    def commit_sources(self, sources: Sequence[LoadedAudio]) -> None:
        if self.async_commits:
            import threading

            self.state = SAMPLE_POOL_LOADING
            snap = list(sources)

            def work():
                self._publish(self._build_generation(snap))

            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()
            return
        self._publish(self._build_generation(sources))

    def wait_ready(self, timeout: Optional[float] = None) -> int:
        """Join an async commit; returns the published state."""
        if self._worker is not None:
            self._worker.join(timeout)
        return self.state

    # -- queries -------------------------------------------------------------

    def _entry(self, sample_id: float) -> Optional[PoolEntry]:
        gen = self.generation
        if gen is None:
            return None
        try:
            return gen.entries.get(int(sample_id))
        except (ValueError, OverflowError):
            return None

    def sample_id_at(self, index: float) -> float:
        gen = self.generation
        if gen is None:
            return 0.0
        try:
            i = int(index)
        except (ValueError, OverflowError):
            return 0.0
        return float(gen.order[i]) if 0 <= i < len(gen.order) else 0.0

    def read(self, sample_id: float, channel: float, frame: float) -> float:
        e = self._entry(sample_id)
        if e is None or e.data.shape[0] == 0 or e.data.shape[1] == 0:
            return 0.0
        if not math.isfinite(frame):
            frame = 0.0
        f = int(round(frame))  # llround semantics
        if f < 0 or f >= e.data.shape[0]:
            return 0.0
        try:
            c = int(channel)
        except (ValueError, OverflowError):
            c = 0
        c = min(max(c, 0), e.data.shape[1] - 1)
        return float(e.data[f, c])

    def read_interp(self, sample_id: float, channel: float, phase: float) -> float:
        if not math.isfinite(phase):
            phase = 0.0
        base = math.floor(phase)
        frac = phase - base
        x0 = self.read(sample_id, channel, base)
        x1 = self.read(sample_id, channel, base + 1.0)
        return x0 + (x1 - x0) * frac

    def read2(self, sample_id: float, phase: float, interp: bool):
        e = self._entry(sample_id)
        if e is None or e.data.shape[0] == 0 or e.data.shape[1] == 0:
            return None
        # hard sample-boundary rule (ref: DspJsfxSamplePool.cpp:412-440)
        if not math.isfinite(phase) or phase < 0.0 or phase > float(e.data.shape[0] - 1):
            return None
        rd = self.read_interp if interp else self.read
        l = rd(sample_id, 0.0, phase)
        r = rd(sample_id, 1.0, phase) if e.data.shape[1] >= 2 else l
        return (l, r)

    def preview_bins(self, sample_id: float) -> float:
        e = self._entry(sample_id)
        return float(len(e.preview)) if e is not None else 0.0

    def preview_read(self, sample_id: float, bin_idx: float):
        e = self._entry(sample_id)
        if e is None:
            return None
        try:
            b = int(bin_idx)
        except (ValueError, OverflowError):
            return None
        if 0 <= b < len(e.preview):
            return tuple(float(v) for v in e.preview[b])
        return None


class EngineHost(InstanceComm):
    """Full host: comm + gmem (InstanceComm) + file slots + sample pool."""

    def __init__(self, world: Optional[CommWorld] = None, name: str = ""):
        super().__init__(world or CommWorld(), name=name)
        self.files = FileSlotService()
        self.pool = SamplePoolService()
        self.track_name_text = ""

    # -- sample pool dispatch (names from the AOT surface) --------------------

    def sample_pool_call(self, st, fn: str, args: List[float]) -> float:
        p = self.pool
        if fn == "sample_pool_from_slot":
            slot = int(args[0]) if args else 0
            files = self.files.slots.get(slot, [])
            p.source_slot = slot
            # the host configures the pool for the current engine rate
            # before every commit (ref JSFXJuceProcessor.cpp:5239,5287)
            p.set_target_srate(float(getattr(st, "srate", 0.0) or 0.0))
            p.commit_sources(files)
            return 1.0 if files else 0.0
        if fn == "sample_pool_set_mode":
            p.set_mode(args[1] if len(args) > 1 else args[0])
            return 1.0
        if fn == "sample_pool_set_budget_mb":
            p.set_budget_mb(float(args[-1]) if args else 0.0)
            return 1.0
        if fn == "sample_pool_commit":
            if p.source_slot is not None:
                p.set_target_srate(float(getattr(st, "srate", 0.0) or 0.0))
                p.commit_sources(self.files.slots.get(p.source_slot, []))
            return 1.0
        if fn == "sample_pool_state":
            return float(p.state)
        if fn == "sample_pool_selected":
            return float(p.generation.selected if p.generation else 0)
        if fn == "sample_pool_loaded":
            return float(len(p.generation.entries) if p.generation else 0)
        if fn == "sample_pool_failed":
            return float(p.generation.failed if p.generation else 0)
        if fn == "sample_pool_ram_mb":
            return p.generation.ram_mb() if p.generation else 0.0
        if fn == "sample_pool_generation":
            return float(p.generation.number if p.generation else 0)
        if fn == "sample_get":
            return p.sample_id_at(args[1] if len(args) > 1 else 0.0)
        if fn == "sample_len":
            e = p._entry(args[1] if len(args) > 1 else 0.0)
            return float(e.data.shape[0]) if e else 0.0
        if fn == "sample_channels":
            e = p._entry(args[1] if len(args) > 1 else 0.0)
            return float(e.data.shape[1]) if e else 0.0
        if fn == "sample_srate":
            e = p._entry(args[1] if len(args) > 1 else 0.0)
            return float(e.srate) if e else 0.0
        if fn == "sample_peak":
            e = p._entry(args[1] if len(args) > 1 else 0.0)
            return e.peak if e else 0.0
        if fn == "sample_rms":
            e = p._entry(args[1] if len(args) > 1 else 0.0)
            return e.rms if e else 0.0
        if fn == "sample_preview_bins":
            return p.preview_bins(args[1] if len(args) > 1 else 0.0)
        if fn == "sample_read":
            return p.read(args[1], args[2], args[3]) if len(args) >= 4 else 0.0
        if fn == "sample_read_interp":
            return p.read_interp(args[1], args[2], args[3]) if len(args) >= 4 else 0.0
        if fn in ("sample_export_mem", "sample_export_mem2"):
            return self._export_mem(st, args, stereo=fn.endswith("2"))
        return 0.0

    def sample_read2(self, st, pool, sid, phase, interp: bool):
        return self.pool.read2(sid, phase, interp)

    def sample_preview_read(self, st, pool, sid, bin_idx):
        return self.pool.preview_read(sid, bin_idx)

    def sample_name(self, st, index, out_lv_write, maxlen) -> float:
        e = self.pool._entry(index)
        return 1.0 if e is not None else 0.0

    def _export_mem(self, st, args: List[float], stereo: bool) -> float:
        # sample_export_mem(pool, id, mem_dst, start_frame, count)
        if len(args) < 5:
            return 0.0
        sid, dst, start, count = args[1], args[2], args[3], args[4]
        e = self.pool._entry(sid)
        if e is None:
            return 0.0
        try:
            d = max(0, int(dst + 1e-5))
            s = max(0, int(start))
            n = max(0, int(count))
        except (ValueError, OverflowError):
            return 0.0
        n = min(n, max(0, e.data.shape[0] - s))
        if n <= 0:
            return 0.0
        if stereo and e.data.shape[1] >= 2:
            st.mem_ensure(d + 2 * n)
            st.mem[d:d + 2 * n] = e.data[s:s + n, :2].reshape(-1).astype(np.float64)
        else:
            st.mem_ensure(d + n)
            st.mem[d:d + n] = e.data[s:s + n, 0].astype(np.float64)
        return float(n)

    # -- legacy file API ------------------------------------------------------

    def file_call(self, st, fn: str, args: List[float]) -> float:
        f = self.files
        if fn in ("file_open", "file_open_multi"):
            return f.open(args[0] if args else -1.0)
        if fn == "file_close":
            return f.close(args[0])
        if fn == "file_rewind":
            return f.rewind(args[0])
        if fn == "file_seek":
            return f.seek(args[0], args[1])
        if fn == "file_avail":
            return f.avail(args[0])
        if fn == "file_text":
            return 0.0
        if fn == "file_mem":
            return f.mem_read(st, args[0], args[1], args[2])
        if fn == "file_multi_count":
            return f.multi_count(args[0])
        if fn == "file_multi_select":
            return f.multi_select(args[0], args[1])
        return 0.0

    def file_var_read(self, st, handle, *rest):
        return self.files.var_read(handle)

    def file_riff_read(self, st, handle, *rest):
        return self.files.riff(handle)

    # -- track names ----------------------------------------------------------

    def track_name(self, st):
        if not self.track_name_text:
            return (0.0, 0.0)
        return (1.0, self._intern(st, self.track_name_text))

    def track_name_available(self, st) -> float:
        return 1.0 if self.track_name_text else 0.0
