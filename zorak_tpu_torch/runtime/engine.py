"""Offline render engine: the framework's replacement for the DAW host.

Counterpart of zorak_tpu/runtime/engine.py.  Drives a plugin over audio
the way the reference host does (ref: src/JSFXJuceProcessor.cpp:3239-3772):
slider push before @init, @init, @slider, then block processing — but the
audio path executes on the GPU through the vectorizing specializer when
the plugin qualifies (engine "torch-vector"), with the Python golden
shadow as the always-available reference.  A plugin whose @block is
audio-coupled renders as "torch-vector" too, its @block on the device
between sample segments (K10), with host MIDI staged into per-block planes
for its midirecv; its gmem is the heap's window, and a lone instance's
bus calls fold inert on the device, as the golden's host answers them.
What the vectorizer rejects renders through the sequential device
executor (engine "torch-devexec": the whole plugin in one kernel, K11), as
the reference's engine orders them, gmem and a lone instance's bus
included (the heap row's window, the calls folded inert); what that also
rejects (the bus calls and host services the reference's device sections
refuse too) renders through the golden (engine "cpu-shadow").  A plugin of an
instance made with `host=EngineHost()` (runtime/services.py) reads its
file slots and sample pool on the device: a load from a file slot in an
audio-coupled @block folds into K10's text, and a loaded sample pool is
gathered by K11 (the vectorizer rejects traced pool reads), each from
tables staged once a render.  Instances that share gmem or the bus render
together in a graph (runtime/graph.py).  `RenderResult.engine` and
`PluginInstance.spec_error` (both refusals) say which ran and why.
`device=None` means CUDA and raises without a GPU; only `device="cpu"`
runs the device engines on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ir.program import PluginProgram
from ..lowering import SpecializeError, specialize_sample_kernel
from ..verify.nulltest import make_initialized_shadow

DEFAULT_SEGMENT_LEN = 1 << 17


def _audio_stats(y_dev: torch.Tensor):
    """On-device peak/rms/finite-count (download only 3 scalars)."""
    return torch.stack([y_dev.abs().max(), (y_dev * y_dev).mean().sqrt(),
                        torch.isfinite(y_dev).sum().to(y_dev.dtype)]).tolist()


@dataclass
class RenderResult:
    audio: np.ndarray                  # float32 [channels, samples]
    srate: float
    engine: str              # "torch-vector" | "torch-devexec" | "cpu-shadow"
    wall_seconds: float
    realtime_factor: float
    state: object = None               # final ShadowState (parity/debug)
    details: Dict = field(default_factory=dict)


def upsample_linear(x: torch.Tensor, factor: int,
                    prev_tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear-interpolation upsample, matching the reference's deliberately
    simple oversampling path (ref: src/JSFXJuceProcessor.cpp:8742).
    x [ch, n] -> [ch, n * factor], in x's dtype, the ramps in f64."""
    if factor <= 1:
        return x
    ch, n = x.shape
    prev = prev_tail if prev_tail is not None else x[:, :1]
    ext = torch.cat([prev, x], dim=1).to(torch.float64)  # [ch, n+1]
    # causal: each group of `factor` outputs ramps prev -> current and LANDS
    # on the current host sample, so down(up(x)) preserves sample positions
    t = (torch.arange(1, factor + 1, dtype=torch.float64, device=x.device)
         / factor)[None, None, :]
    segs = ext[:, :-1, None] * (1.0 - t) + ext[:, 1:, None] * t
    return segs.reshape(ch, n * factor).to(x.dtype)


def downsample_box(y: torch.Tensor, factor: int) -> torch.Tensor:
    """Per-host-sample box average (ref: src/JSFXJuceProcessor.cpp:8756)."""
    if factor <= 1:
        return y
    ch, n = y.shape
    frames = n // factor
    return y[:, : frames * factor].reshape(ch, frames, factor).mean(
        dim=2, dtype=torch.float64).to(y.dtype)


class PluginInstance:
    """One initialized plugin configuration bound to an engine.

    Host-level features mirrored from the reference processor
    (ref: src/JSFXJuceProcessor.cpp):
    * oversampling 1/2/4/8x — engine runs at srate*factor with linear
      upsample / box-average downsample, plugin initialized at the
      engine rate (:3102-3124, 8742-8791),
    * smart idle — optionally skip DSP on silent input blocks, waking on
      input above threshold or MIDI (:6147-6154, 3681-3731),
    * MIDI event streams per render, offsets in samples,
    * state save/load — sliders + string sliders + idle mode as a dict
      (:3777-3960's parameter/FILES persistence, offline flavor).

    A file loaded after the instance is built (`load_file`) reaches the
    host's slots, as the reference's does; a device program built before
    keeps the data it folded until it is built again (`load_state`).
    """

    IDLE_MODES = ("auto", "input_driven", "event_driven", "free_running",
                  "always_awake")

    def __init__(self, program: PluginProgram, srate: float = 48000.0,
                 sliders: Optional[Dict[int, float]] = None,
                 string_sliders: Optional[Dict[int, str]] = None,
                 segment_len: int = DEFAULT_SEGMENT_LEN,
                 prefer: str = "auto", oversample: int = 1,
                 smart_idle: str = "auto",
                 idle_threshold: float = 1e-6,
                 idle_hold_ms: float = 250.0,
                 host=None, device=None):
        if oversample not in (1, 2, 4, 8):
            raise ValueError("oversample factor must be 1, 2, 4, or 8")
        if smart_idle not in self.IDLE_MODES:
            raise ValueError(f"smart_idle must be one of {self.IDLE_MODES}")
        self.device = resolve_device(device)
        self.program = program
        self.srate = float(srate)
        self.oversample = int(oversample)
        self.engine_rate = self.srate * self.oversample
        self.sliders = dict(sliders or {})
        self.string_sliders = dict(string_sliders or {})
        self.segment_len = segment_len
        self.smart_idle = smart_idle
        self.idle_threshold = float(idle_threshold)
        self.idle_hold_ms = float(idle_hold_ms)
        self.nch = max(1, program.io_channels["process"])
        self.recent_files: List[str] = []
        self.import_recipes: List[str] = []   # ImportRecipe JSON blobs
        self.shadow = make_initialized_shadow(
            program, self.engine_rate, self.sliders, self.string_sliders,
            host=host)
        self._up_tail: Optional[np.ndarray] = None
        self.kernel = None
        self.engine = "cpu-shadow"
        self.spec_error: Optional[str] = None
        if prefer in ("auto", "tpu", "vector", "devexec"):
            self._specialize(prefer)

    def _specialize(self, prefer: str) -> None:
        """The reference's order (zorak_tpu/runtime/engine.py:128-150):
        the vectorizer, then the sequential device executor, then the
        golden, which renders what both reject; spec_error keeps both
        reasons, in every RenderResult's details too.  prefer="vector"
        raises where the vectorizer refuses, prefer="devexec" skips it
        and raises where devexec refuses, prefer="tpu" (the reference's
        name for the device engines) raises only where both refuse."""
        from ..lowering.devexec import DeviceExecKernel

        self.kernel, self.engine, self.spec_error = None, "cpu-shadow", None
        try:
            if prefer == "devexec":
                raise SpecializeError("devexec requested")
            self.kernel = specialize_sample_kernel(
                self.program, self.shadow.state, self.nch,
                segment_len=self.segment_len, block_size=512,
                device=self.device)
            self.engine = "torch-vector"
            return
        except SpecializeError as exc:
            self.spec_error = str(exc)
            if prefer == "vector":
                raise
        try:
            self.kernel = DeviceExecKernel(
                self.program, self.shadow.state, self.nch,
                segment_len=self.segment_len, block_size=512,
                device=self.device)
            self.engine = "torch-devexec"
        except SpecializeError as exc:
            self.spec_error = f"{self.spec_error}; devexec: {exc}"
            if prefer in ("devexec", "tpu"):
                raise SpecializeError(self.spec_error) from None

    def _upsample(self, x: np.ndarray) -> np.ndarray:
        """Host audio at srate -> engine rate (the instance's factor)."""
        if self.oversample <= 1:
            return x
        tail = None if self._up_tail is None else torch.from_numpy(
            self._up_tail)
        return upsample_linear(torch.from_numpy(x), self.oversample,
                               tail).numpy()

    # -- smart idle ----------------------------------------------------------

    def infer_idle_mode(self) -> str:
        """Topology inference for smart_idle='auto'
        (ref: JSFXJuceProcessor.cpp:6374-6392 inferSmartIdleModeFromTopology):
        audio inputs -> input_driven; MIDI/file wake sources ->
        event_driven; outputs only -> free_running; else always_awake."""
        has_sample = bool(self.program.sections.get("sample"))
        if has_sample and self.nch > 0:
            return "input_driven"
        src = getattr(self.program, "source", "") or ""
        has_midi = "midirecv" in src
        has_files = bool(getattr(self.shadow.state.host, "files", None)
                         and self.shadow.state.host.files.slots)
        if has_midi or has_files:
            return "event_driven"
        if has_sample:
            return "free_running"
        return "always_awake"

    @property
    def effective_idle_mode(self) -> str:
        mode = self.smart_idle
        if mode == "auto":
            mode = self.infer_idle_mode()
        # runtime override var, like the reference's za_idle_mode hook
        # (ref: JSFXJuceProcessor.cpp:6452-6453)
        ov = self.shadow.state.V.get("za_idle_mode")
        if ov is not None:
            idx = int(ov)
            if 0 <= idx < len(self.IDLE_MODES):
                mode = self.IDLE_MODES[idx]
                if mode == "auto":
                    mode = self.infer_idle_mode()
        return mode

    def _sleep_eligible(self, mode: str) -> bool:
        # (ref: JSFXJuceProcessor.cpp:6369-6372)
        if mode not in ("input_driven", "event_driven"):
            return False
        if float(self.shadow.state.V.get("za_keep_awake", 0.0)):
            return False
        return True

    # -- state persistence ---------------------------------------------------

    def save_state(self) -> Dict:
        """Serializable instance state: parameters + FILES (slot paths and
        selection) + import recipes + recents, the offline mirror of the
        reference's getStateInformation blob
        (ref: src/JSFXJuceProcessor.cpp:3777-3879)."""
        files = {}
        svc = getattr(self.shadow.state.host, "files", None)
        if svc is not None:
            for slot, entries in sorted(svc.slots.items()):
                paths = [e.path for e in entries if e.path]
                if paths:
                    files[int(slot)] = {"paths": paths}
        return {
            "sliders": {d.index0: self.shadow.state.sliders[d.index0]
                        for d in self.program.slider_decls if not d.is_string},
            "string_sliders": dict(self.string_sliders),
            "oversample": self.oversample,
            "smart_idle": self.smart_idle,
            "files": files,
            "import_recipes": list(self.import_recipes),
            "recent_files": list(self.recent_files[-10:]),  # kMaxRecentFiles
        }

    def load_state(self, blob: Dict) -> None:
        for idx0, val in (blob.get("sliders") or {}).items():
            self.shadow.state.sliders[int(idx0)] = float(val)
        self.smart_idle = blob.get("smart_idle", self.smart_idle)
        self.import_recipes = list(blob.get("import_recipes") or ())
        self.recent_files = list(blob.get("recent_files") or ())
        svc = getattr(self.shadow.state.host, "files", None)
        if svc is not None:
            for slot, entry in (blob.get("files") or {}).items():
                have = {e.path for e in svc.slots.get(int(slot), ())}
                for p in entry.get("paths", ()):
                    if p not in have and Path(p).exists():
                        svc.load_slot(int(slot), p)
                        self.note_recent_file(p)
        self.shadow.run_slider()
        if self.kernel is not None:
            # control state changed: respecialize against the new snapshot
            self._specialize("devexec" if self.engine == "torch-devexec"
                             else "auto")

    def note_recent_file(self, path: str) -> None:
        p = str(path)
        if p in self.recent_files:
            self.recent_files.remove(p)
        self.recent_files.append(p)
        del self.recent_files[:-10]

    def load_file(self, slot: int, source, srate: Optional[float] = None,
                  name: str = "") -> None:
        """Load audio into a file slot (and the recents list)."""
        svc = getattr(self.shadow.state.host, "files", None)
        if svc is None:
            raise RuntimeError("instance host has no file service")
        svc.load_slot(int(slot), source, srate=srate, name=name)
        if isinstance(source, (str, Path)):
            self.note_recent_file(str(source))

    MONITOR_MODES = ("compiled", "shadow", "delta")

    def render(self, x: np.ndarray, block_size: int = 512,
               fetch_audio: bool = True, sync_state: bool = True,
               midi=None, monitor: str = "compiled") -> RenderResult:
        """x: float32 [channels, samples] at self.srate.

        midi: optional list of (sample_offset, b1, b2, b3) at host rate.
        fetch_audio=False keeps the rendered audio on the device and
        returns on-device stats in details (peak/rms) instead — the fast
        path when the result feeds further device compute.

        monitor: correctness-monitor output selection (ref:
        src/JSFXCorrectnessCheck.h:1042 Compiled/Shadow/Delta) —
        "compiled" renders normally; "shadow" / "delta" ALSO run the
        golden executor on the same input+MIDI from the same starting
        state and return its audio / the compiled-minus-shadow delta,
        while the instance's go-forward state follows the compiled
        (primary) engine.
        """
        if monitor not in self.MONITOR_MODES:
            raise ValueError(f"monitor must be one of {self.MONITOR_MODES}")
        if monitor != "compiled":
            return self._render_monitor(x, block_size, midi, monitor)
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.shape[0] < self.nch:
            pad = np.zeros((self.nch - x.shape[0], x.shape[1]), dtype=np.float32)
            x = np.concatenate([x, pad], axis=0)
        elif x.shape[0] > self.nch:
            x = x[: self.nch]

        F = self.oversample
        host_n = x.shape[1]
        if F > 1:
            x_eng = self._upsample(x)
            self._up_tail = x[:, -1:].copy()
        else:
            x_eng = x

        kern_midi = None
        if midi and self.kernel is not None and self.kernel.accepts_midi:
            # scale host-rate offsets to the engine rate (the shadow loop
            # does the same per event)
            kern_midi = [(int(e[0]) * F, e[1], e[2], e[3]) for e in midi]
        mode = self.effective_idle_mode
        use_kernel = (self.kernel is not None
                      and (not midi or kern_midi is not None))
        if use_kernel and self._sleep_eligible(mode):
            return self._render_vector_gated(
                x, x_eng, kern_midi, mode, t_start=time.perf_counter(),
                fetch_audio=fetch_audio, sync_state=sync_state)
        if not use_kernel:
            return self._render_shadow(x, x_eng, block_size, midi, t_start=time.perf_counter())

        t0 = time.perf_counter()
        if True:
            y_dev, carry = self.kernel.render_device(x_eng, midi=kern_midi)
            if fetch_audio:
                y = downsample_box(y_dev, F).cpu().numpy()
            else:
                peak, rms, nfinite = _audio_stats(y_dev)
                wall = time.perf_counter() - t0
                if sync_state:
                    self.kernel.writeback(carry, self.shadow.state)
                audio_seconds = host_n / self.srate
                return RenderResult(
                    audio=None, srate=self.srate, engine=self.engine,
                    wall_seconds=wall,
                    realtime_factor=(audio_seconds / wall) if wall > 0 else float("inf"),
                    state=self.shadow.state,
                    details={"peak": peak, "rms": rms,
                             "all_finite": int(nfinite) == y_dev.numel(),
                             "audio_device": y_dev, **self._dispatch()})
            if sync_state:
                self.kernel.writeback(carry, self.shadow.state)
        wall = time.perf_counter() - t0

        audio_seconds = host_n / self.srate
        return RenderResult(
            audio=y, srate=self.srate, engine=self.engine, wall_seconds=wall,
            realtime_factor=(audio_seconds / wall) if wall > 0 else float("inf"),
            state=self.shadow.state,
            details={**({"spec_error": self.spec_error} if self.spec_error
                        else {}), **self._dispatch()},
        )

    def _dispatch(self) -> Dict:
        """How the kernel's last render ran its steps, where it says:
        {"dispatch": "graph"} (K5's captured steps replayed) or
        "eager: <why>" (`SpecializedSampleKernel.dispatch`)."""
        got = getattr(self.kernel, "dispatch", None)
        return {"dispatch": got} if got else {}

    def _render_monitor(self, x: np.ndarray, block_size: int, midi,
                        monitor: str) -> RenderResult:
        """Both engines render the same span from the same state; the
        RenderResult's audio is the shadow's output ("shadow") or the
        compiled-minus-shadow null ("delta"), f32-rounded like the
        harness.  Go-forward instance state (shadow state writeback,
        oversampling tail) follows the compiled path, matching the
        reference monitor, which taps signals without forking the
        session (ref: src/JSFXCorrectnessCheck.h:1042)."""
        t0 = time.perf_counter()
        st0 = self.shadow.state.clone()
        up0 = None if self._up_tail is None else self._up_tail.copy()
        rc = self.render(x, block_size=block_size, midi=midi)

        if self.kernel is None:
            # the compiled path IS the golden executor: identical output
            y_s = rc.audio
            delta = np.zeros_like(rc.audio)
        else:
            live_state, live_tail = self.shadow.state, self._up_tail
            self.shadow.state = st0
            self._up_tail = up0
            try:
                xx = np.ascontiguousarray(x, dtype=np.float32)
                if xx.shape[0] < self.nch:
                    pad = np.zeros((self.nch - xx.shape[0], xx.shape[1]),
                                   dtype=np.float32)
                    xx = np.concatenate([xx, pad], axis=0)
                elif xx.shape[0] > self.nch:
                    xx = xx[: self.nch]
                x_eng = self._upsample(xx)
                rs = self._render_shadow(xx, x_eng, block_size, midi,
                                         t_start=t0)
            finally:
                self.shadow.state = live_state
                self._up_tail = live_tail
            y_s = rs.audio
            delta = rc.audio.astype(np.float32) - y_s.astype(np.float32)

        audio = y_s if monitor == "shadow" else delta
        details = dict(rc.details)
        details["monitor"] = monitor
        details["max_delta"] = (float(np.max(np.abs(delta)))
                                if delta.size else 0.0)
        wall = time.perf_counter() - t0
        audio_seconds = x.shape[-1] / self.srate if x.size else 0.0
        return RenderResult(
            audio=audio, srate=self.srate, engine=rc.engine,
            wall_seconds=wall,
            realtime_factor=(audio_seconds / wall) if wall > 0
            else float("inf"),
            state=self.shadow.state, details=details)

    def _render_vector_gated(self, x_host: np.ndarray, x_eng: np.ndarray,
                             kern_midi, mode: str, t_start: float,
                             fetch_audio: bool = True,
                             sync_state: bool = True) -> RenderResult:
        """Sleep-eligible smart idle ON the vector path: awake spans render
        through the vector kernel with carry continuity (@block state frozen
        across sleeping gaps, like the reference skipping process calls);
        sleeping blocks emit silence.  Output-tail activity extends spans
        so decaying reverbs are not cut (ref: JSFXJuceProcessor.cpp:3742-
        3764 outputActive resetting the quiet window)."""
        kern = self.kernel
        B = kern.B
        T = x_eng.shape[1]
        nb = (T + B - 1) // B
        hold = max(1, int(round(self.idle_hold_ms / 1000.0
                                * self.engine_rate / B)))
        thr = self.idle_threshold

        wake = np.zeros(nb, dtype=bool)
        if mode == "input_driven":
            pad = np.zeros((x_eng.shape[0], nb * B - T), dtype=x_eng.dtype)
            blocks = np.abs(np.concatenate([x_eng, pad], axis=1)
                            .reshape(x_eng.shape[0], nb, B))
            wake |= blocks.max(axis=(0, 2)) > thr
        for ev in kern_midi or ():
            wake[min(nb - 1, int(ev[0]) // B)] = True

        awake = np.zeros(nb, dtype=bool)
        last_wake = -1  # the instance starts awake (quiet window empty)
        for b in range(nb):
            if wake[b]:
                last_wake = b
            awake[b] = (b - last_wake) <= hold

        y = np.zeros_like(x_eng)
        carry = None
        midi_out: List = []
        ev_all = sorted(kern_midi or [], key=lambda e: e[0])

        def render_span(b0: int, b1: int, carry):
            s0, s1 = b0 * B, min(b1 * B, T)
            span_midi = [(e[0] - s0, e[1], e[2], e[3])
                         for e in ev_all if s0 <= e[0] < s1] or None
            ys, carry = kern.render(x_eng[:, s0:s1], carry=carry,
                                    midi=span_midi)
            y[:, s0:s1] = ys
            for mo in kern.last_midi_out:
                # 4-tuple short events; 5-tuples carry sysex/buf payloads
                midi_out.append((s0 + mo[0],) + tuple(mo[1:]))
            return carry

        b = 0
        while b < nb:
            if not awake[b]:
                b += 1
                continue
            e = b
            while e < nb and awake[e]:
                e += 1
            carry = render_span(b, e, carry)
            # output-tail extension: keep rendering while the final block
            # is still audible and the next blocks would have slept
            while e < nb and not awake[e]:
                tail = y[:, max(0, min(e * B, T) - B):min(e * B, T)]
                if tail.size == 0 or np.abs(tail).max() <= thr:
                    break
                e2 = min(e + hold, nb)
                carry = render_span(e, e2, carry)
                awake[e:e2] = True
                e = e2
            b = e
        F = self.oversample
        if sync_state and carry is not None:
            kern.writeback(carry, self.shadow.state)
        y_host = downsample_box(torch.from_numpy(y), F).numpy() if F > 1 else y
        wall = time.perf_counter() - t_start
        audio_seconds = x_host.shape[1] / self.srate
        return RenderResult(
            audio=y_host if fetch_audio else None, srate=self.srate,
            engine=self.engine, wall_seconds=wall,
            realtime_factor=(audio_seconds / wall) if wall > 0
            else float("inf"),
            state=self.shadow.state,
            details={"idle_mode": mode,
                     "awake_blocks": int(awake.sum()), "blocks": nb,
                     "midi_out": [(e[0] // F,) + tuple(e[1:])
                                  for e in midi_out], **self._dispatch()})

    # -- shadow block loop (midi / smart idle / fallback) ---------------------

    def _render_shadow(self, x_host: np.ndarray, x_eng: np.ndarray,
                       block_size: int, midi, t_start: float) -> RenderResult:
        from ..shadow.state import MidiEvent

        F = self.oversample
        host_n = x_host.shape[1]
        total = x_eng.shape[1]
        y_eng = np.zeros_like(x_eng)
        st = self.shadow.state
        events = sorted(midi or [], key=lambda e: e[0])
        ev_i = 0
        midi_out = []
        asleep = False
        quiet_blocks = 0
        thr = self.idle_threshold
        bs = block_size * F
        mode = self.effective_idle_mode
        hold_blocks = max(1, int(round(self.idle_hold_ms / 1000.0
                                       * self.engine_rate / bs)))

        for start in range(0, total, bs):
            stop = min(start + bs, total)
            host_start = start // F
            host_stop = stop // F

            # inject MIDI whose host offsets land in this block
            st.midi_in = []
            st.midi_in_pos = 0
            woke_by_midi = False
            while ev_i < len(events) and events[ev_i][0] < host_stop:
                off, b1, b2, b3 = events[ev_i]
                st.midi_in.append(MidiEvent(
                    max(0, int(off) * F - start), int(b1), int(b2), int(b3)))
                ev_i += 1
                woke_by_midi = True

            block_in = x_eng[:, start:stop]
            if self._sleep_eligible(mode):
                # wake sources (ref: JSFXJuceProcessor.cpp:3693-3717):
                # input above threshold (input_driven), incoming MIDI
                loud = (mode == "input_driven"
                        and bool(np.any(np.abs(block_in) > thr)))
                if loud or woke_by_midi:
                    asleep = False
                    quiet_blocks = 0
                if asleep:
                    y_eng[:, start:stop] = 0.0  # cleared while asleep
                    continue

            self.shadow.process_block(block_in, y_eng[:, start:stop])
            for ev in st.midi_out:
                et = (host_start + ev.offset // F, ev.b1, ev.b2, ev.b3)
                if ev.data is not None:
                    et += (tuple(int(v) & 0xFF for v in ev.data),)
                midi_out.append(et)
            st.midi_out = []

            if self._sleep_eligible(mode) and not (
                    woke_by_midi or (mode == "input_driven" and bool(
                        np.any(np.abs(block_in) > thr)))):
                # quiet window counts only while the OUTPUT is quiet too —
                # tails keep the instance awake (ref: :3742-3764)
                out_active = bool(
                    np.any(np.abs(y_eng[:, start:stop]) > thr))
                if out_active:
                    quiet_blocks = 0
                else:
                    quiet_blocks += 1
                    if quiet_blocks > hold_blocks:
                        asleep = True

        y = downsample_box(torch.from_numpy(y_eng), F).numpy() if F > 1 \
            else y_eng
        wall = time.perf_counter() - t_start
        audio_seconds = host_n / self.srate
        return RenderResult(
            audio=y, srate=self.srate, engine="cpu-shadow", wall_seconds=wall,
            realtime_factor=(audio_seconds / wall) if wall > 0 else float("inf"),
            state=st,
            details={"midi_out": midi_out,
                     **({"spec_error": self.spec_error} if self.spec_error else {})},
        )


def render_file(program: PluginProgram, in_path: str | Path,
                out_path: Optional[str | Path] = None,
                sliders: Optional[Dict[int, float]] = None,
                prefer: str = "auto", device=None) -> RenderResult:
    from . import wavio

    x, rate = wavio.read_wav(in_path)
    inst = PluginInstance(program, srate=float(rate), sliders=sliders,
                          prefer=prefer, device=device)
    result = inst.render(x)
    if out_path is not None:
        wavio.write_wav(out_path, result.audio, int(rate))
    return result
