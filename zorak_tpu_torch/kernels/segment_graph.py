"""K5: one step of a render captured as a CUDA graph and replayed.

Counterpart of the reference's one-dispatch render: `_render_fn`
(zorak_tpu/lowering/specialize.py) reshapes the audio and runs one
`lax.scan` over the full segments and one over the remainder, the
coupled regime's `_coupled_run` is one `lax.scan` over blocks, and the hop
regime's `_hop_run` one over hops.  The port renders a segment (or a
coupled block: K10, then the block's segment; or a hop: its segment, then
K10) as a few dozen to a thousand small launches; here one step is
captured as a CUDA graph and then replayed, so a step costs the host a
handful of operations instead of one launch a kernel.

A step reads and writes only buffers of its own (`StepGraphs.static`):
the segment's f32 input, its control and draw rows (or the gated
regime's pool), the carry (svec, rings, and K10's view), and the output
segment.  Each buffer is a prefix of one storage a name, so a step of any
length reads the same addresses, and what the buffers hold is bounded by
the largest step a kernel has run, whatever lengths its renders take.

A step's captures are keyed by what shapes its program: the step's kind,
length, files, pool size and the host's cursors reduced as the program
uses them (`SpecializedSampleKernel._k5_key`); the key decides every
constant the capture bakes in.  A key seen for the first time runs the
program on the static buffers, uncaptured: a key that never comes back
costs the eager step.  The second time, the program runs on a side stream
(the warm-up PyTorch's notes on CUDA graphs ask for; it is the step
itself) and is then captured, and every later step of the key replays it.
The captures of one kernel share one memory pool: they never run at once,
and what outlives a step lives in the static buffers, never in the pool.

The plain version of a step is the same program run eagerly on the same
buffers, uncaptured: on CPU tensors that is what `step` does.  A capture
or replay that fails raises; nothing falls back to the eager step.

A replay calls no wrapper, so each capture records the launches its
program made (the `LAUNCHES` counters of K2, K3, K4 and K10, and the four
of K6 and K3b) and every replay adds them: the counters keep counting
launches on the card.
"""
from __future__ import annotations

import gc
import importlib
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

# Replays since the counter was last set (chip_smoke.py zeroes it before a
# path and reads it after).
LAUNCHES = 0

# The wrappers whose launch counters a capture records and a replay adds:
# a module's LAUNCHES, or `module.NAME` for a counter of another name (the
# gated index module keeps one a wrapper).
COUNTED = ("linrec_scan", "ring_taps", "scan_group", "block_section",
           "gated_index.CURSOR_LAUNCHES", "gated_index.DRAWS_LAUNCHES",
           "gated_index.WRITE_LAUNCHES", "gated_index.READ_LAUNCHES")

# Captures a kernel keeps.
MAX_GRAPHS = 512

# Keys a kernel remembers having seen, and the steps a capture must have
# gone unreplayed before a new key may take its place (`StepGraphs._room`).
KEEP_SEEN = 4 * MAX_GRAPHS


def _counters():
    """(module, counter name) of each COUNTED entry."""
    out = []
    for entry in COUNTED:
        name, _dot, attr = entry.partition(".")
        out.append((importlib.import_module(f"{__package__}.{name}"),
                    attr or "LAUNCHES"))
    return out


def _counts() -> Tuple[int, ...]:
    return tuple(getattr(m, attr) for m, attr in _counters())


def _add(deltas: Tuple[int, ...]) -> None:
    for (m, attr), d in zip(_counters(), deltas):
        setattr(m, attr, getattr(m, attr) + d)


class StepGraphs:
    """The static buffers and captured steps of one kernel.

    `static(name, shape, dtype)` gives the buffer of that name as a tensor
    of that shape, so every capture reads and writes the same addresses.
    `step(key_fn, body, capture)` runs one step: `body()` is the step's
    program on the static buffers, and `key_fn()` its capture key, None
    before the program's first run has shown what shapes it (the run
    records it)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.buffers: Dict[Any, torch.Tensor] = {}
        # key -> [graph, the launches its capture recorded, the step it
        # was last replayed at], least recently replayed first
        self.graphs: "OrderedDict[Any, list]" = OrderedDict()
        self.keys_seen: "OrderedDict[Any, None]" = OrderedDict()
        self.steps = 0
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.uncaptured = 0
        self.regrowths = 0
        self._pool = None
        self._side = None

    def static(self, name, shape, dtype) -> torch.Tensor:
        """The buffer `name` as a contiguous tensor of `shape`: a prefix of
        one zeroed storage a name, kept for the kernel's life.  A shape
        that needs more than the storage holds grows it and drops every
        capture, since they read the old address."""
        shape = tuple(int(s) for s in shape)
        n = 1
        for s in shape:
            n *= s
        got = self.buffers.get(name)
        if got is not None and got.dtype != dtype:
            raise ValueError(f"static buffer {name!r} is {got.dtype}, asked "
                             f"for {dtype}")
        if got is None or got.numel() < n:
            if got is not None:
                self.graphs.clear()
                self.regrowths += 1
            got = torch.zeros(n, dtype=dtype, device=self.device)
            self.buffers[name] = got
        return got[:n].view(shape)

    def buffer_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers.values())

    def step(self, key_fn: Callable[[], Optional[Any]],
             body: Callable[[], None], capture: bool) -> None:
        """One step: a replay where its key was captured; else the body
        run uncaptured, or, where `capture` and the key was seen before
        and there is room (`_room`), run and then captured."""
        global LAUNCHES
        self.steps += 1
        key = key_fn()
        hit = None if key is None else self.graphs.get(key)
        if hit is not None:
            self.graphs.move_to_end(key)
            hit[2] = self.steps
            hit[0].replay()
            _add(hit[1])
            LAUNCHES += 1
            self.replays += 1
            self._saw(key)
            return
        if capture and key in self.keys_seen and self._room():
            t0 = time.perf_counter()
            key, graph, deltas = self._capture(key_fn, body)
            self.graphs[key] = [graph, deltas, self.steps]
            self.captures += 1
            self.capture_seconds += time.perf_counter() - t0
            self._saw(key)
            return
        body()
        if capture:
            self.uncaptured += 1
        self._saw(key_fn())

    def _saw(self, key) -> None:
        self.keys_seen[key] = None
        self.keys_seen.move_to_end(key)
        while len(self.keys_seen) > KEEP_SEEN:
            self.keys_seen.popitem(last=False)

    def _room(self) -> bool:
        """Whether a new capture may be kept: below MAX_GRAPHS, or where the
        least recently replayed capture has gone KEEP_SEEN steps unused (it
        goes).  Past MAX_GRAPHS keys that recur, the captures made first
        stay and the rest run uncaptured: no capture is dropped that would
        have replayed soon, so no key is captured over and over."""
        if len(self.graphs) < MAX_GRAPHS:
            return True
        oldest = next(iter(self.graphs.values()))
        if self.steps - oldest[2] < KEEP_SEEN:
            return False
        self.graphs.popitem(last=False)
        return True

    def _capture(self, key_fn, body):
        """The step run on the side stream, then captured: (its key, the
        graph, the launches the capture recorded)."""
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()                      # the step itself, uncaptured
        key = key_fn()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        # a CUDA graph that the collector frees mid-capture (another
        # kernel's, dropped in a reference cycle) invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    body()
                except BaseException:
                    try:
                        graph.capture_end()
                    finally:
                        _add(tuple(b - a for a, b in zip(_counts(), before)))
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        after = _counts()
        deltas = tuple(a - b for a, b in zip(after, before))
        # the capture launched nothing: the counters go back
        _add(tuple(-d for d in deltas))
        cur.wait_stream(side)
        return key, graph, deltas

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the device memory segments in the captures' pool (None
        where no capture was made or the allocator's snapshot does not
        name the pools)."""
        if self._pool is None:
            return None
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            named = True
            if tuple(pid) == tuple(self._pool):
                total += int(seg["total_size"])
        return total if named else None

    def stats(self) -> Dict[str, Any]:
        return {"captures": self.captures,
                "capture_seconds": self.capture_seconds,
                "replays": self.replays, "steps": self.steps,
                "uncaptured": self.uncaptured, "graphs": len(self.graphs),
                "keys": len(self.keys_seen), "regrowths": self.regrowths,
                "buffer_bytes": self.buffer_bytes()}
