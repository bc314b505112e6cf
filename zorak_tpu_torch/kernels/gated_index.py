"""K6 and K3b: the gated regime's index program and the dynamic ring read,
CUDA kernels + plain versions.

Counterpart of the gated regime's index arithmetic in
zorak_tpu/lowering/specialize.py (`gate_mask` and `gcursor_idx`
:4217-4238, `gated_rand_vals` :4173-4202, the gated ring write-back
:4758-4803), of its ungated `cursor_idx` (:4208) and of its
`dyn_ring_read` (:4432-4478), which the reference leaves to XLA and the
segment program ran as about 60 torch launches a gate and segment.

- `gated_cursor` (K6a): a gate's prefix sums and every reader of its
  cursor in one launch: positions (f64 plus an origin, or int64) and ring
  values at them, and the cursor's next carried value.  `ring_cursor` is
  the same kernel with no gate: an ungated cursor's positions.
- `gated_draws` (K6b): the gated rand() sites' draws from the render's
  pool, and the consumed count's next value.
- `gated_ring_write` (K6c): a gate's ring writes, each region's new ring.
- `dyn_ring_read` (K3b): a read whose slot changes every sample.

On CUDA tensors each launches its kernel of `csrc/gated_index.cu`; on CPU
tensors each runs its plain version (`*_plain`: the emitter's torch code,
moved here unchanged).  Every step is integer arithmetic, a conversion, a
select or a gather, so the two are equal bit for bit (every NaN one
value).  Nothing falls back from one to the other.  The `*_host` functions
run the kernels' bodies compiled for the CPU (the source's host form), for
tests; no render path calls them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import _build
from ..lowering import eelmath as EM
from ..lowering.specialize import _host_i64 as host_i64

# Kernel launches of each wrapper since its counter was last set;
# chip_smoke.py zeroes them before a path and reads them after to show the
# path went through the kernels.  A K5 replay adds what its capture
# launched (kernels/segment_graph.py's COUNTED).
CURSOR_LAUNCHES = 0
DRAWS_LAUNCHES = 0
WRITE_LAUNCHES = 0
READ_LAUNCHES = 0

MAX_READERS = 16    # csrc: kMaxReaders (more take a launch each 16)
MAX_SITES = 64      # csrc: kMaxSites
MAX_REGIONS = 16    # csrc: kMaxRegions (more take a launch each 16)
SCAN_THREADS = 1024  # a scanning block's most threads (a tile's samples)

F64, I64 = torch.float64, torch.int64
Scalar = Union[float, int, torch.Tensor]


class CursorReader(NamedTuple):
    """One reader of a gated cursor: its position at each sample, anchor +
    fires (up to the sample where `incl`, else before it) + `offset`, mod
    `mod`, given back as `kind` says: "position" (f64, plus `origin` where
    it is not None), "index" (int64) or "value" (`ring` there: [mod]
    shared by the files, or [files, mod])."""
    kind: str
    offset: int
    mod: int
    incl: bool
    origin: Optional[float] = None
    ring: Optional[torch.Tensor] = None


_KINDS = {"position": 0, "value": 1, "index": 2}
_GATHER, _NO_EARLIER, _EARLIER, _EARLIER_SAME = range(4)


class _Stream(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("fs", ctypes.c_longlong),
                ("ts", ctypes.c_longlong)]


class _Anchor(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("fs", ctypes.c_longlong),
                ("value", ctypes.c_double), ("ivalue", ctypes.c_longlong)]


class _Reader(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_longlong), ("offset", ctypes.c_longlong),
                ("mod", ctypes.c_longlong), ("incl", ctypes.c_longlong),
                ("origin", ctypes.c_double),
                ("add_origin", ctypes.c_longlong),
                ("ring", ctypes.c_void_p), ("ring_fs", ctypes.c_longlong),
                ("out", ctypes.c_void_p)]


class _CursorArgs(ctypes.Structure):
    _fields_ = [("gate", _Stream), ("has_gate", ctypes.c_longlong),
                ("anchor", _Anchor), ("nf", ctypes.c_longlong),
                ("length", ctypes.c_longlong),
                ("n_readers", ctypes.c_longlong), ("carry", ctypes.c_void_p),
                ("carry_mod", ctypes.c_double),
                ("r", _Reader * MAX_READERS)]


class _Site(ctypes.Structure):
    _fields_ = [("gate", _Stream), ("has_gate", ctypes.c_longlong)]


class _DrawArgs(ctypes.Structure):
    _fields_ = [("used", _Anchor), ("pool", ctypes.c_void_p),
                ("pool_n", ctypes.c_longlong), ("vals", ctypes.c_void_p),
                ("used_next", ctypes.c_void_p), ("nf", ctypes.c_longlong),
                ("length", ctypes.c_longlong),
                ("n_sites", ctypes.c_longlong), ("s", _Site * MAX_SITES)]


class _Region(ctypes.Structure):
    _fields_ = [("ring", ctypes.c_void_p), ("ring_fs", ctypes.c_longlong),
                ("value", _Stream), ("out", ctypes.c_void_p),
                ("offset", ctypes.c_longlong), ("mod", ctypes.c_longlong)]


class _WriteArgs(ctypes.Structure):
    _fields_ = [("gate", _Stream), ("anchor", _Anchor),
                ("nf", ctypes.c_longlong), ("length", ctypes.c_longlong),
                ("n_regions", ctypes.c_longlong),
                ("g", _Region * MAX_REGIONS)]


class _ReadArgs(ctypes.Structure):
    _fields_ = [("src", _Stream), ("src_n", ctypes.c_longlong),
                ("slot", _Stream), ("cursor", _Anchor),
                ("offset", ctypes.c_longlong), ("mod", ctypes.c_longlong),
                ("mode", ctypes.c_longlong), ("same", _Stream),
                ("out", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("length", ctypes.c_longlong)]


_ENTRIES = ("zorak_gated_cursor", "zorak_gated_draws",
            "zorak_gated_ring_write", "zorak_dyn_ring_read")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("gated_index")
    for name in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _host_library() -> ctypes.CDLL:
    lib = _build.load_host("gated_index")
    for name in _ENTRIES:
        fn = getattr(lib, f"{name}_host")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# -- the plain versions -------------------------------------------------------

def _anchor_i64(v: Scalar):
    """A cursor's value as int64: a host int where it is the host's, else
    the device's [files, 1]."""
    return EM.to_i64(v) if isinstance(v, torch.Tensor) else host_i64(v)


def take(arr: torch.Tensor, idx: torch.Tensor, nf: int,
         length: int) -> torch.Tensor:
    """arr at idx along its last axis, per file: arr [m] (shared) or [nf,
    m]; idx [length] or broadcast to [nf, length]."""
    if idx.dim() < 2:
        idx = idx.expand(length)
        if arr.dim() == 1:
            return arr[idx]
    if arr.dim() == 1:
        return arr[idx.expand(nf, length)]
    return torch.gather(arr, 1, idx.expand(nf, length))


def _ring_pos(pos: torch.Tensor, mod: int) -> torch.Tensor:
    if mod & (mod - 1) == 0:
        return pos & (mod - 1)
    return torch.remainder(pos, mod)


def gated_cursor_plain(gate: torch.Tensor, anchor: Scalar,
                       readers: Sequence[CursorReader], nf: int, length: int,
                       carry_mod: Optional[int] = None
                       ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of `gated_cursor`: the gate's 0/1 mask and its int64
    prefix sums (exact; the reference takes them in f64, a dodge for the
    TPU's vmem), then each reader."""
    m = EM.truthy_mask(gate).to(I64).expand(nf, length)
    after = torch.cumsum(m, dim=1)
    before = after - m
    a = _anchor_i64(anchor)
    outs = []
    for r in readers:
        idx = _ring_pos(a + (after if r.incl else before) + r.offset, r.mod)
        if r.kind == "value":
            outs.append(take(r.ring, idx, nf, length))
        elif r.kind == "position":
            outs.append(idx.to(F64) if r.origin is None
                        else idx.to(F64) + float(r.origin))
        else:
            outs.append(idx)
    carry = None
    if carry_mod is not None:
        a_f = anchor if isinstance(anchor, torch.Tensor) else torch.tensor(
            float(anchor), dtype=F64, device=m.device)
        carry = torch.remainder(a_f + after[:, -1:].to(F64), float(carry_mod))
    return outs, carry


def ring_cursor_plain(start: int, mod: int, length: int,
                      device) -> torch.Tensor:
    """Plain version of `ring_cursor`."""
    pos = start + torch.arange(length, dtype=I64, device=device)
    return _ring_pos(pos, mod)


def gated_draws_plain(gates: Sequence[Optional[torch.Tensor]], used: Scalar,
                      pool: torch.Tensor, nf: int, length: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `gated_draws`."""
    dev = pool.device
    fires = torch.stack(
        [torch.ones((nf, length), dtype=I64, device=dev)
         if gate is None else
         EM.truthy_mask(gate).to(I64).expand(nf, length)
         for gate in gates], dim=2)
    within = torch.cumsum(fires, dim=2) - fires
    per_t = fires.sum(dim=2)
    before = torch.cumsum(per_t, dim=1) - per_t
    idx = (_anchor_i64(used) + before)[:, :, None] + within
    vals = pool[idx.clamp(0, pool.numel() - 1)]
    return vals, used + per_t.sum(dim=1, keepdim=True).to(F64)


def gated_ring_write_plain(gate: torch.Tensor, anchor: Scalar,
                           writes: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                  int, int]],
                           nf: int, length: int) -> List[torch.Tensor]:
    """Plain version of `gated_ring_write`: the segment's writes land at
    consecutive G-space positions (the cursor advances exactly when the
    write fires); a file's inactive samples go to one spare cell past
    every row, dropped.  Active positions are distinct (the plan enforces
    M >= L), so one scatter is exact, each file in its own row."""
    gm = EM.truthy_mask(gate).to(I64).expand(nf, length)
    before = torch.cumsum(gm, dim=1) - gm
    a = _anchor_i64(anchor)
    file_row = torch.arange(nf, dtype=I64, device=gm.device)[:, None]
    out = []
    for ring, value, offset, mod in writes:
        cur = _ring_pos(a + before + offset, mod)
        pos = torch.where(gm > 0, cur + file_row * mod,
                          torch.full_like(gm, nf * mod))
        flat = torch.empty(nf * mod + 1, dtype=F64, device=gm.device)
        flat[:nf * mod] = ring.reshape(-1)
        flat.scatter_(0, pos.reshape(-1), value.expand(nf, length).reshape(-1))
        out.append(flat[:nf * mod].view(nf, mod))
    return out


def dyn_ring_read_plain(src: torch.Tensor, slot: torch.Tensor, nf: int,
                        length: int, cursor: Optional[Scalar] = None,
                        offset: int = 0, preceded: bool = False,
                        same: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `dyn_ring_read`."""
    sigma = EM.to_i64(slot)
    if cursor is None:
        return take(src, sigma, nf, length)
    mod = src.shape[-1] - length
    t64 = torch.arange(length, dtype=I64, device=src.device)
    w0c = _anchor_i64(cursor) + offset
    if not preceded:
        dtil = torch.remainder(w0c + t64 - sigma - 1, mod) + 1
        return take(src, mod + t64 - dtil, nf, length)
    dtil = torch.remainder(w0c + t64 - sigma, mod)
    base = take(src, mod + t64 - dtil, nf, length)
    if same is None:
        return base
    return torch.where(dtil == 0, same, base)


# -- the wrappers -------------------------------------------------------------

def _device(*tensors) -> torch.device:
    devs = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"the tensors must share one device, not {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the gated index kernels run on cuda or cpu, not "
                         f"{dev}")
    return dev


def _stream(v: torch.Tensor, nf: int, length: int, keep: list,
            what: str) -> _Stream:
    """v as a [nf, length] view: its pointer and strides (0 where shared)."""
    if not isinstance(v, torch.Tensor) or v.dtype != F64:
        raise ValueError(f"{what} must be a float64 tensor")
    try:
        v = v.expand(nf, length)
    except RuntimeError:
        raise ValueError(f"{what} of shape {tuple(v.shape)} does not "
                         f"broadcast to [{nf}, {length}]") from None
    keep.append(v)
    return _Stream(v.data_ptr(), v.stride(0), v.stride(1))


def _anchor(v: Scalar, nf: int, keep: list, what: str) -> _Anchor:
    """A cursor's carried value: the host's float (or int), or the device's
    [files, 1] (or 0-d) float64, read by the kernel a file."""
    if not isinstance(v, torch.Tensor):
        iv = int(v) if isinstance(v, int) else host_i64(float(v))
        return _Anchor(None, 0, float(v), iv)
    if v.dtype != F64 or v.numel() not in (1, nf):
        raise ValueError(f"{what} must be a float or float64 [{nf}, 1]")
    v = v.reshape(-1, 1).expand(nf, 1)
    keep.append(v)
    return _Anchor(v.data_ptr(), v.stride(0), 0.0, 0)


def _rows(ring: torch.Tensor, nf: int, keep: list, what: str):
    """A ring [m] (shared) or [nf, m] as (pointer, file stride), each row
    contiguous."""
    if ring.dtype != F64 or ring.dim() not in (1, 2) or (
            ring.dim() == 2 and ring.shape[0] != nf):
        raise ValueError(f"{what} must be float64 [m] or [{nf}, m]")
    if ring.stride(-1) != 1:
        ring = ring.contiguous()
    keep.append(ring)
    return ring.data_ptr(), (ring.stride(0) if ring.dim() == 2 else 0)


def _launch(entry: str, args: ctypes.Structure, dev: torch.device) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_library(), entry)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")


def _cursor_calls(gate, anchor, readers, nf, length, carry_mod, dev):
    """The argument structs of K6a's launches (MAX_READERS readers each;
    the first writes the carry), the outputs and the carry."""
    keep: list = []
    outs = [torch.empty((nf, length), dtype=I64 if r.kind == "index" else F64,
                        device=dev) for r in readers]
    carry = (torch.empty((nf, 1), dtype=F64, device=dev)
             if carry_mod is not None else None)
    calls = []
    for c0 in range(0, max(len(readers), 1), MAX_READERS):
        a = _CursorArgs()
        if gate is not None:
            a.gate, a.has_gate = _stream(gate, nf, length, keep, "gate"), 1
        a.anchor = _anchor(anchor, nf, keep, "the anchor")
        a.nf, a.length = nf, length
        chunk = readers[c0:c0 + MAX_READERS]
        a.n_readers = len(chunk)
        for i, r in enumerate(chunk):
            if r.kind not in _KINDS or r.mod <= 0:
                raise ValueError(f"reader {r.kind!r} mod {r.mod}")
            ar = a.r[i]
            ar.kind, ar.offset, ar.mod, ar.incl = (
                _KINDS[r.kind], r.offset, r.mod, int(bool(r.incl)))
            if r.origin is not None:
                ar.origin, ar.add_origin = float(r.origin), 1
            if r.kind == "value":
                if r.ring.shape[-1] != r.mod:
                    raise ValueError(f"a ring of {r.ring.shape[-1]} cells "
                                     f"read mod {r.mod}")
                ar.ring, ar.ring_fs = _rows(r.ring, nf, keep, "a ring")
            ar.out = outs[c0 + i].data_ptr()
        if c0 == 0 and carry is not None:
            a.carry, a.carry_mod = carry.data_ptr(), float(carry_mod)
        calls.append(a)
    return calls, outs, carry, keep


def gated_cursor(gate: torch.Tensor, anchor: Scalar,
                 readers: Sequence[CursorReader], nf: int, length: int,
                 carry_mod: Optional[int] = None
                 ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """K6a: the positions of a gated cursor for every reader, [nf, length]
    each, and, where `carry_mod`, the cursor's next carried value [nf, 1]
    (the fmod-remainder of anchor + the file's fires by carry_mod).

    `gate` float64, broadcasting to [nf, length]: a sample fires where it
    is truthy (NaN falsy).  `anchor` the cursor's carried value: a host
    float, or the device's float64 [nf, 1].  One launch for every
    MAX_READERS readers.  CUDA tensors go to the kernel, CPU tensors to
    `gated_cursor_plain`."""
    global CURSOR_LAUNCHES
    dev = _device(gate, anchor, *(r.ring for r in readers))
    if dev.type == "cpu":
        return gated_cursor_plain(gate, anchor, readers, nf, length,
                                  carry_mod)
    calls, outs, carry, keep = _cursor_calls(gate, anchor, readers, nf,
                                             length, carry_mod, dev)
    for a in calls:
        _launch("zorak_gated_cursor", a, dev)
        CURSOR_LAUNCHES += 1
    return outs, carry


def ring_cursor(start: int, mod: int, length: int, device) -> torch.Tensor:
    """An ungated cursor's positions (start + t) mod `mod`, int64
    [length]: K6a's kernel with every sample firing on a CUDA device,
    `ring_cursor_plain` on the CPU.  `start` is the host's int."""
    global CURSOR_LAUNCHES
    dev = torch.device(device)
    if dev.type == "cpu":
        return ring_cursor_plain(start, mod, length, dev)
    if dev.type != "cuda":
        raise ValueError(f"ring_cursor runs on cuda or cpu, not {dev}")
    calls, outs, _c, keep = _cursor_calls(
        None, int(start), [CursorReader("index", 0, mod, False)], 1, length,
        None, dev)
    _launch("zorak_gated_cursor", calls[0], dev)
    CURSOR_LAUNCHES += 1
    return outs[0].view(length)


def _draw_call(gates, used, pool, nf, length, dev):
    if not 0 < len(gates) <= MAX_SITES:
        raise ValueError(f"a launch takes 1 to {MAX_SITES} rand sites, not "
                         f"{len(gates)}")
    if pool.dtype != F64 or pool.dim() != 1 or pool.numel() == 0:
        raise ValueError("the pool must be a non-empty float64 [n]")
    keep: list = []
    vals = torch.empty((nf, length, len(gates)), dtype=F64, device=dev)
    used_next = torch.empty((nf, 1), dtype=F64, device=dev)
    a = _DrawArgs()
    a.used = _anchor(used, nf, keep, "the consumed count")
    pool = pool.contiguous()
    keep.append(pool)
    a.pool, a.pool_n = pool.data_ptr(), pool.numel()
    a.vals, a.used_next = vals.data_ptr(), used_next.data_ptr()
    a.nf, a.length, a.n_sites = nf, length, len(gates)
    for s, gate in enumerate(gates):
        if gate is not None:
            a.s[s].gate = _stream(gate, nf, length, keep, "a site's gate")
            a.s[s].has_gate = 1
    return a, vals, used_next, keep


def gated_draws(gates: Sequence[Optional[torch.Tensor]], used: Scalar,
                pool: torch.Tensor, nf: int, length: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6b: the draws of every rand site, [nf, length, sites], and the
    consumed count's next value [nf, 1].

    Site s of sample t of file f draws pool[used + the fires of every
    site before sample t + the fires of the sites before s at t], the
    index clamped into the pool; a site fires where its gate (float64,
    broadcasting to [nf, length]) is truthy, always where it is None.
    `used` the consumed count: a host float, or the device's [nf, 1].
    CUDA tensors go to the kernel, CPU tensors to `gated_draws_plain`."""
    global DRAWS_LAUNCHES
    dev = _device(pool, used, *gates)
    if dev.type == "cpu":
        return gated_draws_plain(gates, used, pool, nf, length)
    a, vals, used_next, keep = _draw_call(gates, used, pool, nf, length, dev)
    _launch("zorak_gated_draws", a, dev)
    DRAWS_LAUNCHES += 1
    return vals, used_next


def _write_calls(gate, anchor, writes, nf, length, dev):
    keep: list = []
    outs, calls = [], []
    for c0 in range(0, len(writes), MAX_REGIONS):
        a = _WriteArgs()
        a.gate = _stream(gate, nf, length, keep, "gate")
        a.anchor = _anchor(anchor, nf, keep, "the anchor")
        a.nf, a.length = nf, length
        chunk = writes[c0:c0 + MAX_REGIONS]
        a.n_regions = len(chunk)
        for i, (ring, value, offset, mod) in enumerate(chunk):
            if ring.dim() != 2 or tuple(ring.shape) != (nf, mod):
                raise ValueError(f"a ring must be float64 [{nf}, {mod}]")
            if mod < min(length, SCAN_THREADS):
                # a tile's fired samples would share cells
                raise ValueError(f"a gated ring of {mod} cells takes at "
                                 f"most {mod} samples a segment, not "
                                 f"{length}")
            g = a.g[i]
            g.ring, g.ring_fs = _rows(ring, nf, keep, "a ring")
            g.value = _stream(value, nf, length, keep, "a written value")
            out = torch.empty((nf, mod), dtype=F64, device=dev)
            outs.append(out)
            g.out, g.offset, g.mod = out.data_ptr(), offset, mod
        calls.append(a)
    return calls, outs, keep


def gated_ring_write(gate: torch.Tensor, anchor: Scalar,
                     writes: Sequence[Tuple[torch.Tensor, torch.Tensor, int,
                                            int]],
                     nf: int, length: int) -> List[torch.Tensor]:
    """K6c: a gate's ring writes; for each `(ring [nf, mod], value, offset,
    mod)` the new ring [nf, mod]: the ring copied (the one handed in stays
    as it was), then each fired sample's value stored at the cursor's
    position before it (anchor + the fires before it + offset, mod mod).
    One launch for every MAX_REGIONS regions.  CUDA tensors go to the
    kernel, CPU tensors to `gated_ring_write_plain`."""
    global WRITE_LAUNCHES
    dev = _device(gate, anchor, *(w[0] for w in writes))
    if dev.type == "cpu":
        return gated_ring_write_plain(gate, anchor, writes, nf, length)
    calls, outs, keep = _write_calls(gate, anchor, writes, nf, length, dev)
    for a in calls:
        _launch("zorak_gated_ring_write", a, dev)
        WRITE_LAUNCHES += 1
    return outs


def _read_call(src, slot, nf, length, cursor, offset, preceded, same, dev):
    """The argument struct of K3b's launch and its output ([length] where
    a gather's ring and slot are both shared, else [nf, length])."""
    keep: list = []
    if src.dtype != F64 or src.dim() not in (1, 2):
        raise ValueError("src must be float64 [m] or [nf, m]")
    gather = cursor is None
    shared = gather and src.dim() == 1 and slot.dim() < 2
    rows = 1 if shared else nf
    out = torch.empty((rows, length), dtype=F64, device=dev)
    a = _ReadArgs()
    a.src = _Stream(*_rows(src, rows, keep, "src"), 1)
    a.src_n = src.shape[-1]
    a.slot = _stream(slot, rows, length, keep, "the slot")
    if gather:
        a.mode = _GATHER
    else:
        if src.dim() != 2 or src.shape[-1] <= length:
            raise ValueError("a read of a written region takes [history | "
                             "writes], [nf, mod + length]")
        a.mod = src.shape[-1] - length
        a.cursor = _anchor(cursor, nf, keep, "the write cursor")
        a.offset = offset
        a.mode = (_NO_EARLIER if not preceded else
                  _EARLIER if same is None else _EARLIER_SAME)
        if same is not None:
            a.same = _stream(same, nf, length, keep, "the same-sample write")
    a.out, a.rows, a.length = out.data_ptr(), rows, length
    return a, (out.view(length) if shared else out), keep


def dyn_ring_read(src: torch.Tensor, slot: torch.Tensor, nf: int,
                  length: int, cursor: Optional[Scalar] = None,
                  offset: int = 0, preceded: bool = False,
                  same: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3b: a ring read whose slot (float64, to_i64 of it, broadcasting to
    [nf, length]) changes every sample.

    `cursor` None: the segment does not write the region, and `src` is its
    ring ([m] shared, or [nf, m]): a gather, [length] where ring and slot
    are both shared, else [nf, length].  Else `src` is [history | this
    segment's final writes], [nf, mod + length], and `cursor` the write
    cursor's carried value (a host float or the device's [nf, 1]) with
    `offset`: the delay to the last write of the slot is dtil =
    (cursor + offset + t - slot - 1) mod mod + 1 where no write precedes
    the read in the sample (`preceded` False), else (cursor + offset + t -
    slot) mod mod, and where it is 0 the value is `same`, the preceding
    writer's stream (None where that writer is the last).  CUDA tensors
    go to the kernel, CPU tensors to `dyn_ring_read_plain`."""
    global READ_LAUNCHES
    dev = _device(src, slot, cursor, same)
    if dev.type == "cpu":
        return dyn_ring_read_plain(src, slot, nf, length, cursor, offset,
                                   preceded, same)
    a, out, keep = _read_call(src, slot, nf, length, cursor, offset,
                              preceded, same, dev)
    if out.numel():
        _launch("zorak_dyn_ring_read", a, dev)
        READ_LAUNCHES += 1
    return out


# -- the host form, for tests --------------------------------------------------

def gated_cursor_host(gate, anchor, readers, nf, length, carry_mod=None):
    """`gated_cursor` through the kernel's body compiled for the CPU
    (CPU tensors; `gate` None: every sample fires)."""
    calls, outs, carry, keep = _cursor_calls(gate, anchor, readers, nf,
                                             length, carry_mod,
                                             torch.device("cpu"))
    for a in calls:
        _host_library().zorak_gated_cursor_host(ctypes.byref(a))
    return outs, carry


def gated_draws_host(gates, used, pool, nf, length):
    """`gated_draws` through the kernel's body compiled for the CPU."""
    a, vals, used_next, keep = _draw_call(gates, used, pool, nf, length,
                                          torch.device("cpu"))
    _host_library().zorak_gated_draws_host(ctypes.byref(a))
    return vals, used_next


def gated_ring_write_host(gate, anchor, writes, nf, length):
    """`gated_ring_write` through the kernel's body compiled for the CPU."""
    calls, outs, keep = _write_calls(gate, anchor, writes, nf, length,
                                     torch.device("cpu"))
    for a in calls:
        _host_library().zorak_gated_ring_write_host(ctypes.byref(a))
    return outs


def dyn_ring_read_host(src, slot, nf, length, cursor=None, offset=0,
                       preceded=False, same=None):
    """`dyn_ring_read` through the kernel's body compiled for the CPU."""
    a, out, keep = _read_call(src, slot, nf, length, cursor, offset,
                              preceded, same, torch.device("cpu"))
    _host_library().zorak_dyn_ring_read_host(ctypes.byref(a))
    return out
