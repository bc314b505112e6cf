"""Sums of constant-gain ring-buffer taps: CUDA kernel + plain version.

Counterpart of the tap reads of zorak_tpu/lowering/specialize.py
(`ring_hist_full`, `ring_delayed`) and the multiply-add chain that
consumes them.  A chain reads its ring region in write order,
`buf = [history | this segment's write stream]`, with `starts[k] = mod -
delay[k]` a tap's static offset into it:

    acc = init
    for k in order:  acc = acc + gains[k] * buf[starts[k] : starts[k] + L]

in f64, multiply and add as two roundings a tap.  The buffer is never
built: buffer index i < mod is `ring[(start + i) % mod]`, where `start`
is the ring position of the oldest sample (the host knows the cursor),
and i >= mod is `stream[i - mod]`.  A chain whose every tap reaches past
the segment reads history alone and takes no stream.

A launch folds a batch of chains (`TapTables`, built once at plan time:
the tables concatenated, and the runs of taps whose window fits the
kernel's shared memory), for one file or for a batch of files that share
the tables and the cursors: then each chain's ring is [files, mod], its
stream and init one row a file or one row for all, and the files are the
third axis of the kernel's grid.  On CUDA tensors `ring_tap_sum` launches the
kernel of `csrc/ring_taps.cu`; on CPU tensors it runs
`ring_tap_sum_reference`, the same fold over slices of the buffer built
with `torch.cat`.  Both keep the chain's order, so both equal the
node-by-node emission bit for bit.  Nothing falls back from one to the
other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

# Kernel launches since the counter was last set; chip_smoke.py zeroes it
# before a path and reads it after to show the path went through the kernel.
LAUNCHES = 0

MAX_CHAINS = 16               # chains in one launch (csrc: kMaxChains)
TILE = 1024                   # output samples a block of the staged kernel
TILES = (256, 512, 1024, 2048)
SMEM_BYTES = 232_448          # shared memory a block may opt into (sm_90)
WINDOW_TAPS = 512             # taps of one window staged at once


class _Chain(ctypes.Structure):
    """One chain of a launch; the layout of csrc/ring_taps.cu's Chain."""
    _fields_ = [("ring", ctypes.c_void_p), ("stream", ctypes.c_void_p),
                ("init", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("mod", ctypes.c_longlong), ("start", ctypes.c_longlong),
                ("init_stride", ctypes.c_longlong),
                ("window_begin", ctypes.c_longlong),
                ("window_end", ctypes.c_longlong),
                ("init_scalar", ctypes.c_double),
                ("ring_fstride", ctypes.c_longlong),
                ("stream_fstride", ctypes.c_longlong),
                ("init_fstride", ctypes.c_longlong),
                ("out_fstride", ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("ring_taps")
    lib.zorak_ring_tap_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.zorak_ring_tap_sum.restype = ctypes.c_int
    return lib


def _windows(starts: Sequence[int],
             tile: int) -> List[Tuple[int, int, int, int]]:
    """Cuts a chain's taps, in order, into runs whose window of
    `max - min + tile + 1` samples fits shared memory beside a table of
    WINDOW_TAPS taps: [(first tap, end, min start, max start)]."""
    room = (SMEM_BYTES - 12 * WINDOW_TAPS) // 8 - tile - 1
    out = []
    k = 0
    while k < len(starts):
        lo = hi = starts[k]
        e = k + 1
        while e < len(starts) and e - k < WINDOW_TAPS and \
                max(hi, starts[e]) - min(lo, starts[e]) <= room:
            lo, hi = min(lo, starts[e]), max(hi, starts[e])
            e += 1
        out.append((k, e, lo, hi))
        k = e
    return out


def choose_tile(length: int, n_chains: int, sms: int, files: int = 1) -> int:
    """The largest tile that still gives nearly every SM a block (15 in
    16) over the chains of every file: each block stages its window's
    span once more, so fewer, larger tiles move less, as long as the
    card stays full."""
    for tile in reversed(TILES):
        if -(-length // tile) * n_chains * files * 16 >= sms * 15:
            return tile
    return TILES[0]


class TapTables:
    """The tap tables of a batch of chains, built once at plan time.

    `chains` is one `(starts, gains)` pair of host sequences a chain, in
    fold order.  Keeps the host lists for the checks and the plain
    version, and on `device` the tables concatenated (starts i32, gains
    f64) and the windows of the staged kernel at `tile` samples a block;
    `tile` None is `choose_tile` for `length` samples of `files` files
    on a CUDA device, else TILE.
    """

    def __init__(self, chains: Sequence[Tuple[Sequence[int], Sequence[float]]],
                 device=None, tile: Optional[int] = None,
                 length: Optional[int] = None, files: int = 1):
        if not 0 < len(chains) <= MAX_CHAINS:
            raise ValueError(f"a launch takes 1 to {MAX_CHAINS} chains, "
                             f"not {len(chains)}")
        device = torch.device("cpu" if device is None else device)
        if tile is None and device.type == "cuda" and length is not None:
            props = torch.cuda.get_device_properties(device)
            tile = choose_tile(length, len(chains),
                               props.multi_processor_count, files)
        elif tile is None:
            tile = TILE
        if tile not in TILES:
            raise ValueError(f"tile must be one of {TILES}, not {tile}")
        self.starts = [[int(s) for s in st] for st, _g in chains]
        self.gains = [[float(g) for g in gs] for _s, gs in chains]
        for st, gs in zip(self.starts, self.gains):
            if not st or len(st) != len(gs):
                raise ValueError("every chain needs taps, as many gains as "
                                 "starts")
            if min(st) < 0 or max(st) >= 2 ** 31:
                raise ValueError("tap starts must lie in [0, 2^31)")
        self.tile = tile
        self.counts = [len(st) for st in self.starts]
        self.max_starts = [max(st) for st in self.starts]
        windows, self.chain_windows = [], []
        base = 0
        for st in self.starts:
            first = len(windows)
            windows += [(base + k, base + e, lo, hi)
                        for k, e, lo, hi in _windows(st, tile)]
            self.chain_windows.append((first, len(windows)))
            base += len(st)
        # gains and starts of the largest window (a multiple of 4), then
        # the window and one double for alignment
        self.table_taps = -(-max(e - k for k, e, _lo, _hi in windows) // 4) * 4
        self.smem_bytes = (12 * self.table_taps + 8 * (
            max(hi - lo for _k, _e, lo, hi in windows) + tile + 1))
        self.n_windows = len(windows)
        host = (torch.tensor([s for st in self.starts for s in st],
                             dtype=torch.int32),
                torch.tensor([g for gs in self.gains for g in gs],
                             dtype=torch.float64),
                torch.tensor(windows, dtype=torch.int32))
        if device.type == "cuda":
            # through pinned memory: a pageable copy would wait for the card
            host = tuple(v.pin_memory().to(device, non_blocking=True)
                         for v in host)
        self.starts_dev, self.gains_dev, self.windows_dev = host
        self.device = self.starts_dev.device     # with its index


def _check(tables: TapTables, rings, cursors, streams, inits,
           length) -> int:
    """Checks a launch's arguments; returns its files: 0 where every ring
    is 1-d (one file, no files axis), else the rings' first axis."""
    n = len(tables.counts)
    if not len(rings) == len(cursors) == len(streams) == len(inits) == n:
        raise ValueError(f"{n} chains need {n} rings, cursors, streams and "
                         "inits")
    if length < 0:
        raise ValueError(f"length {length} < 0")
    f64, dev = torch.float64, tables.device
    batched = isinstance(rings[0], torch.Tensor) and rings[0].dim() == 2
    nf = rings[0].shape[0] if batched else 0
    lead = (nf,) if batched else ()
    for c, (ring, start, stream, init, hi) in enumerate(
            zip(rings, cursors, streams, inits, tables.max_starts)):
        if ring.dtype != f64 or ring.dim() != 1 + batched \
                or ring.shape[:-1] != lead or ring.device != dev:
            raise ValueError(f"chain {c}: the ring must be a float64 "
                             f"{list(lead) + ['mod']} tensor on {dev}")
        mod = ring.shape[-1]
        if not 0 <= start < mod:
            raise ValueError(f"chain {c}: cursor start {start} outside "
                             f"[0, {mod})")
        if stream is None:
            if hi + length > mod:
                raise ValueError(
                    f"chain {c}: a tap at start {hi} reaches past the "
                    f"history of {mod} samples and there is no stream")
        elif stream.dtype != f64 or stream.device != dev or \
                stream.shape not in ((length,), lead + (length,)):
            raise ValueError(f"chain {c}: the stream must be float64 "
                             f"[{length}] or {list(lead) + [length]} on "
                             f"{dev}")
        elif hi > mod:
            raise ValueError(f"chain {c}: a tap at start {hi} reaches past "
                             f"the buffer of {mod} + {length}")
        if isinstance(init, torch.Tensor) and (
                init.dtype != f64 or init.device != dev
                or init.dim() > 1 + batched or not _broadcasts(
                    tuple(init.shape), lead + (length,))):
            raise ValueError(f"chain {c}: init must be a float or a float64 "
                             f"tensor on {dev} that broadcasts to "
                             f"{list(lead) + [length]}")
    return nf


def _broadcasts(shape: Tuple[int, ...], to: Tuple[int, ...]) -> bool:
    return all(a in (1, b) for a, b in zip(reversed(shape), reversed(to)))


def ring_tap_sum_reference(tables: TapTables, rings: Sequence[torch.Tensor],
                           cursors: Sequence[int],
                           streams: Sequence[Optional[torch.Tensor]],
                           inits: Sequence, length: int) -> torch.Tensor:
    """Plain PyTorch version: builds each chain's buffer, then one multiply
    and one add a tap, on slices, every file's row alike.  Returns
    [chains, length], or [chains, files, length] for 2-d rings."""
    nf = _check(tables, rings, cursors, streams, inits, length)
    rows = max(nf, 1)
    out = []
    for c, (ring, start, stream, init) in enumerate(
            zip(rings, cursors, streams, inits)):
        ring = ring.reshape(rows, ring.shape[-1])
        parts = [ring[:, start:], ring[:, :start]]
        if stream is not None:
            parts.append(stream.expand(rows, length))
        buf = torch.cat(parts, dim=1)
        acc = init.expand(rows, length) if isinstance(init, torch.Tensor) \
            else torch.full((rows, length), float(init), dtype=torch.float64,
                            device=ring.device)
        for s, g in zip(tables.starts[c], tables.gains[c]):
            acc = acc + g * buf[:, s:s + length]
        out.append(acc)
    out = torch.stack(out)
    return out if nf else out[:, 0]


def ring_tap_sum(tables: TapTables, rings: Sequence[torch.Tensor],
                 cursors: Sequence[int],
                 streams: Sequence[Optional[torch.Tensor]], inits: Sequence,
                 length: int, staged: bool = True) -> torch.Tensor:
    """Folds every chain of `tables` in one launch -> [chains, length] f64,
    or [chains, files, length] for a batch of files.

    For chain c: `rings[c]` its region's ring, [mod] f64, or [files, mod]
    for a batch (every chain then has the same files); `cursors[c]` the
    ring position of the oldest sample (a host int, shared by the
    files); `streams[c]` this segment's write stream, [length] f64 (one
    for every file) or [files, length], or None for a chain that reads
    history alone; `inits[c]` a float or an f64 tensor that broadcasts to
    [length] ([files, length]: a 0-d, [length], [files, 1] or [files,
    length]).  CUDA tensors go to the kernel, CPU tensors to the plain
    version.  `staged=False` runs the global kernel, the earlier design,
    for timing beside the staged one.
    """
    global LAUNCHES
    nf = _check(tables, rings, cursors, streams, inits, length)
    dev = tables.device
    if dev.type == "cpu":
        return ring_tap_sum_reference(tables, rings, cursors, streams, inits,
                                      length)
    if dev.type != "cuda":
        raise ValueError(f"ring_tap_sum runs on cuda or cpu, not {dev}")
    files = max(nf, 1)
    if files > 65535:
        raise ValueError("ring_tap_sum takes at most 65535 files")
    out = torch.empty((len(rings), files, length), dtype=torch.float64,
                      device=dev)
    if length == 0:
        return out if nf else out[:, 0]
    keep = []                     # every tensor a pointer is taken from
    chains = (_Chain * len(rings))()
    for c, (ring, start, stream, init) in enumerate(
            zip(rings, cursors, streams, inits)):
        # each file's row contiguous in time; a shared row has file stride 0
        ring = ring.reshape(files, ring.shape[-1])
        if ring.stride(1) != 1:
            ring = ring.contiguous()
        keep.append(ring)
        ch = chains[c]
        ch.ring, ch.mod, ch.start = ring.data_ptr(), ring.shape[1], start
        ch.ring_fstride = ring.stride(0)
        if stream is not None:
            stream = stream.expand(files, length)
            if stream.stride(1) != 1:
                stream = stream.contiguous()
            keep.append(stream)
            ch.stream, ch.stream_fstride = stream.data_ptr(), stream.stride(0)
        if isinstance(init, torch.Tensor):
            init = init.expand(files, length)
            keep.append(init)
            ch.init = init.data_ptr()
            ch.init_fstride, ch.init_stride = init.stride()
        else:
            ch.init_scalar = float(init)
        ch.out = out.data_ptr() + 8 * c * files * length
        ch.out_fstride = length
        ch.window_begin, ch.window_end = tables.chain_windows[c]
    with torch.cuda.device(dev):
        stream_ptr = torch.cuda.current_stream(dev).cuda_stream
        err = _library().zorak_ring_tap_sum(
            ctypes.addressof(chains), len(rings), tables.starts_dev.data_ptr(),
            tables.gains_dev.data_ptr(), tables.windows_dev.data_ptr(), length,
            files, tables.tile if staged else 0, tables.table_taps,
            tables.smem_bytes, stream_ptr)
    if err != 0:
        raise RuntimeError(f"ring_tap_sum kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out if nf else out[:, 0]
