"""Sequential device executor: the whole plugin stepped on the card.

Counterpart of zorak_tpu/lowering/devexec.py.  The vectorizing specializer
rejects plugins whose control structure resists time-vectorization
(data-dependent voice loops over record tables, clamps bounded by a control
stream, rand() in an audio-coupled @block).  `DeviceExecKernel` renders
them sequentially in time, like the reference's native loop, but on the
card: @block, the pending-mask @slider retrigger and @sample, printed as C
by `lowering/devgen.py`, run inside one generated kernel, K11
(`kernels/device_exec.py`), that holds the audio, the heap and the vars on
the device for the whole render.

As the reference's, the executor sizes its heap from the observed use
after @init (twice it, at least 4,096 cells, at most the declared maxmem)
and climbs a ladder where a render writes past it: at build, a static
address past the heap rebuilds at once; after a render, the high-water
slot (one device read) at or past the heap rebuilds with at least twice
the heap and replays from the render's input state.  rand() draws from a
pool of MT19937 draws staged before each render from the host's generator
(`semantics/mt19937np.py`); a resumed render first advances that generator
by the draws the last one used.  gmem is a window of the heap row past the
heap, filled from the snapshot's gmem and written back into the state's
(an attached segment bumped over the span that changed); a lone
instance's bus calls fold inert, and no live bus reaches the executor, as
in the reference.  The reference's sectioned mode, its cond outlining and
its DFT tables serve the TPU's remote compiler and are not ported.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ir.program import PluginProgram
from .devgen import (DeviceSection, DevgenError, HostTables,
                     MEM_HIWATER_SLOT, MIDI_OUT_CAP, MIDI_POS_SLOT,
                     PENDING_SLOT_NAMES, RAND_POS_SLOT, section_dynamic_keys)
from .specialize import SpecializeError


class DeviceExecKernel:
    """Whole-plugin sequential render kernel (engine "devexec")."""

    def __init__(self, program: PluginProgram, snapshot, nch: int,
                 segment_len: int = 1 << 17, block_size: int = 512,
                 rand_pool: int = 1 << 18,
                 heap_size: Optional[int] = None, device=None):
        self.P = program
        self.snap = snapshot
        self.nch = int(nch)
        self.B = int(block_size)
        self.device = resolve_device(device)
        self.engine = "devexec"
        self.coupled = True           # @block runs on the device
        self._rand_pool_req = int(rand_pool)
        if not program.sections.get("sample"):
            raise SpecializeError("no @sample section")
        self._secs = tuple(s for s in ("block", "slider", "sample")
                           if program.sections.get(s))
        self._dyn = section_dynamic_keys(program, self._secs)
        # the declared maxmem is the cap, not the working set: start from
        # the observed use after @init with 2x headroom
        top = int(program.memtop or 0)
        used = int(getattr(snapshot, "mem_used", 0))
        self._full_size = 1 << max(12, int(top - 1).bit_length()
                                   if top > 1 else 12)
        if heap_size is not None:
            size = min(int(heap_size), self._full_size)
        else:
            size = min(self._full_size,
                       1 << max(12, (2 * max(used, 1) - 1).bit_length()))
        self.heap_climbs: List[int] = []   # the sizes each climb reached
        # the host services' tables: one for the kernel's life, so a climb
        # of the ladder stages nothing again
        self.tables = HostTables()
        self._build(size)
        self._rng_state = None        # the generator the last pool came from
        self._rng_prestate = None
        self.last_midi_out: List[Tuple[int, int, int, int]] = []
        self.last_draws = 0           # draws the last render used (most
                                      # of its files)

    # -- build -----------------------------------------------------------------

    def _build(self, size: int) -> None:
        """The sections at heap `size`, climbing where a static address
        lies past it."""
        from ..kernels.device_exec import DeviceExecProgram

        # the sections share one heap row: its gmem window and MIDI out
        # table are laid out over all of their bodies
        bodies = [list(self.P.sections.get(s) or []) for s in self._secs]
        probe = None
        while True:
            try:
                if probe is None:
                    # which sections draw rand(): one pool for all of them
                    probe = [DeviceSection(self.P, self.snap, s, self._dyn,
                                           size, reduced_heap=True,
                                           rand_pool=self._rand_pool_req,
                                           layout_bodies=bodies,
                                           tables=self.tables)
                             for s in self._secs]
                    self.uses_rand = any(p.uses_rand for p in probe)
                    self._rand_cap = (self._rand_pool_req if self.uses_rand
                                      else 0)
                secs = {s: DeviceSection(self.P, self.snap, s, self._dyn,
                                         size, reduced_heap=True,
                                         rand_pool=self._rand_cap,
                                         layout_bodies=bodies,
                                         tables=self.tables)
                        for s in self._secs}
                break
            except DevgenError as exc:
                m = re.search(r"address (\d+)", str(exc))
                if "beyond device heap" in str(exc) and m \
                        and size < self._full_size:
                    # jump the ladder straight past the offending address
                    need = int(m.group(1))
                    size = min(self._full_size,
                               max(size * 2, 1 << (need - 1).bit_length()))
                    self.heap_climbs.append(size)
                    probe = None
                    continue
                raise SpecializeError(f"device executor: {exc}") from None
        self.sample = secs["sample"]
        self.block = secs.get("block")
        self.slider = secs.get("slider") if self.block is not None else None
        self.program = DeviceExecProgram(self.sample, self.block, self.slider,
                                         nch=self.nch, block_size=self.B)
        self._rpos = self.sample.slots[("var", RAND_POS_SLOT)]
        self._hw = self.sample.slots[("var", MEM_HIWATER_SLOT)]

    @property
    def mem_size(self) -> int:
        return self.sample.mem_size

    @property
    def accepts_midi(self) -> bool:
        return bool(self.block is not None and self.block.uses_midi_in)

    # -- carries ---------------------------------------------------------------

    def initial_carry(self):
        """(vars [n_vars], heap [total_mem]), float64 on the kernel's device."""
        return (torch.from_numpy(self.sample.initial_vars()).to(self.device),
                torch.from_numpy(self.sample.initial_mem()).to(self.device))

    def _migrate_carry(self, old_sample: DeviceSection, carry):
        """An old heap's (vars, heap) re-laid out onto this kernel's larger
        heap: the plugin heap at the start, the grown region zero-filled,
        the gmem window and the MIDI out table moved to their new bases.
        Slot tables do not depend on the heap's size."""
        bv, bm = carry
        o, n = old_sample, self.sample
        out = torch.zeros(bm.shape[:-1] + (n.total_mem,), dtype=torch.float64,
                          device=bm.device)
        out[..., :o.mem_size] = bm[..., :o.mem_size]
        for cells, at_old, at_new in (
                (o.gmem_cells, o.gmem_base, n.gmem_base),
                (o.midi_out_cells, o.midi_out_base, n.midi_out_base)):
            out[..., at_new:at_new + cells] = bm[..., at_old:at_old + cells]
        return bv.clone(), out

    def grow_to(self, size: int) -> None:
        """Rebuild on a heap of at least `size` cells (a carry from a larger
        heap, e.g. a converted JAX carry); carries made before move with
        `_migrate_carry`."""
        if size > self.mem_size:
            self._build(min(self._full_size, 1 << (int(size) - 1).bit_length()))

    # -- render ----------------------------------------------------------------

    def _midi_planes(self, midi, T: int):
        """The host's events as the reference stages them: [blocks, K, 4]
        (offset in the block, three bytes) and [blocks] counts."""
        B = self.B
        rows = T // B + (1 if T % B else 0)
        per: List[List[Tuple[float, float, float, float]]] = \
            [[] for _ in range(rows)]
        for ev in sorted(midi or [], key=lambda e: e[0]):
            off = max(0, min(int(ev[0]), T - 1))
            per[off // B].append((float(off - (off // B) * B),
                                  float(int(ev[1]) & 0xFF),
                                  float(int(ev[2]) & 0xFF),
                                  float(int(ev[3]) & 0xFF)))
        K = max(1, max((len(p) for p in per), default=1))
        mev = np.zeros((rows, K, 4), dtype=np.float64)
        mn = np.zeros((rows,), dtype=np.float64)
        for b, evs in enumerate(per):
            mn[b] = len(evs)
            for k, e in enumerate(evs):
                mev[b, k] = e
        return mev, mn

    def _stage_rand_pool(self, draws_used: Optional[int]) -> torch.Tensor:
        """The pool of this render: MT19937 draws from the snapshot's
        generator (a fresh render, draws_used None) or from the generator
        advanced by the draws the last render used."""
        from ..semantics import mt19937np as MT

        if draws_used is None or self._rng_prestate is None:
            self._rng_state = MT.eelrng_state_tuple(self.snap.rng)
        else:
            if draws_used > self._rand_cap:
                raise SpecializeError(
                    f"device rand pool exhausted ({draws_used} > "
                    f"{self._rand_cap}); rebuild with a larger rand_pool")
            self._rng_state = (MT.generate(draws_used, self._rng_prestate)[1]
                               if draws_used > 0 else self._rng_prestate)
        self._rng_prestate = self._rng_state
        draws, _ = MT.generate(self._rand_cap, self._rng_state)
        return torch.from_numpy(draws.astype(np.float64)).to(self.device)

    def _files_carry(self, x: torch.Tensor, carries):
        """(vars [nf, n_vars], heap [nf, total_mem], draws used before or
        None where fresh): the carries, checked, cloned onto the device."""
        nf = x.shape[0]
        if carries is None:
            bv, bm = self.initial_carry()
            return (bv.expand(nf, -1).contiguous(),
                    bm.expand(nf, -1).contiguous(), None)
        bv, bm = carries
        bv = torch.as_tensor(bv, dtype=torch.float64).to(self.device)
        bm = torch.as_tensor(bm, dtype=torch.float64).to(self.device)
        if bv.dim() == 1:
            bv, bm = bv[None], bm[None]
        if bv.shape != (nf, self.sample.n_vars) or bm.shape[0] != nf:
            raise ValueError(f"carries {list(bv.shape)}, {list(bm.shape)} "
                             f"for {nf} files of {self.sample.n_vars} slots")
        if bm.shape[1] != self.sample.total_mem:
            raise SpecializeError(
                f"the carries hold a heap of {bm.shape[1]} cells, the kernel "
                f"{self.sample.total_mem}: migrate them to this heap first")
        used = None
        if self.uses_rand:
            counts = bv[:, self._rpos].unique()
            if counts.numel() != 1:
                raise SpecializeError(
                    "the files' carries hold different generator states "
                    f"(draws used {counts.tolist()}): the host's generator "
                    "is shared by the files of one render")
            used = int(counts.item())
        return bv.clone().contiguous(), bm.clone().contiguous(), used

    def render_files(self, x, carries=None, midi=None):
        """x [files, nch, T] float32 (numpy or a tensor).  Returns (y
        [files, nch, T] float32 on the device, carries (vars [files,
        n_vars], heap [files, total_mem])).

        The reference's `_make_run` under a files axis: one K11 launch
        renders every file.  The files share the host's generator and the
        heap's rung: carries whose draws used differ are refused, and a
        climb of the heap ladder for one file climbs for all."""
        x = torch.as_tensor(x).to(self.device, torch.float32).contiguous()
        if x.dim() != 3 or x.shape[1] != self.nch:
            raise ValueError(f"x must be [files, {self.nch}, T], got "
                             f"{list(x.shape)}")
        from ..kernels import device_exec as DX

        T = x.shape[2]
        carry_in = carries
        rng_save = (self._rng_state, self._rng_prestate)
        if midi and not self.accepts_midi:
            raise SpecializeError("MIDI events supplied but this kernel has "
                                  "no @block midirecv path")
        planes = None
        if self.accepts_midi:
            mev, mn = self._midi_planes(midi, T)
            planes = (torch.from_numpy(mev).to(self.device),
                      torch.from_numpy(mn).to(self.device))
        while True:
            bv, bm, used = self._files_carry(x, carry_in)
            pool = None
            if self.uses_rand:
                pool = self._stage_rand_pool(used)
                bv[:, self._rpos] = 0.0
            y, mo = DX.device_exec(self.program, x, bv, bm, pool, planes)
            # the reduced heap's overflow check: a dynamic write at or past
            # the heap was dropped, so the render is replayed on a larger
            # one (one device read, the draws used beside the high water)
            marks = bv[:, [self._hw, self._rpos]].max(dim=0).values.tolist()
            hw = marks[0]
            if hw < self.mem_size:
                self.last_draws = int(marks[1]) if self.uses_rand else 0
                self.last_midi_out = [] if mo is None else \
                    self._decode_midi_out(mo[0].cpu().numpy())
                self._mout_files = mo
                return y, (bv, bm)
            if self.mem_size >= self._full_size:
                raise SpecializeError(
                    f"device heap overflow (write at {int(hw)} with the "
                    f"maxmem-sized heap {self.mem_size})")
            old = self.sample
            self._build(min(self._full_size,
                            max(self.mem_size * 2, 1 << int(hw).bit_length())))
            self.heap_climbs.append(self.mem_size)
            if carry_in is not None:
                cv, cm = carry_in
                cv = torch.as_tensor(cv, dtype=torch.float64).to(self.device)
                cm = torch.as_tensor(cm, dtype=torch.float64).to(self.device)
                carry_in = self._migrate_carry(old, (cv, cm))
            self._rng_state, self._rng_prestate = rng_save

    def render_device(self, x, carry=None, midi=None):
        """x: float32 [nch, T], numpy or a tensor.  Returns (y float32
        tensor [nch, T] on the kernel's device, carry (vars, heap))."""
        x = torch.as_tensor(x)
        if x.dim() != 2 or x.shape[0] != self.nch:
            raise ValueError(f"x must be [{self.nch}, T], got {list(x.shape)}")
        y, (bv, bm) = self.render_files(x[None], carry, midi=midi)
        return y[0], (bv[0], bm[0])

    def render(self, x, carry=None, midi=None):
        """x: float32 [nch, T].  Returns (y float32 numpy [nch, T], carry)."""
        y, carry = self.render_device(x, carry, midi=midi)
        return y.cpu().numpy(), carry

    def _decode_midi_out(self, mo: np.ndarray):
        events = []
        for b in range(mo.shape[0]):
            n = int(mo[b, 0])
            for k in range(min(n, MIDI_OUT_CAP)):
                ofs, b1, b2, b3 = mo[b, 1 + 4 * k: 5 + 4 * k]
                events.append((b * self.B + int(ofs), int(b1), int(b2),
                               int(b3)))
        return events

    # -- writeback -------------------------------------------------------------

    def writeback(self, carry, state) -> None:
        """Flush the final (vars, heap) into a ShadowState."""
        bv, bm = carry
        bv = torch.as_tensor(bv).cpu().numpy()
        bm = torch.as_tensor(bm).cpu().numpy()
        samp = self.sample
        if self.uses_rand and self._rng_prestate is not None:
            from ..semantics import mt19937np as MT

            used = int(bv[self._rpos])
            if used > self._rand_cap:
                raise SpecializeError(
                    f"device rand pool exhausted ({used} > "
                    f"{self._rand_cap}); rebuild with a larger rand_pool")
            rng_state = self._rng_prestate
            if used > 0:
                _, rng_state = MT.generate(used, self._rng_prestate)
            MT.restore_eelrng(state.rng, rng_state)
        if samp.gmem_cells:
            # the window into the state's gmem; an attached segment's pages
            # bumped once over the span the render changed (the
            # reference's coarse rule)
            gm = bm[samp.gmem_base:samp.gmem_base + samp.gmem_cells]
            old = np.asarray(state.gmem, dtype=np.float64)
            n = min(len(old), len(gm))
            changed = np.nonzero(old[:n] != gm[:n])[0]
            state.gmem[:n] = gm[:n]
            host = getattr(state, "host", None)
            seg = getattr(host, "attached_gmem", None)
            if seg is not None and changed.size:
                seg.bump(int(changed.min()), int(changed.max()),
                         getattr(host, "instance_id_int", 0))
        heap = bm[:samp.mem_size]
        state.mem_ensure(len(heap))
        state.mem[:len(heap)] = heap
        masks = ("pending_change_mask", "pending_automate_mask",
                 "pending_automate_end_mask")
        for key, slot in samp.slots.items():
            if key[0] == "param":
                continue
            if key[0] == "var" and key[1] in (MIDI_POS_SLOT, RAND_POS_SLOT,
                                              MEM_HIWATER_SLOT):
                continue
            v = float(bv[slot])
            if key[0] == "var" and key[1] in PENDING_SLOT_NAMES:
                setattr(state, masks[PENDING_SLOT_NAMES.index(key[1])],
                        int(max(0.0, v)))
            elif key[0] == "var":
                state.V[key[1]] = v
            elif key[0] == "spl":
                state.spl[key[1]] = v
            elif key[0] == "slider":
                state.sliders[key[1]] = v
            elif key[0] == "builtin":
                setattr(state, key[1], v)


def device_exec_kernel(program: PluginProgram, snapshot, nch: int,
                       segment_len: int = 1 << 17, block_size: int = 512,
                       device=None) -> DeviceExecKernel:
    return DeviceExecKernel(program, snapshot, nch, segment_len,
                            block_size=block_size, device=device)
