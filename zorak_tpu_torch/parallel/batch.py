"""Batch rendering: many files through one plugin, and the catalog sweep.

Counterpart of zorak_tpu/parallel/batch.py.  The JAX package vmaps the
whole-render pipeline (`_raw_render`) over a files axis (`in_axes=(0, 0,
None, None)`: the carry and the audio per file, the control trajectory
and the draw matrix shared).  Here the pipeline is the kernel's segment
loop, `SpecializedSampleKernel._run`, and the files are a leading axis
written out through the segment emitter and through the kernels it
launches, K2 (`linrec_scan`), K3 (`ring_tap_sum`) and K4
(`scan_group`), so a batch of nf files launches each kernel as often as
one file does, and each file's audio equals its solo render bit for bit.
A plugin whose @block is audio-coupled runs the fused block/sample loop,
`SpecializedSampleKernel._coupled_run`, whose device @block (K10,
`block_section`) takes the files as its grid; a plugin with a hop section
runs the fused sample/hop loop, `_hop_run`, K10 after each hop the same
way.  A kernel with guessed loop(n) bounds checks its overflow monitor
after a batch and rebuilds with a larger bound, as the solo render does.
The host mirror of the
carried cursors is shared by the files; a batched run checks at its start
that every file agrees on it.

The catalog functions keep the reference's API and returns.  The
reference fuses each group of plugins into one XLA program, capped at
five only for the TPU compiler's memory; here a group is its renderers
run in turn on inputs staged once per channel count, and the grouping is
kept so that the returned count matches.  Sharding the files over a
device mesh is out of scope on one GPU: `mesh=` is refused.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ir.program import PluginProgram
from ..lowering import SpecializeError, specialize_sample_kernel
from ..lowering.specialize import LADDER_ATTEMPTS
from ..models import get_faust_module
from ..verify.nulltest import make_initialized_shadow

# (files, T) stagings a renderer keeps on the device, as the reference does
MAX_STAGED = 8


class BatchRenderer:
    """One plugin (one slider configuration), many files.

    `render_files` maps x [nf, nch, T] f32 to y [nf, nch, T] f32 on the
    kernel's device (CUDA unless `device="cpu"`).  Carry, control and
    draws are staged once per (nf, T), at most MAX_STAGED stagings."""

    is_faust = False

    def __init__(self, program: PluginProgram, srate: float = 48000.0,
                 sliders: Optional[Dict[int, float]] = None,
                 segment_len: int = 1 << 16, block_size: int = 512,
                 device=None):
        self.program = program
        self.srate = srate
        self.nch = max(1, program.io_channels["process"])
        shadow = make_initialized_shadow(program, srate, sliders)
        # what the solo path refuses raises here too
        self.kernel = specialize_sample_kernel(
            program, shadow.state, self.nch, segment_len=segment_len,
            block_size=block_size, device=device)
        self.device = self.kernel.device
        self._staged: Dict[Tuple[int, int], tuple] = {}

    def staged(self, nf: int, T: int):
        """(carry, ctrl, rand) on the device for nf files of T samples:
        the planned initial carry broadcast to every file, the control
        trajectory and the draw matrix of a fresh render, shared."""
        got = self._staged.get((nf, T))
        if got is not None:
            return got
        kern = self.kernel

        def files(a):
            return np.broadcast_to(a, (nf,) + np.shape(a))

        def sample_side(c):
            svec, rings = c
            return files(svec), {r: files(a) for r, a in rings.items()}

        c0 = kern.initial_carry()
        carry = kern.device_carry(
            (sample_side(c0[0]), files(c0[1]), files(c0[2]))
            if kern.has_device_view else sample_side(c0))
        # the coupled regime's control rows come from the device @block
        ctrl = None if kern.coupled else kern.put_f64(kern.fresh_control(T))
        got = (carry, ctrl, kern.put_f64(kern._rand_streams(T, reset=True)))
        if len(self._staged) < MAX_STAGED:
            self._staged[(nf, T)] = got
        return got

    def render_files(self, x, mesh=None) -> torch.Tensor:
        """x [nf, nch, T] f32 (numpy or tensor) -> f32 tensor on the
        device, the same shape."""
        if mesh is not None:
            raise ValueError("mesh= shards the files over several devices; "
                             "the port renders a batch on one GPU")
        return self._render_as(None, x)

    def _render_as(self, step, x) -> torch.Tensor:
        """`render_files` with the kernel's steps run as `step` says
        (`SpecializedSampleKernel._step_mode`: None as render_files,
        "eager" the eager step, chip_smoke.py's yardstick for K5)."""
        x = self.kernel.put_audio(x)
        if x.dim() != 3 or x.shape[1] != self.nch:
            raise ValueError(f"render_files takes [nf, {self.nch}, T], got "
                             f"{tuple(x.shape)}")
        nf, nch, T = x.shape
        if nf == 0 or T == 0:
            return torch.zeros((nf, nch, T), dtype=torch.float32,
                               device=self.device)
        for _attempt in range(LADDER_ATTEMPTS):
            kern = self.kernel
            carry, ctrl, rand = self.staged(nf, T)
            y, fcarry = _one_pass(kern, carry, x, ctrl, rand, step)
            # the guessed loop(n) bounds: one device read of the overflow
            # monitor, the largest of the files', and on overflow a
            # rebuild with K doubled past it and a replay (the solo
            # render's ladder, batched)
            if not kern.sym.masked_loops:
                return y
            ovf = kern.loop_overflow(fcarry)
            if ovf <= 0.0:
                return y
            self.kernel = kern.with_larger_loop_bound(ovf)
            self._staged.clear()
        raise SpecializeError("masked-loop overflow ladder did not "
                              "converge")


def _one_pass(kern, carry, x, ctrl, rand, step=None):
    """The kernel's whole render of x [nf, nch, T] from a staged carry:
    the fused block/sample loop (coupled), the fused sample/hop loop from
    the counter's planned phase (hop; K10 updates its carry in place, so
    both take a copy and the staging stays fresh), or the segment loop.
    Returns (y f32 [nf, nch, T], carry)."""
    if kern.coupled:
        y, carry, _mo = kern._coupled_run(kern.device_carry(carry), x, rand,
                                          step=step)
        return y, carry
    if kern._hop is not None:
        return kern._hop_run(kern.device_carry(carry), x, ctrl, rand,
                             kern._hop_phase0, step)
    return kern._run(carry, x, ctrl, rand, kern.segment_length(x.shape[2]),
                     step)


def render_batch(program: PluginProgram, x_files, srate: float = 48000.0,
                 mesh=None, **kw) -> torch.Tensor:
    return BatchRenderer(program, srate=srate, **kw).render_files(
        x_files, mesh=mesh)


class FaustBatchRenderer:
    """Faust-family catalog entry rendered whole-T (no carried segment
    state): `render_files` maps x [nf, nch, T] f32 to y [nf, nch, T] f32.
    The JAX renderer vmaps the module over files; the port's modules take
    [..., ch, T], so the files are a batch dimension written out."""

    is_faust = True

    def __init__(self, slug: str, srate: float = 48000.0, device=None):
        mod = get_faust_module(slug)
        if mod is None:
            raise ValueError(f"no Faust module for {slug}")
        self.device = resolve_device(device)
        self.mod = mod
        self.slug = slug
        self.srate = float(srate)
        self.nch = int(mod.n_in)
        self.values = mod.values()

    def _render(self, x: torch.Tensor) -> torch.Tensor:
        """The module contract is f64 (matches the NumPy goldens); output
        rides as f32 like every other catalog entry."""
        x64 = x.to(device=self.device, dtype=torch.float64)
        return self.mod(x64, self.values, self.srate).to(torch.float32)

    def raw_render(self, T: int):
        """run(x [nch, T]) -> (y f32 [nch, T], None)."""

        def run(x32):
            if x32.shape != (self.nch, T):
                raise ValueError(f"{self.slug} renders [{self.nch}, {T}], "
                                 f"got {tuple(x32.shape)}")
            return self._render(x32), None

        return run

    def render_files(self, x) -> torch.Tensor:
        """x [nf, nch, T] f32 (numpy or tensor) -> f32 tensor on the device."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if x.dim() != 3 or x.shape[1] != self.nch:
            raise ValueError(f"{self.slug} takes [nf, {self.nch}, T], "
                             f"got {tuple(x.shape)}")
        return self._render(x)


def build_catalog_renderers(catalog_root: str, srate: float = 48000.0,
                            only: str = "", segment_len: int = 1 << 16,
                            device=None):
    """Specialize every vectorizable catalog plugin once.

    Returns ({slug: renderer}, {slug: reason skipped}), so callers can
    render (and time) repeatedly without paying re-specialization.  JSFX
    plugins get BatchRenderer, the Faust five FaustBatchRenderer."""
    from ..catalog import discover, select

    renderers: Dict[str, Any] = {}
    skipped: Dict[str, str] = {}
    for spec in select(discover(catalog_root), only):
        if spec.plugin_type != "jsfx":
            try:
                renderers[spec.slug] = FaustBatchRenderer(
                    spec.slug, srate=srate, device=device)
            except ValueError as exc:    # no module of that name
                skipped[spec.slug] = str(exc)
            continue
        try:
            renderers[spec.slug] = BatchRenderer(
                spec.load_program(), srate=srate, segment_len=segment_len,
                device=device)
        except SpecializeError as exc:
            skipped[spec.slug] = str(exc)
    return renderers, skipped


def _upload(x: np.ndarray, nch: int, device, lead: tuple = ()):
    """The first nch channels of x [ch, T] (channel 0 repeated where x has
    fewer) as f32 on the device, with `lead` axes in front."""
    T = x.shape[1]
    xf = x[:nch] if x.shape[0] >= nch else np.broadcast_to(x[:1], (nch, T))
    xf = np.ascontiguousarray(xf, np.float32).reshape(lead + (nch, T))
    return torch.from_numpy(xf).to(device)


def _one_file(renderer):
    """The renderer's whole render of one file [nch, T] from its staging,
    behind its loop(n) ladder (`BatchRenderer.render_files`): run(x) ->
    (y f32 [nch, T], None)."""

    def run(x32):
        return renderer.render_files(x32[None])[0], None

    return run


def catalog_stacked_render(renderers: Dict[str, Any], x: np.ndarray,
                           groups=None, plan=None):
    """Render one input x [ch, T] through many plugins.

    The renderers are planned in groups: by default groups of five, as the
    reference fuses them, and a group of its own for each heavy kernel (a
    coupled @block or a hop section), as the reference gives one; a
    group's renderers run in turn, a JSFX plugin's behind its loop(n)
    ladder.  Inputs are staged on the device once: per channel count for
    the audio, kept in `plan` across calls where one is given, and per
    plugin for its carry, control and draws, in its renderer.  Returns
    ({slug: device audio [nch, T]}, number of groups)."""
    T = int(x.shape[1])
    entries = {} if plan is None else plan.setdefault(("entries", T), {})
    x_dev: Dict[int, Any] = {} if plan is None \
        else plan.setdefault(("xdev", T), {})
    for slug, r in renderers.items():
        if slug in entries:
            continue
        if r.nch not in x_dev:
            x_dev[r.nch] = _upload(x, r.nch, r.device)
        if r.is_faust:
            entries[slug] = (r.raw_render(T), (x_dev[r.nch],))
            continue
        r.staged(1, T)
        entries[slug] = (_one_file(r), (x_dev[r.nch],))

    if groups is None:
        # group from THIS call's renderers: a shared plan's entries hold
        # every slug ever staged
        heavy = [s for s in renderers if s in entries
                 and not renderers[s].is_faust
                 and renderers[s].kernel.has_device_view]
        light = [s for s in renderers if s in entries and s not in heavy]
        groups = [light[i:i + 5] for i in range(0, len(light), 5)]
        groups += [[s] for s in heavy]
    groups = [[s for s in g if s in entries] for g in groups]
    groups = [g for g in groups if g]

    outs: Dict[str, Any] = {}
    for group in groups:
        for s in group:
            fn, inputs = entries[s]
            outs[s] = fn(*inputs)[0]
    return outs, len(groups)


def catalog_batch_render(catalog_root: str, x: np.ndarray,
                         srate: float = 48000.0, only: str = "",
                         segment_len: int = 1 << 16, renderers=None,
                         device=None):
    """Render the same input x [ch, T] through every vectorizable catalog
    plugin as a batch of one file; returns ({slug: device audio [1, nch,
    T]}, {slug: reason skipped}).  Pass a prebuilt `renderers` map (from
    build_catalog_renderers) to skip re-specialization."""
    skipped: Dict[str, str] = {}
    if renderers is None:
        renderers, skipped = build_catalog_renderers(
            catalog_root, srate=srate, only=only, segment_len=segment_len,
            device=device)
    outs = {}
    x_dev: Dict[int, Any] = {}      # one upload per channel count
    for slug, r in renderers.items():
        if r.nch not in x_dev:
            x_dev[r.nch] = _upload(x, r.nch, r.device, lead=(1,))
        outs[slug] = r.render_files(x_dev[r.nch])
    return outs, skipped
