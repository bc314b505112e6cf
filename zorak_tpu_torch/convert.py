"""Carry parameters and state across from the JAX package, as numpy.

The Faust modules hold no trained weights.  Their parameters are the
`values` dict (control values per render) and their state is the
followers' and filters' initial `z0` / `s0`.  JAX-side values may be
floats, numpy scalars or 0-d arrays; the port takes Python floats and
tensors on its device.

A JSFX plugin's state is a `ShadowState` (vars, sliders, spl registers,
mem) and, mid-render, a vector kernel's carry `(svec, rings)`.
`shadow_state_from_numpy` and `carry_from_numpy` rebuild both on the
port's side from plain numpy, so that two renders can start from the
same numbers; `devexec_carry_from_numpy` does the same for the sequential
device executor's carry `(vars, mem)`.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import resolve_device


def values_from_jax(values: Mapping) -> Dict[str, float]:
    """A JAX-side values dict -> the port's dict of Python floats."""
    return {str(k): float(np.asarray(v)) for k, v in values.items()}


def state_from_numpy(state, device=None, dtype=torch.float64):
    """Numpy initial state -> tensors on the chosen device.

    `state` is an array or scalar (a follower's z0), or a tuple or list of
    them (a biquad's s0 pair); the structure is kept.
    """
    dev = resolve_device(device)
    if isinstance(state, (tuple, list)):
        return type(state)(state_from_numpy(v, dev, dtype) for v in state)
    return torch.as_tensor(np.asarray(state, dtype=np.float64),
                           dtype=dtype, device=dev)


def carry_from_numpy(kernel, svec, rings=None):
    """A vector kernel's carry from numpy: `svec` [n] and `rings`
    {(origin, mod): [mod]}, e.g. a JAX kernel's `initial_carry()` or the
    carry one of its renders returned, for the port's `kernel` (a
    `SpecializedSampleKernel` planned from the same program and state).
    A coupled kernel's carry, or a hop kernel's, comes as one argument,
    the JAX package's ((svec, rings), bvars, bmem): its var slots are laid
    out alike, and the port's device heap is the head of the JAX one (the
    plugin heap, then, where the section uses them, the gmem window, the
    MIDI out table and the message bus's OUT table and queues; the JAX
    tail beyond holds nothing the port's sections read).  A hop kernel's render resumes at the counter's phase
    the kernel tracks (`_hop_phase`), as the JAX kernel's does.

    Raises if the two plans do not carry the same scalars and regions.
    """
    if rings is not None:
        return kernel.device_carry(_sample_carry(kernel, svec, rings))
    if not kernel.has_device_view:
        raise ValueError("a coupled or hop carry takes a coupled or hop "
                         "kernel")
    (svec, rings), bvars, bmem = svec
    prog = kernel._block_prog if kernel.coupled else kernel._hop_prog
    n_vars, total = prog.n_vars, prog.total_mem
    bvars = np.asarray(bvars, dtype=np.float64)
    bmem = np.asarray(bmem, dtype=np.float64)
    if bvars.shape != (n_vars,) or bmem.ndim != 1 or len(bmem) < total:
        raise ValueError(f"bvars {bvars.shape} and bmem {bmem.shape} do not "
                         f"hold {n_vars} slots and {total} heap cells")
    return kernel.device_carry((_sample_carry(kernel, svec, rings), bvars,
                                bmem[:total]))


def _sample_carry(kernel, svec, rings):
    """(svec, rings) as checked numpy arrays for the kernel's plan."""
    svec = np.asarray(svec, dtype=np.float64)
    if svec.shape != (len(kernel.carried_vars),):
        raise ValueError(f"svec has shape {svec.shape}, the kernel carries "
                         f"{len(kernel.carried_vars)} scalars")
    rings = {(int(r[0]), int(r[1])): np.asarray(a, dtype=np.float64)
             for r, a in rings.items()}
    if sorted(rings) != sorted(kernel.carry_regions):
        raise ValueError(f"rings cover {sorted(rings)}, the kernel carries "
                         f"{sorted(kernel.carry_regions)}")
    for (origin, mod), a in rings.items():
        if a.shape != (mod,):
            raise ValueError(f"ring ({origin}, {mod}) has shape {a.shape}")
    return svec, rings


def shadow_state_from_numpy(state, variables: Mapping, sliders, mem,
                            spl=None):
    """Overwrite a port `ShadowState` with another package's numbers:
    `variables` {name: value}, `sliders` [64], `mem` (the whole heap
    array: `mem_used` may end below tables that @init wrote) and
    optionally `spl` [64].  Returns `state`."""
    state.V.clear()
    state.V.update({str(k): float(v) for k, v in variables.items()})
    state.sliders = [float(v) for v in sliders]
    mem = np.asarray(mem, dtype=np.float64)
    state.mem_ensure(len(mem))
    state.mem[:len(mem)] = mem
    if spl is not None:
        state.spl = [float(v) for v in spl]
    return state


def devexec_carry_from_numpy(kernel, carry, mem_size: int, rng_state=None):
    """A JAX `DeviceExecKernel`'s carry `(vars, mem)` for the port's
    `kernel` (a `DeviceExecKernel` built from the same program and state),
    as tensors on its device.

    The var slots are laid out alike (the reference's table, the high-water
    slot last).  The JAX heap row is [plugin heap of `mem_size` cells | gmem
    window | MIDI out table | draw pool | ...] (`mem_size` is the JAX
    kernel's `sample.mem_size`; the window is there where a section uses
    gmem, as long as the snapshot's gmem); the port's is [plugin heap |
    gmem window | MIDI out table] and its pool a table of its own, so the
    plugin heap, the window and the MIDI out table are moved across,
    re-laid out as `_migrate_carry` does where the two heaps differ in
    size: the port's kernel climbs to the JAX heap where that is larger,
    and a smaller one is zero-filled above.  rng_state:
    the JAX kernel's `_rng_prestate` (the generator its last pool came
    from), so that the port's next render continues the JAX generator by
    the draws the carry's cursor counts.
    """
    bv, bm = carry
    bv = np.asarray(bv, dtype=np.float64)
    bm = np.asarray(bm, dtype=np.float64)
    samp = kernel.sample
    mem_size = int(mem_size)
    G, mo = samp.gmem_cells, samp.midi_out_cells
    if bv.shape != (samp.n_vars,) or bm.ndim != 1 \
            or len(bm) < mem_size + G + mo:
        raise ValueError(f"vars {bv.shape} and mem {bm.shape} do not hold "
                         f"{samp.n_vars} slots and a heap of {mem_size} "
                         "cells with its gmem window and MIDI out table")
    kernel.grow_to(mem_size)
    samp = kernel.sample
    out = np.zeros(samp.total_mem, dtype=np.float64)
    out[:mem_size] = bm[:mem_size]
    out[samp.gmem_base:samp.gmem_base + G] = bm[mem_size:mem_size + G]
    out[samp.midi_out_base:samp.midi_out_base + mo] = \
        bm[mem_size + G:mem_size + G + mo]
    if rng_state is not None:
        state = (np.array(rng_state[0], dtype=np.uint32), int(rng_state[1]))
        kernel._rng_state = kernel._rng_prestate = state
    return (torch.from_numpy(bv.copy()).to(kernel.device),
            torch.from_numpy(out).to(kernel.device))
