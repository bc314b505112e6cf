"""Batch rendering of many files through one Faust module.

Counterpart of `FaustBatchRenderer` in zorak_tpu/parallel/batch.py.  The
JAX renderer vmaps the module over files; here the files are a batch
dimension written out, since the port's Faust modules take [..., ch, T].
The JSFX `BatchRenderer` is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import get_faust_module


class FaustBatchRenderer:
    """Faust-family catalog entry rendered whole-T (no carried segment
    state): `render_files` maps x [nf, nch, T] f32 to y [nf, nch, T] f32."""

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

    def render_files(self, x) -> torch.Tensor:
        """x [nf, nch, T] f32 (numpy or tensor) -> f32 tensor on the device.

        The module contract is f64 (matches the NumPy goldens); output
        rides as f32 like every other catalog entry.
        """
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if x.dim() != 3 or x.shape[1] != self.nch:
            raise ValueError(f"{self.slug} takes [nf, {self.nch}, T], "
                             f"got {tuple(x.shape)}")
        x64 = x.to(device=self.device, dtype=torch.float64)
        return self.mod(x64, self.values, self.srate).to(torch.float32)
