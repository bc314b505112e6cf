"""Carry the Faust modules' parameters and initial state across from JAX.

The Faust modules hold no trained weights.  Their parameters are the
`values` dict (control values per render) and their state is the
followers' and filters' initial `z0` / `s0`.  JAX-side values may be
floats, numpy scalars or 0-d arrays; the port takes Python floats and
tensors on its device.
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
