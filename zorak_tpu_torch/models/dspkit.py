"""PyTorch DSP building blocks for the Faust-family plugin modules.

Counterpart of zorak_tpu/models/dspkit.py.  Everything is f64 and
[..., T]-shaped with time last; any leading dims are a batch.

- one-poles, leaky integrators, max-hold followers and biquads are linear
  (or max-plus) recurrences, run on the hand-written CUDA kernels of K9
  (kernels/dsp_scan.py: chunked scans) on the GPU and as the doubling
  ladders on the CPU;
- the switching (attack/release) one-pole is not associative and runs on
  the hand-written CUDA kernel (kernels/switching_scan.py) on the GPU;
- FIRs are f64 conv1d; Faust's int32 LCG noise is K9's jump-ahead kernel
  on the GPU.

Scalar helpers take Python floats (control values) or tensors (signals)
and return the same kind.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import dsp_scan as DS
# si.lag_ud / si.onePoleSwitching: the pole depends on rise vs fall, so it
# is genuinely sequential; the CUDA kernel on the GPU, the plain loop on
# the CPU, with the leading axes as the kernel's lanes
from ..kernels.switching_scan import switching_onepole

F64 = torch.float64


def db2lin(db):
    if isinstance(db, torch.Tensor):
        return torch.pow(10.0, db / 20.0)
    return 10.0 ** (db / 20.0)


def lin2db(x, floor=1e-30):
    return 20.0 * torch.log10(torch.clamp(x, min=floor))


def clamp(x, lo, hi):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, min=lo, max=hi)
    return min(max(x, lo), hi)


def smoothstep01(x):
    u = clamp(x, 0.0, 1.0)
    return u * u * (3.0 - 2.0 * u)


def ms2pole(ms, srate):
    if isinstance(ms, torch.Tensor):
        return torch.exp(-1.0 / (srate * (ms / 1000.0)))
    return math.exp(-1.0 / (srate * (ms / 1000.0)))


def hz2pole(hz, srate):
    if isinstance(hz, torch.Tensor):
        return torch.exp(-2.0 * math.pi * torch.clamp(hz, min=1e-3) / srate)
    return math.exp(-2.0 * math.pi * max(hz, 1e-3) / srate)


# ---------------------------------------------------------------------------
# recurrences (K9: kernels/dsp_scan.py)


def onepole(x, pole, z0=0.0):
    """y[t] = (1-pole)*x[t] + pole*y[t-1]  (si.smooth / onePoleExp)."""
    return DS.affine_scan(x, pole, z0, onepole=True)


def integrator(x, pole, z0=0.0):
    """y[t] = x[t] + pole*y[t-1]  (plain leaky accumulation)."""
    return DS.affine_scan(x, pole, z0, onepole=False)


def max_follower(x, rel_pole, z0=0.0):
    """y[t] = max(x[t], rel_pole*y[t-1])  (max-hold follower)."""
    return DS.maxplus_scan(x, rel_pole, z0)


def amp_follower_ar(x, att_sec, rel_sec, srate, z0=0.0):
    """Faust an.amp_follower_ar: abs + attack/release switching one-pole."""
    up = math.exp(-1.0 / (srate * max(att_sec, 1e-9)))
    dn = math.exp(-1.0 / (srate * max(rel_sec, 1e-9)))
    return switching_onepole(torch.abs(x), up, dn, z0)


def biquad_tf2(x, b0, b1, b2, a1, a2, s0=(0.0, 0.0)):
    """Transposed direct-form II biquad (fi.tf22t).

    y[t]  = b0*x + s1
    s1'   = b1*x - a1*y + s2
    s2'   = b2*x - a2*y
    """
    return DS.biquad_scan(x, b0, b1, b2, a1, a2, s0)


def rbj_coeffs(kind: str, fc, q, srate) -> Tuple:
    """RBJ biquad coefficients as used by VAR (ref: VAR .dsp rbjHP/LP/BP)."""
    fc = min(float(fc), 0.45 * srate)
    q = max(float(q), 0.001)
    w0 = 2.0 * math.pi * fc / srate
    cw = math.cos(w0)
    sw = math.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "hp":
        bb = ((1 + cw) / 2, -(1 + cw), (1 + cw) / 2)
    elif kind == "lp":
        bb = ((1 - cw) / 2, 1 - cw, (1 - cw) / 2)
    elif kind == "bp_skirt":
        bb = (sw / 2, 0.0 * sw, -sw / 2)
    else:
        raise ValueError(kind)
    a0 = 1 + alpha
    return (bb[0] / a0, bb[1] / a0, bb[2] / a0, (-2 * cw) / a0, (1 - alpha) / a0)


# ---------------------------------------------------------------------------
# FIR / delay


def delay(x, samples: int):
    """Static integer delay with zero history."""
    if samples <= 0:
        return x
    n = x.shape[-1]
    if samples >= n:
        return torch.zeros_like(x)
    return F.pad(x[..., : n - samples], (samples, 0))


def fir(x, taps):
    """Causal FIR y[t] = sum_k taps[k] * x[t-k], zero history (f64 conv1d)."""
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    k = taps.shape[-1]
    xf = F.pad(x.reshape(-1, 1, x.shape[-1]), (k - 1, 0))
    y = F.conv1d(xf, taps.flip(-1).reshape(1, 1, k))
    return y.reshape(x.shape)


def gaussian_fir_taps(sigma_samples, radius: int, device=None):
    """GTS kernel: normalized symmetric Gaussian over [-R..R]
    (ref: Gaussian Transient Shaper (GTS).dsp gaussKernel)."""
    dev = resolve_device(device)
    sigma = max(float(sigma_samples), 0.25)
    i = torch.arange(-radius, radius + 1, dtype=F64, device=dev)
    g = torch.exp(-0.5 * torch.square(i / sigma))
    g0 = 1.0  # exp(0)
    rest = torch.sum(torch.exp(-0.5 * torch.square(
        torch.arange(1, radius + 1, dtype=F64, device=dev) / sigma)))
    return g / (g0 + 2.0 * rest + 1e-20)


# ---------------------------------------------------------------------------
# noise (Faust no.noise: int32 LCG)


def lcg_noise(n: int, seed: int = 12345, dtype=F64, device=None):
    """Faust-style noise in (-1, 1): x_k = lcg^(k+1)(seed)/2^31 as int32,
    computed on the device; the same stream as zorak_tpu's host loop, bit
    for bit."""
    return DS.lcg_noise(n, seed, dtype, resolve_device(device))
