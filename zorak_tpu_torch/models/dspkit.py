"""PyTorch DSP building blocks for the Faust-family plugin modules.

Counterpart of zorak_tpu/models/dspkit.py.  Everything is f64 and
[..., T]-shaped with time last; any leading dims are a batch.

- one-poles, leaky integrators, max-hold followers and biquads are linear
  (or max-plus) recurrences, run here as log-depth doubling scans over the
  time axis in plain PyTorch: ceil(log2 T) stages of a few tensor ops each;
- the switching (attack/release) one-pole is not associative and runs on
  the hand-written CUDA kernel (kernels/switching_scan.py) on the GPU;
- FIRs are f64 conv1d; Faust's int32 LCG noise is an affine doubling scan
  in int64 on the device.

Scalar helpers take Python floats (control values) or tensors (signals)
and return the same kind.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
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
# recurrences


def _coef(c, like: torch.Tensor) -> torch.Tensor:
    """A per-sample coefficient tensor shaped like `like` (a fresh copy)."""
    c = torch.as_tensor(c, dtype=like.dtype, device=like.device)
    return c.broadcast_to(like.shape).clone()


def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the maps z -> a[t]*z + b[t] along the last axis.

    Returns (A, B) with A[t] = a[0]*...*a[t] and B[t] the recurrence's
    value at t from a zero start.  Hillis-Steele doubling: at stride d every
    t >= d folds in the composite ending at t-d.  Consumes a and b.
    """
    n, d = a.shape[-1], 1
    while d < n:
        b[..., d:] = a[..., d:] * b[..., :-d] + b[..., d:]
        a[..., d:] = a[..., :-d] * a[..., d:]
        d *= 2
    return a, b


def onepole(x, pole, z0=0.0):
    """y[t] = (1-pole)*x[t] + pole*y[t-1]  (si.smooth / onePoleExp)."""
    a = _coef(pole, x)
    A, B = _affine_scan(a, (1.0 - a) * x)
    return A * z0 + B


def integrator(x, pole, z0=0.0):
    """y[t] = x[t] + pole*y[t-1]  (plain leaky accumulation)."""
    A, B = _affine_scan(_coef(pole, x), x.clone())
    return A * z0 + B


def max_follower(x, rel_pole, z0=0.0):
    """y[t] = max(x[t], rel_pole*y[t-1])  — max-plus doubling scan."""
    a, b = _coef(rel_pole, x), x.clone()
    n, d = x.shape[-1], 1
    while d < n:
        b[..., d:] = torch.maximum(b[..., :-d] * a[..., d:], b[..., d:])
        a[..., d:] = a[..., :-d] * a[..., d:]
        d *= 2
    return torch.maximum(a * z0, b)


def amp_follower_ar(x, att_sec, rel_sec, srate, z0=0.0):
    """Faust an.amp_follower_ar: abs + attack/release switching one-pole."""
    up = math.exp(-1.0 / (srate * max(att_sec, 1e-9)))
    dn = math.exp(-1.0 / (srate * max(rel_sec, 1e-9)))
    return switching_onepole(torch.abs(x), up, dn, z0)


def biquad_tf2(x, b0, b1, b2, a1, a2, s0=(0.0, 0.0)):
    """Transposed direct-form II biquad (fi.tf22t) via matrix doubling scan.

    y[t]  = b0*x + s1
    s1'   = b1*x - a1*y + s2
    s2'   = b2*x - a2*y

    The state recurrence s' = M s + v*x[t] with constant M = [[-a1, 1],
    [-a2, 0]] scans as (2x2 matrix, 2-vector) pairs, kept as six [..., T]
    component tensors; y comes from the state before each sample.
    """
    # M's entries (p q / r s) and the input vector (u, w) at every t
    p, q = _coef(-a1, x), _coef(1.0, x)
    r, s = _coef(-a2, x), _coef(0.0, x)
    u, w = (b1 - a1 * b0) * x, (b2 - a2 * b0) * x
    n, d = x.shape[-1], 1
    while d < n:
        # later (at t) composed after earlier (at t-d): M2 @ M1, M2 @ v1 + v2
        p1, q1, r1, s1 = p[..., :-d], q[..., :-d], r[..., :-d], s[..., :-d]
        p2, q2, r2, s2 = p[..., d:], q[..., d:], r[..., d:], s[..., d:]
        u1, w1 = u[..., :-d], w[..., :-d]
        nu = p2 * u1 + q2 * w1 + u[..., d:]
        nw = r2 * u1 + s2 * w1 + w[..., d:]
        np_, nq = p2 * p1 + q2 * r1, p2 * q1 + q2 * s1
        nr, ns = r2 * p1 + s2 * r1, r2 * q1 + s2 * s1
        u[..., d:], w[..., d:] = nu, nw
        p[..., d:], q[..., d:], r[..., d:], s[..., d:] = np_, nq, nr, ns
        d *= 2
    s_init0, s_init1 = float(s0[0]), float(s0[1])
    s1_after = p * s_init0 + q * s_init1 + u      # state s1 AFTER sample t
    s1_prev = torch.cat([torch.full_like(x[..., :1], s_init0),
                         s1_after[..., :-1]], dim=-1)
    return b0 * x + s1_prev


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

_LCG_A = 1103515245
_LCG_C = 12345
_MASK32 = 0xFFFFFFFF


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """a*b mod 2^32 for int64 values in [0, 2^32), with no int64 overflow:
    a splits into 16-bit halves so no partial product reaches 2^49."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _MASK32


def lcg_noise(n: int, seed: int = 12345, dtype=F64, device=None):
    """Faust-style noise in (-1, 1): x_k = lcg^(k+1)(seed)/2^31 as int32.

    Computed on the device: an inclusive doubling scan composes the affine
    LCG step s -> A*s + C (mod 2^32) into the map of k+1 steps for every k,
    in int64 masked to 32 bits, and applies it to the seed.  The same
    stream as zorak_tpu's host loop, bit for bit.
    """
    dev = resolve_device(device)
    a = torch.full((n,), _LCG_A, dtype=torch.int64, device=dev)
    c = torch.full((n,), _LCG_C, dtype=torch.int64, device=dev)
    d = 1
    while d < n:
        # later map (a2, c2) after earlier (a1, c1): s -> a2*a1*s + a2*c1 + c2
        c[d:] = (_mulmod32(a[d:], c[:-d]) + c[d:]) & _MASK32
        a[d:] = _mulmod32(a[d:], a[:-d])
        d *= 2
    s = (_mulmod32(a, seed & _MASK32) + c) & _MASK32
    s = torch.where(s < (1 << 31), s, s - (1 << 32))
    return s.to(F64).div_(float(1 << 31)).to(dtype)
