"""The catalog's five Faust plugins as PyTorch modules.

Counterpart of zorak_tpu/models/faustmods.py (sources cited per class).
Parameters are static per render (offline semantics: Faust's si.smoo ramps
are settled — smoother states initialize at their targets).  Every module
is an `nn.Module` with no weights:

    params:  list of Param (name, default, lo, hi, step, unit)
    n_in / n_out, latency_frames
    forward(x, values, srate) -> y     # f64 [..., ch, T] in, [..., ch, T] out
    render = forward

Leading dims of x are a batch (files); channels are indexed as
x[..., c, :].  The render runs on x's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from . import dspkit as K

F64 = torch.float64


@dataclass(frozen=True)
class Param:
    name: str
    default: float
    lo: float
    hi: float
    step: float = 0.01
    unit: str = ""
    choices: tuple = ()


class FaustModule(nn.Module):
    name = "module"
    slug = ""
    params: List[Param] = []
    n_in = 2
    n_out = 2
    latency_frames = 0

    def values(self, overrides: Dict[str, float] | None = None) -> Dict[str, float]:
        vals = {p.name: p.default for p in self.params}
        if overrides:
            vals.update(overrides)
        return vals

    def forward(self, x: torch.Tensor, values: Dict[str, float],
                srate: float) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def render(self, x: torch.Tensor, values: Dict[str, float],
               srate: float) -> torch.Tensor:
        """The JAX package's name for forward."""
        return self(x, values, srate)


def _ch(x: torch.Tensor, c: int) -> torch.Tensor:
    return x[..., c, :]


def _stack(chans) -> torch.Tensor:
    return torch.stack(list(chans), dim=-2)


class GTS(FaustModule):
    """Gaussian Transient Shaper — 257-tap Gaussian FIR; attack = aligned
    dry minus blur (ref: plugins/Dynamics/GTS/src/Gaussian Transient
    Shaper (GTS).dsp)."""

    name = "Gaussian Transient Shaper"
    slug = "GTS"
    RADIUS = 128
    latency_frames = 128
    params = [
        Param("sigma_ms", 2.0, 0.1, 8.0, 0.01, "ms"),
        Param("attack_db", 0.0, -12.0, 12.0, 0.1, "dB"),
        Param("sustain_db", 0.0, -12.0, 12.0, 0.1, "dB"),
        Param("mix", 1.0, 0.0, 1.0, 0.01),
        Param("output_db", 0.0, -12.0, 12.0, 0.1, "dB"),
    ]

    def forward(self, x, v, srate):
        sigma = max(v["sigma_ms"] * srate * 0.001, 0.25)
        taps = K.gaussian_fir_taps(sigma, self.RADIUS, device=x.device)
        sustain = K.fir(x, taps.flip(-1))  # symmetric kernel; causal over 2R+1
        aligned = K.delay(x, self.RADIUS)
        attack = aligned - sustain
        a_g = K.db2lin(v["attack_db"])
        s_g = K.db2lin(v["sustain_db"])
        shaped = a_g * attack + s_g * sustain
        out_g = K.db2lin(v["output_db"])
        return (v["mix"] * shaped + (1.0 - v["mix"]) * aligned) * out_g


class ModTilt(FaustModule):
    """Envelope tilt shaper with linked-stereo detector
    (ref: plugins/Dynamics/ModTilt/src/ModTilt.dsp)."""

    name = "ModTilt"
    slug = "ModTilt"
    params = [
        Param("tilt_db", 0.0, -6.0, 3.0, 0.1, "dB"),
        Param("pivot_hz", 3.0, 2.0, 5.0, 0.01, "Hz"),
        Param("mix", 1.0, 0.0, 1.0, 0.001),
    ]

    @staticmethod
    def _a_from_hz(hz, srate):
        return 1.0 - math.exp(-2.0 * math.pi * max(hz, 0.001) / srate)

    def forward(self, x, v, srate):
        # faust onepole(a): y = a*x + (1-a)*y'  ->  pole = 1-a
        def op(sig, a):
            return K.onepole(sig, 1.0 - a)

        a_env = self._a_from_hz(25.0, srate)
        a_base = self._a_from_hz(1.0, srate)
        a_piv = self._a_from_hz(v["pivot_hz"], srate)
        a_ratio = 0.05
        a_trim = self._a_from_hz(0.2, srate)
        depth = 0.75
        g_hi = K.db2lin(v["tilt_db"] * 0.5)
        g_lo = K.db2lin(-v["tilt_db"] * 0.5)

        x0, x1 = _ch(x, 0), _ch(x, 1)
        mono = 0.5 * (x0 + x1)
        env2 = op(mono * mono, a_env)
        env = torch.sqrt(torch.clamp(env2, min=0.0))
        base = op(env, a_base)
        m = env - base
        m_lo = op(m, a_piv)
        m_hi = m - m_lo
        m2 = m * (1.0 - depth) + (m_lo * g_lo + m_hi * g_hi) * depth
        env_t = base + m2
        env_tp = torch.maximum(env_t, 0.05 * env)
        r0 = (env_tp + 1e-9) / (env + 1e-9)
        r0c = K.clamp(r0, 0.67, 1.5)
        r_s = 1.0 + op(r0c - 1.0, a_ratio)
        rdb = 20.0 * torch.log10(torch.clamp(r_s, min=1e-12))
        trim = K.db2lin(-op(rdb, a_trim))
        mix = v["mix"]
        y0 = (x0 * (1 - mix) + x0 * r_s * mix) * trim
        y1 = (x1 * (1 - mix) + x1 * r_s * mix) * trim
        return _stack([y0, y1])


class RED(FaustModule):
    """Reverb tail tamer: ducks wet 1/2 against sidechain ref 5/6
    (ref: plugins/Dynamics/RED/src/Reverb Expanding Downwards (RED).dsp)."""

    name = "Reverb Expanding Downwards"
    slug = "RED"
    n_in = 6
    n_out = 6
    params = [
        Param("amount_db", 12.0, 0.0, 24.0, 0.1, "dB"),
        Param("sens_pct", 50.0, 0.0, 100.0, 1.0, "%"),
        Param("release_ms", 350.0, 50.0, 1200.0, 1.0, "ms"),
    ]

    def forward(self, x, v, srate):
        wetL, wetR = _ch(x, 0), _ch(x, 1)
        refL, refR = _ch(x, 4), _ch(x, 5)
        sens = v["sens_pct"] / 100.0
        rel_ms = v["release_ms"]
        thr_db = 18.0 - sens * 21.0
        ratio = 1.2 + sens * 3.0
        knee_db = 10.0 - sens * 6.0
        grace_ms = K.clamp(rel_ms * 0.25, 60.0, 200.0)

        p = lambda ms: K.ms2pole(ms, srate)  # noqa: E731
        floor_lin = 10.0 ** (-80.0 / 20.0)
        dry_on = 10.0 ** (-50.0 / 20.0)
        ref_off = 10.0 ** (-60.0 / 20.0)

        wet_env2 = K.onepole(0.5 * (wetL * wetL + wetR * wetR), p(35.0))
        ref_env2 = K.onepole(0.5 * (refL * refL + refR * refR), p(35.0))
        Ey = torch.clamp(torch.sqrt(torch.clamp(wet_env2, min=0.0)), min=floor_lin)
        Ex = torch.clamp(torch.sqrt(torch.clamp(ref_env2, min=0.0)), min=floor_lin)

        dryA = (Ex > dry_on).to(F64)
        offA = (Ex <= ref_off).to(F64)
        offA_s = K.onepole(offA, p(grace_ms))
        tail_w = (1.0 - offA) + offA * K.smoothstep01(offA_s)

        rdB = K.lin2db((Ey + 1e-12) / (Ex + 1e-12))
        over = rdB - thr_db
        over_eff = torch.where(
            over <= 0.0, 0.0,
            over * K.smoothstep01(K.clamp(over / max(knee_db, 0.001),
                                          0.0, 1.0)))
        tgt0 = torch.where(over_eff > 0.0,
                           torch.clamp(over_eff * ratio, max=v["amount_db"]),
                           0.0)
        tgt_db = K.onepole(tgt0 * tail_w, p(25.0))

        dryA_s = K.onepole(dryA, p(10.0))
        tgt_hold = torch.maximum(tgt_db, K.onepole(tgt_db, p(80.0)))
        tgt_pin = (1.0 - dryA) * tgt_hold + dryA * tgt_db

        gr_norm = K.amp_follower_ar(tgt_pin, 12.0 / 1000.0, rel_ms / 1000.0, srate)
        gr_fast = K.amp_follower_ar(tgt_pin, 12.0 / 1000.0, 70.0 / 1000.0, srate)
        gr_db = (1.0 - dryA_s) * gr_norm + dryA_s * gr_fast
        g = K.db2lin(-gr_db)
        return _stack([wetL * g, wetR * g, _ch(x, 2), _ch(x, 3), refL, refR])


# Savitzky-Golay predictor taps: coefficient at delay d (from the .dsp)
_SG = {
    11: (10, np.array([-36, 9, 44, 69, 84, 89, 84, 69, 44, 9, -36]) / 429.0),
    15: (8, np.array([-78, -13, 42, 87, 122, 147, 162, 167, 162, 147, 122,
                      87, 42, -13, -78])[::-1] / 1105.0),
    21: (5, np.array([-171, -76, 9, 84, 149, 204, 249, 284, 309, 324, 329,
                      324, 309, 284, 249, 204, 149, 84, 9, -76, -171])[::-1] / 3059.0),
    31: (0, np.array([-406, -261, -126, -1, 114, 219, 314, 399, 474, 539,
                      594, 639, 674, 699, 714, 719, 714, 699, 674, 639, 594,
                      539, 474, 399, 314, 219, 114, -1, -126, -261, -406])[::-1] / 9889.0),
}


def _sg_kernel(n: int) -> np.ndarray:
    """Causal FIR kernel (index = delay) for the SG predictor of size n."""
    start_delay, coeffs = _SG[n]
    # coeffs[i] applies at delay start_delay + i (ascending delay)
    k = np.zeros(start_delay + len(coeffs))
    k[start_delay:] = coeffs
    return k


class ClickBeGoneSG(FaustModule):
    """Savitzky-Golay predictor click remover (ref:
    plugins/Restoration/ClickBeGoneSG/src/Click-Be-Gone (SG).dsp)."""

    name = "Click-Be-Gone (SG)"
    slug = "ClickBeGoneSG"
    params = [
        Param("amount", 50.0, 0.0, 100.0, 1.0, "%"),
        Param("sensitivity", 50.0, 0.0, 100.0, 1.0, "%"),
        Param("hpf_hz", 1500.0, 300.0, 6000.0, 10.0, "Hz"),
        Param("mode", 1.0, 0.0, 2.0, 1.0, choices=("Fast", "Medium", "Slow")),
        Param("monitor", 0.0, 0.0, 1.0, 1.0, choices=("Output", "Delta")),
    ]

    def forward(self, x, v, srate):
        amount = v["amount"] / 100.0
        sens = v["sensitivity"] / 100.0
        mode = int(v["mode"])

        ratio_thr = (6.0 - 4.0 * sens) * (1.12, 1.00, 0.92)[mode]
        err_thr = (0.25 - 0.17 * sens) * (1.18, 1.00, 0.90)[mode]
        mix_mul = (0.85, 1.00, 1.08)[mode]
        hold_mul = (0.75, 1.00, 1.35)[mode]
        env_rel_ms = (30.0 - 20.0 * sens) * (0.85, 1.00, 1.10)[mode]
        base_ms = (300.0 - 180.0 * sens) * (0.85, 1.00, 1.10)[mode]
        mix_max = min((0.60 + 0.32 * amount) * mix_mul, 0.96)
        holdN = max((8 + amount * 32) * hold_mul, 4)

        env_rel = math.exp(-1000.0 / (srate * env_rel_ms))
        base_a = 1.0 - math.exp(-1000.0 / (srate * base_ms))
        a = math.exp(-2.0 * math.pi * v["hpf_hz"] / srate)

        L, R = _ch(x, 0), _ch(x, 1)

        # JSFX HPF: y = a*(x - x') + a*y'  (leaky differentiator)
        def hpf(sig):
            u = a * (sig - K.delay(sig, 1))
            return K.integrator(u, a)

        ehf = torch.maximum(torch.abs(hpf(L)), torch.abs(hpf(R)))
        env = K.max_follower(ehf, env_rel)
        base = K.onepole(env, 1.0 - base_a)
        ratio = env / (base + 1e-12)

        xC_L, xC_R = K.delay(L, 15), K.delay(R, 15)
        small_n = (11, 15, 21)[mode]
        large_n = (15, 21, 31)[mode]
        ks, kl = _sg_kernel(small_n), _sg_kernel(large_n)
        small_L, small_R = K.fir(L, ks), K.fir(R, ks)
        large_L, large_R = K.fir(L, kl), K.fir(R, kl)

        eA = (torch.maximum(torch.abs(xC_L - small_L), torch.abs(xC_R - small_R))
              / (torch.maximum(torch.abs(small_L), torch.abs(small_R)) + 1e-6))
        eB = (torch.maximum(torch.abs(xC_L - large_L), torch.abs(xC_R - large_R))
              / (torch.maximum(torch.abs(large_L), torch.abs(large_R)) + 1e-6))
        useA = eA <= eB
        pred_L = torch.where(useA, small_L, large_L)
        pred_R = torch.where(useA, small_R, large_R)
        e_norm = torch.where(useA, eA, eB)

        trig = ((ratio > ratio_thr) & (e_norm > err_thr)).to(F64)
        T = 1e-3
        rel_hold = math.exp(math.log(T) / (holdN + 1e-12))
        hold_env = K.max_follower(trig, rel_hold)
        active = hold_env > T

        rng = err_thr * 3.0
        mix_base = torch.where(active,
                               K.clamp((e_norm - err_thr) / (rng + 1e-12), 0.0, 1.0),
                               0.0)
        mix = mix_base * mix_max
        outL = xC_L * (1 - mix) + pred_L * mix
        outR = xC_R * (1 - mix) + pred_R * mix
        if int(v["monitor"]):
            return _stack([outL - xC_L, outR - xC_R])
        return _stack([outL, outR])


class VAR(FaustModule):
    """Vocal Air Recovery: curvature-driven HF expansion + noise halo
    (ref: plugins/Restoration/VAR/src/Vocal Air Recovery (VAR).dsp)."""

    name = "Vocal Air Recovery"
    slug = "VAR"
    params = [
        Param("air_amount", 35.0, 0.0, 100.0, 1.0, "%"),
        Param("sensitivity", 50.0, 0.0, 100.0, 1.0, "%"),
        Param("floor_db", -60.0, -90.0, -30.0, 1.0, "dB"),
    ]

    def forward(self, x, v, srate):
        amount = v["air_amount"] / 100.0
        sens = v["sensitivity"] / 100.0
        floor_lin = 10.0 ** (v["floor_db"] / 20.0)

        max_exp_lin = 10.0 ** ((5.0 * amount) / 20.0)
        air_mix = 0.25 * amount
        air_base = 10.0 ** (-34.0 / 20.0)
        thrN = 0.18 - 0.13 * sens

        def bq(sig, kind, fc, q):
            b0, b1, b2, a1, a2 = K.rbj_coeffs(kind, fc, q, srate)
            return K.biquad_tf2(sig, b0, b1, b2, a1, a2)

        inL, inR = _ch(x, 0), _ch(x, 1)
        detL = bq(inL, "bp_skirt", 9500.0, 1.0)
        detR = bq(inR, "bp_skirt", 9500.0, 1.0)

        hf_lvl = K.onepole(0.5 * (torch.abs(detL) + torch.abs(detR)),
                           math.exp(-1.0 / (srate * 0.14)))
        gate = K.smoothstep01((hf_lvl / (floor_lin + 1e-12) - 1.0) / 1.0)

        det_a = math.exp(-2.0 * math.pi * min(8500.0, 0.45 * srate) / srate)
        sm2L = K.onepole(K.onepole(detL, det_a), det_a)
        sm2R = K.onepole(K.onepole(detR, det_a), det_a)

        def curv(s0):
            s1 = K.delay(s0, 1)
            s2 = K.delay(s0, 2)
            lap = s0 - 2.0 * s1 + s2
            den = torch.abs(s0) + 2.0 * torch.abs(s1) + torch.abs(s2) + 1e-12
            return torch.abs(lap) / den

        curvN = 0.5 * (curv(sm2L) + curv(sm2R))
        env = K.switching_onepole(
            curvN,
            math.exp(-1.0 / (srate * 0.0025)),
            math.exp(-1.0 / (srate * 0.080)))

        u = torch.clamp(env / thrN - 1.0, min=0.0)
        t = (u / (1.0 + u)) * gate
        t2 = torch.pow(torch.clamp(t, min=1e-12), 1.8)
        g = 1.0 + t * (max_exp_lin - 1.0)

        hfL = bq(bq(inL, "hp", 11500.0, 0.707), "hp", 11500.0, 0.707)
        hfR = bq(bq(inR, "hp", 11500.0, 0.707), "hp", 11500.0, 0.707)

        n = x.shape[-1]
        nL = K.lcg_noise(n, seed=12345, device=x.device)
        nR = K.lcg_noise(n, seed=54321, device=x.device)
        airL = bq(nL, "bp_skirt", 16000.0, 1.2)
        airR = bq(nR, "bp_skirt", 16000.0, 1.2)
        air_gain = (t2 * air_base) * air_mix

        outL = inL + hfL * (g - 1.0) + airL * air_gain
        outR = inR + hfR * (g - 1.0) + airR * air_gain
        return _stack([outL, outR])
