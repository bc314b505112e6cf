"""Sequential NumPy goldens for the five Faust plugins.

Each function is a direct sample-by-sample transcription of the reference
.dsp block diagram (sources cited per function), entirely independent of
the JAX modules in faustmods.py: explicit per-sample loops, scalar state,
zero-initialized delays/recursions — the way the Faust compiler would
execute the diagram.  They exist to be the numerical oracle the JAX
renders null-test against (ε = 1e-5), standing in for the reference's
compiled-Faust processor (ref: src/FaustJuceProcessor.cpp:462-481) since
no Faust compiler exists in this environment.

Documented divergences shared with the JAX modules:
  - parameters are settled (si.smoo ramps start at their targets),
  - VAR's two noise generators use seeds 12345/54321 (Faust's no.noise
    instances share one seed; the decorrelated pair is deliberate).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np


def _db2lin(db: float) -> float:
    return 10.0 ** (db / 20.0)


# ---------------------------------------------------------------------------
# GTS (ref: plugins/Dynamics/GTS/src/Gaussian Transient Shaper (GTS).dsp)

def gts_golden(x: np.ndarray, v: Dict[str, float], srate: float) -> np.ndarray:
    R = 128
    LEN = 2 * R + 1
    sigma = max(0.25, v["sigma_ms"] * srate * 0.001)

    # gaussKernel: coeff(k) = norm * g(|k - R|)
    g = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(R + 1)]
    norm = 1.0 / (g[0] + 2.0 * sum(g[1:]) + 1e-20)
    coeff = [norm * g[abs(k - R)] for k in range(LEN)]

    a_g = _db2lin(v["attack_db"])
    s_g = _db2lin(v["sustain_db"])
    mix = v["mix"]
    out_g = _db2lin(v["output_db"])

    coeff_v = np.asarray(coeff)
    nch, T = x.shape
    y = np.zeros_like(x, dtype=np.float64)
    for c in range(nch):
        xc = x[c].astype(np.float64)
        hist = np.zeros(LEN)          # hist[d] = x[n-d]
        dline = np.zeros(R + 1)       # de.delay(R, R)
        for n in range(T):
            hist[1:] = hist[:-1]
            hist[0] = xc[n]
            # fi.fir: sum_k coeff[k] * x[n-k]
            sustain = float(coeff_v @ hist)
            dline[1:] = dline[:-1]
            dline[0] = xc[n]
            aligned = dline[R]
            attack = aligned - sustain
            shaped = a_g * attack + s_g * sustain
            y[c, n] = (mix * shaped + (1.0 - mix) * aligned) * out_g
    return y


# ---------------------------------------------------------------------------
# ModTilt (ref: plugins/Dynamics/ModTilt/src/ModTilt.dsp)

def modtilt_golden(x: np.ndarray, v: Dict[str, float], srate: float) -> np.ndarray:
    def a_from_hz(hz):
        return 1.0 - math.exp(-2.0 * math.pi * max(hz, 0.001) / srate)

    a_env = a_from_hz(25.0)
    a_base = a_from_hz(1.0)
    a_piv = a_from_hz(v["pivot_hz"])
    a_ratio = 0.05
    a_trim = a_from_hz(0.2)
    depth = 0.75
    g_hi = _db2lin(v["tilt_db"] * 0.5)
    g_lo = _db2lin(-v["tilt_db"] * 0.5)
    mix = v["mix"]

    T = x.shape[1]
    y = np.zeros_like(x, dtype=np.float64)
    # onepole(a): y = a*x + (1-a)*y'
    z_env2 = z_base = z_piv = z_ratio = z_trim = 0.0
    for n in range(T):
        xl, xr = float(x[0, n]), float(x[1, n])
        m_in = 0.5 * (xl + xr)
        z_env2 = a_env * (m_in * m_in) + (1.0 - a_env) * z_env2
        env = math.sqrt(max(z_env2, 0.0))
        z_base = a_base * env + (1.0 - a_base) * z_base
        base = z_base
        m = env - base
        z_piv = a_piv * m + (1.0 - a_piv) * z_piv
        m_lo = z_piv
        m_hi = m - m_lo
        m2 = m * (1.0 - depth) + (m_lo * g_lo + m_hi * g_hi) * depth
        env_t = base + m2
        env_tp = max(env_t, 0.05 * env)
        r0 = (env_tp + 1e-9) / (env + 1e-9)
        r0c = min(max(r0, 0.67), 1.5)
        z_ratio = a_ratio * (r0c - 1.0) + (1.0 - a_ratio) * z_ratio
        r_s = 1.0 + z_ratio
        rdb = 20.0 * math.log10(max(r_s, 1e-12))
        z_trim = a_trim * rdb + (1.0 - a_trim) * z_trim
        trim = _db2lin(-z_trim)
        y[0, n] = (xl * (1.0 - mix) + xl * r_s * mix) * trim
        y[1, n] = (xr * (1.0 - mix) + xr * r_s * mix) * trim
    return y


# ---------------------------------------------------------------------------
# RED (ref: plugins/Dynamics/RED/src/Reverb Expanding Downwards (RED).dsp)

def red_golden(x: np.ndarray, v: Dict[str, float], srate: float) -> np.ndarray:
    def ms2pole(ms):
        return math.exp(-1.0 / (srate * (ms / 1000.0)))

    def smoothstep01(u):
        u = min(max(u, 0.0), 1.0)
        return u * u * (3.0 - 2.0 * u)

    eps = 1e-12
    sens = v["sens_pct"] / 100.0
    rel_ms = v["release_ms"]
    thr_db = 18.0 - sens * 21.0
    ratio = 1.2 + sens * 3.0
    knee_db = 10.0 - sens * 6.0
    grace_ms = min(max(rel_ms * 0.25, 60.0), 200.0)

    p_rms, p_tgt = ms2pole(35.0), ms2pole(25.0)
    p_grace, p_hold = ms2pole(grace_ms), ms2pole(80.0)
    p_dry = ms2pole(10.0)
    # an.amp_follower_ar poles (si.lag_ud / tau2pole on seconds)
    p_att = math.exp(-1.0 / (srate * max(12.0 / 1000.0, 1e-9)))
    p_rel = math.exp(-1.0 / (srate * max(rel_ms / 1000.0, 1e-9)))
    p_rel_in = math.exp(-1.0 / (srate * max(70.0 / 1000.0, 1e-9)))

    floor_lin = _db2lin(-80.0)
    dry_on = _db2lin(-50.0)
    ref_off = _db2lin(-60.0)

    T = x.shape[1]
    y = np.array(x, dtype=np.float64, copy=True)
    z_wet = z_ref = z_off = z_tgt = z_dry = z_hold = 0.0
    z_norm = z_fast = 0.0
    for n in range(T):
        wl, wr = float(x[0, n]), float(x[1, n])
        rl, rr = float(x[4, n]), float(x[5, n])
        z_wet = (1 - p_rms) * 0.5 * (wl * wl + wr * wr) + p_rms * z_wet
        z_ref = (1 - p_rms) * 0.5 * (rl * rl + rr * rr) + p_rms * z_ref
        Ey = max(math.sqrt(max(z_wet, 0.0)), floor_lin)
        Ex = max(math.sqrt(max(z_ref, 0.0)), floor_lin)
        dryA = 1.0 if Ex > dry_on else 0.0
        offA = 1.0 if Ex <= ref_off else 0.0
        z_off = (1 - p_grace) * offA + p_grace * z_off
        tail_w = (1.0 - offA) + offA * smoothstep01(z_off)
        rdB = 20.0 * math.log10(max((Ey + eps) / (Ex + eps), 1e-30))
        over = rdB - thr_db
        if over <= 0.0:
            over_eff = 0.0
        else:
            over_eff = over * smoothstep01(
                min(max(over / max(knee_db, 0.001), 0.0), 1.0))
        tgt0 = min(v["amount_db"], over_eff * ratio) if over_eff > 0.0 else 0.0
        tgt1 = tgt0 * tail_w
        z_tgt = (1 - p_tgt) * tgt1 + p_tgt * z_tgt
        tgt_db = z_tgt
        z_dry = (1 - p_dry) * dryA + p_dry * z_dry
        z_hold = (1 - p_hold) * tgt_db + p_hold * z_hold
        tgt_hold = max(tgt_db, z_hold)
        tgt_pin = (1.0 - dryA) * tgt_hold + dryA * tgt_db
        # amp_follower_ar: abs + switching one-pole (att on rise)
        a_in = abs(tgt_pin)
        pole = p_att if a_in > z_norm else p_rel
        z_norm = a_in + (z_norm - a_in) * pole
        pole = p_att if a_in > z_fast else p_rel_in
        z_fast = a_in + (z_fast - a_in) * pole
        gr_db = (1.0 - z_dry) * z_norm + z_dry * z_fast
        g = _db2lin(-gr_db)
        y[0, n] = wl * g
        y[1, n] = wr * g
    return y


# ---------------------------------------------------------------------------
# ClickBeGoneSG (ref: plugins/Restoration/ClickBeGoneSG/src/
# Click-Be-Gone (SG).dsp)

_SG_TAPS = {
    11: {20: -36, 19: 9, 18: 44, 17: 69, 16: 84, 15: 89, 14: 84, 13: 69,
         12: 44, 11: 9, 10: -36},
    15: {22: -78, 21: -13, 20: 42, 19: 87, 18: 122, 17: 147, 16: 162,
         15: 167, 14: 162, 13: 147, 12: 122, 11: 87, 10: 42, 9: -13,
         8: -78},
    21: {25: -171, 24: -76, 23: 9, 22: 84, 21: 149, 20: 204, 19: 249,
         18: 284, 17: 309, 16: 324, 15: 329, 14: 324, 13: 309, 12: 284,
         11: 249, 10: 204, 9: 149, 8: 84, 7: 9, 6: -76, 5: -171},
    31: {30: -406, 29: -261, 28: -126, 27: -1, 26: 114, 25: 219, 24: 314,
         23: 399, 22: 474, 21: 539, 20: 594, 19: 639, 18: 674, 17: 699,
         16: 714, 15: 719, 14: 714, 13: 699, 12: 674, 11: 639, 10: 594,
         9: 539, 8: 474, 7: 399, 6: 314, 5: 219, 4: 114, 3: -1, 2: -126,
         1: -261, 0: -406},
}
_SG_NORM = {11: 429.0, 15: 1105.0, 21: 3059.0, 31: 9889.0}


def clickbegone_golden(x: np.ndarray, v: Dict[str, float],
                       srate: float) -> np.ndarray:
    eps = 1e-12
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

    small_n = (11, 15, 21)[mode]
    large_n = (15, 21, 31)[mode]
    T_act = 1e-3
    rel_hold = math.exp(math.log(T_act) / (holdN + eps))
    rng = err_thr * 3.0
    monitor = int(v["monitor"])

    T = x.shape[1]
    y = np.zeros_like(x, dtype=np.float64)
    HIST = 33
    hL = np.zeros(HIST)  # hL[d] = L[n-d]
    hR = np.zeros(HIST)
    hp_xL = hp_yL = hp_xR = hp_yR = 0.0
    env = base = hold_env = 0.0
    for n in range(T):
        L, R = float(x[0, n]), float(x[1, n])
        hL[1:] = hL[:-1]
        hL[0] = L
        hR[1:] = hR[:-1]
        hR[0] = R
        # JSFX HPF: y = a*(x - x') + a*y'
        hpl = a * (L - hp_xL) + a * hp_yL
        hp_xL, hp_yL = L, hpl
        hpr = a * (R - hp_xR) + a * hp_yR
        hp_xR, hp_yR = R, hpr

        ehf = max(abs(hpl), abs(hpr))
        env = max(ehf, env_rel * env)
        base = base_a * env + (1.0 - base_a) * base
        ratio = env / (base + eps)

        xc_l, xc_r = hL[15], hR[15]

        def sg(hist, nn):
            s = 0.0
            for d, cc in _SG_TAPS[nn].items():
                s += cc * hist[d]
            return s / _SG_NORM[nn]

        small_l, small_r = sg(hL, small_n), sg(hR, small_n)
        large_l, large_r = sg(hL, large_n), sg(hR, large_n)
        eA = (max(abs(xc_l - small_l), abs(xc_r - small_r))
              / (max(abs(small_l), abs(small_r)) + 1e-6))
        eB = (max(abs(xc_l - large_l), abs(xc_r - large_r))
              / (max(abs(large_l), abs(large_r)) + 1e-6))
        if eA <= eB:
            pred_l, pred_r, e_norm = small_l, small_r, eA
        else:
            pred_l, pred_r, e_norm = large_l, large_r, eB
        trig = 1.0 if (ratio > ratio_thr and e_norm > err_thr) else 0.0
        hold_env = max(trig, rel_hold * hold_env)
        active = hold_env > T_act
        mix_base = min(max((e_norm - err_thr) / (rng + eps), 0.0), 1.0) \
            if active else 0.0
        mix = mix_base * mix_max
        out_l = xc_l * (1.0 - mix) + pred_l * mix
        out_r = xc_r * (1.0 - mix) + pred_r * mix
        if monitor:
            y[0, n], y[1, n] = out_l - xc_l, out_r - xc_r
        else:
            y[0, n], y[1, n] = out_l, out_r
    return y


# ---------------------------------------------------------------------------
# VAR (ref: plugins/Restoration/VAR/src/Vocal Air Recovery (VAR).dsp)

def _rbj(kind, fc, q, srate):
    fc = min(fc, 0.45 * srate)
    q = max(0.001, q)
    w0 = 2.0 * math.pi * fc / srate
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "hp":
        bb = ((1 + cw) / 2, -(1 + cw), (1 + cw) / 2)
    elif kind == "lp":
        bb = ((1 - cw) / 2, 1 - cw, (1 - cw) / 2)
    elif kind == "bp_skirt":
        bb = (sw / 2, 0.0, -sw / 2)
    else:
        raise ValueError(kind)
    a0 = 1 + alpha
    return (bb[0] / a0, bb[1] / a0, bb[2] / a0,
            (-2 * cw) / a0, (1 - alpha) / a0)


class _Biquad:
    """fi.tf22t: transposed direct-form II."""

    def __init__(self, coeffs):
        self.b0, self.b1, self.b2, self.a1, self.a2 = coeffs
        self.s1 = 0.0
        self.s2 = 0.0

    def step(self, xn: float) -> float:
        yn = self.b0 * xn + self.s1
        self.s1 = self.b1 * xn - self.a1 * yn + self.s2
        self.s2 = self.b2 * xn - self.a2 * yn
        return yn


def _lcg_stream(n: int, seed: int) -> np.ndarray:
    vals = np.empty(n, dtype=np.float64)
    s = seed & 0xFFFFFFFF
    for k in range(n):
        s = (1103515245 * s + 12345) & 0xFFFFFFFF
        v = s if s < (1 << 31) else s - (1 << 32)
        vals[k] = v / float(1 << 31)
    return vals


def var_golden(x: np.ndarray, v: Dict[str, float], srate: float) -> np.ndarray:
    eps = 1e-12
    amount = v["air_amount"] / 100.0
    sens = v["sensitivity"] / 100.0
    floor_lin = _db2lin(v["floor_db"])

    max_exp_lin = _db2lin(5.0 * amount)
    air_mix = 0.25 * amount
    air_base = _db2lin(-34.0)
    thrN = 0.18 - 0.13 * sens

    det_a = math.exp(-2.0 * math.pi * min(8500.0, 0.45 * srate) / srate)
    hf_lvl_a = math.exp(-1.0 / (srate * 0.14))
    p_att = math.exp(-1.0 / (srate * 0.0025))
    p_rel = math.exp(-1.0 / (srate * 0.080))

    T = x.shape[1]
    detL = _Biquad(_rbj("bp_skirt", 9500.0, 1.0, srate))
    detR = _Biquad(_rbj("bp_skirt", 9500.0, 1.0, srate))
    hpL1 = _Biquad(_rbj("hp", 11500.0, 0.707, srate))
    hpL2 = _Biquad(_rbj("hp", 11500.0, 0.707, srate))
    hpR1 = _Biquad(_rbj("hp", 11500.0, 0.707, srate))
    hpR2 = _Biquad(_rbj("hp", 11500.0, 0.707, srate))
    airL_bq = _Biquad(_rbj("bp_skirt", 16000.0, 1.2, srate))
    airR_bq = _Biquad(_rbj("bp_skirt", 16000.0, 1.2, srate))
    nL = _lcg_stream(T, 12345)
    nR = _lcg_stream(T, 54321)

    y = np.zeros_like(x, dtype=np.float64)
    z_lvl = 0.0
    zL1 = zL2 = zR1 = zR2 = 0.0
    dL1 = dL2 = dR1 = dR2 = 0.0
    z_env = 0.0
    for n in range(T):
        il, ir = float(x[0, n]), float(x[1, n])
        dl = detL.step(il)
        dr = detR.step(ir)
        hf_abs = 0.5 * (abs(dl) + abs(dr))
        z_lvl = (1.0 - hf_lvl_a) * hf_abs + hf_lvl_a * z_lvl
        u_g = min(1.0, max(0.0, z_lvl / (floor_lin + eps) - 1.0))
        gate = u_g * u_g * (3.0 - 2.0 * u_g)

        zL1 = (1.0 - det_a) * dl + det_a * zL1
        zL2 = (1.0 - det_a) * zL1 + det_a * zL2
        zR1 = (1.0 - det_a) * dr + det_a * zR1
        zR2 = (1.0 - det_a) * zR1 + det_a * zR2
        lapL = zL2 - 2.0 * dL1 + dL2
        denL = abs(zL2) + 2.0 * abs(dL1) + abs(dL2) + eps
        lapR = zR2 - 2.0 * dR1 + dR2
        denR = abs(zR2) + 2.0 * abs(dR1) + abs(dR2) + eps
        curvN = 0.5 * (abs(lapL) / denL + abs(lapR) / denR)
        dL2, dL1 = dL1, zL2
        dR2, dR1 = dR1, zR2

        pole = p_att if curvN > z_env else p_rel
        z_env = curvN + (z_env - curvN) * pole

        u = max(0.0, z_env / thrN - 1.0)
        t = (u / (1.0 + u)) * gate
        t2 = max(eps, t) ** 1.8
        g = 1.0 + t * (max_exp_lin - 1.0)

        hfl = hpL2.step(hpL1.step(il))
        hfr = hpR2.step(hpR1.step(ir))
        airl = airL_bq.step(nL[n])
        airr = airR_bq.step(nR[n])
        air_gain = (t2 * air_base) * air_mix
        y[0, n] = il + hfl * (g - 1.0) + airl * air_gain
        y[1, n] = ir + hfr * (g - 1.0) + airr * air_gain
    return y


GOLDENS = {
    "GTS": gts_golden,
    "ModTilt": modtilt_golden,
    "RED": red_golden,
    "ClickBeGoneSG": clickbegone_golden,
    "VAR": var_golden,
}
