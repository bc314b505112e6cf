#!/usr/bin/env python3
"""On-card smoke test of the zorak_tpu_torch port (one NVIDIA GPU, Hopper).

    python3 chip_smoke.py

    python3 chip_smoke.py --phases jsfx      # the JSFX phases alone

Phases, in order; any failure raises and the script exits non-zero
without printing a result (`--phases` takes `jsfx`, `faust` or both, the
default; device and build always run):

1. device   the card's name and power limit (nvidia-smi);
2. build    every CUDA kernel of the paths, from csrc/ in this checkout,
            one nvcc a source, all started together;
3. kernels (jsfx)  the linear-recurrence scan (K2) against a NumPy
            sequential loop, bit-identical, and against its plain
            doubling ladder within 1e-9 x max|z| (scalar and per-sample
            a; k in 1, 2, 8; L in 1, 7, 4,096, 131,072; z0 != 0, a = 0,
            NaN in b), its time at the main shape beside the ladder's,
            its bounds and a one-thread chain probe.  The ring tap sum
            (K3) against its plain fold, bit-identical, at 16, 192 and
            300 taps, delays below and above L, L = 131,072, a short
            remainder and 1, its time beside the plain fold's, a dense
            FIR convolution's (the library call) and its bound;
4. main (jsfx)  the in-repo delay network and its 192-tap widening
            through PluginInstance.render on 60 s of 48 kHz stereo noise
            at the default segment length: engine torch-vector, K2 and
            K3 launch counts, finite output, timing, a torch.profiler
            pass, the first second against the port's CPU render and the
            first 4,800 samples against the Python golden; then a plugin
            with a sequential scan group, which must report cpu-shadow
            with the missing kernel as the reason;
5. kernels (faust)  the switching scan (K1) must be bit-identical
            (integer views equal), in f64 and f32: at modest shapes, at
            the batch and main paths' shapes (its one-chunk case too),
            with a small chunk and warm-up at T from 1 to 20,000 (many
            chunks, re-runs), and on inputs where trajectories do not
            merge (a burst into exact silence, also at T = 60,000 with
            the default chunk and warm-up), constant input, -0.0 and NaN.
            Its time at the main shape beside the one-chunk case's (a
            thread per lane) and the worst case's, re-run steps, and the
            chain bound from a one-thread probe.  Where a plain loop
            would take minutes, K1 at its defaults is held bit for bit to
            K1 as one chunk (held to the plain loop at the main shape):
            the worst case at the main length and every input the VAR
            and RED renders below give K1;
6. main (faust)  VAR on 60 s of 48 kHz stereo noise (seeded numpy) on CUDA:
            launch counts, re-run steps, finite output, timing, and the
            first second against the port's CPU render at the audio
            epsilon; then VAR on 60 s of program-like material (noise
            with a silent lead-in, silent gaps and a fade-out): time and
            re-run steps;
7. batch (faust)  all five Faust modules through FaustBatchRenderer on
            8 files of 10 s each, the first second of each file against
            the CPU render;
then one `kernels` JSON line (beside `bound_ms`: `chain_ms`, the chain
bound of T steps in one thread, `chunk_chain_ms`, that of the chunked
scan's warmup + chunk steps, `earlier_ms`, the one-chunk time, the
worst case, and the program-like render's re-run steps) and, last, the
device JSON line.

Imports nothing of JAX or of the JAX package `zorak_tpu`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SR = 48000.0
MAIN_T = 2_880_000          # 60 s at 48 kHz
BATCH_FILES, BATCH_T = 8, 480_000
SEG_L = 1 << 17             # the JSFX engine's default segment length
SEED = 20261016

# an attack/release follower: its pole depends on its state, so the
# planner makes it a sequential scan group
SCAN_GROUP_SRC = """\
desc:attack/release follower
@init
env = 0; up = 0.9; dn = 0.999;
@sample
x = abs(spl0);
env = x > env ? x + (env - x)*up : x + (env - x)*dn;
spl0 = env; spl1 = env;
"""

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}   # outside tensor cores
SCAN_OPS_PER_STEP = 5   # compare, select, subtract, multiply, add
# dspkit stages one VAR render runs (zorak_tpu_torch/models/faustmods.py,
# VAR.forward): two noise streams, eight biquads, five one-poles, one scan
VAR_STAGES = {"lcg_noise": 2, "biquad_tf2": 8, "onepole": 5,
              "switching_scan": 1}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_bound_ms(n_t: int, lanes: int, dtype: str):
    """Least time for the scan: bytes over HBM rate vs ops over peak."""
    itemsize = 8 if dtype == "float64" else 4
    nbytes = (2 * n_t * lanes + 3 * lanes) * itemsize
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = SCAN_OPS_PER_STEP * n_t * lanes / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def profile_render(render, label: str) -> None:
    """Device busy time, idle share and top kernels of one render, from a
    torch.profiler trace of the kernels it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("[profile] the trace holds no device events: busy time and "
              "idle share not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    print(f"[profile] {label} render: {len(kernels)} device events, busy "
          f"{busy_us / 1e3:.2f} ms of a {span_us / 1e3:.2f} ms span, idle share "
          f"{1.0 - busy_us / span_us:.3f}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {us / 1e3:9.3f} ms  x{n:<4d} {name[:90]}")


def same_bits(a, b):
    """Equal as bit patterns (integer views), not as floats."""
    import torch

    iv = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(iv), b.view(iv))


def bound_ms(nbytes: float, ops: float, dtype: str = "float64"):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def linrec_phase(torch, cuda, rng):
    """K2 against a NumPy sequential loop (bit-identical) and against its
    plain doubling ladder (tolerance printed); times at the main shape."""
    from zorak_tpu_torch.kernels import linrec_scan as LS

    # the ladder's order differs from the sequential order by rounding only
    tol_rel = 1e-9
    worst = 0.0
    for vec_a in (False, True):
        for k in (1, 2, 8):
            for n in (1, 7, 4096, SEG_L):
                a = rng.uniform(0.5, 0.99995, (k, n) if vec_a else (k,))
                a.flat[0] = 0.0                      # a = 0: z = b
                if k > 1:
                    a[1] = -a[1]
                b = rng.randn(k, n)
                z0 = rng.uniform(-1.0, 1.0, k)       # z0 != 0
                for with_nan in (False, True):
                    if with_nan:
                        if n < 7:
                            continue
                        b = b.copy()
                        b[-1, n // 2] = np.nan
                    at, bt, zt = (torch.from_numpy(v).to(cuda)
                                  for v in (a, b, z0))
                    got = LS.linrec_scan(at, bt, zt)
                    torch.cuda.synchronize()
                    seq = torch.from_numpy(LS.linrec_sequential(a, b, z0))
                    ok = same_bits(got.cpu(), seq)
                    ladder = LS.linrec_scan_reference(at, bt, zt).cpu()
                    fin = torch.isfinite(seq)
                    nan_ok = torch.equal(torch.isnan(ladder), torch.isnan(seq))
                    scale = float(seq[fin].abs().max()) if fin.any() else 1.0
                    err = float((ladder[fin] - got.cpu()[fin]).abs().max()) \
                        if fin.any() else 0.0
                    worst = max(worst, err / max(scale, 1e-300))
                    check(ok, f"linrec_scan k={k} L={n} vec_a={vec_a} "
                          f"nan={with_nan} differs from the sequential loop")
                    check(nan_ok and err <= tol_rel * scale,
                          f"linrec_scan k={k} L={n} vec_a={vec_a} "
                          f"nan={with_nan}: ladder differs by {err:.3e} "
                          f"(limit {tol_rel} x {scale:.3e})")
            print(f"[kernels] linrec_scan {'per-sample' if vec_a else 'scalar'}"
                  f" a, k={k}, L in (1, 7, 4096, {SEG_L}), with and without "
                  "NaN: bit-identical to the sequential loop; plain ladder "
                  f"within {tol_rel} x max|z| (worst so far {worst:.3e})")

    # the main path's shape: the two one-poles of the delay network, one
    # wave of k = 2 rows with scalar a over a full segment
    k, n = 2, SEG_L
    a = torch.full((k,), 0.995, dtype=torch.float64, device=cuda)
    b = torch.from_numpy(rng.randn(k, n) * 0.05).to(cuda)
    z0 = torch.zeros(k, dtype=torch.float64, device=cuda)
    got = LS.linrec_scan(a, b, z0)
    ref = LS.linrec_scan_reference(a, b, z0)
    err = float((got - ref).abs().max())
    scan_ms = cuda_ms(lambda: LS.linrec_scan(a, b, z0), reps=20)
    plain_ms = cuda_ms(lambda: LS.linrec_scan_reference(a, b, z0), reps=5)
    av = torch.from_numpy(rng.uniform(0.5, 0.9999, (k, n))).to(cuda)
    vec_ms = cuda_ms(lambda: LS.linrec_scan(av, b, z0), reps=20)
    vec_plain_ms = cuda_ms(lambda: LS.linrec_scan_reference(av, b, z0), reps=5)
    scan_ms_2 = cuda_ms(lambda: LS.linrec_scan(a, b, z0), reps=20)
    # each input read once, the output written once; 2 operations a step
    b_ms, b_by = bound_ms((2 * k * n + 2 * k) * 8, 2 * k * n)
    # the chain bound: the same dependent steps in one thread, a and b
    # cycling through registers (checked against the sequential loop first)
    ac = torch.from_numpy(rng.uniform(0.9, 0.9999, LS.CHAIN_CHUNK)).to(cuda)
    bc = torch.from_numpy(rng.randn(LS.CHAIN_CHUNK)).to(cuda)
    zc = torch.zeros(1, dtype=torch.float64, device=cuda)
    reps_c = 64
    z_seq = LS.linrec_sequential(
        np.tile(ac.cpu().numpy(), reps_c)[None],
        np.tile(bc.cpu().numpy(), reps_c)[None], np.zeros(1))[:, -1]
    check(same_bits(LS.linrec_chain_probe(ac, bc, zc, reps_c * LS.CHAIN_CHUNK).cpu(),
                    torch.from_numpy(z_seq)),
          "linrec chain probe differs from the sequential loop")
    chain_ms = cuda_ms(lambda: LS.linrec_chain_probe(ac, bc, zc, n), reps=5)
    print(f"[kernels] linrec_scan k={k} L={n} scalar a: ms={scan_ms:.4f} "
          f"(again {scan_ms_2:.4f}) plain_ms={plain_ms:.4f} "
          f"max_abs_err_vs_ladder={err:.3e} bound_ms={b_ms:.5f} ({b_by}) "
          f"chain_ms={chain_ms:.4f} ({chain_ms * 1e6 / n:.3f} ns a step), "
          f"the kernel {scan_ms / chain_ms:.3f}x it; per-sample a: "
          f"ms={vec_ms:.4f} plain_ms={vec_plain_ms:.4f}")
    return {
        "name": "linrec_scan", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/linrec_scan.cu",
        "replaces": "zorak_tpu/lowering/eelmath.py:277",
        "launches": 0, "max_abs_err": err, "ms": scan_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "chain_ms": chain_ms, "vector_a_ms": vec_ms,
        "vector_a_plain_ms": vec_plain_ms, "worst_rel_err_vs_ladder": worst,
        "shape": [k, n],
    }


def tap_case(rng, n_taps, mod, n, long_only=False):
    """A ring buffer [mod + n] (or history alone, every delay >= n) with
    tap offsets spread over it, delay 0 and delay mod included."""
    lo = 0
    hi = mod - n if long_only else mod
    starts = rng.randint(lo, hi + 1, n_taps)
    starts[0], starts[-1] = hi, lo
    gains = rng.uniform(-0.1, 0.1, n_taps)
    buf = rng.randn(mod if long_only else mod + n)
    return buf, starts.astype(np.int64), gains


def ring_taps_phase(torch, cuda, rng):
    """K3 against its plain fold, bit-identical; times at the two delay
    networks' shapes beside a dense-FIR convolution as the library call."""
    from zorak_tpu_torch.kernels import ring_taps as RT

    def on_card(case):
        buf, starts, gains = case
        return (torch.from_numpy(buf).to(cuda),
                torch.from_numpy(starts).to(cuda),
                torch.from_numpy(gains).to(cuda))

    for n_taps, mod in ((16, 4096), (192, 16384), (300, 16384)):
        for n in (SEG_L, 6784, 1):
            for long_only in (False, True):
                if long_only and n > mod:
                    continue
                args = on_card(tap_case(rng, n_taps, mod, n, long_only))
                for init in (0.0, torch.from_numpy(rng.randn(n)).to(cuda)):
                    got = RT.ring_tap_sum(*args, init, n)
                    ref = RT.ring_tap_sum_reference(*args, init, n)
                    torch.cuda.synchronize()
                    check(same_bits(got, ref),
                          f"ring_tap_sum taps={n_taps} mod={mod} L={n} "
                          f"long_only={long_only} differs from its plain fold")
        print(f"[kernels] ring_tap_sum taps={n_taps} mod={mod}, L in ({SEG_L}, "
              "6784, 1), delays below and above L, scalar and stream init: "
              "bit-identical to the plain fold")

    out = {}
    for label, n_taps, mod in (("fallback", 16, 4096), ("wide", 192, 16384)):
        n = SEG_L
        buf, starts, gains = args = on_card(tap_case(rng, n_taps, mod, n))
        got = RT.ring_tap_sum(*args, 0.0, n)
        ref = RT.ring_tap_sum_reference(*args, 0.0, n)
        err = float((got - ref).abs().max())
        ms = cuda_ms(lambda: RT.ring_tap_sum(*args, 0.0, n), reps=20)
        plain_ms = cuda_ms(lambda: RT.ring_tap_sum_reference(*args, 0.0, n),
                           reps=3)
        # one PyTorch call for the same function: the taps as a dense FIR
        s_min, s_max = int(starts.min()), int(starts.max())
        fir = torch.zeros(s_max - s_min + 1, dtype=torch.float64, device=cuda)
        fir.index_add_(0, starts - s_min, gains)
        sig = buf[s_min:s_max + n][None, None]
        lib = torch.nn.functional.conv1d(sig, fir[None, None])[0, 0]
        lib_err = float((lib - ref).abs().max())
        check(lib.shape == ref.shape and lib_err < 1e-9,
              f"dense-FIR convolution disagrees with the tap sum: {lib_err:.3e}")
        lib_ms = cuda_ms(
            lambda: torch.nn.functional.conv1d(sig, fir[None, None]), reps=3)
        ms_2 = cuda_ms(lambda: RT.ring_tap_sum(*args, 0.0, n), reps=20)
        # the buffer read once, the output written once, the tables; one
        # multiply and one add a tap and sample
        b_ms, b_by = bound_ms((mod + n + n) * 8 + n_taps * 16,
                              2 * n_taps * n)
        print(f"[kernels] ring_tap_sum {label}: taps={n_taps} mod={mod} L={n} "
              f"bit-identical max_abs_err={err:.3e} ms={ms:.4f} (again "
              f"{ms_2:.4f}) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"(conv1d, dense FIR of {fir.numel()} taps, max |delta| "
              f"{lib_err:.3e}) bound_ms={b_ms:.5f} ({b_by})")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                      "shape": [n_taps, mod, n]}
    fb, wide = out["fallback"], out["wide"]
    return {
        "name": "ring_tap_sum", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/ring_taps.cu",
        "replaces": "zorak_tpu/lowering/specialize.py:4392",
        "launches": 0, "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": fb["bound_by"], "library_ms": fb["library_ms"],
        "shape": fb["shape"], "wide": wide,
    }


def jsfx_phase(torch, cuda, rng, card):
    """The JSFX main path: the in-repo delay network and its 192-tap
    widening through PluginInstance.render on 60 s of stereo; returns the
    K2 and K3 launch counts of each timed render."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.lowering.specialize import _K4_REASON
    from zorak_tpu_torch.runtime.engine import DEFAULT_SEGMENT_LEN, PluginInstance
    from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio

    check(DEFAULT_SEGMENT_LEN == SEG_L, "the default segment length moved")
    sec = MAIN_T / SR
    n1, n_gold = int(SR), 4800
    launches = {}
    for label, src, hold_golden in (
            ("fallback", BP.FALLBACK_SRC, False),
            ("wide", BP.wide_delay_network(192), True)):
        prog = compile_plugin_source(src)
        inst = PluginInstance(prog, srate=SR)          # device None: the card
        check(inst.engine == "torch-vector",
              f"{label}: engine {inst.engine} ({inst.spec_error})")
        x = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
        inst.render(x)                                 # warm-up
        torch.cuda.synchronize()
        LS.LAUNCHES = RT.LAUNCHES = 0
        out = []
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: out.append(inst.render(x)))
        wall = time.perf_counter() - t0
        launches[label] = {"linrec_scan": LS.LAUNCHES,
                           "ring_tap_sum": RT.LAUNCHES}
        res = out[0]
        # the render's host side (copies, the wake scan) shares its CPU
        # with other tenants: four more renders show the spread
        more_ms = sorted(cuda_ms(lambda: inst.render(x)) for _ in range(4))
        check(res.engine == "torch-vector", f"{label}: rendered by {res.engine}")
        check(all(v > 0 for v in launches[label].values()),
              f"{label}: the main path skipped a kernel: {launches[label]}")
        y = res.audio
        check(y.shape == (2, MAIN_T) and y.dtype == np.float32,
              f"{label}: output {y.shape} {y.dtype}")
        check(bool(np.isfinite(y).all()), f"{label}: output not finite")
        print(f"[main] JSFX {label} 60 s stereo: engine={res.engine} "
              f"device_ms={ms:.2f} wall_s={wall:.4f} "
              f"audio_s_per_s={sec / (ms / 1e3):.1f} "
              f"launches={launches[label]} segments="
              f"{-(-MAIN_T // SEG_L)} four more renders "
              f"{' '.join(f'{m:.2f}' for m in more_ms)} ms card='{card}'")
        kern = inst.kernel
        x_dev = torch.from_numpy(x).to(cuda)
        kern.render_device(x_dev)
        dev_ms = cuda_ms(lambda: kern.render_device(x_dev), reps=3)
        print(f"[main] JSFX {label}: the kernel alone, audio already on the "
              f"card and left there, mean of 3: device_ms={dev_ms:.2f} "
              f"audio_s_per_s={sec / (dev_ms / 1e3):.1f}")
        profile_render(lambda: kern.render_device(x_dev), f"JSFX {label}")

        # causal, so the first second stands alone: against the port's
        # CPU render (the doubling ladders in place of K2's order)
        y_cpu = PluginInstance(prog, srate=SR, device="cpu").render(
            x[:, :n1]).audio
        rep = compare_audio(y_cpu, y[:, :n1])
        print(f"[main] JSFX {label} first 1 s, CUDA vs CPU render: "
              f"{rep.summary()}")
        check(rep.audio_passed,
              f"{label}: CUDA render disagrees with CPU at {AUDIO_EPS}")
        gold = PluginInstance(prog, srate=SR, prefer="none", device="cpu")
        res_g = gold.render(x[:, :n_gold])
        check(res_g.engine == "cpu-shadow", "the golden did not render")
        rep = compare_audio(res_g.audio, y[:, :n_gold])
        print(f"[main] JSFX {label} first {n_gold} samples, CUDA vs the Python "
              f"golden: {rep.summary()}")
        if hold_golden:
            check(rep.audio_passed,
                  f"{label}: CUDA render disagrees with the golden")
        else:
            # the in-repo text leaves dT and gT unset, so both tap tables
            # alias mem[0..15], inside the left ring: the golden reads
            # audio where the planner folded constants.  The reference
            # package differs from its golden by the same amount; what
            # is held here is the port against its CPU render.
            rep_c = compare_audio(res_g.audio, y_cpu[:, :n_gold])
            check(rep_c.max_abs_delta == rep.max_abs_delta or
                  abs(rep_c.max_abs_delta - rep.max_abs_delta) < AUDIO_EPS,
                  f"{label}: CUDA and CPU renders differ from the golden "
                  "by different amounts")

    # a plugin with a sequential scan group (an attack/release follower):
    # the card has no kernel for it yet, so the engine must say so and
    # render through the golden, never through a launch-per-sample loop
    follower = compile_plugin_source(SCAN_GROUP_SRC)
    on_cpu = PluginInstance(follower, srate=SR, device="cpu")
    check(on_cpu.engine == "torch-vector" and on_cpu.kernel.scan_groups,
          "the follower plugin no longer plans a scan group")
    on_card = PluginInstance(follower, srate=SR)
    check(on_card.engine == "cpu-shadow" and on_card.spec_error == _K4_REASON,
          f"scan-group plugin on the card: engine {on_card.engine}, "
          f"reason {on_card.spec_error!r}")
    xs = (rng.randn(2, 2048) * 0.25).astype(np.float32)
    res = on_card.render(xs)
    check(res.engine == "cpu-shadow"
          and res.details.get("spec_error") == _K4_REASON,
          "scan-group render did not report the golden and K4's reason")
    rep = compare_audio(res.audio, on_cpu.render(xs).audio)
    check(rep.audio_passed, "scan-group plugin: golden vs CPU vector render")
    print(f"[main] scan-group plugin on the card: engine={res.engine} "
          f"reason='{on_card.spec_error}'; golden vs CPU vector render: "
          f"{rep.summary()}")
    return launches


def faust_phases(torch, cuda, rng, card):
    """The Faust family: K1 against its plain loop, the VAR renders and the
    batch renders; returns K1's entry of the `kernels` line."""
    from zorak_tpu_torch.kernels import switching_scan as SS
    from zorak_tpu_torch.models import FAUST_MODULES, dspkit as K
    from zorak_tpu_torch.models import get_faust_module
    from zorak_tpu_torch.parallel import FaustBatchRenderer
    from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio

    def zero_reruns():
        for v in SS.RERUN_STEPS.values():
            v.zero_()

    def rerun_steps():
        return sum(int(v.item()) for v in SS.RERUN_STEPS.values())

    # 5. K1 against its plain version -----------------------------------
    # K1 must equal its plain loop bit for bit (same_bits: integer views)
    def scan_inputs(n_t, lanes, dtype, up=None, dn=None, x=None):
        x = np.abs(rng.randn(n_t, lanes)) if x is None else x
        x = torch.from_numpy(x).to(cuda, dtype)
        upv = torch.from_numpy(rng.uniform(0.3, 0.9, lanes) if up is None
                               else np.full(lanes, up)).to(cuda, dtype)
        dnv = torch.from_numpy(rng.uniform(0.95, 0.9999, lanes) if dn is None
                               else np.full(lanes, dn)).to(cuda, dtype)
        z0 = torch.from_numpy(rng.uniform(0.0, 1.0, lanes)).to(cuda, dtype)
        return x, upv, dnv, z0

    def adversarial(kind, n_t, lanes):
        x = np.abs(rng.randn(n_t, lanes))
        if kind == "silence":       # a burst, then exact zeros: never merges
            x[n_t // 10:] = 0.0
        elif kind == "constant":
            x[:] = 0.25
        elif kind == "negzero":
            x[::3] = -0.0
        elif kind == "nan":
            x[n_t // 2] = np.nan
        return x

    def witnessed(what, args):
        """K1 at its defaults against K1 as one chunk on the same inputs,
        bit for bit; returns the defaults' re-run steps."""
        zero_reruns()
        got = SS.switching_scan(*args)
        reruns = rerun_steps()
        ok = same_bits(got, SS.switching_scan(*args, chunk=args[0].shape[0]))
        print(f"[kernels] switching_scan {what} T={args[0].shape[0]} "
              f"lanes={args[0].shape[1]} {str(args[0].dtype)[6:]} defaults vs "
              f"one chunk: {'bit-identical' if ok else 'DIFFERS'} "
              f"rerun_steps={reruns}")
        check(ok, f"switching_scan {what} differs from its one-chunk case")
        return reruns

    def caught_scans(fn):
        """Runs fn() and returns the arguments of every K1 call it made."""
        caught, plain = [], SS.switching_scan

        def spy(*a, **kw):
            caught.append(a)
            return plain(*a, **kw)

        SS.switching_scan = spy
        try:
            fn()
        finally:
            SS.switching_scan = plain
        return caught

    def held(what, args, ref=None, **kw):
        """K1 against the plain loop on the same CUDA inputs, bit for bit;
        returns (plain result, re-run steps)."""
        zero_reruns()
        got = SS.switching_scan(*args, **kw)
        reruns = rerun_steps()
        if ref is None:
            ref = SS.switching_scan_reference(*args)
        torch.cuda.synchronize()
        ok = same_bits(got, ref)
        print(f"[kernels] switching_scan {what} {dict(kw) or 'defaults'}: "
              f"{'bit-identical' if ok else 'DIFFERS'} rerun_steps={reruns}")
        check(ok, f"switching_scan {what} {kw} differs from its plain loop")
        return ref, reruns

    small = {"chunk": 64, "warmup": 64}
    # VAR's follower poles: 2.5 ms attack, 80 ms release
    VAR_POLES = (float(np.exp(-1.0 / (SR * 0.0025))),
                 float(np.exp(-1.0 / (SR * 0.080))))
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for n_t, lanes in ((8192, 1), (8191, 3), (8192, 128),
                           (BATCH_T, BATCH_FILES)):
            held(f"{dname} T={n_t} lanes={lanes}",
                 scan_inputs(n_t, lanes, dtype))
        # many chunks and re-runs at small T
        for n_t in (1, 63, 64, 65, 4095, 20_000):
            for lanes in (1, 3, 8):
                held(f"{dname} T={n_t} lanes={lanes}",
                     scan_inputs(n_t, lanes, dtype), **small)
        for kind in ("silence", "constant", "negzero", "nan"):
            args = scan_inputs(20_000, 3, dtype, x=adversarial(kind, 20_000, 3))
            ref, _ = held(f"{dname} {kind} T=20000 lanes=3", args, **small)
            held(f"{dname} {kind} T=20000 lanes=3", args, ref)
        # past warm-up + chunk at the defaults: chunks after the burst are
        # speculated and, decaying at VAR's release pole, never merge
        n_long = 60_000
        args = scan_inputs(n_long, 3, dtype, *VAR_POLES,
                           x=adversarial("silence", n_long, 3))
        _, reruns = held(f"{dname} silence T={n_long} lanes=3", args)
        check(reruns > 0, "the default-settings silence case re-ran nothing")

    # at the main path's shape: VAR's follower, one lane, at VAR's poles;
    # the one-chunk case too, the witness for the longer inputs below
    one = {"chunk": MAIN_T}         # one chunk: a thread per lane
    args = scan_inputs(MAIN_T, 1, torch.float32, *VAR_POLES)
    ref, _ = held("float32 T=%d lanes=1" % MAIN_T, args)
    held("float32 T=%d lanes=1" % MAIN_T, args, ref, **one)
    args = scan_inputs(MAIN_T, 1, torch.float64, *VAR_POLES)
    zero_reruns()
    got = SS.switching_scan(*args)
    main_reruns = rerun_steps()
    got_one = SS.switching_scan(*args, **one)
    ref_holder = []
    plain_ms = cuda_ms(lambda: ref_holder.append(
        SS.switching_scan_reference(*args)))
    ref = ref_holder[0]
    check(same_bits(got, ref) and same_bits(got_one, ref),
          "switching_scan at the main shape differs from its plain loop")
    scan_err = (got - ref).abs().max().item()
    # the new default, the one-chunk design, the default again: same card
    scan_ms = cuda_ms(lambda: SS.switching_scan(*args), reps=5)
    earlier_ms = cuda_ms(lambda: SS.switching_scan(*args, **one), reps=3)
    scan_ms_2 = cuda_ms(lambda: SS.switching_scan(*args), reps=5)
    bound_ms, bound_by = scan_bound_ms(MAIN_T, 1, "float64")
    chunk, warmup, n_chunks = SS.chunk_plan(MAIN_T, SS.CHUNK,
                                            SS.WARMUP[torch.float64])
    print(f"[kernels] switching_scan float64 T={MAIN_T} lanes=1 bit-identical "
          f"max_abs_err={scan_err:.3e} ms={scan_ms:.4f} "
          f"(again {scan_ms_2:.4f}) "
          f"one_chunk_ms={earlier_ms:.4f} plain_ms={plain_ms:.1f} "
          f"bound_ms={bound_ms:.5f} ({bound_by}) chunk={chunk} "
          f"warmup={warmup} chunks={n_chunks} rerun_steps={main_reruns}")

    # the worst case: a burst, then silence to the end; no chunk after the
    # burst merges, so the fix-up re-runs them all one after another
    worst = scan_inputs(MAIN_T, 1, torch.float64, *VAR_POLES,
                        x=adversarial("silence", MAIN_T, 1))
    worst_reruns = witnessed("worst case (burst then silence)", worst)
    worst_ms = cuda_ms(lambda: SS.switching_scan(*worst), reps=2)
    print(f"[kernels] switching_scan float64 T={MAIN_T} worst case (burst "
          f"then silence): ms={worst_ms:.4f} rerun_steps={worst_reruns}")

    # the chain bound: the same dependent steps in one thread, x cycling
    # through registers, no memory traffic (checked against the plain loop
    # on the same repeated x first)
    xc, chain_args = args[0][:SS.CHAIN_CHUNK, 0].contiguous(), args[1:]
    n_check = 128 * SS.CHAIN_CHUNK
    z_ref = SS.switching_scan_reference(
        xc.repeat(n_check // SS.CHAIN_CHUNK)[:, None], *chain_args)[-1]
    check(same_bits(SS.switching_chain_probe(xc, *chain_args, n_check), z_ref),
          "chain probe differs from the plain loop")
    SS.switching_chain_probe(xc, *chain_args, MAIN_T)
    chain_ms = cuda_ms(
        lambda: SS.switching_chain_probe(xc, *chain_args, MAIN_T), reps=3)
    chain_ns = chain_ms * 1e6 / MAIN_T
    chunk_chain_ms = (warmup + chunk) * chain_ns * 1e-6
    print(f"[kernels] switching_scan chain bound, float64 T={MAIN_T}: "
          f"chain_ms={chain_ms:.4f} ns_per_step={chain_ns:.3f}; one chunk "
          f"{earlier_ms / chain_ms:.3f}x it; chunked bound (warmup + chunk) "
          f"x {chain_ns:.3f} ns = {chunk_chain_ms:.4f} ms, the kernel "
          f"{scan_ms / chunk_chain_ms:.3f}x it")

    # stage times at the main shape, each after a warm-up, for the
    # breakdown of a VAR render
    xs = torch.from_numpy(rng.randn(MAIN_T)).to(cuda, torch.float64)
    bq = K.rbj_coeffs("hp", 11500.0, 0.707, SR)
    stage_fns = {
        "lcg_noise": lambda: K.lcg_noise(MAIN_T, device=cuda),
        "biquad_tf2": lambda: K.biquad_tf2(xs, *bq),
        "onepole": lambda: K.onepole(xs, 0.99),
    }
    stages = {}
    for name, fn in stage_fns.items():
        fn()
        stages[name] = cuda_ms(fn, 3)
    stages["switching_scan"] = scan_ms
    print("[stages] T=%d f64 %s" % (MAIN_T, " ".join(
        f"{k}_ms={v:.3f}" for k, v in stages.items())))

    # 6. main path: VAR, 60 s of 48 kHz stereo -------------------------------
    var = get_faust_module("VAR")
    v = var.values()
    x_np = rng.randn(2, MAIN_T) * 0.25
    x = torch.from_numpy(x_np).to(cuda)
    var_scans = caught_scans(lambda: var(x, v, SR))   # warm-up
    torch.cuda.synchronize()
    SS.LAUNCHES = 0
    zero_reruns()
    t0 = time.perf_counter()
    y_holder = []
    var_ms = cuda_ms(lambda: y_holder.append(var(x, v, SR)))
    var_wall = time.perf_counter() - t0
    main_launches = {"switching_scan": SS.LAUNCHES}
    var_reruns = rerun_steps()
    y = y_holder[0]
    check(all(n > 0 for n in main_launches.values()),
          f"main path skipped a kernel: {main_launches}")
    check(tuple(y.shape) == (2, MAIN_T), f"VAR output shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "VAR output not finite")
    sec = MAIN_T / SR
    print(f"[main] VAR 60 s stereo: device_ms={var_ms:.2f} wall_s={var_wall:.4f} "
          f"audio_s_per_s={sec / (var_ms / 1e3):.1f} launches={main_launches} "
          f"rerun_steps={var_reruns} card='{card}'")
    staged_ms = sum(n * stages[k] for k, n in VAR_STAGES.items())
    print(f"[main] VAR stages {VAR_STAGES} account for {staged_ms:.2f} ms "
          f"of {var_ms:.2f} ms")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[main] SM clock after the render, current and max: {clocks}")
    profile_render(lambda: var(x, v, SR), "VAR")

    n1 = int(SR)
    y_cpu = var(torch.from_numpy(x_np[:, :n1]), v, SR)
    rep = compare_audio(y_cpu.to(torch.float32).numpy(),
                        y[:, :n1].to(torch.float32).cpu().numpy())
    print(f"[main] first 1 s, CUDA vs CPU render: {rep.summary()}")
    check(rep.audio_passed, f"CUDA render disagrees with CPU at {AUDIO_EPS}")
    for a in var_scans:
        witnessed("VAR follower input", a)

    # the same render on program-like material: a 2 s silent lead-in,
    # 1 s silent gaps at 10, 20, 30 and 40 s, a 5 s fade-out to silence.
    # In silence VAR's detector decays at its release pole and a guess
    # does not merge, so the fix-up re-runs there.
    s1 = int(SR)
    x_prog = rng.randn(2, MAIN_T) * 0.25
    x_prog[:, :2 * s1] = 0.0
    for a in range(10 * s1, 50 * s1, 10 * s1):
        x_prog[:, a:a + s1] = 0.0
    x_prog[:, -5 * s1:] *= np.linspace(1.0, 0.0, 5 * s1)
    x_prog = torch.from_numpy(x_prog).to(cuda)
    prog_scans = caught_scans(lambda: var(x_prog, v, SR))   # warm-up
    SS.LAUNCHES = 0
    zero_reruns()
    prog_ms = cuda_ms(lambda: var(x_prog, v, SR))
    prog_reruns, prog_launches = rerun_steps(), SS.LAUNCHES
    print(f"[main] VAR 60 s stereo, program-like material: device_ms="
          f"{prog_ms:.2f} audio_s_per_s={sec / (prog_ms / 1e3):.1f} "
          f"launches={prog_launches} rerun_steps={prog_reruns} (share "
          f"{prog_reruns / MAIN_T:.4f} of T) card='{card}'")
    for a in prog_scans:
        witnessed("VAR follower input, program-like", a)

    # 7. batch path: five modules, 8 files x 10 s ----------------------------
    batch = {}
    for slug in FAUST_MODULES:
        r = FaustBatchRenderer(slug, srate=SR, device=cuda)
        xb = (rng.randn(BATCH_FILES, r.nch, BATCH_T) * 0.25).astype(np.float32)
        xb = torch.from_numpy(xb).to(cuda)
        scans = caught_scans(lambda: r.render_files(xb))   # warm-up
        SS.LAUNCHES = 0
        zero_reruns()
        out = []
        ms = cuda_ms(lambda: out.append(r.render_files(xb)))
        reruns = rerun_steps()
        yb = out[0]
        check(tuple(yb.shape) == tuple(xb.shape), f"{slug} batch shape")
        check(bool(torch.isfinite(yb).all()), f"{slug} batch not finite")
        check(SS.LAUNCHES > 0 or slug not in ("VAR", "RED"),
              f"{slug} batch skipped the switching scan")
        audio_s = BATCH_FILES * BATCH_T / SR
        batch[slug] = audio_s / (ms / 1e3)
        print(f"[batch] {slug} {BATCH_FILES}x{r.nch}ch x 10 s: device_ms={ms:.2f} "
              f"audio_s_per_s={batch[slug]:.1f} switching_scan_launches="
              f"{SS.LAUNCHES} rerun_steps={reruns} card='{card}'")
        for a in scans:
            witnessed(f"{slug} batch follower input", a)
        # every module is causal: the first second of each file against
        # the same module's CPU render of that second
        y_cpu = FaustBatchRenderer(slug, srate=SR, device="cpu").render_files(
            xb[:, :, :n1].cpu())
        rep = compare_audio(y_cpu.reshape(-1, n1).numpy(),
                            yb[:, :, :n1].reshape(-1, n1).cpu().numpy())
        print(f"[batch] {slug} first 1 s, CUDA vs CPU render: {rep.summary()}")
        check(rep.audio_passed,
              f"{slug} batch render disagrees with CPU at {AUDIO_EPS}")

    return {
        "name": "switching_scan",
        "route": "cuda",
        "source": "zorak_tpu_torch/csrc/switching_scan.cu",
        "replaces": "zorak_tpu/kernels/pallas_scan.py:52",
        "launches": main_launches["switching_scan"],
        "max_abs_err": scan_err,
        "ms": scan_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "chain_ms": chain_ms,
        "chunk_chain_ms": chunk_chain_ms,
        "earlier_ms": earlier_ms,
        "worst_ms": worst_ms,
        "rerun_steps": var_reruns,
        "worst_rerun_steps": worst_reruns,
        "program_rerun_steps": prog_reruns,
        "chunk": chunk,
        "warmup": warmup,
        "library_ms": None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="jsfx,faust",
                    help="comma-separated: jsfx, faust (default both)")
    phases = set(ap.parse_args(argv).phases.split(","))
    if not phases or phases - {"jsfx", "faust"}:
        ap.error("--phases takes jsfx, faust or both")
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import zorak_tpu_torch

    # the kernels must build from this checkout's sources, not an installed copy
    check(Path(zorak_tpu_torch.__file__).resolve().parents[1]
          == Path(__file__).resolve().parent,
          f"zorak_tpu_torch imported from {zorak_tpu_torch.__file__}, "
          "not from this checkout")
    from zorak_tpu_torch.kernels import _build

    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED)

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build: one nvcc a source, all started together -----------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {', '.join(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernels = []
    if "jsfx" in phases:
        # 3. K2 and K3 against their plain versions; 4. the JSFX main path
        # a seeded stream of their own: the Faust phases draw the same
        # inputs whether or not these ran before them
        rng_jsfx = np.random.RandomState(SEED + 5)
        k2 = linrec_phase(torch, cuda, rng_jsfx)
        k3 = ring_taps_phase(torch, cuda, rng_jsfx)
        launches = jsfx_phase(torch, cuda, rng_jsfx, card)
        for entry in (k2, k3):
            entry["launches"] = launches["fallback"][entry["name"]]
            entry["launches_wide"] = launches["wide"][entry["name"]]
        kernels += [k2, k3]
        print(f"[done] jsfx phases at {time.perf_counter() - t_start:.1f} s")
    if "faust" in phases:
        kernels.insert(0, faust_phases(torch, cuda, rng, card))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
