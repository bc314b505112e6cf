#!/usr/bin/env python3
"""On-card smoke test of the zorak_tpu_torch port (one NVIDIA GPU, Hopper).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device   the card's name and power limit (nvidia-smi);
2. build    every CUDA kernel of the path, from csrc/ in this checkout;
3. kernels  each kernel against its plain PyTorch version on the same
            CUDA inputs.  The switching scan (K1) must be bit-identical
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
4. main     VAR on 60 s of 48 kHz stereo noise (seeded numpy) on CUDA:
            launch counts, re-run steps, finite output, timing, and the
            first second against the port's CPU render at the audio
            epsilon; then VAR on 60 s of program-like material (noise
            with a silent lead-in, silent gaps and a fade-out): time and
            re-run steps;
5. batch    all five Faust modules through FaustBatchRenderer on
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

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SR = 48000.0
MAIN_T = 2_880_000          # 60 s at 48 kHz
BATCH_FILES, BATCH_T = 8, 480_000
SEED = 20261016

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


def var_profile(render) -> None:
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
    print(f"[profile] VAR render: {len(kernels)} device events, busy "
          f"{busy_us / 1e3:.2f} ms of a {span_us / 1e3:.2f} ms span, idle share "
          f"{1.0 - busy_us / span_us:.3f}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {us / 1e3:9.3f} ms  x{n:<4d} {name[:90]}")


def main() -> int:
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
    from zorak_tpu_torch.kernels import switching_scan as SS
    from zorak_tpu_torch.models import FAUST_MODULES, dspkit as K
    from zorak_tpu_torch.models import get_faust_module
    from zorak_tpu_torch.parallel import FaustBatchRenderer
    from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio

    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED)

    def zero_reruns():
        for v in SS.RERUN_STEPS.values():
            v.zero_()

    def rerun_steps():
        return sum(int(v.item()) for v in SS.RERUN_STEPS.values())

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build("switching_scan")
    print(f"[build] switching_scan in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] switching_scan: {line.strip()}")

    # 3. kernels against their plain versions -----------------------------------
    # K1 must equal its plain loop bit for bit: compare the integer views
    def same_bits(a, b):
        iv = torch.int64 if a.dtype == torch.float64 else torch.int32
        return a.shape == b.shape and torch.equal(a.view(iv), b.view(iv))

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

    # 4. main path: VAR, 60 s of 48 kHz stereo -------------------------------
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
    var_profile(lambda: var(x, v, SR))

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

    # 5. batch path: five modules, 8 files x 10 s ----------------------------
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

    kernels = [{
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
    }]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
