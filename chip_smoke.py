#!/usr/bin/env python3
"""On-card smoke test of the zorak_tpu_torch port (one NVIDIA GPU, Hopper).

    python3 chip_smoke.py

    python3 chip_smoke.py --phases jsfx      # the JSFX phases alone
    python3 chip_smoke.py --phases batch     # the batch phases alone
    python3 chip_smoke.py --phases spectral  # the spectral phase alone

Phases, in order; any failure raises and the script exits non-zero
without printing a result (`--phases` takes any of `jsfx`, `batch`,
`spectral` and `faust`, all four by default; device and build always
run; `k4sweep` is described at the end):

1. device   the card's name and power limit (nvidia-smi);
2. build    every CUDA kernel of the paths, from csrc/ in this checkout,
            one nvcc a source, all started together (the generated
            scan-group kernels are built in phase 3, all together too);
3. kernels (jsfx)  the linear-recurrence scan (K2, a chunked affine
            scan) against `linrec_chunked`, the NumPy mirror of its
            order (equal, every NaN one value), and within 1e-9 x max|z|
            of the sequential loop and of its plain doubling ladder
            (scalar and per-sample a; k in 1, 2, 8; L in 1, 7, 4,096,
            131,072; z0 != 0, a = 0, NaN in b; |a| > 1 with overflow,
            integrators on integer counters, exact; L in 100, 1,000,
            131,071), its time at the main shape beside one chunk (a
            thread a row), the ladder's, its bounds, a one-thread chain
            probe and a sweep over the chunk.  The ring tap sum (K3, a
            window staged in shared memory, the ring read in place,
            sibling chains in one launch) against its plain fold,
            bit-identical, at 16, 192 and 300 taps, delays 0 to mod,
            history alone, cursor starts 0, mod - 1 and the middle, L =
            131,072, a short remainder and 1, scalar, stream and 0-d
            inits, batches of five chains of different tables, a chain
            cut into windows, every tile, and the earlier design (a
            thread a sample); at the two delay networks' planned
            launches, the pair in one launch beside one chain, two
            launches, the earlier design and the buffers the emitter
            joined before, the plain fold's time, a dense FIR
            convolution's (the library call), a sweep over the tile and
            three floors (operations at two roundings, on-chip reads,
            bytes).  The
            scan-group kernels (K4, a speculate and a fix-up kernel),
            generated from each plugin's own step list: eight bodies
            (followers, a coupled pair, a nonlinear recurrence, a peak
            hold fed from a delay, a wrap loop, a sin in the loop)
            against the plain Python loop on the same inputs at L in 1,
            7, 4,096, 131,072, non-zero start carries, with and without
            NaN and -0.0 in the externals, at the default chunk and
            warm-up and at a small one (many chunks re-run):
            bit-identical, every NaN counted as one value, or within
            1e-8 for the body that calls the device's libm; at L =
            131,072 its time and re-run steps on noise and on
            program-like material beside the walk in series (one chunk),
            the plain loop's, a one-thread chain probe of the same body,
            the chunked chain bound, the bytes bound, each body's merge
            step and a launch-per-sample estimate; the follower after a
            burst into exact silence (bit-identical; launches that
            re-walk and launches in series take turns); then every
            operation of csrc/scan_ops.cuh on every pair of a grid of
            edge values against the scalar semantics, bit for bit (the
            libm calls within 4 ulp), as one chunk;
4. main (jsfx)  the in-repo delay network, its 192-tap widening and a
            cross-fed network (the right ring written from the left sum)
            through PluginInstance.render on 60 s of 48 kHz stereo noise
            at the default segment length: engine torch-vector, K2 and
            K3 launch counts, finite output, timing, a torch.profiler
            pass (device events a segment), the first second against
            the port's CPU render, the
            first 4,800 samples against the Python golden and the
            carries after 10 s against the CPU render's within 1e-8;
            then, the same way, two plugins with sequential scan groups
            (a follower that feeds both channels, and two independent
            envelopes): engine torch-vector, K4 launches = levels x
            segments, K4's re-run steps; each whole 60 s render (the
            fallback network reported, not held: it misses its own
            golden) against the native C golden through
            `null_test_plugin(golden="native")`: audio within 1e-5, vars
            and heap within 1e-8 at the end; then the CLI's `verify`
            (native golden, an export bundle) on a one-entry catalog;
4a. batch   K3 and K4 with a files axis (1, 3 and 8 files, other data
            a file, NaN in one, for K4 the last file's burst into
            silence) against their plain versions and against each
            file's own launch, bit for bit, the K4 re-run steps and
            flags of a batch those of its files alone; then the JSFX
            batch path, BatchRenderer on 8 files x 60 s of stereo noise
            at the bench's segment ((1 << 15) * 11, 8 segments) through
            the 192-tap widening, the cross-fed network and the two
            scan-group plugins: every file torch.equal to its solo
            render on the card, K2, K3 and K4 launched exactly as often
            as for one file, the K2, K3 and K4 launches of the middle
            segment held bit for bit to their plain versions on the same
            inputs (linrec_chunked, ring_tap_sum_reference,
            scan_group_plain), times beside one file's, a profiler pass;
            the catalog functions (catalog_batch_render,
            catalog_stacked_render) on a temporary catalog of two Faust
            modules and three JSFX plugins, CUDA against CPU, K1 to K4
            launched; then zorak_tpu_torch/bench.py's config 1:
            ddt_offline_render_rtx at both segment lengths and
            ddt_batched;
4b. spectral  the STFT framing (K7a), overlap-add (K7b) and gate gain
            (K7c) kernels and the partition MAC (K8) against their plain
            versions, bit-identical (every NaN one value), at odd shapes
            (1 and 3 lanes, a hop that does not divide the size, T <
            size, T not a multiple of the part size, an IR under one
            partition, NaN, inf and -0.0 in the inputs; for K8 the edges
            of its walk, every tile it is built for, scale 1 and 2^-12)
            and at the bench's (32 lanes x 20 s, size 2,048, hop 512; a
            131,072-tap IR at part size 2,048; K8's every tile, irfft's
            1/N, and the earlier design); the convolution with 1/N folded
            into K8 against irfft's own 1/N, bit for bit; stft_process,
            spectral_gate and partitioned_convolve on the card against
            the port's CPU render (the convolution also against scipy's
            fftconvolve in f64) at the odd shapes and, on two lanes, at
            the bench's; each kernel's time beside its bound, its plain
            version's and the library call's (Tensor.unfold x window for
            K7a, F.fold x 1/wsum for K7b, a grouped complex conv1d with
            TF32 off for K8; K7c has none); K8's tiles swept, its design
            and the earlier one timed in turns beside the SM clock under load;
            then the three bench sections of zorak_tpu_torch/bench.py as
            a user calls them: each kernel's launches a section call,
            and the stft2048_overlap_add_rtx,
            restoration_spectral_gate_rtx and
            partitioned_convolution_131072tap_rtx figures; a profiler
            pass a pipeline (the convolution's must hold K8 and no
            multiply pass);
5. kernels (faust)  the switching scan (K1) must be bit-identical
            (integer views equal), in f64 and f32: at modest shapes, at
            the batch and main paths' shapes (its one-chunk case too),
            with a small chunk and warm-up at T from 1 to 20,000 (many
            chunks, re-runs), and on inputs where trajectories do not
            merge (a burst into exact silence, also at T = 60,000 with
            the default chunk and warm-up), constant input, -0.0 and NaN.
            Its time at the main shape beside the one-chunk case's (a
            thread per lane) and the worst case's, re-run steps, and the
            chain bound from a one-thread probe.  The plain loop runs
            the main length once, in f64 (minutes), and a tenth of it in
            f32; for the rest at that length K1 at its defaults is held
            bit for bit to K1 as one chunk: the main shape in f32, the
            worst case and every input the VAR and RED renders below
            give K1;
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
worst case, and the program-like render's re-run steps; K2, K3 and K4
carry `launches_batched`, their launches in the batch phase's render of 8
files) and, last, the device JSON line.  Each phase prints the seconds
it took.

    python3 chip_smoke.py --phases k4sweep

runs neither path: it times K4 at L = 131,072 with 2 to 32 samples held
in registers at once, at five pairs of chunk and warm-up beside the
walk in series, and with the speculate kernel loading the externals the
other way (staged through shared memory, or in register blocks), for the
K4 bodies with one, two and three external streams, each held bit for
bit to the default's output first.

Imports nothing of JAX or of the JAX package `zorak_tpu`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
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

# two independent attack/release followers, one a channel: one DAG level,
# two components, so K4 walks them in two blocks, one thread each
STEREO_FOLLOWERS_SRC = """\
desc:two attack/release followers
@init
up = 0.9; dn = 0.999;
@sample
x0 = abs(spl0); x1 = abs(spl1);
e0 = x0 > e0 ? x0 + (e0 - x0)*up : x0 + (e0 - x0)*dn;
e1 = x1 > e1 ? x1 + (e1 - x1)*up : x1 + (e1 - x1)*dn;
spl0 = spl0*(1 - 0.5*e0); spl1 = spl1*(1 - 0.5*e1);
"""

# scan-group bodies held to the plain loop: name -> (source, channels).
# The linear pair `a2 = 0.95*b + ...; b = 0.9*a2 + ...` folds into one
# linear recurrence (K2's), so the pair here is coupled through a select.
K4_BODIES = {
    "follower": (SCAN_GROUP_SRC, 2),
    "stereo_followers": (STEREO_FOLLOWERS_SRC, 2),
    "attack_release_envelope": (
        "@init\na_att = 0.6; a_rel = 0.999;\n@sample\nr = abs(spl0);\n"
        "env = r > env ? a_att*env + (1-a_att)*r : a_rel*env + (1-a_rel)*r;\n"
        "spl0 = env;\n", 1),
    "coupled_pair": (
        "@sample\nx = abs(spl0);\n"
        "fast = x > slow ? x : fast*0.9 + slow*0.1;\n"
        "slow = fast > slow ? slow + (fast - slow)*0.01 : slow*0.9995;\n"
        "spl0 = fast - slow;\n", 1),
    "nonlinear_self_recurrence": (
        "@sample\nz = z*0.9 + z*z*0.01 + spl0*0.1;\nspl0 = z;\n", 1),
    "group_feeding_from_vectorized_delay": (
        "@init\nMASK = 511; d = 100;\n@sample\nbuf[w & MASK] = spl0;\n"
        "late = buf[(w - d) & MASK];\n"
        "pk = abs(late) > pk ? abs(late) : pk*0.995;\n"
        "spl0 = late * (1 - 0.5*pk);\nw += 1;\n", 1),
    "wrap_feeding_recurrence": (
        "@sample\nph += 0.37 + spl0;\nwhile (ph > 1) ( ph -= 2; );\n"
        "spl0 = ph * 0.5;\n", 1),
    "transcendental_in_the_loop": (
        "@sample\nz = sin(z*0.9 + spl0);\nspl0 = z;\n", 1),
}
# the sweep over register block sizes: one, two and three externals, one
# and two components, a data-dependent loop
K4_SWEEP_BODIES = ("follower", "stereo_followers", "attack_release_envelope",
                   "wrap_feeding_recurrence")
K4_SWEEP_UNROLLS = (2, 4, 8, 16, 32)
# (chunk, warm-up) pairs the sweep times beside the walk in series
K4_SWEEP_PLANS = ((1024, 49152), (1024, 16384), (256, 16384), (4096, 16384),
                  (1024, 8192))
K4_LIBM_TOL = 1e-8     # the device's sin is 1 to 2 ulp from glibc's
K4_LIBM_ULPS = 4.0     # one libm call on the card against glibc's
K4_EDGE_VALUES = [
    0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 0.3, -0.999, 2.5, -2.5, 3.0, 7.0, -7.0,
    31.0, 32.0, 33.0, -33.0, 255.75, 4.9e-324, -4.9e-324, 1e-310,
    2.2250738585072014e-308, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 1,
    2.0 ** 31 + 0.5, -(2.0 ** 31) - 1, 2.0 ** 32, 2.0 ** 32 + 5,
    -(2.0 ** 32) - 3, 2.0 ** 53, 2.0 ** 62, -(2.0 ** 62), 1.5 * 2.0 ** 62,
    -1.5 * 2.0 ** 62, 2.0 ** 63, -(2.0 ** 63), 1e300, -1e300, 3.5e38,
    float("inf"), float("-inf"), float("nan"),
]
K1_PLAIN_T = 288_000   # K1's plain Python loop in f32: a tenth of MAIN_T

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}   # outside tensor cores
# a DMUL or a DADD issues at the DFMA instruction rate, half the f64 peak
F64_INSTR_PER_S = PEAK_OPS_PER_S["float64"] / 2
SMEM_BYTES_PER_CLK = 128   # shared memory / L1 of one SM (Hopper)
SCAN_OPS_PER_STEP = 5   # compare, select, subtract, multiply, add
# dspkit stages one VAR render runs (zorak_tpu_torch/models/faustmods.py,
# VAR.forward): two noise streams, eight biquads, five one-poles, one scan
VAR_STAGES = {"lcg_noise": 2, "biquad_tf2": 8, "onepole": 5,
              "switching_scan": 1}

# the spectral slice: STFT sizes, the bench's shapes (bench.py:137-206)
SPEC_SIZE, SPEC_HOP, PART = 2048, 512, 2048
# small odd shapes for K7a/K7b (lanes, T, size, hop): one and three lanes,
# a hop that does not divide the size, T < size, T not a multiple of hop
K7_ODD = [(1, 5000, 512, 128), (3, 7001, 600, 250), (1, 300, 512, 128),
          (3, 4097, 2048, 512), (1, 48000, 1024, 384)]
# (lanes, frames, bins, parts) for K8: one partition, an IR under one
# partition's worth of frames, parts beyond one staged group (64); then
# the edges of the walk of each tile (R frames a thread, W warps, 64
# partitions a group; the default R = 16, W = 8): frames 1, R - 1, R + 1,
# W*R + 1, two tiles and a bit; parts < R, 65, more than the frames,
# three groups; 33 bins; three lanes
K8_ODD = [(1, 5, 9, 1), (3, 7, 33, 4), (2, 3, 17, 9), (1, 20, 5, 70),
          (3, 130, 1025, 65), (1, 1, 2049, 64), (3, 1, 33, 5),
          (3, 15, 33, 9), (2, 17, 33, 65), (3, 129, 33, 130),
          (3, 259, 65, 131), (2, 31, 33, 7), (2, 33, 33, 40),
          (1, 65, 33, 66)]
# (lanes or None, T, IR taps, part_size) for the whole convolution
CONV_ODD = [(None, 20000, 100, 1024), (3, 5000, 3000, 512),
            (1, 700, 300, 256), (3, 4097, 9000, 256), (None, 100, 1000, 256)]
WSUM_MIN = 1e-3   # below it the OLA normalisation magnifies FFT rounding
# a complex MAC on the card: four multiplies and four adds, two roundings
# (no contraction), at the FP32 instruction rate (half the FMA peak)
F32_INSTR_PER_S = PEAK_OPS_PER_S["float32"] / 2
MAC_INSTR = 8


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


def traced(fn):
    """The profiler events of one fn() call, the card synchronised after
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device time of one fn() call: `reps` calls captured in one
    CUDA graph and replayed, so that the host's cost of each launch,
    which can exceed a short kernel's, does not separate the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                       # builds and first allocations, uncaptured
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, reps=replays) / reps
    del graph
    return ms


def scan_bound_ms(n_t: int, lanes: int, dtype: str):
    """Least time for the scan: bytes over HBM rate vs ops over peak."""
    itemsize = 8 if dtype == "float64" else 4
    nbytes = (2 * n_t * lanes + 3 * lanes) * itemsize
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = SCAN_OPS_PER_STEP * n_t * lanes / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def profile_render(render, label: str, segments: int = 0, traces: int = 3):
    """Device busy time, idle share and top kernels of one render, from
    the fullest of `traces` torch.profiler traces of the kernels it ran
    (a trace can miss a few of a render's launches); returns the device
    events a segment (None where the trace holds none or `segments` is 0)
    and (launches, device us) in the trace by kernel name."""
    from torch.autograd import DeviceType

    kernels = max(([e for e in traced(render)
                    if e.device_type == DeviceType.CUDA]
                   for _ in range(traces)), key=len)
    if not kernels:
        print("[profile] the trace holds no device events: busy time and "
              "idle share not measured")
        return None, {}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    per_seg = (f" ({len(kernels) / segments:.1f} a segment)" if segments
               else "")
    print(f"[profile] {label} render: {len(kernels)} device events{per_seg}, busy "
          f"{busy_us / 1e3:.2f} ms of a {span_us / 1e3:.2f} ms span, idle share "
          f"{1.0 - busy_us / span_us:.3f}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {us / 1e3:9.3f} ms  x{n:<4d} {name[:90]}")
    return len(kernels) / segments if segments else None, by_name


def same_bits(a, b):
    """Equal as bit patterns (integer views), not as floats."""
    import torch

    iv = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(iv), b.view(iv))


def same_values(a, b):
    """Equal as bit patterns, every NaN counted as one value (no EEL2
    operation reads a NaN's sign or payload)."""
    import torch

    if a.shape != b.shape:
        return False
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros_like(a)
    return bool(torch.equal(nan_a, nan_b) and same_bits(
        torch.where(nan_a, zero, a), torch.where(nan_b, zero, b)))


def bound_ms(nbytes: float, ops: float, dtype: str = "float64"):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def linrec_phase(torch, cuda, rng):
    """K2 against `linrec_chunked`, the NumPy mirror of its order (equal,
    every NaN one value), and within TOL_REL x max|z| of the sequential
    loop and of its plain doubling ladder; times at the main shape."""
    from zorak_tpu_torch.kernels import linrec_scan as LS

    tol_rel = LS.TOL_REL
    worst = {"sequential": 0.0, "ladder": 0.0}

    def held(what, a, b, z0, exact_seq=False, overflow=False):
        at, bt, zt = (torch.from_numpy(v).to(cuda) for v in (a, b, z0))
        got = LS.linrec_scan(at, bt, zt)
        torch.cuda.synchronize()
        got = got.cpu()
        mirror = torch.from_numpy(LS.linrec_chunked(a, b, z0))
        check(same_values(got, mirror),
              f"linrec_scan {what} differs from linrec_chunked")
        seq = torch.from_numpy(LS.linrec_sequential(a, b, z0))
        if exact_seq:
            check(same_values(got, seq), f"linrec_scan {what} is not exact")
        ladder = LS.linrec_scan_reference(at, bt, zt).cpu()
        fin = torch.isfinite(seq)
        scale = float(seq[fin].abs().max()) if fin.any() else 1.0
        for name, ref in (("sequential", seq), ("ladder", ladder)):
            inf = torch.isinf(ref)
            # the ladder composes maps whose products overflow, so where
            # the loop overflows it may give NaN for inf: held on the
            # loop's finite values there
            check((overflow and name == "ladder")
                  or (torch.equal(torch.isnan(ref), torch.isnan(got))
                      and torch.equal(inf, torch.isinf(got))
                      and torch.equal(ref[inf], got[inf])),
                  f"linrec_scan {what}: NaN or inf elsewhere than the "
                  f"{name}'s")
            fin = torch.isfinite(seq) & torch.isfinite(ref)
            err = float((ref[fin] - got[fin]).abs().max()) if fin.any() else 0.0
            worst[name] = max(worst[name], err / max(scale, 1e-300))
            check(err <= tol_rel * scale, f"linrec_scan {what}: {name} "
                  f"differs by {err:.3e} (limit {tol_rel} x {scale:.3e})")

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
                    held(f"k={k} L={n} vec_a={vec_a} nan={with_nan}", a, b, z0)
        # |a| > 1 (and one that overflows), an integrator on integer
        # counters (exact), L not a multiple of the chunk and below it
        for n in (100, 1000, SEG_L - 1):
            shape = (3, n) if vec_a else (3,)
            a = rng.uniform(1.0, 1.0 + 2.0 / n, shape)
            a[2] = 1.5                                 # overflows to inf
            held(f"|a| > 1 L={n} vec_a={vec_a}", a, rng.randn(3, n),
                 rng.uniform(-1.0, 1.0, 3), overflow=True)
            held(f"integrator L={n} vec_a={vec_a}", np.ones(shape),
                 rng.randint(-1000, 1000, (3, n)).astype(np.float64),
                 np.array([0.0, 5.0, -7.0]), exact_seq=True)
        print(f"[kernels] linrec_scan {'per-sample' if vec_a else 'scalar'}"
              f" a: k in (1, 2, 8), L in (1, 7, 4096, {SEG_L}), with and "
              "without NaN; |a| > 1 with overflow, integrators (exact), L "
              f"in (100, 1000, {SEG_L - 1}): equal to linrec_chunked "
              f"(chunk {LS.CHUNK}), within {tol_rel} x max|z| of the "
              f"sequential loop (worst {worst['sequential']:.3e}) and of the "
              f"plain ladder (worst {worst['ladder']:.3e})")

    # the main path's shape: the two one-poles of the delay network, one
    # wave of k = 2 rows with scalar a over a full segment
    k, n = 2, SEG_L
    a = torch.full((k,), 0.995, dtype=torch.float64, device=cuda)
    b = torch.from_numpy(rng.randn(k, n) * 0.05).to(cuda)
    z0 = torch.zeros(k, dtype=torch.float64, device=cuda)
    got = LS.linrec_scan(a, b, z0)
    ref = LS.linrec_scan_reference(a, b, z0)
    err = float((got - ref).abs().max())
    run = lambda: LS.linrec_scan(a, b, z0)
    run()
    scan_ms = cuda_ms(run, reps=50)
    one_chunk_ms = cuda_ms(lambda: LS.linrec_scan(a, b, z0, chunk=n), reps=10)
    plain_ms = cuda_ms(lambda: LS.linrec_scan_reference(a, b, z0), reps=5)
    av = torch.from_numpy(rng.uniform(0.5, 0.9999, (k, n))).to(cuda)
    vec_ms = cuda_ms(lambda: LS.linrec_scan(av, b, z0), reps=50)
    vec_plain_ms = cuda_ms(lambda: LS.linrec_scan_reference(av, b, z0), reps=5)
    scan_ms_2 = cuda_ms(run, reps=50)
    by_chunk = {c: cuda_ms(lambda c=c: LS.linrec_scan(a, b, z0, chunk=c),
                           reps=50) for c in (64, 128, 256, 512, 1024, 4096)}
    # each input read once, the output written once; 2 operations a step
    b_ms, b_by = bound_ms((2 * k * n + 2 * k) * 8, 2 * k * n)
    # the chain: the same dependent steps in one thread, a and b cycling
    # through registers (checked against the sequential loop first)
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
    chain_ns = chain_ms * 1e6 / n
    # the chunked scan's chains: compose and apply walk a chunk each, the
    # carry pass walks a row's maps
    n_chunks = -(-n // LS.CHUNK)
    chunk_chain_ms = (2 * LS.CHUNK + n_chunks - 1) * chain_ns * 1e-6
    print(f"[kernels] linrec_scan k={k} L={n} scalar a, chunk {LS.CHUNK}: "
          f"ms={scan_ms:.4f} (again {scan_ms_2:.4f}) one_chunk_ms="
          f"{one_chunk_ms:.4f} (a thread a row; the earlier one-thread walk "
          f"with helper warps read 1.344 ms on an NVIDIA H100 80GB HBM3 at "
          f"700 W) plain_ms={plain_ms:.4f} "
          f"max_abs_err_vs_ladder={err:.3e} bound_ms={b_ms:.5f} ({b_by}) "
          f"chain_ms={chain_ms:.4f} ({chain_ns:.3f} ns a step), the kernel "
          f"{scan_ms / chain_ms:.3f}x it; chunked chains (2 x {LS.CHUNK} + "
          f"{n_chunks - 1} steps) {chunk_chain_ms:.4f} ms, the kernel "
          f"{scan_ms / chunk_chain_ms:.3f}x it; per-sample a: ms={vec_ms:.4f} "
          f"plain_ms={vec_plain_ms:.4f}")
    print("[kernels] linrec_scan k=2 L=%d scalar a, ms by chunk: %s" % (
        n, " ".join(f"{c}: {v:.4f}" for c, v in by_chunk.items())))
    return {
        "name": "linrec_scan", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/linrec_scan.cu",
        "replaces": "zorak_tpu/lowering/eelmath.py:277",
        "launches": 0, "max_abs_err": err, "ms": scan_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "chain_ms": chain_ms,
        "chunk_chain_ms": chunk_chain_ms, "earlier_ms": one_chunk_ms,
        "chunk": LS.CHUNK, "ms_by_chunk": by_chunk, "vector_a_ms": vec_ms,
        "vector_a_plain_ms": vec_plain_ms,
        "worst_rel_err_vs_sequential": worst["sequential"],
        "worst_rel_err_vs_ladder": worst["ladder"], "shape": [k, n],
    }


def tap_case(rng, n_taps, mod, n, long_only=False):
    """A ring [mod] and a stream [n] (None: every delay >= n, history
    alone) with tap starts spread over [history | stream], delay 0 (start
    mod) and delay mod (start 0) included."""
    hi = mod - n if long_only else mod
    starts = rng.randint(0, hi + 1, n_taps)
    starts[0], starts[-1] = hi, 0
    return (rng.randn(mod), None if long_only else rng.randn(n),
            starts.tolist(), rng.uniform(-0.1, 0.1, n_taps).tolist())


def tap_bounds(tables, streamed, n, sms, clock_hz):
    """K3's three floors for one launch: the f64 instructions at two
    roundings (a DMUL and a DADD a tap and sample, each at the DFMA
    instruction rate), one 8-byte on-chip read a tap and sample, and the
    bytes from device memory (the part of each buffer the taps reach,
    output, tables; the inits are scalars)."""
    taps = sum(tables.counts)
    ops_ms = 2 * taps * n / F64_INSTR_PER_S * 1e3
    smem_ms = 8 * taps * n / (SMEM_BYTES_PER_CLK * sms * clock_hz) * 1e3
    nbytes = 12 * taps
    for st, (mod, has_stream) in zip(tables.starts, streamed):
        end = min(max(st) + n, mod + (n if has_stream else 0))
        nbytes += 8 * (end - min(st) + n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    floors = {"operations": ops_ms, "on-chip reads": smem_ms,
              "bytes": bytes_ms}
    return floors, max(floors, key=floors.get)


def ring_taps_phase(torch, cuda, rng):
    """K3 against its plain fold, bit-identical (single chains, batches,
    wrapped cursors, history alone, windows cut to fit, both designs);
    then, at the two delay networks' planned launches, each part of the
    design timed on its own beside the earlier design, the plain fold, a
    dense-FIR convolution (the library call) and the three floors."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import ring_taps as RT
    from zorak_tpu_torch.runtime.engine import PluginInstance

    def T(v):
        return torch.from_numpy(np.asarray(v, dtype=np.float64)).to(cuda)

    def on_card(chains, cursors, n, tile=None):
        """chains: (ring, stream, starts, gains, init) in numpy and lists
        -> the wrapper's arguments on the card (tile None: the planner's
        choice for L = n)."""
        tables = RT.TapTables([(st, g) for _r, _s, st, g, _i in chains],
                              cuda, tile, n)
        return (tables, [T(r) for r, *_ in chains], list(cursors),
                [None if s is None else T(s) for _r, s, *_ in chains],
                [T(i) if isinstance(i, np.ndarray) else i
                 for *_, i in chains], n)

    def held(what, args, staged=True):
        got = RT.ring_tap_sum(*args, staged=staged)
        ref = RT.ring_tap_sum_reference(*args)
        torch.cuda.synchronize()
        check(same_bits(got, ref), f"ring_tap_sum {what} "
              f"({'staged' if staged else 'global'}) differs from its plain "
              "fold")

    for n_taps, mod in ((16, 4096), (192, 16384), (300, 16384)):
        for n in (SEG_L, 6784, 1):
            for long_only in (False, True):
                if long_only and n > mod:
                    continue
                ring, stream, starts, gains = tap_case(rng, n_taps, mod, n,
                                                       long_only)
                for start in (0, mod - 1, mod // 2 + 3):
                    for init in (0.0, rng.randn(n)):
                        args = on_card([(ring, stream, starts, gains, init)],
                                       [start], n)
                        what = (f"taps={n_taps} mod={mod} L={n} long_only="
                                f"{long_only} start={start}")
                        held(what, args)
                        held(what, args, staged=False)
        print(f"[kernels] ring_tap_sum taps={n_taps} mod={mod}, L in ({SEG_L}, "
              "6784, 1), delays 0 to mod, history alone, cursor starts 0, "
              "mod - 1 and the middle, scalar and stream init, staged and "
              "global kernels: bit-identical to the plain fold")
    # a batch: tables of 2 to 300 taps, rings of three sizes, history
    # alone beside streams, scalar, stream and 0-d inits; a chain whose
    # taps span 2^18 samples, cut into windows; every tile
    for n in (SEG_L, 6784, 1):
        parts = [tap_case(rng, 2, 64, n), tap_case(rng, 16, 4096, n),
                 tap_case(rng, 300, 16384, n),
                 tap_case(rng, 24, 1 << 18, n, long_only=n < 1 << 18),
                 tap_case(rng, 192, 16384, n, long_only=n <= 16384)]
        inits = [0.0, rng.randn(n), np.array(-0.5), 1.25, rng.randn(n)]
        chains = [p + (i,) for p, i in zip(parts, inits)]
        cursors = [int(rng.randint(0, len(c[0]))) for c in chains]
        for tile in RT.TILES:
            args = on_card(chains, cursors, n, tile)
            held(f"batch of {len(chains)} L={n} tile={tile} windows="
                 f"{args[0].n_windows}", args)
        held(f"batch of {len(chains)} L={n}", args, staged=False)
    print(f"[kernels] ring_tap_sum batches of 5 chains (2 to 300 taps, rings "
          f"of 64 to 2^18, history alone, 0-d inits, windows cut to fit), "
          f"tiles {RT.TILES}: bit-identical to the plain fold")

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    out = {}
    for label, src in (("fallback", BP.FALLBACK_SRC),
                       ("wide", BP.wide_delay_network(192))):
        n = SEG_L
        kern = PluginInstance(compile_plugin_source(src), srate=SR).kernel
        launches = kern.tap_launches(n)
        check(len(launches) == 1 and len(launches[0].members) == 2,
              f"{label}: {len(launches)} tap launches planned")
        chains = []
        for m in launches[0].members:
            mod = m.region[1]
            chains.append((rng.randn(mod), rng.randn(n) if m.needs_src
                           else None, m.starts, m.gains, 0.0))
        cursors = [int(rng.randint(0, len(c[0]))) for c in chains]
        pair = on_card(chains, cursors, n)
        one = on_card(chains[:1], cursors[:1], n)
        other = on_card(chains[1:], cursors[1:], n)
        got = RT.ring_tap_sum(*pair)
        ref = RT.ring_tap_sum_reference(*pair)
        torch.cuda.synchronize()
        check(same_bits(got, ref), f"ring_tap_sum {label} pair differs from "
              "its plain fold")
        err = float((got - ref).abs().max())
        streamed = [(len(c[0]), c[1] is not None) for c in chains]

        def joined(ring, start, stream):
            # the buffer the emitter built for a chain before reading in
            # place: the history joined at the wrap, then [history | stream]
            hist = torch.cat([ring[start:], ring[:start]])
            return hist if stream is None else torch.cat([hist, stream])

        timed = {
            "ms": lambda: RT.ring_tap_sum(*pair),
            "one_chain_ms": lambda: RT.ring_tap_sum(*one),
            "earlier_one_chain_ms": lambda: RT.ring_tap_sum(*one,
                                                            staged=False),
            "two_launches_ms": lambda: (RT.ring_tap_sum(*one),
                                        RT.ring_tap_sum(*other)),
            "earlier_ms": lambda: (RT.ring_tap_sum(*one, staged=False),
                                   RT.ring_tap_sum(*other, staged=False)),
            "cat_ms": lambda: [joined(*a) for a in zip(pair[1], cursors,
                                                       pair[3])],
        }
        # the kernels' device time, in turns, twice: forwards, then
        # backwards; and the pair's launches back to back by CUDA events,
        # where the host's launch cost shows
        times = {k: [] for k in timed}
        for order in (list(timed), list(timed)[::-1]):
            for k in order:
                times[k].append(graph_ms(timed[k]))
        res = {k: min(v) for k, v in times.items()}
        spread = max(max(v) / min(v) for v in times.values())
        res["events_ms"] = cuda_ms(timed["ms"], reps=20)
        res["plain_ms"] = graph_ms(
            lambda: RT.ring_tap_sum_reference(*pair), reps=3)
        # one PyTorch call for the same function: the taps of each chain
        # as a dense FIR, both chains as the groups of one convolution
        firs, sigs = [], []
        for c, (ring, start, stream) in enumerate(zip(pair[1], cursors,
                                                      pair[3])):
            starts, gains = chains[c][2], chains[c][3]
            s_min, s_max = min(starts), max(starts)
            fir = torch.zeros(s_max - s_min + 1, dtype=torch.float64,
                              device=cuda)
            fir.index_add_(0, torch.tensor(starts, device=cuda) - s_min,
                           T(gains))
            firs.append(fir)
            sigs.append(joined(ring, start, stream)[s_min:s_max + n])
        check(len({f.numel() for f in firs}) == 1,
              f"{label}: the chains' FIRs differ in length")
        weight, sig = torch.stack(firs)[:, None], torch.stack(sigs)[None]
        lib = torch.nn.functional.conv1d(sig, weight, groups=len(firs))[0]
        lib_err = float((lib - ref).abs().max())
        check(lib.shape == ref.shape and lib_err < 1e-9,
              f"dense-FIR convolution disagrees with the tap sum: {lib_err:.3e}")
        res["library_ms"] = graph_ms(lambda: torch.nn.functional.conv1d(
            sig, weight, groups=len(firs)), reps=3)
        tiles, tiles_one = {}, {}
        for tile in RT.TILES:
            args = on_card(chains, cursors, n, tile)
            held(f"{label} pair tile={tile}", args)
            tiles[tile] = graph_ms(lambda: RT.ring_tap_sum(*args))
            args = on_card(chains[:1], cursors[:1], n, tile)
            tiles_one[tile] = graph_ms(lambda: RT.ring_tap_sum(*args))
        floors1, by1 = tap_bounds(one[0], streamed[:1], n, sms, max_mhz * 1e6)
        floors2, by2 = tap_bounds(pair[0], streamed, n, sms, max_mhz * 1e6)
        print(f"[kernels] ring_tap_sum {label}: taps={one[0].counts[0]} a "
              f"chain, rings {[c[0] for c in streamed]}, L={n}, windows "
              f"{pair[0].n_windows} for 2 chains, tile {pair[0].tile} for "
              f"the pair and {one[0].tile} for one chain, shared memory "
              f"{pair[0].smem_bytes} B a block; bit-identical max_abs_err="
              f"{err:.3e}")
        print(f"[kernels] ring_tap_sum {label}: one chain {res['one_chain_ms']:.4f}"
              f" ms, earlier design (a thread a sample, global reads) "
              f"{res['earlier_one_chain_ms']:.4f}; the pair in one launch "
              f"ms={res['ms']:.4f}, in two launches "
              f"{res['two_launches_ms']:.4f}, earlier design in two launches "
              f"{res['earlier_ms']:.4f}; the buffers the emitter joined before "
              f"reading in place (4 cats) {res['cat_ms']:.4f} ms; plain fold "
              f"{res['plain_ms']:.4f}; conv1d (two dense FIRs of "
              f"{firs[0].numel()} taps, max |delta| {lib_err:.3e}) "
              f"{res['library_ms']:.4f}; spread over two turns (max/min) "
              f"{spread:.3f} (device time: 20 calls in a CUDA graph); the pair's "
              f"launches back to back by CUDA events {res['events_ms']:.4f}")
        print(f"[kernels] ring_tap_sum {label}: by tile, the pair "
              + ", ".join(f"{t}: {ms:.4f}" for t, ms in tiles.items())
              + " ms; one chain "
              + ", ".join(f"{t}: {ms:.4f}" for t, ms in tiles_one.items())
              + " ms")
        for what, floors, by in (("one chain", floors1, by1),
                                 ("the pair", floors2, by2)):
            print(f"[kernels] ring_tap_sum {label} {what} floors: operations "
                  f"at two roundings {floors['operations']:.5f} ms, on-chip "
                  f"reads {floors['on-chip reads']:.5f} ms ({SMEM_BYTES_PER_CLK}"
                  f" B/clk x {sms} SMs at {max_mhz:.0f} MHz, the max SM "
                  f"clock), bytes {floors['bytes']:.5f} ms; binds: {by}")
        res.update({
            "max_abs_err": err, "tiles_ms": tiles,
            "one_chain_tiles_ms": tiles_one, "spread": spread,
            # the contract's bound, for the pair: bytes or operations
            "bound_ms": max(floors2["bytes"], floors2["operations"]),
            "bound_by": ("bytes" if floors2["bytes"] >= floors2["operations"]
                         else "operations"),
            "floors_ms": floors2, "binds": by2,
            "one_chain_floors_ms": floors1, "one_chain_binds": by1,
            "tile": pair[0].tile,
            "shape": [len(chains), one[0].counts[0], streamed[0][0], n]})
        out[label] = res
    fb = out["fallback"]
    return {
        "name": "ring_tap_sum", "route": "cuda",
        "source": "zorak_tpu_torch/csrc/ring_taps.cu",
        "replaces": "zorak_tpu/lowering/specialize.py:4392",
        "launches": 0, "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": fb["bound_by"], "library_ms": fb["library_ms"],
        "shape": fb["shape"], "fallback": fb, "wide": out["wide"],
    }


def scan_group_phase(torch, cuda, rng):
    """K4, generated from each body's own step list, against the plain
    Python loop on the same CUDA inputs; times at L = 131,072 beside the
    plain loop, a one-thread chain probe, the bytes bound and a
    launch-per-sample estimate (printed, not part of the `kernels` line:
    it is computed from one measured launch).  Returns K4's entry of the
    `kernels` line (the follower body's numbers; every body's under
    `bodies`)."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build, scan_group as SG
    from zorak_tpu_torch.lowering.scan_codegen import TRANSCENDENTAL
    from zorak_tpu_torch.lowering.specialize import _SC_BINARY, _SC_UNARY
    from zorak_tpu_torch.runtime.engine import PluginInstance

    programs = {}
    for name, (src, _nch) in K4_BODIES.items():
        inst = PluginInstance(compile_plugin_source(src), srate=SR)
        check(inst.engine == "torch-vector" and inst.spec_error is None,
              f"{name}: engine {inst.engine} ({inst.spec_error})")
        levels = inst.kernel.scan_level_programs()
        check(len(levels) == 1, f"{name}: {len(levels)} scan levels")
        programs[name] = levels[min(levels)][2]
    # the render's source holds the scan kernel alone; the chain probe is
    # the same steps in a source of its own
    probes = {name: SG.ScanGroupProgram(p.steps, p.outs, p.n_ext, probe=True)
              for name, p in programs.items()}
    # every operation of csrc/scan_ops.cuh as a carry of its own: binary
    # ops on (x0, x1), unary ops on x0, a select
    op_names = ([f"bin {op}" for op in sorted(_SC_BINARY)]
                + [f"call {op}" for op in sorted(_SC_UNARY)] + ["select"])
    op_steps = ([("bin", op, {}, [("x", 0), ("x", 1)])
                 for op in sorted(_SC_BINARY)]
                + [("call", op, {}, [("x", 0)]) for op in sorted(_SC_UNARY)]
                + [("select", None, {}, [("x", 0), ("x", 1), ("c", -3.25)])])
    ops_program = SG.ScanGroupProgram(
        op_steps, [("s", i) for i in range(len(op_steps))], 2)
    # one nvcc a generated source, all started together
    t0 = time.perf_counter()
    logs = _build.build_generated(
        [p.source for p in programs.values()]
        + [p.source for p in probes.values()] + [ops_program.source])
    print(f"[build] {len(logs)} generated scan-group kernels in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, program in programs.items():
        for line in logs[program.source].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] scan_group {name}: {line.strip()}")

    # what one eager launch costs the host: a launch-per-sample loop in
    # plain PyTorch would pay it for every operation of every sample
    acc = torch.zeros((), dtype=torch.float64, device=cuda)
    for _ in range(200):
        acc.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        acc.add_(1.0)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / 2000 * 1e6

    def inputs(program, n, specials):
        xs = rng.randn(n, program.n_ext) * 0.5
        if specials:
            xs[n // 3, 0] = -0.0
            xs[2, 0] = 0.0
            xs[3 * n // 4, -1] = np.nan    # reaches the carry and stays
        c0 = rng.uniform(0.1, 0.9, program.n_carry)     # non-zero start
        return (torch.from_numpy(xs).to(cuda), torch.from_numpy(c0).to(cuda))

    def program_like(xs):
        """Noise with a silent lead-in, a silent gap and a fade-out."""
        xs = xs.clone()
        n = xs.shape[0]
        xs[:2000] = 0.0
        xs[n // 4:n // 4 + 10_000] = 0.0
        xs[-20_000:] *= torch.linspace(1.0, 0.0, 20_000, dtype=xs.dtype,
                                       device=xs.device)[:, None]
        return xs

    def held(program, what, got, ref):
        if program.transcendental:
            fin = torch.isfinite(ref)
            check(torch.equal(torch.isnan(got), torch.isnan(ref)),
                  f"{what}: NaNs elsewhere than the plain loop's")
            err = float((got[fin] - ref[fin]).abs().max()) \
                if fin.any() else 0.0
            check(err <= K4_LIBM_TOL, f"{what}: differs from the "
                  f"plain loop by {err:.3e} (limit {K4_LIBM_TOL})")
        else:
            check(same_values(got, ref), f"{what} differs from its plain loop")
            fin = torch.isfinite(ref)
            err = float((got[fin] - ref[fin]).abs().max()) \
                if fin.any() else 0.0
        return err

    def reruns_of(fn):
        for v in SG.RERUN_STEPS.values():
            v.zero_()
        out = fn()
        torch.cuda.synchronize()
        return out, sum(int(v.item()) for v in SG.RERUN_STEPS.values())

    def merge_step(program, xs, c0):
        """Samples after which a walk started from c0 at a quarter, a
        half and three quarters of xs has the true walk's carries in
        every bit, and keeps them (the most of the three); None if one
        never does within xs."""
        n = xs.shape[0]
        one = {"chunk": n}
        true = SG.scan_group(program, xs, c0, **one).view(torch.int64)
        worst = 0
        for t_s in (n // 4, n // 2, 3 * n // 4):
            guess = SG.scan_group(program, xs[t_s:].contiguous(), c0, **one)
            differs = (guess.view(torch.int64) != true[t_s:]).any(dim=1)
            last = torch.nonzero(differs)
            if len(last) and int(last[-1]) == n - t_s - 1:
                return None
            worst = max(worst, int(last[-1]) + 1 if len(last) else 0)
        return worst

    small = {"chunk": 64, "warmup": 256}   # many chunks, many re-runs
    bodies = {}
    for name, program in programs.items():
        worst = 0.0
        plain_ms = None
        for n in (1, 7, 4096, SEG_L):
            for specials in (False, True):
                if specials and (n < 7 or not program.n_ext):
                    continue
                xs, c0 = inputs(program, n, specials)
                got = SG.scan_group(program, xs, c0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
                if n == SEG_L and not specials:
                    plain_ms = (time.perf_counter() - t0) * 1e3
                what = f"scan_group {name} L={n} specials={specials}"
                worst = max(worst, held(program, what, got, ref))
                # a small chunk and warm-up: many chunks re-run; twice, so
                # that a launch after a fallback to the walk in series is
                # held too
                for _ in range(2):
                    held(program, f"{what} {small}",
                         SG.scan_group(program, xs, c0, **small), ref)
        # time at the main path's segment length beside the walk in series
        # (one chunk: the earlier design's walk) and the chain probe: the
        # same steps with the externals cycling through registers, checked
        # against the plain loop on the same repeated rows first
        xs, c0 = inputs(program, SEG_L, False)
        run = lambda: SG.scan_group(program, xs, c0)
        _, reruns = reruns_of(run)
        ms = cuda_ms(run, reps=20)
        walk_ms = cuda_ms(lambda: SG.scan_group(program, xs, c0, chunk=SEG_L),
                          reps=10)
        xp = program_like(xs)
        _, prog_reruns = reruns_of(lambda: SG.scan_group(program, xp, c0))
        prog_ms = cuda_ms(lambda: SG.scan_group(program, xp, c0), reps=20)
        merge = (merge_step(program, xs, c0), merge_step(program, xp, c0))
        probe = probes[name]
        rows = probe.block_rows
        xc = xs[:rows].contiguous()
        n_check = 64 * rows
        ref_end = SG.scan_group_plain(program.steps, program.outs,
                                      xc.repeat(64, 1), c0)[-1]
        got_end = SG.scan_group_chain_probe(probe, xc, c0, n_check)
        if program.transcendental:
            check(float((got_end - ref_end).abs().max()) <= K4_LIBM_TOL,
                  f"scan_group {name}: chain probe differs from the plain loop")
        else:
            check(same_values(got_end, ref_end),
                  f"scan_group {name}: chain probe differs from the plain loop")
        chain_ms = cuda_ms(
            lambda: SG.scan_group_chain_probe(probe, xc, c0, SEG_L), reps=5)
        chain_ns = chain_ms * 1e6 / SEG_L
        chunk, warm, n_chunks = SG.chunk_plan(SEG_L, SG.CHUNK, SG.WARMUP)
        chunk_chain_ms = (warm + chunk) * chain_ns * 1e-6
        ms_2 = cuda_ms(run, reps=20)
        n_ops = len(program.steps)
        # each external read once, each carry stream written once; the
        # operations bound counts every step of the body as one operation
        b_ms, b_by = bound_ms((program.n_ext + program.n_carry) * SEG_L * 8
                              + program.n_carry * 8, n_ops * SEG_L)
        per_sample_ms = n_ops * SEG_L * launch_us * 1e-3
        how = (f"within {K4_LIBM_TOL} (device libm)" if program.transcendental
               else "bit-identical")
        print(f"[kernels] scan_group {name}: {program.n_carry} carries in "
              f"{len(program.components)} component(s), {program.n_ext} "
              f"externals, {n_ops} steps; L in (1, 7, 4096, {SEG_L}), with "
              f"and without NaN and -0.0, chunk {chunk} warm-up {warm} and "
              f"{small}: {how}, max_abs_err={worst:.3e}; L={SEG_L}: "
              f"ms={ms:.4f} (again {ms_2:.4f}) rerun_steps={reruns} "
              f"walk_in_series_ms={walk_ms:.4f} plain_ms={plain_ms:.1f} "
              f"chain_ms={chain_ms:.4f} ({chain_ns:.3f} ns a step), the "
              f"kernel {ms / chain_ms:.3f}x it; chunked chain bound ({warm} + "
              f"{chunk} steps) {chunk_chain_ms:.4f} ms, the kernel "
              f"{ms / chunk_chain_ms:.3f}x it; program-like material: "
              f"ms={prog_ms:.4f} rerun_steps={prog_reruns}; merge step on "
              f"noise {merge[0]}, on program-like material {merge[1]} "
              f"(None: not within the segment); bound_ms={b_ms:.5f} "
              f"({b_by}); a launch a step and sample at {launch_us:.2f} us "
              f"would take {per_sample_ms:.0f} ms")
        bodies[name] = {
            "ms": ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
            "chunk_chain_ms": chunk_chain_ms, "earlier_ms": walk_ms,
            "rerun_steps": reruns, "program_ms": prog_ms,
            "program_rerun_steps": prog_reruns, "merge_step": merge[0],
            "program_merge_step": merge[1],
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": worst,
            "steps": n_ops,
            "carries": program.n_carry, "externals": program.n_ext,
            "components": len(program.components)}

    # the follower after a burst into exact silence: two walks from other
    # carries keep a fixed ratio and never meet, so every launch that
    # speculates re-walks most of the segment and the next walks in series
    fol = programs["follower"]
    xs, c0 = inputs(fol, SEG_L, False)
    xs[SEG_L // 64:] = 0.0
    ref = SG.scan_group_plain(fol.steps, fol.outs, xs, c0)
    silence_reruns = []
    for _ in range(4):
        got, r = reruns_of(lambda: SG.scan_group(fol, xs, c0))
        held(fol, "scan_group follower, burst into silence", got, ref)
        silence_reruns.append(r)
    check(sorted(r == 0 for r in silence_reruns) == [False, False, True, True],
          f"follower in silence: re-run steps {silence_reruns}, expected "
          "a launch that re-walks and one in series, in turns")
    silence_ms = cuda_ms(lambda: SG.scan_group(fol, xs, c0), reps=22)
    silence_walk_ms = cuda_ms(
        lambda: SG.scan_group(fol, xs, c0, chunk=SEG_L), reps=22)
    print(f"[kernels] scan_group follower, burst into exact silence, "
          f"L={SEG_L}: bit-identical; re-run steps of four launches in a "
          f"row {silence_reruns}; ms={silence_ms:.4f} (mean of 22, half of "
          f"them in series) walk_in_series_ms={silence_walk_ms:.4f}, "
          f"{silence_ms / silence_walk_ms:.3f}x it")

    # the operations one by one, every pair of K4_EDGE_VALUES: what the
    # scalar semantics give (the plain loop), bit for bit; the device's
    # libm calls within K4_LIBM_ULPS of glibc's, same NaNs and infinities
    xs = torch.tensor([(a, b) for a in K4_EDGE_VALUES for b in K4_EDGE_VALUES],
                      dtype=torch.float64, device=cuda)
    c0 = torch.zeros(ops_program.n_carry, dtype=torch.float64, device=cuda)
    got = SG.scan_group(ops_program, xs, c0)
    ref = SG.scan_group_plain(ops_program.steps, ops_program.outs, xs, c0)
    worst_ulps = 0.0
    for i, name in enumerate(op_names):
        g, r = got[:, i], ref[:, i]
        if name.split()[-1] in TRANSCENDENTAL:
            fin = torch.isfinite(r)
            check(torch.equal(torch.isnan(g), torch.isnan(r))
                  and torch.equal(g[torch.isinf(r)], r[torch.isinf(r)]),
                  f"scan_group op {name}: NaNs or infinities elsewhere than "
                  "the plain loop's")
            ulp = (torch.nextafter(r[fin].abs(), torch.full_like(r[fin], np.inf))
                   - r[fin].abs())
            ulps = float(((g[fin] - r[fin]).abs() / ulp).max()) \
                if fin.any() else 0.0
            check(ulps <= K4_LIBM_ULPS, f"scan_group op {name}: {ulps:.1f} "
                  f"ulp from the plain loop (limit {K4_LIBM_ULPS})")
            worst_ulps = max(worst_ulps, ulps)
        else:
            bad = [tuple(xs[j].tolist()) + (float(g[j]), float(r[j]))
                   for j in range(xs.shape[0])
                   if not same_values(g[j:j + 1], r[j:j + 1])][:3]
            check(not bad, f"scan_group op {name} differs from the scalar "
                  f"semantics at (a, b, kernel, plain) {bad}")
    print(f"[kernels] scan_group operations: {len(op_names)} ops on "
          f"{xs.shape[0]} pairs of edge values (zeros, subnormals, +-2^31, "
          f"+-2^62, +-2^63, +-inf, NaN): bit-identical to the scalar "
          f"semantics; the {sum(n.split()[-1] in TRANSCENDENTAL for n in op_names)}"
          f" libm ops within {worst_ulps:.2f} ulp (limit {K4_LIBM_ULPS})")

    fol = bodies["follower"]
    return {
        "name": "scan_group", "route": "cuda",
        "source": "zorak_tpu_torch/lowering/scan_codegen.py",
        "replaces": "zorak_tpu/lowering/specialize.py:4482",
        "launches": 0, "max_abs_err": fol["max_abs_err"], "ms": fol["ms"],
        "plain_ms": fol["plain_ms"], "bound_ms": fol["bound_ms"],
        "bound_by": fol["bound_by"], "library_ms": None,
        "chain_ms": fol["chain_ms"], "chunk_chain_ms": fol["chunk_chain_ms"],
        "earlier_ms": fol["earlier_ms"], "rerun_steps": fol["rerun_steps"],
        "chunk": SG.CHUNK, "warmup": SG.WARMUP,
        "silence_ms": silence_ms, "silence_walk_ms": silence_walk_ms,
        "silence_rerun_steps": silence_reruns, "eager_launch_us": launch_us,
        "worst_abs_err": max(b["max_abs_err"] for b in bodies.values()),
        "shape": [SEG_L, fol["externals"], fol["carries"]], "bodies": bodies,
    }


def scan_group_sweep(torch, cuda, rng, rounds=5, reps=10):
    """K4 across register block sizes: for each of K4_SWEEP_UNROLLS the
    bodies of K4_SWEEP_BODIES generated with that many samples held at
    once, held to the default size's output bit for bit at L = 131,072,
    then timed in a rotating order (mean, min, max of `rounds` samples of
    `reps` launches) beside the body's chain probe."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import _build, scan_group as SG
    from zorak_tpu_torch.lowering import scan_codegen as CG
    from zorak_tpu_torch.runtime.engine import PluginInstance

    bases, programs = {}, {}
    for name in K4_SWEEP_BODIES:
        inst = PluginInstance(compile_plugin_source(K4_BODIES[name][0]),
                              srate=SR)
        ((_keys, _ext, base, _idx),) = inst.kernel.scan_level_programs().values()
        bases[name] = SG.ScanGroupProgram(base.steps, base.outs, base.n_ext,
                                          probe=True)
        for u in K4_SWEEP_UNROLLS:
            programs[name, u] = SG.ScanGroupProgram(
                base.steps, base.outs, base.n_ext, unroll=u)
        # the speculate kernel's other way to load the externals
        programs[name, "other"] = SG.ScanGroupProgram(
            base.steps, base.outs, base.n_ext,
            staged=base.n_ext > CG.STAGE_MAX_EXT)
    _build.build_generated([p.source for p in (*bases.values(),
                                               *programs.values())])
    for name, base in bases.items():
        xs = torch.from_numpy(rng.randn(SEG_L, base.n_ext) * 0.5).to(cuda)
        c0 = torch.from_numpy(rng.uniform(0.1, 0.9, base.n_carry)).to(cuda)
        runs = {u: (lambda p=programs[name, u]: SG.scan_group(p, xs, c0))
                for u in K4_SWEEP_UNROLLS}
        ref = SG.scan_group(base, xs, c0)
        for u, run in runs.items():
            check(same_values(run(), ref),
                  f"scan_group {name} with {u} samples held differs from "
                  "the default")
        xc = xs[:base.block_rows].contiguous()
        chain_ms = cuda_ms(
            lambda: SG.scan_group_chain_probe(base, xc, c0, SEG_L), reps=5)
        samples = {u: [] for u in K4_SWEEP_UNROLLS}
        for r in range(rounds):
            k = r % len(K4_SWEEP_UNROLLS)
            for u in K4_SWEEP_UNROLLS[k:] + K4_SWEEP_UNROLLS[:k]:
                samples[u].append(cuda_ms(runs[u], reps))
        cells = "  ".join(
            f"U={programs[name, u].block_rows}: {np.mean(v):.4f} "
            f"({min(v):.4f}-{max(v):.4f})" for u, v in samples.items())
        print(f"[sweep] scan_group {name} L={SEG_L} n_ext={base.n_ext} "
              f"chain_ms={chain_ms:.4f}; ms mean (min-max): {cells}")
        # the chunk and the warm-up of the default block size, the walk
        # in series last; each held to the default's output first
        plans = {f"C={c} W={w}": (base, {"chunk": c, "warmup": w})
                 for c, w in K4_SWEEP_PLANS}
        plans["one chunk"] = (base, {"chunk": SEG_L})
        other = "register blocks" if base.n_ext <= CG.STAGE_MAX_EXT \
            else "staged"
        plans[other] = (programs[name, "other"], {})
        for prog, kw in plans.values():
            check(same_values(SG.scan_group(prog, xs, c0, **kw), ref),
                  f"scan_group {name} {kw} differs from the default")
        times = {k: [] for k in plans}
        for r in range(rounds):
            for k, (prog, kw) in plans.items():
                times[k].append(cuda_ms(
                    lambda prog=prog, kw=kw: SG.scan_group(prog, xs, c0, **kw),
                    reps))
        print(f"[sweep] scan_group {name} L={SEG_L}, ms mean (min-max) by "
              "chunk C and warm-up W, and with the externals loaded the "
              "other way: "
              + "  ".join(
                  f"{k}: {np.mean(v):.4f} ({min(v):.4f}-{max(v):.4f})"
                  for k, v in times.items()))


def jsfx_phase(torch, cuda, rng, card):
    """The JSFX main path: the in-repo delay network, its 192-tap
    widening, a cross-fed network and two scan-group plugins through
    PluginInstance.render on
    60 s of stereo; returns the K2, K3 and K4 launch counts of each timed
    render, and K4's re-run steps in it."""
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.runtime.engine import DEFAULT_SEGMENT_LEN, PluginInstance
    from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio, null_test_plugin
    # carried state against the CPU render's: the golden's scalar contract
    from zorak_tpu_torch.verify.nulltest import SCALAR_EPS as CARRY_EPS

    check(DEFAULT_SEGMENT_LEN == SEG_L, "the default segment length moved")
    sec = MAIN_T / SR
    n1, n_gold = int(SR), 4800
    launches, reruns = {}, {}
    segments = -(-MAIN_T // SEG_L)
    # label, source, held to the golden, launches of (K2, K3, K4) a
    # segment: one K3 launch folds both channels' chains; the cross-fed
    # network's right ring is written from the left sum, so two
    for label, src, hold_golden, per_segment in (
            ("fallback", BP.FALLBACK_SRC, False, (1, 1, 0)),
            ("wide", BP.wide_delay_network(192), True, (1, 1, 0)),
            ("cross_fed", BP.cross_fed_delay_network(16), True, (1, 2, 0)),
            ("follower", SCAN_GROUP_SRC, True, (0, 0, 1)),
            ("stereo_followers", STEREO_FOLLOWERS_SRC, True, (0, 0, 1))):
        t_phase = time.perf_counter()
        prog = compile_plugin_source(src)
        inst = PluginInstance(prog, srate=SR)          # device None: the card
        check(inst.engine == "torch-vector" and inst.spec_error is None,
              f"{label}: engine {inst.engine} ({inst.spec_error})")
        levels = len(inst.kernel.scan_level_programs())
        check(levels == per_segment[2], f"{label}: {levels} scan levels")
        x = (rng.randn(2, MAIN_T) * 0.25).astype(np.float32)
        t0 = time.perf_counter()
        inst.render(x)                                 # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        LS.LAUNCHES = RT.LAUNCHES = SG.LAUNCHES = 0
        for v in SG.RERUN_STEPS.values():
            v.zero_()
        out = []
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: out.append(inst.render(x)))
        wall = time.perf_counter() - t0
        launches[label] = {"linrec_scan": LS.LAUNCHES,
                           "ring_tap_sum": RT.LAUNCHES,
                           "scan_group": SG.LAUNCHES}
        reruns[label] = sum(int(v.item()) for v in SG.RERUN_STEPS.values())
        res = out[0]
        # the render's host side (copies, the wake scan) shares its CPU
        # with other tenants: four more renders show the spread
        more_ms = sorted(cuda_ms(lambda: inst.render(x)) for _ in range(4))
        check(res.engine == "torch-vector", f"{label}: rendered by {res.engine}")
        check(tuple(launches[label].values())
              == tuple(n * segments for n in per_segment),
              f"{label}: launches {launches[label]}, expected "
              f"{per_segment} a segment x {segments} segments")
        y = res.audio
        check(y.shape == (2, MAIN_T) and y.dtype == np.float32,
              f"{label}: output {y.shape} {y.dtype}")
        check(bool(np.isfinite(y).all()), f"{label}: output not finite")
        print(f"[main] JSFX {label} 60 s stereo: engine={res.engine} "
              f"device_ms={ms:.2f} wall_s={wall:.4f} "
              f"audio_s_per_s={sec / (ms / 1e3):.1f} "
              f"launches={launches[label]} segments={segments} "
              f"scan_group_rerun_steps={reruns[label]} "
              f"warm-up render (kernel builds included) {warm_s:.2f} s; "
              f"four more renders "
              f"{' '.join(f'{m:.2f}' for m in more_ms)} ms card='{card}'")
        kern = inst.kernel
        x_dev = torch.from_numpy(x).to(cuda)
        kern.render_device(x_dev)
        dev_ms = cuda_ms(lambda: kern.render_device(x_dev), reps=3)
        print(f"[main] JSFX {label}: the kernel alone, audio already on the "
              f"card and left there, mean of 3: device_ms={dev_ms:.2f} "
              f"audio_s_per_s={sec / (dev_ms / 1e3):.1f}")
        events, by_name = profile_render(lambda: kern.render_device(x_dev),
                                         f"JSFX {label}", segments)
        traced_k3 = sum(n for name, (n, _us) in by_name.items()
                        if "ring_tap_sum" in name)
        print(f"[main] JSFX {label}: device events a segment {events}, K3 "
              f"launches a segment {per_segment[1]} (in the trace "
              f"{traced_k3} of {per_segment[1] * segments}) card='{card}'")

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
        # the carries after 10 s (four segments, the speculated ones
        # included), scalars and rings, against the CPU render's
        n10 = 10 * int(SR)
        _y, (sv, rings) = kern.render_device(x_dev[:, :n10])
        _y, (sv_c, rings_c) = PluginInstance(
            prog, srate=SR, device="cpu").kernel.render(x[:, :n10])
        carry_err = 0.0
        for what, got, want in [("scalars", sv, sv_c)] + [
                (f"ring {r}", rings[r], a) for r, a in rings_c.items()]:
            got = got.cpu()
            check(torch.equal(torch.isnan(got), torch.isnan(want)),
                  f"{label}: carried {what} NaN elsewhere than the CPU's")
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
            carry_err = max(carry_err, err)
        check(carry_err <= CARRY_EPS, f"{label}: carries after 10 s differ "
              f"from the CPU render's by {carry_err:.3e}")
        print(f"[main] JSFX {label}: carries after 10 s (scalars and "
              f"{len(rings_c)} rings) against the CPU render's: max "
              f"|delta| {carry_err:.3e} (limit {CARRY_EPS})")
        # the whole 60 s render against the native C golden: audio, and
        # vars and heap at the end (null_test_plugin renders both)
        t_g = time.perf_counter()
        rep = null_test_plugin(prog, x, srate=SR, golden="native",
                               segment_len=SEG_L, device=cuda,
                               compare_mem=True)
        print(f"[main] JSFX {label} whole 60 s, CUDA vs the native golden: "
              f"{rep.summary()} ({time.perf_counter() - t_g:.1f} s)")
        if hold_golden:
            check(rep.passed, f"{label}: the 60 s render disagrees with the "
                  "native golden")
        else:
            print(f"[main] JSFX {label}: not held to the golden (its tap "
                  "tables alias the ring; ROADMAP queue 3)")
        print(f"[done] JSFX {label} in {time.perf_counter() - t_phase:.1f} s")

    return launches, reruns


def verify_cli_phase(card):
    """The CLI's `verify` on the card (device None), native golden and an
    export bundle, on a one-entry catalog made in a temporary directory
    (the 192-tap widening, 2 s of stereo noise)."""
    import tempfile

    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.cli.main import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        leaf = Path(tmp) / "catalog" / "plugins" / "Delay" / "Wide"
        (leaf / "src").mkdir(parents=True)
        (leaf / "plugin.json").write_text(json.dumps({
            "name": "Wide delay network", "slug": "Wide",
            "pluginCode": "Zwid", "pluginType": "jsfx"}))
        (leaf / "src" / "Wide.jsfx").write_text(BP.wide_delay_network(192))
        bundle = Path(tmp) / "bundle"
        t0 = time.perf_counter()
        rc = cli_main(["verify", "--catalog", str(Path(tmp) / "catalog"),
                       "--seconds", "2", "--golden", "native",
                       "--export-dir", str(bundle)])
        names = sorted(p.name for p in bundle.iterdir())
        report = json.loads((bundle / "Wide_report.json").read_text())
    check(rc == 0 and report["passed"], f"CLI verify: rc {rc}, {report}")
    check(names == ["Wide_compiled.wav", "Wide_delta.wav", "Wide_report.json",
                    "Wide_shadow.wav"], f"CLI verify bundle: {names}")
    print(f"[verify] CLI verify --golden native --export-dir on the card: rc "
          f"{rc}, bundle {names}, max |delta| {report['max_abs_delta']:.3e} "
          f"({time.perf_counter() - t0:.1f} s) card='{card}'")


def batch_kernels_phase(torch, cuda, rng):
    """K3 and K4 with a files axis against their plain versions on the
    same CUDA inputs, and each file against the kernel's single-file
    launch, bit for bit (every NaN one value): 1, 3 and 8 files, other
    data and cursors a file, NaN in one file; for K4 the last file's
    burst into silence makes its fix-up walk again, which must mark that
    file's flag alone, as its single-file launch marks its own."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import ring_taps as RT, scan_group as SG
    from zorak_tpu_torch.runtime.engine import PluginInstance

    def T(v):
        return torch.from_numpy(np.asarray(v, dtype=np.float64)).to(cuda)

    cases = 0
    for nf in (1, 3, 8):
        for n in (1, 777, SEG_L):
            parts = [tap_case(rng, 192, 16384, n), tap_case(rng, 16, 4096, n),
                     tap_case(rng, 5, max(4096, 2 * n), n, long_only=True)]
            rings = [rng.randn(nf, len(r)) for r, *_ in parts]
            rings[0][nf - 1, ::97] = np.nan       # NaN in the last file
            # a stream a file, one stream for all files, history alone;
            # inits a value a file, a stream a file, one float
            streams = [T(rng.randn(nf, n)), T(parts[1][1]), None]
            inits = [T(rng.randn(nf, 1)), T(rng.randn(nf, n)), 0.25]
            cursors = [16383, 1000, 2048]
            for tile in (None, RT.TILES[0], RT.TILES[-1]):
                tables = RT.TapTables([(st, g) for _r, _s, st, g in parts],
                                      cuda, tile, n, files=nf)
                args = (tables, [T(r) for r in rings], cursors, streams,
                        inits, n)
                got = RT.ring_tap_sum(*args)
                ref = RT.ring_tap_sum_reference(*args)
                what = f"ring_tap_sum files={nf} L={n} tile={tables.tile}"
                check(got.shape == (3, nf, n), f"{what}: {tuple(got.shape)}")
                check(same_values(got, ref), f"{what} differs from its plain "
                      "fold")
                for f in range(nf):
                    one = RT.ring_tap_sum(
                        tables, [r[f] for r in args[1]], cursors,
                        [s if s is None or s.dim() == 1 else s[f]
                         for s in streams],
                        [i[f] if isinstance(i, torch.Tensor) else i
                         for i in inits], n)
                    check(same_values(got[:, f], one),
                          f"{what}: file {f} differs from its own launch")
                cases += 1
    torch.cuda.synchronize()
    print(f"[batch] ring_tap_sum with files 1, 3, 8 x L 1, 777, {SEG_L} x "
          f"three tiles: {cases} cases bit-identical to the plain fold and "
          "to each file's own launch (NaN in one file)")

    small = {"chunk": 64, "warmup": 256}   # many chunks, many re-runs
    key = str(torch.zeros(0, device=cuda).device)     # the flags' key
    for name in ("follower", "stereo_followers",
                 "group_feeding_from_vectorized_delay"):
        src, _nch = K4_BODIES[name]
        levels = PluginInstance(compile_plugin_source(src),
                                srate=SR).kernel.scan_level_programs()
        base = levels[min(levels)][2]

        def fresh():
            # flags of its own; the library is the same text's, built once
            return SG.ScanGroupProgram(base.steps, base.outs, base.n_ext)

        def reruns_of(fn):
            for v in SG.RERUN_STEPS.values():
                v.zero_()
            out = fn()
            torch.cuda.synchronize()
            return out, sum(int(v.item()) for v in SG.RERUN_STEPS.values())

        for nf in (1, 3, 8):
            for n in (4096, SEG_L):
                xs = rng.randn(nf, n, base.n_ext) * 0.5
                if nf > 1 and base.n_ext:
                    xs[1, n // 3, 0] = -0.0
                    xs[1, 3 * n // 4, -1] = np.nan
                xs[nf - 1, n // 10:] = 0.0           # a burst into silence
                xs = T(xs)
                c0 = T(rng.uniform(0.1, 0.9, (nf, base.n_carry)))
                ref = (SG.scan_group_plain(base.steps, base.outs, xs, c0)
                       if n <= 4096 else None)
                for kw in ({}, small):
                    program = fresh()
                    launches = SG.LAUNCHES
                    got, reruns = reruns_of(
                        lambda: SG.scan_group(program, xs, c0, **kw))
                    check(SG.LAUNCHES == launches + 1,
                          f"scan_group {name}: {SG.LAUNCHES - launches} "
                          "launches for one batch")
                    marks = [int(v) for v in program._flags[(key, nf)][0]]
                    what = f"scan_group {name} files={nf} L={n} {kw or ''}"
                    if ref is not None:
                        check(same_values(got, ref),
                              f"{what} differs from its plain loop")
                    solo_reruns, solo_marks = 0, []
                    for f in range(nf):
                        alone = fresh()
                        one, r = reruns_of(lambda: SG.scan_group(
                            alone, xs[f], c0[f], **kw))
                        check(same_values(got[f], one),
                              f"{what}: file {f} differs from its own launch")
                        solo_reruns += r
                        solo_marks += [int(v) for v in
                                       alone._flags[(key, 1)][0]]
                    check(reruns == solo_reruns and marks == solo_marks,
                          f"{what}: re-runs {reruns} flags {marks}, each file "
                          f"alone {solo_reruns} {solo_marks}")
                    if name == "group_feeding_from_vectorized_delay" and kw:
                        check(marks == [-1] * (nf - 1) + [1],
                              f"{what}: flags {marks}, the silent file's alone "
                              "expected")
                    print(f"[batch] {what}: bit-identical to "
                          f"{'the plain loop and ' if ref is not None else ''}"
                          f"each file's own launch, re-run steps {reruns} "
                          f"(each file alone: {solo_reruns}), flags {marks}")


def kernel_bounds(kern, label, nf, seg, per_segment, segments):
    """(kernel, trace name tag, launches a render, (bound ms, by)) of K2,
    K3 and K4 in a render of nf files at segment length seg: each input
    read and each output written once at the HBM rate, or K3's two f64
    instructions a tap and sample."""
    out = []
    if per_segment[0]:
        # the one-pole wave: nf x 2 rows, a scalar a; b read, z written
        rows = nf * 2
        out.append(("linrec_scan", "linrec_", per_segment[0] * segments,
                    bound_ms(16 * rows * seg, 0.0)))
    if per_segment[1]:
        launches = kern.tap_launches(seg, nf)
        taps = sum(sum(g.tables.counts) for g in launches)
        nbytes = 12 * taps
        for g in launches:
            for st, m in zip(g.tables.starts, g.members):
                mod = m.region[1]
                end = min(max(st) + seg, mod + (seg if m.needs_src else 0))
                nbytes += 8 * nf * (end - min(st) + seg)
        # a DMUL and a DADD a tap and sample, at the f64 instruction rate
        ops_ms = 2 * taps * seg * nf / F64_INSTR_PER_S * 1e3 / len(launches)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3 / len(launches)
        out.append(("ring_tap_sum", "ring_tap_sum",
                    per_segment[1] * segments,
                    (max(ops_ms, bytes_ms),
                     "operations" if ops_ms > bytes_ms else "bytes")))
    if per_segment[2]:
        ((_k, ext, program, _i),) = kern.scan_level_programs().values()
        out.append(("scan_group", "zs_", per_segment[2] * segments,
                    bound_ms(8 * nf * seg * (len(ext) + program.n_carry),
                             0.0)))
    return out


def held_at_the_batch_shapes(torch, label, src, seg, x, y, per_segment,
                             segment):
    """K2, K3 and K4 at the shapes a batch render gives them: a fresh
    BatchRenderer renders x with the wrappers' calls of one segment
    recorded (the inputs copied before the launch, the kernel's output
    kept), and each recorded launch is held bit for bit (every NaN one
    value) to its plain version on those same CUDA inputs: K2 to
    `linrec_chunked`, the NumPy mirror of its order, K3 to
    `ring_tap_sum_reference`, K4 to `scan_group_plain` (within
    K4_LIBM_TOL where its body calls the device's libm).  The render must
    equal y."""
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.parallel import BatchRenderer

    def copied(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, (list, tuple)):
            return type(v)(copied(u) for u in v)
        return v

    wrappers = [(LS, "linrec_scan", per_segment[0]),
                (RT, "ring_tap_sum", per_segment[1]),
                (SG, "scan_group", per_segment[2])]
    calls = {name: [] for _m, name, _n in wrappers}
    seen = dict.fromkeys(calls, 0)

    def spy(mod, name, fn, per):
        def run(*args):
            i = seen[name]
            seen[name] += 1
            if per * segment <= i < per * (segment + 1):
                kept = copied(args)
                out = fn(*args)
                calls[name].append((kept, out))
                return out
            return fn(*args)
        setattr(mod, name, run)

    kept_fns = [(mod, name, getattr(mod, name)) for mod, name, _n in wrappers]
    try:
        for (mod, name, per), (_m, _n, fn) in zip(wrappers, kept_fns):
            spy(mod, name, fn, per)
        # a fresh renderer: its segment program binds the recording wrappers
        br = BatchRenderer(compile_plugin_source(src), SR, segment_len=seg)
        again = br.render_files(x)
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in kept_fns:
            setattr(mod, name, fn)
    check(torch.equal(again, y), f"batch {label}: the recorded render differs")
    shapes = []
    for name, rec in calls.items():
        per = dict((n, p) for _m, n, p in wrappers)[name]
        check(len(rec) == per, f"batch {label}: {len(rec)} {name} calls "
              f"recorded in segment {segment}, {per} expected")
        for args, got in rec:
            what = f"batch {label} {name} segment {segment}"
            if name == "linrec_scan":
                a, b, z0 = (v.cpu().numpy() for v in args)
                ref = torch.from_numpy(LS.linrec_chunked(a, b, z0))
                check(same_values(got.cpu(), ref),
                      f"{what} differs from linrec_chunked")
                shapes.append(f"K2 rows {tuple(b.shape)}")
            elif name == "ring_tap_sum":
                ref = RT.ring_tap_sum_reference(*args)
                check(same_values(got, ref), f"{what} differs from its plain "
                      "fold")
                shapes.append(f"K3 {tuple(got.shape)} "
                              f"taps {list(args[0].counts)}")
            else:
                program, xs, c0 = args
                ref = SG.scan_group_plain(program.steps, program.outs, xs, c0)
                if program.transcendental:
                    check(bool((torch.isnan(got) == torch.isnan(ref)).all())
                          and float((got - ref).nan_to_num().abs().max())
                          <= K4_LIBM_TOL, f"{what} differs from its plain "
                          f"loop by more than {K4_LIBM_TOL}")
                else:
                    check(same_values(got, ref),
                          f"{what} differs from its plain loop")
                shapes.append(f"K4 xs {tuple(xs.shape)}")
    return shapes


def batch_phase(torch, cuda, rng, card):
    """The JSFX batch path: BatchRenderer on 8 files x 60 s of stereo at
    the bench's segment through the 192-tap widening, the cross-fed
    network and the two scan-group plugins (each file equal to its solo
    render on the card, K2, K3 and K4 launched as often as for one file,
    times, a profiler pass); the catalog functions on a temporary catalog,
    CUDA against CPU; then the config-1 figures of
    zorak_tpu_torch/bench.py.  Returns the batched launches of the
    widening (K2, K3) and of the follower (K4)."""
    import tempfile

    from zorak_tpu_torch import bench
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import linrec_scan as LS, ring_taps as RT
    from zorak_tpu_torch.kernels import scan_group as SG
    from zorak_tpu_torch.kernels import switching_scan as SS
    from zorak_tpu_torch.parallel import (
        BatchRenderer, build_catalog_renderers, catalog_batch_render,
        catalog_stacked_render)
    from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio

    def counts():
        return {"linrec_scan": LS.LAUNCHES, "ring_tap_sum": RT.LAUNCHES,
                "scan_group": SG.LAUNCHES, "switching_scan": SS.LAUNCHES}

    def zero():
        LS.LAUNCHES = RT.LAUNCHES = SG.LAUNCHES = SS.LAUNCHES = 0

    nf, n, seg = bench.DDT_FILES, bench.DDT_SAMPLES, bench.DDT_SEG
    segments = -(-n // seg)
    sec = n / SR
    gen = torch.Generator(device=cuda)
    launches = {}
    for label, src, per_segment in (
            ("wide", BP.wide_delay_network(192), (1, 1, 0)),
            ("cross_fed", BP.cross_fed_delay_network(16), (1, 2, 0)),
            ("follower", SCAN_GROUP_SRC, (0, 0, 1)),
            ("stereo_followers", STEREO_FOLLOWERS_SRC, (0, 0, 1))):
        t_phase = time.perf_counter()
        br = BatchRenderer(compile_plugin_source(src), SR, segment_len=seg)
        kern = br.kernel
        check(kern.device.type == "cuda", f"batch {label}: on {kern.device}")
        gen.manual_seed(int(rng.randint(1 << 30)))
        x = torch.randn((nf, 2, n), generator=gen, device=cuda) * 0.25
        br.render_files(x)                               # warm-up
        kern.render_device(x[0])
        zero()
        y = br.render_files(x)
        torch.cuda.synchronize()
        batched = counts()
        zero()
        kern.render_device(x[0])
        torch.cuda.synchronize()
        solo = counts()
        want = {"linrec_scan": per_segment[0] * segments,
                "ring_tap_sum": per_segment[1] * segments,
                "scan_group": per_segment[2] * segments, "switching_scan": 0}
        check(batched == solo == want, f"batch {label}: launches {batched} "
              f"for {nf} files, {solo} for one, {want} expected")
        launches[label] = batched
        check(y.shape == (nf, 2, n) and y.dtype == torch.float32,
              f"batch {label}: output {tuple(y.shape)} {y.dtype}")
        check(bool(torch.isfinite(y).all()), f"batch {label}: not finite")
        for f in range(nf):
            one, _carry = kern.render_device(x[f])
            check(torch.equal(y[f], one),
                  f"batch {label}: file {f} differs from its solo render")
        t0 = time.perf_counter()
        shapes = held_at_the_batch_shapes(torch, label, src, seg, x, y,
                                          per_segment, segments // 2)
        print(f"[batch] {label}: segment {segments // 2}'s launches at the "
              f"batch's shapes ({'; '.join(shapes)}) bit-identical to their "
              f"plain versions on the same inputs "
              f"({time.perf_counter() - t0:.1f} s)")
        # in turns: one file, the batch, the batch, one file, twice
        batch_ms, one_ms = [], []
        for _ in range(2):
            one_ms.append(cuda_ms(lambda: kern.render_device(x[0])))
            batch_ms += [cuda_ms(lambda: br.render_files(x)) for _ in range(2)]
            one_ms.append(cuda_ms(lambda: kern.render_device(x[0])))
        ms, solo_ms = min(batch_ms), min(one_ms)
        print(f"[batch] JSFX {label} {nf} files x 60 s stereo, segment {seg} "
              f"({segments} segments): device_ms={ms:.2f} (best of "
              f"{' '.join(f'{m:.2f}' for m in batch_ms)}) audio_s_per_s="
              f"{nf * sec / (ms / 1e3):.1f} per_file_rtx="
              f"{sec / (ms / 1e3):.1f}; one file alone {solo_ms:.2f} ms "
              f"(best of {' '.join(f'{m:.2f}' for m in one_ms)}; x{nf} = "
              f"{nf * solo_ms:.2f}), the batch {ms / solo_ms:.2f}x one "
              f"file's; launches {batched} for {nf} files = one file's; "
              f"every file torch.equal to its solo render card='{card}'")
        _events, by_name = profile_render(lambda: br.render_files(x),
                                          f"batch {label} {nf} files",
                                          segments)
        _events, by_name_one = profile_render(
            lambda: kern.render_device(x[0]), f"batch {label} one file",
            segments, traces=1)
        # each kernel's device time a launch at the batch's shapes, from
        # the traces, beside one file's and the bytes or operations bound
        for kname, tag, n_launch, bound in kernel_bounds(
                kern, label, nf, seg, per_segment, segments):
            def per_launch(names):
                us = sum(t for name, (_n, t) in names.items() if tag in name)
                return us / 1e3 / n_launch
            print(f"[batch] {kname} in the {label} render, {nf} files: "
                  f"{per_launch(by_name):.4f} ms a launch (one file "
                  f"{per_launch(by_name_one):.4f}), bound {bound[0]:.5f} ms "
                  f"({bound[1]}) card='{card}'")
        print(f"[done] batch {label} in {time.perf_counter() - t_phase:.1f} s")

    # the catalog functions on the card against the CPU: two Faust
    # modules (VAR runs K1), and three JSFX plugins (K2, K3, K4)
    leaves = {("Restoration", "VAR"): ("faust", "process = _, _;\n"),
              ("Dynamics", "GTS"): ("faust", "process = _, _;\n"),
              ("Delay", "Wide"): ("jsfx", BP.wide_delay_network(192)),
              ("Delay", "Cross"): ("jsfx", BP.cross_fed_delay_network(16)),
              ("Dynamics", "Follow"): ("jsfx", SCAN_GROUP_SRC)}
    x = (rng.randn(2, int(SR)) * 0.25).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "catalog"
        for (category, slug), (ptype, text) in leaves.items():
            leaf = root / "plugins" / category / slug
            (leaf / "src").mkdir(parents=True)
            (leaf / "plugin.json").write_text(json.dumps({
                "name": slug, "slug": slug, "pluginCode": "Z" + slug[:3],
                "pluginType": ptype}))
            ext = ".dsp" if ptype == "faust" else ".jsfx"
            (leaf / "src" / f"{slug}{ext}").write_text(text)
        renderers, skipped = build_catalog_renderers(str(root),
                                                     segment_len=SEG_L)
        zero()
        outs, _ = catalog_batch_render(str(root), x, renderers=renderers)
        torch.cuda.synchronize()
        got = counts()
        check(not skipped and sorted(outs) == sorted(s for _c, s in leaves),
              f"catalog: {sorted(outs)}, skipped {skipped}")
        check(all(v > 0 for v in got.values()),
              f"catalog_batch_render skipped a kernel: {got}")
        outs_cpu, _ = catalog_batch_render(str(root), x, segment_len=SEG_L,
                                           device="cpu")
        stacked, n_groups = catalog_stacked_render(renderers, x)
    worst = 0.0
    for slug, y in outs.items():
        check(y.device.type == "cuda", f"catalog {slug} on {y.device}")
        rep = compare_audio(outs_cpu[slug][0].numpy(), y[0].cpu().numpy())
        check(rep.audio_passed, f"catalog {slug}: CUDA vs CPU {rep.summary()}")
        check(torch.equal(stacked[slug], y[0]),
              f"catalog {slug}: the stacked render differs from the batch")
        worst = max(worst, rep.max_abs_delta)
    print(f"[batch] catalog_batch_render on the card, {len(outs)} entries: "
          f"launches {got}; each within {AUDIO_EPS} of its CPU render (max "
          f"|delta| {worst:.3e}); catalog_stacked_render in {n_groups} "
          f"group(s), equal to it card='{card}'")

    t0 = time.perf_counter()
    figures = {**bench.section_ddt(cuda), **bench.section_ddt_batched(cuda)}
    print(f"[batch] bench config 1 (zorak_tpu_torch/bench.py, the 192-tap "
          f"widening, 60 s stereo): {json.dumps(figures)} "
          f"({time.perf_counter() - t0:.1f} s) card='{card}'")
    return {"linrec_scan": launches["wide"]["linrec_scan"],
            "ring_tap_sum": launches["wide"]["ring_tap_sum"],
            "scan_group": launches["follower"]["scan_group"]}


def smi_under_load(torch, fn, reps: int) -> str:
    """nvidia-smi's SM clock, power draw and power limit, read while the
    card works through `reps` queued calls of fn."""
    for _ in range(reps):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return smi


def k8_at_the_bench(torch, CV, xb, ir_np, n, held, timed, entry):
    """K8 on the bench's input spectra and IR partitions: held to its
    plain version (every tile, scale 1 and irfft's 1/N) and the earlier
    design to it; the partitioned convolution's new form (1/N folded into
    K8) against its old form bit for bit; the tiles swept; this design
    and the earlier one timed in turns (earlier, this, this, earlier)
    beside nvidia-smi's SM clock under load; the library call (a grouped
    complex conv1d, a group a bin, TF32 off) timed and compared.  Fills
    K8's entry."""
    F = torch.nn.functional
    h = CV.ir_spectra(torch.from_numpy(ir_np).to(xb.device), PART)
    X = CV.input_spectra(xb, PART).contiguous()
    parts, bins = h.shape
    Y = CV.partition_mac(X, h)
    ref = CV.partition_mac_reference(X, h)
    held("K8 at the bench shape", Y, ref)
    scale = 1.0 / (2 * PART)
    held("K8 with irfft's 1/N at the bench shape",
         CV.partition_mac(X, h, scale),
         torch.view_as_complex(torch.view_as_real(ref) * scale))
    for tile in CV.TILES[1:]:
        held(f"K8 tile {tile} at the bench shape",
             CV.partition_mac(X, h, tile=tile), ref)
    del ref

    lib = CV._library()
    lib.zorak_partition_mac_earlier.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.zorak_partition_mac_earlier.restype = ctypes.c_int
    y_old = torch.empty_like(X)
    stream = torch.cuda.current_stream().cuda_stream

    def earlier():
        err = lib.zorak_partition_mac_earlier(
            X.data_ptr(), h.data_ptr(), y_old.data_ptr(), *X.shape, parts,
            stream)
        check(err == 0, f"K8's earlier design: launch failed, cudaError {err}")

    earlier()
    held("K8's earlier design at the bench shape", y_old, Y)

    # the convolution: 1/N in K8's store against irfft's own, bit for bit
    new = CV.partitioned_convolve(xb, torch.from_numpy(ir_np).to(xb.device),
                                  PART)
    old = CV.overlap_save_crop(torch.fft.irfft(Y, 2 * PART, dim=-1), n)
    check(same_bits(new, old), "partitioned_convolve: 1/N folded into K8 "
          "differs from irfft's own 1/N")
    print("[spectral] partitioned_convolve at the bench shape: 1/N folded "
          "into K8 bit-identical to irfft's own 1/N")
    y_max = float(Y.abs().max())
    del new, old, Y

    macs = X.numel() * parts
    ops_ms = MAC_INSTR * macs / F32_INSTR_PER_S * 1e3
    sweep = {}
    for tile in CV.TILES:
        sweep[str(tile)] = timed(lambda: CV.partition_mac(X, h, tile=tile))
        print(f"[spectral] K8 tile (R, W, PG) = {tile}: "
              f"{sweep[str(tile)]:.4f} ms, {ops_ms / sweep[str(tile)]:.1%} "
              f"of the operations bound")
    turns = [timed(earlier), timed(lambda: CV.partition_mac(X, h)),
             timed(lambda: CV.partition_mac(X, h)), timed(earlier)]
    smi = smi_under_load(torch, lambda: CV.partition_mac(X, h), 1500)
    ms, earlier_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    print(f"[spectral] K8 in turns (earlier, this, this, earlier): "
          f"{', '.join(f'{t:.4f}' for t in turns)} ms; this design "
          f"{ms:.4f} ms against {earlier_ms:.4f} ms, {ops_ms / ms:.1%} of "
          f"the operations bound; under load clocks.sm, power.draw, "
          f"power.limit = {smi}")
    del y_old

    # the library yardstick: one grouped complex conv1d, input laid out
    # beforehand, TF32 off (cuDNN's default for f32 convolutions is on)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xin = F.pad(X.permute(0, 2, 1), (parts - 1, 0)).contiguous()
        wt = h.T.flip(-1).unsqueeze(1).contiguous()
        y_lib = F.conv1d(xin, wt, groups=bins).permute(0, 2, 1)
        lib_err = float((y_lib - CV.partition_mac(X, h)).abs().max())
        del y_lib
        library_ms = timed(lambda: F.conv1d(xin, wt, groups=bins), 3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del xin
    print(f"[spectral] K8's library call, grouped complex conv1d (cudnn "
          f"allow_tf32 {tf32} by default, False for the call): "
          f"{library_ms:.4f} ms, max |delta| from the kernel {lib_err:.3e} "
          f"(max |Y| {y_max:.1f}: another summing order)"
          f"{'; it beats the kernel' if library_ms < ms else ''}")
    entry("partition_mac", "zorak_tpu/kernels/convolution.py:73-80", "K8",
          ms, timed(lambda: CV.partition_mac_reference(X, h), 3),
          8.0 * (2 * X.numel() + h.numel()), MAC_INSTR * macs, library_ms,
          X.shape + (parts,), complex_macs=macs, earlier_ms=earlier_ms,
          turns_ms=turns, tile_sweep_ms=sweep, default_tile=list(CV.TILES[0]),
          smi_under_load=smi, library_max_abs_delta=lib_err)


def spectral_phase(torch, cuda, rng, card):
    """The spectral and convolution slice (BASELINE configs 2-4): K7a,
    K7b, K7c and K8 against their plain versions bit for bit, at odd
    shapes and at the bench's; their times beside bounds, plain versions
    and library calls; the three bench sections through
    zorak_tpu_torch.bench (launch counts a section call, the _rtx
    figures); the pipelines against the port's CPU render, and the
    convolution against scipy in f64.  Returns the four `kernels`
    entries."""
    import importlib

    import scipy.signal

    from zorak_tpu_torch import bench as BN
    from zorak_tpu_torch.kernels import convolution as CV
    from zorak_tpu_torch.verify import AUDIO_EPS

    ST = importlib.import_module("zorak_tpu_torch.kernels.stft")
    F = torch.nn.functional

    def bits_equal(a, b):
        """Kernel vs plain: every bit, every NaN one value (complex as
        real and imaginary parts)."""
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        return same_values(a.contiguous(), b.contiguous())

    def held(what, got, want):
        check(bits_equal(got, want), f"{what}: kernel differs from its "
              "plain version")

    def timed(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        return cuda_ms(fn, reps=reps)

    def wsum_of(t, size, hop):
        w = np.hanning(size).astype(np.float32)
        n_frames = ST._n_frames(t, size, hop)
        return ST._ola_window_norm(w, n_frames, size, hop)[:t].astype(
            np.float64)

    def audio_held(what, got, want, size, hop):
        """CUDA against the CPU render: the OLA sum (y x wsum) within
        AUDIO_EPS everywhere, y within it where wsum >= WSUM_MIN."""
        wsum = wsum_of(got.shape[-1], size, hop)
        d = np.abs(got.astype(np.float64) - want.astype(np.float64))
        err_sum = float((d * wsum).max())
        err = float(d[..., wsum >= WSUM_MIN].max())
        print(f"[spectral] {what}: CUDA vs CPU render max |delta| {err:.3e} "
              f"where wsum >= {WSUM_MIN}, of the OLA sum {err_sum:.3e} "
              f"(limit {AUDIO_EPS})")
        check(err <= AUDIO_EPS and err_sum <= AUDIO_EPS,
              f"{what}: CUDA render disagrees with the CPU render")
        return err

    # -- odd shapes, bit for bit ----------------------------------------------
    for lanes, t, size, hop in K7_ODD:
        x = torch.from_numpy((rng.randn(lanes, t) * 0.25).astype(np.float32))
        x[0, :3] = torch.tensor([float("nan"), -0.0, float("inf")])
        w = torch.from_numpy(np.hanning(size).astype(np.float32))
        xc, wc = x.to(cuda), w.to(cuda)
        frames = ST.frame_window(xc, wc, size, hop)
        held(f"K7a {lanes}x{t} size {size} hop {hop}", frames,
             ST.frame_window_reference(xc, wc, size, hop))
        check(torch.equal(torch.isnan(frames.cpu()), torch.isnan(
            ST.frame_window(x, w, size, hop))), "K7a: NaN elsewhere than "
              "on the CPU")
        n_frames = frames.shape[1]
        fr = torch.randn(lanes, n_frames, size, device=cuda) * 100
        fr[0, 0, 1] = -0.0
        inv = torch.from_numpy(ST._inv_wsum(w.numpy().tobytes(), n_frames,
                                            size, hop)).to(cuda)
        for t_out in {t, (n_frames - 1) * hop + size}:
            held(f"K7b {lanes}x{n_frames}x{size} hop {hop} to {t_out}",
                 ST.overlap_add_norm(fr, wc, inv, hop, t_out),
                 ST.overlap_add_norm_reference(fr, wc, inv, hop, t_out))
        bins = size // 2 + 1
        spec = torch.complex(torch.randn(lanes, n_frames, bins, device=cuda),
                             torch.randn(lanes, n_frames, bins, device=cuda))
        spec[0, 0, 0] = complex(float("nan"), 1.0)
        thr = torch.rand(lanes, device=cuda) * 2
        thr[-1] = 0.0
        for floor_db in (-24.0, -60.0):
            held(f"K7c {lanes}x{n_frames}x{bins} floor {floor_db}",
                 ST.gate_gain(spec, thr, floor_db),
                 ST.gate_gain_reference(spec, thr, floor_db))
    nan_thr = torch.tensor([float("nan"), 0.5], device=cuda)
    spec2 = torch.randn(2, 3, 17, dtype=torch.complex64, device=cuda)
    held("K7c NaN threshold", ST.gate_gain(spec2, nan_thr, -24.0),
         ST.gate_gain_reference(spec2, nan_thr, -24.0))
    for lanes, n_frames, bins, parts in K8_ODD:
        x = torch.randn(lanes, n_frames, bins, dtype=torch.complex64,
                        device=cuda)
        x[-1, 0, 0] = complex(float("nan"), -0.0)
        h = torch.randn(parts, bins, dtype=torch.complex64, device=cuda) * 30
        h[0, 1] = complex(float("inf"), 0.0)   # the zero rows meet it
        for scale in (1.0, 2.0 ** -12):
            want = CV.partition_mac_reference(x, h, scale)
            for tile in CV.TILES:
                held(f"K8 {lanes}x{n_frames}x{bins} {parts} parts scale "
                     f"{scale} tile {tile}",
                     CV.partition_mac(x, h, scale, tile), want)
    print(f"[spectral] K7a, K7b, K7c and K8 bit-identical to their plain "
          f"versions at {len(K7_ODD)} + {len(K8_ODD)} odd shapes (K8: "
          f"every tile of {CV.TILES}, scale 1 and 2^-12)")

    # the pipelines at odd shapes against the port's CPU render
    for lanes, t, size, hop in K7_ODD:
        x = (rng.randn(lanes, t) * 0.25).astype(np.float32)
        x1 = x[0] if lanes == 1 else x               # [T] and [lanes, T]
        cpu = ST.stft_process(torch.from_numpy(x1), lambda s: s * 0.5, size,
                              hop).numpy()
        got = ST.stft_process(torch.from_numpy(x1).to(cuda),
                              lambda s: s * 0.5, size, hop).cpu().numpy()
        audio_held(f"stft_process {x1.shape} size {size} hop {hop}", got,
                   cpu, size, hop)
        xq = x1 * np.float32(0.1)
        cpu = ST.spectral_gate(torch.from_numpy(xq), size=size,
                               hop=hop).numpy()
        got = ST.spectral_gate(torch.from_numpy(xq).to(cuda), size=size,
                               hop=hop).cpu().numpy()
        audio_held(f"spectral_gate {x1.shape} size {size} hop {hop}", got,
                   cpu, size, hop)
    for lanes, t, k, b in CONV_ODD:
        x = (rng.randn(*((t,) if lanes is None else (lanes, t)))
             ).astype(np.float32)
        ir = (rng.randn(k) * np.exp(-np.arange(k) / (k / 4))).astype(
            np.float32)
        cpu = CV.partitioned_convolve(torch.from_numpy(x), ir, b).numpy()
        got = CV.partitioned_convolve(torch.from_numpy(x).to(cuda), ir,
                                      b).cpu().numpy()
        scale = max(1.0, float(np.abs(cpu).max()))
        err = float(np.abs(got - cpu).max())
        ref = np.stack([scipy.signal.fftconvolve(
            r.astype(np.float64), ir.astype(np.float64))[:t]
            for r in x.reshape(-1, t)]).reshape(x.shape)
        err_ref = float(np.abs(got - ref).max())
        check(err <= AUDIO_EPS * scale and err_ref <= 2e-5 * max(
            1.0, float(np.abs(ref).max())),
            f"partitioned_convolve {x.shape} k {k} B {b}: {err:.3e} from "
            f"the CPU render, {err_ref:.3e} from scipy")
    print(f"[spectral] stft_process, spectral_gate ({len(K7_ODD)} shapes) "
          f"and partitioned_convolve ({len(CONV_ODD)}) on the card held to "
          "the CPU render; the convolution also to scipy in f64")

    # -- the bench's shapes: held, timed, bounded ------------------------------
    n = int(BN.KERNEL_SECONDS * BN.SRATE)
    lanes = BN.LANES
    src = np.random.RandomState(11)
    xb = torch.from_numpy((src.randn(lanes, n) * 0.25).astype(np.float32)).to(
        cuda)
    ir_np = BN.section_ir(src)      # drawn after the input, as bench.py does
    w_np = np.hanning(SPEC_SIZE).astype(np.float32)
    w = torch.from_numpy(w_np).to(cuda)
    entries = {}

    def entry(name, replaces, what, ms, plain_ms, nbytes, ops, library_ms,
              shape, **extra):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_INSTR_PER_S * 1e3
        b_ms, b_by = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                      else (ops_ms, "operations"))
        lib = ("none (no one PyTorch call computes it)" if library_ms is None
               else f"{library_ms:.4f}")
        print(f"[spectral] {name} ({what}) {shape}: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={b_ms:.4f} "
              f"({b_by}; bytes {bytes_ms:.4f}, operations {ops_ms:.4f}) "
              f"card='{card}'")
        entries[name] = {
            "name": name, "route": "cuda", "source": f"zorak_tpu_torch/csrc/"
            f"{'partition_mac' if name == 'partition_mac' else 'stft_ola'}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "shape": list(shape),
            **extra}

    # K7a
    n_frames = ST._n_frames(n, SPEC_SIZE, SPEC_HOP)
    frames = ST.frame_window(xb, w, SPEC_SIZE, SPEC_HOP)
    held("K7a at the bench shape", frames,
         ST.frame_window_reference(xb, w, SPEC_SIZE, SPEC_HOP))
    pad = (n_frames - 1) * SPEC_HOP + SPEC_SIZE - n

    def unfold_window():
        return F.pad(xb, (0, pad)).unfold(-1, SPEC_SIZE, SPEC_HOP) * w

    entry("frame_window", "zorak_tpu/kernels/stft.py:35", "K7a",
          timed(lambda: ST.frame_window(xb, w, SPEC_SIZE, SPEC_HOP)),
          timed(lambda: ST.frame_window_reference(xb, w, SPEC_SIZE,
                                                  SPEC_HOP), 3),
          4.0 * (xb.numel() + SPEC_SIZE + frames.numel()), frames.numel(),
          timed(unfold_window, 3), frames.shape)
    # K7b on the irFFT of the bench's spectra
    spec = torch.fft.rfft(frames, dim=-1)
    del frames
    fr = torch.fft.irfft(spec, SPEC_SIZE, dim=-1).contiguous()
    del spec
    total = (n_frames - 1) * SPEC_HOP + SPEC_SIZE
    inv = torch.from_numpy(ST._inv_wsum(w_np.tobytes(), n_frames, SPEC_SIZE,
                                        SPEC_HOP)).to(cuda)
    y = ST.overlap_add_norm(fr, w, inv, SPEC_HOP, n)
    held("K7b at the bench shape", y,
         ST.overlap_add_norm_reference(fr, w, inv, SPEC_HOP, n))

    def fold_norm():
        ola = F.fold((fr * w).transpose(1, 2), (1, total), (1, SPEC_SIZE),
                     stride=(1, SPEC_HOP))
        return (ola.reshape(lanes, total) * inv)[:, :n]

    fold_err = float((fold_norm() - y).abs().max())
    entry("overlap_add_norm", "zorak_tpu/kernels/stft.py:61", "K7b",
          timed(lambda: ST.overlap_add_norm(fr, w, inv, SPEC_HOP, n)),
          timed(lambda: ST.overlap_add_norm_reference(fr, w, inv, SPEC_HOP,
                                                      n), 3),
          4.0 * (fr.numel() + SPEC_SIZE + total + y.numel()),
          2.0 * fr.numel() + y.numel(), timed(fold_norm, 3), fr.shape,
          library_max_abs_delta=fold_err)
    print(f"[spectral] K7b: F.fold x 1/wsum differs from the kernel by "
          f"{fold_err:.3e} (another summing order)")
    del fr, y
    # K7c on the denoiser's spectra and thresholds
    xq = torch.from_numpy((np.random.RandomState(11).randn(lanes, n) * 0.02
                           ).astype(np.float32)).to(cuda)
    spec = torch.fft.rfft(ST.frame_window(xq, w, SPEC_SIZE, SPEC_SIZE // 2),
                          dim=-1)
    quiet = ST.percentile(ST.magnitude(spec), 10.0, dim=-2)
    thr = torch.clamp_min(ST.median(quiet), float(
        np.float32(10.0 ** (-50.0 / 20.0)))) * 4.0
    del quiet
    held("K7c at the bench shape", ST.gate_gain(spec, thr, -24.0),
         ST.gate_gain_reference(spec, thr, -24.0))
    entry("gate_gain", "zorak_tpu/kernels/stft.py:126", "K7c",
          timed(lambda: ST.gate_gain(spec, thr, -24.0)),
          timed(lambda: ST.gate_gain_reference(spec, thr, -24.0), 3),
          16.0 * spec.numel() + 4.0 * lanes, 16.0 * spec.numel(), None,
          spec.shape)
    del spec, xq
    # K8 on the bench's input spectra and IR partitions
    k8_at_the_bench(torch, CV, xb, ir_np, n, held, timed, entry)
    torch.cuda.empty_cache()

    # -- the main path: the three bench sections --------------------------------
    for k in ST.LAUNCHES:
        ST.LAUNCHES[k] = 0
    CV.LAUNCHES = 0
    calls = 4                       # _timed: a warm-up, then the best of 3
    rtx, per_call = {}, {}
    for section, kernels_run in (("stft", ("frame_window", "overlap_add_norm")),
                                 ("denoiser", ("frame_window",
                                               "overlap_add_norm",
                                               "gate_gain")),
                                 ("convolution", ("partition_mac",))):
        before = dict(ST.LAUNCHES, partition_mac=CV.LAUNCHES)
        t0 = time.perf_counter()
        rtx.update(BN.SECTIONS[section](cuda))
        torch.cuda.empty_cache()
        after = dict(ST.LAUNCHES, partition_mac=CV.LAUNCHES)
        ran = {k: after[k] - before[k] for k in after}
        per_call[section] = {k: v / calls for k, v in ran.items() if v}
        check(all(ran[k] == calls for k in kernels_run) and
              sum(ran.values()) == calls * len(kernels_run),
              f"bench section {section}: launches {ran}, expected one of "
              f"each of {kernels_run} a call x {calls} calls")
        print(f"[spectral] bench section {section}: launches a call "
              f"{per_call[section]} ({time.perf_counter() - t0:.1f} s)")
    launches = dict(ST.LAUNCHES, partition_mac=CV.LAUNCHES)
    for name, e in entries.items():
        e["launches"] = launches[name]
        e["launches_per_section_call"] = {
            s: c[name] for s, c in per_call.items() if name in c}
    print(f"[spectral] {json.dumps(rtx)} card='{card}'")

    def tilt(spec):
        return spec * torch.linspace(0.5, 1.5, spec.shape[-1],
                                     device=spec.device)

    # -- where a section's time goes: one call of each pipeline, traced -------
    xq = torch.from_numpy((np.random.RandomState(11).randn(lanes, n) * 0.02
                           ).astype(np.float32))
    xq_dev, ir_dev = xq.to(cuda), torch.from_numpy(ir_np).to(cuda)
    for section, call in (
            ("stft", lambda: ST.stft_process(xb, tilt, SPEC_SIZE, SPEC_HOP)),
            ("denoiser", lambda: ST.spectral_gate(xq_dev, size=SPEC_SIZE)),
            ("convolution", lambda: CV.partitioned_convolve(xb, ir_dev,
                                                            PART))):
        call()
        names = profile_render(call, f"bench section {section}")[1]
    # irfft runs unscaled: its 1/N is K8's (no multiply pass left)
    check(any("partition_mac_kernel" in k for k in names) and not any(
        "MulFunctor" in k for k in names), f"the convolution's trace: "
          f"K8 missing or a multiply pass left: {sorted(names)}")
    print("[spectral] the convolution's trace holds K8 and no multiply "
          "pass (irfft's 1/N is K8's)")
    del xq_dev
    torch.cuda.empty_cache()

    # -- the bench's pipelines against the port's CPU render (lanes 0, 31) ----
    keep = [0, lanes - 1]
    x_cpu = xb[keep].cpu()

    got = ST.stft_process(xb, tilt, SPEC_SIZE, SPEC_HOP)[keep].cpu().numpy()
    audio_held("stft_process at the bench shape", got,
               ST.stft_process(x_cpu, tilt, SPEC_SIZE, SPEC_HOP).numpy(),
               SPEC_SIZE, SPEC_HOP)
    got = ST.spectral_gate(xq.to(cuda), size=SPEC_SIZE)[keep].cpu().numpy()
    audio_held("spectral_gate at the bench shape", got,
               ST.spectral_gate(xq[keep], size=SPEC_SIZE).numpy(),
               SPEC_SIZE, SPEC_SIZE // 2)
    got = CV.partitioned_convolve(xb, ir_np, PART)[keep].cpu().numpy()
    cpu = CV.partitioned_convolve(x_cpu, ir_np, PART).numpy()
    err = float(np.abs(got - cpu).max())
    ref = np.stack([scipy.signal.fftconvolve(
        r.astype(np.float64), ir_np.astype(np.float64))[:n]
        for r in x_cpu.numpy()])
    err_ref = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    print(f"[spectral] partitioned_convolve at the bench shape: CUDA vs CPU "
          f"render {err:.3e}, vs scipy.signal.fftconvolve in f64 "
          f"{err_ref:.3e} (max |y| {scale:.1f}; limits "
          f"{AUDIO_EPS} x max(1, max|y|), 2e-5 x max(1, max|y|))")
    check(err <= AUDIO_EPS * max(1.0, float(np.abs(cpu).max())) and
          err_ref <= 2e-5 * max(1.0, scale),
          "partitioned_convolve disagrees with the CPU render or scipy")
    entries["partition_mac"]["conv_vs_scipy_f64"] = err_ref
    del xb
    torch.cuda.empty_cache()
    return [entries[k] for k in ("frame_window", "overlap_add_norm",
                                 "gate_gain", "partition_mac")]


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
    def scan_inputs(n_t, lanes, dtype, up=None, dn=None, x=None, rng=rng):
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

    # VAR's follower, one lane, at VAR's poles, at the main path's shape:
    # K1 at its defaults and as one chunk (a thread per lane) against the
    # plain loop in f64, bit for bit.  The plain Python loop takes 70 to
    # 110 us a step, minutes at this length, so the second dtype runs
    # K1_PLAIN_T steps of it, and at the main length K1 in f32 at its
    # defaults is held to K1 as one chunk.
    one = {"chunk": MAIN_T}         # one chunk: a thread per lane
    # a stream of its own: the draws below stay what they were before the
    # f32 plain loop was cut
    rng_plain = np.random.RandomState(SEED + 7)
    args = scan_inputs(K1_PLAIN_T, 1, torch.float32, *VAR_POLES, rng=rng_plain)
    t0 = time.perf_counter()
    ref, _ = held(f"float32 T={K1_PLAIN_T} lanes=1", args)
    held(f"float32 T={K1_PLAIN_T} lanes=1", args, ref, **one)
    print(f"[kernels] switching_scan plain loop float32 T={K1_PLAIN_T}: "
          f"{time.perf_counter() - t0:.1f} s")
    witnessed("main shape", scan_inputs(MAIN_T, 1, torch.float32, *VAR_POLES))
    args = scan_inputs(MAIN_T, 1, torch.float64, *VAR_POLES)
    ref_holder = []
    t0 = time.perf_counter()
    plain_ms = cuda_ms(lambda: ref_holder.append(
        SS.switching_scan_reference(*args)))
    ref = ref_holder[0]
    print(f"[kernels] switching_scan plain loop float64 T={MAIN_T}: "
          f"{time.perf_counter() - t0:.1f} s")
    _, main_reruns = held(f"float64 T={MAIN_T} lanes=1", args, ref)
    held(f"float64 T={MAIN_T} lanes=1", args, ref, **one)
    scan_err = (SS.switching_scan(*args) - ref).abs().max().item()
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
    ap.add_argument("--phases", default="jsfx,batch,spectral,faust",
                    help="comma-separated: jsfx, batch, spectral, faust "
                         "(default all four); k4sweep times K4 across "
                         "register block sizes")
    phases = set(ap.parse_args(argv).phases.split(","))
    if not phases or phases - {"jsfx", "batch", "spectral", "faust",
                               "k4sweep"}:
        ap.error("--phases takes jsfx, batch, spectral, faust or k4sweep")
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

    # the native golden's libraries go beside the kernels', in the checkout
    os.environ.setdefault("ZORAK_TPU_CACHE", str(_build.BUILD_DIR))
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
            # K8 has a build a tile: name each kernel its lines belong to
            if "registers" in line or "spill" in line or (
                    name == "partition_mac" and "Function properties" in line):
                print(f"[build] {name}: {line.strip()}")

    kernels = []
    if "jsfx" in phases:
        # 3. K2 and K3 against their plain versions; 4. the JSFX main path
        # a seeded stream of their own: the Faust phases draw the same
        # inputs whether or not these ran before them
        rng_jsfx = np.random.RandomState(SEED + 5)
        t0 = time.perf_counter()
        k2 = linrec_phase(torch, cuda, rng_jsfx)
        k3 = ring_taps_phase(torch, cuda, rng_jsfx)
        print(f"[done] K2 and K3 kernel phases in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        # a stream of its own again: K4's draws do not move the others'
        k4 = scan_group_phase(torch, cuda, np.random.RandomState(SEED + 6))
        print(f"[done] K4 kernel phase in {time.perf_counter() - t0:.1f} s")
        launches, reruns = jsfx_phase(torch, cuda, rng_jsfx, card)
        for entry in (k2, k3):
            entry["launches"] = launches["fallback"][entry["name"]]
            entry["launches_wide"] = launches["wide"][entry["name"]]
            entry["launches_cross_fed"] = launches["cross_fed"][entry["name"]]
        k4["launches"] = launches["follower"]["scan_group"]
        k4["launches_stereo"] = launches["stereo_followers"]["scan_group"]
        k4["render_rerun_steps"] = reruns["follower"]
        k4["render_rerun_steps_stereo"] = reruns["stereo_followers"]
        kernels += [k2, k3, k4]
        verify_cli_phase(card)
        print(f"[done] jsfx phases at {time.perf_counter() - t_start:.1f} s")
    if "batch" in phases:
        t0 = time.perf_counter()
        batch_kernels_phase(torch, cuda, np.random.RandomState(SEED + 8))
        print(f"[done] batch kernel phase in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        batched = batch_phase(torch, cuda, np.random.RandomState(SEED + 9),
                              card)
        for entry in kernels:
            if entry["name"] in batched:
                entry["launches_batched"] = batched[entry["name"]]
        print(f"[done] batch phase in {time.perf_counter() - t0:.1f} s; "
              f"launches of 8 files: {batched}")
    if "spectral" in phases:
        t0 = time.perf_counter()
        kernels += spectral_phase(torch, cuda, np.random.RandomState(SEED + 7),
                                  card)
        print(f"[done] spectral phase in {time.perf_counter() - t0:.1f} s")
    if "k4sweep" in phases:
        scan_group_sweep(torch, cuda, np.random.RandomState(SEED))
    if "faust" in phases:
        t0 = time.perf_counter()
        kernels.insert(0, faust_phases(torch, cuda, rng, card))
        print(f"[done] faust phases in {time.perf_counter() - t0:.1f} s")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
