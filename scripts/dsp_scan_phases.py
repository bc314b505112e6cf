#!/usr/bin/env python3
"""Times the three phases of K9's scans (csrc/dsp_scan.cu) on one card.

    PYTHONPATH=. python3 scripts/dsp_scan_phases.py [--reps 10]

At the VAR render's shape (T = 2,880,000, one row) and the Faust batch's
(T = 480,000, 8 rows), f64, seeded noise (|noise| for the max-plus
scan): `onepole` with a pole of the call and with one a sample,
`max_follower` and VAR's high-pass `biquad_tf2`.  For each, the device
time of a call (a CUDA graph of 20 calls) and of each phase by
torch.profiler over `--reps` calls: the chunk walk that composes the
maps (`compose`), the carry block (`carry`) and the walk that writes y
(`apply`), beside the bytes bound (x read and y written once).  Each
call's output is first held to its plain ladder within TOL_REL x
max|y|.  PYTHONPATH names the checkout whose kernels it builds.  Needs a
CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np

SR = 48000.0
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12      # one H100 SXM at 700 W (NVIDIA data sheet)
SHAPES = ((1, 2_880_000), (8, 480_000))


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call, `reps` calls in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / reps


def applies(key: str) -> bool:
    """Whether a walk_kernel<Op, kApply, kVecA> is the apply walk, from its
    demangled or its mangled name."""
    if "walk_kernel<" in key:
        targs = key.split("walk_kernel<", 1)[1].split(">(", 1)[0]
        return targs.split(",")[-2].strip() == "true"
    return key.split("walk_kernel", 1)[1].split("Lb", 1)[1].startswith("1")


def phase_ms(torch, fn, reps: int) -> dict:
    """Each phase's mean device ms a call, from the profiler's kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"compose": 0.0, "carry": 0.0, "apply": 0.0}
    for e in prof.key_averages():
        if "carry_kernel" in e.key:
            name = "carry"
        elif "walk_kernel" in e.key:
            name = "apply" if applies(e.key) else "compose"
        else:
            continue
        out[name] += e.device_time_total / 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dsp_scan_phases: no CUDA device", file=sys.stderr)
        return 1
    from zorak_tpu_torch.kernels import dsp_scan as DS
    from zorak_tpu_torch.models import dspkit as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"{card}; kernels from {DS.__file__}")
    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    bq = K.rbj_coeffs("hp", 11500.0, 0.707, SR)
    for rows, n_t in SHAPES:
        x = torch.from_numpy(rng.randn(rows, n_t)).to(cuda)
        xa = x.abs()
        pole = torch.from_numpy(0.9 + 0.09 * np.abs(np.sin(
            np.arange(n_t) / 50.0))).to(cuda)
        cases = {
            "onepole": (lambda: DS.affine_scan(x, 0.99, onepole=True),
                        lambda: DS.affine_scan_plain(x, 0.99, onepole=True)),
            "onepole per-sample pole": (
                lambda: DS.affine_scan(x, pole, onepole=True),
                lambda: DS.affine_scan_plain(x, pole, onepole=True)),
            "max_follower": (lambda: DS.maxplus_scan(xa, 0.97),
                             lambda: DS.maxplus_scan_plain(xa, 0.97)),
            "biquad_tf2": (lambda: DS.biquad_scan(x, *bq),
                           lambda: DS.biquad_scan_plain(x, *bq)),
        }
        bound = 2 * rows * n_t * 8 / HBM_BYTES_PER_S * 1e3
        for name, (fn, plain) in cases.items():
            got, want = fn(), plain()
            err = (got - want).abs().max().item()
            if not err <= DS.TOL_REL * want.abs().max().item():
                print(f"dsp_scan_phases: {name} rows={rows} T={n_t} differs "
                      f"from its ladder by {err:.3e}", file=sys.stderr)
                return 1
            ms = graph_ms(torch, fn)
            phases = phase_ms(torch, fn, args.reps)
            print(f"[phases] {name} rows={rows} T={n_t}: ms={ms:.5f} "
                  + " ".join(f"{k}_ms={v:.5f}" for k, v in phases.items())
                  + f" bound_ms={bound:.5f} card='{card}'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
