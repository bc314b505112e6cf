#!/usr/bin/env python3
"""Times the CUDA switching scan (K1) across chunk lengths, on one card.

    PYTHONPATH=. python3 scripts/switching_scan_sweep.py [--rounds 5] [--reps 3]

At the main path's shape (T = 2,880,000, one lane) and the batch path's
(T = 480,000, 8 lanes), f64, VAR's poles, seeded |noise|, and at the
main shape on the worst case (a burst, then exact zeros): for each chunk
length of CHUNKS and for one chunk (chunk = T, a thread per lane), the
device time by CUDA events, `--reps` calls a sample and `--rounds`
samples in a rotating order, printed as mean, min and max with the
re-run steps of one call.  Every setting's output is first held bit for
bit to the one-chunk output.  The warm-up is the module's default.
PYTHONPATH names the checkout whose kernels it builds and times (another
checkout's too, to compare two in one run); it prints where it imported
them from.  Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np

SR = 48000.0
SEED = 20261016
CHUNKS = (256, 512, 1024, 2048, 4096, 8192)
# (T, lanes, input): |noise|, or |noise| for T/10 and then exact zeros,
# where no speculated chunk after the burst merges (the worst case)
SHAPES = ((2_880_000, 1, "noise"), (480_000, 8, "noise"),
          (2_880_000, 1, "silence"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("switching_scan_sweep: no CUDA device", file=sys.stderr)
        return 1
    import zorak_tpu_torch
    from zorak_tpu_torch.kernels import _build
    from zorak_tpu_torch.kernels import switching_scan as SS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[sweep] {card}; zorak_tpu_torch from {zorak_tpu_torch.__file__}")
    for line in _build.build("switching_scan").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[sweep] build: {line.strip()}")
    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    up = float(np.exp(-1.0 / (SR * 0.0025)))
    dn = float(np.exp(-1.0 / (SR * 0.080)))

    def ms(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    for n_t, lanes, kind in SHAPES:
        x = np.abs(rng.randn(n_t, lanes))
        if kind == "silence":
            x[n_t // 10:] = 0.0
        x = torch.from_numpy(x).to(cuda)
        v = [torch.full((lanes,), p, dtype=torch.float64, device=cuda)
             for p in (up, dn, 0.0)]
        settings = list(CHUNKS) + [n_t]
        one = SS.switching_scan(x, *v, chunk=n_t)
        reruns = {}
        for c in settings:
            for r in SS.RERUN_STEPS.values():
                r.zero_()
            y = SS.switching_scan(x, *v, chunk=c)
            reruns[c] = sum(int(r.item()) for r in SS.RERUN_STEPS.values())
            if not torch.equal(y.view(torch.int64), one.view(torch.int64)):
                print(f"[sweep] chunk={c} differs from one chunk at "
                      f"T={n_t} lanes={lanes} {kind}", file=sys.stderr)
                return 1
        times = {c: [] for c in settings}
        for i in range(args.rounds):
            order = settings[i % len(settings):] + settings[:i % len(settings)]
            for c in order:
                times[c].append(ms(lambda: SS.switching_scan(x, *v, chunk=c)))
        for c in settings:
            t = np.array(times[c])
            name = "one chunk" if c == n_t else f"chunk={c}"
            print(f"[sweep] T={n_t} lanes={lanes} f64 {kind} {name}: mean_ms="
                  f"{t.mean():.4f} min_ms={t.min():.4f} max_ms={t.max():.4f} "
                  f"rerun_steps={reruns[c]} samples={len(t)}x{args.reps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
