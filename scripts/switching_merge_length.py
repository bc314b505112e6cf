#!/usr/bin/env python3
"""Merge lengths of the switching scan on VAR's and RED's follower inputs.

    python scripts/switching_merge_length.py [--seconds 5] [--starts 8]

The chunk-parallel switching scan (zorak_tpu_torch/csrc/switching_scan.cu)
starts each chunk from a guess, x at the start of its warm-up, and counts
on that trajectory becoming bit-identical to the true one within the
warm-up.  This renders VAR and RED with the port on the CPU (seeded noise
at 0.25 rms, 48 kHz), catches the input of each switching one-pole they
run, and prints, for each follower and in f64 and f32, after how many
steps a trajectory started from the guess at each of `--starts` places
equals the true one in its bits (-1: not within 100,000 steps).  Plain
Python loops: about 20 s for 5 s of audio.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from zorak_tpu_torch.models import dspkit as K
from zorak_tpu_torch.models import get_faust_module

SR = 48000.0
SEED = 20261016
HORIZON = 100_000


def follower_inputs(n_t: int):
    """(name, x [T] f64, up, dn) of every switching one-pole VAR and RED run."""
    caught = []
    plain = K.switching_onepole

    def spy(x, up, dn, z0=0.0):
        caught.append((x.detach().reshape(-1, x.shape[-1])[0].numpy().copy(),
                       float(np.asarray(up).reshape(-1)[0]),
                       float(np.asarray(dn).reshape(-1)[0])))
        return plain(x, up, dn, z0)

    rng = np.random.RandomState(SEED)
    K.switching_onepole = spy
    try:
        for slug in ("VAR", "RED"):
            mod = get_faust_module(slug)
            x = torch.from_numpy(rng.randn(mod.n_in, n_t) * 0.25)
            mod(x, mod.values(), SR)
    finally:
        K.switching_onepole = plain
    names = ["VAR env", "RED gr_norm", "RED gr_fast"]
    return [(n, *c) for n, c in zip(names, caught)]


def trajectory(x, up, dn, z, t0, t1, dtype):
    out = np.empty(t1 - t0, dtype)
    z, up, dn = dtype(z), dtype(up), dtype(dn)
    for i in range(t0, t1):
        xt = x[i]
        z = xt + (z - xt) * (up if xt > z else dn)
        out[i - t0] = z
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--starts", type=int, default=8)
    args = ap.parse_args()
    n_t = int(args.seconds * SR)
    for name, x, up, dn in follower_inputs(n_t):
        for dtype, ints in ((np.float64, np.int64), (np.float32, np.int32)):
            xs = x.astype(dtype)
            true = trajectory(xs, up, dn, 0.0, 0, n_t, dtype).view(ints)
            starts = np.linspace(n_t // 10, max(n_t // 10, n_t - HORIZON),
                                 args.starts).astype(int)
            lengths = []
            for s in starts:
                guess = trajectory(xs, up, dn, xs[s], s, min(n_t, s + HORIZON),
                                   dtype).view(ints)
                same = np.nonzero(guess == true[s:s + len(guess)])[0]
                lengths.append(int(same[0]) if len(same) else -1)
            print(f"{name} {dtype.__name__} up={up:.6f} dn={dn:.6f} "
                  f"zeros={np.mean(x == 0.0):.3f} merge_steps={lengths}",
                  flush=True)


if __name__ == "__main__":
    main()
