#!/usr/bin/env python3
"""The solo JSFX render of two checkouts, timed in turns on one card.

    python3 scripts/solo_render_turns.py OLD_DIR NEW_DIR [--reps 5]
        [--rounds 1]

For each plugin of chip_smoke.py's JSFX main path (the fallback network,
the 192-tap widening, the cross-fed network, the follower and the stereo
followers) a child process imports `zorak_tpu_torch` from one checkout and
times `kernel.render_device` on 60 s of 48 kHz stereo noise already on
the card, left there: a warm-up render, then `reps` renders, each by CUDA
events, and the host's share: the CPU time of the calling thread while
`render_device` enqueues the render (`time.thread_time`, which other
tenants of the host's cores do not inflate; the wait for the card is not
in it).  The input is the same seeded noise in every turn.  The turns run
old, new, new, old (`--rounds` times), so that a drift of the card's
clock or of the host's load falls on both checkouts.  Prints one JSON
line a turn, then a line with the best and the median of each
checkout's renders (every turn) a plugin, device and host, and new over
old.  Each checkout builds its kernels into its own
`zorak_tpu_torch/_build/`.  Needs a CUDA card.

    python3 scripts/solo_render_turns.py OLD_DIR NEW_DIR --graph [--reps 2]

times instead, the same way, chip_smoke.py's render graph and its
sequential executor: `RenderGraph.run` of four `crossmix_declutter`
nodes x 60 s at block 512 (all torch-lockstep; host clock to a
synchronise, and the calling thread's CPU time), after a 1,024-sample
render that builds them, and `grain_texture(16, 131072)` through
`PluginInstance.render` on 60 s with a note-on every 0.5 s (each render
a fresh instance, after a 1 s render that builds K11): the render by
CUDA events and its last K11 launch, the one the heap ladder keeps.

    python3 scripts/solo_render_turns.py OLD_DIR NEW_DIR --ops

counts instead, on the CPU, the top-level torch calls a segment of each
plugin's solo render (segments of 512, torch.profiler) in each checkout,
and prints the calls that differ.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SR = 48000.0
N = 2_880_000                  # 60 s at 48 kHz, chip_smoke.py's MAIN_T
SEED = 1234
HERE = Path(__file__).resolve().parent.parent


def plugins():
    """label -> JSFX source; the two scan-group sources from this
    checkout's chip_smoke.py, so that both turns render the same text."""
    from zorak_tpu_torch import builtin_plugins as BP

    spec = importlib.util.spec_from_file_location("_smoke_sources",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return {"fallback": BP.FALLBACK_SRC,
            "wide": BP.wide_delay_network(192),
            "cross_fed": BP.cross_fed_delay_network(16),
            "follower": smoke.SCAN_GROUP_SRC,
            "stereo_followers": smoke.STEREO_FOLLOWERS_SRC}


def child(reps: int) -> dict:
    """One turn: every plugin's render times in this process's checkout."""
    import torch

    import zorak_tpu_torch
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.runtime.engine import PluginInstance

    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda)
    out = {"package": zorak_tpu_torch.__file__}
    for label, src in plugins().items():
        kern = PluginInstance(compile_plugin_source(src), srate=SR).kernel
        gen.manual_seed(SEED)
        x = torch.randn((2, N), generator=gen, device=cuda) * 0.25
        kern.render_device(x)                          # warm-up, builds
        torch.cuda.synchronize()
        times, host = [], []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            t0 = time.thread_time()
            kern.render_device(x)
            host.append((time.thread_time() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[label] = times
        out[f"{label} host"] = host
    return out


GRAPH_NODES, GRAPH_BLOCK = 4, 512      # chip_smoke.py's graph phase
TEXTURE = (16, 131072)                 # chip_smoke.py's devexec stand-in
NOTE_EVERY = 24000                     # a note-on every 0.5 s


def graph_child(reps: int) -> dict:
    """One turn of `--graph`: the graph's and the Texture stand-in's
    render times in this process's checkout."""
    import numpy as np
    import torch

    import zorak_tpu_torch
    from zorak_tpu_torch import builtin_plugins as BP
    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.kernels import device_exec as DX
    from zorak_tpu_torch.runtime.engine import PluginInstance
    from zorak_tpu_torch.runtime.graph import RenderGraph

    rng = np.random.RandomState(SEED)
    out = {"package": zorak_tpu_torch.__file__}
    g = RenderGraph(srate=SR, block_size=GRAPH_BLOCK, prefer="auto")
    names = [f"n{i}" for i in range(GRAPH_NODES)]
    for i, nm in enumerate(names):
        g.add(nm, compile_plugin_source(BP.crossmix_declutter(i, GRAPH_NODES)))
    g.init_all()
    if g.node_engines != ["torch-lockstep"] * GRAPH_NODES:
        raise SystemExit(f"graph engines {g.node_engines}")
    x = {nm: (rng.randn(2, N) * 0.25).astype(np.float32) for nm in names}
    g.run({nm: a[:, :2 * GRAPH_BLOCK] for nm, a in x.items()})   # builds
    torch.cuda.synchronize()
    wall, host = [], []
    for _ in range(reps):
        t0, c0 = time.perf_counter(), time.thread_time()
        g.run(x)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        host.append((time.thread_time() - c0) * 1e3)
    out["graph"], out["graph host"] = wall, host

    prog = compile_plugin_source(BP.grain_texture(*TEXTURE))
    xt = (rng.randn(2, N) * 0.25).astype(np.float32)
    notes = [(o, 0x90, 48 + (o // NOTE_EVERY) % 24, 100)
             for o in range(100, N, NOTE_EVERY)]
    one = int(SR)
    PluginInstance(prog, srate=SR).render(                      # builds
        xt[:, :one], midi=[n for n in notes if n[0] < one])
    real, renders, kept = DX.device_exec, [], []
    for _ in range(reps):
        inst = PluginInstance(prog, srate=SR)
        if inst.engine != "torch-devexec":
            raise SystemExit(f"texture engine {inst.engine}")
        launches = []

        def timed(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            got = real(*a, **k)
            ev[1].record()
            launches.append(ev)
            return got
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        DX.device_exec = timed
        try:
            start.record()
            inst.render(xt, midi=notes)
            end.record()
        finally:
            DX.device_exec = real
        torch.cuda.synchronize()
        renders.append(start.elapsed_time(end))
        kept.append(launches[-1][0].elapsed_time(launches[-1][1]))
    out["texture render"], out["texture K11"] = renders, kept
    return out


def run_child(tree: Path, args) -> str:
    """This script's child mode in a process that imports `tree`'s
    package; returns its last line of output."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    run = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child", *args],
        cwd=tree, env=env, capture_output=True, text=True, check=False)
    if run.returncode != 0:
        sys.stderr.write(run.stderr)
        raise SystemExit(f"the turn in {tree} failed")
    return run.stdout.strip().splitlines()[-1]


def ops_child() -> dict:
    """Top-level torch calls a segment of each plugin's solo render, on
    the CPU (the plain kernels' own calls are not counted apart from the
    rest): the host's dispatches, which pace the render on the card."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from zorak_tpu_torch.ir import compile_plugin_source
    from zorak_tpu_torch.runtime.engine import PluginInstance

    seg, segments = 512, 4
    out = {}
    for label, src in plugins().items():
        kern = PluginInstance(compile_plugin_source(src), srate=SR,
                              segment_len=seg, device="cpu").kernel
        x = torch.randn((2, seg * segments)) * 0.25
        kern.render_device(x)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            kern.render_device(x)
        calls = collections.Counter(e.name for e in prof.events()
                                    if e.cpu_parent is None)
        out[label] = {"per_segment": sum(calls.values()) / segments,
                      "by_name": {k: v / segments
                                  for k, v in sorted(calls.items())}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", nargs="?")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1,
                    help="old, new, new, old this many times")
    ap.add_argument("--ops", action="store_true",
                    help="count torch calls a segment on the CPU instead")
    ap.add_argument("--graph", action="store_true",
                    help="time the render graph and the Texture stand-in "
                         "instead of the JSFX plugins")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(ops_child() if args.ops else
                         graph_child(args.reps) if args.graph else
                         child(args.reps)))
        return 0
    if not (args.old and args.new):
        ap.error("OLD_DIR and NEW_DIR are required")
    trees = {"old": Path(args.old).resolve(), "new": Path(args.new).resolve()}
    if args.ops:
        counts = {w: json.loads(run_child(tree, ["--ops"]))
                  for w, tree in trees.items()}
        for label in counts["old"]:
            old_n, new_n = (counts[w][label]["by_name"] for w in counts)
            print(json.dumps({label: {
                "old": counts["old"][label]["per_segment"],
                "new": counts["new"][label]["per_segment"],
                "new_minus_old": {k: new_n.get(k, 0) - old_n.get(k, 0)
                                  for k in sorted(set(old_n) | set(new_n))
                                  if new_n.get(k, 0) != old_n.get(k, 0)}}}))
        return 0
    every = {"old": {}, "new": {}}        # checkout -> plugin -> all times
    for which in ("old", "new", "new", "old") * args.rounds:
        times = json.loads(run_child(trees[which], [
            "--reps", str(args.reps), *(["--graph"] if args.graph else [])]))
        print(json.dumps({"turn": which, "ms": times}))
        del times["package"]
        for label, ts in times.items():
            every[which].setdefault(label, []).extend(ts)
    summary = {}
    for name, stat in (("best", min), ("median", statistics.median)):
        ms = {w: {label: stat(ts) for label, ts in every[w].items()}
              for w in every}
        summary[f"{name}_ms"] = ms
        summary[f"new_over_old_{name}"] = {
            label: ms["new"][label] / ms["old"][label] for label in ms["old"]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
