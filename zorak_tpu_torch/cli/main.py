"""Command-line interface of the port: list / inspect / render.

Same arguments as zorak_tpu/cli/main.py (render's `--engine` names the
port's engines: auto, vector, shadow), plus `--device` for render (default
cuda; `--device cpu` runs the plain PyTorch path):

    python -m zorak_tpu_torch.cli.main list    --catalog <catalog root>
    python -m zorak_tpu_torch.cli.main inspect --catalog ... --only VAR
    python -m zorak_tpu_torch.cli.main render  --catalog ... --only VAR \
        --in in.wav --out out.wav [--device cpu]
    python -m zorak_tpu_torch.cli.main render  --catalog ... --only DDT \
        --in in.wav --out out.wav --slider 1=40 [--engine auto|vector|shadow]
        [--monitor compiled|shadow|delta]

Faust entries render through the port's modules, JSFX entries through
`runtime.engine.PluginInstance`.  The verify / bench / help / new-plugin
subcommands come with the tooling slice.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _specs(args):
    from ..catalog import discover, select

    specs = discover(args.catalog)
    if getattr(args, "only", None):
        specs = select(specs, args.only)
    return specs


def cmd_list(args) -> int:
    for s in _specs(args):
        print(f"{s.category:16s} {s.slug:18s} {s.plugin_type:5s} "
              f"{s.plugin_code} {s.entry_path.name}")
    return 0


def cmd_inspect(args) -> int:
    from ..models import get_faust_module

    for s in _specs(args):
        print(f"== {s.category}/{s.slug} ({s.plugin_type}) ==")
        if s.plugin_type == "jsfx":
            prog = s.load_program()
            caps = prog.capabilities()
            print(f"  desc: {prog.desc}")
            print(f"  io: {caps['io_channels']}  kind: {caps['plugin_kind']}")
            print(f"  midi: {caps['midi']}")
            print(f"  comm: uses_msg={prog.comm['uses_msg']} "
                  f"uses_gmem={prog.comm['uses_gmem']}")
            print(f"  sample_pool: {prog.sample_pool['uses_sample_pool']} "
                  f"file_io: {prog.sample_pool['uses_legacy_file_io']}")
            print(f"  memtop: {prog.memtop}")
            print(f"  sliders: {len(prog.slider_decls)}")
            for d in prog.slider_decls:
                kind = ("string" if d.is_string
                        else "choice" if d.is_choice else d.shape)
                print(f"    {d.ident:9s} [{kind:7s}] default={d.default:g} "
                      f"{d.label}")
            continue
        mod = get_faust_module(s.slug)
        if mod is None:
            print("  (no native module registered)")
            continue
        print(f"  module: {mod.name}  io: {mod.n_in}->{mod.n_out}  "
              f"latency: {mod.latency_frames}")
        for p in mod.params:
            print(f"    {p.name:14s} default={p.default:g} "
                  f"[{p.lo:g}..{p.hi:g}] {p.unit}")
    return 0


def _parse_sliders(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        out[int(k) - 1] = float(v)
    return out


def cmd_render(args) -> int:
    from ..device import resolve_device
    from ..models import get_faust_module
    from ..runtime import wavio

    dev = resolve_device(args.device)
    specs = _specs(args)
    if len(specs) != 1:
        print(f"render needs exactly one plugin (matched {len(specs)})",
              file=sys.stderr)
        return 2
    spec = specs[0]
    x, rate = wavio.read_wav(args.infile)
    if spec.plugin_type == "faust":
        mod = get_faust_module(spec.slug)
        if mod is None:
            print(f"no native module for faust plugin {spec.slug}",
                  file=sys.stderr)
            return 2
        if x.shape[0] < mod.n_in:
            x = np.concatenate(
                [x, np.zeros((mod.n_in - x.shape[0], x.shape[1]), np.float32)])
        xt = torch.from_numpy(x[: mod.n_in]).to(device=dev, dtype=torch.float64)
        t0 = time.perf_counter()
        y = mod(xt, mod.values(), float(rate)).to(torch.float32).cpu().numpy()
        wall = time.perf_counter() - t0
        engine = f"{dev.type}-faust"
    else:
        from ..runtime.engine import PluginInstance

        prefer = {"auto": "auto", "vector": "vector",
                  "shadow": "none"}[args.engine]
        inst = PluginInstance(spec.load_program(), srate=float(rate),
                              sliders=_parse_sliders(args.slider),
                              prefer=prefer, device=dev)
        res = inst.render(x, monitor=args.monitor)
        y, wall, engine = res.audio, res.wall_seconds, res.engine
        if inst.spec_error:
            print(f"vector engine refused the plugin: {inst.spec_error}")
        if args.monitor != "compiled":
            print(f"monitor={args.monitor} "
                  f"max_delta={res.details['max_delta']:.3e}")

    wavio.write_wav(args.outfile, y, int(rate))
    secs = x.shape[1] / float(rate)
    print(f"rendered {secs:.2f}s via {engine} in {wall:.3f}s "
          f"({secs / max(wall, 1e-9):.0f}x realtime) -> {args.outfile}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zorak-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--catalog", default="/root/reference",
                       help="catalog root (contains plugins/)")
        p.add_argument("--only", default="", help="filter plugins by substring")

    p = sub.add_parser("list")
    common(p)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("inspect")
    common(p)
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("render")
    common(p)
    p.add_argument("--in", dest="infile", required=True)
    p.add_argument("--out", dest="outfile", required=True)
    p.add_argument("--slider", action="append",
                   help="sliderN=value (repeatable, 1-based N)")
    p.add_argument("--engine", choices=("auto", "vector", "shadow"),
                   default="auto")
    p.add_argument("--monitor", choices=("compiled", "shadow", "delta"),
                   default="compiled",
                   help="correctness-monitor output selection (ref "
                        "JSFXCorrectnessCheck.h:1042): write the golden "
                        "shadow's audio or the compiled-minus-shadow null")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to render (default cuda; no silent CPU fallback)")
    p.set_defaults(fn=cmd_render)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
