"""Command-line interface of the port: list / inspect / render / verify /
bench / help / new-plugin.

Same arguments as zorak_tpu/cli/main.py (render's `--engine` names the
port's engines: auto, vector, shadow), plus `--device` for render,
verify, bench and help (default cuda, with no CPU fallback; `--device
cpu` runs the plain PyTorch path):

    python -m zorak_tpu_torch.cli.main list    --catalog <catalog root>
    python -m zorak_tpu_torch.cli.main inspect --catalog ... --only VAR
    python -m zorak_tpu_torch.cli.main render  --catalog ... --only VAR \
        --in in.wav --out out.wav [--device cpu]
    python -m zorak_tpu_torch.cli.main render  --catalog ... --only DDT \
        --in in.wav --out out.wav --slider 1=40 [--engine auto|vector|shadow]
        [--monitor compiled|shadow|delta]
    python -m zorak_tpu_torch.cli.main verify  --catalog ... [--only Echo] \
        [--seconds 0.5] [--srate 48000] [--golden python|native] \
        [--export-dir DIR] [--device cpu]
    python -m zorak_tpu_torch.cli.main bench   --catalog ... --only DDT \
        [--seconds 60] [--srate 48000] [--json] [--device cpu]
    python -m zorak_tpu_torch.cli.main help    --catalog ... --only DDT \
        [--raw] [--plain] [--width 78] [--no-controls] [--device cpu]
    python -m zorak_tpu_torch.cli.main new-plugin --catalog DIR \
        --category Dynamics --key Mine [--name "My plugin"]

Faust entries render through the port's modules, JSFX entries through
`runtime.engine.PluginInstance`.  `verify` null-tests each JSFX entry's
vector render against the golden (`verify.null_test_plugin`).  `bench`
times what the reference's `prefer="tpu"` renders (the vectorizer, then
the sequential executor; an entry only the golden renders is skipped, as
are Faust entries): the best of three renders as a realtime factor, the
device synchronised inside the timed window.  `help` prints an entry's
README with a Controls reference from its sliders (its device is resolved
as the other commands' are); `new-plugin` scaffolds a catalog leaf.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

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


def cmd_verify(args) -> int:
    from ..device import resolve_device
    from ..lowering import SpecializeError
    from ..verify import null_test_plugin

    dev = resolve_device(args.device)
    failures = 0
    for spec in _specs(args):
        if spec.plugin_type != "jsfx":
            print(f"{spec.slug}: faust module (no shadow null test)")
            continue
        prog = spec.load_program()
        n = int(args.seconds * args.srate)
        rng = np.random.RandomState(42)
        ch = max(1, prog.io_channels["process"])
        x = (rng.randn(ch, n) * 0.25).astype(np.float32)
        try:
            rep = null_test_plugin(
                prog, x, srate=args.srate, golden=args.golden,
                export_dir=(args.export_dir if args.export_dir else None),
                name=spec.slug, device=dev)
            print(f"{spec.slug}: {rep.summary()}")
            if not rep.audio_passed:
                failures += 1
        except SpecializeError as exc:
            print(f"{spec.slug}: SKIP vector engine ({exc}) — shadow-only")
    return 1 if failures else 0


def _sync(dev) -> None:
    """Wait for the device's queued work: a render returns before the card
    has finished it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_bench(args) -> int:
    from ..device import resolve_device
    from ..lowering import SpecializeError
    from ..runtime.engine import PluginInstance

    dev = resolve_device(args.device)
    results = []
    for spec in _specs(args):
        if spec.plugin_type != "jsfx":
            continue
        prog = spec.load_program()
        n = int(args.seconds * args.srate)
        ch = max(1, prog.io_channels["process"])
        x = (np.random.RandomState(1).randn(ch, n) * 0.25).astype(np.float32)
        try:
            inst = PluginInstance(prog, srate=args.srate, prefer="tpu",
                                  device=dev)
        except SpecializeError as exc:
            print(f"{spec.slug}: no vector engine ({exc})")
            continue
        inst.render(x[:, : min(n, 1 << 17)], fetch_audio=False,
                    sync_state=False)
        _sync(dev)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            inst.render(x, fetch_audio=False, sync_state=False)
            _sync(dev)
            best = max(best, args.seconds / (time.perf_counter() - t0))
        print(f"{spec.slug}: {best:.0f}x realtime ({args.seconds:.0f}s render)")
        results.append((spec.slug, best))
    if args.json and results:
        print(json.dumps({slug: round(v, 1) for slug, v in results}))
    return 0


NEW_PLUGIN_TEMPLATE = """\
desc:{name}

slider1:50<0,100,1>Amount

@init
g = 0;

@slider
g = slider1 / 100;

@sample
spl0 *= g;
spl1 *= g;
"""


def cmd_help(args) -> int:
    """An entry's embedded README help, the offline form of the reference
    editor's '?' panel, with a Controls reference generated from the
    slider metadata (zorak_tpu/cli/main.py `cmd_help`)."""
    from ..device import resolve_device
    from ..utils.mdtext import NO_README_FALLBACK, render_markdown

    resolve_device(args.device)
    ansi = sys.stdout.isatty() and not args.plain
    found = False
    for s in _specs(args):
        found = True
        md = s.help_markdown() or NO_README_FALLBACK
        if args.raw:
            print(md, end="" if md.endswith("\n") else "\n")
            continue
        print(render_markdown(md, width=args.width, ansi=ansi), end="")
        if s.plugin_type == "jsfx" and not args.no_controls:
            try:
                prog = s.load_program()
            except Exception:  # noqa: BLE001 (help must not hard-fail)
                continue
            rows = []
            for d in prog.slider_decls:
                if d.hidden:
                    continue
                if d.is_string or d.is_choice:
                    rng = "choice" if d.is_choice else "text"
                else:
                    rng = f"{d.lo:g}..{d.hi:g}" \
                        if d.lo is not None and d.hi is not None else ""
                    if d.default is not None:
                        rng += f" (default {d.default:g})"
                lbl = d.label or ""
                if d.tooltip:
                    lbl += f" — {d.tooltip}"
                rows.append((f"slider{d.index0 + 1}", lbl, rng))
            if rows:
                ctl = ["", "## Controls", ""]
                ctl += [f"- `{n}` — {lbl}" + (f" `{rng}`" if rng else "")
                        for n, lbl, rng in rows]
                print(render_markdown("\n".join(ctl), width=args.width,
                                      ansi=ansi), end="")
    if not found:
        print("no matching plugin", file=sys.stderr)
        return 2
    return 0


def cmd_new_plugin(args) -> int:
    """Scaffold a catalog leaf: plugin.json, README.md, src/<key>.jsfx."""
    root = Path(args.catalog) / "plugins" / args.category / args.key
    if root.exists():
        print(f"{root} already exists", file=sys.stderr)
        return 2
    (root / "src").mkdir(parents=True)
    code = (args.key.upper() + "1111")[:4]
    (root / "plugin.json").write_text(json.dumps({
        "name": args.name or args.key,
        "slug": args.key,
        "pluginCode": code,
        "pluginType": "jsfx",
    }, indent=2) + "\n")
    (root / "README.md").write_text(f"# {args.name or args.key}\n\n"
                                    f"Describe the plugin here; this file "
                                    f"is the embedded '?' help panel.\n")
    (root / "src" / f"{args.key}.jsfx").write_text(
        NEW_PLUGIN_TEMPLATE.format(name=args.name or args.key))
    print(f"scaffolded {root}")
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

    p = sub.add_parser("verify")
    common(p)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--srate", type=float, default=48000.0)
    p.add_argument("--golden", choices=("python", "native"), default="native")
    p.add_argument("--export-dir", default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the vector engine renders (default cuda)")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("bench")
    common(p)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--srate", type=float, default=48000.0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to render (default cuda; no silent CPU fallback)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("help")
    common(p)
    p.add_argument("--raw", action="store_true",
                   help="print the raw embedded markdown")
    p.add_argument("--plain", action="store_true",
                   help="disable ANSI styling")
    p.add_argument("--width", type=int, default=78)
    p.add_argument("--no-controls", action="store_true",
                   help="omit the generated Controls reference")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="the device, resolved as the other commands resolve "
                        "it (default cuda)")
    p.set_defaults(fn=cmd_help)

    p = sub.add_parser("new-plugin")
    p.add_argument("--catalog", required=True,
                   help="catalog root to scaffold into (must be writable)")
    p.add_argument("--category", required=True)
    p.add_argument("--key", required=True)
    p.add_argument("--name", default="")
    p.set_defaults(fn=cmd_new_plugin)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
