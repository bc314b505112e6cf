"""Staged dumps of a kernel's lowering: the port's counterpart of
zorak_tpu/utils/dumps.py (the observability analog of the reference AOT's
--opt-report / --opt-dump-dir staged files).

The stages are the port's: source -> lowered AST -> the plan -> one
segment's top-level torch calls on the CPU (in place of the jaxpr) -> the
generated CUDA C++ the kernel launches (in place of StableHLO: K4's scan
levels, K10's sections for a coupled or hop kernel, K11's file for a
sequential executor) -> nvcc's register and spill report for those
sources (in place of the compiled HLO), where a CUDA toolchain is found.
"""
from __future__ import annotations

import collections
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..frontend.printer import program_text

# the lines of nvcc's -Xptxas -v report that 06_build.txt keeps
_PTXAS_KEYS = ("Compiling entry function", "Function properties",
               "registers", "spill")


def dump_stages(kernel, out_dir: str | Path,
                example_len: int = 1024) -> Dict[str, str]:
    """Write the staged files for one kernel (a vector kernel or a
    `DeviceExecKernel`); returns {file name: path}."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths: Dict[str, str] = {}
    P = kernel.P

    def put(name: str, text: str) -> None:
        p = out / name
        p.write_text(text)
        paths[name] = str(p)

    put("01_source.jsfx", P.source)

    sections = []
    for sec in ("init", "slider", "block", "sample"):
        sections.append(f"@{sec}")
        sections.append(program_text(P.sections.get(sec, [])))
        sections.append("")
    for name, f in P.fn_defs.items():
        sections.append(f"// specialized function {name}({', '.join(f.params)})")
        sections.append(program_text([f.body]))
        sections.append("")
    put("02_sections_lowered.jsfx", "\n".join(sections))

    devexec = _is_devexec(kernel)
    put("03_plan.txt", _devexec_plan(kernel) if devexec
        else _vector_plan(kernel))
    put("04_ops.txt", _segment_ops(kernel, devexec, example_len))
    sources = _generated_sources(kernel, devexec)
    put("05_cuda.cu", "".join(f"// ==== {label} ====\n{src}\n"
                              for label, src in sources)
        or "// no generated CUDA: the kernel launches only the fixed "
           "kernels of csrc/\n")
    put("06_build.txt", _build_report(sources, out))
    return paths


def _is_devexec(kernel) -> bool:
    from ..lowering.devexec import DeviceExecKernel

    return isinstance(kernel, DeviceExecKernel)


def _vector_plan(kernel) -> str:
    """The reference's plan lines."""
    lines = [
        f"segment_len={kernel.L} block_size={kernel.B} nch={kernel.nch}",
        f"has_block={kernel.has_block} "
        f"control_vars={len(kernel.control_vars)} "
        f"ctrl_streams={len(kernel.ctrl_order)}",
        f"carried_scalars={len(kernel.carried_vars)}",
        f"ring_regions={[(o, m) for (o, m) in kernel.ring_regions]}",
        f"scan_group({len(kernel.scan_group)})="
        f"{sorted(kernel.scan_group, key=repr)}",
        "",
        "var plans:",
    ]
    for key in sorted(kernel.plans, key=repr):
        lines.append(f"  {key!r}: {kernel.plans[key].kind}")
    return "\n".join(lines)


def _devexec_plan(kernel) -> str:
    """The sequential executor's plan: its sections, its heap row and its
    slot table."""
    s = kernel.sample
    secs = [sec.section for sec in (kernel.block, kernel.slider, s)
            if sec is not None]
    lines = [
        f"engine=devexec block_size={kernel.B} nch={kernel.nch} "
        f"sections={secs}",
        f"heap={s.mem_size} maxmem_heap={kernel._full_size} "
        f"climbs={kernel.heap_climbs}",
        f"row: heap [0, {s.mem_size}) | gmem window [{s.gmem_base}, "
        f"{s.gmem_base + s.gmem_cells}) | MIDI out [{s.midi_out_base}, "
        f"{s.midi_out_base + s.midi_out_cells}) total_mem={s.total_mem}",
        f"uses_rand={kernel.uses_rand} pool={kernel._rand_cap} "
        f"n_vars={s.n_vars}",
        "",
        "var slots:",
    ]
    for key, slot in sorted(s.slots.items(), key=lambda kv: kv[1]):
        lines.append(f"  {slot}: {key!r}")
    return "\n".join(lines)


def _segment_ops(kernel, devexec: bool, example_len: int) -> str:
    """The top-level torch calls of one segment's render on the CPU, by
    name and count (the profiler form of scripts/solo_render_turns.py
    --ops), from a twin of the kernel built on the CPU, so that the
    kernel's own state stays as it was."""
    from torch.profiler import ProfilerActivity, profile

    if devexec:
        from ..lowering.devexec import DeviceExecKernel

        twin = DeviceExecKernel(kernel.P, kernel.snap, kernel.nch,
                                block_size=kernel.B,
                                rand_pool=kernel._rand_pool_req,
                                heap_size=kernel.mem_size, device="cpu")
        L = max(1, int(example_len))
    else:
        from ..lowering import specialize_sample_kernel

        twin = specialize_sample_kernel(
            kernel.P, kernel.snap, kernel.nch,
            segment_len=min(int(example_len), kernel.L),
            block_size=kernel.B, masked_loop_k=kernel.masked_loop_k,
            device="cpu")
        L = twin.L
    x = torch.from_numpy((np.random.RandomState(0).randn(kernel.nch, L)
                          * 0.25).astype(np.float32))
    twin.render_device(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        twin.render_device(x)
    calls = collections.Counter(e.name for e in prof.events()
                                if e.cpu_parent is None)
    lines = [f"one segment of {L} samples on the CPU: "
             f"{sum(calls.values())} top-level torch calls", ""]
    lines += [f"{n:6d}  {name}" for name, n in
              sorted(calls.items(), key=lambda kv: (-kv[1], kv[0]))]
    return "\n".join(lines) + "\n"


def _generated_sources(kernel, devexec: bool) -> List[Tuple[str, str]]:
    """(label, text) of every generated CUDA source the kernel launches."""
    if devexec:
        return [("K11 device_exec", kernel.program.source)]
    out = [(f"K4 scan_group, scan level {lv}", lowered[2].source)
           for lv, lowered in sorted(kernel.scan_level_programs().items())]
    for attr, what in (("_block_prog", "@block"), ("_hop_prog", "hop")):
        prog = getattr(kernel, attr, None)
        if prog is not None:
            out.append((f"K10 block_section, the {what} section",
                        prog.source))
    return out


def _build_report(sources: List[Tuple[str, str]], out: Path) -> str:
    """nvcc's -Xptxas -v lines (registers, stack frames, spills) for each
    source, compiled to a cubin for sm_90a in a folder of the dump that is
    removed again; one line saying why where there is nothing to build or
    no CUDA toolchain."""
    from ..kernels import _build

    if not sources:
        return "(no generated source to build)\n"
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError as exc:
        return f"(build text unavailable: {exc})\n"
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    work = out / "_build"
    work.mkdir(exist_ok=True)
    running = []
    try:
        for k, (label, src) in enumerate(sources):
            cu = work / f"stage{k}.cu"
            cu.write_text(src)
            running.append((label, subprocess.Popen(
                [nvcc, *flags, "-cubin", "-I", str(_build.CSRC_DIR), "-o",
                 str(work / f"stage{k}.cubin"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        text = []
        for label, proc in running:
            log = proc.communicate()[0]
            text.append(f"== {label} (nvcc exit {proc.returncode}) ==")
            text += [ln.strip() for ln in log.splitlines()
                     if any(k in ln for k in _PTXAS_KEYS)]
            if proc.returncode != 0:
                text.append(log.strip())
        return "\n".join(text) + "\n"
    finally:
        for _label, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
