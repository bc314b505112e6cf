#!/usr/bin/env python3
"""The instruction mix of the partition MAC kernel (K8), from its SASS.

    PYTHONPATH=. python3 scripts/partition_mac_sass.py

Builds csrc/partition_mac.cu (zorak_tpu_torch.kernels._build) and
disassembles the library with cuobjdump.  For each build of the kernel
(one a tile (R, W, PG), and the earlier design) it prints the number of
instructions and, for the steady loop (the innermost loop that holds
f32 multiplies and adds, the walk of R whole steps), its f32 multiplies
and adds, shared loads and the rest: the share of the loop's
instructions that are MAC arithmetic.  Needs the CUDA toolkit (nvcc, cuobjdump); no card.
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

from zorak_tpu_torch.kernels import _build

LINE = re.compile(r"\s+/\*([0-9a-f]+)\*/\s+(.*?);")
BACK = re.compile(r"BRA .*?(0x[0-9a-f]+)")


def opcode(ins: str) -> str:
    """The opcode of a SASS line, predicate and modifiers dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]


def steady_loop(lines):
    """The innermost backward branch's body that holds f32 arithmetic."""
    where = {a: i for i, (a, _) in enumerate(lines)}
    best = None
    for i, (a, ins) in enumerate(lines):
        m = BACK.search(ins)
        target = int(m.group(1), 16) if m else a
        if target >= a or target not in where:
            continue
        body = lines[where[target]:i + 1]
        if any(opcode(x) in ("FMUL", "FADD") for _, x in body) and (
                best is None or len(body) < len(best)):
            best = body
    return best


def main() -> int:
    _build.build("partition_mac")
    lib = _build.library_path("partition_mac")
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        if "partition_mac" not in name:
            continue
        tile = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", name)
        label = (f"(R, W, PG) = ({tile.group(1)}, {tile.group(2)}, "
                 f"{tile.group(3)})" if tile else "the earlier design")
        lines = [(int(m.group(1), 16), m.group(2))
                 for m in map(LINE.match, func.splitlines()) if m]
        body = steady_loop(lines)
        if body is None:
            print(f"{label}: {len(lines)} instructions; no loop of f32 "
                  f"arithmetic found")
            continue
        ops = collections.Counter(opcode(x) for _, x in body)
        fp = ops["FMUL"] + ops["FADD"]
        rest = {k: v for k, v in ops.most_common()
                if k not in ("FMUL", "FADD", "LDS")}
        print(f"{label}: {len(lines)} instructions; steady loop "
              f"{len(body)}: FMUL+FADD {fp}, LDS {ops['LDS']}, other "
              f"{len(body) - fp - ops['LDS']} ({fp / len(body):.1%} of the "
              f"slots are MAC arithmetic); other opcodes {rest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
