"""Build the port's CUDA kernels from `csrc/` with nvcc, load them with ctypes.

Each source in `csrc/` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  A
library is built at its first use, into `zorak_tpu_torch/_build/` (listed
in .gitignore), under a name that carries the hash of its source and of
the flags: editing a source rebuilds it, and a library built from another
source is never loaded.

Importing this module runs nothing and needs no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# kernel name -> its source under csrc/
SOURCES: Dict[str, str] = {
    "switching_scan": "switching_scan.cu",
    "linrec_scan": "linrec_scan.cu",
    "ring_taps": "ring_taps.cu",
}

# --fmad=false keeps multiply and add as two roundings, as in the plain
# PyTorch versions the kernels are held against.  -Xptxas -v records each
# kernel's registers, shared memory and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (CUDA toolkit needed)")


def library_path(name: str) -> Path:
    """Where kernel `name` is built, named by the hash of source and flags."""
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile the kernels `names` that are not built yet, one nvcc each,
    all started together; return each kernel's nvcc log.

    Raises RuntimeError with the compiler's output if a build fails.
    The log of a kernel that was already built is "" (nothing compiled).
    """
    logs: Dict[str, str] = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.is_file():
            logs[name] = ""
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"kernel build of {name} failed (nvcc exit "
                          f"{proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build(name: str) -> str:
    """Compile kernel `name` unless it is built; return nvcc's log."""
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """Build kernel `name` if needed and load its library."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
