"""Build the port's CUDA kernels from `csrc/` with nvcc, load them with ctypes.

Each source in `csrc/` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  A
library is built at its first use, into `zorak_tpu_torch/_build/` (listed
in .gitignore), under a name that carries the hash of its source and of
the flags: editing a source rebuilds it, and a library built from another
source is never loaded.

A kernel whose text is generated at run time (a sequential scan group,
`lowering/scan_codegen.py`) takes the second way in: `load_generated`
writes the text to `_build/gen-<hash>.cu`, compiles it with the same flags
plus `-I csrc/` and loads it; the hash covers the text, the flags and the
headers of `csrc/`, so the same text never compiles twice.  A fixed
source's hash covers those headers too.

A source that also compiles without CUDA (its host form, for tests where
there is no GPU) is built by `load_host` (a fixed source) or
`load_generated_host` (a generated one) with a host C++ compiler.

Importing this module runs nothing and needs no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# kernel name -> its source under csrc/
SOURCES: Dict[str, str] = {
    "switching_scan": "switching_scan.cu",
    "linrec_scan": "linrec_scan.cu",
    "ring_taps": "ring_taps.cu",
    "stft_ola": "stft_ola.cu",
    "partition_mac": "partition_mac.cu",
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
    """Where kernel `name` is built, named by the hash of its source, the
    flags and csrc/'s headers (a source may include one)."""
    src = (CSRC_DIR / SOURCES[name]).read_text()
    return BUILD_DIR / f"lib{name}-{_generated_stem(src, NVCC_FLAGS)}.so"


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


def _generated_stem(source: str, flags: Tuple[str, ...]) -> str:
    """The hash of a generated text, the flags and csrc/'s headers."""
    h = hashlib.sha256(source.encode() + b"\0" + "\0".join(flags).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(b"\0" + header.read_bytes())
    return h.hexdigest()[:16]


def generated_paths(source: str) -> Tuple[Path, Path]:
    """(the .cu a generated source is written to, the library built from
    it), named by the hash of the text, the flags and csrc/'s headers."""
    stem = f"gen-{_generated_stem(source, NVCC_FLAGS)}"
    return BUILD_DIR / f"{stem}.cu", BUILD_DIR / f"lib{stem}.so"


def build_generated(sources: Iterable[str]) -> Dict[str, str]:
    """Compile the generated sources that are not built yet, one nvcc
    each, all started together; return nvcc's log by source text ("" for
    one that was built before).

    Raises RuntimeError with the compiler's output if a build fails.
    """
    logs: Dict[str, str] = {}
    running = []
    for source in dict.fromkeys(sources):
        cu, out = generated_paths(source)
        if out.is_file():
            logs[source] = ""
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp_cu = cu.with_name(f"{cu.stem}.{os.getpid()}.tmp.cu")
        tmp_cu.write_text(source)
        os.replace(tmp_cu, cu)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, proc, tmp, out, cu))
    failed = []
    for source, proc, tmp, out, cu in running:
        logs[source] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"build of generated kernel {cu.name} failed (nvcc "
                          f"exit {proc.returncode}):\n{logs[source]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_generated(source: str) -> ctypes.CDLL:
    """Build the generated source if needed and load its library."""
    build_generated((source,))
    return ctypes.CDLL(str(generated_paths(source)[1]))


# the host form of a generated source: the same two roundings a multiply-add
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")


def find_host_compiler() -> str:
    """Path of g++ (or gcc, cc), for the host form of a generated source."""
    for name in ("g++", "gcc", "c++", "cc"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found (g++, gcc, c++, cc)")


def load_generated_host(source: str) -> ctypes.CDLL:
    """Compile a generated source for the CPU (no CUDA: its host form, a
    plain loop over time around the same bodies) and load it.  For tests
    and for reading a body's arithmetic where there is no GPU; no render
    path calls it."""
    return _load_host_text(
        source,
        BUILD_DIR / f"libgenhost-{_generated_stem(source, HOST_FLAGS)}.so")


def load_host(name: str) -> ctypes.CDLL:
    """Compile kernel `name`'s source for the CPU (its host form: the file
    without __CUDACC__) and load it.  For tests where there is no GPU; no
    render path calls it."""
    source = (CSRC_DIR / SOURCES[name]).read_text()
    return _load_host_text(
        source,
        BUILD_DIR / f"libhost-{name}-{_generated_stem(source, HOST_FLAGS)}.so")


def _load_host_text(source: str, out: Path) -> ctypes.CDLL:
    """Compile C++ text with the host flags into `out` unless it is built,
    and load it."""
    if not out.is_file():
        cxx = find_host_compiler()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *HOST_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), "-",
             "-lm"],
            input=source, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host build of {out.name} failed "
                               f"({cxx} exit {proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
