"""zorak_tpu_torch — the PyTorch/CUDA port of zorak_tpu for NVIDIA Hopper.

The JAX package `zorak_tpu` is the reference; this package keeps its
module names so each counterpart is easy to find, and holds its own copy
of everything it needs (it imports neither `jax` nor `zorak_tpu`).

Ported so far (the Faust-family slice):
  device.py        device policy: None means CUDA, CPU only when asked for
  csrc/            hand-written CUDA kernels (nvcc, plain C interface)
  kernels/         kernel build + wrappers (switching attack/release scan)
  models/          dspkit primitives and the five Faust modules (nn.Module)
  parallel/        FaustBatchRenderer (files as a written-out batch dim)
  convert.py       parameters and initial state carried across from JAX
  runtime/wavio    WAV IO, catalog/ discovery, verify/ audio comparator
  cli/             list / inspect / render

Importing the package touches no global torch state (default dtype,
default device, thread count) and builds nothing: kernels compile at
their first launch.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
