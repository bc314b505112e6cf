"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

    _build           nvcc build of csrc/ into ctypes-loaded libraries
    switching_scan   switching attack/release one-pole (csrc/switching_scan.cu)
    linrec_scan      first-order linear recurrences (csrc/linrec_scan.cu)
    ring_taps        sums of constant-gain ring-buffer taps (csrc/ring_taps.cu)
    scan_group       sequential scan groups: a kernel generated from the
                     group's steps (lowering/scan_codegen.py, csrc/scan_ops.cuh)
    stft             STFT overlap-add and the spectral gate (csrc/stft_ola.cu)
    convolution      direct FIR and partitioned convolution
                     (csrc/partition_mac.cu)
"""
from .stft import stft, istft, stft_process  # noqa: F401
from .convolution import fir_conv, partitioned_convolve  # noqa: F401
