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
    block_section    the audio-coupled @block (K10, generated by
                     lowering/devgen.py, csrc/block_ops.cuh)
    device_exec      the sequential executor's whole render (K11, generated
                     by lowering/devgen.py, csrc/block_ops.cuh)
    segment_graph    a render's step captured as a CUDA graph and replayed
                     (K5: the segment, or a coupled block's K10 and segment)
    gated_index      the gated regime's index program and the dynamic ring
                     read (K6, K3b: csrc/gated_index.cu)
    dsp_scan         the Faust stages' recurrences and noise (K9:
                     csrc/dsp_scan.cu)
"""
from .stft import stft, istft, stft_process  # noqa: F401
from .convolution import fir_conv, partitioned_convolve  # noqa: F401
