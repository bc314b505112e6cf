"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

    _build           nvcc build of csrc/ into ctypes-loaded libraries
    switching_scan   switching attack/release one-pole (csrc/switching_scan.cu)
    linrec_scan      first-order linear recurrences (csrc/linrec_scan.cu)
    ring_taps        sums of constant-gain ring-buffer taps (csrc/ring_taps.cu)
"""
