"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

    _build           nvcc build of csrc/ into ctypes-loaded libraries
    switching_scan   switching attack/release one-pole (csrc/switching_scan.cu)
"""
