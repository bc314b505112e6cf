"""Device policy for every entry point of the port.

`device=None` means CUDA.  Without a GPU an entry point raises unless the
caller asked for the CPU explicitly; nothing carries on quietly on the
CPU.  The tests pass `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Return the torch.device an entry point runs on.

    None -> "cuda".  A CUDA device with no GPU present raises RuntimeError.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
