"""The host-service tables of a printed program, staged for its kernel.

`lowering/devgen.py`'s HostTables holds, as host arrays, what the host
services of one program's sections read on the device: the loaded sample
pool's generation, the file table and the literal pool.  K10
(`block_section`) and K11 (`device_exec`) pass them to each launch as
`csrc/block_ops.cuh`'s ZH, a struct of their addresses; `tables_arg`
copies them to the launch's device once a version of the tables and
keeps the copies beside them, so every launch, file and heap rung of a
render shares one staging.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch


class ZHStruct(ctypes.Structure):
    """`csrc/block_ops.cuh`'s ZH: the tables' addresses, in its order."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "pool_data", "pool_offs", "pool_frm", "pool_nch", "pool_pv_off",
        "pool_pv_bins", "pool_order", "pool_meta", "pool_pv")]
        + [("pool_maxsid", ctypes.c_longlong),
           ("pool_n_order", ctypes.c_longlong), ("files", ctypes.c_void_p),
           ("str_h", ctypes.c_void_p), ("str_len", ctypes.c_void_p),
           ("str_chars", ctypes.c_void_p), ("str_n", ctypes.c_longlong),
           ("str_w", ctypes.c_longlong)])


def tables_arg(tables, device):
    """`tables` (a HostTables) on `device` (a CUDA device, or the CPU for
    the host forms), by reference for a launch: copied over once, and
    again only where a later print added to them."""
    key = str(torch.device(device))
    got = tables.staged.get(key)
    if got is None or got[0] != tables.version:
        keep = []

        def put(a) -> int:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
            keep.append(t)
            return t.data_ptr()
        z = ZHStruct()
        if tables.pool is not None:
            t = tables.pool
            for name in ("data", "offs", "frm", "nch", "pv_off", "pv_bins",
                         "order", "meta", "pv"):
                setattr(z, f"pool_{name}", put(t[name]))
            z.pool_maxsid, z.pool_n_order = t["maxsid"], t["n_order"]
        if tables.file_cells:
            z.files = put(tables.file_table())
        if tables.strings is not None:
            h, ln, ch, width = tables.strings
            z.str_h, z.str_len, z.str_chars = put(h), put(ln), put(ch)
            z.str_n, z.str_w = len(h), width
        got = tables.staged[key] = (tables.version, z, keep)
        tables.stagings += 1
    return ctypes.byref(got[1])
