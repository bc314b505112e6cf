"""Minimal dependency-free WAV read/write (PCM 16/24/32 + float32/64).

The render engine's file IO; the correctness harness exports
compiled/shadow/delta bundles as 24-bit WAV like the reference
(ref: src/JSFXCorrectnessCheck.h:1131-1250).

Copy of zorak_tpu/runtime/wavio.py.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Returns (float32 [channels, samples] in [-1, 1], sample_rate)."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        (size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)

    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    (audio_fmt, nch, rate, _br, _ba, bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_fmt == _FMT_EXTENSIBLE and len(fmt) >= 26:
        (audio_fmt,) = struct.unpack_from("<H", fmt, 24)

    if audio_fmt == _FMT_FLOAT and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_fmt == _FMT_FLOAT and bits == 64:
        x = np.frombuffer(data, dtype="<f8").astype(np.float32)
    elif audio_fmt == _FMT_PCM and bits == 16:
        x = (np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0)
    elif audio_fmt == _FMT_PCM and bits == 24:
        b = np.frombuffer(data, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3)
        i32 = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = np.where(i32 >= (1 << 23), i32 - (1 << 24), i32)
        x = (i32.astype(np.float32) / 8388608.0)
    elif audio_fmt == _FMT_PCM and bits == 32:
        x = (np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0)
    else:
        raise ValueError(f"{path}: unsupported format {audio_fmt}/{bits}bit")

    frames = len(x) // nch
    return x[: frames * nch].reshape(frames, nch).T.copy(), rate


def write_wav(path: str | Path, audio: np.ndarray, rate: int,
              bits: int = 24, float_fmt: bool = False) -> None:
    """audio: [channels, samples] float; interleaves and writes."""
    a = np.asarray(audio, dtype=np.float64)
    if a.ndim == 1:
        a = a[None, :]
    nch, frames = a.shape
    inter = a.T.reshape(-1)

    if float_fmt:
        payload = inter.astype("<f4").tobytes()
        fmt_code, bits = _FMT_FLOAT, 32
    elif bits == 16:
        q = np.clip(np.round(inter * 32768.0), -32768, 32767).astype("<i2")
        payload = q.tobytes()
        fmt_code = _FMT_PCM
    elif bits == 24:
        q = np.clip(np.round(inter * 8388608.0), -8388608, 8388607).astype(np.int32)
        u = np.where(q < 0, q + (1 << 24), q).astype(np.uint32)
        b = np.empty((len(u), 3), dtype=np.uint8)
        b[:, 0] = u & 0xFF
        b[:, 1] = (u >> 8) & 0xFF
        b[:, 2] = (u >> 16) & 0xFF
        payload = b.tobytes()
        fmt_code = _FMT_PCM
    elif bits == 32:
        q = np.clip(np.round(inter * 2147483648.0), -(1 << 31), (1 << 31) - 1).astype("<i4")
        payload = q.tobytes()
        fmt_code = _FMT_PCM
    else:
        raise ValueError(f"unsupported bit depth {bits}")

    block_align = nch * bits // 8
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(payload), b"WAVE", b"fmt ", 16,
        fmt_code, nch, rate, rate * block_align, block_align, bits,
        b"data", len(payload))
    Path(path).write_bytes(hdr + payload)
