"""JSFX FFT builtins: fft/ifft/fft_real/ifft_real/fft_permute/fft_ipermute/
convolve_c, matching the reference runtime's WDL-FFT semantics
(ref: src/JSFXJuceProcessor.cpp:1085-1460) with numpy/XLA FFTs.

Empirically verified contract against the vendored WDL fft:
* forward complex fft: unnormalized DFT (numpy convention, e^{-2pi i}),
  output stored in WDL's split-radix order: natural[k] = wdl[perm[k]],
* ifft: unnormalized inverse — ifft(fft(x)) == N * x,
* fft_real(N): N/2 complex bins, value 2*rfft(x)[k], bin 0 packs
  (2*DC, 2*Nyquist), ordered by perm(N/2),
* ifft_real inverse of that — roundtrip scales by 2N (caller applies
  0.5/N, matching the WDL header contract),
* convolve_c: pointwise complex multiply (order-independent),
* guards: size power-of-2 in [16, 32768], the whole region must stay
  inside one 65536-double page, base truncates with a +-1e-5 bias and
  clamps negatives to 0; failing any guard is a silent no-op.

The split-radix frequency mapping is the classic djbfft recurrence.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

MIN_FFT = 16
MAX_FFT = 32768
PAGE_DOUBLES = 65536

_perm_cache: Dict[int, np.ndarray] = {}
_iperm_cache: Dict[int, np.ndarray] = {}


def _split_radix_freq(i: int, n: int) -> int:
    if n <= 2:
        return i
    m = n >> 1
    if i < m:
        return _split_radix_freq(i, m) << 1
    i -= m
    m >>= 1
    if i < m:
        return (_split_radix_freq(i, m) << 2) + 1
    i -= m
    return ((_split_radix_freq(i, m) << 2) - 1) & (n - 1)


def perm_table(n: int) -> np.ndarray:
    """natural[k] == wdl[perm_table(n)[k]]."""
    tab = _perm_cache.get(n)
    if tab is None:
        tab = np.zeros(n, dtype=np.int64)
        for i in range(1, n):
            tab[n - _split_radix_freq(i, n)] = i
        tab.setflags(write=False)
        _perm_cache[n] = tab
    return tab


def iperm_table(n: int) -> np.ndarray:
    """wdl[k] == natural[iperm_table(n)[k]]."""
    tab = _iperm_cache.get(n)
    if tab is None:
        p = perm_table(n)
        tab = np.zeros(n, dtype=np.int64)
        tab[p] = np.arange(n, dtype=np.int64)
        tab.setflags(write=False)
        _iperm_cache[n] = tab
    return tab


def _round_index(v: float) -> int:
    try:
        return int(v + (1.0e-5 if v >= 0.0 else -1.0e-5))
    except (ValueError, OverflowError):
        return -1


def _pow2_ok(n: int) -> bool:
    return MIN_FFT <= n <= MAX_FFT and (n & (n - 1)) == 0


def _same_page(base: int, span: int) -> bool:
    if base < 0 or span <= 0:
        return False
    return base // PAGE_DOUBLES == (base + span - 1) // PAGE_DOUBLES


def _complex_region(S, base_d: float, count_d: float):
    count = _round_index(count_d)
    base = max(0, _round_index(base_d))
    if count <= 0 or count > PAGE_DOUBLES // 2:
        return None
    if not _same_page(base, 2 * count):
        return None
    S.mem_ensure(base + 2 * count)
    return base, count


def _fft_region(S, base_d: float, size_d: float):
    size = _round_index(size_d)
    if not _pow2_ok(size):
        return None
    return _complex_region(S, base_d, float(size))


def _real_region(S, base_d: float, size_d: float):
    size = _round_index(size_d)
    base = max(0, _round_index(base_d))
    if not _pow2_ok(size) or not _same_page(base, size):
        return None
    S.mem_ensure(base + size)
    return base, size


def _view_complex(S, base: int, n: int) -> np.ndarray:
    return S.mem[base: base + 2 * n].view().reshape(n, 2)


def dispatch(S, which: str, a0: float, a1: float) -> float:
    if which == "fft":
        r = _fft_region(S, a0, a1)
        if r:
            base, n = r
            buf = _view_complex(S, base, n)
            x = buf[:, 0] + 1j * buf[:, 1]
            spec = np.fft.fft(x)
            out = np.empty(n, dtype=np.complex128)
            out[perm_table(n)] = spec
            buf[:, 0] = out.real
            buf[:, 1] = out.imag
    elif which == "ifft":
        r = _fft_region(S, a0, a1)
        if r:
            base, n = r
            buf = _view_complex(S, base, n)
            wdl = buf[:, 0] + 1j * buf[:, 1]
            spec = wdl[perm_table(n)]
            x = np.fft.ifft(spec) * n  # unnormalized inverse
            buf[:, 0] = x.real
            buf[:, 1] = x.imag
    elif which == "fft_real":
        r = _real_region(S, a0, a1)
        if r:
            base, n = r
            half = n // 2
            x = S.mem[base: base + n].copy()
            R = np.fft.rfft(x) * 2.0
            nat = np.empty(half, dtype=np.complex128)
            nat[0] = complex(R[0].real, R[half].real)
            nat[1:] = R[1:half]
            out = np.empty(half, dtype=np.complex128)
            out[perm_table(half)] = nat
            buf = _view_complex(S, base, half)
            buf[:, 0] = out.real
            buf[:, 1] = out.imag
    elif which == "ifft_real":
        r = _real_region(S, a0, a1)
        if r:
            base, n = r
            half = n // 2
            buf = _view_complex(S, base, half).copy()
            wdl = buf[:, 0] + 1j * buf[:, 1]
            nat = wdl[perm_table(half)]
            R = np.empty(half + 1, dtype=np.complex128)
            R[0] = nat[0].real / 2.0
            R[half] = nat[0].imag / 2.0
            R[1:half] = nat[1:] / 2.0
            x = np.fft.irfft(R, n) * (2.0 * n)  # caller scales by 0.5/n
            S.mem[base: base + n] = x
    elif which == "fft_permute":
        r = _fft_region(S, a0, a1)
        if r:
            base, n = r
            buf = _view_complex(S, base, n)
            buf[:] = buf[perm_table(n)]
    elif which == "fft_ipermute":
        r = _fft_region(S, a0, a1)
        if r:
            base, n = r
            buf = _view_complex(S, base, n)
            out = np.empty_like(buf)
            out[perm_table(n)] = buf
            buf[:] = out
    else:
        raise ValueError(which)
    return 0.0


def convolve_c(S, dest_d: float, src_d: float, size_d: float) -> float:
    rd = _complex_region(S, dest_d, size_d)
    rs = _complex_region(S, src_d, size_d)
    if not rd or not rs or rd[1] != rs[1]:
        return 0.0
    db, n = rd
    sb, _ = rs
    d = _view_complex(S, db, n)
    s = _view_complex(S, sb, n).copy()  # overlap-safe
    dr, di = d[:, 0].copy(), d[:, 1].copy()
    d[:, 0] = dr * s[:, 0] - di * s[:, 1]
    d[:, 1] = dr * s[:, 1] + di * s[:, 0]
    return 0.0
