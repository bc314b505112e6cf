"""Vectorized MT19937 (numpy) producing the EXACT sequence of
semantics/scalar.EelRng — used to pregenerate rand() streams for the
vector engine and to advance the golden state without a Python loop.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

N = 624
M = 397
SEED = 0x4141F00D
MATRIX_A = np.uint32(0x9908B0DF)
UPPER = np.uint32(0x80000000)
LOWER = np.uint32(0x7FFFFFFF)


def init_state() -> Tuple[np.ndarray, int]:
    mt = np.empty(N, dtype=np.uint32)
    mt[0] = SEED
    for i in range(1, N):
        prev = int(mt[i - 1])
        mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
    return mt, N


def _twist(mt: np.ndarray) -> np.ndarray:
    """The reference twist updates in place, so later elements read already
    -updated ones: k in [N-M, N-2] uses new[k-(N-M)], and the final element
    uses new[0].  Vectorize in lag-sized chunks to honor that."""
    y = (mt & UPPER) | (np.roll(mt, -1) & LOWER)  # old values everywhere
    mixed = ((y >> np.uint32(1))
             ^ np.where((y & np.uint32(1)).astype(bool), MATRIX_A, np.uint32(0)))

    new = np.empty(N, dtype=np.uint32)
    lag = N - M  # 227
    new[:lag] = mt[M:] ^ mixed[:lag]                 # old sources
    pos = lag
    while pos < N - 1:                               # new sources, lag apart
        end = min(pos + lag, N - 1)
        new[pos:end] = new[pos - lag:end - lag] ^ mixed[pos:end]
        pos = end
    y_last = (mt[N - 1] & UPPER) | (new[0] & LOWER)  # final: new[0] is fresh
    mixed_last = ((y_last >> np.uint32(1))
                  ^ (MATRIX_A if (y_last & np.uint32(1)) else np.uint32(0)))
    new[N - 1] = new[M - 1] ^ mixed_last
    return new


def _temper(y: np.ndarray) -> np.ndarray:
    y = y ^ (y >> np.uint32(11))
    y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
    y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
    y = y ^ (y >> np.uint32(18))
    return y


def generate(n: int, state: Tuple[np.ndarray, int] | None = None
             ) -> Tuple[np.ndarray, Tuple[np.ndarray, int]]:
    """Produce n tempered uint32 draws continuing from `state`
    ((mt, idx) with idx==0 meaning uninitialized, as in EelRng)."""
    if state is None or state[1] == 0:
        mt, idx = init_state()
    else:
        mt, idx = np.array(state[0], dtype=np.uint32), int(state[1])

    out = np.empty(n, dtype=np.uint32)
    pos = 0
    while pos < n:
        if idx >= N:
            mt = _twist(mt)
            idx = 0
        take = min(N - idx, n - pos)
        out[pos:pos + take] = _temper(mt[idx:idx + take])
        idx += take
        pos += take
    return out, (mt, idx)


def eelrng_state_tuple(rng) -> Tuple[np.ndarray, int]:
    """Convert semantics.scalar.EelRng state to (mt, idx).

    EelRng.idx points at the NEXT element to return within the current
    block (1..624 after a twist); the vectorized form uses the same
    convention except idx==624 triggers the twist lazily.
    """
    return np.array(rng.mt, dtype=np.uint32), rng.idx


def restore_eelrng(rng, state: Tuple[np.ndarray, int]) -> None:
    rng.mt = [int(v) for v in state[0]]
    rng.idx = int(state[1])
