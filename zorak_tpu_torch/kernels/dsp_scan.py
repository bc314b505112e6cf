"""K9: the Faust stages' recurrences and noise, CUDA kernels + plain versions.

Counterpart of zorak_tpu/models/dspkit.py's `onepole` (:52), `integrator`
(:66), `max_follower` (:78), `biquad_tf2` (:138), each a
lax.associative_scan, and `lcg_noise` (:244), Faust's int32 LCG.

- `affine_scan` (K9a): z[t] = a[t]*z[t-1] + b[t] along the last axis, b =
  (1 - a)*x (`onepole`) or x (`integrator`);
- `maxplus_scan` (K9b): z[t] = max(a*z[t-1], x[t]) (`max_follower`);
- `biquad_scan` (K9c): the transposed direct-form II biquad (`biquad_tf2`);
- `lcg_noise` (K9d): the LCG's stream in (-1, 1).

On CUDA tensors each launches its kernel of `csrc/dsp_scan.cu` (a chunked
scan of 128-sample chunks whose order is fixed by the position in the row,
so a row's result is the same whatever rows share the launch; the noise
exact); on CPU tensors each runs its plain version (`*_plain`: the
Hillis-Steele doubling ladders the port ran before the kernels, moved here
unchanged).  The scans' two orders differ by rounding (`TOL_REL`), the
noise not at all.  Nothing falls back from one to the other.  The `*_host`
functions run the kernels' arithmetic compiled for the CPU (the source's
host form), for tests; no render path calls them.
"""
from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Sequence, Tuple

import torch

from . import _build

# Kernel launches of each wrapper since its counter was last set;
# chip_smoke.py zeroes them before a path and reads them after to show the
# path went through the kernels.
AFFINE_LAUNCHES = 0
MAXPLUS_LAUNCHES = 0
BIQUAD_LAUNCHES = 0
LCG_LAUNCHES = 0

CHUNK = 128            # csrc: kChunk, samples of a chunk
TILE_MAPS = 8 * 1024   # csrc: kTileMaps, the chunks of one carry tile
MAX_ROWS = 65535       # the walks' grid y

# The stated tolerance of a scan kernel against its plain version (and of
# either against the JAX scans): relative to the largest finite |y|.
TOL_REL = 1e-9

F64 = torch.float64
_ONEPOLE, _INTEGRATOR, _MAXPLUS, _BIQUAD = range(4)

_LCG_A = 1103515245
_LCG_C = 12345
_MASK32 = 0xFFFFFFFF


class _ScanArgs(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("x_rs", ctypes.c_longlong),
                ("a", ctypes.c_void_p), ("a_rs", ctypes.c_longlong),
                ("a_ts", ctypes.c_longlong), ("a_value", ctypes.c_double),
                ("z0", ctypes.c_void_p), ("z0_rs", ctypes.c_longlong),
                ("z0_value", ctypes.c_double),
                ("b0", ctypes.c_double), ("v0", ctypes.c_double),
                ("v1", ctypes.c_double), ("na1", ctypes.c_double),
                ("na2", ctypes.c_double), ("s0", ctypes.c_double),
                ("s1", ctypes.c_double),
                ("y", ctypes.c_void_p), ("ws", ctypes.c_void_p),
                ("ws_n", ctypes.c_longlong),
                ("rows", ctypes.c_longlong), ("length", ctypes.c_longlong),
                ("kind", ctypes.c_longlong)]


class _LcgArgs(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("seed", ctypes.c_longlong)]


_ENTRIES = ("zorak_dsp_scan", "zorak_lcg_noise")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("dsp_scan")
    for name in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _host_library() -> ctypes.CDLL:
    lib = _build.load_host("dsp_scan")
    for name in _ENTRIES:
        fn = getattr(lib, f"{name}_host")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# -- the plain versions -------------------------------------------------------

def _coef(c, like: torch.Tensor) -> torch.Tensor:
    """A per-sample coefficient tensor shaped like `like` (a fresh copy)."""
    c = torch.as_tensor(c, dtype=like.dtype, device=like.device)
    return c.broadcast_to(like.shape).clone()


def _affine_ladder(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the maps z -> a[t]*z + b[t] along the last axis.

    Returns (A, B) with A[t] = a[0]*...*a[t] and B[t] the recurrence's
    value at t from a zero start.  Hillis-Steele doubling: at stride d every
    t >= d folds in the composite ending at t-d.  Consumes a and b.
    """
    n, d = a.shape[-1], 1
    while d < n:
        b[..., d:] = a[..., d:] * b[..., :-d] + b[..., d:]
        a[..., d:] = a[..., :-d] * a[..., d:]
        d *= 2
    return a, b


def affine_scan_plain(x, pole, z0=0.0, *, onepole: bool):
    """Plain version of `affine_scan`: the doubling ladder."""
    if onepole:
        a = _coef(pole, x)
        A, B = _affine_ladder(a, (1.0 - a) * x)
        return A * z0 + B
    A, B = _affine_ladder(_coef(pole, x), x.clone())
    return A * z0 + B


def maxplus_scan_plain(x, rel_pole, z0=0.0):
    """Plain version of `maxplus_scan`: the max-plus doubling ladder."""
    a, b = _coef(rel_pole, x), x.clone()
    n, d = x.shape[-1], 1
    while d < n:
        b[..., d:] = torch.maximum(b[..., :-d] * a[..., d:], b[..., d:])
        a[..., d:] = a[..., :-d] * a[..., d:]
        d *= 2
    return torch.maximum(a * z0, b)


def biquad_scan_plain(x, b0, b1, b2, a1, a2, s0=(0.0, 0.0)):
    """Plain version of `biquad_scan`: the matrix doubling ladder.

    The state recurrence s' = M s + v*x[t] with constant M = [[-a1, 1],
    [-a2, 0]] scans as (2x2 matrix, 2-vector) pairs, kept as six [..., T]
    component tensors; y comes from the state before each sample.
    """
    # M's entries (p q / r s) and the input vector (u, w) at every t
    p, q = _coef(-a1, x), _coef(1.0, x)
    r, s = _coef(-a2, x), _coef(0.0, x)
    u, w = (b1 - a1 * b0) * x, (b2 - a2 * b0) * x
    n, d = x.shape[-1], 1
    while d < n:
        # later (at t) composed after earlier (at t-d): M2 @ M1, M2 @ v1 + v2
        p1, q1, r1, s1 = p[..., :-d], q[..., :-d], r[..., :-d], s[..., :-d]
        p2, q2, r2, s2 = p[..., d:], q[..., d:], r[..., d:], s[..., d:]
        u1, w1 = u[..., :-d], w[..., :-d]
        nu = p2 * u1 + q2 * w1 + u[..., d:]
        nw = r2 * u1 + s2 * w1 + w[..., d:]
        np_, nq = p2 * p1 + q2 * r1, p2 * q1 + q2 * s1
        nr, ns = r2 * p1 + s2 * r1, r2 * q1 + s2 * s1
        u[..., d:], w[..., d:] = nu, nw
        p[..., d:], q[..., d:], r[..., d:], s[..., d:] = np_, nq, nr, ns
        d *= 2
    s_init0, s_init1 = float(s0[0]), float(s0[1])
    s1_after = p * s_init0 + q * s_init1 + u      # state s1 AFTER sample t
    s1_prev = torch.cat([torch.full_like(x[..., :1], s_init0),
                         s1_after[..., :-1]], dim=-1)
    return b0 * x + s1_prev


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """a*b mod 2^32 for int64 values in [0, 2^32), with no int64 overflow:
    a splits into 16-bit halves so no partial product reaches 2^49."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _MASK32


def lcg_noise_plain(n: int, seed: int = 12345, dtype=F64,
                    device="cpu") -> torch.Tensor:
    """Plain version of `lcg_noise`: an inclusive doubling scan composes
    the affine LCG step s -> A*s + C (mod 2^32) into the map of k+1 steps
    for every k, in int64 masked to 32 bits, and applies it to the seed."""
    dev = torch.device(device)
    a = torch.full((n,), _LCG_A, dtype=torch.int64, device=dev)
    c = torch.full((n,), _LCG_C, dtype=torch.int64, device=dev)
    d = 1
    while d < n:
        # later map (a2, c2) after earlier (a1, c1): s -> a2*a1*s + a2*c1 + c2
        c[d:] = (_mulmod32(a[d:], c[:-d]) + c[d:]) & _MASK32
        a[d:] = _mulmod32(a[d:], a[:-d])
        d *= 2
    s = (_mulmod32(a, seed & _MASK32) + c) & _MASK32
    s = torch.where(s < (1 << 31), s, s - (1 << 32))
    return s.to(F64).div_(float(1 << 31)).to(dtype)


# -- the wrappers -------------------------------------------------------------

def _device(x, *others) -> torch.device:
    """x's device, after checking that x is float64 and that every tensor
    of `others` is a float64 on the same device."""
    if not isinstance(x, torch.Tensor) or x.dtype != F64 or x.dim() < 1:
        raise ValueError("x must be a float64 tensor [..., T]")
    for v in others:
        if isinstance(v, torch.Tensor):
            if v.device != x.device:
                raise ValueError(f"the tensors must share one device, not "
                                 f"{x.device} and {v.device}")
            if v.dtype != F64:
                raise ValueError(f"a coefficient tensor must be float64, "
                                 f"not {v.dtype}")
        elif not isinstance(v, numbers.Real):
            raise ValueError(f"a coefficient must be a real number or a "
                             f"float64 tensor, not {type(v).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the K9 kernels run on cuda or cpu, not "
                         f"{x.device}")
    return x.device


def _rows(x: torch.Tensor):
    length = x.shape[-1]
    rows = x.numel() // length if length else 0
    if rows > MAX_ROWS:
        raise ValueError(f"a K9 scan takes at most {MAX_ROWS} rows, not "
                         f"{rows}")
    return rows, length


def _broadcast(v: torch.Tensor, shape, what: str) -> torch.Tensor:
    try:
        return v.broadcast_to(shape)
    except RuntimeError:
        raise ValueError(f"{what} of shape {tuple(v.shape)} does not "
                         f"broadcast to {tuple(shape)}") from None


def _check_shapes(x, pole, z0) -> None:
    """The plain versions take the same shapes as the kernels: the pole
    broadcasting to x, z0 to x's rows."""
    if isinstance(pole, torch.Tensor):
        _broadcast(pole, x.shape, "the pole")
    if isinstance(z0, torch.Tensor):
        _broadcast(z0, x.shape[:-1] + (1,), "z0")


def _scan_call(kind: int, x: torch.Tensor, pole=0.0, z0=0.0,
               coeffs: Sequence[float] = (0.0,) * 7):
    """The argument struct of one K9a-c call, its output and the tensors
    it points into."""
    rows, length = _rows(x)
    keep: list = []
    a = _ScanArgs()
    xr = x.reshape(rows, length)
    if xr.stride(-1) != 1:
        xr = xr.contiguous()
    keep.append(xr)
    a.x, a.x_rs = xr.data_ptr(), xr.stride(0)
    if isinstance(pole, torch.Tensor):
        p = _broadcast(pole, x.shape, "the pole").reshape(rows, length)
        keep.append(p)
        a.a, a.a_rs, a.a_ts = p.data_ptr(), p.stride(0), p.stride(1)
    else:
        a.a_value = float(pole)
    if isinstance(z0, torch.Tensor):
        z = _broadcast(z0, x.shape[:-1] + (1,), "z0").reshape(rows)
        keep.append(z)
        a.z0, a.z0_rs = z.data_ptr(), z.stride(0)
    else:
        a.z0_value = float(z0)
    a.b0, a.v0, a.v1, a.na1, a.na2, a.s0, a.s1 = coeffs
    y = torch.empty((rows, length), dtype=F64, device=x.device)
    # each row's maps and start states take whole carry tiles of slots
    slots = -(-length // (CHUNK * TILE_MAPS)) * TILE_MAPS
    ws = torch.empty(4 * rows * slots, dtype=F64, device=x.device)
    keep.append(ws)
    a.y, a.ws, a.ws_n = y.data_ptr(), ws.data_ptr(), ws.numel()
    a.rows, a.length, a.kind = rows, length, kind
    return a, y.view(x.shape), keep


def _biquad_coeffs(b0, b1, b2, a1, a2, s0) -> Tuple[float, ...]:
    """(b0, v0, v1, -a1, -a2, s0[0], s0[1]): v = (b1 - a1*b0, b2 - a2*b0),
    each rounded as the plain version rounds it."""
    b0, b1, b2, a1, a2 = (float(c) for c in (b0, b1, b2, a1, a2))
    return (b0, b1 - a1 * b0, b2 - a2 * b0, -a1, -a2, float(s0[0]),
            float(s0[1]))


def _launch(entry: str, args: ctypes.Structure, dev: torch.device) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_library(), entry)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")


def affine_scan(x: torch.Tensor, pole, z0=0.0, *,
                onepole: bool) -> torch.Tensor:
    """K9a: z[t] = a[t]*z[t-1] + b[t] along the last axis of x [..., T]
    (float64), z[-1] = z0, with b = (1 - a)*x where `onepole` (Faust's
    si.smooth), else b = x (a leaky integrator).

    `pole` a number, or a float64 tensor broadcasting to x (one a sample);
    `z0` a number, or a float64 tensor broadcasting to [..., 1].  CUDA
    tensors go to the kernel, CPU tensors to `affine_scan_plain`."""
    global AFFINE_LAUNCHES
    dev = _device(x, pole, z0)
    _check_shapes(x, pole, z0)
    if dev.type == "cpu":
        return affine_scan_plain(x, pole, z0, onepole=onepole)
    args, y, keep = _scan_call(_ONEPOLE if onepole else _INTEGRATOR, x,
                               pole, z0)
    if y.numel():
        _launch("zorak_dsp_scan", args, dev)
        AFFINE_LAUNCHES += 1
    return y


def maxplus_scan(x: torch.Tensor, rel_pole, z0=0.0) -> torch.Tensor:
    """K9b: z[t] = max(a*z[t-1], x[t]) along the last axis (a max-hold
    follower), max as torch.maximum; arguments as `affine_scan`'s.  CUDA
    tensors go to the kernel, CPU tensors to `maxplus_scan_plain`."""
    global MAXPLUS_LAUNCHES
    dev = _device(x, rel_pole, z0)
    _check_shapes(x, rel_pole, z0)
    if dev.type == "cpu":
        return maxplus_scan_plain(x, rel_pole, z0)
    args, y, keep = _scan_call(_MAXPLUS, x, rel_pole, z0)
    if y.numel():
        _launch("zorak_dsp_scan", args, dev)
        MAXPLUS_LAUNCHES += 1
    return y


def biquad_scan(x: torch.Tensor, b0, b1, b2, a1, a2,
                s0=(0.0, 0.0)) -> torch.Tensor:
    """K9c: the transposed direct-form II biquad along the last axis of x
    [..., T] (float64): y = b0*x + s1, s1' = b1*x - a1*y + s2, s2' = b2*x
    - a2*y, from the state s0, every row alike.  The coefficients are
    numbers.  CUDA tensors go to the kernel, CPU tensors to
    `biquad_scan_plain`."""
    global BIQUAD_LAUNCHES
    dev = _device(x, b0, b1, b2, a1, a2)
    if dev.type == "cpu":
        return biquad_scan_plain(x, b0, b1, b2, a1, a2, s0)
    args, y, keep = _scan_call(_BIQUAD, x,
                               coeffs=_biquad_coeffs(b0, b1, b2, a1, a2, s0))
    if y.numel():
        _launch("zorak_dsp_scan", args, dev)
        BIQUAD_LAUNCHES += 1
    return y


def _lcg_call(n: int, seed: int, dev: torch.device):
    if isinstance(n, bool) or not isinstance(n, int) or n < 0:
        raise ValueError(f"n must be an int >= 0, not {n!r}")
    out = torch.empty(n, dtype=F64, device=dev)
    a = _LcgArgs(out.data_ptr(), n, int(seed) & _MASK32)
    return a, out


def lcg_noise(n: int, seed: int = 12345, dtype=F64,
              device="cpu") -> torch.Tensor:
    """K9d: Faust-style noise in (-1, 1), x_k = lcg^(k+1)(seed) as int32
    over 2^31, [n] float64 converted to `dtype`.  On a CUDA device the
    kernel, on the CPU `lcg_noise_plain`; the same stream as zorak_tpu's
    host loop bit for bit either way."""
    global LCG_LAUNCHES
    dev = torch.device(device)
    if dev.type == "cpu":
        return lcg_noise_plain(n, seed, dtype, dev)
    if dev.type != "cuda":
        raise ValueError(f"lcg_noise runs on cuda or cpu, not {dev}")
    args, out = _lcg_call(n, seed, dev)
    if n:
        _launch("zorak_lcg_noise", args, dev)
        LCG_LAUNCHES += 1
    return out.to(dtype)


# -- the host form, for tests --------------------------------------------------

def _host_scan(kind, x, pole=0.0, z0=0.0, coeffs=(0.0,) * 7):
    _device(x, pole, z0)
    if x.device.type != "cpu":
        raise ValueError("the host form takes CPU tensors")
    args, y, keep = _scan_call(kind, x, pole, z0, coeffs)
    if _host_library().zorak_dsp_scan_host(ctypes.byref(args)) != 0:
        raise RuntimeError("the host form refused its arguments")
    return y


def affine_scan_host(x, pole, z0=0.0, *, onepole: bool):
    """`affine_scan` through the kernel's arithmetic compiled for the CPU."""
    return _host_scan(_ONEPOLE if onepole else _INTEGRATOR, x, pole, z0)


def maxplus_scan_host(x, rel_pole, z0=0.0):
    """`maxplus_scan` through the kernel's arithmetic compiled for the CPU."""
    return _host_scan(_MAXPLUS, x, rel_pole, z0)


def biquad_scan_host(x, b0, b1, b2, a1, a2, s0=(0.0, 0.0)):
    """`biquad_scan` through the kernel's arithmetic compiled for the CPU."""
    return _host_scan(_BIQUAD, x,
                      coeffs=_biquad_coeffs(b0, b1, b2, a1, a2, s0))


def lcg_noise_host(n: int, seed: int = 12345) -> torch.Tensor:
    """`lcg_noise` through the kernel's arithmetic compiled for the CPU
    (float64)."""
    args, out = _lcg_call(n, seed, torch.device("cpu"))
    _host_library().zorak_lcg_noise_host(ctypes.byref(args))
    return out
