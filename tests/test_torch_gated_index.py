"""K6 and K3b on the CPU: the gated regime's index program and the dynamic
ring read (`zorak_tpu_torch/kernels/gated_index.py`).

Each plain version is held bit for bit (every NaN one value) to a NumPy
loop written here from the reference's formulas
(zorak_tpu/lowering/specialize.py: `gcursor_idx`, `gated_rand_vals`, the
gated ring write-back, `cursor_idx`, `dyn_ring_read`), on edge values:
gates NaN, +-0, subnormal, negative and infinite; anchors negative, NaN,
fractional and at +-2^63; moduli that are powers of two and that are not;
positions before and after the advance; the draw pool's clamp at both
ends; shared and per-file rings; 1 and 3 files; 1 to 1,500 samples; a
dynamic read of a region the segment does not write, with no earlier
writer in the sample, and with one.  The kernels' bodies compiled for the
CPU (the source's host form, g++ -O2 -ffp-contract=off) are held bit for
bit to the plain versions; those cases skip where no host compiler is
found.  The CUDA kernels themselves run only on the card, where
chip_smoke.py holds them to the plain versions.

`gated_fdn_tank(8, 8192)` and `modulated_delay_chorus(3, 4096)` rendered
on the CPU call each wrapper as often a segment as chip_smoke.py requires
of the card's launches, and their renders equal the JAX package's (within
1e-9 or one f32 ulp, carries within 1e-8) and the native golden (the null
contract: audio 1e-5, vars and heap 1e-8).
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zorak_tpu.ir import compile_plugin_source as jax_compile
from zorak_tpu.lowering import specialize_sample_kernel as jax_specialize
from zorak_tpu.verify import make_initialized_shadow as jax_shadow

from zorak_tpu_torch import builtin_plugins
from zorak_tpu_torch.ir import compile_plugin_source
from zorak_tpu_torch.kernels import _build, segment_graph
from zorak_tpu_torch.kernels import gated_index as GI
from zorak_tpu_torch.kernels.gated_index import CursorReader
from zorak_tpu_torch.lowering import specialize_sample_kernel
from zorak_tpu_torch.verify import make_initialized_shadow, null_test_plugin

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the launch counts the card is held to)

JAX_EPS = 1e-9      # the port's f32 audio against the JAX render's
CARRY_EPS = 1e-8    # carried scalars and rings against JAX's

GATES = [0.0, -0.0, 1.0, -2.5, float("nan"), 5e-324, -5e-324, float("inf")]
ANCHORS = [0.0, -7.9, 12345.5, float("nan"), 2.0 ** 63, -2.0 ** 63, 1e300,
           -3.0]
USED = [-5.0, 0.0, float("nan"), 40.9, 2.0 ** 63, -2.0 ** 63, 1e18, 7.0]
LENGTHS = [1, 7, 1024, 1500]


@pytest.fixture(autouse=True)
def cold_trace_cache(tmp_path, monkeypatch):
    # no JAX kernel built here may warm the home trace cache
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(tmp_path))


# -- the reference's formulas, in NumPy ----------------------------------------

def to_i64(v: float) -> int:
    """The reference's float-to-int64 convert: trunc, NaN 0, saturated."""
    if v != v:
        return 0
    if v >= 2.0 ** 63:
        return 2 ** 63 - 1
    if v <= -2.0 ** 63:
        return -2 ** 63
    return int(v)


def wrap(v: int) -> int:
    """An int64 sum as the device keeps it."""
    return (v + 2 ** 63) % 2 ** 64 - 2 ** 63


def ring_pos(pos: int, mod: int) -> int:
    return pos & (mod - 1) if mod & (mod - 1) == 0 else pos % mod


def fremainder(a: float, b: float) -> float:
    m = math.fmod(a, b)
    if m != 0 and ((b < 0) != (m < 0)):
        m += b
    return m


def truthy(v: float) -> bool:
    return v < 0 or v > 0


def same(got, want) -> bool:
    """Equal values of one shape and dtype (every NaN one value, the sign of
    zero kept)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype != np.float64:
        return bool(np.array_equal(got, want))
    nan = np.isnan(got)
    return bool(np.array_equal(nan, np.isnan(want))
                and np.array_equal(got[~nan], want[~nan])
                and np.array_equal(np.signbit(got[~nan]),
                                   np.signbit(want[~nan])))


def gate_rows(rng, nf, L, shared=False):
    g = rng.choice(GATES, size=(1 if shared else nf, L))
    return torch.from_numpy(g[0] if shared else g)


def anchor_of(kind, values, nf):
    """A host float, or the device's [nf, 1] (the values cycled)."""
    if kind == "host":
        return values[0]
    return torch.tensor([[values[f % len(values)]] for f in range(nf)],
                        dtype=torch.float64)


def anchor_values(anchor, nf):
    if isinstance(anchor, torch.Tensor):
        return [float(v) for v in anchor.reshape(-1).expand(nf)]
    return [float(anchor)] * nf


def readers_for(rng, nf):
    ring_f = torch.from_numpy(rng.randn(nf, 12))
    ring_f[0, 3] = float("nan")
    ring_s = torch.from_numpy(rng.randn(16))
    ring_s[5] = -0.0
    return [CursorReader("position", 3, 16, False, 4096.0),
            CursorReader("position", -5, 12, True),
            CursorReader("position", 0, 8192, True),
            CursorReader("value", -3, 12, False, None, ring_f),
            CursorReader("value", 2, 16, True, None, ring_s),
            CursorReader("index", 7, 7, False),
            CursorReader("index", -1, 1, True)]


def cursor_loop(gate, anchor, readers, nf, L, carry_mod):
    g = np.broadcast_to(gate.numpy(), (nf, L))
    a = anchor_values(anchor, nf)
    outs = [np.empty((nf, L), np.int64 if r.kind == "index" else np.float64)
            for r in readers]
    carry = np.empty((nf, 1))
    for f in range(nf):
        ai, n = to_i64(a[f]), 0
        for t in range(L):
            m = int(truthy(g[f, t]))
            n += m
            for r, out in zip(readers, outs):
                idx = ring_pos(wrap(wrap(ai + (n if r.incl else n - m))
                                    + r.offset), r.mod)
                if r.kind == "value":
                    ring = r.ring.numpy()
                    out[f, t] = ring[idx] if ring.ndim == 1 else ring[f, idx]
                elif r.kind == "position":
                    out[f, t] = float(idx) + (0.0 if r.origin is None
                                              else r.origin)
                else:
                    out[f, t] = idx
        carry[f, 0] = fremainder(a[f] + float(n), float(carry_mod))
    return outs, carry


def draws_loop(gates, used, pool, nf, L):
    pool = pool.numpy()
    gs = [None if g is None else np.broadcast_to(g.numpy(), (nf, L))
          for g in gates]
    u = anchor_values(used, nf)
    vals = np.empty((nf, L, len(gates)))
    nxt = np.empty((nf, 1))
    for f in range(nf):
        ui, before = to_i64(u[f]), 0
        for t in range(L):
            within = 0
            for s, g in enumerate(gs):
                idx = wrap(wrap(ui + before) + within)
                vals[f, t, s] = pool[min(max(idx, 0), pool.size - 1)]
                within += 1 if g is None else int(truthy(g[f, t]))
            before += within
        nxt[f, 0] = u[f] + float(before)
    return vals, nxt


def write_loop(gate, anchor, writes, nf, L):
    g = np.broadcast_to(gate.numpy(), (nf, L))
    a = anchor_values(anchor, nf)
    outs = []
    for ring, value, offset, mod in writes:
        out = ring.numpy().copy()
        v = np.broadcast_to(value.numpy(), (nf, L))
        for f in range(nf):
            ai, cnt = to_i64(a[f]), 0
            for t in range(L):
                if truthy(g[f, t]):
                    out[f, ring_pos(wrap(wrap(ai + cnt) + offset), mod)] = \
                        v[f, t]
                    cnt += 1
        outs.append(out)
    return outs


def read_loop(src, slot, nf, L, cursor=None, offset=0, preceded=False,
              same_s=None):
    s = src.numpy()
    shared = cursor is None and s.ndim == 1 and slot.dim() < 2
    rows = 1 if shared else nf
    sl = np.broadcast_to(slot.numpy(), (rows, L))
    out = np.empty((rows, L))
    if cursor is None:
        for f in range(rows):
            for t in range(L):
                row = s if s.ndim == 1 else s[f]
                out[f, t] = row[to_i64(sl[f, t])]
        return out[0] if shared else out
    mod = s.shape[-1] - L
    c = anchor_values(cursor, nf)
    sm = None if same_s is None else np.broadcast_to(same_s.numpy(), (nf, L))
    for f in range(nf):
        w0c = to_i64(c[f]) + offset
        for t in range(L):
            sigma = to_i64(sl[f, t])
            if not preceded:
                dtil = (w0c + t - sigma - 1) % mod + 1
                out[f, t] = s[f, mod + t - dtil]
            else:
                dtil = (w0c + t - sigma) % mod
                out[f, t] = (sm[f, t] if sm is not None and dtil == 0
                             else s[f, mod + t - dtil])
    return out


# -- the plain versions against the loops ------------------------------------

@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("nf", [1, 3])
def test_gated_cursor_plain_is_the_reference(nf, L, kind):
    rng = np.random.RandomState(nf * 10007 + L)
    for i in range(len(ANCHORS)):
        anchor = anchor_of(kind, ANCHORS[i:] + ANCHORS[:i], nf)
        gate = gate_rows(rng, nf, L, shared=i % 2 == 1)
        readers = readers_for(rng, nf)
        got, carry = GI.gated_cursor_plain(gate, anchor, readers, nf, L, 12)
        want, wcarry = cursor_loop(gate, anchor, readers, nf, L, 12)
        for r, a, b in zip(readers, got, want):
            assert same(a, b), (r.kind, r.offset, r.mod, r.incl, anchor)
        assert same(carry, wcarry), anchor


@pytest.mark.parametrize("start,mod,n", [(0, 8, 1), (5, 7, 20), (9, 8, 1024),
                                         (4095, 4096, 1500), (0, 1, 3),
                                         (1530, 1531, 1500)])
def test_ring_cursor_plain_is_the_reference(start, mod, n):
    want = np.array([ring_pos(start + t, mod) for t in range(n)], np.int64)
    assert same(GI.ring_cursor_plain(start, mod, n, "cpu"), want)


@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("nf", [1, 3])
def test_gated_draws_plain_is_the_reference(nf, L, kind):
    # the pool of 50 draws: `used` far below it, NaN, near and past its
    # end and saturated clamp the index at both ends
    rng = np.random.RandomState(nf * 7919 + L)
    pool = torch.from_numpy(rng.randn(50))
    pool[0], pool[49] = float("nan"), -0.0
    for i in range(len(USED)):
        used = anchor_of(kind, USED[i:] + USED[:i], nf)
        gates = [None, gate_rows(rng, nf, L), gate_rows(rng, nf, L, True),
                 None, gate_rows(rng, nf, L)]
        vals, nxt = GI.gated_draws_plain(gates, used, pool, nf, L)
        wvals, wnxt = draws_loop(gates, used, pool, nf, L)
        assert same(vals, wvals) and same(nxt, wnxt), used


@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("nf", [1, 3])
def test_gated_ring_write_plain_is_the_reference(nf, L, kind):
    rng = np.random.RandomState(nf * 4001 + L)
    for i in range(0, len(ANCHORS), 2):
        anchor = anchor_of(kind, ANCHORS[i:] + ANCHORS[:i], nf)
        gate = gate_rows(rng, nf, L, shared=i % 4 == 2)
        value = torch.from_numpy(rng.randn(nf, L))
        value[0, 0] = float("nan")
        writes = [(torch.from_numpy(rng.randn(nf, 2048)), value, 3, 2048),
                  (torch.from_numpy(rng.randn(nf, 1531)), value[0], -2, 1531),
                  (torch.from_numpy(rng.randn(nf, 1500)), value, -1500, 1500)]
        rings = [w[0].clone() for w in writes]
        got = GI.gated_ring_write_plain(gate, anchor, writes, nf, L)
        want = write_loop(gate, anchor, writes, nf, L)
        for a, b in zip(got, want):
            assert same(a, b), anchor
        # the rings handed in stay as they were
        assert all(torch.equal(w[0], r) for w, r in zip(writes, rings))


READ_MODES = ["gather_shared", "gather_files", "gather_shared_ring",
              "no_earlier_writer", "earlier_writer_last",
              "earlier_writer_same"]


def read_case(rng, mode, nf, L, kind):
    """(src, slot, the keyword arguments) of one dynamic read."""
    if mode.startswith("gather"):
        m = 13
        slot = rng.randint(0, m, size=(nf, L)) + rng.rand(nf, L) * 0.999
        slot[0, 0] = float("nan")
        slot[-1, -1] = -0.7
        slot = torch.from_numpy(slot)
        if mode == "gather_shared":
            return torch.from_numpy(rng.randn(m)), slot[0], {}
        if mode == "gather_files":
            return torch.from_numpy(rng.randn(nf, m)), slot[0], {}
        return torch.from_numpy(rng.randn(m)), slot, {}
    mod = 16
    full = torch.from_numpy(rng.randn(nf, mod + L))
    full[0, 1] = float("nan")
    slot = torch.from_numpy(rng.randint(-20, 40, size=(nf, L))
                            + rng.rand(nf, L) * 0.999)
    slot[0, 0] = float("nan")
    cursor = anchor_of(kind, [5.0, -3.5, 1e6, float("nan")], nf)
    kw = {"cursor": cursor, "offset": -2 if kind == "host" else 7,
          "preceded": mode != "no_earlier_writer"}
    if mode == "earlier_writer_same":
        kw["same"] = torch.from_numpy(rng.randn(nf, L))
    return full, slot, kw


@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("L", [1, 7, 1500])
@pytest.mark.parametrize("mode", READ_MODES)
def test_dyn_ring_read_plain_is_the_reference(mode, L, kind):
    rng = np.random.RandomState(L * 31 + READ_MODES.index(mode))
    for nf in (1, 3):
        src, slot, kw = read_case(rng, mode, nf, L, kind)
        got = GI.dyn_ring_read_plain(src, slot, nf, L, **kw)
        want = read_loop(src, slot, nf, L, kw.get("cursor"),
                         kw.get("offset", 0), kw.get("preceded", False),
                         kw.get("same"))
        assert same(got, want), (mode, nf)


def counters():
    return (GI.CURSOR_LAUNCHES, GI.DRAWS_LAUNCHES, GI.WRITE_LAUNCHES,
            GI.READ_LAUNCHES)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.RandomState(5)
    before = counters()
    nf, L = 3, 64
    gate = gate_rows(rng, nf, L)
    readers = readers_for(rng, nf)
    got, carry = GI.gated_cursor(gate, 3.0, readers, nf, L, 12)
    want, wcarry = GI.gated_cursor_plain(gate, 3.0, readers, nf, L, 12)
    assert all(same(a, b.numpy()) for a, b in zip(got, want))
    assert same(carry, wcarry.numpy())
    pool = torch.from_numpy(rng.randn(30))
    vals, nxt = GI.gated_draws([None, gate], 2.0, pool, nf, L)
    assert same(vals, GI.gated_draws_plain([None, gate], 2.0, pool, nf,
                                           L)[0].numpy())
    assert same(GI.ring_cursor(3, 5, 9, "cpu"),
                GI.ring_cursor_plain(3, 5, 9, "cpu").numpy())
    with pytest.raises(ValueError, match="cuda or cpu"):
        GI.ring_cursor(3, 5, 9, "meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        GI.gated_cursor(gate.to("meta"), 3.0, [], nf, L)
    # the launch counters count the card's launches only
    assert counters() == before


def test_k5_replays_count_the_new_launches():
    # a capture records, and a replay adds, each wrapper's own counter
    names = segment_graph.COUNTED
    for counter in ("CURSOR_LAUNCHES", "DRAWS_LAUNCHES", "WRITE_LAUNCHES",
                    "READ_LAUNCHES"):
        assert f"gated_index.{counter}" in names
    before = segment_graph._counts()
    assert len(before) == len(names)
    deltas = tuple(range(1, len(names) + 1))
    segment_graph._add(deltas)
    try:
        after = segment_graph._counts()
        assert tuple(b - a for a, b in zip(before, after)) == deltas
        assert GI.READ_LAUNCHES == before[-1] + len(names)
    finally:
        segment_graph._add(tuple(-d for d in deltas))
    assert segment_graph._counts() == before


# -- the host form -------------------------------------------------------------

def host_compiler():
    try:
        return _build.find_host_compiler()
    except RuntimeError as e:
        pytest.skip(f"the host form needs a C++ compiler: {e}")


@pytest.mark.parametrize("L", [1, 1024, 1500])
@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("kernel", ["cursor", "draws", "write", "read"])
def test_host_form_is_the_plain_version(kernel, nf, L):
    host_compiler()
    rng = np.random.RandomState(nf * 13 + L)
    for i, kind in enumerate(("host", "device") * 4):
        anchor = anchor_of(kind, ANCHORS[i:] + ANCHORS[:i], nf)
        if kernel == "cursor":
            gate = gate_rows(rng, nf, L, shared=i % 3 == 0)
            readers = readers_for(rng, nf) * 3        # two launches of 16
            got, carry = GI.gated_cursor_host(gate, anchor, readers, nf, L,
                                              1531)
            want, wcarry = GI.gated_cursor_plain(gate, anchor, readers, nf,
                                                 L, 1531)
            assert all(same(a, b.numpy()) for a, b in zip(got, want))
            assert same(carry, wcarry.numpy())
            got, _c = GI.gated_cursor_host(
                None, 9 + i, [CursorReader("index", 0, 8 - i % 2, False)],
                1, L)
            assert same(got[0].view(L), GI.ring_cursor_plain(
                9 + i, 8 - i % 2, L, "cpu").numpy())
        elif kernel == "draws":
            pool = torch.from_numpy(rng.randn(40))
            used = anchor_of(kind, USED[i:] + USED[:i], nf)
            gates = [gate_rows(rng, nf, L), None,
                     gate_rows(rng, nf, L, shared=True)]
            vals, nxt = GI.gated_draws_host(gates, used, pool, nf, L)
            wvals, wnxt = GI.gated_draws_plain(gates, used, pool, nf, L)
            assert same(vals, wvals.numpy()) and same(nxt, wnxt.numpy())
        elif kernel == "write":
            gate = gate_rows(rng, nf, L)
            value = torch.from_numpy(rng.randn(nf, L))
            writes = [(torch.from_numpy(rng.randn(nf, 2048)), value, 1, 2048),
                      (torch.from_numpy(rng.randn(nf, 1531)), value[0], -9,
                       1531)] * 9                     # two launches of 16
            got = GI.gated_ring_write_host(gate, anchor, writes, nf, L)
            want = GI.gated_ring_write_plain(gate, anchor, writes, nf, L)
            assert all(same(a, b.numpy()) for a, b in zip(got, want))
        else:
            mode = READ_MODES[i % len(READ_MODES)]
            src, slot, kw = read_case(rng, mode, nf, L, kind)
            got = GI.dyn_ring_read_host(src, slot, nf, L, **kw)
            assert same(got, GI.dyn_ring_read_plain(src, slot, nf, L,
                                                    **kw).numpy()), mode


def test_host_form_refuses_what_the_kernels_do_not_take():
    host_compiler()
    gate = torch.ones(1, 64, dtype=torch.float64)
    ring = torch.zeros(1, 32, dtype=torch.float64)
    # a ring shorter than a tile of fired samples would share cells
    with pytest.raises(ValueError, match="at most 32 samples"):
        GI.gated_ring_write_host(gate, 0.0, [(ring, gate, 0, 32)], 1, 64)
    with pytest.raises(ValueError, match="rand sites"):
        GI.gated_draws_host([None] * (GI.MAX_SITES + 1), 0.0,
                            torch.zeros(4, dtype=torch.float64), 1, 64)
    with pytest.raises(ValueError, match="float64"):
        GI.gated_cursor_host(gate.float(), 0.0, [], 1, 64)


# -- the tank and the chorus ---------------------------------------------------

WRAPPERS = {"gated_cursor": ("gated_cursor", "ring_cursor"),
            "gated_draws": ("gated_draws",),
            "gated_ring_write": ("gated_ring_write",),
            "dyn_ring_read": ("dyn_ring_read",)}

# (source, the launches a segment chip_smoke.py holds the card to, input
# samples, segment length)
RENDERS = {
    "gated_fdn_tank": (builtin_plugins.gated_fdn_tank(chip_smoke.GATED_LINES,
                                                    chip_smoke.GATED_BUF),
                       chip_smoke.GATED_K6_PER_SEGMENT, 4096, 1 << 17),
    "modulated_delay_chorus": (
        builtin_plugins.modulated_delay_chorus(*chip_smoke.PLANNER_CHORUS),
        chip_smoke.PLANNER_K3B_PER_SEGMENT, 6144, 2048),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_renders_call_each_wrapper_as_the_card_is_held_to(name, monkeypatch):
    src, per_segment, n, seg = RENDERS[name]
    calls = dict.fromkeys(WRAPPERS, 0)
    for counter, fns in WRAPPERS.items():
        for fn_name in fns:
            real = getattr(GI, fn_name)

            def spy(*a, _real=real, _counter=counter, **k):
                calls[_counter] += 1
                return _real(*a, **k)
            monkeypatch.setattr(GI, fn_name, spy)
    prog = compile_plugin_source(src)
    kern = specialize_sample_kernel(prog, make_initialized_shadow(prog).state,
                                    2, segment_len=seg, device="cpu")
    x = (np.random.RandomState(21).randn(2, n) * 0.25).astype(np.float32)
    y, carry = kern.render(x)
    segments = -(-n // kern.L)
    assert segments >= 3
    assert calls == {k: v * segments for k, v in per_segment.items()}, calls
    if name == "gated_fdn_tank":
        specs, stream, carry_mod = kern._gate_readers(("var", "w"))
        # one gringidx spec for the eight nodes, eight gringrefs, the stream
        assert len(specs) == 10 and stream == 9 and carry_mod == 8192

    jprog = jax_compile(src)
    jkern = jax_specialize(jprog, jax_shadow(jprog).state, 2,
                           segment_len=seg)
    assert jkern.L == kern.L
    yj, (jsvec, jrings) = jkern.render(x)
    yj = np.asarray(yj, np.float32)
    d = np.abs(y.astype(np.float64) - yj.astype(np.float64))
    assert float(np.max(d - np.maximum(JAX_EPS, np.spacing(np.abs(yj))))) \
        <= 0.0
    svec, rings = carry
    assert float(np.max(np.abs(svec.numpy() - np.asarray(jsvec)))) \
        <= CARRY_EPS
    assert sorted(rings) == sorted(jrings)
    for region, arr in rings.items():
        assert float(np.max(np.abs(arr.numpy() - np.asarray(
            jrings[region])))) <= CARRY_EPS
    rep = null_test_plugin(prog, x, golden="native", device="cpu",
                           compare_state=True, compare_mem=True,
                           segment_len=seg)
    assert rep.passed, rep.summary()
