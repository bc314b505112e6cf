"""K9 on the CPU: the Faust stages' recurrences and noise
(`zorak_tpu_torch/kernels/dsp_scan.py`, `csrc/dsp_scan.cu`).

The plain versions are the doubling ladders `models/dspkit.py` ran before
the kernels, moved unchanged: each is held bit for bit to a copy of the
earlier code kept here.  The kernels' arithmetic compiled for the CPU (the
source's host form, g++ -O2 -ffp-contract=off: the chunk walks, the carry
block's scan as a loop over its strides) is held to the JAX functions of
zorak_tpu/models/dspkit.py under jax.jit: within SCAN_TOL on unit-variance
input at T <= 3,000, within TOL_REL x max|y| at T = 4,097 and across more
than one carry tile; the noise bit for bit.  A row's result is the same
alone and among 8 rows, and NaN and inf fall where the plain version puts
them (where no product of poles underflows; the biquad, where the ladder
differs from the sequential loop, against that loop).  Where a product
of poles underflows, one test states run by run where the ladder, the
host form, the JAX stage and the Faust golden's recurrence put NaN and
inf.  The host form's
cases skip where no host compiler is found.  The CUDA kernels run only on
the card, where chip_smoke.py holds them to their host form and their
plain versions.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zorak_tpu.models import dspkit as J
from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import dsp_scan as DS
from zorak_tpu_torch.models import dspkit as P

SR = 48000.0
SCAN_TOL = 1e-12           # absolute, unit-variance input, T <= 3,000
TOL_REL = DS.TOL_REL       # relative to max|y|, longer rows
MULTI_TILE_T = DS.TILE_MAPS * DS.CHUNK + 3 * DS.CHUNK + 5   # two tiles

# (name, pole): the recurrences with one pole; the biquads VAR runs
POLES = [("onepole", 0.98), ("integrator", 0.95), ("max_follower", 0.97)]
BIQUADS = [("hp", 11500.0, 0.707), ("bp_skirt", 9500.0, 1.0),
           ("bp_skirt", 16000.0, 1.2)]
SHAPES = [(3000,), (2, 3, 3000), (8, 3000)]
LCG_SEEDS = [12345, 54321, 0, 2 ** 32 - 1]
# lengths across the noise kernel's edges: a block of 256 and the grid's
# stride of 1,056 blocks
LCG_LENGTHS = [1, 255, 256, 257, 4097, 1056 * 256 + 1]


@pytest.fixture
def host():
    try:
        _build.find_host_compiler()
    except RuntimeError as e:
        pytest.skip(f"the host form needs a C++ compiler: {e}")


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _coeffs(kind, fc, q):
    return P.rbj_coeffs(kind, fc, q, SR)


def _host(name, x, *args, **kw):
    if name == "onepole":
        return DS.affine_scan_host(x, *args, onepole=True, **kw)
    if name == "integrator":
        return DS.affine_scan_host(x, *args, onepole=False, **kw)
    if name == "max_follower":
        return DS.maxplus_scan_host(x, *args, **kw)
    return DS.biquad_scan_host(x, *args, **kw)


def _plain(name, x, *args, **kw):
    if name == "onepole":
        return DS.affine_scan_plain(x, *args, onepole=True, **kw)
    if name == "integrator":
        return DS.affine_scan_plain(x, *args, onepole=False, **kw)
    if name == "max_follower":
        return DS.maxplus_scan_plain(x, *args, **kw)
    return DS.biquad_scan_plain(x, *args, **kw)


def _input(name, shape, seed):
    x = _x(shape, seed)
    return np.abs(x) if name == "max_follower" else x


# ---------------------------------------------------------------------------
# the plain versions: the earlier ladders of models/dspkit.py, moved


def _earlier_coef(c, like):
    c = torch.as_tensor(c, dtype=like.dtype, device=like.device)
    return c.broadcast_to(like.shape).clone()


def _earlier_affine_scan(a, b):
    n, d = a.shape[-1], 1
    while d < n:
        b[..., d:] = a[..., d:] * b[..., :-d] + b[..., d:]
        a[..., d:] = a[..., :-d] * a[..., d:]
        d *= 2
    return a, b


def _earlier_onepole(x, pole, z0=0.0):
    a = _earlier_coef(pole, x)
    A, B = _earlier_affine_scan(a, (1.0 - a) * x)
    return A * z0 + B


def _earlier_integrator(x, pole, z0=0.0):
    A, B = _earlier_affine_scan(_earlier_coef(pole, x), x.clone())
    return A * z0 + B


def _earlier_max_follower(x, rel_pole, z0=0.0):
    a, b = _earlier_coef(rel_pole, x), x.clone()
    n, d = x.shape[-1], 1
    while d < n:
        b[..., d:] = torch.maximum(b[..., :-d] * a[..., d:], b[..., d:])
        a[..., d:] = a[..., :-d] * a[..., d:]
        d *= 2
    return torch.maximum(a * z0, b)


def _earlier_biquad_tf2(x, b0, b1, b2, a1, a2, s0=(0.0, 0.0)):
    p, q = _earlier_coef(-a1, x), _earlier_coef(1.0, x)
    r, s = _earlier_coef(-a2, x), _earlier_coef(0.0, x)
    u, w = (b1 - a1 * b0) * x, (b2 - a2 * b0) * x
    n, d = x.shape[-1], 1
    while d < n:
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
    s1_after = p * s_init0 + q * s_init1 + u
    s1_prev = torch.cat([torch.full_like(x[..., :1], s_init0),
                         s1_after[..., :-1]], dim=-1)
    return b0 * x + s1_prev


def _earlier_lcg_noise(n, seed=12345):
    mask = 0xFFFFFFFF

    def mulmod32(a, b):
        lo, hi = a & 0xFFFF, a >> 16
        return (lo * b + (((hi * b) & 0xFFFF) << 16)) & mask

    a = torch.full((n,), 1103515245, dtype=torch.int64)
    c = torch.full((n,), 12345, dtype=torch.int64)
    d = 1
    while d < n:
        c[d:] = (mulmod32(a[d:], c[:-d]) + c[d:]) & mask
        a[d:] = mulmod32(a[d:], a[:-d])
        d *= 2
    s = (mulmod32(a, seed & mask) + c) & mask
    s = torch.where(s < (1 << 31), s, s - (1 << 32))
    return s.to(torch.float64).div_(float(1 << 31))


_EARLIER = {"onepole": _earlier_onepole, "integrator": _earlier_integrator,
            "max_follower": _earlier_max_follower}


@pytest.mark.parametrize("pole_kind", ["scalar", "per-sample", "per-row"])
@pytest.mark.parametrize("name", [n for n, _ in POLES])
def test_plain_version_is_the_earlier_ladder(name, pole_kind):
    x = _t(_input(name, (2, 3, 1000), 1))
    pole = {"scalar": 0.97,
            "per-sample": _t(0.9 + 0.09 * np.abs(np.sin(np.arange(1000)
                                                         / 50.0))),
            "per-row": _t(np.array([[0.9], [0.95], [0.99]]))}[pole_kind]
    z0 = _t(np.abs(_x((2, 3, 1), 2)))
    want = _EARLIER[name](x, pole, z0)
    assert torch.equal(_plain(name, x, pole, z0), want)
    assert torch.equal(getattr(P, name)(x, pole, z0), want)


@pytest.mark.parametrize("kind,fc,q", BIQUADS)
def test_biquad_plain_version_is_the_earlier_ladder(kind, fc, q):
    x = _t(_x((2, 3, 1000), 3))
    c = _coeffs(kind, fc, q)
    want = _earlier_biquad_tf2(x, *c, s0=(0.1, -0.2))
    assert torch.equal(DS.biquad_scan_plain(x, *c, s0=(0.1, -0.2)), want)
    assert torch.equal(P.biquad_tf2(x, *c, s0=(0.1, -0.2)), want)


@pytest.mark.parametrize("seed", LCG_SEEDS)
def test_lcg_plain_version_is_the_earlier_ladder(seed):
    want = _earlier_lcg_noise(3000, seed)
    assert torch.equal(DS.lcg_noise_plain(3000, seed), want)
    assert torch.equal(P.lcg_noise(3000, seed, device="cpu"), want)
    assert torch.equal(P.lcg_noise(3000, seed, dtype=torch.float32,
                                   device="cpu"), want.float())


# ---------------------------------------------------------------------------
# the host form against the JAX functions


def _jax(name, x, *args):
    fn = getattr(J, name)
    return np.asarray(jax.jit(lambda a: fn(a, *args))(jnp.asarray(x)))


@pytest.mark.parametrize("shape", SHAPES, ids=["T3000", "2x3xT3000",
                                               "8xT3000"])
@pytest.mark.parametrize("name,pole", POLES, ids=[n for n, _ in POLES])
def test_host_form_matches_jax(host, name, pole, shape):
    x = _input(name, shape, 10)
    z0 = np.abs(_x(shape[:-1] + (1,), 11))
    want = _jax(name, x, pole, jnp.asarray(z0))
    got = _host(name, _t(x), pole, _t(z0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCAN_TOL)


def test_host_form_per_sample_pole_matches_jax(host):
    x = _x((3000,), 12)
    pole = 0.9 + 0.09 * np.abs(np.sin(np.arange(3000) / 50.0))
    want = np.asarray(jax.jit(J.onepole)(jnp.asarray(x), jnp.asarray(pole)))
    got = DS.affine_scan_host(_t(x), _t(pole), onepole=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCAN_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=["T3000", "2x3xT3000",
                                               "8xT3000"])
@pytest.mark.parametrize("kind,fc,q", BIQUADS)
def test_host_form_biquad_matches_jax(host, kind, fc, q, shape):
    x = _x(shape, 16)
    c = _coeffs(kind, fc, q)
    want = np.asarray(jax.jit(lambda a: J.biquad_tf2(a, *c, s0=(0.1, -0.2)))(
        jnp.asarray(x)))
    got = DS.biquad_scan_host(_t(x), *c, s0=(0.1, -0.2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCAN_TOL)


def _within(got, want):
    err = np.abs(got - want).max()
    assert err <= TOL_REL * np.abs(want).max(), err


@pytest.mark.parametrize("n_t", [4097, MULTI_TILE_T],
                         ids=["T4097", "two-tiles"])
@pytest.mark.parametrize("name", [n for n, _ in POLES] + ["biquad_tf2"])
def test_host_form_long_rows_match_jax(host, name, n_t):
    shape = (8, n_t) if n_t == 4097 else (n_t,)
    x = _input(name, shape, 20)
    if name == "biquad_tf2":
        c = _coeffs("hp", 11500.0, 0.707)
        want = _jax(name, x, *c)
        got = DS.biquad_scan_host(_t(x), *c)
    else:
        pole = dict(POLES)[name]
        want = _jax(name, x, pole, 0.25)
        got = _host(name, _t(x), pole, 0.25)
    _within(got.numpy(), want)


@pytest.mark.parametrize("seed", LCG_SEEDS)
def test_host_form_lcg_is_the_jax_stream(host, seed):
    for n in LCG_LENGTHS:
        want = np.asarray(J.lcg_noise(n, seed=seed))
        assert np.array_equal(DS.lcg_noise_host(n, seed).numpy(), want), n


@pytest.mark.parametrize("name", [n for n, _ in POLES] + ["biquad_tf2"])
def test_host_form_row_alone_equals_row_among_eight(host, name):
    x = _t(_input(name, (8, 2 * DS.CHUNK * 64 + 77), 21))
    args = (_coeffs("bp_skirt", 9500.0, 1.0) if name == "biquad_tf2"
            else (dict(POLES)[name], _t(np.abs(_x((8, 1), 22)))))
    many = _host(name, x, *args)
    for r in (0, 5, 7):
        one = (args if name == "biquad_tf2"
               else (args[0], args[1][r:r + 1]))
        assert torch.equal(_host(name, x[r:r + 1], *one), many[r:r + 1])


# ---------------------------------------------------------------------------
# NaN and inf


def _same_places(got, want):
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want)), test.__name__
    fin = torch.isfinite(want)
    assert (got[fin] - want[fin]).abs().max() <= \
        TOL_REL * want[fin].abs().max()


def _with(x, kind):
    x = x.copy()
    if kind == "nan":
        x[0, 1500] = np.nan
        x[2, 5] = np.nan
    else:
        x[0, 1500] = np.inf
        x[1, 7] = np.inf if kind == "inf" else -np.inf
    return x


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf"])
@pytest.mark.parametrize("name,pole", POLES, ids=[n for n, _ in POLES])
def test_nan_and_inf_land_as_in_the_plain_version(host, name, pole, kind):
    # poles >= 0.95 at T = 4,097: no product of poles underflows, so the
    # ladder's inf stays inf; where one does (0 * inf), both orders give
    # NaN but at places that differ
    x = _with(_input(name, (3, 4097), 30), kind)
    if name == "max_follower" and kind == "-inf":
        x[1, 7] = np.inf
    z0 = _t(np.abs(_x((3, 1), 31)))
    _same_places(_host(name, _t(x), pole, z0), _plain(name, _t(x), pole, z0))


def _biquad_loop(x, b0, b1, b2, a1, a2):
    """The sequential transposed direct-form II loop, rows side by side."""
    s1, s2 = np.zeros(x.shape[0]), np.zeros(x.shape[0])
    y = np.empty_like(x)
    with np.errstate(all="ignore"):
        for t in range(x.shape[1]):
            xt = x[:, t]
            y[:, t] = b0 * xt + s1
            s1, s2 = ((-a1 * s1 + s2) + (b1 - a1 * b0) * xt,
                      -a2 * s1 + (b2 - a2 * b0) * xt)
    return y


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf"])
@pytest.mark.parametrize("kind_fc_q", BIQUADS[:2])
def test_biquad_nan_and_inf_land_as_in_the_sequential_loop(host, kind_fc_q,
                                                           kind):
    # NaN lands as in the ladder; inf, where the ladder's order gives inf
    # in a few samples after it that the sequential loop (and a chunk's
    # walk) gives NaN, as in the loop
    x = _with(_x((3, 4097), 32), kind)
    c = _coeffs(*kind_fc_q)
    got = DS.biquad_scan_host(_t(x), *c)
    _same_places(got, _t(_biquad_loop(x, *c)))
    if kind == "nan":
        _same_places(got, DS.biquad_scan_plain(_t(x), *c))


# ---------------------------------------------------------------------------
# non-finite samples: four orders on one input, held to the Faust golden
#
# The same seeded rows, each with one NaN, +inf or -inf at NF_T0[r], far
# enough from the row's end that a product of the poles over the rest
# underflows to 0, through the port's plain ladder, the kernels' host
# form, the JAX stage (zorak_tpu/models/dspkit.py under jax.jit) and the
# sequential recurrence of zorak_tpu/models/faust_golden.py.  Each test
# states, run by run, where each order puts NaN and inf.  NaN lands where
# the golden puts it in every order, but for max_follower; an inf never
# does: the golden keeps it (or, in the biquad, turns it into NaN a
# sample sooner), and the three scan orders give NaN where a product of
# poles underflowed, each at its own places.  Where the port departs from
# the golden the JAX stage departs too (ROADMAP.md, queue 3, "Of the
# reference"), so nothing of the port is changed for it.

NF_T = 4097
NF_T0 = (100, 1500, 2000)
NF_POLE = 0.6          # 0.6 ** 1459 underflows to 0
NF_HP = ("hp", 11500.0, 0.707)


def _golden_rows(name, x):
    """The golden's recurrence, a sample at a time: onepole as VAR's
    level follower (faust_golden.py `z_lvl = (1 - a) * x + a * z_lvl`),
    integrator as ClickBeGone's high-pass (`a * (L - x') + a * y'`: u + a
    y'), max_follower as its envelope (`env = max(ehf, env_rel * env)`,
    Python's max), the biquad as `_Biquad.step` (fi.tf22t)."""
    from zorak_tpu.models.faust_golden import _Biquad, _rbj

    y = np.empty_like(x)
    for r in range(x.shape[0]):
        z, bq = 0.0, _Biquad(_rbj(*NF_HP, SR))
        for t in range(x.shape[1]):
            xt = float(x[r, t])
            if name == "onepole":
                z = (1.0 - NF_POLE) * xt + NF_POLE * z
            elif name == "integrator":
                z = xt + NF_POLE * z
            elif name == "max_follower":
                z = max(xt, NF_POLE * z)
            else:
                z = bq.step(xt)
            y[r, t] = z
    return y


def _runs(row):
    """(class, first, last) runs of the row's non-finite samples and the
    finite ones after the first of them."""
    cls = np.where(np.isnan(row), "nan", np.where(
        np.isposinf(row), "+inf", np.where(np.isneginf(row), "-inf", "")))
    bad = np.flatnonzero(cls != "")
    out = []
    if bad.size:
        for t in range(int(bad[0]), len(row)):
            c = str(cls[t]) or "finite"
            if out and out[-1][0] == c and out[-1][2] == t - 1:
                out[-1] = (c, out[-1][1], t)
            else:
                out.append((c, t, t))
    return out


def _stated(order, name, kind, t0):
    """Where `order` puts NaN and inf on the row whose sample t0 is
    `kind` (the runs from the first non-finite sample to the row's end)."""
    end = NF_T - 1
    if kind == "nan":
        if name == "max_follower" and order == "golden":
            # Python's max keeps the finite operand: NaN at t0 alone
            return [("nan", t0, t0), ("finite", t0 + 1, end)]
        return [("nan", t0, end)]
    s, o = kind, {"inf": "-inf", "-inf": "+inf"}[kind]
    s = "+inf" if s == "inf" else s
    if name == "max_follower" and kind == "-inf":
        return []                       # max(-inf, a z) is a z
    if name == "biquad":
        if order == "golden":
            # s1 = b1 x - a1 y + s2 with x and y infinite: NaN at once
            return [(s, t0, t0), ("nan", t0 + 1, end)]
        if order == "plain":
            # the doubling ladder's 2x2 products keep an inf a few steps
            return [(s, t0, t0), (o, t0 + 1, t0 + 1), ("nan", t0 + 2, t0 + 2),
                    (s, t0 + 3, t0 + 3), ("nan", t0 + 4, t0 + 4),
                    (o, t0 + 5, t0 + 5), ("nan", t0 + 6, t0 + 8),
                    (o, t0 + 9, t0 + 9), ("nan", t0 + 10, t0 + 512),
                    (s, t0 + 513, t0 + 513), ("nan", t0 + 514, end)]
        # the JAX scan and the kernel: (b1 - a1 b0) x is one infinite term
        return [(s, t0, t0), (o, t0 + 1, t0 + 1), ("nan", t0 + 2, end)]
    if order == "golden":
        return [(s, t0, end)]           # a z stays infinite
    # 0 * inf once a product of the poles underflowed: the JAX scan's last
    # combination, the ladder's step of 2,048, the kernel's carry tiles
    first_nan = {"jax": NF_T - 2, "plain": t0 + 2048,
                 "host": {100: 3072, 1500: 4096, 2000: 4096}[t0]}[order]
    return [(s, t0, first_nan - 1), ("nan", first_nan, end)]


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf"])
@pytest.mark.parametrize("name", [n for n, _ in POLES] + ["biquad_tf2"])
def test_non_finite_places_of_four_orders_and_the_golden(host, name, kind):
    assert NF_POLE ** (NF_T - 1 - max(NF_T0)) == 0.0
    x = _input(name, (len(NF_T0), NF_T), 33)
    for r, t0 in enumerate(NF_T0):
        x[r, t0] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}[kind]
    if name == "biquad_tf2":
        c = _coeffs(*NF_HP)
        orders = {"jax": _jax(name, x, *c),
                  "plain": DS.biquad_scan_plain(_t(x), *c).numpy(),
                  "host": DS.biquad_scan_host(_t(x), *c).numpy()}
    else:
        orders = {"jax": _jax(name, x, NF_POLE),
                  "plain": _plain(name, _t(x), NF_POLE).numpy(),
                  "host": _host(name, _t(x), NF_POLE).numpy()}
    with np.errstate(all="ignore"):
        orders["golden"] = _golden_rows(name.replace("_tf2", ""), x)
    for order, y in orders.items():
        for r, t0 in enumerate(NF_T0):
            assert _runs(y[r]) == _stated(order, name.replace("_tf2", ""),
                                          kind, t0), (order, r)


# ---------------------------------------------------------------------------
# the wrappers on the CPU


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    counts = (DS.AFFINE_LAUNCHES, DS.MAXPLUS_LAUNCHES, DS.BIQUAD_LAUNCHES,
              DS.LCG_LAUNCHES)
    x = _t(np.abs(_x((3, 500), 40)))
    c = _coeffs("hp", 11500.0, 0.707)
    assert torch.equal(P.onepole(x, 0.98, 0.1),
                       DS.affine_scan_plain(x, 0.98, 0.1, onepole=True))
    assert torch.equal(P.integrator(x, 0.95),
                       DS.affine_scan_plain(x, 0.95, onepole=False))
    assert torch.equal(P.max_follower(x, 0.97),
                       DS.maxplus_scan_plain(x, 0.97))
    assert torch.equal(P.biquad_tf2(x, *c), DS.biquad_scan_plain(x, *c))
    assert torch.equal(P.lcg_noise(500, device="cpu"),
                       DS.lcg_noise_plain(500))
    assert counts == (DS.AFFINE_LAUNCHES, DS.MAXPLUS_LAUNCHES,
                      DS.BIQUAD_LAUNCHES, DS.LCG_LAUNCHES)


_BAD = {
    "x float32": lambda x: DS.affine_scan(x.float(), 0.9, onepole=True),
    "x int64": lambda x: DS.maxplus_scan(x.long(), 0.9),
    "pole float32": lambda x: DS.affine_scan(x, x.float(), onepole=False),
    "z0 float32": lambda x: DS.maxplus_scan(x, 0.9, x[..., :1].float()),
    "pole on another device": lambda x: DS.affine_scan(
        x, torch.empty(x.shape, dtype=torch.float64, device="meta"),
        onepole=True),
    "z0 on another device": lambda x: DS.maxplus_scan(
        x, 0.9, torch.empty((3, 1), dtype=torch.float64, device="meta")),
    "x on meta": lambda x: DS.biquad_scan(x.to("meta"), 1.0, 0.0, 0.0, 0.0,
                                          0.0),
    "biquad coefficient float32": lambda x: DS.biquad_scan(
        x, torch.tensor(1.0, dtype=torch.float32), 0.0, 0.0, 0.0, 0.0),
    "pole shape": lambda x: DS.affine_scan(x, x[:2], onepole=True),
    "z0 shape": lambda x: DS.maxplus_scan(x, 0.9, x),
    "noise on meta": lambda x: DS.lcg_noise(10, device="meta"),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_wrappers_reject_bad_inputs(case):
    x = _t(_x((3, 64), 41))
    with pytest.raises(ValueError):
        _BAD[case](x)


def test_host_form_refuses_a_short_scratch(host, monkeypatch):
    # the scratch is sized by the source's tile; a wrapper that sized it
    # by another is refused, never written past
    monkeypatch.setattr(DS, "TILE_MAPS", 64)
    x = _t(_x((3, 64 * DS.CHUNK + 1), 50))
    with pytest.raises(RuntimeError, match="refused"):
        DS.affine_scan_host(x, 0.9, onepole=True)
