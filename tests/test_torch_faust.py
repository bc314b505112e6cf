"""zorak_tpu_torch Faust modules and batch renderer against zorak_tpu.

The same seeded numpy inputs go through each JAX module and its port, at
default and perturbed values (built as tests/test_faust_golden.py builds
them), and through the NumPy goldens.  Runs on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zorak_tpu.models import FAUST_MODULES as JAX_MODULES
from zorak_tpu.models import get_faust_module as get_jax_module
from zorak_tpu.models.faust_golden import GOLDENS
from zorak_tpu.parallel.batch import FaustBatchRenderer as JaxBatchRenderer
from zorak_tpu_torch.convert import values_from_jax
from zorak_tpu_torch.models import FAUST_MODULES, get_faust_module
from zorak_tpu_torch.parallel import FaustBatchRenderer
from zorak_tpu_torch.verify import AUDIO_EPS, compare_audio

SR = 48000.0
T = 2500
SLUGS = sorted(FAUST_MODULES)
# The port repeats the JAX modules' f64 arithmetic; only the order in which
# the doubling scans combine terms differs from lax.associative_scan, so
# the two agree to rounding (observed <= 1e-15).  1e-9 leaves room for the
# followers and ratios that amplify a last-bit difference.
MODULE_TOL = 1e-9


def _input_for(mod, seed=7, n=T):
    rs = np.random.RandomState(seed)
    x = rs.randn(mod.n_in, n) * 0.25
    if mod.slug == "RED":
        # wet tail in 1/2, dry reference in 5/6 with silence gaps so the
        # dryA/offA switching paths all exercise
        x[4:] *= (np.arange(n) % 1200 < 700)
        x[:2] *= 0.5
    if mod.slug == "ClickBeGoneSG":
        # needle clicks on top of quiet texture
        x *= 0.05
        for pos in (400, 1100, 1900):
            if pos < n:
                x[:, pos] += 0.9
    return x


def _perturbed(mod):
    vals = {}
    for p in mod.params:
        v = p.lo + 0.37 * (p.hi - p.lo)
        if p.step >= 1.0:
            v = round(v)
        vals[p.name] = min(p.hi, max(p.lo, v))
    return vals


def _jax_render(slug, x, v):
    """The JAX module's render under jit: one XLA compile instead of one
    per eager op of its scans (seconds each on the CPU)."""
    mod = get_jax_module(slug)
    return np.asarray(jax.jit(lambda a: mod.render(a, v, SR))(jnp.asarray(x)))


def _case(slug, which):
    mod = get_faust_module(slug)
    if which == "default":
        return mod, _input_for(mod), mod.values()
    return mod, _input_for(mod, seed=11), mod.values(_perturbed(mod))


@pytest.mark.parametrize("which", ["default", "perturbed"])
@pytest.mark.parametrize("slug", SLUGS)
def test_module_matches_jax(slug, which):
    mod, x, v = _case(slug, which)
    want = _jax_render(slug, x, v)
    got = mod(torch.from_numpy(x), v, SR).numpy()
    assert got.shape == want.shape == (mod.n_out, T)
    assert np.abs(got - want).max() <= MODULE_TOL


@pytest.mark.parametrize("which", ["default", "perturbed"])
@pytest.mark.parametrize("slug", SLUGS)
def test_module_matches_golden(slug, which):
    # the reference's audio contract: f32-rounded samples within 1e-5
    mod, x, v = _case(slug, which)
    got = mod.render(torch.from_numpy(x), v, SR).numpy()
    rep = compare_audio(GOLDENS[slug](x, v, SR), got)
    assert rep.audio_passed, f"{slug}: {rep.summary()}"


@pytest.mark.parametrize("slug", SLUGS)
def test_module_metadata_matches_jax(slug):
    mod, ref = get_faust_module(slug), get_jax_module(slug)
    assert isinstance(mod, torch.nn.Module)
    assert (mod.name, mod.n_in, mod.n_out, mod.latency_frames) == \
        (ref.name, ref.n_in, ref.n_out, ref.latency_frames)
    assert [vars(p) for p in mod.params] == [vars(p) for p in ref.params]


def test_registry():
    assert set(FAUST_MODULES) == set(JAX_MODULES)
    assert get_faust_module("NoSuchPlugin") is None


def test_values_from_jax_carries_jax_values():
    ref = get_jax_module("VAR")
    jvals = {k: jnp.asarray(v) for k, v in ref.values(_perturbed(ref)).items()}
    jvals["sensitivity"] = np.float64(jvals["sensitivity"])
    vals = values_from_jax(jvals)
    assert all(type(v) is float for v in vals.values())
    x = _input_for(ref, seed=3)
    want = _jax_render("VAR", x, jvals)
    got = get_faust_module("VAR")(torch.from_numpy(x), vals, SR).numpy()
    assert np.abs(got - want).max() <= MODULE_TOL


@pytest.mark.parametrize("slug", SLUGS)
def test_leading_batch_dims_match_per_file_renders(slug):
    mod = get_faust_module(slug)
    xs = [_input_for(mod, seed=s, n=1200) for s in (21, 22)]
    v = mod.values()
    batched = mod(torch.from_numpy(np.stack(xs)), v, SR)
    for i, x in enumerate(xs):
        assert torch.equal(batched[i], mod(torch.from_numpy(x), v, SR))


@pytest.mark.parametrize("slug", SLUGS)
def test_batch_renderer_matches_jax(slug):
    port = FaustBatchRenderer(slug, srate=SR, device="cpu")
    ref = JaxBatchRenderer(slug, srate=SR)
    assert port.nch == ref.nch and port.values == ref.values
    mod = port.mod
    x = np.stack([_input_for(mod, seed=s, n=1200)
                  for s in (31, 32)]).astype(np.float32)
    got = port.render_files(x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(ref.render_files(x))
    for f in range(2):
        rep = compare_audio(want[f], got[f].numpy())
        assert rep.audio_passed, f"{slug} file {f}: {rep.summary()}"


def test_batch_renderer_rejects_wrong_channels():
    r = FaustBatchRenderer("RED", device="cpu")
    with pytest.raises(ValueError):
        r.render_files(np.zeros((1, 2, 100), np.float32))
    with pytest.raises(ValueError):
        FaustBatchRenderer("NoSuchPlugin", device="cpu")


def test_render_leaves_global_torch_state_alone():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    mod = get_faust_module("VAR")
    mod(torch.from_numpy(_input_for(mod, n=300)), mod.values(), SR)
    assert torch.get_default_dtype() == dtype
    assert torch.get_num_threads() == threads
