"""The ring tap sum's plain fold against slices in numpy, bit-identical,
and the wrapper's checks and dispatch on CPU tensors."""
import numpy as np
import pytest
import torch

from zorak_tpu_torch.kernels import ring_taps as RT


def numpy_fold(buf, starts, gains, init, n):
    acc = np.full(n, init) if np.isscalar(init) else np.array(init)
    for s, g in zip(starts, gains):
        acc = acc + g * buf[s:s + n]
    return acc


def case(n_taps, mod, n, seed, long_only=False):
    rng = np.random.RandomState(seed)
    hi = mod - n if long_only else mod
    starts = rng.randint(0, hi + 1, n_taps).astype(np.int64)
    starts[0], starts[-1] = hi, 0
    return (rng.randn(mod if long_only else mod + n), starts,
            rng.uniform(-0.2, 0.2, n_taps))


@pytest.mark.parametrize("n_taps,mod", [(2, 64), (16, 4096), (192, 16384)])
@pytest.mark.parametrize("n", [1, 300, 2048])
@pytest.mark.parametrize("stream_init", [False, True])
def test_plain_fold_is_the_numpy_fold(n_taps, mod, n, stream_init):
    buf, starts, gains = case(n_taps, mod, n, seed=n_taps + n)
    init = np.random.RandomState(1).randn(n) if stream_init else 0.25
    got = RT.ring_tap_sum(torch.from_numpy(buf), torch.from_numpy(starts),
                          torch.from_numpy(gains),
                          torch.from_numpy(init) if stream_init else init, n)
    want = numpy_fold(buf, starts, gains, init, n)
    assert np.array_equal(got.numpy().view(np.int64), want.view(np.int64))


def test_history_alone_when_every_delay_reaches_past_the_segment():
    buf, starts, gains = case(24, 4096, 512, seed=4, long_only=True)
    got = RT.ring_tap_sum(torch.from_numpy(buf), torch.from_numpy(starts),
                          torch.from_numpy(gains), 0.0, 512)
    want = numpy_fold(buf, starts, gains, 0.0, 512)
    assert np.array_equal(got.numpy().view(np.int64), want.view(np.int64))


def test_fold_keeps_the_chain_order():
    # a sum in another order rounds differently: the fold is k = 0 first
    buf, starts, gains = case(64, 1024, 256, seed=8)
    got = RT.ring_tap_sum_reference(
        torch.from_numpy(buf), torch.from_numpy(starts),
        torch.from_numpy(gains), 0.0, 256).numpy()
    backwards = numpy_fold(buf, starts[::-1], gains[::-1], 0.0, 256)
    assert np.allclose(got, backwards, rtol=0, atol=1e-12)
    assert not np.array_equal(got, backwards)


def test_wrapper_launches_nothing_on_cpu_tensors():
    buf, starts, gains = case(8, 256, 100, seed=2)
    before = RT.LAUNCHES
    init = torch.zeros(100, dtype=torch.float64)
    got = RT.ring_tap_sum(torch.from_numpy(buf), torch.from_numpy(starts),
                          torch.from_numpy(gains), init)
    assert RT.LAUNCHES == before and got.shape == (100,)
    assert torch.equal(init, torch.zeros(100, dtype=torch.float64))


@pytest.mark.parametrize("bad", ["window", "negative", "length", "dtype",
                                 "gains", "scalar_without_length"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    buf = torch.zeros(300, dtype=torch.float64)
    starts = torch.tensor([0, 100], dtype=torch.int64)
    gains = torch.tensor([0.5, 0.5], dtype=torch.float64)
    init, n = 0.0, 200
    if bad == "window":
        starts = torch.tensor([0, 101], dtype=torch.int64)
    elif bad == "negative":
        starts = torch.tensor([-1, 100], dtype=torch.int64)
    elif bad == "length":
        n = 301
    elif bad == "dtype":
        buf = buf.to(torch.float32)
    elif bad == "gains":
        gains = gains[:1]
    else:
        n = None
    with pytest.raises(ValueError):
        RT.ring_tap_sum(buf, starts, gains, init, n)
