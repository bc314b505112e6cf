"""K8's walk without a GPU: csrc/partition_mac.cu compiled in its host
form (g++ -O2 -ffp-contract=off: two roundings a multiply-add, as nvcc
--fmad=false gives the kernel) runs the kernel's blocks, stages and
threads one after another, through the same walk of
csrc/partition_mac.cuh (window ring, partition groups, ragged tiles);
here it is held to the plain PyTorch version, bit for bit, every NaN
counted as one value.

Each tile of the kernel's builds is held at shapes cut from its own
geometry (R frames a thread, W warps a block, PG partitions a group):
frames 1, R - 1, R + 1, W*R + 1 and 2*W*R + 3; parts < R, PG + 1, more
than the frames and 2*PG + 3 (three groups); 5, 33 and 65 bins; three
lanes; an inf in H (the zero history rows meet it: NaN), NaN and -0.0 in
X; scale 1 and 2^-12.  The small walk (4, 2, 8) crosses many tiles and
groups at these sizes.  Where no host C++ compiler is found the tests
skip with that reason.
"""
import numpy as np
import pytest
import torch

from zorak_tpu_torch.kernels import _build
from zorak_tpu_torch.kernels import convolution as CV


@pytest.fixture(scope="module")
def host_cxx():
    try:
        return _build.find_host_compiler()
    except RuntimeError:
        pytest.skip("no host C++ compiler for K8's host form")


def same_values(a, b):
    """Equal as bit patterns, real and imaginary parts, every NaN one
    value."""
    a, b = torch.view_as_real(a), torch.view_as_real(b)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return a.shape == b.shape and torch.equal(nan_a, nan_b) and torch.equal(
        torch.where(nan_a, 0.0, a).view(torch.int32),
        torch.where(nan_b, 0.0, b).view(torch.int32))


def edge_shapes(tile):
    """(lanes, frames, bins, parts) at the edges of a tile's walk."""
    r, w, pg = tile
    return [(1, 1, 33, 3), (3, r - 1, 33, r - 1), (2, r + 1, 33, pg + 1),
            (3, w * r + 1, 5, r + 3), (1, 7, 65, 2 * pg + 3),
            (3, 2 * w * r + 3, 65, 2 * pg + 3)]


def inputs(lanes, n_frames, bins, parts, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(lanes, n_frames, bins)
                          + 1j * rng.randn(lanes, n_frames, bins)
                          ).astype(np.complex64))
    h = torch.from_numpy(((rng.randn(parts, bins) + 1j * rng.randn(
        parts, bins)) * 30).astype(np.complex64))
    h[0, 1] = complex(float("inf"), 0.0)
    x[-1, 0, 2] = complex(float("nan"), -0.0)
    x[0, -1, 0] = complex(-0.0, -0.0)
    return x, h


CASES = [(tile, shape) for tile in CV.HOST_TILES
         for shape in edge_shapes(tile)]


@pytest.mark.parametrize("tile,shape", CASES,
                         ids=[f"{t}-{s}" for t, s in CASES])
def test_host_walk_equals_the_plain_version(tile, shape, host_cxx):
    x, h = inputs(*shape, seed=sum(shape))
    for scale in (1.0, 2.0 ** -12):
        got = CV.partition_mac_host(x, h, scale, tile)
        want = CV.partition_mac_reference(x, h, scale)
        assert same_values(got, want), (tile, shape, scale)


def test_every_tile_gives_the_same_bits(host_cxx):
    x, h = inputs(2, 300, 70, 140, seed=5)
    want = CV.partition_mac_reference(x, h, 0.25)
    for tile in CV.HOST_TILES:
        assert same_values(CV.partition_mac_host(x, h, 0.25, tile), want), tile


def test_the_history_rows_are_multiplied_not_skipped(host_cxx):
    # X finite, H[1] infinite: frame 0 meets H[1] only through its zero
    # history row X[-1], so every bin of Y[0] is NaN in both versions
    x, h = inputs(1, 3, 33, 2, seed=9)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    h = torch.where(torch.isinf(h.real), torch.ones_like(h), h)
    h[1] = complex(float("inf"), 0.0)
    got = CV.partition_mac_host(x, h, tile=(4, 2, 8))
    assert torch.isnan(got[0, 0]).all()
    assert same_values(got, CV.partition_mac_reference(x, h))


def test_host_form_refuses_what_it_does_not_take(host_cxx):
    x, h = inputs(1, 4, 9, 3, seed=1)
    with pytest.raises(ValueError, match="tile"):
        CV.partition_mac_host(x, h, tile=(8, 8, 64))
    with pytest.raises(ValueError, match="power of two"):
        CV.partition_mac_host(x, h, scale=0.3)
    assert CV.partition_mac_host(x[:, :0], h).shape == (1, 0, 9)
