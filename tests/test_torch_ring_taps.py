"""The ring tap sum's plain fold against a numpy fold over the concatenated
buffer `[ring from the cursor | ring before it | stream]`, bit-identical;
batches of chains; the staged kernel's windows; the wrapper's checks and
dispatch on CPU tensors."""
import numpy as np
import pytest
import torch

from zorak_tpu_torch.kernels import ring_taps as RT


def numpy_fold(ring, start, stream, starts, gains, init, n):
    buf = np.concatenate([ring[start:], ring[:start]]
                         + ([] if stream is None else [stream]))
    acc = np.full(n, init) if np.isscalar(init) else np.array(init)
    for s, g in zip(starts, gains):
        acc = acc + g * buf[s:s + n]
    return acc


def case(n_taps, mod, n, seed, long_only=False):
    """A ring [mod], a stream [n] (None: every delay >= n, history
    alone), tap starts with delay 0 (start mod) and delay mod (start 0)."""
    rng = np.random.RandomState(seed)
    hi = mod - n if long_only else mod
    starts = rng.randint(0, hi + 1, n_taps).astype(np.int64)
    starts[0], starts[-1] = hi, 0
    return (rng.randn(mod), None if long_only else rng.randn(n), starts,
            rng.uniform(-0.2, 0.2, n_taps))


def cursor(kind, mod):
    return {"zero": 0, "last": mod - 1, "middle": mod // 2 + 3}[kind]


def run(chains, n, starts_kind="middle", fn=RT.ring_tap_sum):
    """chains: (ring, stream, starts, gains, init) numpy tuples."""
    tables = RT.TapTables([(st, g) for _r, _s, st, g, _i in chains])
    out = fn(tables, [torch.from_numpy(r) for r, *_ in chains],
             [cursor(starts_kind, len(r)) for r, *_ in chains],
             [None if s is None else torch.from_numpy(s)
              for _r, s, *_ in chains],
             [torch.from_numpy(i) if isinstance(i, np.ndarray) else i
              for *_, i in chains], n)
    return out.numpy()


def same_bits(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int64),
                                                 b.view(np.int64))


@pytest.mark.parametrize("n_taps,mod", [(2, 64), (16, 4096), (192, 16384)])
@pytest.mark.parametrize("n", [1, 300, 2048])
@pytest.mark.parametrize("stream_init", [False, True])
@pytest.mark.parametrize("start", ["zero", "last", "middle"])
def test_plain_fold_is_the_numpy_fold(n_taps, mod, n, stream_init, start):
    ring, stream, starts, gains = case(n_taps, mod, n, seed=n_taps + n)
    init = np.random.RandomState(1).randn(n) if stream_init else 0.25
    got = run([(ring, stream, starts, gains, init)], n, start)
    want = numpy_fold(ring, cursor(start, mod), stream, starts, gains, init, n)
    assert same_bits(got[0], want)


@pytest.mark.parametrize("start", ["zero", "last", "middle"])
def test_history_alone_when_every_delay_reaches_past_the_segment(start):
    ring, stream, starts, gains = case(24, 4096, 512, seed=4, long_only=True)
    assert stream is None
    got = run([(ring, None, starts, gains, 0.0)], 512, start)
    want = numpy_fold(ring, cursor(start, 4096), None, starts, gains, 0.0, 512)
    assert same_bits(got[0], want)


def test_fold_keeps_the_chain_order():
    # a sum in another order rounds differently: the fold is k = 0 first
    ring, stream, starts, gains = case(64, 1024, 256, seed=8)
    got = run([(ring, stream, starts, gains, 0.0)], 256,
              fn=RT.ring_tap_sum_reference)[0]
    backwards = numpy_fold(ring, cursor("middle", 1024), stream, starts[::-1],
                           gains[::-1], 0.0, 256)
    assert np.allclose(got, backwards, rtol=0, atol=1e-12)
    assert not np.array_equal(got, backwards)


@pytest.mark.parametrize("start", ["zero", "last", "middle"])
def test_a_batch_folds_each_chain_as_alone(start):
    # tables of 2, 16, 192 and 5 taps, rings of three sizes, a chain of
    # history alone, scalar, stream and 0-d inits in one launch
    n = 700
    rng = np.random.RandomState(5)
    parts = [case(2, 64, n, seed=11), case(16, 4096, n, seed=12),
             case(192, 16384, n, seed=13), case(5, 4096, n, seed=14,
                                                long_only=True)]
    inits = [0.0, rng.randn(n), -1.5, np.array(0.75)]
    chains = [p + (i,) for p, i in zip(parts, inits)]
    got = run(chains, n, start)
    assert got.shape == (4, n)
    for c, (ring, stream, starts, gains, init) in enumerate(chains):
        want = numpy_fold(ring, cursor(start, len(ring)), stream, starts,
                          gains, init if np.ndim(init) else float(init), n)
        assert same_bits(got[c], want), c
        assert same_bits(got[c], run([chains[c]], n, start)[0]), c


def test_windows_cut_the_taps_in_order_to_fit_shared_memory():
    rng = np.random.RandomState(3)
    wide = rng.randint(0, 1 << 18, 900).tolist()      # spans past any window
    narrow = (16384 - 32 - (np.arange(192) * 317) % 11968).tolist()
    for tile in RT.TILES:
        tables = RT.TapTables([(wide, [0.5] * 900), (narrow, [0.5] * 192)],
                              tile=tile)
        assert tables.smem_bytes <= RT.SMEM_BYTES
        assert tables.table_taps % 4 == 0
        windows = tables.windows_dev.tolist()
        for c, st in enumerate((wide, narrow)):
            w0, w1 = tables.chain_windows[c]
            runs = windows[w0:w1]
            base = runs[0][0]
            assert [r[0] for r in runs[1:]] == [r[1] for r in runs[:-1]]
            assert runs[-1][1] - base == len(st)
            for k, e, lo, hi in runs:
                taps = st[k - base:e - base]
                assert (lo, hi) == (min(taps), max(taps))
                assert e - k <= min(tables.table_taps, RT.WINDOW_TAPS)
                assert 12 * tables.table_taps + 8 * (hi - lo + tile + 1) \
                    <= tables.smem_bytes
        assert tables.chain_windows[1][1] - tables.chain_windows[1][0] == 1
        assert tables.chain_windows[0][1] - tables.chain_windows[0][0] > 1


@pytest.mark.parametrize("length,chains,tile", [
    (131072, 2, 2048), (131072, 1, 1024), (131072, 16, 2048), (6784, 2, 256),
    (1, 1, 256)])
def test_the_tile_is_the_largest_that_keeps_the_card_full(length, chains, tile):
    # 132 SMs (an H100 SXM): at least 15 in 16 of them get a block
    assert RT.choose_tile(length, chains, 132) == tile
    assert RT.TapTables([([0, 5], [0.5, 0.5])], length=length).tile == RT.TILE


def test_wrapper_launches_nothing_on_cpu_tensors():
    ring, stream, starts, gains = case(8, 256, 100, seed=2)
    before = RT.LAUNCHES
    init = np.zeros(100)
    got = run([(ring, stream, starts, gains, init)], 100)
    assert RT.LAUNCHES == before and got.shape == (1, 100)
    assert np.array_equal(init, np.zeros(100))


@pytest.mark.parametrize("bad", [
    "window", "negative", "beyond", "stream", "length", "dtype", "gains",
    "cursor", "count", "too_many", "init", "tile", "no_taps"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ring = torch.zeros(300, dtype=torch.float64)
    stream = torch.zeros(200, dtype=torch.float64)
    chains = [([0, 100], [0.5, 0.5])]
    rings, cursors, streams, inits, n = [ring], [5], [stream], [0.0], 200
    tile = RT.TILE
    if bad == "window":
        chains, streams = [([0, 101], [0.5, 0.5])], [None]
    elif bad == "negative":
        chains = [([-1, 100], [0.5, 0.5])]
    elif bad == "beyond":
        chains = [([0, 301], [0.5, 0.5])]
    elif bad == "stream":
        streams = [stream[:199]]
    elif bad == "length":
        n = -1
    elif bad == "dtype":
        rings = [ring.to(torch.float32)]
    elif bad == "gains":
        chains = [([0, 100], [0.5])]
    elif bad == "cursor":
        cursors = [300]
    elif bad == "count":
        rings = [ring, ring]
    elif bad == "too_many":
        chains = chains * (RT.MAX_CHAINS + 1)
    elif bad == "init":
        inits = [torch.zeros(199, dtype=torch.float64)]
    elif bad == "tile":
        tile = 768
    else:
        chains = [([], [])]
    with pytest.raises(ValueError):
        tables = RT.TapTables(chains, tile=tile)
        RT.ring_tap_sum(tables, rings, cursors, streams, inits, n)


@pytest.mark.parametrize("start", ["zero", "last", "middle"])
@pytest.mark.parametrize("nf", [1, 3])
def test_files_fold_each_file_as_alone(start, nf):
    # a batch of files shares the tables and the cursors: rings [nf, mod],
    # streams one a file or one for all, inits [nf, 1], [nf, n], [n], 0-d
    # and floats; each file's fold equals its single-file fold
    n = 700
    rng = np.random.RandomState(20 + nf)
    parts = [case(2, 64, n, seed=21), case(16, 4096, n, seed=22),
             case(192, 16384, n, seed=23), case(5, 4096, n, seed=24,
                                                long_only=True)]
    tables = RT.TapTables([(st, g) for _r, _s, st, g in parts])
    rings = [rng.randn(nf, len(r)) for r, *_ in parts]
    shared = [False, True, False, True]
    streams = [None if s is None else (s if sh else rng.randn(nf, n))
               for (_r, s, *_), sh in zip(parts, shared)]
    inits = [rng.randn(nf, 1), rng.randn(nf, n), rng.randn(n), np.array(0.5)]
    cursors = [cursor(start, len(r)) for r, *_ in parts]
    T = torch.from_numpy
    got = RT.ring_tap_sum(tables, [T(r) for r in rings], cursors,
                          [None if s is None else T(s) for s in streams],
                          [T(i) for i in inits], n).numpy()
    assert got.shape == (4, nf, n)
    for f in range(nf):
        one = RT.ring_tap_sum(
            tables, [T(r[f]) for r in rings], cursors,
            [None if s is None else T(s if s.ndim == 1 else s[f])
             for s in streams],
            [T(np.broadcast_to(i, (nf, n))[f].copy()) for i in inits],
            n).numpy()
        assert same_bits(got[:, f], one), f
    # a float init and the plain fold agree with the tensor forms
    floats = RT.ring_tap_sum_reference(
        tables, [T(r) for r in rings], cursors,
        [None if s is None else T(s) for s in streams],
        [0.5, 0.5, 0.5, 0.5], n).numpy()
    halves = RT.ring_tap_sum_reference(
        tables, [T(r) for r in rings], cursors,
        [None if s is None else T(s) for s in streams],
        [T(np.array(0.5))] * 4, n).numpy()
    assert same_bits(floats, halves)


def test_files_need_rings_of_one_batch():
    _ring, _stream, starts, gains = case(8, 256, 100, seed=2, long_only=True)
    tables = RT.TapTables([(starts, gains), (starts, gains)])
    rings = [torch.zeros(2, 256, dtype=torch.float64),
             torch.zeros(3, 256, dtype=torch.float64)]
    with pytest.raises(ValueError, match="ring"):
        RT.ring_tap_sum(tables, rings, [0, 0], [None, None], [0.0, 0.0], 100)
    with pytest.raises(ValueError, match="stream"):
        RT.ring_tap_sum(tables, [rings[0]] * 2, [0, 0],
                        [torch.zeros(3, 100, dtype=torch.float64)] * 2,
                        [0.0, 0.0], 100)
    with pytest.raises(ValueError, match="init"):
        RT.ring_tap_sum(tables, [rings[0]] * 2, [0, 0], [None, None],
                        [torch.zeros(3, 1, dtype=torch.float64)] * 2, 100)


@pytest.mark.parametrize("length,chains,files,tile", [
    (131072, 2, 1, 2048), (131072, 2, 8, 2048), (16384, 2, 8, 2048),
    (16384, 2, 1, 256), (6784, 2, 8, 512), (2048, 1, 8, 256)])
def test_the_tile_counts_the_files(length, chains, files, tile):
    assert RT.choose_tile(length, chains, 132, files) == tile
