"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu_torch import ops
from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir as k34
from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(rows, n, seed, amp=0.5, silent=(0, 0)):
    rng = np.random.default_rng(seed)
    x = amp * (rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n)))
    x[:, silent[0]:silent[1]] = 0
    return torch.from_numpy(x.astype(np.complex64))


@pytest.mark.parametrize("rows,n,amp", [(1, 263_840, 0.5), (64, 4096, 0.5),
                                        (3, 5000, 1.0), (2, 1000, 0.5), (3, 4999, 0.5)])
def test_sync_stats_kernel_matches_plain(dev, rows, n, amp):
    x = _stream(rows, n, seed=rows, amp=amp, silent=(n // 3, n // 3 + 600))
    want = [v.to(dev) for v in k1.sync_stats_plain(x.to(dev))]
    before = k1.sync_stats.launches
    got = k1.sync_stats(x.to(dev))
    torch.cuda.synchronize()
    assert k1.sync_stats.launches == before + 1
    a, p, c = got
    torch.testing.assert_close(a, want[0], atol=2e-4, rtol=0)
    torch.testing.assert_close(p, want[1], atol=2e-4, rtol=0)
    mask = want[1] > 1e-3
    torch.testing.assert_close(c[mask], want[2][mask], atol=1e-3, rtol=0)
    # a silent stretch gives exact zeros once both windows lie inside it
    quiet = slice(n // 3 + 64, n // 3 + 600)
    assert torch.count_nonzero(a[:, quiet]) == 0
    assert torch.count_nonzero(p[:, quiet]) == 0


def _burst_rows(n, edges_per_row, min_plateau=2, seed=0):
    """Rows of faint noise with 48-sample bursts of a unit-magnitude
    16-periodic signal, placed so that each burst's rising detection edge
    falls at the given index (c first reaches 0.56 36 samples into a
    burst: 21/37 there, 20/36 a sample before)."""
    rng = np.random.default_rng(seed)
    x = 1e-3 * (rng.standard_normal((len(edges_per_row), n))
                + 1j * rng.standard_normal((len(edges_per_row), n)))
    for row, edges in enumerate(edges_per_row):
        for e in edges:
            p = e - 36 - (min_plateau - 1)
            theta = rng.uniform(0, 2 * np.pi, 16)
            x[row, p: p + 48] = np.exp(1j * theta[np.arange(48) % 16])
    return torch.from_numpy(x.astype(np.complex64))


# edges on the detector's tile boundaries (992, 1984, 2976) and the dense
# pass's (1024), more than K in one tile (every 112 samples from 2100),
# near the row's end, and none at all
EDGES = [[991, 1984], [992, 1985], [993, 1983], [1023, 2976], [1024], [1025],
         list(range(2100, 3072, 112)) + [5000], [7000], []]


def _detect_both(x, k, mp, lo, hi):
    want = k1.sync_detect_plain(x, k, 0.56, mp, lo, hi)
    before = k1.sync_detect.launches
    got = k1.sync_detect(x, k, 0.56, mp, lo, hi)
    torch.cuda.synchronize()
    assert k1.sync_detect.launches == before + 1
    return got, want


def _assert_candidates(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[3], want[3], atol=1e-3, rtol=0)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mp", [1, 2, 3])
def test_sync_detect_kernel_at_tile_boundaries(dev, mp, k):
    x = _burst_rows(7200, EDGES, mp, seed=mp).to(dev)
    got, want = _detect_both(x, k, mp, 0, None)
    valid = want[1].cpu()
    edges = [sorted(r)[:k] for r in EDGES]
    assert valid.sum(-1).tolist() == [len(r) for r in edges]
    for row, r in enumerate(edges):           # the bursts land where designed
        assert want[0][row, : len(r)].tolist() == [e - (mp - 1) for e in r]
    _assert_candidates(got, want)
    # the dense kernel with the plain glue gives the very same bits
    a, _, c = k1.sync_stats(x)
    glue = k1.detect_from_stats(a, c, k, 0.56, mp, 0, None)
    for g, w in zip(got, glue):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lo,hi", [(992, None), (993, None), (0, 992), (0, 993),
                                   (991, 994), (1024, None), (1025, None), (0, 1024),
                                   (1023, 1026), (2976, 7000), (2977, 7001), (7200, 7200)])
def test_sync_detect_kernel_search_bounds(dev, lo, hi):
    x = _burst_rows(7200, EDGES, seed=9).to(dev)
    got, want = _detect_both(x, 4, 2, lo, hi)
    _assert_candidates(got, want)


@pytest.mark.parametrize("rows,n", [(64, 263_840), (1, 32_768), (3, 1000), (2, 4001)])
def test_sync_detect_kernel_on_noise_and_bursts(dev, rows, n):
    """Random edges in noise, leading dims kept; a row shorter than a
    tile; an odd row length (rows not 16-byte aligned)."""
    rng = np.random.default_rng(rows)
    edges = [sorted(rng.choice(np.arange(200, n - 100, 120), min(6, n // 300),
                               replace=False).tolist()) for _ in range(rows)]
    x = _burst_rows(n, edges, seed=rows).to(dev)
    got, want = _detect_both(x.reshape((rows, 1, n)), 4, 2, 256, n - 300)
    assert got[0].shape == (rows, 1, 4)
    _assert_candidates(got, want)


def test_sync_detect_kernel_past_65535_rows(dev):
    """More rows than a launch's grid holds in y: the kernel loops rows."""
    edges = [[] for _ in range(65_540)]
    edges[0], edges[65_535], edges[65_539] = [150], [150, 260], [120]
    x = _burst_rows(300, edges, seed=11).to(dev)
    got, want = _detect_both(x, 2, 2, 0, None)
    assert want[1].sum().item() == 4
    assert want[0][65_535].tolist() == [149, 259] and want[0][65_539, 0].item() == 119
    _assert_candidates(got, want)


def test_sync_detect_tiling_model_matches_the_kernel(dev):
    x = _burst_rows(7200, EDGES, seed=4)
    starts = k1.sync_detect(x.to(dev), 4, 0.56, 2)[0].cpu()
    a, _, c = k1.sync_stats_plain(x)
    edge = (c >= 0.56) & (k1._delay(c >= 0.56, 1))
    edge = edge & ~k1._delay(edge, 1)
    tiled = k1.first_edges_tiled(edge, 4)
    assert torch.equal(torch.where(tiled < 7200, tiled - 1, 0).to(torch.int32), starts)


def _llrs(b, n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "tied":       # small integers: equal path metrics are common
        llr = rng.integers(-2, 3, (b, n, 2)).astype(np.float32)
    else:
        llr = rng.standard_normal((b, n, 2)).astype(np.float32) * 4
    if kind == "punctured":  # 3/4 pattern erasures
        flat = llr.reshape(b, -1)
        mask = np.tile(np.array([1, 1, 1, 0, 0, 1], bool), flat.shape[1] // 6 + 1)
        flat[:, ~mask[: flat.shape[1]]] = 0
    return torch.from_numpy(llr)


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("kind", ["random", "punctured", "tied"])
@pytest.mark.parametrize("b,n", [(256, 422), (256, 24), (3, 1000)])
def test_viterbi_kernel_matches_plain(dev, b, n, kind, terminated):
    llr = _llrs(b, n, seed=b + n, kind=kind).to(dev)
    want = k2.viterbi_decode_plain(llr, terminated)
    before = k2.viterbi_decode.launches
    got = k2.viterbi_decode(llr, terminated)
    torch.cuda.synchronize()
    assert k2.viterbi_decode.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("segs", [[(256, 422, "random", True), (256, 24, "tied", True)],
                                  [(5, 1000, "punctured", False), (3, 24, "random", True),
                                   (0, 30, "random", True)],
                                  [(7, 3000, "tied", True), (2, 17, "punctured", False),
                                   (9, 422, "random", False)]])
def test_viterbi_many_kernel_matches_plain(dev, segs):
    llrs = [_llrs(b, n, seed=b * n + 1, kind=kind).to(dev) for b, n, kind, _ in segs]
    flags = [t for *_, t in segs]
    want = k2.viterbi_decode_many_plain(llrs, flags)
    before = k2.viterbi_decode_many.launches
    got = k2.viterbi_decode_many(llrs, flags)
    torch.cuda.synchronize()
    assert k2.viterbi_decode_many.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_viterbi_kernel_unaligned_llrs(dev):
    """A view that starts 8 bytes past a 16-byte boundary."""
    llr = _llrs(6, 421, seed=5, kind="tied").to(dev)[1:]
    assert llr.data_ptr() % 16 == 8
    assert torch.equal(k2.viterbi_decode(llr, False), k2.viterbi_decode_plain(llr, False))


def test_viterbi_kernel_long_trellis(dev):
    """A trellis too long for 4 frames a warp: fewer frames share one."""
    llr = _llrs(5, 9000, seed=3, kind="random").to(dev)
    assert torch.equal(k2.viterbi_decode(llr, True), k2.viterbi_decode_plain(llr, True))


def _rand(shape, seed, cplx):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        return torch.from_numpy((x + 1j * rng.standard_normal(shape)).astype(np.complex64))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n_taps,shape", [(5, (2, 300)), (48, (2, 300)), (129, (2, 300)),
                                          (200, (3, 5000)), (1000, (2, 3000)),
                                          (65, (4, 1 << 20))])
def test_fir_kernel_matches_plain(dev, n_taps, shape, cplx):
    """atol 2e-4, the Pallas FIR tests' tolerance (taps scaled to unit
    energy past 129 taps, so the sums stay at the scale of those cases)."""
    taps = np.random.default_rng(n_taps).standard_normal(n_taps).astype(np.float32)
    if n_taps > 129:
        taps /= np.sqrt(n_taps)
    x = _rand(shape, 7, cplx).to(dev)
    want = k34.fir_filter_plain(x, taps)
    before = k34.fir_filter.launches
    got = k34.fir_filter(x, taps)
    torch.cuda.synchronize()
    assert k34.fir_filter.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def test_fir_kernel_keeps_rows_apart(dev):
    x = torch.zeros(2, 256, device=dev)
    x[0, 250] = 1.0
    got = k34.fir_filter(x, np.ones(64, np.float32))
    assert got[1].abs().max().item() == 0.0
    assert got[0, 250:].min().item() == 1.0


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("interp,decim", [(1, 2), (2, 1), (3, 4), (4, 3), (5, 2), (2, 3)])
@pytest.mark.parametrize("shape", [(600,), (2, 4, 90), (3, 70_001)])
def test_resample_kernel_matches_plain(dev, interp, decim, shape, cplx):
    taps = ops.design_lowpass(interp, decim)
    x = _rand(shape, interp * 10 + decim, cplx).to(dev)
    want = k34.polyphase_resample_plain(x, interp, decim, taps)
    before = k34.polyphase_resample.launches
    got = k34.polyphase_resample(x, interp, decim, taps)
    torch.cuda.synchronize()
    assert k34.polyphase_resample.launches == before + 1
    assert got.dtype == x.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n_taps", [1, 65, 256, 257, 1000])
@pytest.mark.parametrize("n", [2047, 2048, 2049, 4097])
def test_fir_kernel_at_tile_edges_and_tap_capacity(dev, n, n_taps, cplx):
    """Rows one short of, at, one past the 2048-output tile and past two
    tiles; taps up to one 256-tap chunk and past it (more chunks through
    shared memory). atol 2e-4, taps at unit energy."""
    taps = (np.random.default_rng(n_taps).standard_normal(n_taps) / np.sqrt(n_taps)).astype(
        np.float32)
    x = _rand((3, n), n + n_taps, cplx).to(dev)
    for h in (taps, torch.from_numpy(taps).to(dev)):
        before = k34.fir_filter.launches
        got = k34.fir_filter(x, h)
        torch.cuda.synchronize()
        assert k34.fir_filter.launches == before + 1
        torch.testing.assert_close(got, k34.fir_filter_plain(x, taps), atol=2e-4, rtol=0)


@pytest.mark.parametrize("cplx", [False, True])
def test_fir_kernel_unaligned_rows(dev, cplx):
    """Rows that start off a 16-byte boundary take one-element copies."""
    taps = np.random.default_rng(3).standard_normal(65).astype(np.float32) / 8
    flat = _rand((3 * 5001 + 1,), 4, cplx).to(dev)
    x = flat[1:].view(3, 5001)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    torch.testing.assert_close(k34.fir_filter(x, taps), k34.fir_filter_plain(x, taps),
                               atol=2e-4, rtol=0)


def test_fir_kernel_past_65535_rows(dev):
    taps = np.random.default_rng(5).standard_normal(65).astype(np.float32) / 8
    x = _rand((70_000, 40), 5, True).to(dev)
    torch.testing.assert_close(k34.fir_filter(x, taps), k34.fir_filter_plain(x, taps),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("interp,decim", [(3, 4), (1, 2), (2, 1)])
@pytest.mark.parametrize("n", [2047, 2048, 2049, 4097, 2730, 2731, 2732, 5462])
def test_resample_kernel_at_tile_edges(dev, n, interp, decim, cplx):
    """Input rows and output rows (2730-2732 and 5462 give 2048, 2049 and
    4097 outputs at 3/4) around the 2048-output tile; atol 2e-4."""
    taps = ops.design_lowpass(interp, decim)
    x = _rand((3, n), n + interp, cplx).to(dev)
    for h in (taps, torch.from_numpy(taps).to(dev)):
        before = k34.polyphase_resample.launches
        got = k34.polyphase_resample(x, interp, decim, h)
        torch.cuda.synchronize()
        assert k34.polyphase_resample.launches == before + 1
        torch.testing.assert_close(got, k34.polyphase_resample_plain(x, interp, decim, taps),
                                   atol=2e-4, rtol=0)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("interp,decim,tpp", [(1, 96, 12), (1, 5000, 12), (3, 4, 16),
                                              (7, 5, 9), (1, 2, 7000)])
def test_resample_kernel_small_tiles_and_other_phase_lengths(dev, interp, decim, tpp, cplx):
    """Ratios whose span shrinks the tile (1/96, 1/5000), phase rows other
    than 12 (the generic loop), and 7000 taps a phase, which outgrow half
    the span's room and go in restaged passes; atol 2e-4."""
    taps = ops.design_lowpass(interp, decim, tpp)
    x = _rand((2, 20_000), decim + tpp, cplx).to(dev)
    got = k34.polyphase_resample(x, interp, decim, taps)
    torch.testing.assert_close(got, k34.polyphase_resample_plain(x, interp, decim, taps),
                               atol=2e-4, rtol=0)


def test_resample_kernel_past_65535_rows(dev):
    taps = ops.design_lowpass(3, 4)
    x = _rand((70_000, 50), 6, True).to(dev)
    torch.testing.assert_close(k34.polyphase_resample(x, 3, 4, taps),
                               k34.polyphase_resample_plain(x, 3, 4, taps), atol=2e-4, rtol=0)


def test_resample_kernel_past_the_int32_index_range(dev):
    """25001/25000 on a 200 000-sample tone: j * M passes 2**31 at output
    85 900; kernel = plain (atol 2e-4) and = the analytic tone (1e-3)."""
    f, n = 0.01, 200_000
    x = torch.from_numpy(np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)).to(dev)
    got = ops.rational_resampler(x, 25001, 25000)
    taps = ops.design_lowpass(25001, 25000)
    torch.testing.assert_close(got, k34.polyphase_resample_plain(x, 25001, 25000, taps),
                               atol=2e-4, rtol=0)
    j = np.arange(200, got.shape[-1] - 200)
    want = np.exp(2j * np.pi * f * j * (25000 / 25001))
    assert np.abs(got[200:-200].cpu().numpy() - want).max() < 1e-3


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        k1.sync_stats(torch.zeros(10, device=dev))
    x = torch.zeros(2, 4096, dtype=torch.complex64, device=dev)
    for mp in (0, k1.MAX_PLATEAU + 1):
        with pytest.raises(ValueError):
            k1.sync_detect(x, 4, 0.56, mp)
    with pytest.raises(TypeError):
        k1.sync_detect(x.to(torch.complex128), 4, 0.56, 2)
    with pytest.raises(ValueError):
        k1.sync_detect(x.t(), 4, 0.56, 2)
    with pytest.raises(TypeError):
        k2.viterbi_decode_many([torch.zeros(2, 5, 2, device=dev, dtype=torch.float64)], [True])
    with pytest.raises(ValueError):
        k2.viterbi_decode_many([torch.zeros(2, 2, 5, device=dev).transpose(1, 2)], [True])
    with pytest.raises(ValueError):
        k2.viterbi_decode(torch.zeros(2, 5, 3, device=dev))
    with pytest.raises(TypeError):
        k34.fir_filter(torch.zeros(10, dtype=torch.float64, device=dev), np.ones(3))
    with pytest.raises(ValueError):
        k34.polyphase_resample(torch.zeros(4, 10, device=dev).t(), 3, 4,
                               ops.design_lowpass(3, 4))
