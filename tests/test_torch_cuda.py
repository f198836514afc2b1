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


# -- the SIGNAL-steered path, the trackers and the CRC on the card -----------


def _adaptive_stream(seed, n=4 * 8192, snr_db=25):
    """One channel of MCS 0 / 3 / 7 frames (the port's TX) in seeded noise,
    one of them straddling the first block seam."""
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

    rng = np.random.default_rng(seed)
    x = np.zeros(n, np.complex64)
    sent = []
    for i, (pos, mcs, ln) in enumerate([(600, 0, 50), (8000, 3, 120), (15000, 7, 50),
                                        (24000, 3, 50)]):
        payload = rng.integers(0, 256, (1, ln), dtype=np.uint8)
        b = tx.transmit(payload, mcs, scrambler_seed=i + 1, device="cpu")[0].numpy()
        x[pos: pos + b.size] += 0.5 * b
        sent.append((mcs, tuple(payload[0])))
    sigma = 0.5 * 10 ** (-snr_db / 20) / np.sqrt(2)
    x += (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    return x[None], sent


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.global_start, g.rate_idx, g.length, g.parity_ok) == (
            w.channel, w.global_start, w.rate_idx, w.length, w.parity_ok)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.cfo - w.cfo) <= 1e-5
        assert abs(g.snr_db - w.snr_db) <= 1e-3


@pytest.mark.parametrize("wire", ["sc16", "sc8"])
@pytest.mark.parametrize("algo", ["LS", "LMS"])
def test_adaptive_executor_on_cuda_equals_cpu(dev, algo, wire):
    from gnuradio_wifi_imagetransfer_tpu_torch.config import (
        ChannelEstimator, ExecutorConfig, PhyConfig)
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import AdaptiveStreamExecutor

    x, sent = _adaptive_stream(3)
    kw = dict(exec_cfg=ExecutorConfig(block_size=8192, time_shards=2, max_frames_per_block=4,
                                      wire_format=wire),
              phy_cfg=PhyConfig(chan_est=ChannelEstimator[algo]))
    k1.sync_detect.launches = k2.viterbi_decode.launches = k2.viterbi_decode_many.launches = 0
    ex = AdaptiveStreamExecutor(device=dev, **kw)
    got = ex.run(x)
    torch.cuda.synchronize()
    # 2 steps: a detector and a SIGNAL Viterbi launch each; one payload
    # launch a (rate, length class) bucket
    assert (k1.sync_detect.launches, k2.viterbi_decode.launches) == (2, 2)
    assert k2.viterbi_decode_many.launches == ex.tracer.report()["stage_b_slots"].calls >= 1
    _same_records(got, AdaptiveStreamExecutor(device="cpu", **kw).run(x))
    assert set(sent) <= {(r.rate_idx, tuple(r.psdu)) for r in got if r.parity_ok}


@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
def test_mesh_on_a_one_rank_nccl_group_equals_cpu(dev, kind):
    """A (1, 4) mesh over a one-rank NCCL group on the card gives the
    records of the same mesh on the CPU (group=None): the gather, the
    sharded step and stage B from host-cut windows."""
    import socket

    import torch.distributed as dist

    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
        AdaptiveStreamExecutor, StreamExecutor, make_mesh)
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

    x, sent = _adaptive_stream(5)
    cfg = ExecutorConfig(block_size=4096, time_shards=4, max_frames_per_block=4,
                         wire_format="sc16")

    def make(mesh, device):
        if kind == "fixed":
            return StreamExecutor(tx.tx_plan(2, 50), mesh=mesh, exec_cfg=cfg, device=device)
        return AdaptiveStreamExecutor(mesh=mesh, exec_cfg=cfg, device=device)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        k1.sync_detect.launches = 0
        got = make(make_mesh(1, 4, group=dist.group.WORLD), dev).run(x)
        torch.cuda.synchronize()
        assert k1.sync_detect.launches > 0
    finally:
        dist.destroy_process_group()
    _same_records(got, make(make_mesh(1, 4), "cpu").run(x))
    if kind == "adaptive":
        assert set(sent) <= {(r.rate_idx, tuple(r.psdu)) for r in got if r.parity_ok}


def test_adaptive_receiver_on_cuda_equals_cpu(dev):
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import AdaptiveReceiver

    x, sent = _adaptive_stream(4, n=1 << 15)
    got = AdaptiveReceiver(max_psdu=256, max_frames=8, device=dev).receive(x[0])
    want = AdaptiveReceiver(max_psdu=256, max_frames=8, device="cpu").receive(x[0])
    assert len(got) == len(want) == len(sent)
    for g, w in zip(got, want):
        assert (g.start, g.rate_idx, g.length) == (w.start, w.rate_idx, w.length)
        assert np.array_equal(g.psdu, w.psdu) and abs(g.cfo - w.cfo) <= 1e-5
    assert set(sent) == {(f.rate_idx, tuple(f.psdu)) for f in got}


@pytest.mark.parametrize("shape", [(1, 5), (300, 46), (4, 3, 828)])
def test_crc32_on_cuda_equals_zlib(dev, shape):
    import zlib

    from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac

    data = np.random.default_rng(shape[-1]).integers(0, 256, shape, dtype=np.uint8)
    got = mac.crc32(torch.from_numpy(data).to(dev))
    assert got.device.type == "cuda"
    want = [zlib.crc32(r.tobytes()) for r in data.reshape(-1, shape[-1])]
    assert got.cpu().reshape(-1).tolist() == want
    mpdus = torch.from_numpy(mac.frame_batch(data.reshape(-1, shape[-1]))).to(dev)
    assert bool(mac.check_fcs_batch(mpdus).all())
    mpdus[:, 7] ^= 4
    assert not bool(mac.check_fcs_batch(mpdus).any())


@pytest.mark.parametrize("mcs", [None, 0, 2, 7])
@pytest.mark.parametrize("algo", ["LS", "LMS", "COMB", "STA"])
def test_equalize_on_cuda_within_1e4_of_cpu(dev, algo, mcs):
    from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import equalizer, mapping

    rng = np.random.default_rng(8)
    y = (rng.standard_normal((6, 30, 64)) + 1j * rng.standard_normal((6, 30, 64))) * 0.05
    y += mapping.map_bits(torch.from_numpy(rng.integers(0, 2, (6, 30, 128), dtype=np.uint8)),
                          2).numpy().reshape(6, 30, 64) * np.exp(0.3j)
    h0 = np.exp(0.3j) * (1 + 0.1 * rng.standard_normal((6, 52)))
    y, h0 = torch.from_numpy(y.astype(np.complex64)), torch.from_numpy(h0.astype(np.complex64))
    for idx0 in (0, 1):
        want = equalizer.equalize(y, h0, idx0, ChannelEstimator[algo], mcs)
        got = equalizer.equalize(y.to(dev), h0.to(dev), idx0, ChannelEstimator[algo], mcs)
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=0)


# -- the radios on the card ---------------------------------------------------


def _radio_pieces(seed, shape=(30, 30, 3)):
    from gnuradio_wifi_imagetransfer_tpu_torch.utils import image

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    return img, image.detach_image(img, rng=rng)


def _radio_run(in_port, out_sock, pieces, img, spacing):
    """Send the pieces to in_port; the canvas drawn from out_sock."""
    import pickle
    import socket
    import time

    from gnuradio_wifi_imagetransfer_tpu_torch.utils import image

    tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for p in pieces:
        tx_sock.sendto(image.encode_piece(p), ("127.0.0.1", in_port))
        time.sleep(spacing)
    tx_sock.close()
    canvas, seen = np.zeros_like(img), set()
    while len(seen) < len(pieces):
        piece = pickle.loads(out_sock.recvfrom(65536)[0])
        image.redraw_image(piece, canvas)
        seen.add(piece[0])
    return canvas


def _out_socket():
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    s.bind(("127.0.0.1", 0))
    s.settimeout(60.0)
    return s


def test_loopback_radio_on_cuda(dev):
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import LoopbackRadio

    build.library()                     # nvcc before the radio thread's first launch
    img, pieces = _radio_pieces(21)      # 27 pieces
    out = _out_socket()
    k1.sync_detect.launches = k2.viterbi_decode_many.launches = 0
    radio = LoopbackRadio(in_port=0, out_port=out.getsockname()[1], device=dev).start()
    try:
        canvas = _radio_run(radio.in_port, out, pieces, img, 0.002)
        assert np.array_equal(canvas, img)
        assert radio.stats["frames_ok"] == len(pieces)
        assert k1.sync_detect.launches > 0 and k2.viterbi_decode_many.launches > 0
    finally:
        radio.stop()
        out.close()


def test_tx_radio_into_rx_radio_on_cuda(dev):
    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import RxRadio, TxRadio

    build.library()
    img, pieces = _radio_pieces(22)
    out = _out_socket()
    k1.sync_detect.launches = k2.viterbi_decode.launches = k2.viterbi_decode_many.launches = 0
    rxr = RxRadio(samp_port=0, out_port=out.getsockname()[1], chunk=1 << 15,
                  exec_cfg=ExecutorConfig(block_size=1 << 14, time_shards=4,
                                          max_frames_per_block=8), device=dev).start()
    txr = TxRadio(in_port=0, samp_port=rxr.samp_port, device=dev).start()
    try:
        canvas = _radio_run(txr.in_port, out, pieces, img, 0.01)
        assert np.array_equal(canvas, img)
        assert rxr.stats["frames_ok"] == len(pieces) and rxr.stats["frames_crc_fail"] == 0
        assert k1.sync_detect.launches > 0 and k2.viterbi_decode.launches > 0
        assert k2.viterbi_decode_many.launches > 0
        assert rxr.constellation.points().shape[0] > 0 and np.isfinite(rxr.snr_probe.snr_db())
    finally:
        txr.stop()
        rxr.stop()
        out.close()


def test_dqn_agent_on_cuda_matches_cpu(dev):
    """tests/test_control.py's bandit, 150 steps on the card and on the CPU
    from one set of initial parameters and one environment: equal actions,
    losses within 1e-5 relative; none of the four kernels launches."""
    from gnuradio_wifi_imagetransfer_tpu_torch.control import DqnAgent, DqnConfig, IrsPowerEnv

    env = IrsPowerEnv(n_grid=3, obs_dim=4, device=dev)
    cfg = DqnConfig(obs_dim=4, n_actions=env.n_actions, batch_size=32, buffer_size=2000,
                    eps_decay_steps=300, gamma=0.0, learning_rate=3e-3, target_update=25)
    kernels = (k1.sync_stats, k1.sync_detect, k2.viterbi_decode, k2.viterbi_decode_many,
               k34.fir_filter, k34.polyphase_resample)
    before = [k.launches for k in kernels]
    init, runs = None, []
    for d in (dev, torch.device("cpu")):
        agent = DqnAgent(cfg, seed=1, device=d)
        if init is None:
            init = {k: v.detach().cpu().clone() for k, v in agent.net.state_dict().items()}
        agent.net.load_state_dict(init)
        agent.target.load_state_dict(init)
        obs, actions, losses = env.reset(), [], []
        for _ in range(150):
            a = agent.act(obs)
            next_obs, r = env.step(a)
            losses.append(agent.observe(obs, a, r, next_obs, 0.0))
            actions.append(a)
            obs = next_obs
        runs.append((actions, losses))
    (act_c, loss_c), (act_h, loss_h) = runs
    assert act_c == act_h
    for c, h in zip(loss_c, loss_h):
        assert (c is None and h is None) or abs(c - h) <= 1e-5 * abs(h)
    assert [k.launches for k in kernels] == before


def test_masked_autoencoder_on_cuda_matches_cpu(dev):
    """A small MaskedAutoencoderViT on the card against the CPU path on the
    same weights and noise: mask and ids exactly, loss and pred within
    1e-4 of their peak."""
    from gnuradio_wifi_imagetransfer_tpu_torch.models import MaskedAutoencoderViT

    def make(d):
        return MaskedAutoencoderViT(img_size=32, patch_size=8, embed_dim=64, depth=2,
                                    num_heads=4, decoder_embed_dim=32, decoder_depth=1,
                                    decoder_num_heads=4, device=d).eval()

    torch.manual_seed(0)
    card, host = make(dev), make("cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    imgs = torch.randn(2, 3, 32, 32)
    noise = torch.rand(2, 16, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    outs = []
    with torch.no_grad():
        for m, d in ((card, dev), (host, torch.device("cpu"))):
            x = imgs.to(d)
            lat, mask, ids = m.forward_encoder(x, 0.75, noise.to(d))
            pred = m.forward_decoder(lat, ids)
            outs.append([t.cpu() for t in (m.forward_loss(x, pred, mask), pred, mask, ids)])
    (l_c, p_c, m_c, i_c), (l_h, p_h, m_h, i_h) = outs
    assert torch.equal(m_c, m_h) and torch.equal(i_c, i_h)
    torch.testing.assert_close(l_c, l_h, rtol=1e-4, atol=0)
    torch.testing.assert_close(p_c, p_h, rtol=0, atol=1e-4 * float(p_h.abs().max()))


def test_multichip_dryrun_over_two_cards(dev, tmp_path):
    """multichip_torch.py --procs 2 --dryrun, one NCCL rank a card: every
    leg passes on both ranks (JAX's dry-run shapes), rank 0 holds K1 and
    K2, and both ranks launched the detector."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (one NCCL rank a card)")
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, str(repo / "multichip_torch.py"), "--procs", "2",
                        "--dryrun", "--timeout", "300", "--out", str(tmp_path / "mc.json")],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    legs = json.loads(r.stdout.strip().splitlines()[-1])["worlds"]["2"]
    for label in ("fixed", "adaptive", "frontend"):
        leg = legs[label]
        assert leg["mesh"] == [2, 1] and leg["good"] == leg["sent"] and leg["equal_local"]
        assert "sync_detect" in leg["held"]
        assert all(n["sync_detect"] == leg["steps"] for n in leg["launches"])
    assert legs["train"]["replicas_equal"]
