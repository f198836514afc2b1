"""Stage B by length class: frames of different PSDU lengths in one bucket.

The adaptive executor buckets its candidates by (rate, length class)
(``parallel/executor.py``: ``length_classes``, ``_Candidates.buckets``),
so one stage-B decode, one graph and one Viterbi launch carry frames of
many lengths, each at its own length. Held here, on the CPU:

  (a) on a seeded 2-channel stream of 36 frames at all 8 rates and PSDUs
      of 28 to 1 554 bytes, several lengths to a class, the port's records
      are the JAX package's ``AdaptiveStreamExecutor``'s (which decodes
      every (rate, length) on its own) to the tolerances of
      test_torch_adaptive.py: psdu, rate, length and parity exact, cfo
      1e-5 rad/sample, snr 1e-3 dB, the captured symbols 1e-4 and each
      frame's own n_sym of them;
  (b) the same records against the plain float64 receiver
      (plain_track_rx.py, LMS with mu 0: the LTF estimate with the pilots'
      phase, the port's LS) frame by frame at each frame's exact length;
  (c) K2's plain version with per-frame trellis lengths: each frame of a
      call bit for bit that frame decoded alone (and the kernel, on the
      card);
  (d) the graph keys of a stream of 200+ distinct lengths within the bound
      stated where they are made (and, on the card, a second run captures
      nothing);
  (e) the ``stage_b_slots`` and ``stage_b_symbols`` counters on a known
      bucket.

On the card (marker ``cuda``): ``python -m pytest --noconftest -m cuda
tests/test_torch_length_classes.py``; the JAX comparison skips there.
"""

import numpy as np
import plain_track_rx as plain
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig, PhyConfig
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import AdaptiveStreamExecutor
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import executor as pexec
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.graphs import GraphCache
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params, tx

torch.set_num_threads(2)

MAX_PSDU = 1554
# per channel: (mcs, length); at each rate two or three lengths share a
# length class (MCS 0's 28 and 60 bytes, MCS 7's 1 200 and 1 554, ...);
# 1 554 bytes is a 12 454-step trellis at any rate
FRAMES = [(0, 28), (0, 60), (1, 200), (1, 230), (2, 500), (2, 640), (3, 900), (3, 1100),
          (4, 1300), (4, 1500), (5, 94), (5, 150), (6, 700), (6, 760), (7, 40), (7, 1200),
          (7, 1554), (0, 400)]
CFG = dict(block_size=16384, time_shards=16, max_frames_per_block=8)   # one step
# snr_db against the plain float64 receiver: both sync as sync_short and
# sync_long define it and take the same decision-directed EVM over the
# frame's own symbols, the port in float32 and the plain receiver in
# float64, so they differ by rounding alone (at most 5.3e-6 dB on this
# stream); the tolerance is the JAX comparison's
SNR_PLAIN_DB = 1e-3


def _stream(seed=27, gap=(600, 2400), snr_db=30.0):
    """(x (2, n) complex64, truth [(channel, start, mcs, psdu)]): FRAMES on
    each channel in a shuffled order, the port's TX, random bytes."""
    rng = np.random.default_rng(seed)
    rows, truth = [], []
    for ch in range(2):
        pos, row = 400, []
        for i in rng.permutation(len(FRAMES)):
            mcs, length = FRAMES[i]
            psdu = rng.integers(0, 256, length, dtype=np.uint8)
            burst = tx.transmit(psdu, mcs, scrambler_seed=int(rng.integers(1, 128)),
                                device="cpu").numpy()
            row.append((pos, burst))
            truth.append((ch, pos, mcs, psdu))
            pos += burst.size + int(rng.integers(*gap))
        rows.append((pos, row))
    n = -(-max(p for p, _ in rows) // 262144) * 262144
    x = np.zeros((2, n), np.complex64)
    for ch, (_, row) in enumerate(rows):
        for pos, burst in row:
            x[ch, pos: pos + burst.size] += 0.5 * burst
    sd = 0.5 * 10 ** (-snr_db / 20) / np.sqrt(2)
    x += (sd * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
          ).astype(np.complex64)
    return x, truth


@pytest.fixture(scope="module")
def port_run():
    """The stream, its truth, the port's records (captured symbols) and
    the stage-B buckets' (mcs, class, [lengths]) on the CPU."""
    x, truth = _stream()
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(**CFG),
                                phy_cfg=PhyConfig(max_psdu_bytes=MAX_PSDU),
                                capture_symbols=True, device="cpu")
    buckets = []
    decode = ex.bucket_decode

    def spy(plan, windows, scalars):
        buckets.append((plan.mcs, plan.n_sym, sorted({int(v) for v in scalars[:, 3] if v})))
        return decode(plan, windows, scalars)

    ex.bucket_decode = spy
    return x, truth, ex.run(x), buckets


def test_buckets_hold_several_lengths(port_run):
    _, truth, recs, buckets = port_run
    assert sum(r.parity_ok for r in recs) == len(truth) == 2 * len(FRAMES)
    mixed = [b for b in buckets if len(b[2]) > 1]
    assert len(mixed) >= 8 and {b[0] for b in mixed} == set(range(8))
    for mcs, n_sym, lengths in buckets:
        assert all(params.n_symbols(mcs, ln) <= n_sym for ln in lengths)
        assert n_sym in pexec.length_classes(MAX_PSDU)[mcs]


def test_records_match_jax(port_run):
    if torch.cuda.is_available():
        pytest.skip("the JAX package does not run on a card host")
    pytest.importorskip("jax")
    from gnuradio_wifi_imagetransfer_tpu import config as jconfig
    from gnuradio_wifi_imagetransfer_tpu.parallel import AdaptiveStreamExecutor as JAdaptive

    x, truth, got, _ = port_run
    want = JAdaptive(mesh=None, exec_cfg=jconfig.ExecutorConfig(**CFG),
                     phy_cfg=jconfig.PhyConfig(max_psdu_bytes=MAX_PSDU),
                     capture_symbols=True).run(x)
    assert len(got) == len(want) >= len(truth)
    for g, w in zip(got, want):
        assert (g.channel, g.global_start, g.rate_idx, g.length, g.parity_ok) == (
            w.channel, w.global_start, w.rate_idx, w.length, w.parity_ok)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.cfo - w.cfo) <= 1e-5
        assert abs(g.snr_db - w.snr_db) <= 1e-3
        assert g.eq_symbols.shape == w.eq_symbols.shape == (
            tx.tx_plan(g.rate_idx, g.length).n_sym, 48)
        np.testing.assert_allclose(g.eq_symbols, w.eq_symbols, atol=1e-4, rtol=0)


def test_records_match_the_plain_receiver_at_exact_length(port_run):
    x, truth, recs, _ = port_run
    by_key: dict = {}
    for ch, pos, mcs, psdu in truth:
        (rec,) = [r for r in recs if r.channel == ch and 0 <= r.global_start - pos < 160]
        by_key.setdefault((mcs, psdu.size), []).append((ch, pos, psdu, rec))
    for (mcs, length), frames in by_key.items():        # one plain call a (rate, length)
        w = plain.SEARCH + 64 + 401 + 80 * (1 + tx.tx_plan(mcs, length).n_sym) + 16
        seg = np.stack([x[ch, pos - plain.SEARCH: pos - plain.SEARCH + w]
                        for ch, pos, _, _ in frames])
        res = plain.receive(torch.from_numpy(seg.astype(np.complex128)), mcs, length,
                            algo="LMS", mu=0.0)
        for k, (_, _, psdu, rec) in enumerate(frames):
            assert res["signal"][k] == (rec.rate_idx, rec.length, rec.parity_ok) == (
                mcs, length, True)
            assert np.array_equal(res["psdu"][k], rec.psdu) and np.array_equal(rec.psdu, psdu)
            assert abs(float(res["snr_db"][k]) - rec.snr_db) <= SNR_PLAIN_DB, (
                mcs, length, float(res["snr_db"][k]), rec.snr_db)


# -- (c) K2 with per-frame trellis lengths ------------------------------------


def _llrs(b, n, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, n, 2), generator=g) * 3.0).contiguous()


@pytest.mark.parametrize("n,lengths", [(300, [300, 1, 57, 128, 299, 200, 22]),
                                       (1000, [1000, 422, 999, 23, 640])])
def test_plain_viterbi_rows_of_their_own_length(n, lengths):
    llr = _llrs(len(lengths), n, n)
    own = torch.tensor(lengths, dtype=torch.int32)
    got = k2.viterbi_decode_plain(llr, True, own)
    sig = _llrs(len(lengths), 24, 1)
    many = k2.viterbi_decode_many_plain([sig, llr], [True, True], [None, own])
    assert torch.equal(many[1], got)
    assert torch.equal(many[0], k2.viterbi_decode_plain(sig, True))
    for i, ln in enumerate(lengths):
        alone = k2.viterbi_decode_plain(llr[i: i + 1, :ln].contiguous(), True)
        assert torch.equal(got[i, :ln], alone[0])
        assert not got[i, ln:].any()
    with pytest.raises(ValueError):
        k2.viterbi_decode_plain(llr, False, own)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [422, 5000, 12454])
def test_kernel_rows_of_their_own_length_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n)
    lengths = [n, 1, 22, n - 1] + rng.integers(1, n + 1, 13).tolist()
    llr = _llrs(len(lengths), n, n)
    own = torch.tensor(lengths, dtype=torch.int32)
    sig = _llrs(len(lengths), 24, 2)
    dev = torch.device("cuda")
    got = k2.viterbi_decode_many([sig.to(dev), llr.to(dev)], [True, True],
                                 [None, own.to(dev)])
    want = k2.viterbi_decode_many_plain([sig, llr], [True, True], [None, own])
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    for i, ln in enumerate(lengths[:6]):
        alone = k2.viterbi_decode(llr[i: i + 1, :ln].contiguous().to(dev), True)
        assert torch.equal(got[1][i, :ln].cpu(), alone[0].cpu())


# -- (d) the graph keys -------------------------------------------------------


def _many_lengths(n, seed=5, max_psdu=MAX_PSDU):
    rng = np.random.default_rng(seed)
    length = rng.permutation(np.arange(1, max_psdu + 1))[:n]
    return pexec._Candidates(
        channel=rng.integers(0, 4, n), global_start=np.arange(n, dtype=np.int64) * 50,
        cfo=np.zeros(n, np.float32), frame_start=np.full(n, 160),
        rate_idx=rng.integers(0, 8, n), length=length)


@pytest.mark.parametrize("max_psdu", [200, 800, MAX_PSDU])
def test_graph_keys_stay_within_the_bound(monkeypatch, max_psdu):
    cands = _many_lengths(min(1200, max_psdu), max_psdu=max_psdu)
    assert len(np.unique(cands.length)) >= 200
    # every (rate, class, rows) key the executor can make, and the step's
    everything = {(m, c, r) for m, cs in enumerate(pexec.length_classes(max_psdu))
                  for c in cs for r in pexec.ROW_SIZES}
    assert len(everything) == pexec.stage_b_key_count(max_psdu)
    assert pexec.stage_b_key_count(max_psdu) + 1 <= GraphCache.MAX_GRAPHS
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(block_size=4096, time_shards=2),
                                phy_cfg=PhyConfig(max_psdu_bytes=max_psdu), device="cpu")
    ex._dev_stream = torch.zeros((4, 200_000, 2), dtype=torch.int16)
    keys, rows = set(), 0

    def spy(plan, windows, scalars):
        nonlocal rows
        keys.add((plan.mcs, plan.n_sym, windows.shape[0]))
        rows += int((scalars[:, 3] > 0).sum())
        return torch.zeros((windows.shape[0], plan.psdu_len + 2))

    monkeypatch.setattr(ex, "bucket_decode", spy)
    ex._stage_b_dispatch(np.zeros((4, 1), np.complex64), cands)
    assert keys <= everything and rows == len(cands)
    assert {k[:2] for k in keys} == {k[:2] for k in everything}     # every class reached


def test_an_executor_refuses_more_keys_than_the_cache_holds():
    big = 4095                  # Clause 17's longest PSDU
    assert pexec.stage_b_key_count(big) + 1 > GraphCache.MAX_GRAPHS
    with pytest.raises(ValueError, match="graph keys"):
        AdaptiveStreamExecutor(phy_cfg=PhyConfig(max_psdu_bytes=big), device="cpu")


@pytest.mark.cuda
def test_a_second_run_captures_nothing_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    n, pos, x = 1 << 21, 400, None
    x = np.zeros((1, n), np.complex64)
    lengths = rng.permutation(np.arange(28, MAX_PSDU + 1))[:240]
    sent = []
    for ln in lengths:
        mcs = int(rng.integers(0, 8))
        psdu = rng.integers(0, 256, int(ln), dtype=np.uint8)
        burst = tx.transmit(psdu, mcs, device="cpu").numpy()
        if pos + burst.size + 2000 > n:
            break
        x[0, pos: pos + burst.size] = 0.5 * burst
        sent.append((mcs, psdu.tobytes()))
        pos += burst.size + int(rng.integers(200, 2000))
    x += (0.005 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
          ).astype(np.complex64)
    assert len({len(p) for _, p in sent}) >= 200
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(block_size=1 << 17, time_shards=16,
                                                        max_frames_per_block=32),
                                phy_cfg=PhyConfig(max_psdu_bytes=MAX_PSDU), device="cuda")
    first = ex.run(x)
    captured = ex.graphs.captured
    second = ex.run(x)
    assert ex.graphs.captured == captured <= GraphCache.MAX_GRAPHS
    assert captured <= pexec.stage_b_key_count(MAX_PSDU) + 1
    assert [(r.global_start, r.psdu.tobytes()) for r in first] == [
        (r.global_start, r.psdu.tobytes()) for r in second]
    assert set(sent) <= {(r.rate_idx, r.psdu.tobytes()) for r in second if r.parity_ok}


# -- (e) the counters ---------------------------------------------------------


def test_stage_b_counters_on_a_known_bucket():
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(block_size=4096, time_shards=2),
                                device="cpu")
    ex._dev_stream = torch.zeros((1, ex.padded_out_len(8192), 2), dtype=torch.int16)
    lengths = np.array([100, 50, 60])           # MCS 2: 18, 9 and 11 data symbols
    bucket = pexec._Candidates(
        channel=np.zeros(3, np.int64), global_start=np.array([500, 3000, 6000]),
        cfo=np.zeros(3, np.float32), frame_start=np.full(3, 160),
        rate_idx=np.full(3, 2), length=lengths)
    (got,) = bucket.buckets(ex.phy.max_psdu_bytes)
    assert got.length.tolist() == [100, 60, 50]      # longest first
    _, plan, packed = ex._dispatch_bucket(np.zeros((1, 8192), np.complex64), got)
    assert plan.n_sym == 34 and packed.shape[0] == 3      # MCS 2's smallest class at 800
    report = ex.tracer.report()
    slots, symbols = report["stage_b_slots"], report["stage_b_symbols"]
    assert (slots.calls, slots.frames, slots.samples) == (1, 3, pexec.ROW_SIZES[0] * 34)
    assert (symbols.calls, symbols.frames, symbols.samples) == (1, 3, 18 + 11 + 9)
