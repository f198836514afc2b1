"""The port's SIGNAL-steered reception (AdaptiveStreamExecutor and
AdaptiveReceiver) against the JAX package on the CPU, on the local
scenarios of tests/test_adaptive_executor.py, tests/test_frontend.py and
tests/test_adaptive.py.

Executor records must be the same FrameRecords: channel, global_start,
rate_idx, length, parity_ok and psdu exactly; cfo within 1e-5 rad/sample,
snr_db within 1e-3 dB and captured eq_symbols within 1e-4 (float32
arithmetic of two libraries). Receiver frames: start, rate_idx, length
and psdu exactly, cfo within 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.channel.model import sample_clock_offset
from gnuradio_wifi_imagetransfer_tpu.parallel import AdaptiveReceiver as JReceiver
from gnuradio_wifi_imagetransfer_tpu.parallel import AdaptiveStreamExecutor as JAdaptive
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu_torch.config import (
    ChannelEstimator,
    ExecutorConfig,
    FrontendConfig,
    PhyConfig,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
    AdaptiveReceiver,
    AdaptiveStreamExecutor,
    make_mesh,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import executor as pexec
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import HALO_LEFT, StageAOutputs
from gnuradio_wifi_imagetransfer_tpu_torch.phy import rx, sync, tx
from gnuradio_wifi_imagetransfer_tpu_torch.utils import tracing

torch.set_num_threads(2)


def _mixed_stream(n_samples, specs, seed=0, snr_db=30):
    """specs: (pos, mcs, payload) per frame -> a noise-floored stream (the
    JAX package's TX makes the bursts, as tests/test_adaptive_executor.py
    does)."""
    rng = np.random.default_rng(seed)
    x = np.zeros(n_samples, np.complex64)
    for i, (pos, mcs, payload) in enumerate(specs):
        b = np.asarray(jtx.transmit(jnp.asarray(payload)[None], mcs,
                                    scrambler_seed=(i % 127) + 1))[0]
        x[pos: pos + b.size] += 0.5 * b
    noise = 0.5 * 10 ** (-snr_db / 20) / np.sqrt(2)
    x = x + noise * (rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples))
    return x.astype(np.complex64)


def _specs(seed=7):
    """Interleaved MCS 0 / 3 / 7 frames with two distinct lengths."""
    rng = np.random.default_rng(seed)
    return [(600, 0, rng.integers(0, 256, 50, dtype=np.uint8)),
            (4000, 3, rng.integers(0, 256, 120, dtype=np.uint8)),
            (7000, 7, rng.integers(0, 256, 50, dtype=np.uint8)),
            (10500, 3, rng.integers(0, 256, 50, dtype=np.uint8))]


def _run_both(stream, capture_symbols=False, phy=None, **cfg):
    jphy = jconfig.PhyConfig() if phy is None else jconfig.PhyConfig(
        **{k: (jconfig.ChannelEstimator(int(v)) if k == "chan_est" else v)
           for k, v in phy.items()})
    jfe = cfg.pop("frontend", None)
    want = JAdaptive(mesh=None, exec_cfg=jconfig.ExecutorConfig(
        frontend=None if jfe is None else jconfig.FrontendConfig(**jfe), **cfg),
        phy_cfg=jphy, capture_symbols=capture_symbols).run(stream)
    got = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(
        frontend=None if jfe is None else FrontendConfig(**jfe), **cfg),
        phy_cfg=PhyConfig(**(phy or {})), capture_symbols=capture_symbols,
        device="cpu").run(stream)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.global_start, g.rate_idx, g.length, g.parity_ok) == (
            w.channel, w.global_start, w.rate_idx, w.length, w.parity_ok)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.cfo - w.cfo) <= 1e-5
        assert abs(g.snr_db - w.snr_db) <= 1e-3
        if capture_symbols:
            assert g.eq_symbols.shape == w.eq_symbols.shape == (
                tx.tx_plan(g.rate_idx, g.length).n_sym, 48)
            np.testing.assert_allclose(g.eq_symbols, w.eq_symbols, atol=1e-4, rtol=0)
        else:
            assert g.eq_symbols is None and w.eq_symbols is None
    return got


def _check(records, specs, channel=0):
    ok = {tuple(r.psdu): r for r in records if r.channel == channel and r.parity_ok}
    for pos, mcs, payload in specs:
        r = ok[tuple(payload)]
        assert (r.rate_idx, r.length) == (mcs, len(payload))
        assert abs(r.global_start - pos) <= 160


def test_mixed_mcs_matches_jax():
    specs = _specs()
    recs = _run_both(_mixed_stream(4 * 4096, specs), block_size=4096, time_shards=4,
                     max_frames_per_block=4)
    _check(recs, specs)


@pytest.mark.parametrize("algo", [ChannelEstimator.LMS, ChannelEstimator.STA,
                                  ChannelEstimator.COMB])
def test_trackers_through_both_stages_match_jax(algo):
    """SIGNAL equalized with the tracker's unit-modulus proxy in stage A,
    the payload with the frame's constellation in stage B, at 18 dB."""
    specs = [(pos, mcs, p) for pos, mcs, p in _specs(11) if mcs != 7]
    x = _mixed_stream(4 * 4096, specs, seed=3, snr_db=18)
    recs = _run_both(x, phy=dict(chan_est=algo, lms_mu=0.25, sta_beta=0.25),
                     block_size=4096, time_shards=4, max_frames_per_block=4)
    _check(recs, specs)


def test_superblock_boundary_matches_jax():
    span = 2 * 2048
    rng = np.random.default_rng(9)
    specs = [(span - 700, 3, rng.integers(0, 256, 60, dtype=np.uint8)),    # straddles
             (2 * span + 300, 7, rng.integers(0, 256, 60, dtype=np.uint8))]
    recs = _run_both(_mixed_stream(3 * span, specs, seed=4), block_size=2048,
                     time_shards=2, max_frames_per_block=4)
    assert sum(r.parity_ok for r in recs) == len(specs)
    _check(recs, specs)


def test_frame_at_stream_end_unpadded_matches_jax():
    """A burst ending at the stream's last sample: stage B's gather reads
    the resident stream's zero pad past the end."""
    rng = np.random.default_rng(21)
    payload = rng.integers(0, 256, 60, dtype=np.uint8)
    burst = np.asarray(jtx.transmit(jnp.asarray(payload)[None], 3))[0]
    n = 4 * 2048
    pos = n - burst.size
    x = np.zeros(n, np.complex64)
    x[pos:] += 0.5 * burst
    x += (0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    recs = _run_both(x, block_size=2048, time_shards=4, max_frames_per_block=4)
    assert sum(r.parity_ok for r in recs) == 1
    _check(recs, [(pos, 3, payload)])


def test_two_channels_match_jax():
    rng = np.random.default_rng(11)
    specs_a = _specs(seed=7)
    specs_b = [(1500, 7, rng.integers(0, 256, 200, dtype=np.uint8)),
               (9000, 0, rng.integers(0, 256, 50, dtype=np.uint8))]
    stream = np.stack([_mixed_stream(4 * 4096, specs_a, seed=1),
                       _mixed_stream(4 * 4096, specs_b, seed=2)])
    recs = _run_both(stream, block_size=4096, time_shards=4, max_frames_per_block=4,
                     channels=2)
    _check(recs, specs_a, channel=0)
    _check(recs, specs_b, channel=1)


def test_sc8_wire_matches_jax():
    rng = np.random.default_rng(5)
    n = 1 << 16
    specs = [(700, 2, rng.integers(0, 256, 50, dtype=np.uint8)),
             (34000, 7, rng.integers(0, 256, 120, dtype=np.uint8))]
    x = np.zeros(n, np.complex64)
    for i, (pos, mcs, payload) in enumerate(specs):
        b = np.asarray(jtx.transmit(jnp.asarray(payload)[None], mcs, scrambler_seed=i + 1))[0]
        x[pos: pos + b.size] += 0.5 * b
    x += 0.004 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    recs = _run_both(x[None], block_size=1 << 14, time_shards=4, max_frames_per_block=4,
                     wire_format="sc8")
    _check(recs, specs)


def test_capture_symbols_matches_jax():
    rng = np.random.default_rng(3)
    specs = [(600, 2, rng.integers(0, 256, 50, dtype=np.uint8)),
             (9000, 5, rng.integers(0, 256, 70, dtype=np.uint8))]
    x = _mixed_stream(1 << 14, specs, snr_db=28)
    recs = _run_both(x[None], capture_symbols=True, block_size=1 << 13, time_shards=2,
                     max_frames_per_block=4)
    _check(recs, specs)


@pytest.mark.parametrize("fe", [dict(resample=(1, 2)), dict(ppm=-40.0)])
def test_frontend_matches_jax(fe):
    """tests/test_frontend.py's local adaptive cases: a 2x-oversampled
    capture and a -40 ppm clock skew, corrected on the device first."""
    rng = np.random.default_rng(13 if "resample" in fe else 17)
    n, n_frames = 120_000, 6
    frames = rng.integers(0, 256, (n_frames, 50), dtype=np.uint8)
    bursts = np.asarray(jtx.transmit(frames, 2))
    x = (0.012 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    starts = [4000 + i * ((n - 8000) // n_frames) for i in range(n_frames)]
    for i, s in enumerate(starts):
        x[s: s + bursts.shape[1]] += bursts[i]
    if "resample" in fe:
        spec = np.fft.fft(x)
        up = np.zeros(2 * n, np.complex64)
        up[: n // 2], up[-(n // 2):] = spec[: n // 2], spec[-(n // 2):]
        x = (np.fft.ifft(up) * 2).astype(np.complex64)
    else:
        x = np.asarray(sample_clock_offset(jnp.asarray(x), fe["ppm"]))
    recs = _run_both(x[None], frontend=fe, block_size=1 << 14, time_shards=2)
    _check(recs, [(s, 2, f) for s, f in zip(starts, frames)])


def test_tracer_stages_and_resident_pad():
    """A run reports its stages (one fetch of all three buckets at the
    end: MCS 3's 50 and 120 bytes share a length class), and the resident
    stream carries the longest frame's window of zeros past its end, so a
    stage-B gather never leaves it."""
    specs = _specs()
    x = _mixed_stream(4 * 4096, specs)[None]
    tracer = tracing.Tracer()
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(block_size=4096, time_shards=4,
                                                        max_frames_per_block=4),
                                tracer=tracer, device="cpu")
    recs = ex.run(x)
    stages = tracer.report()
    assert {"layout", "transfer", "device_step", "collect", "stage_b",
            "stage_b_fetch"} <= set(stages)
    assert stages["stage_b"].frames == len(recs) == 4
    assert stages["stage_b_fetch"].calls == 1 and stages["stage_b_fetch"].frames == 3
    assert (stages["stage_b_slots"].calls, stages["stage_b_slots"].frames) == (3, 4)
    assert ex._resident_right_pad() == sync.window_len(tx.tx_plan(0, 800).n_sym) == 22160
    assert ex.padded_out_len(4 * 4096) == 256 + 4 * 4096 + 22160
    assert ex.halo_right == 560


def test_candidates_counter_counts_the_kept_and_the_read_rows():
    """The Tracer's ``candidates`` counter: one call a step, the frames
    kept (every record of the run) and the steerable rows read, the
    duplicates among them included."""
    x = _mixed_stream(4 * 4096, _specs())[None]
    tracer = tracing.Tracer()
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(block_size=4096, time_shards=2,
                                                        max_frames_per_block=4),
                                tracer=tracer, device="cpu")
    recs = ex.run(x)
    counted = tracer.report()["candidates"]
    assert counted.calls == 2                           # two steps of 2 x 4096
    assert counted.frames == len(recs) == 4
    assert counted.samples >= counted.frames


def _receiver_stream(jobs, n, seed=0, noise=0.004, gap=9000, pos0=500):
    rng = np.random.default_rng(seed)
    x = np.zeros(n, np.complex64)
    pos = pos0
    for mcs, psdu in jobs:
        burst = np.asarray(jtx.transmit(jnp.asarray(psdu[None]), mcs))[0]
        x[pos: pos + burst.size] += 0.5 * burst
        pos += gap
    x += noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x


def _short_stream():
    rng = np.random.default_rng(4)
    psdu = rng.integers(0, 256, 30, dtype=np.uint8)
    burst = np.asarray(jtx.transmit(jnp.asarray(psdu[None]), 1))[0]
    x = np.zeros(burst.size + 400, np.complex64)
    x[200: 200 + burst.size] = 0.4 * burst
    x += 0.003 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size)).astype(
        np.complex64)
    return x


def _receiver_case(name):
    """(stream, max_psdu, max_frames, frames expected) of a scenario of
    tests/test_adaptive.py."""
    if name == "mixed":
        rng = np.random.default_rng(1)
        jobs = [(0, rng.integers(0, 256, 40, dtype=np.uint8)),
                (2, rng.integers(0, 256, 100, dtype=np.uint8)),
                (5, rng.integers(0, 256, 64, dtype=np.uint8))]
        return _receiver_stream(jobs, 1 << 15), 256, 4, 3
    if name == "one_bucket":
        rng = np.random.default_rng(2)
        jobs = [(3, rng.integers(0, 256, 50, dtype=np.uint8)) for _ in range(3)]
        return _receiver_stream(jobs, 1 << 15), 128, 4, 3
    if name == "noise_only":
        rng = np.random.default_rng(3)
        n = 1 << 14
        return (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(
            np.complex64), 128, 4, 0
    return _short_stream(), 256, 2, 1


@pytest.mark.parametrize("name", ["mixed", "one_bucket", "noise_only", "short_padded"])
def test_receiver_matches_jax(name):
    x, max_psdu, max_frames, n_expected = _receiver_case(name)
    want = JReceiver(max_psdu=max_psdu, max_frames=max_frames).receive(x)
    got = AdaptiveReceiver(max_psdu=max_psdu, max_frames=max_frames, device="cpu").receive(x)
    assert len(got) == len(want) == n_expected
    for g, w in zip(got, want):
        assert (g.start, g.rate_idx, g.length, g.sig_ok) == (w.start, w.rate_idx, w.length,
                                                              w.sig_ok)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.cfo - w.cfo) <= 1e-5


def test_signal_buckets_and_steerable_mask():
    """The host dispatch rules both SIGNAL-steered paths share: a decode
    steers only with parity, a known rate and 1 <= length <= max_psdu;
    buckets and their members keep the order of first appearance."""
    sig_ok = np.array([True, True, False, True, True, True, True])
    rate_idx = np.array([3, -1, 3, 0, 3, 7, 0])
    length = np.array([50, 50, 50, 0, 50, 801, 120])
    ok = rx.steerable(sig_ok, rate_idx, length, 800)
    assert ok.tolist() == [True, False, False, False, True, False, True]
    assert rx.signal_buckets([7, 3, 7, 0, 3], [50, 50, 50, 50, 60]) == {
        (7, 50): [0, 2], (3, 50): [1], (0, 50): [3], (3, 60): [4]}


# -- the host's column path against the loop it replaced ------------------------

C_SYN, T_SYN, K_SYN, BLK_SYN = 3, 4, 8, 1024


def _synthetic_stage_a(seed, offset, n):
    """(C, T, K) stage-A outputs with the cases the host sorts out: one
    (channel, global_start) in two slots of a block and in the block before
    it, SIGNALs that do not steer, starts at or past ``n``."""
    rng = np.random.default_rng(seed)
    shape = (C_SYN, T_SYN, K_SYN)
    starts = rng.integers(0, BLK_SYN, shape)
    valid = rng.random(shape) < 0.8
    sig_ok = rng.random(shape) < 0.85
    rate_idx = rng.choice([-1, 0, 3, 3, 7], shape)
    length = rng.choice([0, 50, 50, 120, 801], shape)
    dups = [(0, 1, 0), (0, 1, 3), (0, 0, 5), (2, 3, 1), (2, 2, 7)]
    starts[0, 1, 3] = starts[0, 1, 0]
    starts[0, 0, 5] = starts[0, 1, 0] + BLK_SYN          # block 0, past its own edge
    starts[2, 2, 7] = starts[2, 3, 1] + BLK_SYN
    for d in dups:
        valid[d], sig_ok[d], rate_idx[d], length[d] = True, True, 3, 50
    rate_idx[0, 0, 5] = 7                     # the first row of a key decides its bucket
    valid[1, T_SYN - 1] = True
    # the edges of channel 1's last block at and past n (local: n inside it)
    starts[1, T_SYN - 1, :2] = n - offset - (T_SYN - 1) * BLK_SYN + np.array([0, 37])
    return StageAOutputs(
        valid=torch.from_numpy(valid), starts=torch.from_numpy(starts.astype(np.int32)),
        cfo=torch.from_numpy(rng.normal(0, 1e-3, shape).astype(np.float32)),
        frame_start=torch.from_numpy(rng.integers(100, 200, shape).astype(np.int32)),
        rate_idx=torch.from_numpy(rate_idx.astype(np.int32)),
        length=torch.from_numpy(length.astype(np.int32)), sig_ok=torch.from_numpy(sig_ok))


def _plain_collect_and_bucket(ex, offset, h, n, seen):
    """The per-row host loop the column path replaced: the mask, the
    argwhere walk with a set of (channel, global_start), then
    ``rx.signal_buckets``. Returns (rows read, candidates, buckets) with
    each candidate (channel, global_start, cfo, frame_start, rate_idx,
    length) as Python numbers."""
    starts = h.starts.numpy().astype(np.int64)
    cfo, frame_start = h.cfo.numpy(), h.frame_start.numpy()
    rate_idx, length = h.rate_idx.numpy(), h.length.numpy()
    gstart = offset + np.arange(starts.shape[1])[None, :, None] * ex.block + starts
    mask = (h.valid.numpy() & (gstart < n)
            & rx.steerable(h.sig_ok.numpy(), rate_idx, length, ex.phy.max_psdu_bytes))
    if ex.mesh is not None:
        mask &= ~ex._untrusted(gstart, sync.window_len(0), offset, n)
    cands = []
    for ci, ti, ki in np.argwhere(mask):
        key = (int(ci), int(gstart[ci, ti, ki]))
        if key in seen:
            continue
        seen.add(key)
        cands.append((key[0], key[1], float(cfo[ci, ti, ki]), int(frame_start[ci, ti, ki]),
                      int(rate_idx[ci, ti, ki]), int(length[ci, ti, ki])))
    # stage B's buckets: (rate, length class) in order of first appearance,
    # longest first in each (candidate order among equal lengths), cut into
    # chunks of ROW_SIZES[-1] rows
    classes = pexec.length_classes(ex.phy.max_psdu_bytes)
    groups: dict = {}
    for c in cands:
        n_sym = tx.tx_plan(c[4], c[5]).n_sym
        groups.setdefault((c[4], min(k for k in classes[c[4]] if k >= n_sym)), []).append(c)
    chunk = pexec.ROW_SIZES[-1]
    buckets = []
    for members in groups.values():
        members = sorted(members, key=lambda c: -c[5])
        buckets += [members[i: i + chunk] for i in range(0, len(members), chunk)]
    return int(mask.sum()), cands, buckets


def _plain_rows(bucket, n_pad):
    """A bucket's (b_pad, 4) float64 scalars as the loop wrote them one row
    at a time (local mode; mesh mode without a front-end: tau 0), the rows
    padded to the smallest of ROW_SIZES that holds them."""
    rows = np.zeros((min(r for r in pexec.ROW_SIZES if r >= len(bucket)), 4))
    for i, (ch, gs, cfo, fs, _, ln) in enumerate(bucket):
        rows[i] = (fs, cfo, ch * n_pad + gs - sync.MARGIN + HALO_LEFT, ln) if n_pad else (
            fs, cfo, np.float32(0.0), ln)
    return rows


def _as_tuples(cands):
    return list(zip(cands.channel.tolist(), cands.global_start.tolist(), cands.cfo.tolist(),
                    cands.frame_start.tolist(), cands.rate_idx.tolist(),
                    cands.length.tolist()))


@pytest.mark.parametrize("mode", ["local", "mesh"])
def test_column_path_matches_the_per_row_loop(monkeypatch, mode):
    """Dedup, ``seen``, bucketing and the bucket scalars of the column
    path are the per-row loop's: the same candidates and buckets in the
    same order, the float64 rows byte for byte with the padding. Local:
    edges at and past the stream's end; mesh: the ``_untrusted`` rows of
    the edge blocks."""
    offset = 3 * 4096
    n = offset + (T_SYN - 1) * BLK_SYN + 300 if mode == "local" else offset + 9 * BLK_SYN
    cfg = ExecutorConfig(block_size=BLK_SYN, time_shards=T_SYN, max_frames_per_block=K_SYN,
                         channels=C_SYN, wire_format="sc16")
    tracer = tracing.Tracer()
    ex = AdaptiveStreamExecutor(mesh=None if mode == "local" else make_mesh(1, T_SYN),
                                exec_cfg=cfg, tracer=tracer, device="cpu")
    outs = _synthetic_stage_a(11, offset, n)
    seen_rows = [(1, 0, 0), (2, 1, 4)]            # keys a previous step already took
    for r in seen_rows:
        outs.valid[r], outs.sig_ok[r], outs.rate_idx[r], outs.length[r] = True, True, 0, 120
    seen_plain = {(r[0], offset + r[1] * BLK_SYN + int(outs.starts[r])) for r in seen_rows}
    seen_plain.add((0, 7))
    seen = {c * n + g for c, g in seen_plain}
    read, want, want_buckets = _plain_collect_and_bucket(ex, offset, outs, n, seen_plain)

    cands = ex._collect_candidates(offset, outs, n, 0, seen)
    got = _as_tuples(cands)
    assert got == want and len(want) > 20
    assert seen == {c * n + g for c, g in seen_plain}
    assert (0, offset + BLK_SYN + int(outs.starts[0, 1, 0])) in {w[:2] for w in want}
    counted = tracer.report()["candidates"]
    assert (counted.calls, counted.frames, counted.samples) == (1, len(want), read)
    assert read > len(want)                               # duplicates and seen keys read
    if mode == "local":
        assert not any(g >= n for _, g, *_ in want)
    else:
        assert ex._untrusted(offset + np.arange(T_SYN)[None, :, None] * BLK_SYN
                             + outs.starts.numpy(), sync.window_len(0), offset, n).any()
    assert _as_tuples(cands[: len(cands) // 2]) == want[: len(want) // 2]   # the half control

    stream = np.zeros((C_SYN, n), np.complex64)
    n_pad = 0
    if mode == "local":
        n_pad = ex.padded_out_len(n)
        ex._dev_stream = torch.zeros((C_SYN, n_pad, 2), dtype=torch.int16)
    dispatched = []

    def spy(self, stream, bucket):
        wlen = sync.window_len(tx.tx_plan(int(bucket.rate_idx[0]), int(bucket.length[0])).n_sym)
        assert len(bucket) <= pexec.ROW_SIZES[-1]
        dispatched.append((bucket, self._bucket_inputs(stream, bucket, wlen)[1]))
        return bucket, None, None

    monkeypatch.setattr(AdaptiveStreamExecutor, "_dispatch_bucket", spy)
    ex._stage_b_dispatch(stream, cands)
    assert [_as_tuples(b) for b, _ in dispatched] == want_buckets and len(want_buckets) > 2
    for (_, scalars), bucket in zip(dispatched, want_buckets):
        assert scalars.dtype == torch.float64
        assert scalars.numpy().tobytes() == _plain_rows(bucket, n_pad).tobytes()
