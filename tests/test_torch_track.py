"""The LMS and STA trackers against the plain receiver (plain_track_rx.py).

On the CPU: ``equalize``'s tracking loop, the decode around it and the
adaptive executor with ``chan_est=STA`` against the plain float64
receiver, on seeded frames through a time-varying multipath channel at
three rates and two short lengths; the loop against the JAX package's
trackers frozen in ``golden/track_eq_jax.npz`` (``make_track_golden.py``),
and the frozen outputs against the JAX package's live ones wherever JAX
imports. On the card (marker ``cuda``): the tracking kernel K5 against
the loop, the frozen JAX outputs and the plain float64 tracker, a padded
bucket and stage A's single symbol among its inputs; 64-QAM at 25 dB by
the share of decisions that agree; a control with STA's spectral term
dropped; and the executor's buckets each one K5 launch.

Only the frozen-output check imports the JAX package (it skips without
JAX and on a card host, where the JAX package does not run); on a card:

    python -m pytest --noconftest tests/test_torch_track.py
"""

import importlib
import pathlib

import numpy as np
import plain_track_rx as plain
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import (
    ChannelEstimator, ExecutorConfig, PhyConfig)
from gnuradio_wifi_imagetransfer_tpu_torch.ops import track_eq as k5
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import AdaptiveStreamExecutor
from gnuradio_wifi_imagetransfer_tpu_torch.phy import equalizer, mapping, params, rx, tx

RATES = (0, 2, 4)
LENGTHS = (24, 60)
# eq and csi of the float32 loop against the float64 reference: a step
# rounds at about 1e-7 of a unit point, the recursion carries it over at
# most 25 symbols here, and a faded carrier's 1 / |h| (|h| >= 0.1 in these
# frames) amplifies it, so 1e-4 absolute holds with a wide margin; csi is
# |h|^2 of the same estimate
EQ_ATOL = 1e-4
GOLDEN = pathlib.Path(__file__).parent / "golden" / "track_eq_jax.npz"
JAX_EQ = "gnuradio_wifi_imagetransfer_tpu.phy.equalizer"
# (input set, decision MCS or None for the proxy, first symbol's index):
# make_track_golden.py's cases
GOLDEN_CASES = (("b2", None, 0), ("b0", 0, 0), ("b2", 2, 0), ("b4", 4, 0), ("b7", 7, 0),
                ("b2", 2, 1), ("a", None, 0), ("a", 2, 0))
# 64-QAM at 25 dB (noise 0.0398 an axis on unit-energy points, about what
# 64-QAM 3/4 needs): where a decision falls within a float32 rounding of a
# tie, K5 and a float64 tracker may decide it apart, and that carrier's
# estimate (and, through STA's spectral average, its four neighbours')
# then parts for the rest of the frame. The limit on the share of
# decisions that agree leaves room for a few such partings in the 181 248
# decisions of the case (each costs at most 5 carriers x 59 symbols,
# 0.16 %), while STA without its spectral term agrees on about 18 %
QAM64_SIGMA = 0.0398
AGREE_MIN = 0.99


def _fading_frames(seed, mcs, length, frames=3, snr_db=30.0, doppler=300.0):
    """Frames of the port's TX through a 3-tap Rayleigh channel whose taps
    turn at ``doppler`` Hz at 10 Msamples/s, with AWGN; each window starts
    plain.SEARCH samples before its frame. Returns (windows (F, W)
    complex64, PSDUs (F, length))."""
    rng = np.random.default_rng(seed)
    psdus = rng.integers(0, 256, (frames, length), dtype=np.uint8)
    bursts = tx.transmit(psdus, mcs, scrambler_seed=seed % 127 + 1, device="cpu").numpy()
    n = bursts.shape[1]
    w = n + 2 * plain.SEARCH + 16
    t = np.arange(n + 2)
    out = np.zeros((frames, w), np.complex64)
    for f in range(frames):
        y = np.zeros(n + 2, np.complex128)
        for k, p in enumerate((0.6, 0.3, 0.1)):
            th = rng.uniform(0, 2 * np.pi, 8)
            ph = rng.uniform(0, 2 * np.pi, 8)
            g = np.exp(1j * (ph[None] + 2 * np.pi * doppler * np.cos(th)[None]
                             * t[:, None] / 1e7)).sum(-1) * np.sqrt(p / 8)
            y[k: k + n] += g[k: k + n] * bursts[f]
        y *= 0.5 * np.exp(1j * 0.002 * np.arange(n + 2))                # CFO
        out[f, plain.SEARCH: plain.SEARCH + n + 2] = y
    sigma = 0.5 * 10 ** (-snr_db / 20) / np.sqrt(2)
    out += (sigma * (rng.standard_normal(out.shape) + 1j * rng.standard_normal(out.shape))
            ).astype(np.complex64)
    return out, psdus


def _aligned(windows, mcs, length):
    """The plain receiver's timing and CFO applied: (B, N) derotated
    samples from each first preamble sample, as the port decodes them."""
    start, cfo = plain.sync(torch.from_numpy(windows))
    n = rx.TxPlan(mcs, length).n_sym
    span = plain.PREAMBLE + plain.SYMBOL * (1 + n)
    idx = start.numpy()[:, None] + np.arange(span)
    seg = windows[np.arange(len(windows))[:, None], idx]
    return (seg * np.exp(-1j * cfo.numpy()[:, None] * np.arange(span))).astype(np.complex64)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("mcs", RATES)
@pytest.mark.parametrize("algo", ["LMS", "STA"])
def test_equalize_matches_plain_tracker(algo, mcs, length):
    seg = torch.from_numpy(_aligned(*_fading_frames(mcs * 7 + length, mcs, length)[:1],
                                    mcs, length))
    n = rx.TxPlan(mcs, length).n_sym
    ltf1, ltf2, spec = rx.frame_spectra(seg, n)
    h0 = equalizer.ls_estimate(ltf1, ltf2)
    eq, csi = equalizer.equalize(spec, h0, 0, ChannelEstimator[algo], mcs)
    want_eq, want_csi = plain.track(spec.to(torch.complex128), h0.to(torch.complex128), mcs, algo)
    # the decisions are the same points, and the trackers' outputs agree
    assert torch.equal(mapping.decide(eq[:, 1:], mcs),
                       mapping.decide(want_eq[:, 1:].to(torch.complex64), mcs))
    torch.testing.assert_close(eq, want_eq.to(torch.complex64), atol=EQ_ATOL, rtol=0)
    torch.testing.assert_close(csi, want_csi.to(torch.float32), atol=EQ_ATOL, rtol=0)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("mcs", RATES)
def test_sta_decode_matches_plain_receiver(mcs, length):
    windows, psdus = _fading_frames(mcs * 11 + length, mcs, length)
    want = plain.receive(windows, mcs, length)
    got = rx.decode_aligned(torch.from_numpy(_aligned(windows, mcs, length)),
                            rx.TxPlan(mcs, length), algo=ChannelEstimator.STA)
    assert plain.delivered(want, mcs, psdus).all()     # the frames decode at all
    assert np.array_equal(got.psdu.numpy(), want["psdu"])
    assert bool(got.sig["parity_ok"].all())
    assert got.sig["rate_idx"].tolist() == [m for m, _, _ in want["signal"]]
    assert got.sig["length"].tolist() == [ln for _, ln, _ in want["signal"]]
    torch.testing.assert_close(got.eq_symbols, want["eq"].to(torch.complex64),
                               atol=EQ_ATOL, rtol=0)


def _stream(seed, frames):
    """One 10 Msamples/s channel of faded frames [(mcs, length)], and the
    truth [(start, mcs, PSDU)]."""
    x = np.zeros(4 * 8192, np.complex64)
    truth, pos = [], 400
    for i, (mcs, length) in enumerate(frames):
        w, psdus = _fading_frames(seed + i, mcs, length, frames=1)
        x[pos - plain.SEARCH: pos - plain.SEARCH + w.shape[1]] += w[0]
        truth.append((pos, mcs, psdus[0]))
        pos += w.shape[1] + 700
    rng = np.random.default_rng(seed)
    sigma = 0.5 * 10 ** (-30 / 20) / np.sqrt(2)
    quiet = (x == 0)
    x[quiet] = (sigma * (rng.standard_normal(quiet.sum()) + 1j * rng.standard_normal(quiet.sum()))
                ).astype(np.complex64)
    return x[None], truth


def test_adaptive_executor_sta_matches_plain_receiver():
    frames = [(m, ln) for m in RATES for ln in LENGTHS]
    x, truth = _stream(5, frames)
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(block_size=8192, time_shards=2,
                                                        max_frames_per_block=4),
                                phy_cfg=PhyConfig(chan_est=ChannelEstimator.STA), device="cpu")
    recs = [r for r in ex.run(x) if r.parity_ok]
    assert len(recs) == len(truth)
    steps = ex.tracer.report()["track"]
    assert (steps.frames, steps.samples) == (
        len(truth), sum(rx.TxPlan(m, ln).n_sym for m, ln in frames))
    for rec, (pos, mcs, psdu) in zip(recs, truth):
        assert (rec.rate_idx, rec.length) == (mcs, psdu.size)
        assert pos <= rec.global_start < pos + 160
        a = pos - plain.SEARCH
        w = x[0, a: a + rx.TxPlan(mcs, psdu.size).n_sym * 80 + 400 + 2 * plain.SEARCH + 16][None]
        want = plain.receive(w, mcs, psdu.size)
        assert plain.delivered(want, mcs, psdu[None]).all()
        assert np.array_equal(rec.psdu, psdu)
        # the record's SNR is the decision-directed EVM SNR of the same
        # symbols, float32 (and a sync whose timing and CFO round in
        # float32) against float64
        assert abs(rec.snr_db - float(want["snr_db"][0])) <= 0.01


def test_the_kernel_wrapper_takes_only_cuda_tensors():
    """``equalize`` keeps CPU tensors on its loop; the wrapper itself
    refuses any other device rather than computing plainly."""
    y, h0 = torch.zeros(2, 3, 64, dtype=torch.complex64), torch.ones(2, 52, dtype=torch.complex64)
    pol = torch.ones(3)
    before = k5.track_eq.launches
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="unsupported device"):
            k5.track_eq(y.to(dev), h0.to(dev), pol, ChannelEstimator.STA, 2, True, 0.5, 0.5, 0.125)
    with pytest.raises(ValueError, match="carries no estimate"):
        k5.track_eq(y, h0, pol, ChannelEstimator.LS, 2, True, 0.5, 0.5, 0.125)
    equalizer.equalize(y, h0, 0, ChannelEstimator.STA, 2)
    assert k5.track_eq.launches == before


@pytest.mark.parametrize("mcs", [0, 2, 4, 6])
def test_the_kernels_decision_tables_are_the_constellations(mcs):
    """A square constellation's nearest point, ties to the first, is the
    nearest level on each axis, ties to the first: the per-axis levels
    the kernel is handed rebuild ``params.constellation`` point by point."""
    decision, levels, level, bpsk = k5.decision_args(mcs)
    pts = params.constellation(int(params.MCS_N_BPSC[mcs]))
    assert np.array_equal(np.array(bpsk, np.float32), params.constellation(1).real)
    if mcs == 0:
        assert decision == k5.BPSK
        return
    half = int(params.MCS_N_BPSC[mcs]) // 2
    lv = np.array(level, np.float32)
    assert decision == k5.QAM and levels == 1 << half
    rebuilt = lv[np.arange(pts.size) >> half] + 1j * lv[np.arange(pts.size) & (levels - 1)]
    assert np.array_equal(rebuilt.astype(np.complex64), pts)


def _golden():
    return dict(np.load(GOLDEN))


def _golden_key(algo, name, mcs, idx0):
    return f"{algo}_{name}_{'p' if mcs is None else mcs}_{idx0}"


def _assert_like_golden(got, g, algo, case):
    """eq and csi within float32 tolerance of the frozen JAX outputs
    (two float32 roundings of the same recursion), the decisions equal."""
    name, mcs, idx0 = case
    key = _golden_key(algo, name, mcs, idx0)
    want_eq, want_csi = torch.from_numpy(g[f"eq_{key}"]), torch.from_numpy(g[f"csi_{key}"])
    torch.testing.assert_close(got[0].cpu(), want_eq, atol=EQ_ATOL, rtol=0, msg=key)
    torch.testing.assert_close(got[1].cpu(), want_csi, atol=EQ_ATOL, rtol=0, msg=key)
    dec = 2 if mcs is None else mcs
    assert torch.equal(mapping.decide(got[0].cpu(), dec), mapping.decide(want_eq, dec)), key


@pytest.mark.parametrize("algo", ["LMS", "STA"])
def test_the_frozen_jax_outputs_are_the_jax_packages(algo):
    """golden/track_eq_jax.npz still holds what the JAX package's trackers
    give on its inputs (the file's drift guard). The JAX package is the
    reference on the CPU and is not run on a card host (where JAX would
    take the card); another XLA build may round a few outputs differently
    at 1e-6, a changed recursion moves them by far more than 1e-5."""
    if torch.cuda.is_available():
        pytest.skip("the JAX package runs on the CPU only; the card holds K5 to the frozen file")
    jeq = pytest.importorskip(JAX_EQ)
    jconfig = importlib.import_module("gnuradio_wifi_imagetransfer_tpu.config")
    g = _golden()
    for name, mcs, idx0 in GOLDEN_CASES:
        eq, csi = jeq.equalize(g[f"y_{name}"], g[f"h0_{name}"], idx0,
                               jconfig.ChannelEstimator[algo], mcs)
        key = _golden_key(algo, name, mcs, idx0)
        np.testing.assert_allclose(np.asarray(eq), g[f"eq_{key}"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.asarray(csi), g[f"csi_{key}"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", GOLDEN_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("algo", ["LMS", "STA"])
def test_the_loop_matches_the_frozen_jax_tracker(algo, case):
    g = _golden()
    name, mcs, idx0 = case
    y, h0 = torch.from_numpy(g[f"y_{name}"]), torch.from_numpy(g[f"h0_{name}"])
    _assert_like_golden(equalizer.equalize(y, h0, idx0, ChannelEstimator[algo], mcs),
                        g, algo, case)


def _agreement(eq, want, mcs):
    """The share of data-symbol decisions of eq equal to those of the
    float64 tracker's want."""
    return float((mapping.decide(eq[:, 1:].cpu(), mcs)
                  == mapping.decide(want[:, 1:].to(torch.complex64), mcs)).float().mean())


@pytest.mark.parametrize("algo", ["LMS", "STA"])
def test_the_loop_at_64qam_and_25_db_decides_as_the_plain_tracker(algo):
    y, h0 = _spectra(64, 60, seed=11, mcs=7, sigma=QAM64_SIGMA)
    want, _ = plain.track(y.to(torch.complex128), h0.to(torch.complex128), 7, algo)
    assert _agreement(equalizer.equalize(y, h0, 0, ChannelEstimator[algo], 7)[0], want,
                      7) >= AGREE_MIN


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spectra(rows, symbols, seed, mcs=2, sigma=0.02):
    """Noisy rotated points of ``mcs`` on every bin (noise ``sigma`` an
    axis) and a perturbed estimate: (rows, symbols, 64) spectra and (rows,
    52) h0."""
    rng = np.random.default_rng(seed)
    shape = (rows, symbols, 64)
    y = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * sigma
    bits = rng.integers(0, 2, (rows, symbols, 64 * int(params.MCS_N_BPSC[mcs])), dtype=np.uint8)
    y += mapping.map_bits(torch.from_numpy(bits), mcs).numpy() * np.exp(0.3j)
    h0 = np.exp(0.3j) * (1 + 0.1 * rng.standard_normal((rows, 52)))
    return torch.from_numpy(y.astype(np.complex64)), torch.from_numpy(h0.astype(np.complex64))


@pytest.mark.cuda
@pytest.mark.parametrize("mcs", [None, 0, 2, 4, 7])
@pytest.mark.parametrize("algo", ["LMS", "STA"])
def test_k5_matches_plain_loop_on_card(dev, algo, mcs):
    # a bucket of 5 frames padded to 8 rows with copies of row 0 (the
    # executor pads with channel 0's window) over 40 symbols, from SIGNAL
    # and from a later symbol; and stage A's single symbol over 9 rows
    y, h0 = _spectra(5, 40, seed=3, mcs=2 if mcs is None else mcs)
    y, h0 = torch.cat([y, y[:1].expand(3, -1, -1)]), torch.cat([h0, h0[:1].expand(3, -1)])
    y1, h1 = _spectra(9, 1, seed=4)
    for yy, hh, idx0 in ((y, h0, 0), (y, h0, 1), (y1, h1, 0)):
        want = equalizer.equalize(yy, hh, idx0, ChannelEstimator[algo], mcs)
        before = k5.track_eq.launches
        got = equalizer.equalize(yy.to(dev), hh.to(dev), idx0, ChannelEstimator[algo], mcs)
        torch.cuda.synchronize()
        assert k5.track_eq.launches == before + 1
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), w, atol=EQ_ATOL, rtol=0)
        if mcs is not None:
            assert torch.equal(mapping.decide(got[0].cpu(), mcs), mapping.decide(want[0], mcs))


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["LMS", "STA"])
def test_k5_matches_the_frozen_jax_tracker_on_card(dev, algo):
    g = _golden()
    for case in GOLDEN_CASES:
        name, mcs, idx0 = case
        y, h0 = torch.from_numpy(g[f"y_{name}"]), torch.from_numpy(g[f"h0_{name}"])
        before = k5.track_eq.launches
        got = equalizer.equalize(y.to(dev), h0.to(dev), idx0, ChannelEstimator[algo], mcs)
        torch.cuda.synchronize()
        assert k5.track_eq.launches == before + 1
        _assert_like_golden(got, g, algo, case)


@pytest.mark.cuda
@pytest.mark.parametrize("mcs", [0, 2, 4, 7])
@pytest.mark.parametrize("algo", ["LMS", "STA"])
def test_k5_matches_the_plain_float64_tracker_on_card(dev, algo, mcs):
    # a bucket of 5 frames padded to 8 rows with copies of row 0, from SIGNAL
    y, h0 = _spectra(5, 40, seed=6, mcs=mcs)
    y, h0 = torch.cat([y, y[:1].expand(3, -1, -1)]), torch.cat([h0, h0[:1].expand(3, -1)])
    want_eq, want_csi = plain.track(y.to(torch.complex128), h0.to(torch.complex128), mcs, algo)
    eq, csi = equalizer.equalize(y.to(dev), h0.to(dev), 0, ChannelEstimator[algo], mcs)
    assert _agreement(eq, want_eq, mcs) == 1.0
    torch.testing.assert_close(eq.cpu(), want_eq.to(torch.complex64), atol=EQ_ATOL, rtol=0)
    torch.testing.assert_close(csi.cpu(), want_csi.to(torch.float32), atol=EQ_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["LMS", "STA"])
def test_k5_at_64qam_and_25_db_decides_as_the_plain_tracker_on_card(dev, algo):
    """At realistic noise K5 is held by the share of decisions that agree
    with the float64 tracker's; STA without its spectral term (the
    control) falls under the limit."""
    y, h0 = _spectra(64, 60, seed=11, mcs=7, sigma=QAM64_SIGMA)
    want, _ = plain.track(y.to(torch.complex128), h0.to(torch.complex128), 7, algo)
    eq, _ = equalizer.equalize(y.to(dev), h0.to(dev), 0, ChannelEstimator[algo], 7)
    assert _agreement(eq, want, 7) >= AGREE_MIN
    if algo == "STA":
        ctrl, _ = equalizer.equalize(y.to(dev), h0.to(dev), 0, ChannelEstimator.STA, 7,
                                     sta_beta=0.0)
        assert _agreement(ctrl, want, 7) < AGREE_MIN


@pytest.mark.cuda
def test_k5_without_the_spectral_term_is_refused(dev):
    """The control: K5 with STA's spectral average dropped (beta 0) does not
    pass the comparison that the sound kernel passes."""
    y, h0 = _spectra(8, 40, seed=5)
    want = equalizer.equalize(y, h0, 0, ChannelEstimator.STA, 2)
    got = equalizer.equalize(y.to(dev), h0.to(dev), 0, ChannelEstimator.STA, 2, sta_beta=0.0)
    assert float((got[0].cpu() - want[0]).abs().max()) > 10 * EQ_ATOL


@pytest.mark.cuda
def test_executor_sta_buckets_launch_k5_once_on_card(dev, monkeypatch):
    frames = [(m, ln) for m in RATES for ln in LENGTHS]
    x, truth = _stream(9, frames)
    kw = dict(exec_cfg=ExecutorConfig(block_size=8192, time_shards=2, max_frames_per_block=4,
                                      wire_format="sc16"),
              phy_cfg=PhyConfig(chan_est=ChannelEstimator.STA))
    want = AdaptiveStreamExecutor(device="cpu", **kw).run(x)
    loop_on_card = []
    plain_loop = equalizer._track_plain

    def watched(y_all, *a):
        loop_on_card.append(y_all.device.type == "cuda")
        return plain_loop(y_all, *a)

    monkeypatch.setattr(equalizer, "_track_plain", watched)
    k5.track_eq.launches = 0
    ex = AdaptiveStreamExecutor(device=dev, **kw)
    got = ex.run(x)
    torch.cuda.synchronize()
    assert not any(loop_on_card)
    # 2 steps (stage A: one launch each) and one launch a (rate, length
    # class) bucket
    assert k5.track_eq.launches == 2 + ex.tracer.report()["stage_b_slots"].calls
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.global_start, g.rate_idx, g.length, g.parity_ok) == (
            w.channel, w.global_start, w.rate_idx, w.length, w.parity_ok)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.snr_db - w.snr_db) <= 1e-3
    assert {(m, tuple(p)) for _, m, p in truth} <= {
        (r.rate_idx, tuple(r.psdu)) for r in got if r.parity_ok}
