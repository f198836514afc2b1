"""The port's equalizers (LS, LMS, COMB, STA) and their tracker gains,
against the JAX package on the CPU.

Inputs are the synthetic symbol runs of tests/test_equalizer.py (known
QPSK data on the 802.11a carrier grid through a per-carrier channel).
``eq`` and ``csi`` agree within 1e-4 (float32 arithmetic of two
libraries); the hard decisions of the decision-directed trackers must be
identical, which holds at the runs' 30 dB."""

import dataclasses
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.parallel import AdaptiveStreamExecutor as JAdaptive
from gnuradio_wifi_imagetransfer_tpu.parallel import StreamExecutor as JStreamExecutor
from gnuradio_wifi_imagetransfer_tpu.phy import equalizer as jequalizer
from gnuradio_wifi_imagetransfer_tpu.phy import mapping as jmapping
from gnuradio_wifi_imagetransfer_tpu.phy import ofdm as jofdm
from gnuradio_wifi_imagetransfer_tpu.phy import params as jparams
from gnuradio_wifi_imagetransfer_tpu.phy import rx as jrx
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu_torch import state
from gnuradio_wifi_imagetransfer_tpu_torch.config import (
    ChannelEstimator,
    ExecutorConfig,
    PhyConfig,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
    AdaptiveStreamExecutor,
    StreamExecutor,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import executor as exmod
from gnuradio_wifi_imagetransfer_tpu_torch.phy import equalizer, mapping, rx, tx

torch.set_num_threads(2)

MCS = 2        # QPSK 1/2
S = 40         # symbols per synthetic run
ATOL = 1e-4


def _synthetic_run(seed):
    """Known QPSK data symbols (S, 48) and their shifted spectra (S, 64)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (S, 48 * 2), dtype=np.uint8)
    data = np.asarray(jmapping.map_bits(jnp.asarray(bits), MCS))
    return data, np.asarray(jofdm.allocate_carriers(jnp.asarray(data), symbol_index0=1))


def _apply(spectra, h_used_t, snr_db=30, seed=2):
    """Y[t, k] = H_t[k] X[t, k] + noise on the used bins."""
    rng = np.random.default_rng(seed)
    used = np.asarray(jparams.USED_BINS)
    y = spectra.copy()
    y[:, used] = y[:, used] * h_used_t
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    y = y + sigma * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    return y.astype(np.complex64)


def _fading(seed=3):
    """tests/test_equalizer.py's slow three-tap fading: H smooth across
    carriers, drifting across symbols (LMS and STA track it, LS does not)."""
    data, spectra = _synthetic_run(0)
    rng = np.random.default_rng(seed)
    t = np.arange(S)[:, None]
    used = np.asarray(jparams.USED_BINS) - 32
    delays = np.array([0, 3, 7])
    g0 = np.array([1.0, 0.45, 0.3]) * np.exp(1j * 2 * np.pi * rng.random(3))
    wobble = np.exp(1j * (2 * np.pi * t / np.array([40.0, 51.2, 64.4])
                          + 2 * np.pi * rng.random(3)))
    gains = g0 * (1 + 0.65 * (wobble - wobble[0]))
    h_t = np.einsum("st,tk->sk", gains, np.exp(-2j * np.pi * np.outer(delays, used) / 64))
    return data, _apply(spectra, h_t), h_t[0].astype(np.complex64)


def _tilt():
    """tests/test_equalizer.py's per-symbol gain ramp and growing phase
    tilt (COMB tracks it, LS does not)."""
    data, spectra = _synthetic_run(5)
    rng = np.random.default_rng(6)
    h0 = ((0.8 + 0.4 * rng.random(52)) * np.exp(0.5j * rng.standard_normal(52))
          ).astype(np.complex64)
    t, k = np.arange(S)[:, None], np.arange(52)[None, :]
    return data, _apply(spectra, h0 * (1.0 + 0.012 * t) * np.exp(1j * 0.0035 * t * (k - 25.5))), h0


def _ser(eq, data):
    return float(np.mean(np.abs(mapping.decide(torch.from_numpy(eq), MCS).numpy() - data) > 1e-3))


@pytest.mark.parametrize("algo", list(ChannelEstimator))
@pytest.mark.parametrize("symbol_index0", [1, 0])
@pytest.mark.parametrize("mcs", [None, MCS])
def test_equalize_matches_jax(algo, symbol_index0, mcs):
    _, y, h0 = _tilt() if algo == ChannelEstimator.COMB else _fading()
    # a batch of two runs: the channel and its conjugate-rotated copy
    y2, h2 = np.stack([y, y * 1j]), np.stack([h0, h0 * 1j])
    got_eq, got_csi = equalizer.equalize(torch.from_numpy(y2), torch.from_numpy(h2),
                                         symbol_index0=symbol_index0, algo=algo, mcs=mcs)
    want_eq, want_csi = (np.asarray(v) for v in jequalizer.equalize(
        jnp.asarray(y2), jnp.asarray(h2), symbol_index0=symbol_index0,
        algo=jconfig.ChannelEstimator(int(algo)), mcs=mcs))
    assert got_eq.shape == want_eq.shape == (2, S, 48)
    assert got_csi.shape == want_csi.shape == (2, S, 48)
    np.testing.assert_allclose(got_eq.numpy(), want_eq, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_csi.numpy(), want_csi, atol=ATOL, rtol=0)
    dec = mapping.decide(got_eq, MCS).numpy()
    assert np.array_equal(dec, np.asarray(jmapping.decide(jnp.asarray(want_eq), MCS)))


def test_decisions_of_the_trackers_match_jax():
    """The trackers' own decisions (the unit-modulus proxy and the
    constellation) and the COMB interpolation weights equal JAX's."""
    _, y, _ = _fading()
    eq = torch.from_numpy(y[:, :48])
    for mcs in (None, 0, 2, 7):
        got = equalizer._decide(eq, mcs).numpy()
        want = np.asarray(jequalizer._decide(jnp.asarray(y[:, :48]), mcs))
        if mcs is None:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        else:
            assert np.array_equal(got, want)
    assert np.array_equal(equalizer._comb_interp_matrix(), jequalizer._comb_interp_matrix())


def test_trackers_beat_ls_on_their_channels():
    data, y, h0 = _fading()
    ser = {a: _ser(equalizer.equalize(torch.from_numpy(y), torch.from_numpy(h0),
                                      symbol_index0=1, algo=a, mcs=MCS)[0].numpy(), data)
           for a in (ChannelEstimator.LS, ChannelEstimator.LMS, ChannelEstimator.STA)}
    assert ser[ChannelEstimator.LS] > 0.05
    assert ser[ChannelEstimator.LMS] < ser[ChannelEstimator.LS] / 5
    assert ser[ChannelEstimator.STA] < ser[ChannelEstimator.LS] / 5
    data, y, h0 = _tilt()
    ser = {a: _ser(equalizer.equalize(torch.from_numpy(y), torch.from_numpy(h0),
                                      symbol_index0=1, algo=a, mcs=MCS)[0].numpy(), data)
           for a in (ChannelEstimator.LS, ChannelEstimator.COMB)}
    assert ser[ChannelEstimator.LS] > 0.05
    assert ser[ChannelEstimator.COMB] < ser[ChannelEstimator.LS] / 5


def _echo_frame():
    """tests/test_equalizer.py's integration frame: 64-QAM 3/4, 400 bytes,
    through a two-tap channel whose echo grows and rotates over the frame."""
    rng = np.random.default_rng(9)
    psdu = rng.integers(0, 256, (1, 400), dtype=np.uint8)
    burst = tx.transmit(psdu, 7, device="cpu")[0].numpy()
    n = burst.size
    echo = np.zeros(n, np.complex64)
    echo[8:] = burst[:-8]
    y = burst + (np.linspace(0.0, 0.4, n) * np.exp(2j * np.pi * np.arange(n) / 6000.0)
                 * echo).astype(np.complex64)
    y = y + (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    return psdu[0], y[None]


def test_lms_decodes_the_echo_frame_where_ls_fails():
    psdu, y = _echo_frame()
    plan = tx.tx_plan(7, 400)
    errs = {}
    for algo in (ChannelEstimator.LS, ChannelEstimator.LMS):
        res = rx.decode_aligned(torch.from_numpy(y), plan, start=0, algo=algo)
        want = jrx.decode_aligned(jnp.asarray(y), jtx.tx_plan(7, 400), start=0,
                                  algo=jconfig.ChannelEstimator(int(algo)))
        got = res.psdu.numpy()[0]
        assert np.array_equal(got, np.asarray(want.psdu)[0])
        np.testing.assert_allclose(res.eq_symbols.numpy(), np.asarray(want.eq_symbols),
                                   atol=ATOL, rtol=0)
        errs[algo] = int((got != psdu).sum())
    assert errs[ChannelEstimator.LMS] == 0
    assert errs[ChannelEstimator.LS] > 50


@pytest.mark.parametrize("fn", [equalizer.equalize, rx.decode_aligned, rx.decode_spectra])
def test_tracker_gain_defaults_are_phyconfigs(fn):
    cfg = PhyConfig()
    sig = inspect.signature(fn)
    assert sig.parameters["lms_mu"].default == cfg.lms_mu
    assert sig.parameters["sta_alpha"].default == cfg.sta_alpha
    assert sig.parameters["sta_beta"].default == cfg.sta_beta
    assert (cfg.lms_mu, cfg.sta_alpha, cfg.sta_beta) == (
        jconfig.PhyConfig().lms_mu, jconfig.PhyConfig().sta_alpha, jconfig.PhyConfig().sta_beta)


def test_gains_change_the_decode():
    """Non-default gains reach the trackers through decode_aligned."""
    psdu, y = _echo_frame()
    plan = tx.tx_plan(7, 400)
    for algo, kw in ((ChannelEstimator.LMS, dict(lms_mu=0.25)),
                     (ChannelEstimator.STA, dict(sta_alpha=0.25)),
                     (ChannelEstimator.STA, dict(sta_beta=0.25))):
        base = rx.decode_aligned(torch.from_numpy(y), plan, algo=algo).eq_symbols
        got = rx.decode_aligned(torch.from_numpy(y), plan, algo=algo, **kw).eq_symbols
        want = jrx.decode_aligned(jnp.asarray(y), jtx.tx_plan(7, 400),
                                  algo=jconfig.ChannelEstimator(int(algo)), **kw).eq_symbols
        assert (got - base).abs().max() > 1e-3
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.global_start, g.parity_ok, g.rate_idx, g.length) == (
            w.channel, w.global_start, w.parity_ok, w.rate_idx, w.length)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.cfo - w.cfo) <= 1e-5
        assert abs(g.snr_db - w.snr_db) <= 1e-3


def _stream(seed, n=4 * 8192, mcs=2, length=50, snr_db=20):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (3, length), dtype=np.uint8)
    bursts = tx.transmit(frames, mcs, scrambler_seed=torch.arange(1, 4), device="cpu").numpy()
    x = np.zeros(n, np.complex64)
    for pos, b in zip((500, n // 2 - 300, n - bursts.shape[1] - 700), bursts):
        x[pos: pos + b.size] += 0.5 * b
    sigma = 0.5 * 10 ** (-snr_db / 20) / np.sqrt(2)
    x += (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    return x[None], frames


def test_stream_executor_threads_the_gains():
    """StreamExecutor with STA and a non-default sta_beta gives the JAX
    executor's records (the gains reach the equalizer)."""
    x, frames = _stream(31)
    kw = dict(block_size=8192, time_shards=2, max_frames_per_block=4, wire_format="sc16")
    phy = dict(chan_est=ChannelEstimator.STA, sta_beta=0.25)
    got = StreamExecutor(tx.tx_plan(2, 50), exec_cfg=ExecutorConfig(**kw),
                         phy_cfg=PhyConfig(**phy), device="cpu").run(x)
    want = JStreamExecutor(jtx.tx_plan(2, 50), mesh=None, exec_cfg=jconfig.ExecutorConfig(**kw),
                           phy_cfg=jconfig.PhyConfig(chan_est=jconfig.ChannelEstimator.STA,
                                                     sta_beta=0.25)).run(x)
    _records_equal(got, want)
    default = StreamExecutor(tx.tx_plan(2, 50), exec_cfg=ExecutorConfig(**kw),
                             phy_cfg=PhyConfig(chan_est=ChannelEstimator.STA),
                             device="cpu").run(x)
    assert max(abs(a.snr_db - b.snr_db) for a, b in zip(got, default)) > 1e-3
    assert {tuple(f) for f in frames} <= {tuple(r.psdu) for r in got if r.parity_ok}


def test_reference_state_with_lms_decodes_as_jax():
    """state.load_reference_state turns the JAX package's PhyConfig(LMS,
    lms_mu=0.25) into a port config with which both executors give JAX's
    records."""
    jphy = jconfig.PhyConfig(chan_est=jconfig.ChannelEstimator.LMS, lms_mu=0.25)
    kw = dict(block_size=8192, time_shards=2, max_frames_per_block=4, wire_format="sc16")
    phy, ex = state.load_reference_state(
        state.reference_arrays(jparams),
        {"phy": dataclasses.asdict(jphy),
         "executor": dataclasses.asdict(jconfig.ExecutorConfig(**kw))})
    assert phy == PhyConfig(chan_est=ChannelEstimator.LMS, lms_mu=0.25)
    assert ex == ExecutorConfig(**kw)
    x, frames = _stream(37, mcs=4, length=80)
    jex = jconfig.ExecutorConfig(**kw)
    _records_equal(StreamExecutor(tx.tx_plan(4, 80), exec_cfg=ex, phy_cfg=phy,
                                  device="cpu").run(x),
                   JStreamExecutor(jtx.tx_plan(4, 80), mesh=None, exec_cfg=jex,
                                   phy_cfg=jphy).run(x))
    got = AdaptiveStreamExecutor(exec_cfg=ex, phy_cfg=phy, device="cpu").run(x)
    _records_equal(got, JAdaptive(mesh=None, exec_cfg=jex, phy_cfg=jphy).run(x))
    assert {tuple(f) for f in frames} <= {tuple(r.psdu) for r in got if r.parity_ok}


def test_frame_record_carries_eq_symbols():
    assert exmod.FrameRecord(0, 0, np.zeros(1, np.uint8), True, 0, 1, 0.0).eq_symbols is None
    assert [f.name for f in dataclasses.fields(exmod.FrameRecord)] == [
        "channel", "global_start", "psdu", "parity_ok", "rate_idx", "length", "cfo",
        "snr_db", "eq_symbols"]
