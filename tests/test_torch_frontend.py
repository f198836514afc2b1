"""The port's rate-conversion front-end (parallel/frontend.py) and the local
StreamExecutor with a front-end, against the JAX package on the CPU.

Host geometry (ratios, factoring, padded geometry, block cuts) must equal
JAX's exactly. Corrected streams agree within 1e-4 (float32 sums of two
libraries). Executor records must be the same FrameRecords: channel,
global_start, psdu, parity_ok, rate_idx and length exactly; cfo within
1e-5 rad/sample and snr_db within 1e-3 dB, as tests/test_torch_executor.py
holds them. The seeds keep clear of detection-threshold ties (ROADMAP,
Queue 3). Fixtures follow tests/test_frontend.py: exact FFT oversampling
and the JAX package's sample_clock_offset for the clock skew."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.channel.model import sample_clock_offset
from gnuradio_wifi_imagetransfer_tpu.parallel import frontend as jfrontend
from gnuradio_wifi_imagetransfer_tpu.parallel.executor import StreamExecutor as JStreamExecutor
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu_torch import config
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import frontend
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import StreamExecutor
from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

torch.set_num_threads(2)

CONFIGS = {
    "decim2": dict(resample=(1, 2)),
    "ppm+40": dict(ppm=40.0),
    "ppm-40": dict(ppm=-40.0),
    "decim2+40ppm": dict(resample=(1, 2), ppm=40.0),
    "general3/4": dict(resample=(3, 4)),
}
ATOL = 1e-4


def _pair(name):
    """The same front-end in both packages."""
    kw = CONFIGS[name]
    return (frontend.Frontend(config.FrontendConfig(**kw)),
            jfrontend.Frontend(jconfig.FrontendConfig(**kw)))


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


# ----------------------------------------------------------------------
# factoring and geometry
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS) + ["decim4-2500ppm", "decim3+100ppm"])
def test_factoring_matches_jax(name):
    kw = CONFIGS.get(name) or {"decim4-2500ppm": dict(resample=(1, 4), ppm=-2500.0),
                               "decim3+100ppm": dict(resample=(1, 3), ppm=100.0)}[name]
    fe, jfe = (frontend.Frontend(config.FrontendConfig(**kw)),
               jfrontend.Frontend(jconfig.FrontendConfig(**kw)))
    assert fe.ratio == jfe.ratio
    assert fe.ratio == frontend.combined_in_per_out(config.FrontendConfig(**kw))
    assert fe.general == jfe.general
    assert (fe.decim is None) == (jfe.decim is None)
    if fe.decim is not None:
        assert (fe.decim.m, fe.decim.k, fe.decim.center) == (jfe.decim.m, jfe.decim.k,
                                                             jfe.decim.center)
        assert np.array_equal(fe.decim.taps, jfe.decim.taps)
    assert (fe.trim is None) == (jfe.trim is None)
    if fe.trim is not None:
        assert (fe.trim.r, fe.trim.delta, fe.trim.k, fe.trim.center, fe.trim.sub) == (
            jfe.trim.r, jfe.trim.delta, jfe.trim.k, jfe.trim.center, jfe.trim.sub)
    for n_in in (1, 99_999, 123_456_789):
        assert fe.out_len(n_in) == jfe.out_len(n_in)


def test_untuned_and_invalid_configs():
    assert frontend.cached_frontend(config.FrontendConfig()) is None
    fe = frontend.cached_frontend(config.FrontendConfig(resample=(3, 4)))
    assert fe is frontend.cached_frontend(config.FrontendConfig(resample=(3, 4)))
    with pytest.raises(ValueError):
        fe.block_ext_in(1000)          # general ratio is local-mode only
    with pytest.raises(ValueError):
        frontend.combined_in_per_out(config.FrontendConfig(resample=(0, 2)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_padded_geometry_equals_jax(name):
    fe, jfe = _pair(name)
    np_out, p_out = 256 + 40_000 + 700, 256
    p_in, n_in_pad, aux = fe.padded_geometry(np_out, p_out)
    jp_in, jn_in_pad, jaux = jfe.padded_geometry(np_out, p_out)
    assert (p_in, n_in_pad) == (jp_in, jn_in_pad)
    assert len(aux) == len(jaux)
    for a, ja in zip(aux, jaux):
        ja = np.asarray(ja)
        assert a.numpy().dtype == ja.dtype
        assert np.array_equal(a.numpy(), ja)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_correct_padded_matches_jax(name):
    fe, jfe = _pair(name)
    np_out, p_out = 256 + 20_000 + 700, 256
    p_in, n_in_pad, aux = fe.padded_geometry(np_out, p_out)
    _, _, jaux = jfe.padded_geometry(np_out, p_out)
    buf = np.zeros((2, n_in_pad), np.complex64)
    n_in = n_in_pad - p_in - 40
    buf[:, p_in: p_in + n_in] = _noise(2 * n_in, 3).reshape(2, n_in)
    got = fe.correct_padded(torch.from_numpy(buf), np_out, p_out, aux).numpy()
    want = np.asarray(jax.jit(lambda a: jfe.correct_padded(a, np_out, p_out, jaux))(
        jnp.asarray(buf)))
    assert got.shape == want.shape == (2, np_out)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(resample=(1, 2)), dict(ppm=-40.0),
                                dict(resample=(1, 2), ppm=25.0)])
def test_correct_block_matches_jax(kw):
    fe = frontend.Frontend(config.FrontendConfig(**kw))
    jfe = jfrontend.Frontend(jconfig.FrontendConfig(**kw))
    x = _noise(30_000, 5)
    for s0, ext_out in ((5000, 2048), (0, 4096)):
        in_cut, tau0 = fe.block_cut(s0, ext_out)
        ext_in = fe.block_ext_in(ext_out)
        assert (in_cut, tau0, ext_in) == (*jfe.block_cut(s0, ext_out), jfe.block_ext_in(ext_out))
        cut = np.zeros(ext_in, np.complex64)
        lo, hi = max(in_cut, 0), min(in_cut + ext_in, x.size)
        cut[lo - in_cut: hi - in_cut] = x[lo:hi]
        got = fe.correct_block(torch.from_numpy(cut), tau0, ext_out).numpy()
        want = np.asarray(jax.jit(lambda a, t: jfe.correct_block(a, t, ext_out))(
            jnp.asarray(cut), jnp.float32(tau0)))
        assert got.shape == want.shape == (ext_out,)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ----------------------------------------------------------------------
# the local executor with a front-end
# ----------------------------------------------------------------------


def fft_oversample(x: np.ndarray, m: int) -> np.ndarray:
    """Exact m-times oversampling by FFT zero padding (periodic)."""
    n = len(x)
    spec = np.fft.fft(x)
    up = np.zeros(m * n, np.complex64)
    h = n // 2
    up[:h] = spec[:h]
    up[-h:] = spec[-h:]
    return (np.fft.ifft(up) * m).astype(np.complex64)


def _stream(seed, n=120_000, n_frames=6):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, 50), dtype=np.uint8)
    bursts = np.asarray(jtx.transmit(jnp.asarray(frames), 2))
    x = (0.012 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    step = (n - 8000) // n_frames
    for i in range(n_frames):
        s = 4000 + i * step
        x[s: s + bursts.shape[1]] += bursts[i]
    return x, frames


def _capture(kind, seed):
    """(input-rate capture, sent frames, front-end kwargs) of one case."""
    if kind == "general3/4":
        x, frames = _stream(seed, n=90_000, n_frames=4)
        return fft_oversample(x, 4)[::3].copy(), frames, CONFIGS[kind]
    x, frames = _stream(seed)
    kw = CONFIGS.get(kind, {})
    if kw.get("resample") == (1, 2):
        x = fft_oversample(x, 2)
    if kw.get("ppm"):
        x = np.asarray(sample_clock_offset(jnp.asarray(x), kw["ppm"]))
    return x, frames, kw


def _run_both(capture, port_kw, jax_kw, wire):
    ex = dict(block_size=1 << 14, time_shards=2, max_frames_per_block=4, wire_format=wire)
    want = JStreamExecutor(jtx.tx_plan(2, 50), mesh=None, exec_cfg=jconfig.ExecutorConfig(
        frontend=None if jax_kw is None else jconfig.FrontendConfig(**jax_kw), **ex)
    ).run(capture[None, :])
    got = StreamExecutor(tx.tx_plan(2, 50), exec_cfg=config.ExecutorConfig(
        frontend=None if port_kw is None else config.FrontendConfig(**port_kw), **ex),
        device="cpu").run(capture[None, :])
    return got, want


def _assert_same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.global_start, g.parity_ok, g.rate_idx, g.length) == (
            w.channel, w.global_start, w.parity_ok, w.rate_idx, w.length)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.cfo - w.cfo) <= 1e-5
        assert abs(g.snr_db - w.snr_db) <= 1e-3


@pytest.mark.parametrize("kind,wire,seed", [
    ("decim2", "f32", 7),
    ("ppm+40", "sc16", 11),
    ("ppm-40", "f32", 11),
    ("decim2+40ppm", "sc16", 19),
    ("general3/4", "f32", 23),
])
def test_local_executor_with_frontend_matches_jax(kind, wire, seed):
    capture, frames, kw = _capture(kind, seed)
    got, want = _run_both(capture, kw, kw, wire)
    _assert_same_records(got, want)
    ok = {tuple(r.psdu) for r in got if r.parity_ok}
    assert all(tuple(f) in ok for f in frames)


def test_untuned_frontend_matches_none():
    """resample=(1, 1), ppm=0 runs exactly as frontend=None, in the port
    and against the JAX package's run without a front-end."""
    capture, frames = _stream(29, n=60_000, n_frames=3)
    got, want = _run_both(capture, {}, None, "sc16")
    _assert_same_records(got, want)
    base = StreamExecutor(tx.tx_plan(2, 50), exec_cfg=config.ExecutorConfig(
        block_size=1 << 14, time_shards=2, max_frames_per_block=4, wire_format="sc16"),
        device="cpu").run(capture[None, :])
    assert [dataclasses.astuple(r)[:2] for r in base] == [
        dataclasses.astuple(r)[:2] for r in got]
    assert all(np.array_equal(a.psdu, b.psdu) for a, b in zip(base, got))
    assert sum(r.parity_ok for r in got) == len(frames)
