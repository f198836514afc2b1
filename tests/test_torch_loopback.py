"""CPU twin of tests/test_loopback.py: aligned TX -> impairment -> RX, the
port against the JAX package, case for case.

Each case's frames go through JAX's TX and its impairment (noise drawn in
numpy, as the JAX test draws it); then both packages' ``decode_aligned``
decode the same samples. psdu, rate_idx, length and parity_ok must be
equal exactly, eq_symbols and csi within 1e-4 (two float32 FFT libraries,
as tests/test_torch_rx.py), and the port's psdu must be the frames sent."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.config import ChannelEstimator as JChannelEstimator
from gnuradio_wifi_imagetransfer_tpu.phy import rx as jrx
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator
from gnuradio_wifi_imagetransfer_tpu_torch.phy import rx, tx

torch.set_num_threads(2)

FIELDS = ("psdu", "rate_idx", "length", "parity_ok", "eq_symbols", "csi")
_fns = {}


def _jax_decode(samples, mcs, L, start, algo):
    """JAX's decode_aligned, jitted once per (MCS, length, algo, static
    start); a per-frame start is a traced argument."""
    static = start if isinstance(start, int) else None
    key = (mcs, L, algo, static)
    if key not in _fns:
        plan = jtx.tx_plan(mcs, L)

        def fn(y, st):
            r = jrx.decode_aligned(y, plan, start=static if static is not None else st,
                                   algo=JChannelEstimator[algo])
            return (r.psdu, r.sig["rate_idx"], r.sig["length"], r.sig["parity_ok"],
                    r.eq_symbols, r.csi)

        _fns[key] = jax.jit(fn)
    st = jnp.asarray(start if static is None else 0)
    return dict(zip(FIELDS, (np.asarray(v) for v in _fns[key](jnp.asarray(samples), st))))


def _decode_both(samples, mcs, L, start=0, algo="LS"):
    """Both packages' decode of the same complex64 samples, held equal;
    returns the port's fields."""
    samples = np.array(samples, np.complex64)          # a writable copy for torch
    want = _jax_decode(samples, mcs, L, start, algo)
    st = start if isinstance(start, int) else torch.from_numpy(np.asarray(start, np.int32))
    r = rx.decode_aligned(torch.from_numpy(samples), tx.tx_plan(mcs, L), start=st,
                          algo=ChannelEstimator[algo])
    got = dict(zip(FIELDS, (v.numpy() for v in (
        r.psdu, r.sig["rate_idx"], r.sig["length"], r.sig["parity_ok"], r.eq_symbols, r.csi))))
    for f in FIELDS[:4]:
        assert got[f].shape == want[f].shape and np.array_equal(got[f], want[f].astype(
            got[f].dtype)), f
    np.testing.assert_allclose(got["eq_symbols"], want["eq_symbols"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["csi"], want["csi"], atol=1e-4, rtol=0)
    return got


def _transmit(psdu, mcs, seeds=1):
    return np.asarray(jtx.transmit(jnp.asarray(psdu), mcs, scrambler_seed=jnp.asarray(seeds)))


@pytest.mark.parametrize("mcs", range(8))
def test_ideal_loopback_bit_exact(mcs):
    rng = np.random.default_rng(42 + mcs)
    L = 50
    psdu = rng.integers(0, 256, (3, L), dtype=np.uint8)
    burst = _transmit(psdu, mcs, [1, 55, 127])
    assert burst.shape == (3, tx.tx_plan(mcs, L).n_samples)
    got = _decode_both(burst, mcs, L)
    assert np.array_equal(got["psdu"], psdu)
    assert np.all(got["rate_idx"] == mcs) and np.all(got["length"] == L)
    assert np.all(got["parity_ok"])


@pytest.mark.parametrize("mcs,snr_db", [(0, 10), (2, 15), (3, 20), (5, 22), (7, 28)])
def test_awgn_loopback(mcs, snr_db):
    rng = np.random.default_rng(mcs * 100 + snr_db)
    L = 50
    psdu = rng.integers(0, 256, (4, L), dtype=np.uint8)
    burst = _transmit(psdu, mcs)
    sig_pow = np.mean(np.abs(burst) ** 2)
    noise_std = np.sqrt(sig_pow / (10 ** (snr_db / 10)) / 2)
    noise = noise_std * (rng.standard_normal(burst.shape) + 1j * rng.standard_normal(burst.shape))
    got = _decode_both(burst + noise, mcs, L)
    assert np.array_equal(got["psdu"], psdu), f"mcs={mcs} snr={snr_db}"


def test_flat_fading_phase_rotation():
    rng = np.random.default_rng(9)
    L, mcs = 100, 4
    psdu = rng.integers(0, 256, (2, L), dtype=np.uint8)
    burst = _transmit(psdu, mcs)
    got = _decode_both(burst * (0.6 * np.exp(1j * 2.1)), mcs, L)
    assert np.array_equal(got["psdu"], psdu)


def test_nonzero_start_offset():
    rng = np.random.default_rng(10)
    L, mcs = 40, 2
    psdu = rng.integers(0, 256, (2, L), dtype=np.uint8)
    burst = _transmit(psdu, mcs)
    padded = np.concatenate(
        [np.zeros((2, 137), np.complex64), burst, np.zeros((2, 60), np.complex64)], axis=1)
    assert np.array_equal(_decode_both(padded, mcs, L, start=137)["psdu"], psdu)
    # per-frame start indices, as the sync front-end produces them
    assert np.array_equal(_decode_both(padded, mcs, L, start=[137, 137])["psdu"], psdu)


@pytest.mark.parametrize("algo", ["LS", "COMB", "LMS", "STA"])
def test_equalizer_algorithms(algo):
    rng = np.random.default_rng(11)
    L, mcs = 60, 3
    psdu = rng.integers(0, 256, (2, L), dtype=np.uint8)
    burst = _transmit(psdu, mcs)
    assert np.array_equal(_decode_both(burst, mcs, L, algo=algo)["psdu"], psdu), algo


def test_multipath_two_tap():
    rng = np.random.default_rng(12)
    L, mcs = 50, 2
    psdu = rng.integers(0, 256, (2, L), dtype=np.uint8)
    burst = _transmit(psdu, mcs)
    taps = np.array([1.0, 0.0, 0.25 + 0.15j], dtype=np.complex64)
    faded = np.stack([np.convolve(b, taps)[: burst.shape[1]] for b in burst])
    assert np.array_equal(_decode_both(faded, mcs, L)["psdu"], psdu)
