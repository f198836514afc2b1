"""CPU twin of tests/test_waterfall.py: the modem's error behaviour, the
port against the JAX package.

The same frames (rng 0) go through JAX's TX; the noise is drawn in numpy
(JAX's ``jax.random.key`` stream has no torch twin) by the port's
harness (``utils/scenarios.py``), which chip_smoke.py's phase 34 runs on
the card at full size. Both packages' ``decode_aligned`` decode every
point: psdu, rate_idx, length and parity_ok equal exactly, eq_symbols and
csi within 1e-4 (two float32 FFT libraries, as tests/test_torch_rx.py)
and 1e-5 of the value (``RTOL``), so the PER tables are equal; then
test_waterfall.py's own assertions hold on them. The fading table is cut
to 8 frames at 15 and 35 dB (the card runs it whole)."""

import importlib.util
import pathlib

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
from gnuradio_wifi_imagetransfer_tpu_torch.utils import scenarios as sc

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
# test_waterfall.py's AWGN points: the regimes, the ladder, the MCS-3 sweep
AWGN = {0: (-2.0, 8.0, 10.0), 3: (2.0, 4.0, 6.0, 10.0, 14.0, 18.0), 7: (10.0, 14.0, 26.0)}
FIELDS = ("psdu", "rate_idx", "length", "parity_ok")
# eq_symbols and csi: 1e-4 at unit scale, and a few float32 ulps of the
# symbols that a deep fade's small LS estimate blows up at low SNR (up to
# about 150 at -2 dB, where the two FFT libraries differ by 2e-6 of it)
RTOL = 1e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FADING = dict(sc.FADING, frames=8, snrs=(15.0, 35.0))


def jax_transmit(psdu, mcs, seeds):
    return np.asarray(jtx.transmit(jnp.asarray(psdu), mcs, scrambler_seed=jnp.asarray(seeds)))


def _jax_decode(y, mcs, psdu_len, algo):
    fn = _jitted(mcs, psdu_len, algo)
    return {k: np.asarray(v) for k, v in zip(FIELDS + ("eq_symbols", "csi"), fn(y))}


_fns = {}


def _jitted(mcs, psdu_len, algo):
    key = (mcs, psdu_len, algo)
    if key not in _fns:
        plan = jtx.tx_plan(mcs, psdu_len)

        @jax.jit
        def fn(y):
            r = jrx.decode_aligned(y, plan, start=0, algo=JChannelEstimator[algo])
            return (r.psdu, r.sig["rate_idx"], r.sig["length"], r.sig["parity_ok"],
                    r.eq_symbols, r.csi)

        _fns[key] = fn
    return _fns[key]


def _port_decode(y, mcs, psdu_len, algo):
    r = rx.decode_aligned(torch.from_numpy(y), tx.tx_plan(mcs, psdu_len), start=0,
                          algo=ChannelEstimator[algo])
    out = dict(zip(FIELDS, (r.psdu, r.sig["rate_idx"], r.sig["length"], r.sig["parity_ok"])))
    return {k: v.numpy() for k, v in dict(out, eq_symbols=r.eq_symbols, csi=r.csi).items()}


_tables = {}


def _tables_of(name):
    """Both packages' tables over one scenario's points ("awgn" or
    "fading"), made once, with the sent frames."""
    if name not in _tables:
        snrs = AWGN if name == "awgn" else {}
        fading = FADING if name == "fading" else dict(FADING, algos=())
        inputs = sc.waterfall_inputs(jax_transmit, snrs=snrs, fading=fading)
        tables = [sc.waterfall_tables(inputs, dec, snrs=snrs, fading=fading)
                  for dec in (_jax_decode, _port_decode)]
        _tables[name] = (inputs, *tables)
    return _tables[name]


def _per(name):
    """The PER of every point of the scenario, after holding the port's
    decode against JAX's at each."""
    inputs, want, got = _tables_of(name)
    for key in want:
        w, g = want[key], got[key]
        for f in FIELDS:
            assert np.array_equal(g[f], w[f].astype(g[f].dtype)), (key, f)
        for f in ("eq_symbols", "csi"):
            np.testing.assert_allclose(g[f], w[f], atol=1e-4, rtol=RTOL, err_msg=str(key))
    errs = sc.frame_errors(want, inputs)
    assert all(np.array_equal(e, sc.frame_errors(got, inputs)[k]) for k, e in errs.items())
    return {k: float(e.mean()) for k, e in errs.items()}


@pytest.mark.parametrize("mcs,ok_snr,fail_snr", [
    (0, 8.0, -2.0),
    (3, 14.0, 4.0),
    (7, 26.0, 14.0),
])
def test_per_regimes(mcs, ok_snr, fail_snr):
    per = _per("awgn")
    assert per[("awgn", mcs, ok_snr)] == 0.0, f"MCS{mcs} should be clean at {ok_snr} dB"
    assert per[("awgn", mcs, fail_snr)] > 0.5, f"MCS{mcs} should fail at {fail_snr} dB"


def test_rate_ladder_orders():
    per = _per("awgn")
    assert per[("awgn", 0, 10.0)] == 0.0
    assert per[("awgn", 7, 10.0)] == 1.0


def test_per_monotone_in_snr():
    per = _per("awgn")
    pers = [per[("awgn", 3, s)] for s in (2.0, 6.0, 10.0, 14.0, 18.0)]
    assert all(a >= b - 0.07 for a, b in zip(pers, pers[1:])), pers
    assert pers[0] > 0.5 and pers[-1] == 0.0, pers
    assert sc.waterfall_failures(per) == []


def test_equalizer_algorithm_waterfall_over_fading_reduced():
    """test_waterfall.py:80's table cut to 8 frames at 15 and 35 dB:
    equal in both packages frame by frame, and its assertions hold."""
    per = _per("fading")
    assert sc.waterfall_failures(per) == [], per


def test_fading_burst_is_test_waterfalls():
    """The port's copy of the channel (it imports nothing of the tests)
    makes test_waterfall.py's bursts."""
    wf = _load("_waterfall_twin_of", "tests/test_waterfall.py")
    burst = (np.random.default_rng(1).standard_normal(3000) * (1 + 1j)).astype(np.complex64)
    for seed in (100, 107):
        want = wf._fading_burst(burst, np.random.default_rng(seed))
        assert np.array_equal(sc.fading_burst(burst, np.random.default_rng(seed)), want)
