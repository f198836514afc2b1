"""The port's RX back half (phy/rx.py: FFT demod, LS equalizer, SIGNAL,
demap, deinterleave, depuncture, Viterbi, descramble) against the JAX
package for all 8 MCSs, with static and per-frame preamble offsets.

Decoded bytes and the SIGNAL fields must match exactly. Equalized symbols
and CSI agree within 1e-4: two float32 FFT libraries differ by a few ulps
of unit-scale values."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.phy import rx as jrx
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu_torch.phy import rx, tx

torch.set_num_threads(2)

L = 31
OFFSETS = np.array([40, 57, 81], np.int32)
STATIC = 40
_cache = {}


def _case(mcs):
    """JAX-made bursts of one MCS at per-frame offsets in noisy windows,
    the same frames re-cut at one static offset, and the JAX decode. The
    JAX decode runs once per MCS (per-frame offsets); the re-cut windows
    hold the very same frame samples, so it is their reference too."""
    if mcs not in _cache:
        rng = np.random.default_rng(100 + mcs)
        frames = rng.integers(0, 256, (3, L), dtype=np.uint8)
        bursts = np.asarray(jtx.transmit(jnp.asarray(frames), mcs,
                                         scrambler_seed=jnp.asarray([3, 9, 27])))
        n = bursts.shape[1] + 200
        noise = 0.01 * (rng.standard_normal((3, n + 50)) + 1j * rng.standard_normal((3, n + 50)))
        dyn = noise[:, :n].astype(np.complex64)
        stat = np.empty_like(dyn)
        for i, off in enumerate(OFFSETS):
            dyn[i, off: off + bursts.shape[1]] += 0.5 * bursts[i]
            shift = off - STATIC
            stat[i] = noise[i, shift: shift + n]
            stat[i, STATIC: STATIC + bursts.shape[1]] = dyn[i, off: off + bursts.shape[1]]
        plan = jtx.tx_plan(mcs, L)
        fn = jax.jit(lambda s, st: _unpack(jrx.decode_aligned(s, plan, start=st)))
        _cache[mcs] = (frames, dyn, stat, [np.asarray(v) for v in fn(dyn, OFFSETS)])
    return _cache[mcs]


def _unpack(res):
    return (res.psdu, res.sig["rate_idx"], res.sig["length"], res.sig["parity_ok"],
            res.sig["raw_bits"], res.eq_symbols, res.csi)


@pytest.mark.parametrize("start", ["static", "per_frame"])
@pytest.mark.parametrize("mcs", range(8))
def test_decode_aligned_matches_jax(mcs, start):
    frames, dyn, stat, want = _case(mcs)
    plan = tx.tx_plan(mcs, L)
    if start == "static":
        res = rx.decode_aligned(torch.from_numpy(stat), plan, start=STATIC)
    else:
        res = rx.decode_aligned(torch.from_numpy(dyn), plan, start=torch.from_numpy(OFFSETS))
    got = [v.numpy() for v in _unpack(res)]
    for g, w in zip(got[:5], want[:5]):          # psdu and SIGNAL fields
        assert g.shape == w.shape and np.array_equal(g, w.astype(g.dtype))
    assert np.array_equal(got[0], frames)
    assert got[1].tolist() == [mcs] * 3 and got[3].all()
    np.testing.assert_allclose(got[5], want[5], atol=1e-4, rtol=0)   # eq_symbols
    np.testing.assert_allclose(got[6], want[6], atol=1e-4, rtol=0)   # csi


@pytest.mark.parametrize("mcs", range(8))
def test_signal_llrs_and_parse_match_jax(mcs):
    """SIGNAL decoding in its two halves (demap + deinterleave, then the
    fields of the decoded bits) equals the one-call decode and JAX's."""
    from gnuradio_wifi_imagetransfer_tpu.phy import signal_field as jsig
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import signal_field, viterbi

    rng = np.random.default_rng(mcs)
    length = np.array([1, 31, 500, 4095], np.int32)
    sym = np.asarray(jsig.encode(mcs, jnp.asarray(length)))
    sym = (sym + 0.4 * (rng.standard_normal(sym.shape) + 1j * rng.standard_normal(sym.shape))
           ).astype(np.complex64)
    want = jsig.decode(jnp.asarray(sym))
    s = torch.from_numpy(sym)
    got = signal_field.parse(viterbi.decode(signal_field.signal_llrs(s), 24))
    one = signal_field.decode(s)
    for key in ("rate_idx", "length", "parity_ok", "raw_bits"):
        assert torch.equal(got[key], one[key])
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]).astype(
            got[key].numpy().dtype))
