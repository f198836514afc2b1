"""The port's Viterbi decoder (ops/viterbi_acs.py plain path on the CPU)
against the JAX package's, bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.ops import pallas_viterbi
from gnuradio_wifi_imagetransfer_tpu.phy import bits as jbits
from gnuradio_wifi_imagetransfer_tpu.phy import viterbi as jviterbi
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs
from gnuradio_wifi_imagetransfer_tpu_torch.phy import viterbi

torch.set_num_threads(2)

N_BITS = 240
FRAMES = 6


def _coded_llrs(rng, terminated, rate=None, noise=0.0):
    """LLRs of random frames through the JAX encoder: (FRAMES, 2*N_BITS)."""
    b = rng.integers(0, 2, (FRAMES, N_BITS), dtype=np.uint8)
    if terminated:
        b[:, -6:] = 0
    coded = np.asarray(jbits.conv_encode(jnp.asarray(b)))
    llr = (2.0 * coded - 1.0 + noise * rng.standard_normal(coded.shape)).astype(np.float32)
    if rate is not None:
        kept = jbits.puncture(jnp.asarray(llr), rate)
        llr = np.asarray(jbits.depuncture(kept, rate, llr.shape[-1]))
    return llr, b


def _llrs(kind, terminated, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((FRAMES, 2 * N_BITS)).astype(np.float32) * 3, None
    if kind == "tied":       # small integers: equal path metrics are common
        return rng.integers(-2, 3, (FRAMES, 2 * N_BITS)).astype(np.float32), None
    if kind == "noisy":
        return _coded_llrs(rng, terminated, noise=0.8)
    return _coded_llrs(rng, terminated, rate=kind, noise=0.3)     # "2/3", "3/4"


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("kind", ["random", "tied", "noisy", "2/3", "3/4"])
def test_decode_matches_jax(kind, terminated):
    llr, sent = _llrs(kind, terminated, seed=len(kind) + terminated)
    want = np.asarray(jviterbi.decode(jnp.asarray(llr), N_BITS, terminated=terminated))
    got = viterbi.decode(torch.from_numpy(llr), N_BITS, terminated=terminated)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    if sent is not None and kind != "noisy":
        assert np.array_equal(got.numpy(), sent)       # mild noise decodes clean


def test_decode_matches_pallas_interpret():
    """The TPU kernel itself, run in interpret mode: 24 steps, 5 frames."""
    rng = np.random.default_rng(11)
    llr = rng.integers(-3, 4, (5, 48)).astype(np.float32)
    want = np.asarray(pallas_viterbi.decode(jnp.asarray(llr), 24, interpret=True))
    got = viterbi.decode(torch.from_numpy(llr), 24, terminated=True)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("terminated", [(True, True), (True, False), (False, True, False)])
def test_decode_many_matches_separate_decodes_and_jax(terminated):
    """Mixed lengths in one call (SIGNAL's 24 steps beside longer
    trellises): each segment equals its own decode and the JAX decode."""
    rng = np.random.default_rng(len(terminated) + sum(terminated))
    lengths = [24, N_BITS, 61][: len(terminated)]
    llrs = [rng.integers(-2, 3, (FRAMES - i, 2 * nb)).astype(np.float32)
            for i, nb in enumerate(lengths)]
    got = viterbi.decode_many([torch.from_numpy(v) for v in llrs], lengths, terminated)
    for g, v, nb, t in zip(got, llrs, lengths, terminated):
        assert g.shape == (v.shape[0], nb) and g.dtype == torch.uint8
        assert torch.equal(g, viterbi.decode(torch.from_numpy(v), nb, terminated=t))
        want = np.asarray(jviterbi.decode(jnp.asarray(v), nb, terminated=t))
        assert np.array_equal(g.numpy(), want)


def test_viterbi_decode_many_plain_is_per_segment():
    rng = np.random.default_rng(3)
    segs = [torch.from_numpy((3 * rng.standard_normal((b, n, 2))).astype(np.float32))
            for b, n in ((4, 30), (1, 7), (0, 5))]
    flags = [True, False, True]
    got = viterbi_acs.viterbi_decode_many(segs, flags)       # CPU: the plain version
    want = [viterbi_acs.viterbi_decode_plain(v, t) for v, t in zip(segs, flags)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        viterbi_acs.viterbi_decode_many(segs, flags[:2])
