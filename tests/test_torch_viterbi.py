"""The port's Viterbi decoder (ops/viterbi_acs.py plain path on the CPU)
against the JAX package's, bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.ops import pallas_viterbi
from gnuradio_wifi_imagetransfer_tpu.phy import bits as jbits
from gnuradio_wifi_imagetransfer_tpu.phy import viterbi as jviterbi
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
