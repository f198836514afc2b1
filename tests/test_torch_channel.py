"""The port's channel model (channel/model.py) and pad_burst against the
JAX package on the CPU. The deterministic parts agree within 1e-5
(float32 arithmetic of two libraries); the noise comes from a torch
Generator, so only its statistics are checked."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.channel import model as jmodel
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu_torch.channel import model
from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

torch.set_num_threads(2)

ATOL = 1e-5


def _signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


@pytest.mark.parametrize("taps", [(1.0,), (0.8 - 0.2j,), (1.0, 0.0, 0.3j, -0.1),
                                  (0.9, 0.35 + 0.1j, 0, 0, 0, 0, 0, 0, 0.2)])
def test_multipath_matches_jax(taps):
    x = _signal((2, 3, 700))
    got = model.multipath(torch.from_numpy(x), taps)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.multipath(jnp.asarray(x), taps)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("fo", [0.0, 1e-3, -0.013, np.array([[2e-4], [-5e-3]], np.float32)])
def test_apply_cfo_matches_jax(fo):
    x = _signal((2, 4000), seed=1)
    fo_t = torch.from_numpy(fo) if isinstance(fo, np.ndarray) else fo
    fo_j = jnp.asarray(fo) if isinstance(fo, np.ndarray) else fo
    got = model.apply_cfo(torch.from_numpy(x), fo_t)
    want = np.asarray(jmodel.apply_cfo(jnp.asarray(x), fo_j))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ppm,n_taps", [(40.0, 16), (-40.0, 16), (120.0, 8)])
def test_sample_clock_offset_matches_jax(ppm, n_taps):
    x = _signal((2, 6000), seed=2)
    got = model.sample_clock_offset(torch.from_numpy(x), ppm, n_taps)
    want = np.asarray(jmodel.sample_clock_offset(jnp.asarray(x), ppm, n_taps))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(), dict(snr_db=12.0, frequency_offset=2e-3),
                                dict(taps=(1.0, 0.2j), clock_ppm=40.0, frequency_offset=-1e-3)])
def test_channel_model_without_noise_matches_jax(kw):
    x = _signal((3, 2500), seed=3)
    got = model.channel_model(torch.Generator().manual_seed(0), torch.from_numpy(x),
                              noise_voltage=0.0, **kw)
    want = np.asarray(jmodel.channel_model(jax.random.PRNGKey(0), jnp.asarray(x),
                                           noise_voltage=0.0, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL * max(1, 10 ** (kw.get(
        "snr_db", 0) / 20)), rtol=0)


def test_awgn_power_and_seed():
    x = torch.zeros(4, 50_000, dtype=torch.complex64)
    y = model.awgn(torch.Generator().manual_seed(5), x, 0.3)
    assert y.dtype == torch.complex64
    p = (y.abs() ** 2).mean().item()
    assert abs(p - 0.09) < 0.09 * 0.02                       # total power nv^2
    assert abs(y.real.var().item() - y.imag.var().item()) < 0.09 * 0.02
    again = model.awgn(torch.Generator().manual_seed(5), x, 0.3)
    assert torch.equal(y, again)
    per_row = model.awgn(torch.Generator().manual_seed(5), x,
                         torch.tensor([[0.1], [0.2], [0.3], [0.4]]))
    np.testing.assert_allclose((per_row.abs() ** 2).mean(-1).numpy(), [0.01, 0.04, 0.09, 0.16],
                               rtol=0.03)


def test_epsilon_to_frequency_offset_matches_jax():
    for eps in (-20e-6, 0.0, 7.5e-6):
        assert model.epsilon_to_frequency_offset(eps) == jmodel.epsilon_to_frequency_offset(eps)
        assert (model.epsilon_to_frequency_offset(eps, 2.4e9)
                == jmodel.epsilon_to_frequency_offset(eps, 2.4e9))


@pytest.mark.parametrize("kw", [dict(), dict(pad_front=7, pad_tail=0, scale=2.0)])
def test_pad_burst_equals_jax(kw):
    b = tx.transmit(np.arange(2 * 30, dtype=np.uint8).reshape(2, 30), 3, device="cpu")
    got = tx.pad_burst(b, **kw)
    want = np.asarray(jtx.pad_burst(jnp.asarray(b.numpy()), **kw))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
