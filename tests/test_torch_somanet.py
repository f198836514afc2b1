"""The port's SOMANet and SOMANetPE (models/somanet.py) against the JAX
package's, on the CPU at a tiny size (16 x 16 images, c = 16, n_irs = 4,
2 users of 2 images).

The JAX variables (params, batch_stats and shared_phi) are carried into the
port's model; the AWGN of the physics paths is JAX's own draws
(``fold_in(key, user)`` and its splits) passed to the port as a tensor.
Tolerances: the simple path's outputs within 1e-6 absolute (outputs
peak at about 2e-2; float32 convolutions summed in another order) and its
batch statistics within 1e-6; the physics paths' outputs within 1e-3 of
their peak (the zero-forcing divides by a CSI of modulus below 1 and the
channel-wise L2 normalisation follows, so rounding moves more there:
measured 2.9e-6 of a 7e-3 peak); the helpers exactly or within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.models import somanet as jsomanet
from gnuradio_wifi_imagetransfer_tpu_torch.models import somanet
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt

torch.set_num_threads(2)

U, B, IMG, C, N_IRS = 2, 2, 16, 16, 4
ATOL = 1e-6


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def soma():
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((U, B, IMG, IMG, 3)) * 0.5).astype(np.float32)
    labels = jsomanet.pe_labels(["3-4", "13-10"]).astype(np.float32)
    jmod = jsomanet.SOMANet(compressed_channel=C, img_size=IMG, n_irs=N_IRS)
    variables = _np(jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(images),
                                       jnp.asarray(labels)))
    port = somanet.SOMANet(C, IMG, N_IRS, device="cpu")
    port.load_state_dict(wt.state_dict_from_flax(variables, port))
    return jmod, variables, port, images, labels


def _envs(seed):
    rng = np.random.default_rng(seed)
    return tuple(((rng.standard_normal((U, N_IRS, 1)) + 1j * rng.standard_normal((U, N_IRS, 1)))
                  / np.sqrt(2)).astype(np.complex64) for _ in range(2))


def test_helpers_match_jax():
    rng = np.random.default_rng(1)
    f = (rng.standard_normal((3, 8)) + 1j * rng.standard_normal((3, 8))).astype(np.complex64)
    f[1] = 0                                           # the zero-power guard
    np.testing.assert_allclose(somanet.power_norm(torch.from_numpy(f), 2.0).numpy(),
                               np.asarray(jsomanet.power_norm(jnp.asarray(f), 2.0)), atol=1e-6)
    x = rng.standard_normal((2, 10)).astype(np.float32)
    z = somanet.complexify(torch.from_numpy(x))
    assert np.array_equal(z.numpy(), np.asarray(jsomanet.complexify(jnp.asarray(x))))
    assert np.array_equal(somanet.decomplexify(z).numpy(), x)
    keys = ["3-4", "13-10", "0-0", "29-59", "45-2"]
    assert np.array_equal(somanet.pe_labels(keys), jsomanet.pe_labels(keys))


def test_somanet_forward_matches_jax(soma):
    jmod, variables, port, images, labels = soma
    want = np.asarray(jax.jit(jmod.apply)(variables, images, labels))
    with torch.no_grad():
        got = port(_nchw(images), torch.from_numpy(labels))
    assert got.shape == (U, B, 3, IMG, IMG)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)
    # train mode: the encoder's BatchNorm on batch statistics, once a user
    jtrain = jax.jit(lambda v, x, lb: jmod.apply(v, x, lb, True, mutable=["batch_stats"]))
    want, mut = jtrain(variables, images, labels)
    port_t = somanet.SOMANet(C, IMG, N_IRS, device="cpu")
    port_t.load_state_dict(wt.state_dict_from_flax(variables, port_t))
    with torch.no_grad():
        got = port_t(_nchw(images), torch.from_numpy(labels), True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)
    stats = wt._flatten(wt.flax_from_module(port_t)["batch_stats"])
    jstats = wt._flatten(_np(mut["batch_stats"]))
    assert stats.keys() == jstats.keys()
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], atol=ATOL, err_msg=k)


def test_somanet_forward_physics_matches_jax(soma):
    jmod, variables, port, images, labels = soma
    envs_tx, envs_rx = _envs(1)
    key = jax.random.key(2)
    phys = jax.jit(lambda v, x, lb, et, er, k: jmod.apply(
        v, x, lb, et, er, k, 20.0, method=jsomanet.SOMANet.forward_physics))
    want = np.asarray(phys(variables, images, labels, envs_tx, envs_rx, key))
    # JAX's draws: for user u, (kr, ki, _) = split(fold_in(key, u), 3)
    n = IMG // 8 * IMG // 8 * C // 2
    draws = []
    for u in range(U):
        kr, ki, _ = jax.random.split(jax.random.fold_in(key, u), 3)
        draws.append(jax.random.normal(kr, (B, n)) + 1j * jax.random.normal(ki, (B, n)))
    noise = torch.from_numpy(np.asarray(jnp.stack(draws)).astype(np.complex64))
    with torch.no_grad():
        got = port.forward_physics(_nchw(images), torch.from_numpy(labels),
                                   torch.from_numpy(envs_tx), torch.from_numpy(envs_rx),
                                   noise, 20.0)
        quiet = port.forward_physics(_nchw(images), torch.from_numpy(labels),
                                     torch.from_numpy(envs_tx), torch.from_numpy(envs_rx))
        drawn = port.forward_physics(_nchw(images), torch.from_numpy(labels),
                                     torch.from_numpy(envs_tx), torch.from_numpy(envs_rx),
                                     torch.Generator().manual_seed(0), 20.0)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-3 * np.abs(want).max())
    want_quiet = np.asarray(jax.jit(lambda v, x, lb, et, er: jmod.apply(
        v, x, lb, et, er, method=jsomanet.SOMANet.forward_physics))(
            variables, images, labels, envs_tx, envs_rx))
    np.testing.assert_allclose(_nhwc(quiet), want_quiet, atol=1e-3 * np.abs(want_quiet).max())
    assert drawn.shape == got.shape and bool(torch.isfinite(drawn).all())
    assert not torch.allclose(drawn, quiet)
    csi = port.get_chnl(torch.from_numpy(envs_tx[0]), torch.from_numpy(envs_rx[0]))
    np.testing.assert_allclose(csi.detach().numpy(), np.asarray(jmod.apply(
        variables, envs_tx[0], envs_rx[0], method=jsomanet.SOMANet.get_chnl)), atol=1e-6)


def test_somanet_pe_matches_jax():
    rng = np.random.default_rng(3)
    images = (rng.standard_normal((U, B, IMG, IMG, 3)) * 0.5).astype(np.float32)
    envs = ((rng.standard_normal((3, N_IRS, 1)) + 1j * rng.standard_normal((3, N_IRS, 1)))
            * 3).astype(np.complex64)
    pairs = np.array([[0, 1], [2, 0]], np.int32)
    jmod = jsomanet.SOMANetPE(compressed_channel=C, img_size=IMG, n_irs=N_IRS)
    key = jax.random.key(4)
    variables = _np(jax.jit(jmod.init)(jax.random.key(0), images, pairs, envs))
    want = np.asarray(jax.jit(jmod.apply)(variables, images, pairs, envs, key))
    draws = []
    for u in range(U):
        kr, ki = jax.random.split(jax.random.fold_in(key, u))
        draws.append(jax.random.normal(kr, (B, 32)) + 1j * jax.random.normal(ki, (B, 32)))
    port = somanet.SOMANetPE(C, IMG, N_IRS, device="cpu")
    port.load_state_dict(wt.state_dict_from_flax(variables, port))
    with torch.no_grad():
        got = port(_nchw(images), pairs, torch.from_numpy(envs),
                   torch.from_numpy(np.asarray(jnp.stack(draws)).astype(np.complex64)))
    assert got.shape == (U, B, 3, IMG, IMG)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-3 * np.abs(want).max())
    # the PE label lookup from the pair's own CSI
    csi = port.get_chnl(torch.from_numpy(envs[0]), torch.from_numpy(envs[1]))[0, 0]
    jcsi = np.asarray(jmod.apply(variables, envs[0], envs[1],
                                 method=jsomanet.SOMANetPE.get_chnl))[0, 0]
    np.testing.assert_allclose(csi.detach().numpy(), jcsi, atol=1e-5)
    assert np.array_equal(port._pe_label(csi).numpy(), np.asarray(jmod.apply(
        variables, jnp.asarray(jcsi), method=jsomanet.SOMANetPE._pe_label)))


def test_models_initialise_from_a_seed():
    a = somanet.SOMANet(C, IMG, N_IRS, seed=5, device="cpu")
    b = somanet.SOMANet(C, IMG, N_IRS, seed=5, device="cpu")
    c = somanet.SOMANet(C, IMG, N_IRS, seed=6, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["shared_phi"], sc["shared_phi"])
    phi = sa["shared_phi"]
    assert phi.shape == (N_IRS,) and bool(((phi >= 0) & (phi < 2 * 3.14)).all())
    # Flax's initialisers: gamma sqrt(0.1 I + pedestal), PReLU 0.25, zero biases
    gdn = a.shared_decoder.convBlock1.gdn1
    assert torch.allclose(gdn.gamma, torch.sqrt(0.1 * torch.eye(256) + gdn.pedestal))
    assert float(a.shared_decoder.convBlock1.prelu1.weight.detach()[0]) == 0.25
    assert float(a.shared_encoder.attention1.fc1.bias.detach().abs().max()) == 0.0
