"""The port's SV and IRS channels (channel/sv.py, channel/irs.py) and the
trainer's environment against the JAX package's, on the CPU.

The two packages draw from different generators (a torch.Generator, a JAX
PRNG key), so every test that draws makes JAX's draws from the same key
splits the JAX function makes and feeds them to the port's deterministic
function of the draws (``sv_taps``, ``rician_mix``, ``awgn_from``).
Tolerances: the SV taps and steering matrices within 5e-7 (a few float32
ulps of unit-magnitude values: exp, sqrt and the norm of two libraries;
measured 1.2e-7);
LoS entries with the carrier phase e^{-jkd} within 1e-4 (k d is some 470
rad, and one float32 ulp of d moves it by 5e-5 rad); the numpy-phased
codebooks within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.channel import irs as jirs
from gnuradio_wifi_imagetransfer_tpu.channel import sv as jsv
from gnuradio_wifi_imagetransfer_tpu.utils import trainer as jtrainer
from gnuradio_wifi_imagetransfer_tpu_torch.channel import irs, sv
from gnuradio_wifi_imagetransfer_tpu_torch.channel.model import channel_model
from gnuradio_wifi_imagetransfer_tpu_torch.phy import sync, tx
from gnuradio_wifi_imagetransfer_tpu_torch.utils import trainer

torch.set_num_threads(2)

USERS = np.array([[0.3, 0.2, 1.0], [0.1, 0.4, 1.5]])
SV_ATOL = 5e-7
PHASE_ATOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _jax_cn(key, shape):
    """cn() of the JAX channels: split, (re + j im) / sqrt(2)."""
    kr, ki = jax.random.split(key)
    return (jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape)) / jnp.sqrt(2.0)


def _sv():
    geo = dict(irs_scale=4, irs_pos=(0.015, 0.015, 0.0), ap_pos=(0.24, 0.24, 4.5),
               user_num=2, antenna_num=3)
    return jsv.SVChannel(**geo), sv.SVChannel(**geo, device="cpu")


@pytest.mark.parametrize("trial", range(6))
def test_sv_taps_from_jax_draws_match(trial):
    """sv_impulse_response(key(trial), 6 taps, decay 1.5): the port's taps
    from JAX's gains and mask (the splits of channel/sv.py:137-141)."""
    key = jax.random.key(trial)
    kg, km = jax.random.split(key)
    kr, ki = jax.random.split(kg)
    gains = (jax.random.normal(kr, (6,)) + 1j * jax.random.normal(ki, (6,))) / jnp.sqrt(2.0)
    profile = jnp.exp(-jnp.arange(6) / 1.5)
    mask = jax.random.bernoulli(km, jnp.minimum(1.0, 0.25 + profile), (6,))
    got = sv.sv_taps(_t(gains).to(torch.complex64), _t(mask), ray_decay=1.5)
    want = jsv.sv_impulse_response(key, n_taps=6, ray_decay=1.5)
    assert got.dtype == torch.complex64 and got.shape == (6,)
    _close(got, want, SV_ATOL)
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-6


def test_sv_taps_silent_first_tap_and_generator():
    taps = sv.sv_taps(torch.zeros(4, dtype=torch.complex64), torch.ones(4, dtype=torch.bool),
                      normalize=False)
    assert taps.tolist() == [1, 0, 0, 0]
    g = lambda: torch.Generator().manual_seed(3)       # noqa: E731
    a, b = sv.sv_impulse_response(g(), n_taps=6), sv.sv_impulse_response(g(), n_taps=6)
    assert torch.equal(a, b) and a.shape == (6,)


def test_sv_channel_geometry_matches_jax():
    """The twin of tests/test_channel.py test_sv_channel_geometry."""
    jch, ch = _sv()
    los = ch.gen_los(USERS)
    for got, want in zip(los, jch.gen_los(USERS)):
        _close(got, want, SV_ATOL)
    assert [tuple(h.shape) for h in los] == [(3, 16), (16, 2), (3, 2)]
    assert np.allclose(np.abs(los[0].numpy()), 1.0, atol=1e-5)
    # Rician mixing of JAX's draws (gen_nonlos' splits)
    key = jax.random.key(0)
    k1, k2, k3 = jax.random.split(key, 3)
    nlos = [_jax_cn(k1, (3, 16)), _jax_cn(k2, (16, 2)), _jax_cn(k3, (3, 2))]
    got = sv.rician_mix(los, [_t(n).to(torch.complex64) for n in nlos], 10.0)
    for g, w in zip(got, jch.gen_rician(key, USERS, k_factor=10.0)):
        _close(g, w, 1e-6)
    # K -> huge reduces to LoS; the aggregate against a numpy oracle
    gen = torch.Generator().manual_seed(0)
    _close(ch.gen_rician(gen, USERS, k_factor=1e9)[0], los[0], 1e-3)
    psi = np.exp(1j * np.linspace(0, np.pi, 16)).astype(np.complex64)
    h = ch.aggregate(*los, _t(psi))
    _close(h, jch.aggregate(*jch.gen_los(USERS), jnp.asarray(psi)), 1e-5)
    ref = los[0].numpy() @ np.diag(psi) @ los[1].numpy() + los[2].numpy()
    _close(h, ref, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(ch.gen_rayleigh(USERS), los))
    for got, want in zip(ch.gen_awgn(), jch.gen_awgn()):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_irs_channel_mmse_and_aggregate_match_jax():
    """The twin of tests/test_channel.py test_irs_channel_mmse_and_aggregate."""
    jch, ch = jirs.IRSChannel(2, 2, 16), irs.IRSChannel(2, 2, 16, device="cpu")
    args = ((0.24, 0.24, 4.5), (0.015, 0.015, 0.0), USERS)
    los = ch.gen_los(*args)
    for got, want in zip(los, jch.gen_los(*args)):
        _close(got, want, PHASE_ATOL)
    psi = torch.exp(1j * torch.arange(16.0))
    h = irs.IRSChannel.get_chnl(*los, psi)
    ref = los[1].numpy() @ np.diag(psi.numpy()) @ los[2].numpy() + los[0].numpy()
    _close(h, ref, 1e-4)
    _close(irs.IRSChannel.ch_est(h, 0.0, torch.eye(2, dtype=torch.complex64)), h, 1e-5)
    _close(irs.IRSChannel.ch_est(h, 0.5, torch.eye(2, dtype=torch.complex64)), h / 1.5, 1e-5)
    h11 = irs.channel_mdl((0, 0, 0), (1, 0, 0), (1, 1, 1), (1, 1, 1), f=5e9)
    k = 2 * np.pi * 5e9 / 3e8
    assert np.isclose(np.angle(h11.numpy()[0, 0]), np.angle(np.exp(-1j * k)), atol=1e-3)
    # noise and propagation from JAX's draws: y = H s + (re + j im) sigma / sqrt(2)
    key = jax.random.key(4)
    kr, ki = jax.random.split(key)
    draws = jax.random.normal(kr, (2, 2)) + 1j * jax.random.normal(ki, (2, 2))
    _close(irs.awgn_from(_t(draws).to(torch.complex64), 0.3), jch.noise(key, 0.3), 1e-7)
    sig = (np.arange(4).reshape(2, 2) + 1j).astype(np.complex64)
    want = jch.propagation(key, jnp.asarray(sig), jnp.asarray(h.numpy()), 0.3)
    _close(h @ _t(sig) + irs.awgn_from(_t(draws).to(torch.complex64), 0.3), want, 1e-5)
    gen = torch.Generator().manual_seed(1)
    assert ch.propagation(gen, _t(sig), h, 0.3).shape == (2, 2)
    assert [tuple(n.shape) for n in ch.gen_nonlos(gen)] == [(2, 2), (2, 16), (16, 2)]
    _close(irs.dft_matrix(8), jirs.dft_matrix(8), 1e-6)


def _clustered():
    geo = dict(irs_unit_gap=0.03, irs_scale=8, cluster_scale=2, irs_pos=(0.015, 0.015, 0.0),
               ap_pos=(0.12, 0.12, 4.5), user_num=2, ap_num=1)
    return jirs.ClusteredIRSChannel(**geo), irs.ClusteredIRSChannel(**geo, device="cpu")


def test_clustered_irs_channel_matches_jax():
    """The twin of tests/test_channel.py test_clustered_irs_channel, each
    output against JAX's."""
    jch, ch = _clustered()
    assert ch.group_scale == 4 and ch.group_num == 16
    los, jlos = ch.gen_los(USERS), jch.gen_los(USERS)
    assert [tuple(h.shape) for h in los] == [(1, 2), (1, 16), (16, 2)]
    for got, want in zip(los, jlos):
        _close(got, want, PHASE_ATOL)
    jlos_t = tuple(_t(h) for h in jlos)
    ones = torch.ones(16, dtype=torch.complex64)
    assert ch.gen_chnl_ideal(los, ones).shape == (1, 2)
    _close(ch.gen_chnl_ideal(jlos_t, ones), jch.gen_chnl_ideal(jlos, jnp.ones(16)), 1e-5)
    # Rician refresh from JAX's draws (gen_chnl's splits), on JAX's LoS
    key = jax.random.key(0)
    ks = jax.random.split(key, 3)
    nlos = [_t(_jax_cn(k, h.shape)).to(torch.complex64) for k, h in zip(ks, jlos)]
    h_d, h_r2b, h_u2r = irs.rician_mix(jlos_t, nlos, 10.0)
    for got, want in zip((h_r2b, h_u2r, h_d), jch.gen_chnl(key, jlos, k_factor=10.0)):
        _close(got, want, 1e-6)
    got = ch.gen_chnl(torch.Generator().manual_seed(0), los, 10.0)
    assert [tuple(h.shape) for h in got] == [(1, 16), (16, 2), (1, 2)]
    for theta, phi in ((0.3, 0.1), (0.0, 0.7)):
        phases = ch.gen_phase_nograd(theta, phi)
        assert phases.shape == (4, 4)
        _close(phases, jch.gen_phase_nograd(theta, phi), 1e-6)
    inc = ch.gen_incidence_phase()
    _close(inc, jch.gen_incidence_phase(), 1e-6)
    assert np.all(np.abs(inc.numpy()) <= np.pi + 1e-6)


def test_environment_reset_and_graph_match_jax():
    """The twin of tests/test_training.py test_environment_reset_and_graph:
    the same numpy positions and SNRs, the LoS within the phase tolerance,
    the graph equal."""
    env = trainer.Environment(user_num=2, irs_scale=4, dynamic_position=True, device="cpu")
    jenv = jtrainer.Environment(user_num=2, irs_scale=4, dynamic_position=True)
    gen = torch.Generator().manual_seed(0)
    (h_r2b, h_u2r, h_d), snr = env.reset(gen)
    _, jsnr = jenv.reset(jax.random.key(0))
    assert h_r2b.shape == (1, 16) and h_u2r.shape == (16, 2) and h_d.shape == (1, 2)
    assert snr == jsnr and np.array_equal(env.usr_pos, jenv.usr_pos)
    for got, want in zip(env._los, jenv._los):
        _close(got, want, PHASE_ATOL)
    graph, edges = env.get_pos()
    jgraph, jedges = jenv.get_pos()
    assert np.array_equal(graph, jgraph) and np.array_equal(edges, jedges)
    assert graph.shape == (4, 3) and edges.shape == (2, 16)
    p1 = env.usr_pos.copy()
    env.reset(gen)
    assert not np.allclose(p1, env.usr_pos)


def test_sv_fading_64qam34_through_the_port_receive():
    """The twin of tests/test_channel.py test_sv_fading_64qam34_pilot_tracking
    on the port's CPU path: 2 frames of 100 bytes at MCS 7, six SV
    realisations (JAX's taps, from the key of each trial), 30 dB,
    frequency offset 2e-3; at least 8 of 12 frames bit-exact."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 100), dtype=np.uint8)
    bursts = tx.transmit(frames, 7, device="cpu")
    stream = tx.pad_burst(bursts, pad_front=150, pad_tail=300).reshape(-1)
    decoded = 0
    for trial in range(6):
        taps = _t(jsv.sv_impulse_response(jax.random.key(trial), n_taps=6, ray_decay=1.5))
        y = channel_model(torch.Generator().manual_seed(100 + trial), stream,
                          noise_voltage=0.5 * 10 ** (-30 / 20), frequency_offset=2e-3,
                          taps=taps)
        res, cand = sync.receive(y, tx.tx_plan(7, 100), max_frames=4, device="cpu")
        ok = cand.valid.numpy() & res.sig["parity_ok"].numpy()
        got = {tuple(r) for r in res.psdu.numpy()[ok]}
        decoded += sum(tuple(f) in got for f in frames)
    assert decoded >= 8, f"only {decoded}/12 frames decoded over SV fading"
