"""The port's DQN IRS controller (control/dqn_irs.py) against the JAX
package's, on the CPU.

The JAX agent's parameters are carried into the port's networks
(``load_flax_params``); from them the port takes the JAX agent's host
decisions, which both draw from ``np.random.default_rng(seed)`` in the same
order. Tolerances: Q-values within 1e-6 absolute (they peak near 1); one
double-DQN update's loss within 1e-6 relative and every parameter within
1e-6 of JAX's (Adam's first step moves each by about lr = 3e-3); over 150
bandit steps the action sequences are equal and every loss within 1e-4
relative. The environment's powers agree within 2e-5 of the peak power
(linear; measured 4.1e-6): the LoS carrier phase k d is near 3 300 rad,
where one float32 ulp of d moves it by 2e-4 rad, so the two packages'
rounding moves a power by up to 8e-3 dB where the codebook entry cancels
the path (ROADMAP Queue 3).
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.control import dqn_irs as jdqn
from gnuradio_wifi_imagetransfer_tpu_torch.control import (
    DqnAgent, DqnConfig, IrsControlClient, IrsControlServer, IrsPowerEnv, QNetwork,
    ReplayBuffer)
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt

torch.set_num_threads(2)

BANDIT = dict(obs_dim=4, n_actions=9, batch_size=32, buffer_size=2000,
              eps_decay_steps=300, gamma=0.0, learning_rate=3e-3, target_update=25)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _flat_jax(params, module):
    return {k: v.numpy() for k, v in wt.state_dict_from_flax(_np(params), module).items()}


@pytest.fixture(scope="module")
def env():
    return IrsPowerEnv(n_grid=3, obs_dim=4, device="cpu")


def test_qnetwork_matches_jax():
    jnet = jdqn.QNetwork(9)
    params = _np(jax.jit(jnet.init)(jax.random.PRNGKey(3), jnp.zeros((1, 4))))
    net = QNetwork(9, obs_dim=4)
    assert set(net.state_dict()) == {f"Dense_{i}.{n}" for i in range(3) for n in ("weight", "bias")}
    net.load_state_dict(wt.state_dict_from_flax(params, net))
    obs = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32) * 20
    want = np.asarray(jax.jit(jnet.apply)(params, obs))
    got = net(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * max(1.0, np.abs(want).max()), rtol=0)


def test_fresh_agent_initialises_as_flax():
    """lecun-normal kernels (std sqrt(1 / fan_in), truncated at 2 std) and
    zero biases, from the seed; the target a separate copy."""
    a, b = DqnAgent(DqnConfig(), seed=4, device="cpu"), DqnAgent(DqnConfig(), seed=4, device="cpu")
    for name, w in a.net.state_dict().items():
        assert torch.equal(w, b.net.state_dict()[name])
        if name.endswith("bias"):
            assert not w.any()
        else:
            std = float(np.sqrt(1.0 / w.shape[1]))
            assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
            assert 0.8 * std < float(w.std()) < 1.2 * std
    assert all(p.data_ptr() != q.data_ptr()
               for p, q in zip(a.net.parameters(), a.target.parameters()))


def test_agent_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        DqnAgent(DqnConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        IrsPowerEnv(n_grid=2)


def test_one_double_dqn_update_matches_jax():
    cfg = dict(BANDIT, gamma=0.9)
    jagent = jdqn.DqnAgent(jdqn.DqnConfig(**cfg), seed=1)
    # a target net apart from the online one, so the double-DQN split counts
    jagent.target_params = jax.jit(jagent.net.init)(jax.random.PRNGKey(7), jnp.zeros((1, 4)))
    agent = DqnAgent(DqnConfig(**cfg), seed=1, device="cpu")
    agent.load_flax_params(_np(jagent.params))
    agent.target.load_state_dict(wt.state_dict_from_flax(_np(jagent.target_params), agent.target))

    rng = np.random.default_rng(2)
    batch = (rng.standard_normal((32, 4)).astype(np.float32) * 10 - 5,
             rng.integers(0, 9, 32).astype(np.int32),
             rng.standard_normal(32).astype(np.float32) * 10,
             rng.standard_normal((32, 4)).astype(np.float32) * 10 - 5,
             (rng.random(32) < 0.2).astype(np.float32))
    params, _, jloss = jagent._update(jagent.params, jagent.target_params, jagent.opt_state,
                                      *(jnp.asarray(b) for b in batch))
    loss = agent._update(*(torch.from_numpy(b) for b in batch[:1]),
                         torch.from_numpy(batch[1]).long(),
                         *(torch.from_numpy(b) for b in batch[2:]))
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    want, got = _flat_jax(params, agent.net), _flat(agent.net)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    moved = _flat_jax(jagent.params, agent.net)
    assert all(np.abs(want[k] - moved[k]).max() > 1e-3 for k in want)


def _drive(agent, env, steps):
    """The bandit loop of tests/test_control.py; returns actions and losses."""
    obs = env.reset()
    actions, losses = [], []
    for _ in range(steps):
        a = agent.act(obs)
        next_obs, r = env.step(a)
        losses.append(agent.observe(obs, a, r, next_obs, 0.0))
        actions.append(a)
        obs = next_obs
    return actions, losses


def test_150_bandit_steps_match_jax(env):
    """Both agents from one set of parameters, driven by the same
    environment (the port's): equal actions, losses within 1e-4."""
    jagent = jdqn.DqnAgent(jdqn.DqnConfig(**BANDIT), seed=1)
    agent = DqnAgent(DqnConfig(**BANDIT), seed=1, device="cpu")
    agent.load_flax_params(_np(jagent.params))
    want_a, want_l = _drive(jagent, env, 150)
    got_a, got_l = _drive(agent, env, 150)
    assert got_a == want_a
    assert [g is None for g in got_l] == [w is None for w in want_l]
    pairs = [(g, w) for g, w in zip(got_l, want_l) if w is not None]
    assert len(pairs) == 150 - 31
    for g, w in pairs:
        assert abs(g - w) <= 1e-4 * abs(w), (g, w)
    assert agent.steps == jagent.steps == 150


def test_replay_buffer_wraps_as_jax():
    bufs = ReplayBuffer(capacity=4, obs_dim=2), jdqn.ReplayBuffer(capacity=4, obs_dim=2)
    for buf in bufs:
        for i in range(6):
            buf.push(np.full(2, i, np.float32), i, float(i), np.full(2, i + 1, np.float32), 0.0)
    assert bufs[0].size == bufs[1].size == 4 and bufs[0].idx == bufs[1].idx == 2
    got, want = (b.sample(np.random.default_rng(0), 8) for b in bufs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert set(got[1].tolist()) <= {2, 3, 4, 5}   # oldest two overwritten


def test_env_rewards_per_action_match_jax(env):
    jenv = jdqn.IrsPowerEnv(n_grid=3, obs_dim=4, seed=0)
    assert env.n_actions == jenv.n_actions == 9
    got = np.array([env.step(a)[1] for a in range(env.n_actions)])
    want = np.array([jenv.step(a)[1] for a in range(jenv.n_actions)])
    lin_g, lin_w = 10 ** (got / 10), 10 ** (want / 10)
    assert np.abs(lin_g - lin_w).max() <= 2e-5 * lin_w.max()
    assert env.best_action() == jenv.best_action() == int(np.argmax(want))
    # the history holds the last obs_dim rewards (float32), newest first
    assert np.array_equal(env.history, got[::-1][:4].astype(np.float32))
    # as in JAX, seed and k_factor change nothing
    other = IrsPowerEnv(n_grid=3, obs_dim=4, seed=9, k_factor=1.0, device="cpu")
    assert [other._power_db(c) for c in other.codebook] == [env._power_db(c) for c in env.codebook]


def test_tcp_action_push():
    srv = IrsControlServer()
    try:
        cli = IrsControlClient(port=srv.port)
        for a in (3, 1, 4):
            cli.send_action(a, meta={"power_db": -42.0})
        cli.close()
        deadline = time.monotonic() + 5.0
        while len(srv.actions) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [m["action"] for m in srv.actions] == [3, 1, 4]
        assert srv.actions[0]["power_db"] == -42.0
    finally:
        srv.stop()
