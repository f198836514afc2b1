"""DQN-driven IRS phase-shift control (PyTorch port of the JAX package's
control/dqn_irs.py).

The reference carries a (disabled) embedded GNU Radio block that runs a
stable-baselines3 DQN over the received-power observation and pushes the
chosen IRS phase-shift action to an IRS controller over TCP
192.168.10.5:56666 (IRS_AP.grc:464-563, state `disabled`). The rebuild:

  * QNetwork / DqnAgent — an MLP Q-function with a target network,
    epsilon-greedy exploration and the double-DQN update, on ``device``
    ("cuda" unless the caller asks for the CPU). A fresh agent initialises
    as Flax does (lecun-normal kernels, zero biases) from a
    ``torch.Generator(seed)``; ``load_flax_params`` carries a JAX agent's
    parameters in. The host decisions (epsilon-greedy, replay sampling)
    draw from ``np.random.default_rng(seed)`` in the JAX agent's order, so
    from the same parameters the port acts as the JAX agent does;
  * ReplayBuffer — flat numpy circular transition store;
  * IrsPowerEnv — a received-power environment over the clustered IRS
    geometry channel (channel/irs.py): actions select a phase-gradient
    codebook entry, the reward is the receive power in dB, observations are
    the recent power history;
  * IrsControlClient / IrsControlServer — the TCP action push as JSON
    lines, with a local server standing in for the IRS hardware controller.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import socket
import socketserver
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.channel.irs import ClusteredIRSChannel
from gnuradio_wifi_imagetransfer_tpu_torch.models.somanet import flax_init_
from gnuradio_wifi_imagetransfer_tpu_torch.models.weights import state_dict_from_flax
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


class QNetwork(nn.Module):
    """MLP Q-function: observation -> per-action value. The layers carry
    Flax's names for its unnamed Dense layers (Dense_0, Dense_1, ...)."""

    def __init__(self, n_actions: int, hidden: tuple[int, ...] = (64, 64), obs_dim: int = 8):
        super().__init__()
        self.n_layers = len(hidden) + 1
        widths = (obs_dim,) + tuple(hidden) + (n_actions,)
        for i in range(self.n_layers):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for i in range(self.n_layers - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_layers - 1}")(x)


class ReplayBuffer:
    """Circular (obs, action, reward, next_obs, done) store."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.action = np.zeros(capacity, np.int32)
        self.reward = np.zeros(capacity, np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.done = np.zeros(capacity, np.float32)
        self.idx = 0
        self.size = 0

    def push(self, obs, action, reward, next_obs, done):
        i = self.idx
        self.obs[i] = obs
        self.action[i] = action
        self.reward[i] = reward
        self.next_obs[i] = next_obs
        self.done[i] = done
        self.idx = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int):
        j = rng.integers(0, self.size, batch)
        return (self.obs[j], self.action[j], self.reward[j],
                self.next_obs[j], self.done[j])


@dataclasses.dataclass
class DqnConfig:
    obs_dim: int = 8
    n_actions: int = 16
    gamma: float = 0.9
    learning_rate: float = 1e-3
    batch_size: int = 64
    buffer_size: int = 10_000
    target_update: int = 50      # steps between target-network syncs
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 500


class DqnAgent:
    """Double-DQN agent with Adam (optax's defaults: b1 0.9, b2 0.999, eps
    1e-8). The target network is a separate copy, synced by value."""

    def __init__(self, cfg: DqnConfig = DqnConfig(), seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        self.net = flax_init_(QNetwork(cfg.n_actions, obs_dim=cfg.obs_dim),
                              torch.Generator().manual_seed(seed)).to(self.device)
        self.target = copy.deepcopy(self.net).requires_grad_(False)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=cfg.learning_rate)
        self.buffer = ReplayBuffer(cfg.buffer_size, cfg.obs_dim)
        self.rng = np.random.default_rng(seed)
        self.steps = 0

    def load_flax_params(self, params) -> None:
        """A JAX agent's ``params`` ({"params": {"Dense_0": ...}}, numpy
        leaves) into the online and the target network."""
        sd = state_dict_from_flax(params, self.net)
        self.net.load_state_dict(sd)
        self.target.load_state_dict(sd)

    # -- acting ----------------------------------------------------------

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(self.steps / max(c.eps_decay_steps, 1), 1.0)
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    def act(self, obs: np.ndarray, greedy: bool = False) -> int:
        if not greedy and self.rng.random() < self.epsilon():
            return int(self.rng.integers(self.cfg.n_actions))
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
            q = self.net(x[None])[0].cpu().numpy()
        return int(np.argmax(q))                            # the first maximum

    # -- learning --------------------------------------------------------

    def _update(self, obs, action, reward, next_obs, done) -> torch.Tensor:
        """One double-DQN Adam step on a batch of tensors on the device:
        the online net picks the next action, the target net values it.
        Returns the loss (before the step)."""
        with torch.no_grad():
            next_a = self.net(next_obs).argmax(dim=-1)
            next_v = self.target(next_obs).gather(1, next_a[:, None])[:, 0]
            target = reward + self.cfg.gamma * (1.0 - done) * next_v
        qa = self.net(obs).gather(1, action[:, None])[:, 0]
        loss = torch.mean((qa - target) ** 2)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def observe(self, obs, action, reward, next_obs, done) -> float | None:
        """Record a transition and (when warm) run one gradient step."""
        self.buffer.push(obs, action, reward, next_obs, done)
        self.steps += 1
        if self.buffer.size < self.cfg.batch_size:
            return None
        o, a, r, o2, d = self.buffer.sample(self.rng, self.cfg.batch_size)
        dev = self.device
        loss = self._update(torch.from_numpy(o).to(dev), torch.from_numpy(a).long().to(dev),
                            torch.from_numpy(r).to(dev), torch.from_numpy(o2).to(dev),
                            torch.from_numpy(d).to(dev))
        if self.steps % self.cfg.target_update == 0:
            self.target.load_state_dict(self.net.state_dict())
        return float(loss)


class IrsPowerEnv:
    """Received-power environment over the clustered IRS channel.

    Actions index a (theta, phi) phase-gradient codebook
    (ClusteredIRSChannel.gen_phase_nograd, mirroring
    utils/channel.py:248-268 in the reference); reward = receive power in
    dB for a fixed user under the LoS channel; observation = the last
    obs_dim rewards. As in the JAX package, ``seed`` and ``k_factor`` are
    accepted and never used. The channel lies on ``device``.
    """

    def __init__(self, n_grid: int = 4, obs_dim: int = 8, seed: int = 0,
                 k_factor: float = 10.0, device="cuda"):
        self.ch = ClusteredIRSChannel(
            irs_unit_gap=0.03, irs_scale=8, cluster_scale=2,
            irs_pos=(0.015, 0.015, 0.0), ap_pos=(0.12, 0.12, 4.5),
            user_num=1, ap_num=1, device=str(resolve(device)))
        self.obs_dim = obs_dim
        thetas = np.linspace(0, np.pi / 2, n_grid, endpoint=False)
        phis = np.linspace(0, np.pi, n_grid, endpoint=False)
        self.codebook = [self.ch.gen_phase_nograd(float(t), float(p))
                         for t in thetas for p in phis]
        self.n_actions = len(self.codebook)
        pos_users = np.array([[30.0, 10.0, 1.5]])
        self.los = self.ch.gen_los(pos_users)
        self.k_factor = k_factor
        self.history = np.zeros(obs_dim, np.float32)

    def _power_db(self, psi: torch.Tensor) -> float:
        h = self.ch.gen_chnl_ideal(self.los, psi).cpu().numpy()
        p = float(np.sum(np.abs(h) ** 2))
        return 10.0 * np.log10(max(p, 1e-30))

    def reset(self) -> np.ndarray:
        self.history[:] = 0.0
        return self.history.copy()

    def step(self, action: int) -> tuple[np.ndarray, float]:
        reward = self._power_db(self.codebook[action])
        self.history = np.roll(self.history, 1)
        self.history[0] = reward
        return self.history.copy(), reward

    def best_action(self) -> int:
        return int(np.argmax([self._power_db(c) for c in self.codebook]))


# ---------------------------------------------------------------------------
# TCP action push (the reference pushes DQN actions to the IRS controller
# over TCP; IRS_AP.grc embedded block, target 192.168.10.5:56666)
# ---------------------------------------------------------------------------


class IrsControlClient:
    """Pushes chosen IRS actions to the controller as JSON lines."""

    def __init__(self, host: str = "127.0.0.1", port: int = 56666,
                 timeout: float = 2.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._f = self.sock.makefile("rwb")

    def send_action(self, action: int, meta: dict | None = None):
        msg = {"action": int(action)}
        if meta:
            msg.update(meta)
        self._f.write(json.dumps(msg).encode() + b"\n")
        self._f.flush()

    def close(self):
        try:
            self._f.close()
        finally:
            self.sock.close()


class IrsControlServer:
    """Loopback stand-in for the IRS hardware controller: collects pushed
    actions on a TCP port (test double for 192.168.10.5:56666)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.actions: list[dict] = []
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        outer.actions.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue

        self._srv = socketserver.ThreadingTCPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
