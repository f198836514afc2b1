"""IRS control plane (PyTorch port): DQN phase-shift agent + TCP action push."""

from gnuradio_wifi_imagetransfer_tpu_torch.control.dqn_irs import (
    DqnAgent,
    DqnConfig,
    IrsControlClient,
    IrsControlServer,
    IrsPowerEnv,
    QNetwork,
    ReplayBuffer,
)

__all__ = [
    "DqnAgent",
    "DqnConfig",
    "IrsControlClient",
    "IrsControlServer",
    "IrsPowerEnv",
    "QNetwork",
    "ReplayBuffer",
]
