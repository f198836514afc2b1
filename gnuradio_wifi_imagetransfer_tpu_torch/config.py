"""Typed configuration for the PyTorch port (copy of the JAX package's
``config.py``: ``Encoding``, ``ChannelEstimator``, ``PhyConfig`` and
``ExecutorConfig``).

Reference parameter provenance:
  - encoding enum:        IRS_user.py:130-132 (ieee802_11.Encoding values)
  - sync parameters:      IRS_AP.py:268-269, wifi_phy_hier.grc:63,690
    (threshold 0.56, min_plateau 2, sync_length 320)
  - chan_est algorithms:  IRS_AP.py:139-141 (LS / LMS / COMB / STA)

The rate-conversion front-end (``FrontendConfig``) is not ported yet, so
``ExecutorConfig.frontend`` must be ``None``.
"""

from __future__ import annotations

import dataclasses
import enum


class Encoding(enum.IntEnum):
    """MCS indices, value-compatible with ieee802_11.Encoding."""

    BPSK_1_2 = 0
    BPSK_3_4 = 1
    QPSK_1_2 = 2
    QPSK_3_4 = 3
    QAM16_1_2 = 4
    QAM16_3_4 = 5
    QAM64_2_3 = 6
    QAM64_3_4 = 7


class ChannelEstimator(enum.IntEnum):
    """Channel-estimation algorithms (ieee802_11.frame_equalizer algo)."""

    LS = 0
    LMS = 1
    COMB = 2
    STA = 3


@dataclasses.dataclass(frozen=True)
class PhyConfig:
    """Static PHY configuration (everything that fixes shapes)."""

    bandwidth: float = 10e6            # Hz; reference default 10 MHz
    frequency: float = 5.89e9          # Hz carrier
    encoding: Encoding = Encoding.QPSK_1_2
    chan_est: ChannelEstimator = ChannelEstimator.LS
    sync_threshold: float = 0.56       # sync_short plateau threshold
    min_plateau: int = 2               # sync_short min plateau
    sync_length: int = 320             # sync_long search window
    max_psdu_bytes: int = 800          # PHY buffer sizing assumption
    lms_mu: float = 0.5                # LMS update gain (tuned default)
    sta_alpha: float = 0.5             # STA smoothing across symbols
    sta_beta: float = 0.125            # STA smoothing across carriers


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """Streaming block-executor configuration."""

    frontend: object | None = None     # rate-conversion front-end: not ported
    block_size: int = 1 << 16          # samples per time-block
    halo: int = 4096                   # unused (as in the JAX package); kept so
                                       # configs round-trip from it
    max_frames_per_block: int = 8      # fixed frame-candidate slots per block
    channels: int = 1                  # parallel 20 MHz channels
    time_shards: int = 1               # time blocks per step
    wire_format: str = "f32"           # host->device sample format: f32, sc16, sc8

    def __post_init__(self):
        if self.frontend is not None:
            raise NotImplementedError(
                "the rate-conversion front-end is not ported yet: "
                "ExecutorConfig.frontend must be None")
