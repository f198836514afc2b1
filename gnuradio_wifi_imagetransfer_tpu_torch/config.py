"""Typed configuration for the PyTorch port (copy of the JAX package's
``config.py``: ``Encoding``, ``ChannelEstimator``, ``PhyConfig`` and
``ExecutorConfig``).

Reference parameter provenance:
  - encoding enum:        IRS_user.py:130-132 (ieee802_11.Encoding values)
  - sync parameters:      IRS_AP.py:268-269, wifi_phy_hier.grc:63,690
    (threshold 0.56, min_plateau 2, sync_length 320)
  - chan_est algorithms:  IRS_AP.py:139-141 (LS / LMS / COMB / STA)

``FrontendConfig`` configures the rate-conversion front-end
(``parallel/frontend.py``), which the local ``StreamExecutor`` runs on the
device ahead of sync. ``AppConfig`` holds the application-layer constants
of the radios and apps (``runtime/``).
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
class FrontendConfig:
    """Sample-rate-conversion front-end for the streaming executor.

    The executor ingests a stream at ``nominal * resample[1]/resample[0] *
    (1 + ppm*1e-6)`` and corrects it to the nominal grid on the device
    before sync:

      resample: (L, M) rational ratio; an input oversampled M/L times is
                resampled by L/M (e.g. (1, 2) for a 2x-oversampled capture).
      ppm:      residual TX/RX sample-clock offset to undo (the stream was
                produced by a clock running (1 + ppm*1e-6) fast).

    parallel/frontend.py factors the combined exact ratio into up to two
    stages (integer-decimation FIR + fractional-delay clock trim) with a
    general polyphase fallback.
    """

    resample: tuple[int, int] = (1, 1)
    ppm: float = 0.0
    taps_per_phase: int = 12           # anti-alias FIR length per decim phase
    frac_taps: int = 32                # fractional-delay interpolator taps
    sub_block: int = 512               # clock-trim granularity (samples);
                                       # timing ripple = sub_block * |ppm| * 1e-6


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """Streaming block-executor configuration."""

    frontend: FrontendConfig | None = None   # rate-conversion front-end (None = off)
    block_size: int = 1 << 16          # samples per time-block
    halo: int = 4096                   # unused (as in the JAX package); kept so
                                       # configs round-trip from it
    max_frames_per_block: int = 8      # fixed frame-candidate slots per block
    channels: int = 1                  # parallel 20 MHz channels
    time_shards: int = 1               # time blocks per step
    wire_format: str = "f32"           # host->device sample format: f32, sc16, sc8


@dataclasses.dataclass(frozen=True)
class AppConfig:
    """Application-layer constants (upload/download apps).

    Reference provenance: HOST/PORT constants upload_featuremap_udp.py:20-22,
    download_featuremap_udp.py:18-22; image size upload_image_udp.py:21;
    piece spacing upload_image_udp.py:33.
    """

    tx_host: str = "127.0.0.1"
    tx_port: int = 52001               # app -> radio UDP (IRS_user.grc:311-318)
    rx_host: str = "127.0.0.1"
    rx_port: int = 10010               # radio -> app UDP (IRS_AP_epy_block_2.py:38)
    image_size: tuple[int, int] = (300, 300)
    piece_size: tuple[int, int] = (10, 10)
    piece_interval_s: float = 0.05
    pdu_length: int = 50               # frame payload bytes (IRS_user.py:104)
