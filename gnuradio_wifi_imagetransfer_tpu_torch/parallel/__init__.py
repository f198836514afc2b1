"""Streaming executors (PyTorch port; local mode only)."""

from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import (  # noqa: F401
    FrameRecord,
    StreamExecutor,
)
