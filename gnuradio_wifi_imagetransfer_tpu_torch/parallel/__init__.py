"""Streaming executors and the adaptive receiver (PyTorch port; local mode
only)."""

from gnuradio_wifi_imagetransfer_tpu_torch.parallel.adaptive import (  # noqa: F401
    AdaptiveFrame,
    AdaptiveReceiver,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import (  # noqa: F401
    AdaptiveStreamExecutor,
    FrameRecord,
    StreamExecutor,
)
