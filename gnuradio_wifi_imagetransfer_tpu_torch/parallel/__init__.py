"""Parallel runtime (PyTorch port): meshes, halo exchange, the streaming
executors and the adaptive receiver."""

from gnuradio_wifi_imagetransfer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_data_mesh,
    make_mesh,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.adaptive import (  # noqa: F401
    AdaptiveFrame,
    AdaptiveReceiver,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import (  # noqa: F401
    AdaptiveStreamExecutor,
    FrameRecord,
    StreamExecutor,
)
