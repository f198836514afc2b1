"""Runtime layer: the UDP socket-PDU bridge, the loopback radio and the
split TX / RX radios (runtime/bridge.py), over the native host runtime
(runtime/native.py), and the web apps of both modes (runtime/apps.py)."""

from gnuradio_wifi_imagetransfer_tpu_torch.runtime.apps import (  # noqa: F401
    FeatureMapReceiverApp,
    FeatureMapSenderApp,
    ReceiverApp,
    SenderApp,
)
from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import (  # noqa: F401
    LoopbackRadio,
    RxRadio,
    TxRadio,
    UdpSink,
    UdpSource,
)
