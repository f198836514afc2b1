"""Runtime layer: the UDP socket-PDU bridge, the loopback radio and the
split TX / RX radios (runtime/bridge.py), over the native host runtime
(runtime/native.py)."""

from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import LoopbackRadio, UdpSink, UdpSource  # noqa: F401
