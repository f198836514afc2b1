"""Channel simulation: waveform impairments (PyTorch port; the
Saleh-Valenzuela and IRS channels are not ported yet)."""

from gnuradio_wifi_imagetransfer_tpu_torch.channel.model import (  # noqa: F401
    apply_cfo,
    awgn,
    channel_model,
)
