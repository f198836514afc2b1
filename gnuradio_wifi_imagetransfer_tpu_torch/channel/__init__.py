"""Channel simulation (PyTorch port): waveform impairments (``model``), the
Saleh-Valenzuela geometry and tapped-delay fading (``sv``), and the IRS
channels (``irs``)."""

from gnuradio_wifi_imagetransfer_tpu_torch.channel.model import (  # noqa: F401
    apply_cfo,
    awgn,
    channel_model,
)
