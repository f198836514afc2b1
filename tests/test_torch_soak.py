"""The Mode-2 soak through the port: the twin of tests/test_soak.py.

One harness, ``utils/scenarios.py``'s ``run_soak(device, size,
timeout_s)`` (chip_smoke.py's phase 35 runs it at full scale on the
card): the port's SenderApp re-sends the resized kodim07 in laps 2 ms
apart, a relay drops 8 % of the datagrams (``np.random.default_rng(0)``),
LoopbackRadio (MCS 3, 22 dB, batch 16) decodes them on ``device`` into
ReceiverApp, until the canvas equals the image exactly.

Here: a rehearsal on the CPU at 60 x 60 (108 pieces a lap). The
full-scale soak (300 x 300, 2 700 pieces a lap) is gated as the JAX one
is (``slow``, ``GWT_SOAK=1``) and runs on the card:

    GWT_SOAK=1 python -m pytest --noconftest -m cuda tests/test_torch_soak.py -s
"""

import contextlib
import io
import json
import os

import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.utils import scenarios as sc

torch.set_num_threads(2)


def test_mode2_soak_rehearsal_on_the_cpu():
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rec = sc.run_soak("cpu", size=60, timeout_s=60.0)
    assert "dropped" not in log.getvalue(), log.getvalue()[-2000:]
    assert rec["bit_exact"], rec
    assert rec["pieces_per_lap"] == 108 and rec["pixels_equal"] == 60 * 60
    assert rec["relay_dropped"] > 0 and rec["pieces_decoded"] >= 108
    assert rec["frames_crc_fail"] == 0


@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.skipif(not os.environ.get("GWT_SOAK"), reason="full-scale soak: set GWT_SOAK=1")
def test_mode2_full_scale_soak_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import build

    build.library()                 # nvcc before the radio's first batch, not inside it
    rec = sc.run_soak("cuda")
    print("\nSOAK " + json.dumps(rec))
    assert rec["bit_exact"] and rec["pieces_decoded"] >= 2700, rec
