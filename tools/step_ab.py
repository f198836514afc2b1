#!/usr/bin/env python3
"""device_step of one checkout of the PyTorch port, for comparing two
checkouts on one card in turns (A, B, B, A):

    python3 tools/step_ab.py <checkout root>

Builds the executor stream of ``chip_smoke.py`` phase 8 (4 channels x 16
blocks x 262 144 samples, sc16, 3 frames per block per channel; the
checkout's ``utils/scenarios.py``) with the checkout's own TX, then times
``StreamExecutor.step``: 20 steps with CUDA
events, the median of 10 synchronised steps on the host clock, and the
device busy time and device activities of 3 profiled steps. Prints one
JSON line. Needs one NVIDIA GPU.
"""
import json
import os
import sys
import time

import numpy as np


def main() -> None:
    import torch

    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import StreamExecutor
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx
    from gnuradio_wifi_imagetransfer_tpu_torch.utils import scenarios as sc
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.tracing import cuda_ms, device_profile

    if not torch.cuda.is_available() or not tx.__file__.startswith(root):
        sys.exit(f"step_ab: needs a GPU and the port under {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = sc.TIME_BLOCKS * sc.BLOCK
    n_frames = sc.FRAMES_PER_BLOCK * sc.TIME_BLOCKS
    pos = [min(150 + i * (n // n_frames), n - 2000) for i in range(n_frames)]
    stream = np.stack([sc.make_stream(tx, n, pos, n_frames, rng, dev)[0]
                       for _ in range(sc.CHANNELS)])
    cfg = ExecutorConfig(block_size=sc.BLOCK, time_shards=sc.TIME_BLOCKS,
                         channels=sc.CHANNELS, max_frames_per_block=sc.MAX_FRAMES,
                         wire_format="sc16")
    ex = StreamExecutor(tx.tx_plan(sc.MCS, sc.PSDU_LEN), exec_cfg=cfg, device=dev)
    ex.stage_resident(stream)
    for _ in range(3):
        ex.step(0)
    step_ms = cuda_ms(lambda: ex.step(0), 20)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.step(0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    busy = []
    for _ in range(3):
        _, ms, _, _, n_act = device_profile(lambda: ex.step(0))
        busy.append([ms, n_act])
    print(json.dumps({"root": sys.argv[1], "card": torch.cuda.get_device_name(0),
                      "step_ms_events_20": step_ms,
                      "step_ms_synced_wall_median": float(np.median(walls)),
                      "profiled_busy_ms_and_activities": busy}))


if __name__ == "__main__":
    main()
