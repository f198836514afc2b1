#!/usr/bin/env python3
"""device_step of one checkout of the PyTorch port, for comparing two
checkouts on one card in turns (A, B, B, A):

    python3 tools/step_ab.py <checkout root>

Builds the executor stream of ``chip_smoke.py`` phase 8 (4 channels x 16
blocks x 262 144 samples, sc16, 3 frames per block per channel) with the
checkout's own TX, then times ``StreamExecutor.step``: 20 steps with CUDA
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
    from torch.profiler import ProfilerActivity, profile

    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import chip_smoke as cs
    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import StreamExecutor
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx

    if not torch.cuda.is_available() or not tx.__file__.startswith(root):
        sys.exit(f"step_ab: needs a GPU and the port under {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = cs.TIME_BLOCKS * cs.BLOCK
    n_frames = cs.FRAMES_PER_BLOCK * cs.TIME_BLOCKS
    pos = [min(150 + i * (n // n_frames), n - 2000) for i in range(n_frames)]
    stream = np.stack([cs.make_stream(tx, n, pos, n_frames, rng, dev)[0]
                       for _ in range(cs.CHANNELS)])
    cfg = ExecutorConfig(block_size=cs.BLOCK, time_shards=cs.TIME_BLOCKS,
                         channels=cs.CHANNELS, max_frames_per_block=cs.MAX_FRAMES,
                         wire_format="sc16")
    ex = StreamExecutor(tx.tx_plan(cs.MCS, cs.PSDU_LEN), exec_cfg=cfg, device=dev)
    ex.stage_resident(stream)
    for _ in range(3):
        ex.step(0)
    step_ms = cs.cuda_ms(lambda: ex.step(0), 20)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.step(0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    busy = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ex.step(0)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("executor.")]
        busy.append([sum(e.time_range.elapsed_us() for e in kern) / 1e3, len(kern)])
    print(json.dumps({"root": sys.argv[1], "card": torch.cuda.get_device_name(0),
                      "step_ms_events_20": step_ms,
                      "step_ms_synced_wall_median": float(np.median(walls)),
                      "profiled_busy_ms_and_activities": busy}))


if __name__ == "__main__":
    main()
