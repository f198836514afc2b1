"""One-command Mode-2 demo on the PyTorch port: image -> sender -> 802.11a
loopback radio -> receiver, printing progressive PSNR as the canvas
converges (the analogue of demo.py, which runs the JAX package).

    python demo_torch.py [--image PATH] [--mcs 0..7] [--snr 25] [--size 48]
                         [--timeout 300] [--device cuda|cpu]

Runs on the card by default (``--device cpu`` runs the kernels' plain
versions on the CPU; ``--device`` takes the place of demo.py's ``--tpu``).
Every piece crosses a real UDP socket bridge, is MAC-framed, modulated,
impaired, synchronized and Viterbi-decoded by the port's ``SenderApp``,
``LoopbackRadio`` and ``ReceiverApp``. The received image is written to
``demo_received.png`` in the working directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _parse():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", default=None,
                   help="input image (default: assets/kodim01.png, else a generated ramp)")
    p.add_argument("--mcs", type=int, default=3, help="802.11a MCS 0..7")
    p.add_argument("--snr", type=float, default=25.0, help="loopback SNR dB")
    p.add_argument("--size", type=int, default=48,
                   help="transfer size NxN (300 = reference scale)")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--device", default="cuda", help="torch device of the radio (cuda or cpu)")
    return p.parse_args()


def main():
    args = _parse()
    import numpy as np
    import torch
    from PIL import Image

    from gnuradio_wifi_imagetransfer_tpu_torch.config import AppConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime.apps import ReceiverApp, SenderApp
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import LoopbackRadio
    from gnuradio_wifi_imagetransfer_tpu_torch.utils import metrics
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve

    device = resolve(args.device)
    if device.type == "cuda":
        from gnuradio_wifi_imagetransfer_tpu_torch.ops import build

        build.library()         # nvcc now, not in the radio thread's first launch
    else:
        torch.set_num_threads(2)

    default_img = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "kodim01.png")
    if args.image is None and os.path.exists(default_img):
        args.image = default_img
    if args.image:
        img = np.asarray(Image.open(args.image).convert("RGB"), dtype=np.uint8)
    else:
        yy, xx = np.meshgrid(np.linspace(0, 1, 256), np.linspace(0, 1, 256), indexing="ij")
        img = np.stack([255 * yy, 255 * xx, 127 + 127 * np.sin(8 * np.pi * (yy + xx))],
                       axis=-1).astype(np.uint8)

    # the receiver binds its UDP port first and the radio sends there, so
    # no other process can take the port in between
    receiver = ReceiverApp(cfg=AppConfig(image_size=(args.size, args.size)), rx_port=0).start()
    print(f"starting loopback radio (MCS {args.mcs}, {args.snr:.0f} dB SNR, {device})...")
    radio = LoopbackRadio(in_port=0, out_port=receiver.rx_port, mcs=args.mcs, snr_db=args.snr,
                          batch=4, device=device).start()
    cfg = AppConfig(tx_port=radio.in_port, image_size=(args.size, args.size),
                    piece_interval_s=0.005)
    sender = SenderApp(cfg=cfg)
    sender.start()
    n_pieces = (args.size // 10) * (args.size // 10) * 3
    target = np.asarray(Image.fromarray(img).resize((args.size, args.size)), dtype=np.uint8)
    try:
        sender.send_image(img)
        print(f"sender UI:   http://127.0.0.1:{sender.port}/  "
              f"(port field pre-set to the radio's UDP port)")
        print(f"receiver UI: http://127.0.0.1:{receiver.port}/")
        print(f"transferring {args.size}x{args.size}x3 as {n_pieces} pieces "
              f"over the 802.11a PHY...")
        t0 = time.time()
        last = -1
        while time.time() - t0 < args.timeout:
            n = receiver.pieces_received
            if n != last and n > 0:
                p = metrics.psnr(target, receiver.canvas)
                bar = "#" * int(30 * min(n, n_pieces) / n_pieces)
                print(f"\r[{bar:<30}] pieces {n:>4}  PSNR {p:6.2f} dB", end="", flush=True)
                last = n
            if np.array_equal(receiver.canvas, target):
                break
            time.sleep(0.2)
        print()
        if not np.array_equal(receiver.canvas, target):
            match = float(np.mean(receiver.canvas == target))
            print(f"timeout: canvas {match:.1%} converged; radio stats {radio.stats}")
            sys.exit(1)
        print(f"converged bit-exact in {time.time() - t0:.1f}s "
              f"({radio.stats['frames_ok']} frames decoded, "
              f"{radio.stats['frames_crc_fail']} CRC-rejected)")
        out = "demo_received.png"
        Image.fromarray(receiver.canvas).save(out)
        print(f"received image written to {out}")
    finally:
        sender.stop()
        radio.stop()
        receiver.stop()


if __name__ == "__main__":
    main()
