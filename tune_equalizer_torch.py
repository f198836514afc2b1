"""Sweep the LMS/STA equalizer tracker gains over the fading waterfall on
the PyTorch port (the analogue of tune_equalizer.py, which runs the JAX
package).

PER of each gain setting over the same slowly fading 3-tap channel the
waterfall test locks regions with (tests/test_waterfall.py:63-80), at two
wander depths, plus a static-multipath control so a tracking gain that
wins on fading does not regress the time-invariant case.

Scenario (tune_equalizer.py's): 16-QAM 3/4 (MCS 5), 400-byte PSDUs, 3-tap
delays (0, 3, 7), tap wander periods of about 80-130 symbols, AWGN at 25
dB SNR, genie-aligned decode (isolates equalization from sync). The AWGN
comes from a ``torch.Generator`` seeded with --seed, or is passed in as
draws (``build_scenarios(noise=...)``).

Usage: python tune_equalizer_torch.py [--frames 32] [--out eq_sweep_torch.json]
                                      [--device cuda|cpu] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.channel import model
from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator
from gnuradio_wifi_imagetransfer_tpu_torch.phy import rx, tx
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve

MCS = 5
PSDU_L = 400
SNR_DB = 25.0
SCENARIOS = (("fade_deep", 0.5), ("fade_mild", 0.25), ("static", 0.0))
LMS_MU = (0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9)
STA_GAINS = (0.125, 0.25, 0.5, 0.75)


def fading_burst(burst: np.ndarray, rng: np.random.Generator, wander: float) -> np.ndarray:
    """The waterfall test's slowly time-varying 3-tap channel
    (tests/test_waterfall.py:63-80)."""
    n = burst.size
    delays = np.array([0, 3, 7])
    g0 = np.array([1.0, 0.45, 0.3]) * np.exp(2j * np.pi * rng.random(3))
    periods = np.array([80.0, 102.4, 128.8]) * 80.0
    t = np.arange(n)[:, None]
    wob = np.exp(1j * (2 * np.pi * t / periods + 2 * np.pi * rng.random(3)))
    gains = g0 * (1 + wander * (wob - wob[0]))
    y = np.zeros(n, dtype=np.complex128)
    for d, gd in zip(delays, gains.T):
        y[d:] += gd[d:] * burst[: n - d]
    return y.astype(np.complex64)


def build_scenarios(n_frames: int, device, seed: int = 7, noise: dict | None = None):
    """The sent PSDUs and, per scenario, the (n_frames, n) received bursts
    on ``device``. The AWGN (noise voltage 10^(-SNR/20)) is drawn from a
    torch.Generator seeded with ``seed`` unless ``noise`` gives it per
    scenario as complex draws of the bursts' shape."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    psdu = rng.integers(0, 256, (n_frames, PSDU_L), dtype=np.uint8)
    bursts = tx.transmit(psdu, MCS, scrambler_seed=torch.arange(n_frames) % 127 + 1,
                         device=dev).cpu().numpy()
    gen = torch.Generator(dev).manual_seed(seed)
    scen = {}
    for name, wander in SCENARIOS:
        faded = torch.from_numpy(np.stack([
            fading_burst(b, np.random.default_rng(100 + i), wander)
            for i, b in enumerate(bursts)])).to(dev)
        if noise is None:
            scen[name] = model.awgn(gen, faded, noise_voltage=10 ** (-SNR_DB / 20))
        else:
            scen[name] = faded + torch.as_tensor(noise[name], dtype=torch.complex64, device=dev)
    return psdu, scen


def per(y: torch.Tensor, psdu: np.ndarray, algo, **gains) -> np.ndarray:
    """Packet error rate of the genie-aligned decode of bursts y, (S, F, n)
    for S scenarios of the F frames ``psdu``: one decode of all S x F
    bursts, (S,) rates."""
    res = rx.decode_aligned(y.reshape(-1, y.shape[-1]), tx.tx_plan(MCS, PSDU_L), start=0,
                            algo=algo, **gains)
    wrong = (res.psdu.cpu().numpy().reshape(y.shape[0], *psdu.shape) != psdu).any(axis=-1)
    return wrong.mean(axis=-1)


def sweep(psdu: np.ndarray, scen: dict, log=print) -> dict:
    """PER of every LMS mu and STA (alpha, beta) on every scenario."""
    results = {"lms": [], "sta": [], "frames": len(psdu), "snr_db": SNR_DB}
    y = torch.stack(list(scen.values()))
    t0 = time.time()
    settings = ([("lms", ChannelEstimator.LMS, {"lms_mu": mu}) for mu in LMS_MU]
                + [("sta", ChannelEstimator.STA, {"sta_alpha": a, "sta_beta": b})
                   for a in STA_GAINS for b in STA_GAINS])
    for key, algo, gains in settings:
        row = dict(gains, **{name: float(v) for name, v in zip(scen, per(y, psdu, algo, **gains))})
        results[key].append(row)
        log(f"[{time.time() - t0:6.0f}s] {key.upper()} {gains}: {row}")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--out", default="eq_sweep_torch.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=7, help="seed of the AWGN generator")
    args = ap.parse_args()
    if resolve(args.device).type == "cpu":
        torch.set_num_threads(2)
    psdu, scen = build_scenarios(args.frames, args.device, args.seed)
    results = sweep(psdu, scen, log=lambda s: print(s, flush=True))
    results["device"] = (torch.cuda.get_device_name(0) if resolve(args.device).type == "cuda"
                         else "cpu")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
