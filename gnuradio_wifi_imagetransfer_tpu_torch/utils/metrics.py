"""Quality and signal metrics: PSNR, SSIM, YCbCr, ImageNet denormalisation
and the SNR estimate of equalized symbols
(copy of the JAX package's utils/metrics.py; numpy only).

psnr follows the reference's validation.py:19-30 (1e-4 MSE floor, 255
peak); ssim is an in-house implementation with skimage's defaults (7 x 7
uniform window, K1 = 0.01, K2 = 0.03, unbiased covariance, channel mean).
"""

from __future__ import annotations

import numpy as np

from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import IMAGENET_MEAN, IMAGENET_STD


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """Batch-mean PSNR with the reference's 1e-4 MSE floor and 255 peak.
    Inputs (B, ...) uint8 or float arrays."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    if img1.shape[0] != img2.shape[0]:
        raise ValueError("batch size mismatch")
    total = 0.0
    for b in range(img1.shape[0]):
        mse = max(np.mean((img1[b] - img2[b]) ** 2), 1e-4)
        total += 10.0 * np.log10(255.0 * 255.0 / mse)
    return total / img1.shape[0]


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """2-D moving average of the same size as x (symmetric padding), by
    cumulative sums."""
    pad = size // 2
    xp = np.pad(x, ((pad, pad), (pad, pad)), mode="symmetric")
    c = np.cumsum(np.cumsum(xp, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = (c[size:, size:] - c[:-size, size:] - c[size:, :-size] + c[:-size, :-size])
    return s / (size * size)


def ssim(img1: np.ndarray, img2: np.ndarray, channel_axis: int | None = None,
         data_range: float = 255.0, win_size: int = 7) -> float:
    """Structural similarity with skimage's default parameters."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    if channel_axis is not None:
        img1 = np.moveaxis(img1, channel_axis, -1)
        img2 = np.moveaxis(img2, channel_axis, -1)
        return float(np.mean([ssim(img1[..., c], img2[..., c], None, data_range, win_size)
                              for c in range(img1.shape[-1])]))
    k1, k2 = 0.01, 0.03
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    mu1 = _uniform_filter(img1, win_size)
    mu2 = _uniform_filter(img2, win_size)
    n = win_size * win_size
    cov_norm = n / (n - 1)                   # skimage's unbiased normalisation
    s11 = (_uniform_filter(img1 * img1, win_size) - mu1 * mu1) * cov_norm
    s22 = (_uniform_filter(img2 * img2, win_size) - mu2 * mu2) * cov_norm
    s12 = (_uniform_filter(img1 * img2, win_size) - mu1 * mu2) * cov_norm
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 ** 2 + mu2 ** 2 + c1) * (s11 + s22 + c2)
    pad = win_size // 2
    return float((num / den)[pad:-pad, pad:-pad].mean())


def rgb2ycbcr(rgb_image: np.ndarray) -> np.ndarray:
    """BT.601 full-swing to studio-swing conversion (validation.py:57-65)."""
    if rgb_image.shape[-1] != 3 or rgb_image.dtype != np.uint8:
        raise ValueError(f"expected (..., 3) uint8, got {rgb_image.shape} {rgb_image.dtype}")
    weights = np.array([
        [65.481, 128.553, 24.944],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ], dtype=np.float32) / 255.0
    bias = np.array([16.0, 128.0, 128.0], dtype=np.float32)
    return np.clip(rgb_image.astype(np.float32) @ weights.T + bias, 16, 255).astype(np.uint8)


def denormalize_batch(img: np.ndarray) -> np.ndarray:
    """ImageNet-denormalize NHWC float arrays."""
    return img * IMAGENET_STD + IMAGENET_MEAN


def snr_estimate_db(symbols: np.ndarray, mcs: int | None = None) -> float:
    """SNR estimate of equalized constellation symbols, the stand-in for
    probe_mpsk_snr_est_c (IRS_AP.py:275, 312): with a known MCS, the error
    against the nearest constellation point; without, the M2/M4 moments
    estimator."""
    s = np.asarray(symbols).reshape(-1)
    if mcs is not None:
        from gnuradio_wifi_imagetransfer_tpu_torch.phy import params

        pts = params.constellation(int(params.MCS_N_BPSC[mcs]))
        nearest = pts[np.argmin(np.abs(s[:, None] - pts[None, :]), axis=1)]
        noise = np.mean(np.abs(s - nearest) ** 2)
        sig = np.mean(np.abs(nearest) ** 2)
        return float(10 * np.log10(max(sig, 1e-12) / max(noise, 1e-12)))
    m2 = np.mean(np.abs(s) ** 2)
    m4 = np.mean(np.abs(s) ** 4)
    sig = np.sqrt(max(2 * m2 ** 2 - m4, 1e-12))
    noise = max(m2 - sig, 1e-12)
    return float(10 * np.log10(sig / noise))
