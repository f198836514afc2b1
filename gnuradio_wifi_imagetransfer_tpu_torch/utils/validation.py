"""Offline quality-evaluation harness for the codec models (PyTorch port of
the JAX package's utils/validation.py, the reference's utils/validation.py):
``evaluate`` (:67-142, PSNR/SSIM over batches with a rendered comparison
grid), ``evaluate_soma`` (:227-308, per-user multi-user evaluation) and
``evaluate_multiband`` (:311-497, frequency-keyed nested evaluation).

numpy and PIL throughout: ``apply_fn`` is any callable from normalized
NHWC numpy batches to the same (a port model wrapped by its caller).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from gnuradio_wifi_imagetransfer_tpu_torch.utils.metrics import denormalize_batch, psnr, ssim


def _restore(x: np.ndarray) -> np.ndarray:
    """normalized NHWC float -> uint8 pixels (validation.py:82-84)."""
    return (np.clip(denormalize_batch(np.asarray(x)), 0, 1) * 255).astype(np.uint8)


def _score(restored: np.ndarray, source: np.ndarray, metric: str) -> float:
    if metric == "PSNR":
        return psnr(restored, source)
    return float(np.mean([ssim(restored[b], source[b], channel_axis=2)
                          for b in range(restored.shape[0])]))


def evaluate(
    apply_fn: Callable[[np.ndarray], np.ndarray],
    batches,
    metric: str = "PSNR",
    save_grid: Optional[str] = None,
    max_batches: Optional[int] = None,
) -> float:
    """Average PSNR/SSIM of apply_fn over normalized NHWC image batches
    (validation.py evaluate :67-142)."""
    total, n = 0.0, 0
    last = None
    for i, image in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        restored, source = _restore(np.asarray(apply_fn(image))), _restore(image)
        total += _score(restored, source, metric)
        n += 1
        last = (source, restored)
    if save_grid and last is not None:
        render_grid(last[0], last[1], save_grid)
    return total / max(n, 1)


def evaluate_soma(
    apply_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    batches,
    labels: np.ndarray,
    metric: str = "PSNR",
    max_batches: Optional[int] = None,
) -> dict:
    """Per-user multi-user evaluation (validation.py evaluate_SOMA
    :227-308): apply_fn maps (U, B, H, W, 3) images + (U, 256) labels to
    per-user reconstructions; returns {user_index: metric}."""
    user_tot: dict[int, float] = {}
    n = 0
    for i, images in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        out = np.asarray(apply_fn(images, labels))
        for u in range(images.shape[0]):
            m = _score(_restore(out[u]), _restore(images[u]), metric)
            user_tot[u] = user_tot.get(u, 0.0) + m
        n += 1
    return {u: v / max(n, 1) for u, v in user_tot.items()}


def evaluate_multiband(
    apply_fns: dict,
    band_batches: dict,
    band_labels: dict,
    metric: str = "PSNR",
    max_batches: Optional[int] = None,
) -> dict:
    """Frequency-keyed nested evaluation (validation.py evaluate_MultiBand
    :311-497): {freq: {user: metric}}."""
    return {
        f: evaluate_soma(apply_fns[f], band_batches[f], band_labels[f], metric, max_batches)
        for f in band_batches
    }


def render_grid(source: np.ndarray, restored: np.ndarray, path: str,
                max_cols: int = 4) -> None:
    """Side-by-side source/reconstruction grid (validation.py:100-140)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = min(max_cols, source.shape[0])
    fig, axes = plt.subplots(2, cols, figsize=(3 * cols, 6))
    axes = np.atleast_2d(axes)
    for c in range(cols):
        axes[0, c].imshow(source[c])
        axes[0, c].set_title("source")
        axes[1, c].imshow(restored[c])
        axes[1, c].set_title("restored")
        for r in range(2):
            axes[r, c].axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
