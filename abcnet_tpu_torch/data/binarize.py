"""Otsu thresholding, counterpart of abcnet_tpu/data/binarize.py.

The reference's production paths binarize at fixed thresholds (0.6
synthetic, 0.2 scanned; data/pipeline.py:pack_images takes one); this is
the Otsu criterion for images whose contrast a fixed threshold does not
fit: a copy of the host numpy routine, and `otsu_threshold_torch` in the
place of `otsu_threshold_jax`, on tensors of any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["otsu_threshold", "otsu_threshold_torch", "binarize_otsu"]


def otsu_threshold(img_u8: np.ndarray) -> int:
    """Classic Otsu: threshold maximizing between-class variance."""
    hist = np.bincount(np.asarray(img_u8, np.uint8).reshape(-1),
                       minlength=256).astype(np.float64)
    total = hist.sum()
    omega = np.cumsum(hist) / total                    # class-0 mass
    mu = np.cumsum(hist * np.arange(256)) / total      # cumulative mean
    mu_t = mu[-1]
    denom = omega * (1.0 - omega)
    denom[denom == 0] = np.inf
    sigma_b = (mu_t * omega - mu) ** 2 / denom
    return int(np.argmax(sigma_b))


def binarize_otsu(img_u8: np.ndarray) -> np.ndarray:
    """Foreground (ink) mask via Otsu, matching the demo's orientation:
    dark pixels are foreground."""
    t = otsu_threshold(img_u8)
    return (np.asarray(img_u8) <= t).astype(np.float32)


def otsu_threshold_torch(img_u8: torch.Tensor) -> torch.Tensor:
    """Otsu over a uint8 tensor of any shape, in f32 on its device (the
    histogram is one torch.bincount); a 0-d int64 tensor."""
    hist = torch.bincount(img_u8.reshape(-1).to(torch.int64),
                          minlength=256).to(torch.float32)
    total = hist.sum()
    omega = torch.cumsum(hist, 0) / total
    levels = torch.arange(256, dtype=torch.float32, device=hist.device)
    mu = torch.cumsum(hist * levels, 0) / total
    mu_t = mu[-1]
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 0,
                          (mu_t * omega - mu) ** 2 / denom.clamp(min=1e-12),
                          torch.zeros((), device=hist.device))
    return torch.argmax(sigma_b)
