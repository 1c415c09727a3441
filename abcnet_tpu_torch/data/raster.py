"""Grayscale image I/O and resize (PIL), the part of
abcnet_tpu/data/raster.py:130-144 that the training input path uses.
The drawing canvas and the fonts belong to the generator stack, which
is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image

__all__ = ["resize", "imwrite", "imread_gray"]


def resize(img: np.ndarray, out_hw: Tuple[int, int],
           resample=Image.BILINEAR) -> np.ndarray:
    """Resize a grayscale array to (rows, cols) — cv2.resize equivalent
    for the augmentation path (reference src/utils.py:50-54)."""
    h, w = out_hw
    pil = Image.fromarray(np.asarray(img).astype(np.uint8))
    return np.asarray(pil.resize((w, h), resample), np.uint8)


def imwrite(path: str, img: np.ndarray) -> None:
    Image.fromarray(np.asarray(img).astype(np.uint8)).save(path)


def imread_gray(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("L"), np.uint8)
