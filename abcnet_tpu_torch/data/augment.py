"""Image augmentation: anisotropic rescale, binarize, salt/pepper noise.

Host (numpy) transliteration of the reference train dataset's
__getitem__ preprocessing (reference src/utils.py:44-81):
  * 20%: one axis rescaled by U(0.8, 1) then white re-center-pad to 512
  * binarize at threshold 0.6 (foreground = ink = 1)
  * salt (adds ink) at rate U(0, amount/100)
  * pepper (erases ink) at rate U(0, amount); final fg = (ink|salt) & ~pepper

The device variant (noise + binarize only; geometry is handled on the
host because it moves the labels) lives in pipeline.py. Own copy of
abcnet_tpu/data/augment.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class AugmentParams:
    scale_x: float  # row-axis scale
    scale_y: float  # col-axis scale
    ddx: int        # row padding offset
    ddy: int        # col padding offset


def augment_np(img_u8: np.ndarray, rng: np.random.Generator,
               amount: float = 0.2, size: int = 512,
               train: bool = True) -> Tuple[np.ndarray, AugmentParams]:
    """Returns (binary float32 [1, size, size] foreground mask, params)."""
    from . import raster

    temp = img_u8
    scale_x = 1.0
    scale_y = 1.0
    if train and rng.random() < 0.2:
        if rng.random() < 0.5:
            scale_x = rng.uniform(0.8, 1.0)
            temp = raster.resize(temp, (int(scale_x * size), size))
        else:
            scale_y = rng.uniform(0.8, 1.0)
            temp = raster.resize(temp, (size, int(scale_y * size)))
    temp = temp.astype(np.float32)

    ddx = (size - temp.shape[0]) // 2
    ddy = (size - temp.shape[1]) // 2
    canvas = np.full((size, size), 255.0, np.float32)
    canvas[ddx:ddx + temp.shape[0], ddy:ddy + temp.shape[1]] = temp

    ink = ((canvas / 255.0) < 0.6).astype(np.float32)

    if train and amount > 0:
        salt_amount = rng.uniform(0, amount / 100)
        salt = rng.uniform(0, 1, ink.shape) < salt_amount
        ink = np.logical_or(ink, salt)
        pepper_amount = rng.uniform(0, amount)
        pepper = rng.uniform(0, 1, ink.shape) < pepper_amount
        ink = np.logical_and(ink, np.logical_not(pepper)).astype(np.float32)
    else:
        ink = ink.astype(np.float32)

    return ink[None], AugmentParams(scale_x, scale_y, ddx, ddy)


def binarize_test_np(img_u8: np.ndarray, threshold: float = 0.2,
                     size: int = 512) -> np.ndarray:
    """Inference-time binarization (utils_for_test.py:22-28): fg = ink."""
    from . import raster
    img = img_u8
    if img.shape != (size, size):
        img = raster.resize(img, (size, size))
    ink = 1.0 - ((img.astype(np.float32) / 255.0) > threshold).astype(
        np.float32)
    return ink[None]
