"""Serving input path: host binarize + 1-bit pack, device unpack.

Counterpart of the eval half of abcnet_tpu/data/pipeline.py. Images are
binarized and bit-packed on the host (1 bit per pixel crosses to the
device, an eighth of the uint8 image) and unpacked on the device by
kernel 1 (ops/unpack.py). The training half (salt/pepper noise, the
`_kernel_noise` kernel, collation of labels) comes with the training
slice of the port.
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

import numpy as np
import torch

from ..ops.unpack import unpack_bits

SIZE = 512


def pack_images(images_u8: np.ndarray, threshold: float = 0.6) -> np.ndarray:
    """Binarize (ink = gray/255 < threshold, the reference's utils.py:63)
    and bit-pack along the column axis: (B, H, W) uint8 -> (B, H, W//8)
    uint8, MSB first.

    The predicate gray/255 < t is monotone in the uint8 value, so it
    equals x < cutoff, with the cutoff found by evaluating the f32
    predicate over all 256 byte values: no float temporary the size of
    the batch."""
    lut = (np.arange(256, dtype=np.uint8).astype(np.float32)
           / 255.0) < threshold
    cutoff = int(lut.sum())
    if cutoff <= 0:
        ink = np.zeros(images_u8.shape, bool)
    elif cutoff >= 256:
        ink = np.ones(images_u8.shape, bool)
    else:
        ink = images_u8 < np.uint8(cutoff)
    return np.packbits(ink, axis=-1)


def device_unpack_bits(image_bits: torch.Tensor, train: bool = False,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bit-packed batch (B, H, W//8) -> {0, 1} mask (B, H, W, 1) in
    `dtype`, the eval path of abcnet_tpu's device_unpack_bits.

    The binarize threshold was applied at pack time (pack_images). The
    (B, H, W, 1) result is a view of the (B, H, W) buffer the kernel
    writes, which is also the NCHW (B, 1, H, W) input of the stem conv."""
    if train:
        raise NotImplementedError(
            "train=True needs the salt/pepper noise kernel (_kernel_noise), "
            "which comes with the training slice of the port")
    return unpack_bits(image_bits, dtype)[..., None]


def _read_gray(path: str) -> np.ndarray:
    from PIL import Image          # only the CLI reads image files
    img = Image.open(path).convert("L")
    if img.size != (SIZE, SIZE):
        img = img.resize((SIZE, SIZE), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def load_image_csv(csv_path: str) -> Tuple[List[np.ndarray], List[str]]:
    """Read a dataset CSV: the labelled format the generator writes
    (Smiles/atoms_string/bonds_string/path) or a plain (image, smiles)
    CSV like the UOB benchmark's. Returns (uint8 images resized to
    512 x 512, SMILES). Image paths are relative to the CSV's directory.
    Column names are matched case-insensitively: SMILES from `smiles`,
    the image from path/file/filename/image/image_path."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = {c.lower(): c for c in (rows[0].keys() if rows else ())}
    smi_col = cols.get("smiles")
    img_col = next((cols[k] for k in ("path", "file", "filename", "image",
                                      "image_path") if k in cols), None)
    if smi_col is None or img_col is None:
        raise ValueError(f"{csv_path}: need a SMILES and an image-path "
                         f"column; got {sorted(cols.values())}")
    root = os.path.dirname(csv_path)
    images = [_read_gray(os.path.join(root, r[img_col])) for r in rows]
    return images, [r[smi_col] for r in rows]
