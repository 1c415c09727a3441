"""Overlay visualization, a copy of abcnet_tpu/utils/viz.py (numpy and
PIL): the reference's commented-out matplotlib debug blocks (its
src/train.py:29-41, utils.py:230-243, img2smiles2.py:81-102,318-337) as
a real utility.

Renders target/prediction peaks and bond rays over the input image and
writes a PNG; used for eyeballing data alignment and decode quality.
Takes numpy arrays or CPU tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from ..data import vocab


def overlay_targets(image_u8: np.ndarray, targets: Dict[str, np.ndarray],
                    path: Optional[str] = None,
                    stride: int = vocab.STRIDE) -> np.ndarray:
    """Mark atom centers (red) / bond centers (blue) + omega rays
    (green) from channel-first dense targets on the grayscale image."""
    from PIL import Image

    img = np.stack([np.asarray(image_u8)] * 3, -1).astype(np.uint8)
    at = np.asarray(targets["atom_target"])[0]
    bt = np.asarray(targets["bond_target"])[0]
    omega = np.asarray(targets["bond_omega"])
    rho = np.asarray(targets["bond_rho"])

    def mark(x, y, color):
        r0, r1 = max(x * stride - 2, 0), x * stride + 3
        c0, c1 = max(y * stride - 2, 0), y * stride + 3
        img[r0:r1, c0:c1] = color

    for x, y in zip(*np.where(at == 1.0)):
        mark(x, y, [255, 0, 0])
    for x, y in zip(*np.where(bt == 1.0)):
        mark(x, y, [0, 0, 255])
        for o in np.where(omega[:, x, y] == 1.0)[0]:
            ang = o * (math.pi / 30) + math.pi / 60 - math.pi / 2
            r = rho[o, x, y]
            dx, dy = r * math.cos(ang), r * math.sin(ang)
            for t in np.linspace(0, 1, 24):
                rr = int((x + dx * t) * stride)
                cc = int((y + dy * t) * stride)
                if 0 <= rr < img.shape[0] and 0 <= cc < img.shape[1]:
                    img[rr, cc] = [0, 200, 0]
    if path:
        Image.fromarray(img).save(path)
    return img


def overlay_peaks(image_u8: np.ndarray, peaks: Dict[str, np.ndarray],
                  index: int, path: Optional[str] = None,
                  stride: int = vocab.STRIDE) -> np.ndarray:
    """Mark decoded peaks (infer/decode.py output) on the image."""
    from PIL import Image

    img = np.stack([np.asarray(image_u8)] * 3, -1).astype(np.uint8)
    axy = np.asarray(peaks["atom_xy"][index])
    av = np.asarray(peaks["atom_valid"][index])
    bxy = np.asarray(peaks["bond_xy"][index])
    bd = np.asarray(peaks["bond_delta"][index])
    bv = np.asarray(peaks["bond_valid"][index])
    for (x, y), ok in zip(axy, av):
        if ok:
            img[max(x * stride - 2, 0):x * stride + 3,
                max(y * stride - 2, 0):y * stride + 3] = [255, 0, 0]
    for (x, y), (dx, dy), ok in zip(bxy, bd, bv):
        if not ok:
            continue
        for t in np.linspace(-1, 1, 32):
            rr = int((x + dx * t) * stride)
            cc = int((y + dy * t) * stride)
            if 0 <= rr < img.shape[0] and 0 <= cc < img.shape[1]:
                img[rr, cc] = [0, 200, 0]
    if path:
        Image.fromarray(img).save(path)
    return img
