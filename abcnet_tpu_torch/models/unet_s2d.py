"""Space-to-depth stem U-Net (PyTorch), counterpart of
abcnet_tpu/models/unet_s2d.py.

The (B, 512, 512, 1) mask becomes (B, 128, 128, 16) by a lossless 4x4
space-to-depth, then two DoubleConvs at 128² lift it to the 64 channels
of the production model's x3 level; from there the topology, the head
contract (`dense_heads`, `return_features`) and the parameter names are
the production model's, so targets, losses, the sparse serving decode
and assembly run unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .unet import PRODUCTION_HEADS, DoubleConv, _Trunk


def space_to_depth(x: torch.Tensor, block: int = 4) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, H/b, W/b, C*b*b), the JAX function's
    channel order: channel (i*b + j)*C + c holds pixel (i, j) of the
    block, channel c. (F.pixel_unshuffle on NCHW orders c*b*b + i*b + j;
    the two agree only for C = 1.)"""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


class UNetS2D(_Trunk):
    """Production head I/O contract on a space-to-depth stem."""

    BLOCKS = ("stem1", "stem2") + _Trunk.BLOCKS

    def __init__(self, heads: Sequence[int] = PRODUCTION_HEADS,
                 dtype: torch.dtype = torch.float32):
        super().__init__(heads, dtype)

    def build_stem(self) -> None:
        self.stem1 = DoubleConv(16, 64)
        self.stem2 = DoubleConv(64, 64)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        # x is NCHW with one channel, so its NHWC view is a permute.
        x = space_to_depth(x.permute(0, 2, 3, 1), 4).permute(0, 3, 1, 2)
        return self._dc("stem2", self._dc("stem1", x))
