"""CBAM U-Net variant (PyTorch, NCHW inside), counterpart of
abcnet_tpu/models/unet_cbam.py (the reference's src/unet2.py).

Differences from the production model:
  * stem widened to 32 channels with k5 convs;
  * DoubleConv = (conv-BN-ReLU, conv-BN) + CBAM (channel attention from
    the spatial mean and max through a shared two-layer MLP, then spatial
    attention from the channel mean and max through a 7x7 conv) +
    residual 1x1 shortcut where the width changes, ReLU after the add;
  * OutConv without dropout; the heads come back in f32.
11,177,340 parameters at the production heads. Precision follows the
production model: convs and dense layers in `dtype` on f32 masters,
BatchNorm in f32 (`conv_bn_act`, as the production model).

Built on the production model's `_Trunk`, so it has the production
serving contract: `forward(x, dense_heads, return_features, generator)`,
the per-head `head(name)` that infer/decode.py's sparse heads fuse, and
remat. `img2smiles` serves it as it serves the production model. Each of
the 13 gate sites (channel gate, spatial gate, residual add, ReLU) is a
device span `cbam` of utils/profiling.py and counts one `cbam_gates`;
without an active profile both are no-ops. Parameter names follow the
Flax tree (models/weights.py maps them): Dense_i -> dense{i}, CBAM_0 ->
cbam, ChannelAttention_0 -> channel, SpatialAttention_0 -> spatial,
DoubleConvCBAM_0 -> double_conv_cbam.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import profiling
from .unet import (BN_EPS, BN_MOMENTUM, PRODUCTION_HEADS, BatchNorm, Down,
                   OutConv, Up, _conv, _Trunk, conv_bn_act)


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class ChannelAttention(nn.Module):
    """Squeeze (spatial mean and max) -> shared MLP -> sigmoid gate."""

    def __init__(self, features: int, reduction: int = 16):
        super().__init__()
        mid = max(features // reduction, 1)
        self.dense0 = nn.Linear(features, mid)
        self.dense1 = nn.Linear(mid, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        def mlp(v):
            return _dense(self.dense1, F.relu(_dense(self.dense0, v, dtype)),
                          dtype)
        avg = x.mean(dim=(2, 3))
        mx = x.amax(dim=(2, 3))
        return torch.sigmoid(mlp(avg) + mlp(mx))[:, :, None, None]


class SpatialAttention(nn.Module):
    """Channel mean and max -> conv 7x7 -> sigmoid gate."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(2, 1, 7, padding=3)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(_conv(self.conv0, s, dtype))


class CBAM(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.channel = ChannelAttention(features)
        self.spatial = SpatialAttention()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.channel(x, dtype) * x
        return self.spatial(x, dtype) * x


class DoubleConvCBAM(nn.Module):
    """(conv-BN-ReLU, conv-BN, CBAM) + residual shortcut, final ReLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 3):
        super().__init__()
        pad = kernel // 2
        self.conv0 = nn.Conv2d(in_features, features, kernel, padding=pad)
        self.bn0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)
        self.conv1 = nn.Conv2d(features, features, kernel, padding=pad)
        self.bn1 = BatchNorm(features, BN_EPS, BN_MOMENTUM)
        self.cbam = CBAM(features)
        if in_features != features:
            self.conv2 = nn.Conv2d(in_features, features, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = conv_bn_act(self.conv0, self.bn0, x, "relu", dtype)
        y = conv_bn_act(self.conv1, self.bn1, y, "none", dtype)
        res = _conv(self.conv2, x, dtype) if hasattr(self, "conv2") \
            else x.to(dtype)
        with profiling.device_span("cbam", y):
            profiling.count("cbam_gates", 1)
            return F.relu(self.cbam(y, dtype) + res)


class DownCBAM(Down):
    BLOCK, BODY = DoubleConvCBAM, "double_conv_cbam"


class UpCBAM(Up):
    BLOCK, BODY = DoubleConvCBAM, "double_conv_cbam"


class OutConvNoDropout(OutConv):
    """Conv3x3 -> BN -> LeakyReLU -> Conv1x1: OutConv with no dropout
    (`generator` is accepted for the trainer's call and unused)."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = conv_bn_act(self.conv0, self.bn0, x, "leaky_relu", dtype)
        return _conv(self.conv1, x, dtype)


class UNetCBAM(_Trunk):
    """CBAM U-Net (the reference's unet2.py:129-175). forward(x) takes NHWC
    images (B, H, W, 1) and returns a dict head name -> (B, H/4, W/4,
    width) f32 logits; `dense_heads` and `return_features` as the
    production UNet's."""

    BLOCKS = ("inc1", "inc2", "down1", "down2", "inc3") + _Trunk.BLOCKS
    DOUBLE_CONV, DOWN, UP, OUT_CONV = (DoubleConvCBAM, DownCBAM, UpCBAM,
                                       OutConvNoDropout)
    HEAD_DTYPE = torch.float32

    def __init__(self, heads: Sequence[int] = PRODUCTION_HEADS,
                 dtype: torch.dtype = torch.float32):
        super().__init__(heads, dtype)

    def build_stem(self) -> None:
        self.inc1 = DoubleConvCBAM(1, 32, kernel=5)
        self.inc2 = DoubleConvCBAM(32, 32, kernel=5)
        self.down1 = DownCBAM(32, 32)
        self.down2 = DownCBAM(32, 64)
        self.inc3 = DoubleConvCBAM(64, 64)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self._dc("inc2", self._dc("inc1", x))
        x2 = self._down("down1", x1)
        return self._dc("inc3", self._down("down2", x2))
