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

It returns the dense head dict only, as the JAX module does: a training
variant (`train.trainer.create_state(cfg, model=UNetCBAM(...))`), not
served by the sparse pipeline. Parameter names follow the Flax tree
(models/weights.py maps them): Dense_i -> dense{i}, CBAM_0 -> cbam,
ChannelAttention_0 -> channel, SpatialAttention_0 -> spatial,
DoubleConvCBAM_0 -> double_conv_cbam.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import (BN_EPS, BN_MOMENTUM, PRODUCTION_HEADS, BatchNorm, _conv,
                   _crop_or_pad_to, conv_bn_act, head_names)


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
        y = self.cbam(y, dtype)
        res = _conv(self.conv2, x, dtype) if hasattr(self, "conv2") \
            else x.to(dtype)
        return F.relu(y + res)


class DownCBAM(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.double_conv_cbam = DoubleConvCBAM(in_features, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.double_conv_cbam(F.max_pool2d(x, 2), dtype)


class UpCBAM(nn.Module):
    def __init__(self, in_features: int, out_features: int, skip: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_features, in_features // 2, 3,
                                     stride=2)
        self.double_conv_cbam = DoubleConvCBAM(skip + in_features // 2,
                                               out_features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        x = _conv(self.up, x, dtype, transpose=True)
        x = _crop_or_pad_to(x, skip.shape[2], skip.shape[3])
        x = torch.cat([skip, x.to(skip.dtype)], dim=1)
        return self.double_conv_cbam(x, dtype)


class OutConvNoDropout(nn.Module):
    """Conv3x3 -> BN -> LeakyReLU -> Conv1x1."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_features, in_features, 3, padding=1)
        self.bn0 = BatchNorm(in_features, BN_EPS, BN_MOMENTUM)
        self.conv1 = nn.Conv2d(in_features, out_features, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = conv_bn_act(self.conv0, self.bn0, x, "leaky_relu", dtype)
        return _conv(self.conv1, x, dtype)


class UNetCBAM(nn.Module):
    """CBAM U-Net (the reference's unet2.py:129-175). forward(x) takes NHWC
    images (B, H, W, 1) and returns a dict head name -> (B, H/4, W/4,
    width) f32 logits."""

    def __init__(self, heads: Sequence[int] = PRODUCTION_HEADS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = tuple(heads)
        self.dtype = dtype
        self.head_names = head_names(self.heads)
        self.s = nn.Parameter(torch.randn(10) / 100.0)
        self.inc1 = DoubleConvCBAM(1, 32, kernel=5)
        self.inc2 = DoubleConvCBAM(32, 32, kernel=5)
        self.down1 = DownCBAM(32, 32)
        self.down2 = DownCBAM(32, 64)
        self.inc3 = DoubleConvCBAM(64, 64)
        self.down3 = DownCBAM(64, 128)
        self.down4 = DownCBAM(128, 256)
        self.down5 = DownCBAM(256, 512)
        self.up1 = UpCBAM(512, 256, skip=256)
        self.up2 = UpCBAM(256, 128, skip=128)
        self.up3 = UpCBAM(128, 128, skip=64)
        self.dconv1 = DoubleConvCBAM(128, 128)
        self.dconv2 = DoubleConvCBAM(128, 128)
        for name, width in zip(self.head_names, self.heads):
            self.add_module(f"out_{name}", OutConvNoDropout(128, width))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`generator` is accepted for the trainer's call and unused: the
        CBAM heads have no dropout."""
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        x1 = self.inc2(self.inc1(x, dt), dt)
        x2 = self.down1(x1, dt)
        x3 = self.inc3(self.down2(x2, dt), dt)
        x4 = self.down3(x3, dt)
        x5 = self.down4(x4, dt)
        x6 = self.down5(x5, dt)
        y = self.up1(x6, x5, dt)
        y = self.up2(y, x4, dt)
        y = self.up3(y, x3, dt)
        y = self.dconv2(self.dconv1(y, dt), dt)
        return {name: getattr(self, f"out_{name}")(y, dt).float()
                .permute(0, 2, 3, 1) for name in self.head_names}
