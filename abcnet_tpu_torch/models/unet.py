"""Multi-head U-Net keypoint detector (PyTorch, NCHW inside).

Counterpart of abcnet_tpu/models/unet.py, block for block: stem
DoubleConv pair at 16 channels, encoder 16-32-64(-inc3)-128-256-512 via
max-pool downs, decoder with k3 s2 transposed convs + skip concat, two
trailing DoubleConvs at 128 channels, one OutConv head per output group,
all heads at stride 4. 10,698,575 parameters for the production heads
(1,14,3,2,1,360,60,60), the learned uncertainty weights `s` included.

Layout: the public `forward` takes NHWC images (B, H, W, 1) and returns
NHWC heads (B, H/4, W/4, width) and features, as the JAX module does;
both are views of the NCHW tensors the blocks compute on (a 1-channel
NHWC tensor is already NCHW in memory).

Precision follows the JAX module's `dtype`: parameters stay f32 master
weights, each conv casts its input and weights to `dtype` (bf16 in
production), BatchNorm runs in f32 and its output is cast back after
the activation. Heads stay in `dtype`. No autocast.

Train mode (`model.train()`) follows Flax, not torch's defaults, in two
places. BatchNorm normalizes with the batch statistics and moves its
running variance with the *biased* batch variance (torch's own update
uses the unbiased one). Dropout in the heads draws its keep mask from
the `generator` handed to `forward`, after the cast to the compute
dtype, so a training run is reproducible from its generator and never
touches the global CUDA stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

PRODUCTION_HEADS: Tuple[int, ...] = (1, 14, 3, 2, 1, 360, 60, 60)

HEAD_NAMES = ("atom_target", "atom_type", "atom_charge", "atom_hs",
              "bond_target", "bond_type", "bond_rho", "bond_omega")

BN_EPS = 1e-5
BN_MOMENTUM = 0.1        # flax momentum 0.9 (the weight of the old value)


class BatchNorm(nn.BatchNorm2d):
    """f32 batch norm with Flax's running-statistics update.

    Eval: normalizes with the running statistics, as nn.BatchNorm2d.
    Train: normalizes with the batch statistics and updates

        running = 0.9 * running + 0.1 * batch

    with the biased batch variance, as flax.linen.BatchNorm(momentum=0.9)
    does (abcnet_tpu/models/unet.py:45-46). torch's own update would use
    the unbiased variance, n/(n-1) larger. F.batch_norm is therefore
    given zeroed scratch buffers and momentum 1, which leaves the batch
    mean and the unbiased batch variance in them without another pass
    over the activation; the variance is scaled back by (n-1)/n."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(
                var, alpha=self.momentum * (n - 1) / n)
        return out


def _conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype,
          transpose: bool = False) -> torch.Tensor:
    """The conv in the compute dtype, weights cast from the f32 masters."""
    w, b = conv.weight.to(dtype), conv.bias.to(dtype)
    if transpose:
        return F.conv_transpose2d(x.to(dtype), w, b, stride=conv.stride)
    return F.conv2d(x.to(dtype), w, b, padding=conv.padding)


class DoubleConv(nn.Module):
    """(conv k -> BN -> ReLU) x2 (the reference's unet.py:6-21)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3):
        super().__init__()
        pad = kernel // 2
        self.conv0 = nn.Conv2d(in_features, features, kernel, padding=pad)
        self.bn0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)
        self.conv1 = nn.Conv2d(features, features, kernel, padding=pad)
        self.bn1 = BatchNorm(features, BN_EPS, BN_MOMENTUM)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = F.relu(bn(_conv(conv, x, dtype).float())).to(dtype)
        return x


class Down(nn.Module):
    """MaxPool 2x2 then DoubleConv (unet.py:24-35)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.double_conv = DoubleConv(in_features, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.double_conv(F.max_pool2d(x, 2), dtype)


def _crop_or_pad_to(x: torch.Tensor, target_h: int, target_w: int):
    """Match spatial dims to the skip tensor with the reference's
    asymmetric pad (unet.py:51-55): amounts (d//2, d - d//2), negative
    values crop. For the 2H+1 transposed-conv output d = -1 gives
    (-1, 0): the leading row and column go."""
    dh = target_h - x.shape[2]
    dw = target_w - x.shape[3]
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class Up(nn.Module):
    """Transposed conv k3 s2 (channels halved), crop/pad to the skip,
    concat, DoubleConv (unet.py:38-60).

    The weight of `up` is a torch ConvTranspose2d weight (in, out, kh,
    kw). Flax's ConvTranspose does not flip its kernel, so a Flax kernel
    maps to it flipped on both spatial axes (models/weights.py)."""

    def __init__(self, in_features: int, out_features: int, skip: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_features, in_features // 2, 3,
                                     stride=2)
        self.double_conv = DoubleConv(skip + in_features // 2, out_features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        x = _conv(self.up, x, dtype, transpose=True)
        x = _crop_or_pad_to(x, skip.shape[2], skip.shape[3])
        x = torch.cat([skip, x.to(skip.dtype)], dim=1)
        return self.double_conv(x, dtype)


class OutConv(nn.Module):
    """Conv3x3 -> BN -> LeakyReLU -> Dropout(0.2) -> Conv1x1
    (unet.py:63-74). Dropout is the identity in eval; in train mode the
    keep mask (p = 0.8, survivors scaled by 1/0.8) is drawn from
    `generator` (the device's default generator if None)."""

    DROP = 0.2

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_features, in_features, 3, padding=1)
        self.bn0 = BatchNorm(in_features, BN_EPS, BN_MOMENTUM)
        self.conv1 = nn.Conv2d(in_features, out_features, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.bn0(_conv(self.conv0, x, dtype).float())
        x = F.leaky_relu(x, 0.01).to(dtype)
        if self.training:
            keep = torch.empty_like(x).bernoulli_(1 - self.DROP,
                                                  generator=generator)
            x = x * keep.mul_(1.0 / (1 - self.DROP))   # 0 or 1.25, exact
        return _conv(self.conv1, x, dtype)


class UNet(nn.Module):
    """Production multi-head U-Net.

    forward(x) takes NHWC images (B, 512, 512, 1) and returns a dict
    head name -> (B, 128, 128, width) logits in `dtype`."""

    def __init__(self, heads: Sequence[int] = PRODUCTION_HEADS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = tuple(heads)
        self.dtype = dtype
        self.head_names = (HEAD_NAMES if len(self.heads) == len(HEAD_NAMES)
                           else tuple(f"head{i}"
                                      for i in range(len(self.heads))))
        # Learned homoscedastic uncertainty weights (unet.py:82).
        self.s = nn.Parameter(torch.randn(10) / 100.0)
        self.inc1 = DoubleConv(1, 16)
        self.inc2 = DoubleConv(16, 16)
        self.down1 = Down(16, 32)
        self.down2 = Down(32, 64)
        self.inc3 = DoubleConv(64, 64)
        self.down3 = Down(64, 128)
        self.down4 = Down(128, 256)
        self.down5 = Down(256, 512)
        self.up1 = Up(512, 256, skip=256)
        self.up2 = Up(256, 128, skip=128)
        self.up3 = Up(128, 128, skip=64)
        self.dconv1 = DoubleConv(128, 128)
        self.dconv2 = DoubleConv(128, 128)
        for name, width in zip(self.head_names, self.heads):
            self.add_module(f"out_{name}", OutConv(128, width))

    def head(self, name: str) -> OutConv:
        return getattr(self, f"out_{name}")

    def forward(self, x: torch.Tensor, dense_heads: Sequence[str] = None,
                return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: NHWC (B, H, W, 1). dense_heads: if given, only these heads
        are computed. return_features additionally returns the shared
        NHWC (B, H/4, W/4, 128) trunk features, so callers can evaluate
        the other heads only at peak cells (infer/decode.py). generator:
        the source of the heads' dropout masks in train mode."""
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

        out: Dict[str, torch.Tensor] = {}
        for name in self.head_names:
            if dense_heads is not None and name not in dense_heads:
                continue
            out[name] = self.head(name)(y, dt, generator).permute(0, 2, 3, 1)
        if return_features:
            return out, y.permute(0, 2, 3, 1)
        return out


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
