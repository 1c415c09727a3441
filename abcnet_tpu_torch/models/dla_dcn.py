"""CenterNet's DLA-34 with deformable up-convolutions under ABC-Net's eight
heads (PyTorch, NCHW inside).

The source is CenterNet's `pose_dla_dcn.py` ("Objects as Points",
arXiv:1904.07850; github.com/xingyizhou/CenterNet, src/lib/models/
networks/pose_dla_dcn.py: `dla34`, `DLASeg`), DLA from arXiv:1707.06484
and the deformable conv from DCNv2 (arXiv:1811.11168,
github.com/CharlesShang/DCNv2, `DCN`). `down_ratio` 4: a 512² drawing
gives the 128² grid of ABC-Net's heads.

  * the base, `levels` (1, 1, 1, 2, 2, 1), `channels` (16, 32, 64, 128,
    256, 512): a 7x7 stride-1 conv to 16 (bias off, BatchNorm, ReLU),
    level0 a 3x3 conv to 16, level1 a 3x3 stride-2 conv to 32, levels 2-5
    `Tree`s of residual `BasicBlock`s (3x3 conv, BN, ReLU, 3x3 conv, BN,
    + residual, ReLU) that downsample by a 2x2 max pool and project the
    residual with a 1x1 conv and BN where the width changes; a `Root`
    (1x1 conv over the concatenated children, plus the level's pooled
    input where `level_root`, BN, ReLU) closes each tree of one level;
  * iterative deep aggregation, `DLAUp` (three `IDAUp`s over levels 2-5)
    and the final `IDAUp(64, (64, 128, 256), (1, 2, 4))`: in each step a
    `DeformConv` projects a level to the step's width, a depthwise
    transposed conv (kernel 2f, stride f, padding f / 2, bilinear
    weights) brings it up by f, and a second `DeformConv` takes the sum
    with the level above: 16 deformable sites at 16², 32², 64², 128²;
  * `DeformConv`: DCNv2's 3x3 conv (ops/deform_conv.py) whose offsets and
    masks come from its own 3x3 conv to 27 channels (`conv_offset_mask`),
    then BN and ReLU;
  * one head a name (`out_<name>`): 3x3 conv 64 -> 256 with bias, ReLU,
    1x1 conv 256 -> width with bias (CenterNet's `head_conv` 256,
    `final_kernel` 1).

Departures from the source, each also the configuration's
(benchmark/configs/dla34_dcn_bf16.json):
  * the input is the binarized 1-channel mask, as every ABC-Net model's,
    not RGB: the stem conv takes 1 channel;
  * the heads are ABC-Net's eight, by name, in the serving contract's
    dict, not CenterNet's hm / wh / reg;
  * the benchmark's seeded weights draw `conv_offset_mask` (He-normal,
    scaled by 0.2) where the source zeroes it, so that a seeded model
    samples off the grid (with zero offsets and masks the layer is a plain
    conv scaled by 1/2);
  * the outer tree of levels 3 and 4 (levels 2) computes no `project`: the
    source computes it and its first child, a tree, overwrites the
    residual it is handed, so it never reaches the output. Its parameters
    stay, so the model's count is the source's.

Precision follows the port's convention (models/unet.py): convs in
`dtype` (bf16 in serving) on f32 masters, each BatchNorm in f32 through
ops/bn_act.py with its activation and cast, the heads back in f32. The
deformable sites form their sampling coordinates in f32, the offset added
to the integer grid position. Channels-last inside on a GPU.

Serving contract of models/unet.py:_Trunk.forward: `forward(x,
dense_heads, return_features, generator)` on NHWC (B, H, W, 1) images,
`return_features` gives the 64-channel stride-4 map, and `head(name)` the
head that infer/decode.py's sparse heads fuse. Each of the 16 eval-mode
deformable sites (offset / mask conv, sampling, contraction, BN, ReLU) is
a device span `dcn` of utils/profiling.py that counts one `dcn_sites`;
without an active profile both are no-ops. In eval mode and bf16 a site
runs ops/deform_conv.py:deform_conv_bn_act_eval (on a GPU the kernel of
csrc/deform_conv.cu); in eval mode and another type its plain version;
in train mode the plain op under autograd. Training this model is not
measured.

Parameter names map to the snapshot's Flax-style tree through
models/weights.py (conv{i} -> Conv_{i}, bn{i} -> BatchNorm_{i}, every
other name as it is); a depthwise up is stored as a conv kernel
(2f, 2f, 1, o) (HWIO, I = 1).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import (deform_conv_bn_act_eval,
                                deform_conv_bn_act_eval_plain,
                                deform_conv_plain)
from ..utils import profiling
from .unet import BN_EPS, BN_MOMENTUM, PRODUCTION_HEADS, BatchNorm, head_names

LEVELS = (1, 1, 1, 2, 2, 1)
CHANNELS = (16, 32, 64, 128, 256, 512)
FIRST_LEVEL = 2             # log2(down_ratio 4)
LAST_LEVEL = 5
HEAD_CONV = 256


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """The conv in the compute dtype with its stride, padding and bias
    (if any), weights cast from the f32 masters."""
    b = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), b,
                    stride=conv.stride, padding=conv.padding)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, BN_EPS, BN_MOMENTUM)


class ConvBN(nn.Module):
    """conv (bias off) -> BatchNorm -> activation: a `_make_conv_level`
    layer, the stem, a projection or a root's conv."""

    def __init__(self, ci: int, co: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv0 = nn.Conv2d(ci, co, kernel, stride, kernel // 2,
                               bias=False)
        self.bn0 = _bn(co)

    def forward(self, x: torch.Tensor, act: str,
                dtype: torch.dtype) -> torch.Tensor:
        return self.bn0.act(_conv(self.conv0, x, dtype), act, dtype)


class BasicBlock(nn.Module):
    """conv3x3 (stride) -> BN -> ReLU -> conv3x3 -> BN, + residual, ReLU."""

    def __init__(self, ci: int, co: int, stride: int = 1):
        super().__init__()
        self.conv0 = nn.Conv2d(ci, co, 3, stride, 1, bias=False)
        self.bn0 = _bn(co)
        self.conv1 = nn.Conv2d(co, co, 3, 1, 1, bias=False)
        self.bn1 = _bn(co)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
        residual = x if residual is None else residual
        y = self.bn0.act(_conv(self.conv0, x, dtype), "relu", dtype)
        y = self.bn1.act(_conv(self.conv1, y, dtype), "none", dtype)
        return F.relu(y + residual.to(dtype))


class Root(nn.Module):
    """1x1 conv over the concatenated children -> BN -> ReLU
    (`residual_root` False)."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv0 = nn.Conv2d(ci, co, 1, bias=False)
        self.bn0 = _bn(co)

    def forward(self, children, dtype: torch.dtype) -> torch.Tensor:
        x = torch.cat([c.to(dtype) for c in children], dim=1)
        return self.bn0.act(_conv(self.conv0, x, dtype), "relu", dtype)


class Tree(nn.Module):
    """DLA's Tree: `levels` 1 holds two BasicBlocks and a Root; more
    levels hold two Trees, the second taking the first's children."""

    def __init__(self, levels: int, ci: int, co: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * co
        if level_root:
            root_dim += ci
        if levels == 1:
            self.tree1 = BasicBlock(ci, co, stride)
            self.tree2 = BasicBlock(co, co, 1)
            self.root = Root(root_dim, co)
        else:
            self.tree1 = Tree(levels - 1, ci, co, stride)
            self.tree2 = Tree(levels - 1, co, co, root_dim=root_dim + co)
        self.levels, self.level_root, self.stride = levels, level_root, stride
        if ci != co:
            self.project = ConvBN(ci, co, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                children=None) -> torch.Tensor:
        children = [] if children is None else children
        bottom = F.max_pool2d(x, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom, "none", dtype) \
                if hasattr(self, "project") else bottom
            x1 = self.tree1(x, residual, dtype)
            x2 = self.tree2(x1, None, dtype)
            return self.root([x2, x1, *children], dtype)
        # the source's project of this level feeds a Tree that overwrites
        # it: never computed here (the module docstring's departures)
        x1 = self.tree1(x, dtype)
        children.append(x1)
        return self.tree2(x1, dtype, children)


class DLA34(nn.Module):
    """DLA-34's base: the stem, level0-1 conv levels, level2-5 trees.
    Returns the six levels' outputs."""

    def __init__(self, in_channels: int = 1):
        super().__init__()
        c = CHANNELS
        self.base_layer = ConvBN(in_channels, c[0], 7)
        self.level0 = ConvBN(c[0], c[0], 3)
        self.level1 = ConvBN(c[0], c[1], 3, stride=2)
        self.level2 = Tree(LEVELS[2], c[1], c[2], 2, level_root=False)
        self.level3 = Tree(LEVELS[3], c[2], c[3], 2, level_root=True)
        self.level4 = Tree(LEVELS[4], c[3], c[4], 2, level_root=True)
        self.level5 = Tree(LEVELS[5], c[4], c[5], 2, level_root=True)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        x = self.base_layer(x, "relu", dtype)
        y = [self.level0(x, "relu", dtype)]
        y.append(self.level1(y[-1], "relu", dtype))
        for i in range(2, 6):
            y.append(getattr(self, f"level{i}")(y[-1], dtype))
        return y


class DeformConv(nn.Module):
    """DCNv2's 3x3 deformable conv -> BN -> ReLU. `conv0` holds the DCN's
    weight and bias, `conv1` its `conv_offset_mask` (3x3 to 27 channels,
    with bias)."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv0 = nn.Conv2d(ci, co, 3, padding=1)
        self.conv1 = nn.Conv2d(ci, 27, 3, padding=1)
        self.bn0 = _bn(co)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        if self.training:
            om = _conv(self.conv1, x, dtype)
            y = deform_conv_plain(x, om, self.conv0.weight, self.conv0.bias)
            return self.bn0.act(y, "relu", dtype)
        bn = self.bn0
        # the kernel takes bf16; another compute type takes the plain op
        op = deform_conv_bn_act_eval if dtype == torch.bfloat16 \
            else deform_conv_bn_act_eval_plain
        with profiling.device_span("dcn", x):
            profiling.count("dcn_sites", 1)
            om = _conv(self.conv1, x, dtype)
            return op(x, om, self.conv0.weight, self.conv0.bias,
                      bn.running_mean, bn.running_var, bn.weight, bn.bias,
                      bn.eps, "relu")


def fill_up_weights(up: nn.ConvTranspose2d) -> None:
    """The source's bilinear kernel in every channel of a depthwise up."""
    w = up.weight.data
    f = math.ceil(w.size(2) / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    for i in range(w.size(2)):
        for j in range(w.size(3)):
            w[0, 0, i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    w[1:, 0] = w[0, 0]


class IDAUp(nn.Module):
    """Iterative deep aggregation over `channels` (levels at scales
    `up_f`) into width `o`: proj{i}, up{i}, node{i} for i >= 1."""

    def __init__(self, o: int, channels: Sequence[int],
                 up_f: Sequence[int]):
        super().__init__()
        for i in range(1, len(channels)):
            f = int(up_f[i])
            setattr(self, f"proj{i}", DeformConv(channels[i], o))
            up = nn.ConvTranspose2d(o, o, 2 * f, stride=f, padding=f // 2,
                                    groups=o, bias=False)
            fill_up_weights(up)
            setattr(self, f"up{i}", up)
            setattr(self, f"node{i}", DeformConv(o, o))

    def forward(self, layers, startp: int, endp: int,
                dtype: torch.dtype) -> None:
        for i in range(startp + 1, endp):
            k = i - startp
            up = getattr(self, f"up{k}")
            y = getattr(self, f"proj{k}")(layers[i], dtype)
            y = F.conv_transpose2d(y, up.weight.to(dtype), None, up.stride,
                                   up.padding, groups=up.groups)
            layers[i] = getattr(self, f"node{k}")(y + layers[i - 1].to(dtype),
                                                  dtype)


class DLAUp(nn.Module):
    """DLAUp(startp, channels, scales): ida_0 .. ida_{n-2}, each aggregating
    the deepest levels into the next shallower width."""

    def __init__(self, startp: int, channels: Sequence[int],
                 scales: Sequence[int]):
        super().__init__()
        self.startp = startp
        in_channels = list(channels)
        scales = list(scales)
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]]))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers, dtype: torch.dtype):
        layers = list(layers)
        out = [layers[-1]]
        for i in range(len(layers) - self.startp - 1):
            getattr(self, f"ida_{i}")(layers, len(layers) - i - 2,
                                      len(layers), dtype)
            out.insert(0, layers[-1])
        return out


class CenterNetHead(nn.Module):
    """conv3x3 (64 -> 256, bias) -> ReLU -> conv1x1 (256 -> width, bias):
    CenterNet's head at `head_conv` 256 and `final_kernel` 1, no
    BatchNorm."""

    def __init__(self, ci: int, width: int, head_conv: int = HEAD_CONV):
        super().__init__()
        self.conv0 = nn.Conv2d(ci, head_conv, 3, padding=1)
        self.conv1 = nn.Conv2d(head_conv, width, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return _conv(self.conv1, F.relu(_conv(self.conv0, x, dtype)), dtype)


class DLASeg(nn.Module):
    """DLA-34 + DCN aggregation + ABC-Net's heads. forward(x) takes NHWC
    images (B, H, W, 1) and returns a dict head name -> (B, H/4, W/4,
    width) float32 logits; `dense_heads` and `return_features` as the
    production UNet's (the features are 64 channels)."""

    HEAD_DTYPE = torch.float32

    def __init__(self, heads: Sequence[int] = PRODUCTION_HEADS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = tuple(heads)
        self.dtype = dtype
        self.head_names = head_names(self.heads)
        c = CHANNELS
        self.base = DLA34()
        scales = [2 ** i for i in range(len(c[FIRST_LEVEL:]))]
        self.dla_up = DLAUp(FIRST_LEVEL, c[FIRST_LEVEL:], scales)
        self.ida_up = IDAUp(c[FIRST_LEVEL], c[FIRST_LEVEL:LAST_LEVEL],
                            [2 ** i for i in range(LAST_LEVEL - FIRST_LEVEL)])
        for name, width in zip(self.head_names, self.heads):
            self.add_module(f"out_{name}",
                            CenterNetHead(c[FIRST_LEVEL], width))

    def head(self, name: str) -> CenterNetHead:
        return getattr(self, f"out_{name}")

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The NCHW (B, 64, H/4, W/4) map the heads read, from NCHW x."""
        dt = self.dtype
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        up = self.dla_up(self.base(x, dt), dt)
        y = up[:LAST_LEVEL - FIRST_LEVEL]
        self.ida_up(y, 0, len(y), dt)
        return y[-1]

    def forward(self, x: torch.Tensor, dense_heads: Sequence[str] = None,
                return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        y = self.features(x.permute(0, 3, 1, 2).to(self.dtype))
        heads = {n: self.head(n)(y, self.dtype).to(self.HEAD_DTYPE)
                 for n in self.head_names
                 if dense_heads is None or n in dense_heads}
        out = {n: v.permute(0, 2, 3, 1) for n, v in heads.items()}
        if return_features:
            return out, y.permute(0, 2, 3, 1)
        return out
