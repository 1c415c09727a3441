"""Plain PyTorch reference of ABC-Net's CBAM U-Net (src/unet2.py:6-186).

The configuration `unet_cbam_bf16` as its file states it: the production
U-Net's topology (reference/unet.py) with every DoubleConv a
DoubleConvCBAM, the stem at 32 channels with 5x5 kernels:

  * DoubleConvCBAM (unet2.py:49-74): conv k -> BatchNorm -> ReLU, conv k
    -> BatchNorm, CBAM, plus the residual (a 1x1 conv where the width
    changes, else the block's input), then ReLU;
  * CBAM (unet2.py:6-46): the channel gate sigmoid(mlp(spatial mean) +
    mlp(spatial max)), the MLP shared, Dense(C / 16) -> ReLU -> Dense(C);
    then the spatial gate sigmoid(conv7x7([channel mean, channel max]));
    each gate multiplies the tensor;
  * blocks: inc1 (1 -> 32, k5), inc2 (32 -> 32, k5), down1 (32), down2
    (64), inc3 (64), down3-5 (128, 256, 512) after 2x2 max pools; up1-3
    (k3 s2 transposed convs, crop to the skip, concat) to 256, 128, 128;
    dconv1-2 at 128; 13 CBAM sites;
  * the eight OutConvs without dropout (unet2.py:116-126): 3x3 conv ->
    BatchNorm -> LeakyReLU 0.01 -> 1x1 conv, at stride 4.

Eval mode: BatchNorm uses the running statistics. Everything in float32
with TF32 off. Weights come straight from a snapshot .npz of flattened
Flax variables (`params/<block>/[DoubleConvCBAM_0/]Conv_i/kernel` HWIO,
`.../CBAM_0/ChannelAttention_0/Dense_i/kernel` (in, out),
`.../CBAM_0/SpatialAttention_0/Conv_0/kernel`, `batch_stats/...`).

Departures from src/unet2.py, each also that of the port and of the
JAX package's module (whose parameter count, 11,177,340, is unet2.py's):
the transposed conv's (2H+1)-wide output is matched to the skip with the
production model's asymmetric pad (reference/unet.py:_crop_to); the
input is the binarized mask (B, 1, H, W); the heads come back as a dict
of NCHW float32 logits of the eight named heads, where unet2.py returns
a list, with the trunk's features beside them; the channel MLP's two
Dense layers carry biases.

Two controls for the comparison's limits, `variant`:
  * "no_max": the channel gate from the spatial mean alone (the max
    branch left out);
  * "fp8": each gate and the carry between blocks (each block's output)
    rounded to float8 e4m3.

`calibrate` takes a BatchNorm's statistics from the batch in front of
it (biased variance, as Flax's running update uses) and writes them
into the weights as it goes, so a forward over a batch of drawings
leaves every BatchNorm recalibrated to it (benchmark/cbam_weights.py).

Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .unet import EPS, HEADS, exact_f32, load_snapshot  # noqa: F401
from .unet import _convt, _crop_to

# (block, in, out, kernel) of the DoubleConvCBAM blocks, forward order;
# the Downs' and Ups' blocks sit under DoubleConvCBAM_0.
STEM = (("inc1", 1, 32, 5), ("inc2", 32, 32, 5), ("down1", 32, 32, 3),
        ("down2", 32, 64, 3), ("inc3", 64, 64, 3))
ENCODER = (("down3", 64, 128, 3), ("down4", 128, 256, 3),
           ("down5", 256, 512, 3))
UPS = (("up1", 512, 256, 256), ("up2", 256, 128, 128),
       ("up3", 128, 64, 128))               # (block, in, skip, out)
TAIL = (("dconv1", 128, 128, 3), ("dconv2", 128, 128, 3))
REDUCTION = 16
SPATIAL_KERNEL = 7
HEAD_FEATURES = 128


def prefix(name: str) -> str:
    """The Flax path of a block's DoubleConvCBAM."""
    return f"{name}/DoubleConvCBAM_0" if name.startswith(("down", "up")) \
        else name


def blocks():
    """(Flax path, in, out, kernel) of every DoubleConvCBAM, forward
    order."""
    for name, ci, co, k in STEM + ENCODER:
        yield prefix(name), ci, co, k
    for name, ci, skip, co in UPS:
        yield prefix(name), skip + ci // 2, co, 3
    for name, ci, co, k in TAIL:
        yield prefix(name), ci, co, k


def param_shapes(heads: Dict[str, int] = HEADS) -> Dict[str, tuple]:
    """{Flax key: shape} of every parameter of the model, in the order of
    the JAX module's tree walk (`s`, the blocks, the heads)."""
    shapes = {"params/s": (10,)}

    def conv(p, ci, co, k):
        shapes[f"params/{p}/kernel"] = (k, k, ci, co)
        shapes[f"params/{p}/bias"] = (co,)

    def bn(p, c):
        shapes[f"params/{p}/scale"] = (c,)
        shapes[f"params/{p}/bias"] = (c,)

    def block(p, ci, co, k):
        conv(f"{p}/Conv_0", ci, co, k)
        bn(f"{p}/BatchNorm_0", co)
        conv(f"{p}/Conv_1", co, co, k)
        bn(f"{p}/BatchNorm_1", co)
        mid = max(co // REDUCTION, 1)
        ca = f"{p}/CBAM_0/ChannelAttention_0"
        shapes[f"params/{ca}/Dense_0/kernel"] = (co, mid)
        shapes[f"params/{ca}/Dense_0/bias"] = (mid,)
        shapes[f"params/{ca}/Dense_1/kernel"] = (mid, co)
        shapes[f"params/{ca}/Dense_1/bias"] = (co,)
        conv(f"{p}/CBAM_0/SpatialAttention_0/Conv_0", 2, 1, SPATIAL_KERNEL)
        if ci != co:
            conv(f"{p}/Conv_2", ci, co, 1)

    ups = {name: (ci, skip) for name, ci, skip, _ in UPS}
    for p, ci, co, k in blocks():
        name = p.split("/")[0]
        if name in ups:
            ci_up = ups[name][0]
            conv(f"{name}/ConvTranspose_0", ci_up, ci_up // 2, 3)
        block(p, ci, co, k)
    for h, width in heads.items():
        conv(f"out_{h}/Conv_0", HEAD_FEATURES, HEAD_FEATURES, 3)
        bn(f"out_{h}/BatchNorm_0", HEAD_FEATURES)
        conv(f"out_{h}/Conv_1", HEAD_FEATURES, width, 1)
    return shapes


def bn_keys(heads: Dict[str, int] = HEADS):
    """The Flax paths of every BatchNorm, forward order."""
    for p, _, _, _ in blocks():
        yield f"{p}/BatchNorm_0"
        yield f"{p}/BatchNorm_1"
    for h in heads:
        yield f"out_{h}/BatchNorm_0"


def _conv(x, k, b):
    """SAME conv, stride 1, of NCHW x with an HWIO kernel."""
    return F.conv2d(x, k.permute(3, 2, 0, 1), b, padding=k.shape[0] // 2)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (saturating at its largest value)."""
    big = torch.finfo(torch.float8_e4m3fn).max
    return x.clamp(-big, big).to(torch.float8_e4m3fn).float()


class _Forward:
    """One forward's weights, control variant and calibration."""

    def __init__(self, w: Dict, variant: Optional[str], calibrate: bool):
        if variant not in (None, "no_max", "fp8"):
            raise ValueError(f"no control {variant!r}")
        self.w, self.variant, self.calibrate = w, variant, calibrate

    def round(self, x):
        return _fp8(x) if self.variant == "fp8" else x

    def bn(self, x, p):
        w = self.w
        if self.calibrate:
            w[f"batch_stats/{p}/mean"] = x.mean(dim=(0, 2, 3))
            w[f"batch_stats/{p}/var"] = x.var(dim=(0, 2, 3),
                                              unbiased=False)
        mean, var = w[f"batch_stats/{p}/mean"], w[f"batch_stats/{p}/var"]
        inv = torch.rsqrt(var + EPS) * w[f"params/{p}/scale"]
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + w[f"params/{p}/bias"][:, None, None]

    def conv(self, x, p):
        return _conv(x, self.w[f"params/{p}/kernel"],
                     self.w[f"params/{p}/bias"])

    def cbam(self, y, p):
        ca = f"params/{p}/CBAM_0/ChannelAttention_0"

        def mlp(v):
            h = F.relu(v @ self.w[f"{ca}/Dense_0/kernel"]
                       + self.w[f"{ca}/Dense_0/bias"])
            return h @ self.w[f"{ca}/Dense_1/kernel"] \
                + self.w[f"{ca}/Dense_1/bias"]

        logit = mlp(y.mean(dim=(2, 3)))
        if self.variant != "no_max":
            logit = logit + mlp(y.amax(dim=(2, 3)))
        y = self.round(torch.sigmoid(logit))[:, :, None, None] * y
        s = torch.cat([y.mean(dim=1, keepdim=True),
                       y.amax(dim=1, keepdim=True)], dim=1)
        gate = torch.sigmoid(self.conv(s, f"{p}/CBAM_0/SpatialAttention_0/"
                                          "Conv_0"))
        return self.round(gate) * y

    def block(self, name, x):
        p = prefix(name)
        y = F.relu(self.bn(self.conv(x, f"{p}/Conv_0"), f"{p}/BatchNorm_0"))
        y = self.bn(self.conv(y, f"{p}/Conv_1"), f"{p}/BatchNorm_1")
        res = self.conv(x, f"{p}/Conv_2") \
            if f"params/{p}/Conv_2/kernel" in self.w else x
        return self.round(F.relu(self.cbam(y, p) + res))

    def up(self, name, x, skip):
        t = _convt(x, self.w[f"params/{name}/ConvTranspose_0/kernel"],
                   self.w[f"params/{name}/ConvTranspose_0/bias"])
        return self.block(name, torch.cat([skip, _crop_to(t, skip)], dim=1))

    def trunk(self, x):
        x1 = self.block("inc2", self.block("inc1", x))
        x2 = self.block("down1", F.max_pool2d(x1, 2))
        x3 = self.block("inc3", self.block("down2", F.max_pool2d(x2, 2)))
        x4 = self.block("down3", F.max_pool2d(x3, 2))
        x5 = self.block("down4", F.max_pool2d(x4, 2))
        x6 = self.block("down5", F.max_pool2d(x5, 2))
        y = self.up("up1", x6, x5)
        y = self.up("up2", y, x4)
        y = self.up("up3", y, x3)
        return self.block("dconv2", self.block("dconv1", y))

    def head(self, name, y):
        p = f"out_{name}"
        z = F.leaky_relu(self.bn(self.conv(y, f"{p}/Conv_0"),
                                 f"{p}/BatchNorm_0"), 0.01)
        return self.conv(z, f"{p}/Conv_1")


@torch.no_grad()
def forward(w: Dict[str, torch.Tensor], ink: torch.Tensor,
            variant: Optional[str] = None, calibrate: bool = False,
            heads=HEADS) -> Dict[str, torch.Tensor]:
    """ink: (B, 1, H, W) float32 {0, 1} masks. Returns each head's NCHW
    float32 logits (`heads`: the eight by default) and the 128-channel
    features under "features"."""
    f = _Forward(w, variant, calibrate)
    with exact_f32():
        y = f.trunk(ink.float())
        out = {h: f.head(h, y) for h in heads}
    out["features"] = y
    return out
