"""Plain PyTorch reference of CenterNet's DLA-34 with deformable
up-convolutions under ABC-Net's eight heads (configuration
`dla34_dcn_bf16`; CenterNet's src/lib/models/networks/pose_dla_dcn.py,
`dla34` and `DLASeg` at down_ratio 4, head_conv 256, final_kernel 1; the
deformable conv of DCNv2's `DCN`).

  * the DLA-34 base: a 7x7 stride-1 conv to 16 (no bias) -> BatchNorm ->
    ReLU; level0 3x3 to 16; level1 3x3 stride 2 to 32; level2-5 trees of
    BasicBlocks (3x3 conv, BN, ReLU, 3x3 conv, BN, + residual, ReLU; the
    residual the level's 2x2 max-pooled input, through a 1x1 conv and BN
    where the width changes), a Root (1x1 conv over the concatenated
    children, plus the pooled input where `level_root`, BN, ReLU) closing
    each tree of one level;
  * DLAUp (ida_0, ida_1, ida_2) and the final IDAUp: proj (a deformable
    site), a depthwise transposed conv up by f (kernel 2f, stride f,
    padding f / 2), node (a deformable site) on the sum with the level
    above;
  * a deformable site, DCNv2 from its equations: om = conv3x3(x) + b to
    27 channels; for tap k = 3i + j the sample point of output (h, w) is
    y = h - 1 + i + om[2k], x = w - 1 + j + om[2k + 1]; the bilinear
    sample is 0 unless -1 < y < H and -1 < x < W, and a corner off the map
    counts 0; it is weighted by sigmoid(om[18 + k]); the output is the
    bias plus the sum over taps of the tap's kernel slice applied to its
    samples; then BN and ReLU;
  * the heads: 3x3 conv 64 -> 256 with bias, ReLU, 1x1 conv 256 -> width.

Departures from the source (the configuration's `changed`): the input is
the binarized mask (B, 1, H, W); the heads are ABC-Net's eight, as a dict
of NCHW float32 logits with the 64-channel features beside them; the
outer trees of level3 and level4 compute no `project`, which the source
computes and never uses.

Eval mode: BatchNorm uses the running statistics. Everything in float32
with TF32 off. Weights come straight from a snapshot .npz of flattened
Flax-style variables (`params/<path>/Conv_i/kernel` HWIO, `.../bias`,
`.../BatchNorm_i/scale, bias`, `batch_stats/.../mean, var`; a depthwise
up's kernel `params/<ida>/up<i>/kernel` (2f, 2f, 1, o)).

Three controls for the comparison's limits, `variant`:
  * "no_offset": every offset forced to 0 (the masks kept);
  * "no_mask": the modulation dropped, every mask 1 (DCNv1);
  * "fp8": each site's modulated samples and the carry between
    aggregation stages rounded to float8 e4m3: each output of the base's
    conv levels, blocks and roots (DLA's hierarchical aggregation) and of
    each IDA node (its iterative aggregation).

`calibrate` takes a BatchNorm's statistics from the batch in front of it
(biased variance) and writes them into the weights as it goes
(benchmark/dla_weights.py).

Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .unet import EPS, HEADS, exact_f32, load_snapshot  # noqa: F401
from .unet_cbam import _fp8

LEVELS = (1, 1, 1, 2, 2, 1)
CHANNELS = (16, 32, 64, 128, 256, 512)
FIRST_LEVEL, LAST_LEVEL = 2, 5
HEAD_CONV = 256
# (level, tree levels, in, out, level_root) of the base's trees
TREES = (("level2", 1, 32, 64, False), ("level3", 2, 64, 128, True),
         ("level4", 2, 128, 256, True), ("level5", 1, 256, 512, True))
VARIANTS = (None, "no_offset", "no_mask", "fp8")


def ida_layout():
    """[(Flax path of the IDAUp, o, in channels, up factors)]: DLAUp's
    ida_0 .. ida_2, then the final ida_up, as DLASeg builds them."""
    out = []
    channels = list(CHANNELS[FIRST_LEVEL:])
    in_ch = list(channels)
    scales = [2 ** i for i in range(len(channels))]
    for i in range(len(channels) - 1):
        j = len(channels) - 2 - i
        out.append((f"dla_up/ida_{i}", channels[j], in_ch[j:],
                    [s // scales[j] for s in scales[j:]]))
        scales[j + 1:] = [scales[j]] * (len(scales) - j - 1)
        in_ch[j + 1:] = [channels[j]] * (len(in_ch) - j - 1)
    n = LAST_LEVEL - FIRST_LEVEL
    out.append(("ida_up", channels[0], channels[:n],
                [2 ** i for i in range(n)]))
    return out


def param_shapes(heads: Dict[str, int] = HEADS) -> Dict[str, tuple]:
    """{Flax key: shape} of every parameter, in the order the model holds
    them (the base, DLAUp, the final IDAUp, the heads)."""
    shapes: Dict[str, tuple] = {}

    def conv(p, ci, co, k, bias=True):
        shapes[f"params/{p}/kernel"] = (k, k, ci, co)
        if bias:
            shapes[f"params/{p}/bias"] = (co,)

    def bn(p, c):
        shapes[f"params/{p}/scale"] = (c,)
        shapes[f"params/{p}/bias"] = (c,)

    def conv_bn(p, ci, co, k):
        conv(f"{p}/Conv_0", ci, co, k, bias=False)
        bn(f"{p}/BatchNorm_0", co)

    def block(p, ci, co):
        conv(f"{p}/Conv_0", ci, co, 3, bias=False)
        bn(f"{p}/BatchNorm_0", co)
        conv(f"{p}/Conv_1", co, co, 3, bias=False)
        bn(f"{p}/BatchNorm_1", co)

    def tree(p, levels, ci, co, level_root, root_dim=0):
        root_dim = root_dim or 2 * co
        if level_root:
            root_dim += ci
        if levels == 1:
            block(f"{p}/tree1", ci, co)
            block(f"{p}/tree2", co, co)
            conv_bn(f"{p}/root", root_dim, co, 1)
        else:
            tree(f"{p}/tree1", levels - 1, ci, co, False)
            tree(f"{p}/tree2", levels - 1, co, co, False, root_dim + co)
        if ci != co:
            conv_bn(f"{p}/project", ci, co, 1)

    def dcn(p, ci, co):
        conv(f"{p}/Conv_0", ci, co, 3)
        conv(f"{p}/Conv_1", ci, 27, 3)
        bn(f"{p}/BatchNorm_0", co)

    conv_bn("base/base_layer", 1, CHANNELS[0], 7)
    conv_bn("base/level0", CHANNELS[0], CHANNELS[0], 3)
    conv_bn("base/level1", CHANNELS[0], CHANNELS[1], 3)
    for name, levels, ci, co, level_root in TREES:
        tree(f"base/{name}", levels, ci, co, level_root)
    for p, o, chans, ups in ida_layout():
        for i in range(1, len(chans)):
            dcn(f"{p}/proj{i}", chans[i], o)
            shapes[f"params/{p}/up{i}/kernel"] = (2 * ups[i], 2 * ups[i], 1,
                                                   o)
            dcn(f"{p}/node{i}", o, o)
    for h, width in heads.items():
        conv(f"out_{h}/Conv_0", CHANNELS[FIRST_LEVEL], HEAD_CONV, 3)
        conv(f"out_{h}/Conv_1", HEAD_CONV, width, 1)
    return shapes


def bilinear_up(k: int) -> torch.Tensor:
    """fill_up_weights' (k, k) bilinear kernel of a 2f-wide up."""
    f = (k + 1) // 2
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    t = 1 - (torch.arange(k, dtype=torch.float64) / f - c).abs()
    return (t[:, None] * t[None, :]).float()


class _Forward:
    """One forward's weights, control variant and calibration."""

    def __init__(self, w: Dict, variant: Optional[str], calibrate: bool):
        if variant not in VARIANTS:
            raise ValueError(f"no control {variant!r}")
        self.w, self.variant, self.calibrate = w, variant, calibrate

    def round(self, x):
        return _fp8(x) if self.variant == "fp8" else x

    def conv(self, x, p, stride=1):
        k = self.w[f"params/{p}/kernel"]
        return F.conv2d(x, k.permute(3, 2, 0, 1),
                        self.w.get(f"params/{p}/bias"), stride=stride,
                        padding=k.shape[0] // 2)

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

    def conv_bn(self, x, p, stride=1):
        return self.bn(self.conv(x, f"{p}/Conv_0", stride),
                       f"{p}/BatchNorm_0")

    # -- the base ----------------------------------------------------------

    def block(self, p, x, residual, stride):
        y = F.relu(self.conv_bn(x, p, stride))
        y = self.bn(self.conv(y, f"{p}/Conv_1"), f"{p}/BatchNorm_1")
        return self.round(F.relu(y + residual))

    def tree(self, p, x, levels, ci, co, stride, level_root, children=None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, stride) if stride > 1 else x
        if level_root:
            children.append(bottom)
        if levels == 1:
            residual = self.conv_bn(bottom, f"{p}/project") if ci != co \
                else bottom
            x1 = self.block(f"{p}/tree1", x, residual, stride)
            x2 = self.block(f"{p}/tree2", x1, x1, 1)
            return self.round(F.relu(self.conv_bn(
                torch.cat([x2, x1, *children], 1), f"{p}/root")))
        x1 = self.tree(f"{p}/tree1", x, levels - 1, ci, co, stride, False)
        children.append(x1)
        return self.tree(f"{p}/tree2", x1, levels - 1, co, co, 1, False,
                         children)

    def base(self, x):
        x = self.round(F.relu(self.conv_bn(x, "base/base_layer")))
        y = [self.round(F.relu(self.conv_bn(x, "base/level0")))]
        y.append(self.round(F.relu(self.conv_bn(y[-1], "base/level1", 2))))
        for name, levels, ci, co, level_root in TREES:
            y.append(self.tree(f"base/{name}", y[-1], levels, ci, co, 2,
                               level_root))
        return y

    # -- the deformable site -----------------------------------------------

    def sample(self, x, py, px):
        """Bilinear samples of NCHW x at float positions py, px (N, H, W):
        (N, C, H, W)."""
        n, c, h, w = x.shape
        flat = x.reshape(n, c, h * w)
        inside = (py > -1) & (py < h) & (px > -1) & (px < w)
        y0, x0 = torch.floor(py), torch.floor(px)
        fy, fx = py - y0, px - x0
        acc = torch.zeros_like(x)
        for oy, wy in ((0, 1 - fy), (1, fy)):
            for ox, wx in ((0, 1 - fx), (1, fx)):
                yy, xx = y0 + oy, x0 + ox
                ok = inside & (yy >= 0) & (yy <= h - 1) & (xx >= 0) & \
                    (xx <= w - 1)
                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
                v = torch.gather(flat, 2, idx.reshape(n, 1, -1).expand(
                    n, c, h * w)).reshape(n, c, h, w)
                acc = acc + v * (wy * wx * ok)[:, None]
        return acc

    def dcn(self, p, x):
        """A deformable site: DCN 3x3 with bias -> BN -> ReLU."""
        n, c, h, w = x.shape
        om = self.conv(x, f"{p}/Conv_1")
        if self.variant == "no_offset":
            om = torch.cat([torch.zeros_like(om[:, :18]), om[:, 18:]], 1)
        mask = torch.ones_like(om[:, 18:]) if self.variant == "no_mask" \
            else torch.sigmoid(om[:, 18:])
        kernel = self.w[f"params/{p}/Conv_0/kernel"]          # (3, 3, C, O)
        out = self.w[f"params/{p}/Conv_0/bias"][None, :, None, None]
        gy = torch.arange(h, device=x.device, dtype=x.dtype)[:, None]
        gx = torch.arange(w, device=x.device, dtype=x.dtype)[None, :]
        for i in range(3):
            for j in range(3):
                k = 3 * i + j
                s = self.sample(x, gy + (i - 1) + om[:, 2 * k],
                                gx + (j - 1) + om[:, 2 * k + 1])
                s = self.round(s * mask[:, k:k + 1])
                out = out + torch.einsum("nchw,co->nohw", s, kernel[i, j])
        return F.relu(self.bn(out, f"{p}/BatchNorm_0"))

    # -- the aggregation ---------------------------------------------------

    def ida(self, p, ups, layers, startp, endp):
        for i in range(startp + 1, endp):
            k = i - startp
            f = ups[k]
            y = self.dcn(f"{p}/proj{k}", layers[i])
            up = self.w[f"params/{p}/up{k}/kernel"].permute(3, 2, 0, 1)
            y = F.conv_transpose2d(y, up, stride=f, padding=f // 2,
                                   groups=up.shape[0])
            layers[i] = self.round(self.dcn(f"{p}/node{k}",
                                            y + layers[i - 1]))

    def trunk(self, x):
        layers = self.base(x)
        idas = ida_layout()
        out = [layers[-1]]
        for i, (p, _, _, ups) in enumerate(idas[:-1]):
            self.ida(p, ups, layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        y = out[:LAST_LEVEL - FIRST_LEVEL]
        p, _, _, ups = idas[-1]
        self.ida(p, ups, y, 0, len(y))
        return y[-1]

    def head(self, name, y):
        p = f"out_{name}"
        return self.conv(F.relu(self.conv(y, f"{p}/Conv_0")),
                         f"{p}/Conv_1")


@torch.no_grad()
def forward(w: Dict[str, torch.Tensor], ink: torch.Tensor,
            variant: Optional[str] = None, calibrate: bool = False,
            heads=HEADS) -> Dict[str, torch.Tensor]:
    """ink: (B, 1, H, W) float32 {0, 1} masks. Returns each head's NCHW
    float32 logits (`heads`: the eight by default) and the 64-channel
    features under "features"."""
    f = _Forward(w, variant, calibrate)
    with exact_f32():
        y = f.trunk(ink.float())
        out = {h: f.head(h, y) for h in heads}
    out["features"] = y
    return out


@torch.no_grad()
def offsets(w: Dict[str, torch.Tensor], ink: torch.Tensor):
    """{site path: (N, 18, H, W) float32 offsets} of every deformable site
    over a forward of `ink` (the readings' spread of the sampling)."""
    got = {}
    f = _Forward(w, None, False)
    dcn = f.dcn

    def recording(p, x):
        got[p] = f.conv(x, f"{p}/Conv_1")[:, :18]
        return dcn(p, x)

    f.dcn = recording
    with exact_f32():
        f.trunk(ink.float())
    return got
