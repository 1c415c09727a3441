"""Post-training int8 quantization of the serving backbone.

Counterpart of abcnet_tpu/infer/quant.py, with its functions and its
bundle layout (HWIO kernels, per-output-channel weight scales, one
activation scale per conv site), so one bundle runs through both:

  1. `fold_eval_params`  eval-mode BatchNorm folded into the conv
     weights and biases: a flat layer table of the production topology;
  2. `forward_folded`    float forward over the folded table with the
     sparse-serving contract ({head: logits}, trunk features), and the
     calibration recorder (per-site |activation| maxima);
  3. `quantize_folded`   int8 weights and activation scales;
  4. `forward_quant`     int8 forward: each conv quantizes its input at
     the site's scale, multiplies s8 x s8 with exact s32 accumulation,
     and dequantizes into the bf16 carry; pooling, crop and concat stay
     in the carry; the heads' 1x1 convs stay float.

Each of the 28 3x3 sites (the 26 of the trunk, the two heads' 3x3) is
one launch of the hand-written kernel `ops/conv_s8.py:conv3x3_s8` on a
CUDA tensor: quantize while staging the input tile, s8 x s8 -> s32 on
the int8 tensor cores, dequantize, bias, activation and cast in the
epilogue. It reads the weights in `pack_weights`' layout, which
`pack_bundle(q)` makes once a bundle (make_infer_pipeline does it when
it is given a bundle). On the CPU, or with `rec` given (the tests' hook,
which needs each site's int8 input and int32 accumulators), a site runs
`conv3x3_s8_plain`, the chain the kernel replaced: `q8`, then im2col and
`torch._int_mm` (`conv_int8`, exact: K = 9·C_in reaches 4,608 products
of up to 127² each, past what an f32 sum holds, so no float convolution
of int8 values would do), then `acc.float() * coef + b`, the activation
and the cast. A 3x3 transposed conv (stride 2) stays a library GEMM
x·W to (..., 9·C_out) followed by an int32 scatter-add of the nine taps
(`convt_int8`). cuBLASLt's int8 GEMM wants M > 16 and K, N multiples of
8; `int_mm` pads the operands to that.

`make_infer_pipeline(model, quant=prepare_quant(model, images))`
(infer/decode.py) swaps this backbone into the sparse serving path; peak
extraction and the sparse wide heads are unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.unet import _crop_or_pad_to
# conv_int8 is re-exported beside this module's other exact convs
from ..ops.conv_s8 import (conv3x3_s8, conv3x3_s8_plain,  # noqa: F401
                           conv_int8, int_mm, pack_weights, q8)

_EPS = 1e-5
_DC_BLOCKS = ("inc1", "inc2", "down1", "down2", "inc3", "down3",
              "down4", "down5", "dconv1", "dconv2")
_UPS = ("up1", "up2", "up3")


def _t(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


def _fold(conv: Dict, bn: Dict, st: Dict) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    f = _t(bn["scale"]) * torch.rsqrt(_t(st["var"]) + _EPS)
    k = _t(conv["kernel"]) * f
    b = (_t(conv["bias"]) - _t(st["mean"])) * f + _t(bn["bias"])
    return k, b


def fold_eval_params(variables: Dict,
                     dense_heads: Sequence[str] = ("atom_target",
                                                   "bond_target")) -> Dict:
    """The production UNet's {"params", "batch_stats"} trees (numpy
    leaves, the layout of models/weights.to_flax) -> folded (kernel HWIO,
    bias) pairs as f32 CPU tensors."""
    p, s = variables["params"], variables["batch_stats"]

    def dc(pp, ss):
        return [_fold(pp[f"Conv_{i}"], pp[f"BatchNorm_{i}"],
                      ss[f"BatchNorm_{i}"]) for i in (0, 1)]

    table: Dict = {}
    for name in _DC_BLOCKS:
        if name.startswith("down"):
            table[name] = dc(p[name]["DoubleConv_0"],
                             s[name]["DoubleConv_0"])
        else:
            table[name] = dc(p[name], s[name])
    for name in _UPS:
        table[name] = {
            "t": (_t(p[name]["ConvTranspose_0"]["kernel"]),
                  _t(p[name]["ConvTranspose_0"]["bias"])),
            "dc": dc(p[name]["DoubleConv_0"], s[name]["DoubleConv_0"]),
        }
    table["heads"] = {}
    for h in dense_heads:
        hp, hs = p[f"out_{h}"], s[f"out_{h}"]
        table["heads"][h] = {
            "c3": _fold(hp["Conv_0"], hp["BatchNorm_0"], hs["BatchNorm_0"]),
            "c1": (_t(hp["Conv_1"]["kernel"]), _t(hp["Conv_1"]["bias"])),
        }
    return table


def to_device(tree, device):
    """A folded table or a quantized bundle with its tensors on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# Float convs on NHWC tensors with HWIO kernels (the JAX layout)
# ---------------------------------------------------------------------------

def _conv_f(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """SAME conv, stride 1, in f32: NHWC x, HWIO k."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                 padding=k.shape[0] // 2)
    return y.permute(0, 2, 3, 1) + b


def _convt_f(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """VALID transposed conv, stride 2, in f32, Flax's (unflipped) HWIO
    kernel: the (2H+1, 2W+1) output."""
    w = torch.flip(k, (0, 1)).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2), w, stride=2)
    return y.permute(0, 2, 3, 1) + b


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _crop(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """NHWC crop/pad of x to the skip's spatial size."""
    return _crop_or_pad_to(x.permute(0, 3, 1, 2), skip.shape[1],
                           skip.shape[2]).permute(0, 2, 3, 1)


class _Rec:
    """Per-site |x| maxima across calibration batches."""

    def __init__(self):
        self.amax: Dict[str, float] = {}

    def see(self, site: str, x: torch.Tensor) -> None:
        v = float(x.abs().max())
        self.amax[site] = max(self.amax.get(site, 0.0), v)


@torch.no_grad()
def forward_folded(table: Dict, images: torch.Tensor,
                   rec: Optional[_Rec] = None):
    """Float forward over the folded table. images: NHWC (B, H, W, 1) f32.
    Returns ({head: logits}, features), the sparse-serving contract."""
    see = rec.see if rec is not None else (lambda *_: None)

    def dcf(name, x):
        layers = table[name] if isinstance(table[name], list) \
            else table[name]["dc"]
        for i, (k, b) in enumerate(layers):
            see(f"{name}.{i}", x)
            x = F.relu(_conv_f(x, k, b))
        return x

    see("in", images)
    x1 = dcf("inc2", dcf("inc1", images))
    x2 = dcf("down1", _pool(x1))
    x3 = dcf("inc3", dcf("down2", _pool(x2)))
    x4 = dcf("down3", _pool(x3))
    x5 = dcf("down4", _pool(x4))
    x6 = dcf("down5", _pool(x5))

    def up(name, x, skip):
        kt, bt = table[name]["t"]
        see(f"{name}.t", x)
        x = _crop(_convt_f(x, kt, bt), skip)
        return dcf(name, torch.cat([skip, x], dim=-1))

    y = up("up1", x6, x5)
    y = up("up2", y, x4)
    y = up("up3", y, x3)
    y = dcf("dconv2", dcf("dconv1", y))
    see("y", y)

    out = {}
    for h, hp in table["heads"].items():
        k3, b3 = hp["c3"]
        z = F.leaky_relu(_conv_f(y, k3, b3), 0.01)
        k1, b1 = hp["c1"]
        out[h] = _conv_f(z, k1, b1)
    return out, y


def calibrate(table: Dict, images, batch: int = 8) -> Dict[str, float]:
    """Per-site activation maxima over calibration images (B, H, W, 1),
    numpy or a tensor."""
    rec = _Rec()
    device = table["inc1"][0][0].device
    for i in range(0, len(images), batch):
        chunk = images[i:i + batch]
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.from_numpy(np.asarray(chunk, np.float32))
        forward_folded(table, chunk.float().to(device), rec)
    return rec.amax


def quantize_folded(table: Dict, amax: Dict[str, float]) -> Dict:
    """int8 weights (per-output-channel scales) + per-site act scales."""
    def qw(k):
        sw = torch.clamp(k.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
        kq = torch.clamp(torch.round(k / sw), -127, 127).to(torch.int8)
        return kq, sw

    q: Dict = {"scales": {k: max(v, 1e-12) / 127.0
                          for k, v in amax.items()}}
    # The input is a {0,1} ink mask: its scale is exact, not calibrated.
    q["scales"]["in"] = 1.0 / 127.0
    for name in _DC_BLOCKS:
        q[name] = [qw(k) + (b,) for k, b in table[name]]
    for name in _UPS:
        kt, bt = table[name]["t"]
        q[name] = {"t": qw(kt) + (bt,),
                   "dc": [qw(k) + (b,) for k, b in table[name]["dc"]]}
    q["heads"] = {h: {"c3": qw(hp["c3"][0]) + (hp["c3"][1],),
                      "c1": hp["c1"]}
                  for h, hp in table["heads"].items()}
    return q


# ---------------------------------------------------------------------------
# Exact int8 convolutions
# ---------------------------------------------------------------------------

def convt_int8(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """VALID transposed conv, stride 2, of NHWC int8 x with Flax's
    (unflipped) HWIO int8 kernel (3, 3, C, O): the exact int32
    accumulators (B, 2H+1, 2W+1, O). Input cell (i, j) adds
    x·k[2-di, 2-dj] to output cell (2i+di, 2j+dj): one GEMM to the nine
    taps, then nine strided int32 adds."""
    b, h, w, c = xq.shape
    kh, kw, _, o = kq.shape
    wmat = torch.flip(kq, (0, 1)).permute(2, 0, 1, 3).reshape(c, kh * kw * o)
    taps = int_mm(xq.reshape(b * h * w, c), wmat).reshape(b, h, w, kh, kw,
                                                          o)
    out = torch.zeros(b, 2 * h + kh - 2, 2 * w + kw - 2, o,
                      dtype=torch.int32, device=xq.device)
    for di in range(kh):
        for dj in range(kw):
            out[:, di:di + 2 * h:2, dj:dj + 2 * w:2] += taps[:, :, :, di, dj]
    return out


def conv_sites(q: Dict):
    """(key, scale site, layer) of the bundle's 28 3x3 conv sites in
    forward order: the trunk's "<block>.<i>", then each head's 3x3 under
    "y:<head>" (the heads share the scale site "y")."""
    for name in _DC_BLOCKS[:8] + _UPS + _DC_BLOCKS[8:]:
        layers = q[name] if isinstance(q[name], list) else q[name]["dc"]
        for i, layer in enumerate(layers):
            yield f"{name}.{i}", f"{name}.{i}", layer
    for h, hp in q["heads"].items():
        yield f"y:{h}", "y", hp["c3"]


def pack_bundle(q: Dict) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{key of conv_sites: (pack_weights(kq), coef)} on the bundle's
    device, coef = scales[site] * sw, the f32 vector the kernel and the
    plain chain both read. Made once a bundle."""
    return {key: (pack_weights(layer[0]), q["scales"][site] * layer[1])
            for key, site, layer in conv_sites(q)}


@torch.no_grad()
def forward_quant(q: Dict, images: torch.Tensor,
                  carry: torch.dtype = torch.bfloat16,
                  rec: Optional[Dict] = None,
                  packed: Optional[Dict] = None):
    """int8 forward with the (heads, features) sparse-serving contract.
    images: NHWC (B, H, W, 1). On a CUDA tensor with `rec` None each 3x3
    site is one `conv3x3_s8` launch over `packed` (`pack_bundle(q)`,
    made here when None); otherwise it runs `conv3x3_s8_plain`. `rec`,
    if given, receives each conv site's int8 input and int32 accumulators
    (for tests; a head's 3x3 under "y:<head>")."""
    scales = q["scales"]
    kernel = rec is None and images.device.type == "cuda"
    if kernel and packed is None:
        packed = pack_bundle(q)

    def conv_q(x, layer, site, act, out, key=None):
        kq, sw, b = layer
        key = key or site
        if kernel:
            w, coef = packed[key]
            return conv3x3_s8(x.contiguous(), w, scales[site], coef, b, act,
                              out)

        def see(xq, y):
            rec[key] = (xq, y)
        return conv3x3_s8_plain(x, kq, scales[site], scales[site] * sw, b,
                                act, out, see if rec is not None else None)

    def convt_q(x, layer, site):
        kq, sw, b = layer
        xq = q8(x, scales[site])
        y = convt_int8(xq, kq)
        if rec is not None:
            rec[site] = (xq, y)
        return (y.float() * (scales[site] * sw) + b).to(carry)

    def dcq(name, x):
        layers = q[name] if isinstance(q[name], list) else q[name]["dc"]
        for i, layer in enumerate(layers):
            x = conv_q(x, layer, f"{name}.{i}", "relu", carry)
        return x

    x1 = dcq("inc2", dcq("inc1", images.to(carry)))
    x2 = dcq("down1", _pool(x1))
    x3 = dcq("inc3", dcq("down2", _pool(x2)))
    x4 = dcq("down3", _pool(x3))
    x5 = dcq("down4", _pool(x4))
    x6 = dcq("down5", _pool(x5))

    def up(name, x, skip):
        x = _crop(convt_q(x, q[name]["t"], f"{name}.t"), skip)
        return dcq(name, torch.cat([skip, x], dim=-1))

    y = up("up1", x6, x5)
    y = up("up2", y, x4)
    y = up("up3", y, x3)
    y = dcq("dconv2", dcq("dconv1", y))

    out = {}
    for h, hp in q["heads"].items():
        z = conv_q(y, hp["c3"], "y", "leaky_relu", torch.float32, f"y:{h}")
        k1, b1 = hp["c1"]
        out[h] = _conv_f(z, k1, b1)
    return out, y


def prepare_quant(model: torch.nn.Module, calib_images,
                  dense_heads: Sequence[str] = ("atom_target",
                                                "bond_target")) -> Dict:
    """One-call PTQ of a production UNet: fold -> calibrate -> quantize,
    on the model's device. calib_images: (N, H, W, 1) {0, 1} masks. Any
    other model (UNetCBAM, UNetS2D, a fused head bank) raises ValueError
    naming it: the fold reads the production topology."""
    from ..models.unet import UNet
    from ..models.weights import to_flax

    fused = getattr(model, "fused_head_bank", False)
    if type(model) is not UNet or fused:
        raise ValueError(f"the int8 backbone serves the production UNet "
                         f"only, not {type(model).__name__}"
                         f"{' with a fused head bank' if fused else ''}: "
                         f"serve this model in bf16 or float32")

    params, stats = to_flax(model.state_dict())
    device = next(model.parameters()).device
    table = to_device(fold_eval_params({"params": params,
                                        "batch_stats": stats},
                                       dense_heads), device)
    return quantize_folded(table, calibrate(table, calib_images))
