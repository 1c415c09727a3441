"""Plain PyTorch reference of the production multi-head U-Net.

The ABC-Net architecture (src/unet.py of the reference) as the
configuration file states it: a 16-channel stem DoubleConv pair, the
encoder 16-32-64(-inc3)-128-256-512 through 2x2 max pools, the decoder of
k3 s2 transposed convs with an asymmetric crop to the skip and a concat,
two trailing DoubleConvs at 128 channels, and one OutConv a head (3x3
conv, BatchNorm, LeakyReLU 0.01, 1x1 conv) at stride 4. Eval mode:
BatchNorm uses the running statistics; dropout is the identity.

Weights come straight from a snapshot .npz of flattened Flax variables
(`params/<block>/.../Conv_i/kernel` HWIO, `batch_stats/.../mean, var`).
Two forwards read them:

  * `forward_f32`: every conv and BatchNorm in float32 with TF32 off;
  * `forward_int8`: the post-training int8 backbone of the configuration
    `unet_int8` (BatchNorm folded into the conv, per-output-channel
    weight scales, one activation scale a conv site from calibration
    maxima, exact integer accumulation, a bf16 carry between layers, the
    heads' 1x1 in float32), at `bits` bits: 8 for the reference, 4 for
    the lower-precision control.

Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
STEM = ("inc1", "inc2", "down1", "down2", "inc3")
ENCODER = ("down3", "down4", "down5")
UPS = ("up1", "up2", "up3")
TAIL = ("dconv1", "dconv2")
HEADS = {"atom_target": 1, "atom_type": 14, "atom_charge": 3, "atom_hs": 2,
         "bond_target": 1, "bond_type": 360, "bond_rho": 60,
         "bond_omega": 60}
HEATMAPS = ("atom_target", "bond_target")


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def load_snapshot(path: str, device) -> Dict[str, torch.Tensor]:
    """Every array of the snapshot as a float32 tensor on `device`, keyed
    by its flattened Flax path."""
    z = np.load(path)
    return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
            for k in z.files if k != "__step__"}


def _dc_prefix(name: str) -> str:
    return f"{name}/DoubleConv_0" if name.startswith(("down", "up")) \
        else name


def _conv_bn(w: Dict, p: str, i: int):
    """(HWIO kernel, bias, scale, shift, mean, var) of conv i of `p`."""
    return (w[f"params/{p}/Conv_{i}/kernel"], w[f"params/{p}/Conv_{i}/bias"],
            w[f"params/{p}/BatchNorm_{i}/scale"],
            w[f"params/{p}/BatchNorm_{i}/bias"],
            w[f"batch_stats/{p}/BatchNorm_{i}/mean"],
            w[f"batch_stats/{p}/BatchNorm_{i}/var"])


def _conv(x, k, b):
    """SAME conv, stride 1, of NCHW x with an HWIO kernel."""
    return F.conv2d(x, k.permute(3, 2, 0, 1), b, padding=k.shape[0] // 2)


def _convt(x, k, b):
    """VALID transposed conv, stride 2, with Flax's unflipped HWIO
    kernel: the (2H+1, 2W+1) output."""
    return F.conv_transpose2d(x, torch.flip(k, (0, 1)).permute(2, 3, 0, 1),
                              b, stride=2)


def _bn(x, scale, shift, mean, var):
    inv = torch.rsqrt(var + EPS) * scale
    return (x - mean[:, None, None]) * inv[:, None, None] \
        + shift[:, None, None]


def _crop_to(x, skip):
    """The reference's asymmetric pad (d//2, d - d//2); negative crops."""
    dh = skip.shape[2] - x.shape[2]
    dw = skip.shape[3] - x.shape[3]
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


def _trunk(x, dc, up):
    """The U-Net's topology over a DoubleConv `dc(name, x)` and an
    upsampling `up(name, x, skip)`; returns the 128-channel features."""
    x1 = dc("inc2", dc("inc1", x))
    x2 = dc("down1", F.max_pool2d(x1, 2))
    x3 = dc("inc3", dc("down2", F.max_pool2d(x2, 2)))
    x4 = dc("down3", F.max_pool2d(x3, 2))
    x5 = dc("down4", F.max_pool2d(x4, 2))
    x6 = dc("down5", F.max_pool2d(x5, 2))
    y = dc("up1", up("up1", x6, x5))
    y = dc("up2", up("up2", y, x4))
    y = dc("up3", up("up3", y, x3))
    return dc("dconv2", dc("dconv1", y))


def head_f32(w: Dict, name: str, y: torch.Tensor) -> torch.Tensor:
    """One OutConv in float32 on NCHW features: (B, width, G, G)."""
    k, b, sc, sh, mu, var = _conv_bn(w, f"out_{name}", 0)
    z = F.leaky_relu(_bn(_conv(y, k, b), sc, sh, mu, var), 0.01)
    return _conv(z, w[f"params/out_{name}/Conv_1/kernel"],
                 w[f"params/out_{name}/Conv_1/bias"])


@torch.no_grad()
def forward_f32(w: Dict, ink: torch.Tensor) -> Dict[str, torch.Tensor]:
    """ink: (B, 1, H, W) float32 {0, 1} masks. Returns every head's NCHW
    float32 logits and the features under "features"."""
    with exact_f32():
        def dc(name, x):
            for i in (0, 1):
                k, b, sc, sh, mu, var = _conv_bn(w, _dc_prefix(name), i)
                x = F.relu(_bn(_conv(x, k, b), sc, sh, mu, var))
            return x

        def up(name, x, skip):
            t = _convt(x, w[f"params/{name}/ConvTranspose_0/kernel"],
                       w[f"params/{name}/ConvTranspose_0/bias"])
            return torch.cat([skip, _crop_to(t, skip)], dim=1)

        y = _trunk(ink.float(), dc, up)
        out = {h: head_f32(w, h, y) for h in HEADS}
    out["features"] = y
    return out


# ---------------------------------------------------------------------------
# The int8 backbone
# ---------------------------------------------------------------------------

def _fold(w: Dict, p: str, i: int):
    """BatchNorm folded into conv i of `p`: (HWIO kernel, bias)."""
    k, b, sc, sh, mu, var = _conv_bn(w, p, i)
    f = sc * torch.rsqrt(var + EPS)
    return k * f, (b - mu) * f + sh


def fold(w: Dict) -> Dict:
    """{site: (kernel, bias)} of every conv the int8 backbone quantizes:
    "<block>.<i>" (the trunk's 3x3), "<up>.t" (the transposed convs),
    "y:<heatmap head>" (the heatmap heads' 3x3), float32."""
    sites = {}
    for name in STEM + ENCODER + UPS + TAIL:
        for i in (0, 1):
            sites[f"{name}.{i}"] = _fold(w, _dc_prefix(name), i)
    for name in UPS:
        sites[f"{name}.t"] = (w[f"params/{name}/ConvTranspose_0/kernel"],
                              w[f"params/{name}/ConvTranspose_0/bias"])
    for h in HEATMAPS:
        sites[f"y:{h}"] = _fold(w, f"out_{h}", 0)
    return sites


def _folded_forward(sites: Dict, ink: torch.Tensor, see):
    """float32 forward over the folded convs, `see(site, input)` at every
    activation scale site ("in", "<block>.<i>", "<up>.t", "y")."""
    def dc(name, x):
        for i in (0, 1):
            see(f"{name}.{i}", x)
            x = F.relu(_conv(x, *sites[f"{name}.{i}"]))
        return x

    def up(name, x, skip):
        see(f"{name}.t", x)
        return torch.cat([skip, _crop_to(_convt(x, *sites[f"{name}.t"]),
                                         skip)], dim=1)

    see("in", ink)
    y = _trunk(ink, dc, up)
    see("y", y)


@torch.no_grad()
def calibrate(sites: Dict, ink: torch.Tensor, chunk: int = 8) -> Dict:
    """Per-site max |activation| over the calibration masks (B, 1, H, W),
    in float32 with TF32 off."""
    amax: Dict[str, float] = {}

    def see(site, x):
        amax[site] = max(amax.get(site, 0.0), float(x.abs().max()))

    with exact_f32():
        for i in range(0, ink.shape[0], chunk):
            _folded_forward(sites, ink[i:i + chunk].float(), see)
    return amax


def quantize(sites: Dict, amax: Dict, bits: int = 8) -> Dict:
    """Weights per output channel and activations per site at `bits`
    bits, symmetric: q = clip(round(v / s), -Q, Q), Q = 2^(bits-1) - 1,
    s = max|v| / Q; the {0, 1} input's scale is 1/Q, exact."""
    qmax = float(2 ** (bits - 1) - 1)
    q = {"qmax": qmax,
         "scales": {k: max(v, 1e-12) / qmax for k, v in amax.items()}}
    q["scales"]["in"] = 1.0 / qmax
    for site, (k, b) in sites.items():
        sw = torch.clamp(k.abs().amax(dim=(0, 1, 2)), min=1e-12) / qmax
        q[site] = (torch.clamp(torch.round(k / sw), -qmax, qmax), sw, b)
    return q


def _quant_act(x: torch.Tensor, s: float, qmax: float) -> torch.Tensor:
    """The integer values of x at scale s, as float64."""
    return torch.clamp(torch.round(x.float() / s), -qmax, qmax).double()


@torch.no_grad()
def forward_int8(w: Dict, q: Dict, ink: torch.Tensor,
                 carry: torch.dtype = torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """The quantized backbone on (B, 1, H, W) masks: each conv quantizes
    its input at its site's scale, accumulates the integer products
    exactly (float64 holds every sum), dequantizes (acc * s * sw + b),
    applies its activation and casts to the carry. The heatmap heads' 3x3
    output stays float32 into their float32 1x1. Returns the two heatmap
    logits and the carry features, NCHW."""
    qmax, scales = q["qmax"], q["scales"]

    def site(name, x, scale_site, act, out, transpose=False):
        kq, sw, b = q[name]
        s = scales[scale_site]
        xq = _quant_act(x, s, qmax)
        if transpose:
            acc = F.conv_transpose2d(
                xq, torch.flip(kq, (0, 1)).permute(2, 3, 0, 1).double(),
                stride=2)
        else:
            acc = F.conv2d(xq, kq.permute(3, 2, 0, 1).double(), padding=1)
        y = acc.float() * (s * sw)[:, None, None] + b[:, None, None]
        return act(y).to(out)

    relu = F.relu

    def lrelu(v):
        return F.leaky_relu(v, 0.01)

    def dc(name, x):
        for i in (0, 1):
            x = site(f"{name}.{i}", x, f"{name}.{i}", relu, carry)
        return x

    def up(name, x, skip):
        t = site(f"{name}.t", x, f"{name}.t", lambda v: v, carry, True)
        return torch.cat([skip, _crop_to(t, skip)], dim=1)

    with exact_f32():
        y = _trunk(ink.to(carry), dc, up)
        out = {}
        for h in HEATMAPS:
            z = site(f"y:{h}", y, "y", lrelu, torch.float32)
            out[h] = _conv(z, w[f"params/out_{h}/Conv_1/kernel"],
                           w[f"params/out_{h}/Conv_1/bias"])
    out["features"] = y
    return out


@torch.no_grad()
def wide_heads_f32(w: Dict, features: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The six heads that are not heatmaps, in float32 (TF32 off), on the
    given NCHW features."""
    with exact_f32():
        return {h: head_f32(w, h, features.float())
                for h in HEADS if h not in HEATMAPS}


def prepare_int8(w: Dict, calib_ink: torch.Tensor, bits: int = 8) -> Dict:
    """fold -> calibrate -> quantize, on the weights' device."""
    sites = fold(w)
    return quantize(sites, calibrate(sites, calib_ink), bits)


def forward(w: Dict, ink: torch.Tensor, q: Optional[Dict] = None
            ) -> Dict[str, torch.Tensor]:
    """Every head's NCHW float32 logits on (B, 1, H, W) masks: the float32
    U-Net, or with `q` the quantized backbone with the wide heads in
    float32 on its features."""
    if q is None:
        return forward_f32(w, ink)
    out = forward_int8(w, q, ink)
    out.update(wide_heads_f32(w, out["features"]))
    return out
