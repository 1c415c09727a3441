"""The modulated deformable 3x3 conv of DCNv2 (arXiv:1811.11168), as
CenterNet's DLA-34 aggregation runs it (models/dla_dcn.py:DeformConv).

Given x (N, C, H, W) and the output of the site's offset / mask conv
`offset_mask` (N, 27, H, W): for tap k = 3i + j, channel 2k is dy, 2k + 1
is dx (DCN's offset = cat(o1, o2) is the first 18 channels in order) and
18 + k the mask logit. The sample point of output pixel (h, w) is

    y = (h - 1 + i) + dy,    x = (w - 1 + j) + dx

in float32, read bilinearly from x: 0 unless -1 < y < H and -1 < x < W,
and inside that each corner that falls off the map counts 0. The sample
is weighted by sigmoid(mask logit), and the conv contracts the 9 C
samples of a pixel with the (C_out, C, 3, 3) weight, then adds the bias.

  * `modulated_columns_plain(x, offset_mask)`: the (N, H, W, 9 C) columns
    (tap-major, channels inside) in x's type, computed in float32 and
    rounded once, on any device, differentiable (the train-mode path);
  * `modulated_columns(x, offset_mask)`: a CUDA bf16 tensor through the
    kernel of csrc/deform_conv.cu (same arithmetic, each f32 operation
    rounded alone in the plain op's order: the columns come out bit-equal
    to it), a CPU tensor through the plain op;
  * `deform_conv_bn_act_eval(x, offset_mask, weight, bias, running_mean,
    running_var, bn_weight, bn_bias, eps, act)`: the eval-mode site, the
    columns, one GEMM (the contraction) and ops/bn_act.py:bn_act_eval (the
    bias, eval BatchNorm, activation and cast); channels-last out;
  * `deform_conv_bn_act_eval_plain(...)`: the same chain through the plain
    columns and bn_act_eval_plain, on any device;
  * `deform_conv_plain(x, offset_mask, weight, bias)`: the conv alone, bias
    included, under autograd (the train-mode path).

Each kernel launch counts `modulated_columns.launches`. No Pallas kernel
stands behind it: the JAX package has no deformable conv.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import build
from ..utils.device import stream_ptr
from .bn_act import bn_act_eval, bn_act_eval_plain

TAPS = 9
OFFSET_MASK = 3 * TAPS      # 18 offsets (dy, dx a tap), 9 mask logits
VEC = 8                     # csrc/deform_conv.cu:kVec, bf16 values a thread
CHANNELS_LAST = torch.channels_last


def _check_pair(x: torch.Tensor, offset_mask: torch.Tensor) -> None:
    if x.dim() != 4 or offset_mask.dim() != 4:
        raise ValueError("deform_conv takes 4-d x and offset_mask")
    n, _, h, w = x.shape
    if tuple(offset_mask.shape) != (n, OFFSET_MASK, h, w):
        raise ValueError(f"deform_conv: offset_mask of shape "
                         f"{tuple(offset_mask.shape)}, expected "
                         f"{(n, OFFSET_MASK, h, w)}")


# ---------------------------------------------------------------------------
# The plain op
# ---------------------------------------------------------------------------

def modulated_columns_plain(x: torch.Tensor,
                            offset_mask: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 9 C) modulated columns in x's type: column 9-tap-major,
    channel minor. Every coordinate and product in float32, in the order
    the kernel keeps (csrc/deform_conv.cu)."""
    _check_pair(x, offset_mask)
    n, c, h, w = x.shape
    dev = x.device
    om = offset_mask.float()
    dy, dx = om[:, 0:18:2], om[:, 1:18:2]                   # (N, 9, H, W)
    mask = torch.sigmoid(om[:, 18:])
    taps = torch.arange(TAPS, device=dev)
    gy = (torch.arange(h, device=dev)[None, :, None] - 1
          + (taps // 3)[:, None, None]).float()              # (9, H, 1)
    gx = (torch.arange(w, device=dev)[None, None, :] - 1
          + (taps % 3)[:, None, None]).float()               # (9, 1, W)
    ys, xs = gy + dy, gx + dx
    inside = (ys > -1) & (ys < h) & (xs > -1) & (xs < w)
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0f, xs - x0f
    hy, hx = 1 - ly, 1 - lx
    y0, x0 = y0f.long(), x0f.long()
    flat = x.permute(0, 2, 3, 1).reshape(n, h * w, c).float()

    def corner(yy, xx, wt):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(n, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        v = v.reshape(n, TAPS, h, w, c)
        v = torch.where(valid[..., None], v, torch.zeros((), device=dev))
        return wt[..., None] * v

    s = corner(y0, x0, hy * hx) + corner(y0, x0 + 1, hy * lx)
    s = s + corner(y0 + 1, x0, ly * hx)
    s = s + corner(y0 + 1, x0 + 1, ly * lx)
    col = torch.where(inside[..., None], s * mask[..., None],
                      torch.zeros((), device=dev))
    return col.permute(0, 2, 3, 1, 4).reshape(n, h, w, TAPS * c).to(x.dtype)


def _contract(cols: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 9 C) columns times the (C_out, C, 3, 3) weight cast to the
    columns' type: (N, C_out, H, W), channels-last."""
    co = weight.shape[0]
    wk = weight.to(cols.dtype).permute(0, 2, 3, 1).reshape(co, -1)
    return (cols @ wk.t()).permute(0, 3, 1, 2)


def deform_conv_plain(x: torch.Tensor, offset_mask: torch.Tensor,
                      weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The deformable conv with its bias, in x's type, differentiable."""
    y = _contract(modulated_columns_plain(x, offset_mask), weight)
    return y + bias.to(x.dtype)[:, None, None]


def deform_conv_bn_act_eval_plain(x, offset_mask, weight, bias,
                                  running_mean, running_var, bn_weight,
                                  bn_bias, eps, act) -> torch.Tensor:
    """The eval-mode site through the plain columns: the contraction, then
    bn_act_eval_plain adding the bias (rounded to x's type)."""
    y = _contract(modulated_columns_plain(x, offset_mask), weight)
    return bn_act_eval_plain(y, bias.to(x.dtype), running_mean, running_var,
                             bn_weight, bn_bias, eps, act, x.dtype)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("deform_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.abcnet_deform_columns
    fn.argtypes = [p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, offset_mask: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16 or offset_mask.dtype != torch.bfloat16:
        raise TypeError(f"deform_conv kernel takes bf16 x and offset_mask, "
                        f"not {x.dtype} and {offset_mask.dtype}")
    n, c, h, w = x.shape
    if c % VEC or not 0 < n * h * w * TAPS * c < 2 ** 40:
        raise ValueError(f"deform_conv kernel: unsupported input shape "
                         f"{tuple(x.shape)} (channels a multiple of {VEC})")
    if offset_mask.device != x.device:
        raise ValueError("deform_conv kernel: offset_mask on another device "
                         "than x")
    x = x.contiguous(memory_format=CHANNELS_LAST)
    om = offset_mask.contiguous(memory_format=CHANNELS_LAST)
    if x.data_ptr() % 16:
        raise ValueError("deform_conv kernel takes x 16-byte aligned")
    cols = torch.empty((n, h, w, TAPS * c), dtype=torch.bfloat16,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().abcnet_deform_columns(x.data_ptr(), om.data_ptr(),
                                           cols.data_ptr(), n, h, w, c,
                                           stream_ptr(x))
    if err:
        raise RuntimeError(f"deform_conv kernel launch failed (CUDA error "
                           f"{err})")
    return cols


def modulated_columns(x: torch.Tensor,
                      offset_mask: torch.Tensor) -> torch.Tensor:
    """The (N, H, W, 9 C) columns: a CUDA tensor through the kernel (bf16;
    no backward, so a call that autograd would track raises), a CPU tensor
    through `modulated_columns_plain`; anything else raises."""
    _check_pair(x, offset_mask)
    if x.device.type == "cpu":
        return modulated_columns_plain(x, offset_mask)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or
                                    offset_mask.requires_grad):
        raise RuntimeError("the deform_conv kernel has no backward: run "
                           "eval-mode forwards under torch.no_grad()")
    cols = _launch(x, offset_mask)
    modulated_columns.launches += 1
    return cols


modulated_columns.launches = 0


def deform_conv_bn_act_eval(x: torch.Tensor, offset_mask: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            running_mean: torch.Tensor,
                            running_var: torch.Tensor,
                            bn_weight: torch.Tensor, bn_bias: torch.Tensor,
                            eps: float, act: str) -> torch.Tensor:
    """act(bn_eval(deform_conv(x) + bias)) in x's type: an eval-mode site.
    The columns (`modulated_columns`), one GEMM, then bn_act_eval with the
    bias."""
    y = _contract(modulated_columns(x, offset_mask), weight)
    return bn_act_eval(y, bias.to(x.dtype), running_mean, running_var,
                       bn_weight, bn_bias, eps, act, x.dtype)
