"""A stem site of the CBAM U-Net in eval mode as one op: the 5x5 conv
(padding 2, to 32 channels), its bias, the eval BatchNorm and the
activation (models/unet_cbam.py:DoubleConvCBAM, blocks inc1 and inc2).

`stem_conv_bn_act_eval(x, conv_weight, conv_bias, running_mean,
running_var, bn_weight, bn_bias, eps, act)` computes

    act(bn_eval(conv5x5(x, conv_weight) + conv_bias))

in x's type, the conv's weights and bias the f32 masters cast to it as
models/unet.py:_conv casts them. A CUDA tensor goes through one native
call into `csrc/stem_conv.cu` (a wgmma implicit GEMM for 32 input
channels, an mma.sync one for 1) that rounds as the stock chain it
replaces: cuDNN's conv in bf16 without its bias, then
ops/bn_act.py:bn_act_eval with the bias (kernel (e)); only the order in
which the f32 accumulator sums the conv's products differs. It takes x
channels_last bf16 with 1 or 32 channels and a (32, C, 5, 5) weight,
writes channels_last bf16, has no backward, and raises on anything else
(under autograd, another layout, type, width or kernel size): the
train-mode and f32 stems stay on `conv_bn_act`. Each call counts
`stem_conv_bn_act_eval.launches` and the recorder's counter `stem_fused`
(utils/profiling.py). A CPU tensor goes through
`stem_conv_bn_act_eval_plain`, the chain `conv_bn_act` runs there.

No Pallas kernel stands behind it: the JAX package gets the conv from XLA
(abcnet_tpu/models/unet_cbam.py). The kernel's source note states the
bound and the design.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import build, profiling
from ..utils.device import stream_ptr
from .bn_act import bn_act_eval_plain

KERNEL = 5
PAD = KERNEL // 2
WIDTH = 32                  # the stem's output channels
IN_CHANNELS = (1, WIDTH)
CHANNELS_LAST = torch.channels_last
ACT_CODES = {"none": 0, "relu": 1}


# ---------------------------------------------------------------------------
# The plain chain
# ---------------------------------------------------------------------------

def stem_conv_bn_act_eval_plain(x: torch.Tensor, conv_weight: torch.Tensor,
                                conv_bias: torch.Tensor,
                                running_mean: torch.Tensor,
                                running_var: torch.Tensor,
                                bn_weight: torch.Tensor,
                                bn_bias: torch.Tensor, eps: float,
                                act: str) -> torch.Tensor:
    """The chain `conv_bn_act` runs for an eval-mode site, in x's type, on
    any device: the conv without its bias, then bn_act_eval_plain adding
    it, where models/unet.py:_folds_conv_bias folds the bias (a GPU: the
    chain kernel (e) of csrc/bn_act.cu equals bit for bit); else the conv
    with its bias, then bn_act_eval_plain."""
    from ..models.unet import _folds_conv_bias

    dtype = x.dtype
    w = conv_weight.to(dtype)
    b = conv_bias.to(dtype)
    if _folds_conv_bias(None, x):
        y = F.conv2d(x, w, None, padding=PAD)
        return bn_act_eval_plain(y, b, running_mean, running_var, bn_weight,
                                 bn_bias, eps, act, dtype)
    y = F.conv2d(x, w, b, padding=PAD)
    return bn_act_eval_plain(y, None, running_mean, running_var, bn_weight,
                             bn_bias, eps, act, dtype)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("stem_conv")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.abcnet_stem_conv_eval
    fn.argtypes = [p, p, p, p, p, p, p, f, p, i, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    return lib


def _vector(t: torch.Tensor, x: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    """A per-channel operand as the kernel reads it: WIDTH contiguous
    values of `dtype` on x's device."""
    if tuple(t.shape) != (WIDTH,) or t.device != x.device:
        raise ValueError(f"stem_conv: a per-channel operand of shape "
                         f"{tuple(t.shape)} on {t.device}, expected "
                         f"({WIDTH},) on {x.device}")
    return t.to(dtype).contiguous()


def _check(x: torch.Tensor, conv_weight: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"stem_conv kernel takes bf16 x, not {x.dtype}")
    if conv_weight.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem_conv kernel: conv weight of type "
                        f"{conv_weight.dtype}")
    if x.dim() != 4 or x.shape[1] not in IN_CHANNELS:
        raise ValueError(f"stem_conv kernel: unsupported input shape "
                         f"{tuple(x.shape)} (channels 1 or {WIDTH})")
    n, c, h, w = x.shape
    if tuple(conv_weight.shape) != (WIDTH, c, KERNEL, KERNEL):
        raise ValueError(f"stem_conv kernel takes a ({WIDTH}, {c}, {KERNEL},"
                         f" {KERNEL}) conv weight, not "
                         f"{tuple(conv_weight.shape)}")
    if conv_weight.device != x.device:
        raise ValueError("stem_conv kernel: the conv weight is on another "
                         "device than x")
    if not x.is_contiguous(memory_format=CHANNELS_LAST) or \
            x.data_ptr() % 16:
        raise ValueError("stem_conv kernel takes channels_last x, 16-byte "
                         "aligned")
    if not 0 < n * h * w < 2 ** 31 // WIDTH:
        raise ValueError(f"stem_conv kernel: unsupported input shape "
                         f"{tuple(x.shape)}")


def _launch(x, conv_weight, conv_bias, running_mean, running_var, bn_weight,
            bn_bias, eps, act):
    _check(x, conv_weight)
    n, c, h, w = x.shape
    wt = conv_weight.to(torch.bfloat16).contiguous()
    vecs = [_vector(conv_bias, x, torch.bfloat16)] + [
        _vector(t, x, torch.float32)
        for t in (running_mean, running_var, bn_weight, bn_bias)]
    y = torch.empty((n, WIDTH, h, w), dtype=torch.bfloat16, device=x.device,
                    memory_format=CHANNELS_LAST)
    counter = torch.empty(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().abcnet_stem_conv_eval(
            x.data_ptr(), wt.data_ptr(), *(v.data_ptr() for v in vecs),
            float(eps), y.data_ptr(), n, h, w, c, ACT_CODES[act],
            counter.data_ptr(), stream_ptr(x))
    if err:
        raise RuntimeError(f"stem_conv kernel launch failed (CUDA error "
                           f"{err})")
    return y


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------

def stem_conv_bn_act_eval(x: torch.Tensor, conv_weight: torch.Tensor,
                          conv_bias: torch.Tensor,
                          running_mean: torch.Tensor,
                          running_var: torch.Tensor, bn_weight: torch.Tensor,
                          bn_bias: torch.Tensor, eps: float,
                          act: str) -> torch.Tensor:
    """act(bn_eval(conv5x5(x) + conv_bias)) in x's type: an eval-mode stem
    site.

    A CUDA tensor goes through the kernel (x channels_last bf16; it has
    no backward, so a call that autograd would track raises: run eval
    forwards under torch.no_grad()), a CPU tensor through
    `stem_conv_bn_act_eval_plain`; anything else raises."""
    if act not in ACT_CODES:
        raise ValueError(f"stem_conv: act {act!r} is none of "
                         f"{sorted(ACT_CODES)}")
    if tuple(conv_weight.shape[2:]) != (KERNEL, KERNEL):
        raise ValueError(f"stem_conv takes a {KERNEL}x{KERNEL} conv, not "
                         f"{tuple(conv_weight.shape[2:])}")
    if x.device.type == "cpu":
        return stem_conv_bn_act_eval_plain(x, conv_weight, conv_bias,
                                           running_mean, running_var,
                                           bn_weight, bn_bias, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv_bn_act_eval: unsupported device "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, conv_weight, conv_bias, bn_weight,
                                      bn_bias)):
        raise RuntimeError("stem_conv_bn_act_eval has no backward: run "
                           "eval-mode forwards under torch.no_grad()")
    y = _launch(x, conv_weight, conv_bias, running_mean, running_var,
                bn_weight, bn_bias, eps, act)
    stem_conv_bn_act_eval.launches += 1
    profiling.count("stem_fused", 1)
    return y


stem_conv_bn_act_eval.launches = 0
