"""int8 3x3 convolution of the serving backbone, one conv site as one op:
quantize the input at the site's scale, s8 x s8 -> s32, dequantize,
bias, activation, cast.

`conv3x3_s8(x, packed, scale, coef, bias, act, out_dtype)` launches the
kernel of `csrc/conv_s8.cu` for a CUDA tensor, on the current stream of
x's device, and counts `conv3x3_s8.launches`; for a CPU tensor it runs
`conv3x3_s8_plain`. No Pallas kernel stands behind it: in the JAX
package the site is one XLA convolution with int32 accumulation, the
quantize and the dequantize fused around it (abcnet_tpu/infer/quant.py:
195-217), and stock PyTorch has no int8 convolution on CUDA.

`conv3x3_s8_plain(x, kq, scale, coef, bias, act, out_dtype)` is the
chain the kernel replaces, the one infer/quant.py:forward_quant ran at
every 3x3 site before it: `q8` (.float(), divide, round, clamp, cast) ->
`conv_int8` (im2col and `torch._int_mm`, cuBLASLt's int8 GEMM on the
card) -> `acc.float() * coef + bias` -> the activation -> `.to(out_dtype)`.
`coef` is the site's scale times the weight scales, `scale * sw`,
computed once by the caller, so both read the same f32 vector.

`pack_weights(kq)` turns an HWIO int8 kernel (3, 3, C_in, C_out) into
the layout the kernel reads, (ceil(C_in/32), 9, C_out, 32): for each
chunk of 32 input channels and each tap, each output channel's 32
weights side by side (K-major), the channels past C_in zero.
`unpack_weights(packed, c_in)` inverts it.

The transposed convs keep `convt_int8` (infer/quant.py), over `int_mm`.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import build
from ..utils.device import stream_ptr
from .bn_act import ACTS, activation

DTYPES = (torch.bfloat16, torch.float32)
CHUNK = 32                      # input channels a k-step of the kernel
TAPS = 9
# int8 elements of an im2col chunk (the GEMM's A operand)
IM2COL_CHUNK = 1 << 28


# ---------------------------------------------------------------------------
# The plain chain: quantize, im2col + torch._int_mm, dequantize
# ---------------------------------------------------------------------------

def q8(x: torch.Tensor, s: float) -> torch.Tensor:
    """Quantize at scale s: round half to even, clip to +-127."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact. The operands are
    zero-padded to M > 16 and K, N multiples of 8, what cuBLASLt's int8
    GEMM takes."""
    m, k = a.shape
    n = b.shape[1]
    pk, pn = -k % 8, -n % 8
    pm = max(17 - m, 0)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n] if (pm or pn) else out


def im2col(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """SAME patches of NHWC x: (B*H*W, kh*kw*C), (row, col, channel)
    order, the rows of an HWIO kernel reshaped to (kh*kw*C, O)."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = [xp[:, i:i + h, j:j + w] for i in range(kh) for j in range(kw)]
    return torch.stack(cols, dim=3).reshape(b * h * w, kh * kw * c)


def conv_int8(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """SAME conv, stride 1, of NHWC int8 x with an HWIO int8 kernel:
    the exact int32 accumulators (B, H, W, O), im2col and int_mm over
    chunks of images."""
    b, h, w, c = xq.shape
    kh, kw, _, o = kq.shape
    wmat = kq.reshape(kh * kw * c, o)
    per = max(1, IM2COL_CHUNK // (h * w * kh * kw * c))
    out = torch.empty(b, h, w, o, dtype=torch.int32, device=xq.device)
    for i in range(0, b, per):
        part = xq[i:i + per]
        out[i:i + per] = int_mm(im2col(part, kh, kw), wmat).reshape(
            part.shape[0], h, w, o)
    return out


def conv3x3_s8_plain(x: torch.Tensor, kq: torch.Tensor, scale: float,
                     coef: torch.Tensor, bias: torch.Tensor,
                     act: str = "relu",
                     out_dtype: torch.dtype = torch.bfloat16,
                     rec: Optional[Callable] = None) -> torch.Tensor:
    """Plain version of `conv3x3_s8`, on any device, with the HWIO int8
    kernel `kq`: q8 -> conv_int8 -> acc.float() * coef + bias -> act ->
    .to(out_dtype). `rec`, if given, is called with (xq, acc)."""
    _check_args(scale, act, out_dtype)
    xq = q8(x, scale)
    acc = conv_int8(xq, kq)
    if rec is not None:
        rec(xq, acc)
    return activation(act)(acc.float() * coef + bias).to(out_dtype)


# ---------------------------------------------------------------------------
# The kernel's weight layout
# ---------------------------------------------------------------------------

def pack_weights(kq: torch.Tensor) -> torch.Tensor:
    """HWIO int8 (3, 3, C_in, C_out) -> (ceil(C_in/32), 9, C_out, 32)
    int8, contiguous, on kq's device: [chunk j, tap 3*dy+dx, o, c] =
    kq[dy, dx, 32*j + c, o], 0 past C_in."""
    if kq.dtype != torch.int8 or kq.dim() != 4 or kq.shape[:2] != (3, 3):
        raise ValueError("pack_weights takes a (3, 3, C_in, C_out) int8 "
                         "HWIO kernel")
    _, _, ci, co = kq.shape
    chunks = -(-ci // CHUNK)
    w = kq.new_zeros(TAPS, chunks * CHUNK, co)
    w[:, :ci] = kq.reshape(TAPS, ci, co)
    return w.reshape(TAPS, chunks, CHUNK, co).permute(1, 0, 3, 2).contiguous()


def unpack_weights(packed: torch.Tensor, c_in: int) -> torch.Tensor:
    """The HWIO int8 kernel (3, 3, c_in, C_out) of `pack_weights`' layout."""
    chunks, _, co, _ = packed.shape
    w = packed.permute(1, 0, 3, 2).reshape(TAPS, chunks * CHUNK, co)
    return w[:, :c_in].reshape(3, 3, c_in, co).contiguous()


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("conv_s8")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.abcnet_conv3x3_s8
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, i, i,
                   p]
    fn.restype = ctypes.c_int
    return lib


def reciprocal(scale: float) -> float:
    """The f32 reciprocal that `x.float() / scale` multiplies by on the
    card for a Python scalar `scale` (ATen's div_true_kernel_cuda): 1 /
    scale in double, rounded to f32 (1.0f / f32(scale) differs from it for
    some scales)."""
    return float(np.float32(1.0 / float(scale)))


def _check_args(scale, act: str, out_dtype: torch.dtype) -> None:
    if act not in ACTS:
        raise ValueError(f"conv3x3_s8: act {act!r} is none of {sorted(ACTS)}")
    if out_dtype not in DTYPES:
        raise TypeError(f"conv3x3_s8 writes bf16 or f32, not {out_dtype}")
    # A tensor divisor would divide exactly on the card, where the chain's
    # Python scalar is a multiply by its reciprocal (see csrc/conv_s8.cu).
    if not isinstance(scale, numbers.Real) or \
            not 0 < float(scale) < float("inf"):
        raise TypeError(f"conv3x3_s8: scale must be a positive finite "
                        f"Python number, not {scale!r}")


def _check_operands(x: torch.Tensor, packed: torch.Tensor,
                    coef: torch.Tensor, bias: torch.Tensor) -> int:
    """C_out of a well-formed call; raises on anything else."""
    if x.dtype not in DTYPES:
        raise TypeError(f"conv3x3_s8 takes bf16 or f32 input, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError("conv3x3_s8 takes an NHWC (B, H, W, C_in) tensor")
    if packed.dtype != torch.int8 or packed.dim() != 4 or \
            packed.shape[0] != -(-x.shape[3] // CHUNK) or \
            packed.shape[1] != TAPS or packed.shape[3] != CHUNK:
        raise ValueError("conv3x3_s8 takes pack_weights' (ceil(C_in/32), 9, "
                         "C_out, 32) int8 layout of the input's C_in")
    co = packed.shape[2]
    for v in (coef, bias):
        if v.dtype != torch.float32 or tuple(v.shape) != (co,):
            raise ValueError("conv3x3_s8: coef and bias must be (C_out,) "
                             "f32 vectors")
    return co


def conv3x3_s8(x: torch.Tensor, packed: torch.Tensor, scale: float,
               coef: torch.Tensor, bias: torch.Tensor, act: str = "relu",
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """act(conv3x3_SAME(q8(x, scale), w) * coef + bias) in `out_dtype`,
    NHWC: x (B, H, W, C_in) bf16 or f32, `packed` pack_weights(w),
    `scale` the site's activation scale (a Python number), coef and bias
    (C_out,) f32, `act` "relu", "leaky_relu" (0.01) or "none".

    A CUDA tensor goes through the kernel, launched on x's device and
    current stream (every operand contiguous on that device), a CPU
    tensor through `conv3x3_s8_plain`; anything else raises."""
    _check_args(scale, act, out_dtype)
    co = _check_operands(x, packed, coef, bias)
    if x.device.type == "cpu":
        return conv3x3_s8_plain(x, unpack_weights(packed, x.shape[3]), scale,
                                coef, bias, act, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_s8: unsupported device {x.device}")
    for t in (x, packed, coef, bias):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv3x3_s8 takes contiguous operands on the "
                             "input's device")
    if packed.data_ptr() % 16:
        raise ValueError("conv3x3_s8: the packed weights must be 16-byte "
                         "aligned")
    b, h, w, ci = x.shape
    if min(b, h, w) == 0:
        raise ValueError(f"conv3x3_s8: empty input {tuple(x.shape)}")
    out = torch.empty(b, h, w, co, dtype=out_dtype, device=x.device)
    inv = reciprocal(scale)
    vec = int(ci % 8 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        err = _lib().abcnet_conv3x3_s8(
            x.data_ptr(), packed.data_ptr(), coef.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, h, w, ci, co, inv,
            ACTS[act], int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), vec, stream_ptr(x))
    if err:
        raise RuntimeError(f"conv3x3_s8 kernel launch failed (CUDA error "
                           f"{err})")
    conv3x3_s8.launches += 1
    return out


conv3x3_s8.launches = 0
