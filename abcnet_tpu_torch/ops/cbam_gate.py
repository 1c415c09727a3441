"""The CBAM gate of one DoubleConvCBAM site in eval mode as one op:
out = relu(sa * (ca * y) + res), with ca the channel gate of y and sa the
spatial gate of ca * y (models/unet_cbam.py).

`cbam_gate_eval(y, res, w0, b0, w1, b1, ws, bs, dtype)` is the gate of
serving, `eval_step` and the metrics step: w0, b0, w1, b1 the shared
MLP's Dense weights (C -> C/16 -> C), ws, bs the spatial gate's 7x7 conv
(2 -> 1), all f32 masters. A CUDA tensor goes through the three kernels
of `csrc/cbam_gate.cu`, launched by one native call (channel pooling
partials, the MLP, then one pass over tiles with a 3-pixel halo for the
spatial gate and the output), in place of the stock chain of some
fifteen kernels a site. It takes y and res channels_last, bf16 or f32 (C
a multiple of 16 bytes of values), writes out channels_last in y's type,
has no backward and raises where autograd would need one: the
train-mode gate stays on the chain. Each call counts
`cbam_gate_eval.launches` and the recorder's counter `cbam_fused`
(utils/profiling.py). A CPU tensor goes through `cbam_gate_eval_plain`,
the chain's exact op sequence.

No Pallas kernel stands behind it: the JAX package gets the gate from
XLA's fusions (abcnet_tpu/models/unet_cbam.py). It is bound by bytes;
the kernel's source note says how it moves y twice, res once and out
once, and how it rounds where the chain stores.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import build, profiling
from ..utils.device import stream_ptr

DTYPES = (torch.bfloat16, torch.float32)
CHANNELS_LAST = torch.channels_last
THREADS = 256               # csrc/cbam_gate.cu:kThreads
VEC_BYTES = 16              # a thread's load along C
MAX_VECTORS = 128           # a pixel's 16-byte vectors: 4 a lane of 32
# The pooling kernel's split: at most as many blocks as the card holds at
# once (one wave), each thread at least MIN_PIXELS pixels.
MIN_PIXELS = 16
# The gate kernel's tiles: about TILE_BYTES of y each (32 x 32 pixels at
# 32 bf16 channels, 8 x 8 at 512), at least 64 pixels.
TILE_BYTES = 64 * 1024
SPATIAL = 7


class Plan(NamedTuple):
    """How one call splits its work: the pooling kernel's chunks of an
    image (`parts` of `chunk` pixels); the gate kernel's th x tw tiles and
    the lanes of a pixel (`group`, a power of two <= 32, each taking `nv`
    16-byte vectors)."""
    parts: int
    chunk: int
    th: int
    tw: int
    group: int
    nv: int


def plan(b: int, c: int, h: int, w: int, el: int, resident: int) -> Plan:
    """The split of a (b, c, h, w) gate of `el`-byte values on a card that
    holds `resident` pooling blocks at once."""
    cv = c * el // VEC_BYTES
    hw = h * w
    parts = max(1, min(resident // b,
                       -(-hw // (THREADS // cv * MIN_PIXELS))))
    chunk = -(-hw // parts)
    px = max(TILE_BYTES // (c * el), 64)
    tw = min(w, 32 if px >= 512 else 16 if px >= 128 else 8)
    th = min(h, px // tw)
    group = min(1 << (cv - 1).bit_length(), 32)
    nv = 1 << (-(-cv // group) - 1).bit_length()
    return Plan(-(-hw // chunk), chunk, th, tw, group, nv)


def mean_factor(kept: int, numel: int) -> float:
    """ATen's factor of a mean on the card: outputs over inputs, each made
    f32 and divided in f32; the mean is the f32 sum times it."""
    return float(np.float32(kept) / np.float32(numel))


# ---------------------------------------------------------------------------
# The plain chain
# ---------------------------------------------------------------------------

def cbam_gate_eval_plain(y: torch.Tensor, res: torch.Tensor,
                         w0: torch.Tensor, b0: torch.Tensor,
                         w1: torch.Tensor, b1: torch.Tensor,
                         ws: torch.Tensor, bs: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """relu(CBAM(y) + res) by the op sequence of models/unet_cbam.py's
    modules (ChannelAttention, SpatialAttention, CBAM, DoubleConvCBAM),
    weights cast to `dtype` as they cast them: on any device,
    differentiable."""
    def dense(v, w, b):
        return F.linear(v.to(dtype), w.to(dtype), b.to(dtype))

    def mlp(v):
        return dense(F.relu(dense(v, w0, b0)), w1, b1)

    ca = torch.sigmoid(mlp(y.mean(dim=(2, 3))) + mlp(y.amax(dim=(2, 3))))
    x = ca[:, :, None, None] * y
    s = torch.cat([x.mean(dim=1, keepdim=True),
                   x.amax(dim=1, keepdim=True)], dim=1)
    sa = torch.sigmoid(F.conv2d(s.to(dtype), ws.to(dtype), bs.to(dtype),
                                padding=SPATIAL // 2))
    return F.relu(sa * x + res)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("cbam_gate")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.abcnet_cbam_gate_eval
    fn.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p, i, p, p, p, i, i, p,
                   i, i, i, i, f, f, p]
    fn.restype = ctypes.c_int
    lib.abcnet_cbam_gate_pool_resident.argtypes = [i]
    lib.abcnet_cbam_gate_pool_resident.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _resident(device: int, bf16: int) -> int:
    """Pooling blocks that `device` holds at once."""
    with torch.cuda.device(device):
        n = _lib().abcnet_cbam_gate_pool_resident(bf16)
    if n < 0:
        raise RuntimeError(f"cbam_gate occupancy query failed (CUDA error "
                           f"{-n})")
    return max(1, n)


def _weight(t: torch.Tensor, shape, y: torch.Tensor) -> torch.Tensor:
    """A weight as the kernels read it: contiguous f32 on y's device."""
    if tuple(t.shape) != tuple(shape) or t.device != y.device:
        raise ValueError(f"cbam_gate: a weight of shape {tuple(t.shape)} "
                         f"on {t.device}, expected {tuple(shape)} on "
                         f"{y.device}")
    return t.float().contiguous()


def _check(y: torch.Tensor, res: torch.Tensor) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"cbam_gate kernels: unsupported device {y.device}")
    if y.dtype not in DTYPES or res.dtype != y.dtype:
        raise TypeError(f"cbam_gate kernels take y and res both bf16 or "
                        f"both f32, not {y.dtype} and {res.dtype}")
    if y.dim() != 4 or res.shape != y.shape or res.device != y.device:
        raise ValueError(f"cbam_gate kernels: y {tuple(y.shape)} and res "
                         f"{tuple(res.shape)} must be one NCHW shape on one "
                         f"device")
    if not all(t.is_contiguous(memory_format=CHANNELS_LAST) and
               t.data_ptr() % VEC_BYTES == 0 for t in (y, res)):
        raise ValueError("cbam_gate kernels take channels_last y and res, "
                         "16-byte aligned")
    n, c, h, w = y.shape
    cv = c * y.element_size() // VEC_BYTES
    if c * y.element_size() % VEC_BYTES or not 0 < cv <= MAX_VECTORS or \
            not 0 < n <= 65535 or h * w == 0 or n * h * w >= 2 ** 31:
        raise ValueError(f"cbam_gate kernels: unsupported shape "
                         f"{tuple(y.shape)}")


def _launch(y: torch.Tensor, res: torch.Tensor, w0: torch.Tensor,
            b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """The three kernels on channels_last y and res of one type: out in
    y's type and layout."""
    _check(y, res)
    n, c, h, w = y.shape
    mid = w0.shape[0]
    w0, b0 = _weight(w0, (mid, c), y), _weight(b0, (mid,), y)
    w1, b1 = _weight(w1, (c, mid), y), _weight(b1, (c,), y)
    ws = _weight(ws, (1, 2, SPATIAL, SPATIAL), y)
    bs = _weight(bs, (1,), y)
    p = plan(n, c, h, w, y.element_size(),
             _resident(y.device.index, int(y.dtype == torch.bfloat16)))
    out = torch.empty_like(y, memory_format=CHANNELS_LAST)
    part = torch.empty(n * p.parts * 2 * c, dtype=torch.float32,
                       device=y.device)
    ca = torch.empty(n * c, dtype=torch.float32, device=y.device)
    numel = n * c * h * w
    with torch.cuda.device(y.device):
        err = _lib().abcnet_cbam_gate_eval(
            y.data_ptr(), res.data_ptr(), out.data_ptr(),
            int(y.dtype == torch.bfloat16), n, h, w, c, w0.data_ptr(),
            b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), mid, ws.data_ptr(),
            bs.data_ptr(), part.data_ptr(), p.parts, p.chunk, ca.data_ptr(),
            p.th, p.tw, p.group, p.nv,
            mean_factor(n * c, numel), mean_factor(n * h * w, numel),
            stream_ptr(y))
    if err:
        raise RuntimeError(f"cbam_gate kernel launch failed (CUDA error "
                           f"{err})")
    return out


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------

def cbam_gate_eval(y: torch.Tensor, res: torch.Tensor, w0: torch.Tensor,
                   b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   ws: torch.Tensor, bs: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """relu(CBAM(y) + res) in `dtype`, the eval-mode gate of a site.

    A CUDA tensor goes through the kernels (`dtype` must be y's type; they
    have no backward, so a call that autograd would track raises: run
    eval forwards under torch.no_grad()), a CPU tensor through
    `cbam_gate_eval_plain`; anything else raises."""
    if y.device.type == "cpu":
        return cbam_gate_eval_plain(y, res, w0, b0, w1, b1, ws, bs, dtype)
    if y.device.type != "cuda":
        raise ValueError(f"cbam_gate_eval: unsupported device {y.device}")
    if dtype != y.dtype:
        raise TypeError(f"cbam_gate_eval kernels write y's type {y.dtype}, "
                        f"not {dtype}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, res, w0, b0, w1, b1, ws, bs)):
        raise RuntimeError("cbam_gate_eval has no backward: run eval-mode "
                           "forwards under torch.no_grad()")
    out = _launch(y, res, w0, b0, w1, b1, ws, bs)
    cbam_gate_eval.launches += 1
    profiling.count("cbam_fused", 1)
    return out


cbam_gate_eval.launches = 0
