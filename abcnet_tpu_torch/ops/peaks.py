"""Fused 3x3 NMS + threshold + top-K peak selection on (B, H, W) logits.

Kernel 2 of the port, `csrc/nms_topk.cu`, replacing the Pallas kernel
abcnet_tpu/ops/pallas_peaks.py:_nms_topk_kernel and its wrapper
`nms_topk`. One CTA takes one map: the map sits in shared memory, the
survivors are compacted and sorted by (score descending, index
ascending). It reads each map once and is bound by latency, not bytes;
the CUDA source says how its design meets that. `nms_topk` launches it
for a CUDA tensor and runs `nms_topk_plain` for a CPU one.

Contract (the XLA path of abcnet_tpu/infer/decode.py:102-106, which
tests/test_pallas_peaks.py holds the Pallas kernel to):
  * a cell survives if it equals the max of its in-bounds 3x3
    neighbourhood (plateau ties all survive) and exceeds the threshold;
  * slots are sorted by score descending, ties by flat index ascending;
  * exhausted slots carry -inf and the indices a stable sort gives them
    (the smallest non-surviving flat indices, ascending).
Scores come back as f32 (a bf16 map converts exactly), indices as int32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import build
from ..utils.device import stream_ptr

# Shared memory a CTA may use on Hopper (H100: 227 KB).
MAX_SMEM_BYTES = 232448


def nms_topk_plain(logit: torch.Tensor, k: int, threshold: float):
    """Plain version: max pool with -inf padding, the mask, a stable
    descending sort, the first k."""
    x = logit.float()
    pooled = F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]
    keep = (pooled == x) & (x > threshold)
    scores = torch.where(keep, x, float("-inf")).reshape(x.shape[0], -1)
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), idx[:, :k].to(torch.int32)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("nms_topk")
    for fn in (lib.abcnet_nms_topk_bf16, lib.abcnet_nms_topk_f32):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.abcnet_nms_topk_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.abcnet_nms_topk_smem_bytes.restype = ctypes.c_longlong
    return lib


def nms_topk(logit: torch.Tensor, k: int, threshold: float):
    """logit: (B, H, W) bf16 or f32. Returns (scores (B, k) f32, flat
    indices (B, k) int32). A CUDA tensor goes through the kernel, a CPU
    tensor through the plain version; anything else raises."""
    if logit.dim() != 3:
        raise ValueError(f"nms_topk takes (B, H, W) maps, got "
                         f"{tuple(logit.shape)}")
    b, h, w = logit.shape
    if not 1 <= k <= h * w:
        raise ValueError(f"nms_topk: k={k} outside 1..{h * w}")
    if logit.device.type == "cpu":
        return nms_topk_plain(logit, k, threshold)
    if logit.device.type != "cuda":
        raise ValueError(f"nms_topk: unsupported device {logit.device}")
    if logit.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nms_topk takes bf16 or f32 maps, not "
                        f"{logit.dtype}")
    if not logit.is_contiguous():
        raise ValueError("nms_topk takes a contiguous (B, H, W) tensor")
    lib = _lib()
    if lib.abcnet_nms_topk_smem_bytes(h, w) > MAX_SMEM_BYTES:
        raise ValueError(f"nms_topk: a {h}x{w} map does not fit in one "
                         "CTA's shared memory")
    scores = torch.empty(b, k, dtype=torch.float32, device=logit.device)
    idx = torch.empty(b, k, dtype=torch.int32, device=logit.device)
    fn = (lib.abcnet_nms_topk_bf16 if logit.dtype == torch.bfloat16
          else lib.abcnet_nms_topk_f32)
    err = fn(logit.data_ptr(), b, h, w, k, float(threshold),
             scores.data_ptr(), idx.data_ptr(), stream_ptr(logit))
    if err:
        raise RuntimeError(f"nms_topk kernel launch failed (CUDA error "
                           f"{err})")
    nms_topk.launches += 1
    return scores, idx


nms_topk.launches = 0
