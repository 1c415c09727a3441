"""Fused 3x3 NMS + threshold + top-K peak selection on (B, H, W) logits.

Kernel 2 of the port, `csrc/nms_topk.cu`, replacing the Pallas kernel
abcnet_tpu/ops/pallas_peaks.py:_nms_topk_kernel and its wrapper
`nms_topk`. A thread block cluster takes one map, each of its CTAs a
band of rows: survivors are found from 16-byte loads and shuffles and
become (score descending, index ascending) keys, every band hands its
keys to the cluster's first CTA through distributed shared memory, and
that CTA gives each key the slot that counting the keys before it says.
One launch serves one map (`nms_topk`) or the two heatmaps of a serving
batch (`nms_topk_pair`). The kernel reads each map once and is bound by
latency, above all by instructions that run once; the CUDA source says
how its design meets that. Both entry points launch the kernel for CUDA
tensors and run `nms_topk_plain` for CPU ones.

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

# CTAs per map (a thread block cluster). chip_smoke.py times 1, 2, 4 and 8
# on an H100 (`kernel_times`, `by_cluster_ms`): 2 and 4 are the fastest and
# within a percent of each other, 1 and 8 some 8% slower.
CLUSTER = 4


def nms_topk_plain(logit: torch.Tensor, k: int, threshold: float):
    """Plain version: max pool with -inf padding, the mask, a stable
    descending sort, the first k."""
    x = logit.float()
    pooled = F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]
    keep = (pooled == x) & (x > threshold)
    scores = torch.where(keep, x, float("-inf")).reshape(x.shape[0], -1)
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def nms_topk_pair_plain(a_logit: torch.Tensor, k_a: int,
                        b_logit: torch.Tensor, k_b: int, threshold: float):
    """Plain version of `nms_topk_pair`: two calls of `nms_topk_plain`."""
    return (nms_topk_plain(a_logit, k_a, threshold),
            nms_topk_plain(b_logit, k_b, threshold))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("nms_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.abcnet_nms_topk.argtypes = [p, i, p, p, p, i, p, p, i, i, i, i,
                                    ctypes.c_float, i, i, p]
    lib.abcnet_nms_topk.restype = i
    lib.abcnet_nms_topk_null.argtypes = [i, i, i, i, i, i, p]
    lib.abcnet_nms_topk_null.restype = i
    lib.abcnet_nms_topk_smem_bytes.argtypes = [i, i, i, i]
    lib.abcnet_nms_topk_smem_bytes.restype = ctypes.c_longlong
    lib.abcnet_nms_topk_cluster.argtypes = [i, i, i, i]
    lib.abcnet_nms_topk_cluster.restype = i
    return lib


def _check(maps, ks) -> None:
    first = maps[0]
    for logit, k in zip(maps, ks):
        if logit.dim() != 3:
            raise ValueError(f"nms_topk takes (B, H, W) maps, got "
                             f"{tuple(logit.shape)}")
        if not 1 <= k <= logit.shape[1] * logit.shape[2]:
            raise ValueError(f"nms_topk: k={k} outside "
                             f"1..{logit.shape[1] * logit.shape[2]}")
        if logit.shape != first.shape or logit.dtype != first.dtype or \
                logit.device != first.device:
            raise ValueError("nms_topk_pair takes two maps of one shape, "
                             "type and device")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_topk: unsupported device {first.device}")


def _launch(maps, ks, threshold: float, cluster: int):
    """One launch of the kernel over one or two (B, H, W) CUDA maps."""
    first = maps[0]
    b, h, w = first.shape
    if first.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"nms_topk takes bf16 or f32 maps, not "
                        f"{first.dtype}")
    if not all(m.is_contiguous() for m in maps):
        raise ValueError("nms_topk takes a contiguous (B, H, W) tensor")
    lib = _lib()
    if lib.abcnet_nms_topk_smem_bytes(h, w, max(ks), cluster) < 0:
        raise ValueError(f"nms_topk: a {h}x{w} map does not fit in the "
                         "shared memory of its CTAs")
    out = [(torch.empty(b, k, dtype=torch.float32, device=first.device),
            torch.empty(b, k, dtype=torch.int32, device=first.device))
           for k in ks]
    if b == 0:
        return out
    args = []
    for j in (0, -1):                   # a single map fills both places
        args += [maps[j].data_ptr(), ks[j], out[j][0].data_ptr(),
                 out[j][1].data_ptr()]
    err = lib.abcnet_nms_topk(*args, len(maps), b, h, w, float(threshold),
                              int(first.dtype == torch.bfloat16), cluster,
                              stream_ptr(first))
    if err:
        raise RuntimeError(f"nms_topk kernel launch failed (CUDA error "
                           f"{err})")
    nms_topk.launches += 1
    return out


def nms_topk(logit: torch.Tensor, k: int, threshold: float,
             cluster: int = CLUSTER):
    """logit: (B, H, W) bf16 or f32. Returns (scores (B, k) f32, flat
    indices (B, k) int32). A CUDA tensor goes through the kernel, a CPU
    tensor through the plain version; anything else raises. `cluster`
    is the number of CTAs that share a map (1, 2, 4 or 8; fewer where
    the map has fewer rows)."""
    _check([logit], [k])
    if logit.device.type == "cpu":
        return nms_topk_plain(logit, k, threshold)
    return _launch([logit], [k], threshold, cluster)[0]


def nms_topk_pair(a_logit: torch.Tensor, k_a: int, b_logit: torch.Tensor,
                  k_b: int, threshold: float, cluster: int = CLUSTER):
    """`nms_topk` of two maps of one shape and type, each with its own k,
    in one kernel launch: ((scores_a, idx_a), (scores_b, idx_b)). The
    launch counts once, on `nms_topk.launches`."""
    _check([a_logit, b_logit], [k_a, k_b])
    if a_logit.device.type == "cpu":
        return nms_topk_pair_plain(a_logit, k_a, b_logit, k_b, threshold)
    return tuple(_launch([a_logit, b_logit], [k_a, k_b], threshold,
                         cluster))


def null_launch(b: int, h: int, w: int, k: int, maps: int = 2,
                cluster: int = CLUSTER) -> None:
    """Launch an empty kernel with the grid, cluster and shared memory
    that the NMS kernel takes for `maps` (b, h, w) maps: what a launch
    of that shape costs by itself. For measurements only."""
    err = _lib().abcnet_nms_topk_null(
        maps, b, h, w, k, cluster, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"null launch failed (CUDA error {err})")


nms_topk.launches = 0
