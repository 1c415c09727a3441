"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points run on the GPU unless the caller asks for the CPU.

    Raises when a CUDA device is asked for (the default) and none is
    available, instead of carrying on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) "
            "to run abcnet_tpu_torch on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def stream_ptr(t: torch.Tensor):
    """The current CUDA stream of `t`'s device, as a ctypes pointer."""
    import ctypes
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
