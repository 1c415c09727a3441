"""Bit unpack: (B, H, W/8) uint8, MSB first -> (B, H, W) {0, 1} mask.

Kernel 1 of the port, `csrc/unpack.cu`, replacing the Pallas kernel
abcnet_tpu/ops/pallas_input.py:_kernel_unpack. It is memory-bound (one
byte read per eight values written); the CUDA source says how its
design meets that. `unpack_bits` launches it for a CUDA tensor and runs
`unpack_bits_plain`, the same function in plain PyTorch, for a CPU one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import build
from ..utils.device import stream_ptr

DTYPES = (torch.bfloat16, torch.float32)


def unpack_bits_plain(bits: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: bit 7 - j of byte i is output 8i + j (the semantics
    of abcnet_tpu/data/pipeline.py:182-188)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    out = (bits[..., None] >> shifts) & 1
    return out.reshape(*bits.shape[:-1], bits.shape[-1] * 8).to(dtype)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("unpack")
    for fn in (lib.abcnet_unpack_bits_bf16, lib.abcnet_unpack_bits_f32):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def unpack_bits(bits: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(..., W/8) uint8 -> (..., W) mask in `dtype` (bf16 or f32).

    A CUDA tensor goes through the kernel, launched on that tensor's
    device, a CPU tensor through the plain version; anything else
    raises."""
    if bits.dtype != torch.uint8:
        raise TypeError(f"unpack_bits takes uint8 bits, got {bits.dtype}")
    if dtype not in DTYPES:
        raise TypeError(f"unpack_bits writes bf16 or f32, not {dtype}")
    if bits.device.type == "cpu":
        return unpack_bits_plain(bits, dtype)
    if bits.device.type != "cuda":
        raise ValueError(f"unpack_bits: unsupported device {bits.device}")
    if bits.dim() < 1 or not bits.is_contiguous():
        raise ValueError("unpack_bits takes a contiguous tensor of packed "
                         "rows")
    out = torch.empty(*bits.shape[:-1], bits.shape[-1] * 8, dtype=dtype,
                      device=bits.device)
    lib = _lib()
    fn = (lib.abcnet_unpack_bits_bf16 if dtype == torch.bfloat16
          else lib.abcnet_unpack_bits_f32)
    with torch.cuda.device(bits.device):
        err = fn(bits.data_ptr(), out.data_ptr(), bits.numel(),
                 stream_ptr(bits))
    if err:
        raise RuntimeError(f"unpack_bits kernel launch failed (CUDA error "
                           f"{err})")
    unpack_bits.launches += 1
    return out


unpack_bits.launches = 0
