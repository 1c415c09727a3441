"""Fused training input: bit unpack + per-image salt/pepper noise.

Kernel 2 of the port, `csrc/noise.cu`, replacing the Pallas kernel
abcnet_tpu/ops/pallas_input.py:_kernel_noise. Per pixel

    mask = max(ink, u1 < salt_b) * (u2 >= pepper_b)

with (salt_b, pepper_b) the rates of image b and u = (r >> 8) * 2^-24
from 32 random bits r. The bits come from a counter-based Philox4x32-10
keyed by a 64-bit seed and countered by (byte index in the image, image,
draw 0..3, 0): draws 0 and 1 give u1 of pixels 0-3 and 4-7 of a packed
byte, draws 2 and 3 give u2. `unpack_noise_plain` is the same function
in integer tensor arithmetic, bit-equal to the kernel; `unpack_noise`
launches the kernel for a CUDA tensor and runs the plain version for a
CPU one. The stream is this port's own: the TPU kernel's hardware PRNG
and JAX's threefry give other bits, so the two packages agree on the
noise by distribution only (pallas_input.py:14-20 makes the same
statement about its two paths).

Bound on the card: the Philox arithmetic, 32-bit integer work, not the
17 bytes moved per packed byte (the CUDA source counts both). The kernel
compares the random words with integer thresholds instead of making
floats of them; `rate_thresholds` is that arithmetic on tensors.

A NaN rate behaves as in the float compares, where `u < NaN` and
`u >= NaN` are both false: a NaN salt rate adds no ink, a NaN pepper
rate erases the image. Kernel and plain version agree on that.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from ..utils import build
from ..utils.device import stream_ptr
from .unpack import DTYPES

_MASK = 0xFFFFFFFF
_MUL0, _MUL1 = 0xD2511F53, 0xCD9E8D57
_WEYL0, _WEYL1 = 0x9E3779B9, 0xBB67AE85
SEED_MAX = 2 ** 63 - 1

Seed = Union[int, torch.Tensor]


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32 with ten rounds on int64 tensors that hold 32-bit
    words. A product of two such words fills 64 bits; int64
    multiplication keeps its low 64 bits under wrap-around, so the high
    word is (p >> 32) & 0xFFFFFFFF whatever the sign."""
    for _ in range(10):
        p0, p1 = c0 * _MUL0, c2 * _MUL1
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _WEYL0) & _MASK, (k1 + _WEYL1) & _MASK
    return c0, c1, c2, c3


def _seed_tensor(seed: Seed, device) -> torch.Tensor:
    """The seed as a one-element int64 tensor on `device`."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise TypeError("unpack_noise: a tensor seed is one int64")
        return seed.reshape(1).to(device)
    if not 0 <= int(seed) <= SEED_MAX:
        raise ValueError(f"unpack_noise: seed {seed} outside [0, 2^63)")
    return torch.tensor([int(seed)], dtype=torch.int64, device=device)


def noise_uniforms(b: int, per_image: int, seed: Seed, device="cpu"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniforms of every pixel: (u1, u2), each (b, per_image * 8)
    f32 in [0, 1), in the kernel's counter layout."""
    s = _seed_tensor(seed, device)
    k0, k1 = s & _MASK, (s >> 32) & _MASK
    idx = torch.arange(per_image, dtype=torch.int64, device=device)
    img = torch.arange(b, dtype=torch.int64, device=device)
    draw = torch.arange(4, dtype=torch.int64, device=device)
    shape = (b, per_image, 4)
    words = philox4x32_10(idx[None, :, None].expand(shape),
                          img[:, None, None].expand(shape),
                          draw[None, None, :].expand(shape),
                          torch.zeros((), dtype=torch.int64, device=device),
                          k0, k1)
    r = torch.stack(words, dim=-1).reshape(b, per_image, 16)
    u = (r >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u[..., :8].reshape(b, per_image * 8),
            u[..., 8:].reshape(b, per_image * 8))


def rate_thresholds(rates: torch.Tensor) -> torch.Tensor:
    """The kernel's integer form of the two compares. rates: (..., 2) f32
    (salt, pepper). Returns int64 T of the same shape with, for every
    24-bit integer m and u = m * 2^-24,

        u <  salt    ==  m <  T[..., 0]
        u >= pepper  ==  m >= T[..., 1]

    T = ceil(rate * 2^24) clamped to [0, 2^24]; the product is exact in
    f32. A NaN salt rate gives 0 and a NaN pepper rate 2^24, so that both
    compares stay false. On the 32-bit word r with m = r >> 8 the kernel
    tests r < (T << 8) and r >= (T << 8), and takes T = 2^24, which does
    not fit that form, apart."""
    if rates.dtype != torch.float32 or rates.shape[-1] != 2:
        raise TypeError("rate_thresholds takes (..., 2) float32 rates")
    one = float(1 << 24)
    x = torch.ceil(rates * one)
    salt = torch.where(x[..., 0] > 0, x[..., 0].clamp(max=one), 0.0)
    pepper = torch.where(x[..., 1] < one, x[..., 1].clamp(min=0.0), one)
    return torch.stack([salt, pepper], dim=-1).to(torch.int64)


def _check(bits: torch.Tensor, rates: torch.Tensor, dtype) -> None:
    if bits.dtype != torch.uint8 or bits.dim() != 3:
        raise TypeError("unpack_noise takes (B, H, W/8) uint8 bits, got "
                        f"{tuple(bits.shape)} {bits.dtype}")
    if dtype not in DTYPES:
        raise TypeError(f"unpack_noise writes bf16 or f32, not {dtype}")
    if rates.dtype != torch.float32 or \
            tuple(rates.shape) != (bits.shape[0], 2):
        raise TypeError("unpack_noise takes (B, 2) float32 rates (salt, "
                        f"pepper), got {tuple(rates.shape)} {rates.dtype}")
    if rates.device != bits.device:
        raise ValueError("unpack_noise: bits and rates on different devices")


def unpack_noise_plain(bits: torch.Tensor, rates: torch.Tensor, seed: Seed,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: (B, H, W/8) uint8, (B, 2) f32 rates, seed ->
    (B, H, W) mask in `dtype`, bit-equal to the kernel."""
    _check(bits, rates, dtype)
    b, h, wb = bits.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    ink = ((bits[..., None] >> shifts) & 1).reshape(b, h * wb * 8) > 0
    u1, u2 = noise_uniforms(b, h * wb, seed, bits.device)
    keep = (ink | (u1 < rates[:, :1])) & (u2 >= rates[:, 1:])
    return keep.reshape(b, h, wb * 8).to(dtype)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("noise")
    for fn in (lib.abcnet_unpack_noise_bf16, lib.abcnet_unpack_noise_f32):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.abcnet_int32_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.abcnet_int32_probe.restype = ctypes.c_longlong
    return lib


def unpack_noise(bits: torch.Tensor, rates: torch.Tensor, seed: Seed,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, H, W/8) uint8 bits -> (B, H, W) noisy mask in `dtype`.

    rates: (B, 2) f32, salt and pepper rate of each image. seed: an int
    in [0, 2^63) or a one-element int64 tensor (on the card it is read
    from device memory, so a seed drawn there never visits the host).
    Rates of 0 give the pure unpack. A CUDA tensor goes through the
    kernel, launched on that tensor's device, a CPU tensor through the
    plain version; anything else raises."""
    _check(bits, rates, dtype)
    if bits.device.type == "cpu":
        return unpack_noise_plain(bits, rates, seed, dtype)
    if bits.device.type != "cuda":
        raise ValueError(f"unpack_noise: unsupported device {bits.device}")
    if not bits.is_contiguous() or not rates.is_contiguous():
        raise ValueError("unpack_noise takes contiguous bits and rates")
    b, h, wb = bits.shape
    if h * wb > 65535 * 256:
        raise ValueError("unpack_noise: more than 16,776,960 packed bytes "
                         "per image")
    seed_t = _seed_tensor(seed, bits.device)
    out = torch.empty(b, h, wb * 8, dtype=dtype, device=bits.device)
    if bits.numel() == 0:
        return out
    lib = _lib()
    fn = (lib.abcnet_unpack_noise_bf16 if dtype == torch.bfloat16
          else lib.abcnet_unpack_noise_f32)
    with torch.cuda.device(bits.device):
        err = fn(bits.data_ptr(), rates.data_ptr(), seed_t.data_ptr(),
                 out.data_ptr(), bits.numel(), h * wb, stream_ptr(bits))
    if err:
        raise RuntimeError(f"unpack_noise kernel launch failed (CUDA error "
                           f"{err})")
    unpack_noise.launches += 1
    return out


def int32_probe(out: torch.Tensor, rounds: int) -> int:
    """Launch the probe kernel of csrc/noise.cu: out.numel() threads (a
    multiple of 256, out is int32 on the card) run `rounds` Philox rounds
    on four counters each, nothing else. Returns the integer instructions
    run per thread, so that a timing of this call gives the card's
    rate for the noise kernel's instruction mix. For measurements only."""
    if out.device.type != "cuda" or out.dtype != torch.int32 or \
            out.numel() % 256 or not out.is_contiguous():
        raise ValueError("int32_probe takes a contiguous int32 CUDA tensor "
                         "of a multiple of 256 elements")
    with torch.cuda.device(out.device):
        ops = _lib().abcnet_int32_probe(out.data_ptr(), out.numel() // 256,
                                        rounds, stream_ptr(out))
    if ops < 0:
        raise RuntimeError("int32_probe kernel launch failed")
    return ops


unpack_noise.launches = 0
