"""The port's hand-written CUDA kernels, each beside its plain version."""

from .noise import unpack_noise, unpack_noise_plain
from .peaks import nms_topk, nms_topk_pair, nms_topk_plain
from .unpack import unpack_bits, unpack_bits_plain

__all__ = ["nms_topk", "nms_topk_pair", "nms_topk_plain", "unpack_bits",
           "unpack_bits_plain", "unpack_noise", "unpack_noise_plain"]
