"""Input path of the torch port against abcnet_tpu on the CPU.

Everything here is exact: pack_images is integer work, and the unpacked
mask is {0, 1} in every dtype, so the tolerance is bit-equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.data import pipeline as jax_pipeline
from abcnet_tpu.ops.pallas_input import fused_unpack_noise
from abcnet_tpu_torch.data import pipeline
from abcnet_tpu_torch.ops.unpack import unpack_bits
from torch_parity import packed_bits


@pytest.mark.parametrize("kind", ["random", "zeros", "ones"])
def test_unpack_matches_jax(kind):
    bits = packed_bits(kind)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_pipeline.device_unpack_bits(
        jnp.asarray(bits), key, train=False))                # (B,H,W,1) f32
    fused = np.asarray(fused_unpack_noise(jnp.asarray(bits), key,
                                          train=False), np.float32)
    t = torch.from_numpy(bits)
    got32 = pipeline.device_unpack_bits(t, dtype=torch.float32)
    gotbf = pipeline.device_unpack_bits(t, dtype=torch.bfloat16)
    assert got32.dtype == torch.float32 and gotbf.dtype == torch.bfloat16
    assert tuple(got32.shape) == want.shape == fused.shape
    np.testing.assert_array_equal(got32.numpy(), want)
    np.testing.assert_array_equal(gotbf.float().numpy(), want)
    np.testing.assert_array_equal(fused, want)


@pytest.mark.parametrize("threshold", [0.0, 0.2, 0.6, 1.0])
def test_pack_images_matches_jax(threshold):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (3, 32, 64), dtype=np.uint8)
    img[0, 0, :8] = (0, 1, 50, 51, 152, 153, 254, 255)   # cutoff edges
    np.testing.assert_array_equal(
        pipeline.pack_images(img, threshold),
        jax_pipeline.pack_images(img, threshold))


def test_unpack_is_msb_first():
    bits = torch.tensor([[[0b10000001, 0b01000000]]], dtype=torch.uint8)
    want = [1, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0]
    assert unpack_bits(bits, torch.float32)[0, 0].tolist() == want


def test_unpack_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        unpack_bits(torch.zeros(1, 4, 2, dtype=torch.int32))
    with pytest.raises(TypeError):
        unpack_bits(torch.zeros(1, 4, 2, dtype=torch.uint8), torch.float16)
    # train=True goes through the noise kernel's wrapper, which takes a
    # (B, H, W/8) batch only (tests/test_torch_noise.py holds the rest).
    with pytest.raises(TypeError, match=r"\(B, H, W/8\)"):
        pipeline.device_unpack_bits(torch.zeros(4, 2, dtype=torch.uint8),
                                    train=True)
    out = pipeline.device_unpack_bits(torch.zeros(1, 4, 2, dtype=torch.uint8),
                                      train=True)
    assert tuple(out.shape) == (1, 4, 16, 1)
