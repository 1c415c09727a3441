"""The noise kernel's plain version (abcnet_tpu_torch/ops/noise.py) on the CPU.

  * its Philox4x32-10 in int64 tensor arithmetic against a Philox written
    with Python integers, and against the known-answer vectors of the
    Random123 library: bit-equal;
  * the counter layout (byte index, image, draw, 0) and the word -> pixel
    assignment, pinned against the Python-integer Philox: bit-equal;
  * rates 0: equal to unpack_bits_plain and to the JAX package's
    fused_unpack_noise(train=False), run in interpret mode as
    tests/test_pallas_input.py runs it: bit-equal;
  * rates > 0: by distribution only (RNG streams do not cross
    frameworks). Realized flip rates within 6 binomial standard
    deviations of the rates given, and inside the bounds that
    tests/test_pallas_input.py::test_train_mode_noise_rates holds the
    JAX kernel to;
  * the same (rates, seed) or generator state gives the same mask;
  * the integer thresholds the CUDA kernel compares its random words
    with (`rate_thresholds`) against the float compares of the plain
    version: exact, NaN rates included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.ops.pallas_input import fused_unpack_noise
from abcnet_tpu_torch.data import pipeline
from abcnet_tpu_torch.ops.noise import (noise_uniforms, philox4x32_10,
                                        rate_thresholds, unpack_noise,
                                        unpack_noise_plain)
from abcnet_tpu_torch.ops.unpack import unpack_bits_plain

M32 = 0xFFFFFFFF


def philox_py(ctr, key):
    """Philox4x32-10 with Python integers (Salmon et al., SC'11)."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & M32]
        k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
    return c


# Known-answer vectors of Random123's kat_vectors for philox4x32-10.
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert tuple(philox_py(ctr, key)) == want
    t = [torch.tensor([v], dtype=torch.int64) for v in (*ctr, *key)]
    assert tuple(int(x) for x in philox4x32_10(*t)) == want


def test_philox_tensor_matches_python_ints_on_random_words():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (64, 6), dtype=np.uint64).astype(np.int64)
    got = torch.stack(philox4x32_10(*torch.from_numpy(words).T), dim=1)
    want = [philox_py(w[:4].tolist(), w[4:].tolist()) for w in words]
    assert got.tolist() == want


@pytest.mark.parametrize("seed", [0, 43100, (5 << 32) | 7, 2 ** 63 - 1])
def test_counter_layout(seed):
    """Pixel p of byte i of image b: u1 from word p % 4 of draw p // 4,
    u2 from draw 2 + p // 4; the key is the seed's two 32-bit halves."""
    b, per_image = 3, 5
    u1, u2 = noise_uniforms(b, per_image, seed)
    assert tuple(u1.shape) == tuple(u2.shape) == (b, per_image * 8)
    key = (seed & M32, seed >> 32)
    for img in range(b):
        for i in range(per_image):
            w = [x for d in range(4) for x in philox_py((i, img, d, 0), key)]
            for p in range(8):
                assert float(u1[img, 8 * i + p]) == (w[p] >> 8) / 2 ** 24
                assert float(u2[img, 8 * i + p]) == (w[8 + p] >> 8) / 2 ** 24
    # a tensor seed is the same seed
    t1, t2 = noise_uniforms(b, per_image, torch.tensor([seed]))
    assert torch.equal(t1, u1) and torch.equal(t2, u2)


def _bits(b=2, seed=0, shape=(512, 512)):
    rng = np.random.default_rng(seed)
    return np.packbits(rng.random((b, *shape)) < 0.06, axis=-1)  # ~6% ink


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_zero_rates_are_the_pure_unpack(dtype):
    bits = _bits()
    t = torch.from_numpy(bits)
    got = unpack_noise(t, torch.zeros(2, 2), 123, dtype)
    assert got.dtype == dtype and tuple(got.shape) == (2, 512, 512)
    assert torch.equal(got, unpack_bits_plain(t, dtype))
    fused = np.asarray(fused_unpack_noise(jnp.asarray(bits),
                                          jax.random.PRNGKey(0), amount=0.0,
                                          train=False), np.float32)[..., 0]
    np.testing.assert_array_equal(got.float().numpy(), fused)
    # amount 0 or train=False through the pipeline: the same
    for kw in ({"train": False}, {"train": True, "amount": 0.0}):
        out = pipeline.device_unpack_bits(t, dtype=dtype, **kw)
        assert torch.equal(out[..., 0], got)


def test_noise_rates_match_by_distribution():
    b = 8
    t = torch.from_numpy(_bits(b, 2))
    clean = unpack_bits_plain(t, torch.float32) > 0
    gen = torch.Generator().manual_seed(11)
    rates = pipeline.draw_noise_rates(b, 0.2, "cpu", gen)
    assert (rates[:, 0] >= 0).all() and (rates[:, 0] < 0.002).all()
    assert (rates[:, 1] >= 0).all() and (rates[:, 1] < 0.2).all()
    noisy = unpack_noise(t, rates, 99, torch.float32) > 0
    # keep = (ink | salt) & ~pepper: ink survives at 1 - pepper; a white
    # pixel turns to ink at salt * (1 - pepper).
    for i in range(b):
        s, p = float(rates[i, 0]), float(rates[i, 1])
        n_ink, n_bg = int(clean[i].sum()), int((~clean[i]).sum())
        drop = 1.0 - float(noisy[i][clean[i]].float().mean())
        add = float(noisy[i][~clean[i]].float().mean())
        q = s * (1 - p)
        assert abs(drop - p) <= 6 * np.sqrt(p * (1 - p) / n_ink) + 1e-6
        assert abs(add - q) <= 6 * np.sqrt(q * (1 - q) / n_bg) + 1e-6
    # The bounds the JAX kernel is held to (test_pallas_input.py:72-78),
    # through the pipeline's own rate draw.
    out = pipeline.device_unpack_bits(t, train=True, amount=0.2,
                                      generator=gen)[..., 0] > 0
    salt_rate = float(out[~clean].float().mean())
    pepper_drop = 1.0 - float(out[clean].float().mean())
    assert 0.0 < salt_rate < 0.004, salt_rate        # E ~ 0.001
    assert 0.02 < pepper_drop < 0.25, pepper_drop    # E ~ 0.1
    flips = [float((out[i] != clean[i]).float().mean()) for i in range(b)]
    assert len({round(f, 6) for f in flips}) > 1


def test_same_seed_same_mask_and_images_differ():
    t = torch.from_numpy(_bits(1, 3, (64, 64))).expand(3, -1, -1).contiguous()
    rates = torch.tensor([[0.01, 0.3]]).expand(3, -1).contiguous()
    a = unpack_noise(t, rates, 5, torch.float32)
    assert torch.equal(a, unpack_noise(t, rates, 5, torch.float32))
    assert torch.equal(a, unpack_noise_plain(t, rates, torch.tensor([5]),
                                             torch.float32))
    assert not torch.equal(a, unpack_noise(t, rates, 6, torch.float32))
    # the image index is part of the counter: equal bits and rates, other
    # noise
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    # the same generator state gives the same mask through the pipeline
    g1, g2 = (torch.Generator().manual_seed(8) for _ in range(2))
    assert torch.equal(
        pipeline.device_unpack_bits(t, train=True, generator=g1),
        pipeline.device_unpack_bits(t, train=True, generator=g2))


def test_integer_thresholds_equal_float_compare():
    """u < s == m < T and u >= s == m >= T for u = m * 2^-24, at the
    threshold's neighbours and the range's ends, for both columns; and in
    the kernel's 32-bit form, r < (T << 8) with T = 2^24 taken apart, for
    the low byte of r all zeros and all ones. Tolerance: none."""
    one = 1 << 24
    fixed = [0.0, 2.0 ** -25, 2.0 ** -24, 1.5 * 2.0 ** -24, 0.002, 0.2,
             1.0 - 2.0 ** -24, 1.0]
    drawn = np.random.default_rng(5).random(1000, dtype=np.float32)
    drawn[::4] *= 0.002                       # the salt rates' range too
    s = torch.cat([torch.tensor(fixed, dtype=torch.float32),
                   torch.from_numpy(drawn)])
    t = rate_thresholds(torch.stack([s, s], dim=1))
    assert t.dtype == torch.int64 and tuple(t.shape) == (len(s), 2)
    assert torch.equal(t[:, 0], t[:, 1])      # the columns differ on NaN only
    assert t[:8, 0].tolist() == [0, 1, 1, 2, 33555, 3355444, one - 1, one]
    t = t[:, :1]
    offs = torch.arange(-2, 3)
    m = torch.cat([torch.zeros(len(s), 1, dtype=torch.int64), t + offs,
                   torch.full((len(s), 1), one - 1)], dim=1).clamp(0, one - 1)
    u = m.to(torch.float32) * (1.0 / one)     # exact, as in noise_uniforms
    assert torch.equal(u < s[:, None], m < t)
    assert torch.equal(u >= s[:, None], m >= t)
    for low in (0, 0xFF):
        r = (m << 8) | low
        below = torch.where(t == one, torch.ones_like(m, dtype=torch.bool),
                            r < (t << 8))
        assert torch.equal(u < s[:, None], below)
        assert torch.equal(u >= s[:, None], ~below)


def test_nan_and_out_of_range_rates():
    """A NaN salt rate adds nothing and a NaN pepper rate erases the image,
    as `u < NaN` and `u >= NaN` are both false; rates outside [0, 1] act
    as 0 or 1. The thresholds say the same."""
    nan, inf = float("nan"), float("inf")
    rates = torch.tensor([[nan, 0.0], [0.0, nan], [-1.0, -0.5], [2.0, 0.0],
                          [0.5, inf], [inf, 0.25]])
    one = 1 << 24
    assert rate_thresholds(rates).tolist() == [
        [0, 0], [0, one], [0, 0], [one, 0], [1 << 23, one], [one, 1 << 22]]
    bits = torch.from_numpy(_bits(6, 4, (64, 64)))
    clean = unpack_bits_plain(bits, torch.float32)
    got = unpack_noise_plain(bits, rates, 9, torch.float32)
    assert torch.equal(got[0], clean[0]) and torch.equal(got[2], clean[2])
    assert not got[1].any() and not got[4].any()
    assert got[3].all()
    u1, u2 = noise_uniforms(6, 64 * 8, 9)
    t = rate_thresholds(rates)
    m1, m2 = (u1 * one).long(), (u2 * one).long()
    keep = ((clean.reshape(6, -1) > 0) | (m1 < t[:, :1])) & (m2 >= t[:, 1:])
    assert torch.equal(keep.reshape(6, 64, 64).float(), got)
    with pytest.raises(TypeError):
        rate_thresholds(rates.double())


def test_noise_rejects_what_the_kernel_does_not_take():
    bits = torch.zeros(2, 4, 2, dtype=torch.uint8)
    rates = torch.zeros(2, 2)
    with pytest.raises(TypeError):
        unpack_noise(bits.int(), rates, 0)
    with pytest.raises(TypeError):
        unpack_noise(bits, rates, 0, torch.float16)
    with pytest.raises(TypeError):
        unpack_noise(bits, torch.zeros(2, 3), 0)
    with pytest.raises(TypeError):
        unpack_noise(bits, rates.double(), 0)
    with pytest.raises(TypeError):
        unpack_noise(bits, rates, torch.tensor([1, 2]))
    with pytest.raises(ValueError):
        unpack_noise(bits, rates, -1)
