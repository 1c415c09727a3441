"""abcnet_tpu_torch.ops.conv_s8 (one int8 3x3 conv site of the serving
backbone) on the CPU, small sizes, inputs from numpy seeds.

  * conv3x3_s8_plain against the JAX package's site computation
    (abcnet_tpu/infer/quant.py:195-204: q8, conv_general_dilated with
    int32 accumulation, `acc * (s * sw) + b`, the activation, the cast),
    op by op and jitted as the package jits forward_quant: the int8
    inputs and the int32 accumulators bit-equal; the outputs bit-equal to
    the op-by-op site, and to the jitted one but where XLA's CPU contracts
    the dequantize's multiply and add into a fused multiply-add, there by
    at most one f32 ulp of the product and one ulp of the output type.
  * pack_weights' layout: an implicit GEMM over it, written with torch
    ops in int64 (the kernel's loop: chunks of 32 input channels, nine
    taps, each tap's rows the pixels shifted by it), equals conv_int8
    exactly; unpack_weights inverts it.
  * Routing: conv3x3_s8 on a CPU tensor is the plain chain and launches
    nothing; forward_quant on the CPU runs the plain chain at every site
    (with and without `rec`, with and without packed weights), its
    per-site `rec` the int8 inputs and conv_int8's accumulators.
  * The wrapper raises on what neither version takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from abcnet_tpu_torch.infer import quant
from abcnet_tpu_torch.models import UNet
from abcnet_tpu_torch.ops import conv_s8
from abcnet_tpu_torch.ops.conv_s8 import (conv3x3_s8, conv3x3_s8_plain,
                                          conv_int8, pack_weights,
                                          unpack_weights)

_DN = ("NHWC", "HWIO", "NHWC")
JAX_ACTS = {"relu": jax.nn.relu,
            "leaky_relu": lambda v: jax.nn.leaky_relu(v, negative_slope=0.01),
            "none": lambda v: v}
TORCH_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _inputs(b, h, w, ci, co, seed):
    """bf16 x with about 2% of its values past the clamp, an HWIO int8
    kernel, the site scale (a Python float), sw and the bias (f32)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, ci)) * 2).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16)
    k = rng.integers(-127, 128, (3, 3, ci, co), dtype=np.int8)
    scale = float(4.0 / 127.0 * (1 + seed % 5 / 20))
    sw = (rng.random(co) * 1e-3 + 1e-4).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.5).astype(np.float32)
    return x, k, scale, sw, bias


def _jax_site(x, kq, s, sw, b):
    """The JAX package's conv_q up to the activation (abcnet_tpu/infer/
    quant.py:195-204)."""
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / s), -127,
                  127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(xq, kq, (1, 1), "SAME",
                                       dimension_numbers=_DN,
                                       preferred_element_type=jnp.int32)
    return xq, acc, acc.astype(jnp.float32) * (s * sw) + b


# As the package runs it, under jax.jit (s a traced scalar, as a bundle's
# scale is under jax.jit(forward_quant)).
_jax_site_jit = jax.jit(_jax_site)


def _ulp(v: np.ndarray, dtype: str) -> np.ndarray:
    """The last place of `dtype` (bf16 or f32) at each |v|."""
    frac = 7 if dtype == "bfloat16" else 23
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - frac)


@pytest.mark.parametrize("ci", [1, 16, 48])
@pytest.mark.parametrize("co", [16, 40])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_plain_matches_the_jax_site(ci, co, act, out):
    """Op by op, JAX's site and the plain chain round alike: bit-equal.
    Under jax.jit, XLA's CPU contracts the dequantize's multiply and add
    into one rounding (a fused multiply-add), which the chain on the card
    does not: the jitted outputs differ exactly where a fused multiply-add
    rounds otherwise, and nowhere else, by at most the rounding it skips
    (one f32 ulp of the product) and one ulp of the output type."""
    shape = {1: (2, 24, 24), 16: (1, 8, 8), 48: (2, 13, 17)}[ci]
    x, k, scale, sw, bias = _inputs(*shape, ci, co, seed=ci + co)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)

    def finish(y):
        return np.asarray(JAX_ACTS[act](jnp.asarray(y)).astype(out)
                          .astype(jnp.float32))

    seen = {}
    coef = scale * torch.from_numpy(sw)
    got = conv3x3_s8_plain(x, torch.from_numpy(k), scale, coef,
                           torch.from_numpy(bias), act, TORCH_DT[out],
                           rec=lambda xq, acc: seen.update(xq=xq, acc=acc))
    assert got.dtype == TORCH_DT[out] and got.shape == (*shape, co)
    got = got.float().numpy()
    assert (np.abs(seen["xq"].numpy().astype(int)) == 127).mean() > 0.005
    assert seen["acc"].dtype == torch.int32
    for site in (_jax_site, _jax_site_jit):
        jxq, jacc, _ = site(jx, jnp.asarray(k), scale, jnp.asarray(sw),
                            jnp.asarray(bias))
        np.testing.assert_array_equal(seen["xq"].numpy(), np.asarray(jxq))
        np.testing.assert_array_equal(seen["acc"].numpy(), np.asarray(jacc))

    eager = finish(_jax_site(jx, jnp.asarray(k), scale, jnp.asarray(sw),
                             jnp.asarray(bias))[2])
    np.testing.assert_array_equal(got.view(np.int32), eager.view(np.int32))

    jitted = finish(_jax_site_jit(jx, jnp.asarray(k), scale,
                                  jnp.asarray(sw), jnp.asarray(bias))[2])
    acc = seen["acc"].numpy().astype(np.float64)
    fused = finish((acc * coef.numpy().astype(np.float64) +
                    bias.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(jitted, fused)
    differ = got != jitted
    np.testing.assert_array_equal(differ, got != fused)
    # the one rounding the contraction skips (an f32 ulp of the product,
    # which cancellation against the bias can make large beside the sum)
    # and one ulp of the output type
    product = acc * coef.numpy().astype(np.float64)
    bound = _ulp(product, "float32") + _ulp(jitted, out)
    assert np.all(np.abs(got - jitted)[differ] <= bound[differ])


@pytest.mark.parametrize("ci,co", [(1, 16), (16, 16), (48, 40), (64, 8),
                                   (96, 24)])
def test_implicit_gemm_over_the_packed_layout_is_conv_int8(ci, co):
    rng = np.random.default_rng(ci * co)
    b, h, w = 2, 7, 10
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, ci),
                                       dtype=np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, (3, 3, ci, co),
                                       dtype=np.int8))
    packed = pack_weights(kq)
    chunks = -(-ci // 32)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == (chunks, 9, co, 32)
    assert not packed.reshape(chunks, 9, co, 32).permute(
        0, 3, 1, 2).reshape(chunks * 32, -1)[ci:].any()
    assert torch.equal(unpack_weights(packed, ci), kq)

    # the kernel's loop: chunk j, tap (dy, dx), rows = pixels shifted by
    # the tap in the zero-padded input, 32 channels a k-step
    xp = torch.zeros(b, h + 2, w + 2, chunks * 32, dtype=torch.int64)
    xp[:, 1:-1, 1:-1, :ci] = xq.long()
    acc = torch.zeros(b, h, w, co, dtype=torch.int64)
    for j in range(chunks):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            a = xp[:, dy:dy + h, dx:dx + w, 32 * j:32 * (j + 1)]
            acc += a @ packed[j, tap].long().t()
    assert torch.equal(acc, conv_int8(xq, kq).long())


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_wrapper_on_the_cpu_is_the_plain_chain(act, out):
    x, k, scale, sw, bias = _inputs(2, 9, 11, 40, 24, seed=3)
    coef = scale * torch.from_numpy(sw)
    bias = torch.from_numpy(bias)
    kq = torch.from_numpy(k)
    before = conv3x3_s8.launches
    got = conv3x3_s8(x, pack_weights(kq), scale, coef, bias, act,
                     TORCH_DT[out])
    assert conv3x3_s8.launches == before
    assert torch.equal(got, conv3x3_s8_plain(x, kq, scale, coef, bias, act,
                                             TORCH_DT[out]))


def test_wrapper_rejects_what_it_does_not_take():
    x, k, scale, sw, bias = _inputs(1, 6, 6, 16, 16, seed=1)
    w = pack_weights(torch.from_numpy(k))
    coef, bias = scale * torch.from_numpy(sw), torch.from_numpy(bias)
    with pytest.raises(TypeError):
        conv3x3_s8(x.half(), w, scale, coef, bias)
    with pytest.raises(ValueError):
        conv3x3_s8(x[0], w, scale, coef, bias)
    with pytest.raises(ValueError):                 # another C_in's layout
        conv3x3_s8(torch.cat([x, x, x], -1), w, scale, coef, bias)
    with pytest.raises(ValueError):                 # HWIO, not packed
        conv3x3_s8(x, torch.from_numpy(k), scale, coef, bias)
    with pytest.raises(ValueError):
        conv3x3_s8(x, w, scale, coef[:8], bias)
    with pytest.raises(TypeError):
        conv3x3_s8(x, w, torch.tensor(scale), coef, bias)
    with pytest.raises(TypeError):
        conv3x3_s8(x, w, 0.0, coef, bias)
    with pytest.raises(ValueError):
        conv3x3_s8(x, w, scale, coef, bias, act="gelu")
    with pytest.raises(TypeError):
        conv3x3_s8(x, w, scale, coef, bias, out_dtype=torch.int8)
    with pytest.raises(ValueError):
        pack_weights(torch.from_numpy(k).float())


@pytest.fixture(scope="module")
def bundle():
    torch.manual_seed(0)
    model = UNet().eval()
    masks = (np.random.default_rng(2).random((2, 32, 32, 1)) < 0.15).astype(
        np.float32)
    return quant.prepare_quant(model, masks), torch.from_numpy(masks)


def test_conv_sites_are_the_28_of_the_smoke_run(bundle):
    q, _ = bundle
    sites = list(quant.conv_sites(q))
    assert [key for key, _, _ in sites] == \
        [s[0] for s in chip_smoke.CONV_S8_SITES]
    for (key, site, (kq, sw, b)), (_, h, ci, co) in zip(
            sites, chip_smoke.CONV_S8_SITES):
        assert site in q["scales"] and tuple(kq.shape) == (3, 3, ci, co)
        assert site == ("y" if key.startswith("y:") else key)
    packed = quant.pack_bundle(q)
    for key, site, (kq, sw, b) in sites:
        w, coef = packed[key]
        assert torch.equal(unpack_weights(w, kq.shape[2]), kq)
        assert torch.equal(coef, q["scales"][site] * sw)
    # the bound the smoke run reckons for the 28 sites at batch 64
    total = sum(max(chip_smoke.conv_s8_bound_ms(
        64, h, ci, co, 4 if key.startswith("y:") else 2))
        for key, h, ci, co in chip_smoke.CONV_S8_SITES)
    assert total == pytest.approx(3.578, abs=5e-4)


def test_forward_quant_on_the_cpu_runs_the_plain_chain(bundle, monkeypatch):
    q, images = bundle

    def no_kernel(*a, **kw):
        raise AssertionError("conv3x3_s8 called on the CPU path")

    calls = []

    def counting_plain(*a, **kw):
        calls.append(a[0].shape)
        return conv3x3_s8_plain(*a, **kw)

    monkeypatch.setattr(quant, "conv3x3_s8", no_kernel)
    monkeypatch.setattr(quant, "conv3x3_s8_plain", counting_plain)
    before = conv_s8.conv3x3_s8.launches
    rec = {}
    out, y = quant.forward_quant(q, images, rec=rec)
    assert len(calls) == 28
    again, y2 = quant.forward_quant(q, images,
                                    packed=quant.pack_bundle(q))
    assert len(calls) == 56 and torch.equal(y, y2)
    for h in out:
        assert torch.equal(out[h], again[h])
    assert conv_s8.conv3x3_s8.launches == before
    keys = {key for key, _, _ in quant.conv_sites(q)}
    assert set(rec) == keys | {f"{n}.t" for n in ("up1", "up2", "up3")}
    layers = {key: layer for key, _, layer in quant.conv_sites(q)}
    for key, (xq, acc) in rec.items():
        assert xq.dtype == torch.int8 and acc.dtype == torch.int32
        if key in layers:
            assert torch.equal(acc, conv_int8(xq, layers[key][0])), key
