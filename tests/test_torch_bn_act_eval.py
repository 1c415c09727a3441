"""The port's eval-mode conv bias -> BatchNorm -> activation -> cast
(abcnet_tpu_torch/ops/bn_act.py:bn_act_eval, models/unet.py:conv_bn_act)
on the CPU, where it runs its plain version.

  * `bn_act_eval_plain` against the chain it replaced in models/unet.py
    (the conv with its bias -> .float() -> F.batch_norm(training=False)
    -> the activation -> .to(dtype)): bit-equal for each activation, in
    f32 and bf16, channels_last and contiguous. With the bias handed to
    it instead (what the card runs) it is the chain of the conv without
    bias followed by the bias add, as ATen runs a cuDNN convolution.
  * The eval forwards of UNet, its fused head bank, UNetS2D and UNetCBAM
    under the new routing, bit-equal to the same weights through the old
    chain, f32 and bf16; with the bias folded as on the card, bit-equal
    to the old chain as the card ran it (the conv without its bias, then
    the bias add).
  * A train-mode forward and backward: bit-equal to the old routing, the
    conv still adds its bias, one train-mode `bn_act` a BatchNorm.
  * The port's eval forward against the JAX package's Flax UNet on the
    snapshot's weights, seeded numpy masks, f32, within
    tests/test_torch_model.py's 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from abcnet_tpu.models.unet import UNet as FlaxUNet
from abcnet_tpu_torch.infer.decode import DENSE_HEADS_SPARSE_MODE
from abcnet_tpu_torch.models import unet, unet_cbam
from abcnet_tpu_torch.models.unet import UNet
from abcnet_tpu_torch.models.unet_cbam import UNetCBAM
from abcnet_tpu_torch.models.unet_s2d import UNetS2D
from abcnet_tpu_torch.ops.bn_act import (ACTS, activation, bn_act_eval,
                                         bn_act_eval_plain)
from torch_parity import flax_variables, ink_images, torch_model

EPS = 1e-5
ATOL = 1e-4                 # tests/test_torch_model.py's f32 tolerance
LAYOUTS = {"channels_last": torch.channels_last,
           "contiguous": torch.contiguous_format}


def old_chain(bn, x, act, dtype):
    """BatchNorm.act's eval branch before bn_act_eval."""
    out = F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                       bn.weight, bn.bias, False, 0.0, bn.eps)
    return activation(act)(out).to(dtype)


def old_conv_bn_act(conv, bn, x, act, dtype):
    """The conv with its bias, then the old eval chain or bn_act."""
    y = unet._conv(conv, x, dtype)
    if bn.training:
        return bn.act(y, act, dtype)
    return old_chain(bn, y, act, dtype)


@pytest.fixture
def old_routing(monkeypatch):
    """Runs the models as they ran before conv_bn_act."""
    def use():
        monkeypatch.setattr(unet, "conv_bn_act", old_conv_bn_act)
        monkeypatch.setattr(unet_cbam, "conv_bn_act", old_conv_bn_act)
    return use


def _conv_inputs(dtype, fmt, seed=0):
    rng = np.random.default_rng(seed)
    c_in, c = 8, 12

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32))

    inp = t(2, c_in, 16, 16).to(dtype, memory_format=LAYOUTS[fmt])
    w, b = t(c, c_in, 3, 3, scale=0.2).to(dtype), t(c, scale=0.5).to(dtype)
    stats = (t(c, scale=0.5), t(c).abs() + 0.05, t(c, scale=0.2, shift=1.0),
             t(c, scale=0.3))
    return inp, w, b, stats


@pytest.mark.parametrize("fmt", sorted(LAYOUTS))
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_chain(dtype, act, fmt):
    inp, w, b, (rm, rv, g, be) = _conv_inputs(dtype, fmt)
    bn = torch.nn.BatchNorm2d(len(b), EPS).eval()
    bn.running_mean.copy_(rm)
    bn.running_var.copy_(rv)
    with torch.no_grad():
        bn.weight.copy_(g)
        bn.bias.copy_(be)
    args = (rm, rv, g, be, EPS, act, dtype)
    with torch.no_grad():
        conv = F.conv2d(inp, w, b, padding=1)
        want = old_chain(bn, conv, act, dtype)
        got = bn_act_eval_plain(conv, None, *args)
        assert torch.equal(got, want)
        assert got.stride() == want.stride() == conv.stride()
        assert torch.equal(bn_act_eval(conv, None, *args), want)
        # the bias handed over, as on the card: the chain of the conv
        # without its bias, then the bias add in the conv's type
        bare = F.conv2d(inp, w, None, padding=1)
        folded = bn_act_eval_plain(bare, b, *args)
        assert torch.equal(folded, old_chain(bn, bare + b[:, None, None],
                                             act, dtype))
        assert folded.stride() == bare.stride()
    g_in = conv.detach().requires_grad_(True)
    bn_act_eval_plain(g_in, None, *args).float().sum().backward()
    assert g_in.grad is not None and g_in.grad.isfinite().all()


def _random_model(name, dtype, seed=0):
    torch.manual_seed(seed)
    model = {"unet": lambda: UNet(dtype=dtype),
             "fused_bank": lambda: UNet(dtype=dtype, fused_head_bank=True),
             "s2d": lambda: UNetS2D(dtype=dtype),
             "cbam": lambda: UNetCBAM(dtype=dtype)}[name]()
    gen = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, unet.BatchNorm):
            m.running_mean.normal_(0.0, 0.3, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.eval()


def _eval_forwards(model, x):
    with torch.no_grad():
        out = dict(model(x))
        heads, feats = model(x, dense_heads=DENSE_HEADS_SPARSE_MODE,
                             return_features=True)
        out.update({f"sparse/{k}": v for k, v in heads.items()},
                   features=feats)
    return out


def _assert_equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["unet", "fused_bank", "s2d", "cbam"])
def test_eval_forward_is_the_old_chain(name, dtype, old_routing):
    model = _random_model(name, dtype)
    x = torch.from_numpy(ink_images(1, 128, seed=11)).to(dtype)
    got = _eval_forwards(model, x)
    old_routing()
    _assert_equal_dicts(got, _eval_forwards(model, x))


def old_card_conv_bn_act(conv, bn, x, act, dtype):
    """The old eval chain as the card ran it: ATen adds a cuDNN
    convolution's bias in a pass of its own."""
    y = unet._conv(conv, x, dtype, bias=False)
    return old_chain(bn, y + conv.bias.to(dtype)[:, None, None], act, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["unet", "fused_bank"])
def test_card_routing_on_the_cpu(name, dtype, monkeypatch):
    """The routing the card takes (the conv without its bias, the bias
    handed to bn_act_eval at every BatchNorm), run with the plain op on
    the CPU, is the old chain as the card ran it, bit for bit."""
    model = _random_model(name, dtype, seed=3)
    x = torch.from_numpy(ink_images(1, 128, seed=12)).to(dtype)
    handed = []

    def recording(xx, conv_bias, *rest):
        handed.append(conv_bias is not None and xx.shape[1] ==
                      conv_bias.shape[0])
        return bn_act_eval(xx, conv_bias, *rest)

    monkeypatch.setattr(unet, "_folds_conv_bias",
                        lambda bn, xx: not bn.training)
    monkeypatch.setattr(unet, "bn_act_eval", recording)
    got = _eval_forwards(model, x)
    per_forward = 27 if name == "fused_bank" else 34
    assert handed == [True] * (per_forward + (27 if name == "fused_bank"
                                              else 28))
    monkeypatch.undo()
    monkeypatch.setattr(unet, "conv_bn_act", old_card_conv_bn_act)
    _assert_equal_dicts(got, _eval_forwards(model, x))


def test_train_forward_backward_unchanged(old_routing, monkeypatch):
    """Train mode: the conv adds its bias and bn_act runs as before (one
    call a BatchNorm), outputs, gradients and running statistics
    bit-equal to the old routing."""
    calls = []
    real = unet.bn_act

    def counting(x, *rest):
        calls.append(x.dtype)
        return real(x, *rest)

    monkeypatch.setattr(unet, "bn_act", counting)

    def step():
        model = _random_model("unet", torch.bfloat16, seed=5).train()
        x = torch.from_numpy(ink_images(2, 64, seed=13)).to(torch.bfloat16)
        out = model(x, generator=torch.Generator().manual_seed(7))
        sum(v.float().square().mean() for v in out.values()).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return out, grads, {n: b.clone() for n, b in model.named_buffers()}

    got = step()
    assert calls == [torch.bfloat16] * 34
    old_routing()
    want = step()
    for a, b in zip(got, want):
        _assert_equal_dicts(a, b)


@pytest.mark.parametrize("routing", ["cpu", "card"])
def test_eval_forward_matches_flax(routing, monkeypatch):
    params, stats = flax_variables("snapshot")
    x = ink_images(2, 128, seed=3)
    heads, feats = FlaxUNet(dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, x, train=False,
        return_features=True)
    if routing == "card":
        monkeypatch.setattr(unet, "_folds_conv_bias",
                            lambda bn, xx: not bn.training)
    model = torch_model(params, stats)
    with torch.no_grad():
        got, got_feats = model(torch.from_numpy(x), return_features=True)
    assert sorted(got) == sorted(heads)
    for k in heads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(heads[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got_feats.numpy(), np.asarray(feats),
                               rtol=0, atol=ATOL)
