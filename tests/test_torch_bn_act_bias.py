"""The conv bias folded into the port's train-mode BatchNorm op
(abcnet_tpu_torch/ops/bn_act.py:bn_act with `conv_bias`, models/unet.py:
conv_bn_act) on the CPU, where it runs its plain version.

  * `bn_act_plain` with a conv bias against `bn_act_plain` on x + b made
    as a tensor of its own: y, batch statistics, dx, dweight and dbias
    bit-equal, and the conv bias gradient bit-equal to that chain's
    dx.sum((0, 2, 3)), for each activation, in f32 and bf16.
  * The card's train routing forced on the CPU (`_folds_conv_bias` true:
    the conv without its bias, the bias handed to bn_act at every
    BatchNorm) against the routing the card ran before (the bias-less
    conv, an explicit bias add, then bn_act without a bias): one training
    forward and backward of UNet and of its fused head bank, outputs,
    every gradient (the conv biases' too) and the running statistics bit
    for bit, 34 (27) bias hand-offs.
  * That routing in f32 against Flax's train-mode DoubleConv and OutConv
    (abcnet_tpu/models/unet.py:34-48, :108-121) on the same numpy inputs
    and the same dropout mask (see CONV_BIAS_GRAD_BOUND for the bias
    gradients).
  * The kernel entry points, bn_act and bn_act_plain raise on a conv bias
    of the wrong length or type; the entry points raise on a CPU tensor
    too, and launch nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from abcnet_tpu.models.unet import DoubleConv as FlaxDoubleConv
from abcnet_tpu.models.unet import OutConv as FlaxOutConv
from abcnet_tpu_torch.models import unet
from abcnet_tpu_torch.models.unet import UNet
from abcnet_tpu_torch.ops import bn_act as ops
from abcnet_tpu_torch.ops.bn_act import ACTS, bn_act, bn_act_plain
from torch_parity import ink_images

EPS = 1e-5
DTYPES = [torch.float32, torch.bfloat16]
# Against Flax in f32: outputs and dx within tests/test_torch_model.py's
# 1e-4, the running statistics within tests/test_torch_trainer.py's 1e-5
# + 1e-4 relative, the conv weight and BatchNorm gradients 1e-4 relative
# L2 (only the order of f32 sums differs, over at most 2 * 12 * 12 * 9 * 8
# terms).
ATOL, STAT_ATOL, STAT_RTOL, GRAD_REL = 1e-4, 1e-5, 1e-4, 1e-4
# The conv bias gradient through a batch-statistics BatchNorm is 0 in
# exact arithmetic (a per-channel shift of the conv output moves the batch
# mean by the same amount), so each package returns rounding residue and
# a relative comparison is meaningless. Each side sums the n = N*H*W f32
# gradients of a channel: a recursive, pairwise or blocked sum is within
# (n - 1) * u * sum|terms| of the exact sum of its terms (Higham, Accuracy
# and Stability of Numerical Algorithms, 4.2; u = 2^-24), and each term is
# within a few u of its exact value, whose channel sum is 0. So each side
# is within (n + c) * u * sum|dx| of 0, c a small constant, and the two
# within twice that; the bound takes 4 * n * u * sum|dx| per channel.
U32 = 2.0 ** -24


def CONV_BIAS_GRAD_BOUND(dx_nchw):
    n = dx_nchw.shape[0] * dx_nchw.shape[2] * dx_nchw.shape[3]
    return 4 * n * U32 * np.abs(dx_nchw).sum(axis=(0, 2, 3))


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.7, 2.0, shape).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    c = shape[1]
    w = np.linspace(0.5, 1.5, c).astype(np.float32)
    b = np.linspace(-1.0, 1.0, c).astype(np.float32)
    cb = rng.normal(0.0, 1.5, c).astype(np.float32)
    return x, dy, w, b, cb


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_plain_with_conv_bias_is_the_add_then_the_chain(act, dtype):
    x, dy, w, b, cb = _inputs((2, 6, 9, 11))
    cl = torch.channels_last

    def leaves():
        return (torch.from_numpy(x).to(dtype, memory_format=cl),
                torch.from_numpy(w).requires_grad_(True),
                torch.from_numpy(b).requires_grad_(True))

    dyt = torch.from_numpy(dy).to(dtype, memory_format=cl)
    want = []
    xt, wt, bt = leaves()
    cbt = torch.from_numpy(cb).to(dtype)
    xb = (xt + cbt[:, None, None]).requires_grad_(True)
    y, mean, var = bn_act_plain(xb, wt, bt, EPS, act)
    y.backward(dyt)
    want = (y, mean, var, xb.grad, wt.grad, bt.grad,
            xb.grad.sum((0, 2, 3)))
    for fn in (bn_act_plain, bn_act):           # bn_act: plain on the CPU
        xt, wt, bt = leaves()
        xt.requires_grad_(True)
        cbt = torch.from_numpy(cb).to(dtype).requires_grad_(True)
        y, mean, var = fn(xt, wt, bt, EPS, act, None, cbt)
        y.backward(dyt)
        got = (y, mean, var, xt.grad, wt.grad, bt.grad, cbt.grad)
        names = ("y", "mean", "var", "dx", "dweight", "dbias", "dconv_bias")
        for name, g, v in zip(names, got, want):
            assert g.dtype == v.dtype and torch.equal(g, v), (fn, name)
    assert cbt.grad.dtype == dtype


def _random_model(name, dtype, seed):
    torch.manual_seed(seed)
    model = UNet(dtype=dtype, fused_head_bank=name == "fused_bank")
    with torch.no_grad():                  # biases that move the statistics
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.5)
    return model.train()


def old_card_train_conv_bn_act(conv, bn, x, act, dtype):
    """The train routing as the card ran it before the fold: ATen adds a
    cuDNN convolution's bias in a pass of its own, then bn_act."""
    y = unet._conv(conv, x, dtype, bias=False)
    return bn.act(y + conv.bias.to(dtype)[:, None, None], act, dtype)


def _train_step(model, x):
    out = model(x, generator=torch.Generator().manual_seed(7))
    sum(v.float().square().mean() for v in out.values()).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return out, grads, {n: t.clone() for n, t in model.named_buffers()}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["unet", "fused_bank"])
def test_card_train_routing_on_the_cpu(name, dtype, monkeypatch):
    x = torch.from_numpy(ink_images(2, 64, seed=21)).to(dtype)
    handed = []
    real = unet.bn_act

    def recording(xx, weight, bias, eps, act, group=None, conv_bias=None):
        handed.append(conv_bias is not None and
                      conv_bias.shape == (xx.shape[1],) and
                      conv_bias.requires_grad)
        return real(xx, weight, bias, eps, act, group, conv_bias)

    monkeypatch.setattr(unet, "_folds_conv_bias", lambda bn, xx: True)
    monkeypatch.setattr(unet, "bn_act", recording)
    got = _train_step(_random_model(name, dtype, seed=4), x)
    assert handed == [True] * (27 if name == "fused_bank" else 34)
    monkeypatch.undo()
    monkeypatch.setattr(unet, "conv_bn_act", old_card_train_conv_bn_act)
    want = _train_step(_random_model(name, dtype, seed=4), x)
    conv_biases = [k for k in want[1] if k.endswith(".bias")
                   and k.replace(".bias", ".weight") in want[1]
                   and want[1][k.replace(".bias", ".weight")].dim() == 4]
    assert len(conv_biases) > 34
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def _flax_train(module, params, stats, x, dy, mask=None):
    """(y, dx, param gradients, updated batch_stats) of a Flax block in
    train mode; the dropout mask `mask` (NHWC) replaces flax's own."""
    def dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            return args[0] * mask
        return next_fun(*args, **kwargs)

    def f(xx, p):
        with nn.intercept_methods(dropout):
            return module.apply({"params": p, "batch_stats": stats}, xx,
                                train=True, mutable=["batch_stats"])

    y, vjp, upd = jax.vjp(f, jnp.asarray(x), params, has_aux=True)
    dx, dp = vjp(jnp.asarray(dy))
    return (np.asarray(y), np.asarray(dx),
            jax.tree_util.tree_map(np.asarray, dp),
            jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("block", ["DoubleConv", "OutConv"])
def test_card_train_routing_matches_flax(block, monkeypatch):
    rng = np.random.default_rng(31)
    c_in, feat, out = (4, 8, None) if block == "DoubleConv" else (8, 8, 3)
    x = rng.normal(0.3, 1.0, (2, c_in, 12, 12)).astype(np.float32)
    if block == "DoubleConv":
        flax_block = FlaxDoubleConv(feat, dtype=jnp.float32)
        port = unet.DoubleConv(c_in, feat)
        pairs = [("Conv_0", "BatchNorm_0", port.conv0, port.bn0),
                 ("Conv_1", "BatchNorm_1", port.conv1, port.bn1)]
        dy = rng.normal(size=(2, feat, 12, 12)).astype(np.float32)
    else:
        flax_block = FlaxOutConv(c_in, out, dtype=jnp.float32)
        port = unet.OutConv(c_in, out)
        pairs = [("Conv_0", "BatchNorm_0", port.conv0, port.bn0)]
        dy = rng.normal(size=(2, out, 12, 12)).astype(np.float32)
    variables = flax_block.init(jax.random.PRNGKey(0), _nhwc(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    with torch.no_grad():
        for conv_name, bn_name, conv, bn in pairs:
            k = rng.normal(0.0, 0.3, params[conv_name]["kernel"].shape)
            cb = rng.normal(0.0, 1.0, params[conv_name]["bias"].shape)
            scale = rng.uniform(0.5, 1.5, params[bn_name]["scale"].shape)
            shift = rng.normal(0.0, 0.3, params[bn_name]["bias"].shape)
            mean = rng.normal(0.0, 0.5, stats[bn_name]["mean"].shape)
            var = rng.uniform(0.5, 2.0, stats[bn_name]["var"].shape)
            params[conv_name] = {"kernel": k.astype(np.float32),
                                 "bias": cb.astype(np.float32)}
            params[bn_name] = {"scale": scale.astype(np.float32),
                               "bias": shift.astype(np.float32)}
            stats[bn_name] = {"mean": mean.astype(np.float32),
                              "var": var.astype(np.float32)}
            conv.weight.copy_(torch.from_numpy(
                params[conv_name]["kernel"].transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(params[conv_name]["bias"]))
            bn.weight.copy_(torch.from_numpy(params[bn_name]["scale"]))
            bn.bias.copy_(torch.from_numpy(params[bn_name]["bias"]))
            bn.running_mean.copy_(torch.from_numpy(stats[bn_name]["mean"]))
            bn.running_var.copy_(torch.from_numpy(stats[bn_name]["var"]))
        if block == "OutConv":
            k1 = rng.normal(0.0, 0.3, params["Conv_1"]["kernel"].shape)
            params["Conv_1"] = {"kernel": k1.astype(np.float32),
                                "bias": rng.normal(0.0, 0.3, out)
                                .astype(np.float32)}
            port.conv1.weight.copy_(torch.from_numpy(
                params["Conv_1"]["kernel"].transpose(3, 2, 0, 1).copy()))
            port.conv1.bias.copy_(torch.from_numpy(params["Conv_1"]["bias"]))
    keep = (rng.random((2, feat, 12, 12)) >= unet.OutConv.DROP)
    mask = (keep / (1 - unet.OutConv.DROP)).astype(np.float32)    # 0, 1.25
    y_j, dx_j, dp_j, stats_j = _flax_train(flax_block, params, stats,
                                           _nhwc(x), _nhwc(dy), _nhwc(mask))

    handed = []
    real = unet.bn_act

    def recording(xx, *rest):
        # xx: the conv output without its bias; its gradient is the
        # BatchNorm's input gradient, whose channel sums are the conv
        # bias gradient
        xx.retain_grad()
        handed.append((xx, rest[-1] is not None))
        return real(xx, *rest)

    monkeypatch.setattr(unet, "_folds_conv_bias", lambda bn, xx: True)
    monkeypatch.setattr(unet, "bn_act", recording)
    monkeypatch.setattr(unet, "_dropout",
                        lambda t, training, gen: t * torch.from_numpy(mask))
    port.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt, torch.float32)
    y.backward(torch.from_numpy(dy))
    assert [h for _, h in handed] == [True] * len(pairs)

    np.testing.assert_allclose(y.detach().numpy(), _nchw(y_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), _nchw(dx_j), rtol=0,
                               atol=ATOL)
    for conv_name, bn_name, conv, bn in pairs:
        want_k = dp_j[conv_name]["kernel"].transpose(3, 2, 0, 1)
        assert _rel_l2(conv.weight.grad.numpy(), want_k) <= GRAD_REL
        assert _rel_l2(bn.weight.grad.numpy(), dp_j[bn_name]["scale"]) \
            <= GRAD_REL
        assert _rel_l2(bn.bias.grad.numpy(), dp_j[bn_name]["bias"]) \
            <= GRAD_REL
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   stats_j[bn_name]["mean"], rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=bn_name)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   stats_j[bn_name]["var"], rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=bn_name)
    for (conv_name, _, conv, _), (bn_in, _) in zip(pairs, handed):
        bound = CONV_BIAS_GRAD_BOUND(bn_in.grad.numpy())
        diff = np.abs(conv.bias.grad.numpy() - dp_j[conv_name]["bias"])
        assert (diff <= bound).all(), (conv_name, diff, bound)


KERNEL_ARGS = {
    "stats": lambda x, v, st: (x, 1e-5),
    "apply": lambda x, v, st: (x, st, v, v, "relu"),
    "grad_sums": lambda x, v, st: (x, x, st, v, v, "relu"),
    "grad_apply": lambda x, v, st: (x, x, st, v, v, st[:2], 0.5, "relu"),
}


@pytest.mark.parametrize("bad", ["cpu", "length", "type"])
@pytest.mark.parametrize("kernel", sorted(KERNEL_ARGS))
def test_kernel_entry_points_raise_on_a_bad_conv_bias(kernel, bad):
    x = torch.zeros(2, 3, 4, 4).contiguous(memory_format=torch.channels_last)
    v, st = torch.zeros(3), torch.zeros(3, 3)
    cb, exc, match = {"cpu": (torch.zeros(3), ValueError, "device"),
                      "length": (torch.zeros(4), ValueError, "conv_bias"),
                      "type": (torch.zeros(3, dtype=torch.bfloat16),
                               TypeError, "conv_bias")}[bad]
    fn = getattr(ops, kernel)
    before = fn.launches
    with pytest.raises(exc, match=match):
        fn(*KERNEL_ARGS[kernel](x, v, st), conv_bias=cb)
    assert fn.launches == before


@pytest.mark.parametrize("bad", ["length", "type"])
@pytest.mark.parametrize("fn", [bn_act, bn_act_plain],
                         ids=["bn_act", "bn_act_plain"])
def test_the_op_raises_on_a_bad_conv_bias(fn, bad):
    x = torch.zeros(2, 3, 4, 4)
    cb, exc = {"length": (torch.zeros(4), ValueError),
               "type": (torch.zeros(3, dtype=torch.float64), TypeError)}[bad]
    with pytest.raises(exc, match="conv_bias"):
        fn(x, torch.ones(3), torch.zeros(3), 1e-5, "relu", None, cb)
