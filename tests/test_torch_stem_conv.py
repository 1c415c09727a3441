"""The CBAM U-Net's stem sites as one op (ops/stem_conv.py), on the CPU:

  * `stem_conv_bn_act_eval_plain`, and the op routed on the CPU, are the
    chain `conv_bn_act` runs there for an eval-mode site (the conv with
    its bias, then bn_act_eval_plain), bit for bit: 1 and 32 input
    channels, relu and none, bf16, at 128² and at a ragged side; and
    where models/unet.py:_folds_conv_bias hands the bias to the BatchNorm
    (as on a GPU), the plain op follows it as conv_bn_act does;
  * an eval-mode bf16 UNetCBAM, whose four 5x5 sites now call the op,
    gives the heads and features of the forward before it, bit for bit,
    through 4 calls of the op a forward, and a profiled forward counts 4
    `stem_sites` and 4 `stem` spans, and no `stem_fused` (no kernel runs
    on the CPU);
  * train mode and f32 never call the op;
  * the op raises on a kernel other than 5x5 and on a device it does not
    take, and on the CPU stays differentiable (the chain under autograd);
  * the benchmark's readers: `stem_conv_ms` from the counter
    `stem_device_us`, `stem_conv_roofline_pct` against the four sites'
    2.936 ms bound at batch 64, nothing where the counter is missing or a
    batch ran other than 4 sites.

The kernel itself runs only on the card: tests/test_torch_stem_conv_cuda.py.
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from abcnet_tpu_torch.infer.decode import DENSE_HEADS_SPARSE_MODE
from abcnet_tpu_torch.models import unet, unet_cbam
from abcnet_tpu_torch.models.unet import (BN_EPS, BN_MOMENTUM, BatchNorm,
                                          _conv, conv_bn_act)
from abcnet_tpu_torch.models.unet_cbam import DoubleConvCBAM, UNetCBAM
from abcnet_tpu_torch.ops.stem_conv import (stem_conv_bn_act_eval,
                                            stem_conv_bn_act_eval_plain)
from abcnet_tpu_torch.utils import profiling
from torch_parity import REPO

BF16 = torch.bfloat16


def _site(c_in, h, w, seed=0):
    """A 5x5 conv to 32 channels and an eval BatchNorm with moved
    statistics, and a channels_last bf16 input (a binary drawing for one
    channel, a ReLU output for 32)."""
    gen = torch.Generator().manual_seed(seed)
    conv = torch.nn.Conv2d(c_in, 32, 5, padding=2)
    bn = BatchNorm(32, BN_EPS, BN_MOMENTUM).eval()
    with torch.no_grad():
        conv.weight.normal_(0.0, (2 / (25 * c_in)) ** 0.5, generator=gen)
        conv.bias.normal_(0.0, 0.1, generator=gen)
        bn.running_mean.normal_(0.0, 0.3, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
        bn.weight.normal_(1.0, 0.2, generator=gen)
        bn.bias.normal_(0.0, 0.1, generator=gen)
    if c_in == 1:
        x = (torch.rand(1, 1, h, w, generator=gen) < 0.1).to(BF16)
    else:
        x = torch.randn(1, c_in, h, w, generator=gen).relu().to(BF16)
    return conv, bn, x.contiguous(memory_format=torch.channels_last)


def _args(conv, bn, x, act):
    return (x, conv.weight, conv.bias, bn.running_mean, bn.running_var,
            bn.weight, bn.bias, bn.eps, act)


@pytest.mark.parametrize("h,w", [(128, 128), (37, 53)])
@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("c_in", [1, 32])
def test_plain_is_conv_bn_acts_chain(c_in, act, h, w):
    conv, bn, x = _site(c_in, h, w)
    with torch.no_grad():
        want = conv_bn_act(conv, bn, x, act, BF16)
        got = stem_conv_bn_act_eval_plain(*_args(conv, bn, x, act))
        routed = stem_conv_bn_act_eval(*_args(conv, bn, x, act))
    assert got.dtype == want.dtype == BF16
    assert got.shape == (1, 32, h, w)
    assert torch.equal(got, want) and torch.equal(routed, want)


@pytest.mark.parametrize("h,w", [(128, 128), (37, 53)])
@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("c_in", [1, 32])
def test_plain_follows_the_bias_fold(monkeypatch, c_in, act, h, w):
    """With the bias handed to the BatchNorm (the GPU's routing) the plain
    op is conv_bn_act's chain still, and no longer the CPU's: the rule
    lives in _folds_conv_bias alone."""
    conv, bn, x = _site(c_in, h, w)
    with torch.no_grad():
        unfolded = stem_conv_bn_act_eval_plain(*_args(conv, bn, x, act))
        monkeypatch.setattr(unet, "_folds_conv_bias", lambda bn, x: True)
        want = conv_bn_act(conv, bn, x, act, BF16)
        got = stem_conv_bn_act_eval_plain(*_args(conv, bn, x, act))
    assert torch.equal(got, want)
    assert not torch.equal(got, unfolded)


def _old_forward(self, x, dtype):
    """DoubleConvCBAM.forward before the op: conv_bn_act at every site."""
    y = conv_bn_act(self.conv0, self.bn0, x, "relu", dtype)
    y = conv_bn_act(self.conv1, self.bn1, y, "none", dtype)
    res = _conv(self.conv2, x, dtype) if hasattr(self, "conv2") \
        else x.to(dtype)
    with profiling.device_span("cbam", y):
        profiling.count("cbam_gates", 1)
        if not self.training:
            return unet_cbam.cbam_gate_eval(y, res, *self.cbam.weights(),
                                            dtype)
        return torch.relu(self.cbam(y, dtype) + res)


def _model(dtype):
    torch.manual_seed(0)
    model = UNetCBAM(dtype=dtype)
    gen = torch.Generator().manual_seed(1)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.normal_(0.0, 0.3, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model


def _counting(monkeypatch):
    calls = []

    def counted(*args):
        calls.append((args[0].shape[1], args[-1]))
        return stem_conv_bn_act_eval(*args)

    monkeypatch.setattr(unet_cbam, "stem_conv_bn_act_eval", counted)
    return calls


def _images(n, side, seed, dtype):
    return (torch.rand(n, side, side, 1,
                       generator=torch.Generator().manual_seed(seed))
            < 0.1).to(dtype)


def test_eval_model_through_the_op_is_the_old_forward(monkeypatch):
    model = _model(BF16).eval()
    images = _images(1, 64, 2, BF16)
    calls = _counting(monkeypatch)

    def forwards():
        with torch.no_grad():
            out = dict(model(images))
            heads, feats = model(images, dense_heads=DENSE_HEADS_SPARSE_MODE,
                                 return_features=True)
        out.update({f"sparse/{k}": v for k, v in heads.items()},
                   features=feats)
        return out

    got = forwards()
    assert calls == [(1, "relu"), (32, "none"), (32, "relu"),
                     (32, "none")] * 2
    monkeypatch.setattr(DoubleConvCBAM, "forward", _old_forward)
    want = forwards()
    assert len(calls) == 8
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _profiled_forward():
    """The batch id of one profiled eval forward of the bf16 model."""
    model = _model(BF16).eval()
    images = _images(1, 32, 4, BF16)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        bid = profiling.start_batch()
        with profiling.batch(bid):
            model(images)
    return bid


def test_profiled_forward_counts_the_sites():
    bid = _profiled_forward()
    counters = profiling.counters()[bid]
    spans = [s for s in profiling.spans() if s.name == "stem"]
    profiling.clear()
    assert counters["stem_sites"] == 4 and counters["cbam_gates"] == 13
    # the CPU's sites are the plain chain: the kernel's counter stays out
    assert "stem_fused" not in counters
    assert len(spans) == 4


def test_benchmark_readers():
    sys.path.insert(0, REPO)
    try:
        from benchmark import harness
    finally:
        sys.path.remove(REPO)
    cfg = harness.load_json(os.path.join(REPO, "benchmark", "configs",
                                         "unet_cbam_bf16.json"))
    ms = harness.metric_reader("stem_conv_ms")
    roof = harness.metric_reader("stem_conv_roofline_pct")
    obs = SimpleNamespace(cfg=cfg, traffic={"batch": 64})
    assert [k for *_, k in roof.sites(cfg)] == [32] * 4
    assert round(roof.bound_s(cfg, 64) * 1e3, 3) == 2.936
    profiling.clear()
    assert ms.read(obs) is None and roof.read(obs) is None
    bid = _profiled_forward()
    # no kernel on the CPU, so no device time: nothing to read
    assert ms.read(obs) is None and roof.read(obs) is None
    profiling.RECORDER.count(bid, "stem_device_us", 5_872)
    assert ms.read(obs) == 5.872
    assert abs(roof.read(obs) - 100 * 2.936178640 / 5.872) < 1e-6
    profiling.RECORDER.count(bid, "stem_sites", -1)
    assert ms.read(obs) == 5.872 and roof.read(obs) is None
    profiling.clear()


@pytest.mark.parametrize("dtype,train", [(BF16, True),
                                         (torch.float32, True),
                                         (torch.float32, False)])
def test_train_mode_and_f32_never_call_the_op(dtype, train, monkeypatch):
    model = _model(dtype).train(train)
    calls = _counting(monkeypatch)
    images = _images(2, 32, 3, dtype)
    out = model(images)
    if train:
        sum(v.float().square().mean() for v in out.values()).backward()
        assert all(p.grad is not None for p in model.inc1.parameters())
    assert calls == []


def test_op_raises_where_it_cannot_run():
    conv, bn, x = _site(32, 8, 8)
    args = _args(conv, bn, x, "relu")
    three = torch.nn.Conv2d(32, 32, 3, padding=1)
    with pytest.raises(ValueError, match="5x5"):
        stem_conv_bn_act_eval(x, three.weight, three.bias, *args[3:])
    with pytest.raises(ValueError, match="unsupported device"):
        stem_conv_bn_act_eval(x.to("meta"), *args[1:])
    with pytest.raises(ValueError, match="act"):
        stem_conv_bn_act_eval(*args[:-1], "gelu")
    # under autograd the CPU path is the differentiable chain
    xg = x.float().requires_grad_(True)
    out = stem_conv_bn_act_eval(xg, *args[1:])
    out.float().sum().backward()
    assert xg.grad is not None and xg.grad.isfinite().all()

