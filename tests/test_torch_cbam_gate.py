"""The CBAM gate of the port's CBAM U-Net as one op (ops/cbam_gate.py), on
the CPU:

  * `cbam_gate_eval_plain` is the modules' chain (models/unet_cbam.py:
    CBAM, then the residual add and relu of DoubleConvCBAM.forward), bit
    for bit, at three site shapes, bf16 and f32, with and without a
    residual conv in front;
  * an eval-mode UNetCBAM, whose sites now call `cbam_gate_eval`, gives
    the heads and features of the forward before it (the modules' chain
    at every site), bit for bit, through 13 calls of the op a forward;
  * a train-mode forward and backward never call the op;
  * the kernels' plan covers each site of the configuration and the
    ragged sides the card tests use;
  * the op raises on a device it does not take, and on the CPU stays
    differentiable (the chain under autograd);
  * `mean_factor` is the factor ATen's mean multiplies its f32 sum by.

The kernels themselves run only on the card:
tests/test_torch_cbam_gate_cuda.py.
"""

import pytest
import torch
import torch.nn.functional as F

from abcnet_tpu_torch.infer.decode import DENSE_HEADS_SPARSE_MODE
from abcnet_tpu_torch.models import unet_cbam
from abcnet_tpu_torch.models.unet import BatchNorm, _conv, conv_bn_act
from abcnet_tpu_torch.models.unet_cbam import CBAM, DoubleConvCBAM, UNetCBAM
from abcnet_tpu_torch.ops import cbam_gate
from abcnet_tpu_torch.ops.cbam_gate import (cbam_gate_eval,
                                            cbam_gate_eval_plain, plan)

# (C, H) of three sites: the stem's width at a reduced side, the
# encoder's widest, a decoder width; with (conv) and without (identity) a
# residual conv
SITES = [(32, 64, "conv"), (512, 4, "identity"), (128, 16, "conv")]
# (block, C, H = W) of the configuration's 13 sites at 512²
ALL_SITES = [("inc1", 32, 512), ("inc2", 32, 512), ("down1", 32, 256),
             ("down2", 64, 128), ("inc3", 64, 128), ("down3", 128, 64),
             ("down4", 256, 32), ("down5", 512, 16), ("up1", 256, 32),
             ("up2", 128, 64), ("up3", 128, 128), ("dconv1", 128, 128),
             ("dconv2", 128, 128)]


def _site(c, h, residual, dtype, seed=0):
    """A CBAM module of width c with random weights, its gated input y and
    the residual (a 1x1 conv of a block input, or the input itself)."""
    torch.manual_seed(seed)
    cbam = CBAM(c)
    for p in cbam.parameters():
        p.data.normal_(0.0, 0.5)
    y = torch.randn(2, c, h, h).to(dtype)
    x = torch.randn(2, c, h, h)
    if residual == "conv":
        res = _conv(torch.nn.Conv2d(c, c, 1), x, dtype)
    else:
        res = x.to(dtype)
    return cbam, y, res


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h,residual", SITES)
def test_plain_is_the_modules_chain(c, h, residual, dtype):
    cbam, y, res = _site(c, h, residual, dtype)
    with torch.no_grad():
        want = F.relu(cbam(y, dtype) + res)
        got = cbam_gate_eval_plain(y, res, *cbam.weights(), dtype)
        routed = cbam_gate_eval(y, res, *cbam.weights(), dtype)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want) and torch.equal(routed, want)


def _old_forward(self, x, dtype):
    """DoubleConvCBAM.forward before the op: the modules' chain at every
    site, in both modes."""
    y = conv_bn_act(self.conv0, self.bn0, x, "relu", dtype)
    y = conv_bn_act(self.conv1, self.bn1, y, "none", dtype)
    res = _conv(self.conv2, x, dtype) if hasattr(self, "conv2") \
        else x.to(dtype)
    return F.relu(self.cbam(y, dtype) + res)


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
        calls.append(args[0].shape)
        return cbam_gate_eval(*args)

    monkeypatch.setattr(unet_cbam, "cbam_gate_eval", counted)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_model_through_the_op_is_the_old_forward(dtype, monkeypatch):
    model = _model(dtype).eval()
    images = (torch.rand(1, 64, 64, 1,
                         generator=torch.Generator().manual_seed(2))
              < 0.1).to(dtype)
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
    assert len(calls) == 26
    monkeypatch.setattr(DoubleConvCBAM, "forward", _old_forward)
    want = forwards()
    assert len(calls) == 26
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_train_mode_never_calls_the_op(monkeypatch):
    model = _model(torch.float32).train()
    calls = _counting(monkeypatch)
    images = (torch.rand(2, 32, 32, 1,
                         generator=torch.Generator().manual_seed(3))
              < 0.1).float()
    out = model(images)
    sum(v.float().square().mean() for v in out.values()).backward()
    assert calls == []
    grads = [p.grad for m in model.modules() if isinstance(m, CBAM)
             for p in m.parameters()]
    assert len(grads) == 13 * 6 and all(
        g is not None and g.isfinite().all() for g in grads)


@pytest.mark.parametrize("el", [2, 4])
@pytest.mark.parametrize("b,c,h,w", [(64, c, h, h) for _, c, h in ALL_SITES]
                         + [(2, 32, 20, 20), (2, 64, 100, 100),
                            (2, 256, 100, 36)])
def test_plan_covers_the_site(b, c, h, w, el):
    """Every pixel in some pooling chunk and some gate tile; a pixel's
    vectors across its lanes; the gate block's shared memory within the
    48 KB that needs no opt-in."""
    for resident in (1, 528, 660):
        p = plan(b, c, h, w, el, resident)
        cv = c * el // cbam_gate.VEC_BYTES
        assert p.parts * p.chunk >= h * w > (p.parts - 1) * p.chunk
        assert p.parts == 1 or b * p.parts <= resident
        assert 1 <= p.th <= h and 1 <= p.tw <= w
        assert p.group & (p.group - 1) == 0 and p.group <= 32
        assert p.nv in (1, 2, 4) and p.group * p.nv >= cv
        assert cbam_gate.THREADS % p.group == 0
        ext = (p.th + 6) * (p.tw + 6)
        assert 4 * (c + 100 + 2 * ext + p.th * p.tw) <= 48 * 1024


def test_op_raises_where_it_cannot_run():
    cbam, y, res = _site(32, 8, "identity", torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        cbam_gate_eval(y.to("meta"), res.to("meta"), *cbam.weights(),
                       torch.bfloat16)
    # under autograd the CPU path is the differentiable chain
    yg = y.float().requires_grad_(True)
    out = cbam_gate_eval(yg, res.float(), *cbam.weights(), torch.float32)
    out.sum().backward()
    assert yg.grad is not None and yg.grad.isfinite().all()


def test_mean_factor_is_atens():
    """The factor the card's mean multiplies its f32 sum by: outputs over
    inputs in f32 (1/N itself where N is a power of two)."""
    assert cbam_gate.mean_factor(64 * 32, 64 * 32 * 512 * 512) == 2.0 ** -18
    assert cbam_gate.mean_factor(2 * 100 * 100, 2 * 32 * 100 * 100) == \
        2.0 ** -5
    f = cbam_gate.mean_factor(2 * 64, 2 * 64 * 100 * 100)
    assert f == float(torch.tensor(1.0) / torch.tensor(10000.0))
