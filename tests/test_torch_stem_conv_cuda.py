"""The CBAM stem's conv kernel (ops/stem_conv.py, csrc/stem_conv.cu) on
the card: every test needs an NVIDIA GPU (marker `cuda`) and skips without
one. The file imports no JAX; on the GPU machine it runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stem_conv_cuda.py

`stem_conv_bn_act_eval` is held, at the four stem sites of a batch of 64
at 512² (1 -> 32 channels with relu; 32 -> 32 with none, relu, none) and
at ragged sides, against:

  * the stock chain it replaces (cuDNN's conv without its bias, then
    bn_act_eval, kernel (e), adding it). The kernel rounds where the chain
    stores and sums the conv's f32 products in another order, so a conv
    sum within its f32 order error of a bf16 rounding boundary may round
    the other way: one bf16 unit of the conv sum, which the bias add may
    round once more (one unit of the sum with the bias), the BatchNorm's
    scale carries, and the output's rounding may flip again (one unit of
    the output). Every element lies within that bound
    (chip_smoke.stem_site_tolerance, from the float64 conv sum), and at
    most DIFF_SHARE of the elements differ at all (measured: none at the
    four 512² sites of a batch of 64; one in 10^5 at a ragged 1-channel
    side).
  * the same math in float64 on the same operands (the conv sum in
    float64, the bias rounded to bf16 as the chain's, then the BatchNorm
    and the activation): the kernel's root mean square error is the
    chain's own within RMS_SLACK (both round the conv sum to bf16 where
    the chain stores it).

Besides: two calls give the same bits; the op raises under autograd and on
a layout, type or shape the kernel does not take; it counts one launch a
call; an eval forward of the CBAM U-Net in bf16 runs the kernel once a
stem site (4 `stem_fused` = 4 `stem_sites` a batch, and their device time
in `stem_device_us`).
"""

import pytest
import torch

import chip_smoke
from abcnet_tpu_torch.models import unet_cbam
from abcnet_tpu_torch.models.unet import BN_EPS, BN_MOMENTUM, BatchNorm
from abcnet_tpu_torch.ops.bn_act import activation
from abcnet_tpu_torch.ops.stem_conv import (stem_conv_bn_act_eval,
                                            stem_conv_bn_act_eval_plain)
from abcnet_tpu_torch.utils import profiling
from torch_parity import cuda  # noqa: F401

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
DIFF_SHARE = 1e-3
RMS_SLACK = 2 ** -6
# (name, batch, C_in, H, W, act): the four sites at 512², then ragged sides
SHAPES = [("inc1.0", 64, 1, 512, 512, "relu"),
          ("inc1.1", 64, 32, 512, 512, "none"),
          ("inc2.0", 64, 32, 512, 512, "relu"),
          ("inc2.1", 64, 32, 512, 512, "none"),
          ("side20", 2, 32, 20, 20, "relu"),
          ("rows37x130", 3, 32, 37, 130, "none"),
          ("narrow67x200", 2, 1, 67, 200, "relu"),
          ("tiny3x5", 1, 32, 3, 5, "relu")]


def _site(dev, n, c_in, h, w, seed=0):
    """A 5x5 conv to 32 channels, an eval BatchNorm with moved statistics,
    and a channels_last bf16 input: a binary drawing for one channel, a
    ReLU output of about unit scale for 32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    conv = torch.nn.Conv2d(c_in, 32, 5, padding=2).to(dev)
    bn = BatchNorm(32, BN_EPS, BN_MOMENTUM).to(dev).eval()
    with torch.no_grad():
        conv.weight.normal_(0.0, (2 / (25 * c_in)) ** 0.5, generator=gen)
        conv.bias.normal_(0.0, 0.1, generator=gen)
        bn.running_mean.normal_(0.0, 0.3, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
        bn.weight.normal_(1.0, 0.2, generator=gen)
        bn.bias.normal_(0.0, 0.1, generator=gen)
    if c_in == 1:
        x = (torch.rand(n, 1, h, w, device=dev, generator=gen) < 0.1)
    else:
        x = torch.randn(n, c_in, h, w, device=dev, generator=gen).relu()
    return x.to(BF16).contiguous(memory_format=torch.channels_last), conv, bn


def _f64(s, conv, bn, act):
    """The site in float64 from the float64 conv sum s."""
    cb = conv.bias.to(BF16).double()[:, None, None]
    scale = (bn.weight.double() / (bn.running_var.double() + bn.eps).sqrt())
    pre = (s + cb - bn.running_mean.double()[:, None, None]) * \
        scale[:, None, None] + bn.bias.double()[:, None, None]
    return activation(act)(pre)


@pytest.mark.parametrize("name,n,c_in,h,w,act", SHAPES)
def test_kernel_is_the_stock_chain(cuda, name, n, c_in, h, w, act):
    x, conv, bn = _site(cuda, n, c_in, h, w)
    args = chip_smoke.stem_site_args(x, conv, bn, act)
    with torch.no_grad():
        got = stem_conv_bn_act_eval(*args)
        again = stem_conv_bn_act_eval(*args)
        want = chip_smoke.stem_stock_chain(torch, x, conv, bn, act)
        s = chip_smoke.stem_conv_f64(torch, x, conv)
    torch.cuda.synchronize()
    assert got.dtype == BF16 and got.shape == (n, 32, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, again)
    d = (got.double() - want.double()).abs()
    tol = chip_smoke.stem_site_tolerance(torch, s, conv, bn, want)
    assert bool((d <= tol).all()), name
    del tol
    assert (d > 0).double().mean().item() <= DIFF_SHARE
    del d
    ref = _f64(s, conv, bn, act)
    del s
    rms = [(v.double() - ref).square().mean().sqrt().item()
           for v in (got, want)]
    assert rms[0] <= rms[1] * (1 + RMS_SLACK)


def test_plain_on_the_card_is_the_stock_chain(cuda):
    """On the card the plain version runs the chain kernel (e) equals."""
    x, conv, bn = _site(cuda, 2, 32, 40, 40)
    with torch.no_grad():
        for act in ("relu", "none"):
            args = chip_smoke.stem_site_args(x, conv, bn, act)
            assert torch.equal(
                stem_conv_bn_act_eval_plain(*args),
                chip_smoke.stem_stock_chain(torch, x, conv, bn, act))


def test_kernel_has_no_backward(cuda):
    x, conv, bn = _site(cuda, 1, 32, 16, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        stem_conv_bn_act_eval(*chip_smoke.stem_site_args(
            x.requires_grad_(True), conv, bn, "relu"))
    with pytest.raises(RuntimeError, match="no backward"):
        stem_conv_bn_act_eval(*chip_smoke.stem_site_args(
            x.detach(), conv, bn, "relu"))
    with torch.no_grad():
        assert stem_conv_bn_act_eval(*chip_smoke.stem_site_args(
            x.detach(), conv, bn, "relu")).isfinite().all()


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, conv, bn = _site(cuda, 1, 32, 16, 16)

    def run(x, weight=conv.weight, act="relu"):
        stem_conv_bn_act_eval(x, weight, conv.bias, bn.running_mean,
                              bn.running_var, bn.weight, bn.bias, bn.eps,
                              act)

    with torch.no_grad():
        with pytest.raises(ValueError, match="channels_last"):
            run(x.contiguous())
        with pytest.raises(TypeError, match="bf16"):
            run(x.float())
        with pytest.raises(TypeError, match="bf16"):
            run(x.half())
        with pytest.raises(TypeError, match="conv weight"):
            run(x, conv.weight.half())
        with pytest.raises(ValueError, match="5x5"):
            run(x, conv.weight[:, :, :3, :3])
        with pytest.raises(ValueError, match="unsupported input shape"):
            run(torch.zeros(1, 16, 8, 8, dtype=BF16, device=cuda)
                .contiguous(memory_format=torch.channels_last))
        with pytest.raises(ValueError, match="act"):
            run(x, act="leaky_relu")


def test_launches_count_each_call(cuda):
    x, conv, bn = _site(cuda, 1, 32, 24, 24)
    args = chip_smoke.stem_site_args(x, conv, bn, "relu")
    before = stem_conv_bn_act_eval.launches
    with torch.no_grad():
        for _ in range(3):
            stem_conv_bn_act_eval(*args)
    torch.cuda.synchronize()
    assert stem_conv_bn_act_eval.launches == before + 3
    with torch.no_grad():
        stem_conv_bn_act_eval_plain(*args)
    assert stem_conv_bn_act_eval.launches == before + 3


def test_eval_model_runs_the_kernel_at_each_stem_site(cuda):
    """A profiled eval forward of the bf16 CBAM U-Net: one kernel launch
    and one `stem_fused` a stem site, their device time in
    `stem_device_us`; f32 and train mode launch none."""
    from torch.profiler import ProfilerActivity, profile

    torch.manual_seed(0)
    model = unet_cbam.UNetCBAM(dtype=BF16).to(cuda).eval()
    images = (torch.rand(2, 128, 128, 1, device=cuda) < 0.1).to(BF16)
    before = stem_conv_bn_act_eval.launches
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        bid = profiling.start_batch()
        with profiling.batch(bid):
            model(images)
            torch.cuda.synchronize()
            profiling.resolve_device_spans()
    counters = profiling.counters()[bid]
    profiling.clear()
    assert stem_conv_bn_act_eval.launches == before + 4
    assert counters["stem_sites"] == counters["stem_fused"] == 4
    assert counters["stem_device_us"] > 0
    model.dtype = torch.float32
    with torch.no_grad():
        model(images.float())
    model.dtype = BF16
    model.train()(images)
    assert stem_conv_bn_act_eval.launches == before + 4
