"""The CBAM gate's kernels (ops/cbam_gate.py, csrc/cbam_gate.cu) on the
card: every test needs an NVIDIA GPU (marker `cuda`) and skips without
one. The file imports no JAX; on the GPU machine it runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cbam_gate_cuda.py

`cbam_gate_eval` is held, at each of the CBAM U-Net's 13 site shapes at
batch 2 and at ragged sides, with a residual conv in front and without,
against:

  * `cbam_gate_eval_plain` on the card, the stock chain it replaces.
    Tolerance: summation order only. The kernels round where the chain
    stores, but sum the spatial mean, the shared MLP and the 7x7 conv in
    another order than ATen, cuBLAS and cuDNN. In bf16 a sum that lands
    within its f32 order error of a rounding boundary rounds the other
    way: at most DIFF_SHARE of the elements differ (measured at most
    1.25e-5 over 96 cases), and where one does, a flipped rounding of a
    gate's sigmoid argument v (the 7x7 conv's output, the MLP's) moves
    the gate by up to one bf16 unit of v relative, 2^-7 |v|: REL_BF16 of
    the scale |sa * ca * y| + |res| allows |v| up to 16 (measured 0.036).
    In f32 the sums of up to 2^18 terms differ in their last bits:
    REL_F32 of the scale (measured 5.4e-6).
  * the same math in float64 on the same operands (the weights rounded to
    the working type, as the chain casts them): in bf16 the kernels' root
    mean square error is the chain's own within RMS_SLACK (a few flipped
    roundings cannot move it; measured 1 + 2e-5), in f32 within REL_F32
    of the scale (measured 5.7e-6).

Besides: the op raises under autograd and on a layout or type the kernels
do not take, counts one launch a call, and an eval forward of the CBAM
U-Net runs the kernels once a site.
"""

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from abcnet_tpu_torch.models import unet_cbam
from abcnet_tpu_torch.models.unet import BatchNorm
from abcnet_tpu_torch.ops import cbam_gate
from abcnet_tpu_torch.ops.cbam_gate import (cbam_gate_eval,
                                            cbam_gate_eval_plain)
from torch_parity import cuda  # noqa: F401

pytestmark = pytest.mark.cuda

DIFF_SHARE = 1e-3
REL_BF16 = 2 ** -3
REL_F32 = 2 ** -14
RMS_SLACK = 2 ** -6
MODEL_REL = 1e-2
# (block, C, H = W): the 13 sites at 512², then ragged sides
SHAPES = [("inc1", 32, 512, 512), ("inc2", 32, 512, 512),
          ("down1", 32, 256, 256), ("down2", 64, 128, 128),
          ("inc3", 64, 128, 128), ("down3", 128, 64, 64),
          ("down4", 256, 32, 32), ("down5", 512, 16, 16),
          ("up1", 256, 32, 32), ("up2", 128, 64, 64),
          ("up3", 128, 128, 128), ("dconv1", 128, 128, 128),
          ("dconv2", 128, 128, 128), ("side20", 32, 20, 20),
          ("side100", 64, 100, 100), ("wide100x36", 256, 100, 36)]


def _operands(dev, c, h, w, dtype, residual, seed=0):
    """chip_smoke.py's operands of a site at batch 2: y, res (with a 1x1
    conv in front or without), the f32 weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y, res, weights = chip_smoke.cbam_gate_inputs(torch, (2, c, h, w), dtype,
                                                  gen, residual, dev)
    assert res.is_contiguous(memory_format=torch.channels_last)
    return y, res, weights


def _f64(y, res, weights, dtype):
    """The gate in float64 on the same operands, the weights rounded to
    dtype; returns (out, the scale |sa * ca * y| + |res|)."""
    w0, b0, w1, b1, ws, bs = (t.to(dtype).double() for t in weights)
    y, res = y.double(), res.double()

    def mlp(v):
        return F.linear(F.relu(F.linear(v, w0, b0)), w1, b1)

    ca = torch.sigmoid(mlp(y.mean((2, 3))) + mlp(y.amax((2, 3))))
    x = ca[:, :, None, None] * y
    s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
    gated = torch.sigmoid(F.conv2d(s, ws, bs, padding=3)) * x
    return F.relu(gated + res), gated.abs() + res.abs()


@pytest.mark.parametrize("residual", ["conv", "identity"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,c,h,w", SHAPES)
def test_gate_kernels_are_the_chain(cuda, name, c, h, w, dtype, residual):
    y, res, weights = _operands(cuda, c, h, w, dtype, residual)
    with torch.no_grad():
        got = cbam_gate_eval(y, res, *weights, dtype)
        want = cbam_gate_eval_plain(y, res, *weights, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == y.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref, scale = _f64(y, res, weights, dtype)
    scale = scale + 1e-30
    diff = (got.double() - want.double()).abs()
    err_kernels = (got.double() - ref).abs() / scale
    if dtype == torch.bfloat16:
        assert (diff > 0).double().mean().item() <= DIFF_SHARE
        assert (diff / scale).max().item() <= REL_BF16
        err_chain = (want.double() - ref).abs() / scale
        rms = [e.square().mean().sqrt().item()
               for e in (err_kernels, err_chain)]
        assert rms[0] <= rms[1] * (1 + RMS_SLACK)
    else:
        assert (diff / scale).max().item() <= REL_F32
        assert err_kernels.max().item() <= REL_F32


def test_gate_has_no_backward(cuda):
    y, res, weights = _operands(cuda, 32, 16, 16, torch.bfloat16, "conv")
    with pytest.raises(RuntimeError, match="no backward"):
        cbam_gate_eval(y.requires_grad_(True), res, *weights,
                       torch.bfloat16)
    weights = [t.requires_grad_(True) for t in weights]
    with pytest.raises(RuntimeError, match="no backward"):
        cbam_gate_eval(y.detach(), res, *weights, torch.bfloat16)
    with torch.no_grad():
        assert cbam_gate_eval(y, res, *weights,
                              torch.bfloat16).isfinite().all()


def test_gate_rejects_what_it_does_not_take(cuda):
    y, res, weights = _operands(cuda, 32, 16, 16, torch.bfloat16, "conv")
    with torch.no_grad():
        with pytest.raises(ValueError, match="channels_last"):
            cbam_gate_eval(y.contiguous(), res, *weights, torch.bfloat16)
        with pytest.raises(ValueError, match="channels_last"):
            cbam_gate_eval(y, res.contiguous(), *weights, torch.bfloat16)
        with pytest.raises(TypeError):
            cbam_gate_eval(y.half(), res.half(), *weights, torch.float16)
        with pytest.raises(TypeError):
            cbam_gate_eval(y, res.float(), *weights, torch.bfloat16)
        with pytest.raises(TypeError):
            cbam_gate_eval(y, res, *weights, torch.float32)
        with pytest.raises(ValueError, match="unsupported shape"):
            odd = torch.zeros(2, 12, 8, 8, dtype=torch.bfloat16,
                              device=cuda).contiguous(
                                  memory_format=torch.channels_last)
            cbam_gate_eval(odd, odd, *weights, torch.bfloat16)
        with pytest.raises(ValueError, match="weight"):
            cbam_gate_eval(y, res, *weights[:4], weights[4][:, :1],
                           weights[5], torch.bfloat16)


def test_launches_count_each_call(cuda):
    y, res, weights = _operands(cuda, 64, 32, 32, torch.bfloat16, "conv")
    before = cbam_gate_eval.launches
    with torch.no_grad():
        for _ in range(3):
            cbam_gate_eval(y, res, *weights, torch.bfloat16)
    torch.cuda.synchronize()
    assert cbam_gate_eval.launches == before + 3
    with torch.no_grad():
        cbam_gate_eval_plain(y, res, *weights, torch.bfloat16)
    assert cbam_gate_eval.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_model_runs_the_kernels_at_each_site(cuda, dtype, monkeypatch):
    """An eval forward of the CBAM U-Net calls the kernels once a site,
    and its heads agree with the same forward through the stock chain to
    MODEL_REL relative L2 (each site within the tolerance above; a flip
    at one site carries through the blocks after it)."""
    torch.manual_seed(0)
    model = unet_cbam.UNetCBAM(dtype=dtype)
    gen = torch.Generator().manual_seed(1)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.normal_(0.0, 0.3, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    model = model.to(cuda).eval()
    images = (torch.rand(2, 128, 128, 1, device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(2)) < 0.1).to(dtype)
    before = cbam_gate_eval.launches
    with torch.no_grad():
        got = model(images)
    assert cbam_gate_eval.launches == before + 13
    monkeypatch.setattr(unet_cbam, "cbam_gate_eval", cbam_gate_eval_plain)
    with torch.no_grad():
        want = model(images)
    assert cbam_gate_eval.launches == before + 13
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].double(), want[k].double()
        assert g.isfinite().all(), k
        assert (g - w).norm() <= MODEL_REL * w.norm(), k


def test_plan_stays_within_one_wave(cuda):
    """The pooling split on this card: at most the resident blocks."""
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.tensor([], dtype=dtype).element_size()
        resident = cbam_gate._resident(torch.cuda.current_device(),
                                       int(dtype == torch.bfloat16))
        assert resident >= torch.cuda.get_device_properties(
            0).multi_processor_count
        p = cbam_gate.plan(64, 32, 512, 512, el, resident)
        assert 64 * p.parts <= resident
