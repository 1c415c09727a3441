"""The deformable columns kernel (ops/deform_conv.py, csrc/deform_conv.cu)
on the card: every test needs an NVIDIA GPU (marker `cuda`) and skips
without one. The file imports no JAX; on the GPU machine it runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_deform_conv_cuda.py

At each of the DLA-34 + DCN model's 16 deformable sites, at a batch of
64 on the activations of a seeded model (chip_smoke.dcn_seeded_model: the
benchmark's seeded kernels with He-normal offset convs, offsets of about
a pixel, every BatchNorm recalibrated on the fixture's drawings), the
kernel's columns and the whole site (columns, GEMM, bn_act_eval) are held
to the plain op: the kernel rounds each f32 operation alone in the plain
op's order, so at most chip_smoke.DCN_DIFF_SHARE of the elements may
differ, by one bf16 unit (a libm exp against ATen's sigmoid).

On offsets drawn over (-2.5, 2.5) pixels and mask logits over (-4, 4),
the kernel's columns differ from each of three mutants of the plain op
(dy and dx swapped, the sigmoid dropped from the mask, the offsets
rounded to whole pixels) in most elements: a kernel with one of those
faults fails the tests above.

Besides: two calls give the same bits; the op raises under autograd and
on a type or width the kernel does not take; an eval forward of the
model on the card runs the kernel once a site (16 launches = 16
`dcn_sites` a batch, their device time in `dcn_device_us`).
"""

import os

import pytest
import torch

import chip_smoke
from benchmark import counts_dla, harness
from abcnet_tpu_torch.ops import deform_conv as dc
from abcnet_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def seeded():
    """The seeded model on the card, the fixture's drawings unpacked, and
    the 16 sites' operands; skips without a GPU."""
    import numpy as np

    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    from torch_parity import FIXTURE

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the deformable kernel has no CPU "
                    "mode (its plain version is tested on the CPU)")
    fixture = dict(np.load(FIXTURE))
    model = chip_smoke.dcn_seeded_model(torch, fixture["images"])
    bits = torch.from_numpy(pack_images(fixture["images"])).cuda()
    images = unpack_bits(bits, BF16)[..., None]
    sites = chip_smoke.dcn_site_operands(torch, model, images)
    return model, images, sites


def test_sixteen_sites_at_batch_64(seeded):
    _, _, sites = seeded
    got = [(x.shape[0], x.shape[2], x.shape[1], m.conv0.out_channels)
           for _, m, x in sites]
    cfg = harness.load_json(os.path.join(chip_smoke.HERE, "benchmark",
                                         "configs", "dla34_dcn_bf16.json"))
    assert got == [(64, h, ci, co) for _, h, ci, co in counts_dla.sites(cfg)]


@pytest.mark.parametrize("site", range(16))
def test_kernel_matches_the_plain_op(seeded, site):
    _, _, sites = seeded
    name, mod, x = sites[site]
    args = chip_smoke.dcn_site_args(torch, mod, x)
    with torch.no_grad():
        cols = dc.modulated_columns(x, args[1])
        want = dc.modulated_columns_plain(x, args[1])
        share, units = chip_smoke.bf16_units(torch, cols, want)
        assert share <= chip_smoke.DCN_DIFF_SHARE, (name, share)
        assert units <= chip_smoke.DCN_ULPS, (name, units)
        assert (cols != 0).float().mean() > 0.3, name
        out = dc.deform_conv_bn_act_eval(*args)
        plain = dc.deform_conv_bn_act_eval_plain(*args)
        share, units = chip_smoke.bf16_units(torch, out, plain)
        assert share <= chip_smoke.DCN_DIFF_SHARE, (name, share)
        assert units <= chip_smoke.DCN_ULPS, (name, units)
        assert out.is_contiguous(memory_format=torch.channels_last)
        # the samples land off the grid
        off = args[1][:, :18].float()
        assert ((off - off.round()).abs() > 0.05).float().mean() > 0.5


def _drawn_offsets(x, seed=5):
    n, _, h, w = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed)
    off = (torch.rand(n, 18, h, w, device=x.device, generator=gen) - 0.5) * 5
    m = (torch.rand(n, 9, h, w, device=x.device, generator=gen) - 0.5) * 8
    return torch.cat([off, m], 1).to(BF16).contiguous(
        memory_format=torch.channels_last)


def _mutant(x, om, kind):
    if kind == "swapped":
        om = om.clone()
        om[:, 0:18:2], om[:, 1:18:2] = om[:, 1:18:2].clone(), \
            om[:, 0:18:2].clone()
        return dc.modulated_columns_plain(x, om)
    if kind == "rounded":
        om = om.clone()
        om[:, :18] = om[:, :18].round()
        return dc.modulated_columns_plain(x, om)
    # the sigmoid dropped: the raw logit as the mask
    m = om[:, 18:].float()
    scale = (m / torch.sigmoid(m)).permute(0, 2, 3, 1)        # (N, H, W, 9)
    cols = dc.modulated_columns_plain(x, om).float()
    n, h, w, _ = cols.shape
    return (cols.reshape(n, h, w, 9, -1) * scale[..., None]).reshape(
        n, h, w, -1).to(BF16)


@pytest.mark.parametrize("kind", ["swapped", "no_sigmoid", "rounded"])
@pytest.mark.parametrize("site", [0, 7, 14])
def test_mutants_differ(seeded, site, kind):
    _, _, sites = seeded
    _, _, x = sites[site]
    x = x[:8]
    om = _drawn_offsets(x)
    with torch.no_grad():
        cols = dc.modulated_columns(x, om)
        share, _ = chip_smoke.bf16_units(torch, cols,
                                         dc.modulated_columns_plain(x, om))
        assert share <= chip_smoke.DCN_DIFF_SHARE
        bad, _ = chip_smoke.bf16_units(torch, cols, _mutant(x, om, kind))
    assert bad > 0.5, (kind, bad)


def test_two_calls_give_the_same_bits(seeded):
    _, _, sites = seeded
    _, mod, x = sites[7]
    om = chip_smoke.dcn_site_args(torch, mod, x)[1]
    with torch.no_grad():
        assert torch.equal(dc.modulated_columns(x, om),
                           dc.modulated_columns(x, om))


def test_refuses_what_the_kernel_does_not_take(seeded):
    _, _, sites = seeded
    _, mod, x = sites[7]
    om = chip_smoke.dcn_site_args(torch, mod, x)[1]
    with pytest.raises(RuntimeError, match="no backward"):
        dc.modulated_columns(x.clone().requires_grad_(), om)
    with torch.no_grad():
        with pytest.raises(TypeError):
            dc.modulated_columns(x.float(), om)
        with pytest.raises(ValueError):
            dc.modulated_columns(x[:, :12], om)
        with pytest.raises(ValueError):
            dc.modulated_columns(x, om[:, :26])


def test_served_model_runs_the_kernel_once_a_site(seeded):
    from torch.profiler import ProfilerActivity, profile

    model, images, _ = seeded
    dc.modulated_columns.launches = 0
    profiling.clear()
    bid = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        bid = profiling.start_batch()
        with profiling.batch(bid), torch.no_grad():
            model(images[:8], dense_heads=("atom_target", "bond_target"))
            torch.cuda.synchronize()
            profiling.resolve_device_spans()
    counters = profiling.counters()[bid]
    profiling.clear()
    assert dc.modulated_columns.launches == 16
    assert counters["dcn_sites"] == 16 and counters["dcn_device_us"] > 0
