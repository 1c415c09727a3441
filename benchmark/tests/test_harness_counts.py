"""The frozen counts: conv and matmul operations from a configuration's
shapes equal what FlopCounterMode counts on the plain reference, and the
bounds equal those the port's smoke script computed for the same sites."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from .cpu_run import BENCH
from benchmark import counts
from benchmark.reference import unet as ref_unet


def dense_forward_ops(c):
    """One image's forward with every head dense."""
    return sum(counts.conv_ops(*layer[1:]) for layer in counts.conv_layers(c))


def cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def random_weights(c, seed=0):
    """Snapshot-shaped random weights from the configuration's shapes."""
    g = torch.Generator().manual_seed(seed)
    w = {}

    def conv(p, i, ci, co, k=3):
        w[f"params/{p}/Conv_{i}/kernel"] = torch.randn(k, k, ci, co,
                                                       generator=g) * 0.1
        w[f"params/{p}/Conv_{i}/bias"] = torch.zeros(co)

    def bn(p, i, co):
        w[f"params/{p}/BatchNorm_{i}/scale"] = torch.ones(co)
        w[f"params/{p}/BatchNorm_{i}/bias"] = torch.zeros(co)
        w[f"batch_stats/{p}/BatchNorm_{i}/mean"] = torch.zeros(co)
        w[f"batch_stats/{p}/BatchNorm_{i}/var"] = torch.ones(co)

    for site, kind, h, ci, co, k in counts.conv_layers(c):
        if kind == "head1":
            conv(f"out_{site[4:]}", 1, ci, co, 1)
            continue
        if kind == "head3":
            p, i = f"out_{site[2:]}", 0
        elif kind == "convt":
            name = site[:-2]
            w[f"params/{name}/ConvTranspose_0/kernel"] = torch.randn(
                3, 3, ci, co, generator=g) * 0.1
            w[f"params/{name}/ConvTranspose_0/bias"] = torch.zeros(co)
            continue
        else:
            name, i = site.split(".")
            p, i = ref_unet._dc_prefix(name), int(i)
        conv(p, i, ci, co)
        bn(p, i, co)
    return w


@pytest.mark.parametrize("name", ["unet_bf16", "unet_int8"])
def test_forward_ops_equal_flop_counter(name):
    c = cfg(name)
    w = random_weights(c)
    ink = (torch.rand(1, 1, c["image_size"], c["image_size"],
                      generator=torch.Generator().manual_seed(1)) < 0.1)
    with FlopCounterMode(display=False) as fc:
        out = ref_unet.forward_f32(w, ink.float())
    assert fc.get_total_flops() == dense_forward_ops(c)
    assert {k: v.shape[1] for k, v in out.items() if k != "features"} \
        == c["heads"]


def test_ops_scale_with_batch_and_heads():
    c = cfg("unet_bf16")
    w = random_weights(c)
    with FlopCounterMode(display=False) as fc:
        y = ref_unet.forward_f32(w, torch.zeros(2, 1, 512, 512))["features"]
    assert fc.get_total_flops() == 2 * dense_forward_ops(c)
    assert y.shape == (2, 128, 128, 128)
    per_image = sum(counts.conv_ops(*layer[1:]) for layer in
                    counts.conv_layers(c, c["heatmap_heads"]))
    assert per_image == pytest.approx(62.8978e9, rel=1e-5)


def test_sparse_head_ops():
    c = cfg("unet_bf16")
    f = 128
    head = lambda width: 2 * (9 * f * f + f * width)  # noqa: E731
    want = 128 * (head(14) + head(3) + head(2)) + 160 * (
        head(360) + head(60) + head(60) + 8 * head(60))
    assert counts.sparse_head_ops(c) == want


def test_bounds_equal_the_smoke_scripts():
    # chip_smoke.py: the 28 conv_s8 sites' bound 3.578 ms at batch 64,
    # bn_act_eval's 11.6 GB of a batch 3.46 ms at 3.35 TB/s
    c = cfg("unet_int8")
    assert counts.conv_s8_bound_s(c, 64) * 1e3 == pytest.approx(3.5778,
                                                                 rel=1e-4)
    assert counts.bn_act_eval_bound_s(cfg("unet_bf16"), 64) * 1e3 == \
        pytest.approx(3.4656, rel=1e-4)
    sites = [s for s, kind, *_ in counts.conv_layers(c, c["heatmap_heads"])
             if kind in ("conv", "head3")]
    assert len(sites) == 28 and sites[0] == "inc1.0"
    assert sites[-2:] == ["y:atom_target", "y:bond_target"]


def test_serving_least_time():
    bf16, int8 = cfg("unet_bf16"), cfg("unet_int8")
    ops = sum(counts.conv_ops(*layer[1:]) for layer in counts.conv_layers(
        bf16, bf16["heatmap_heads"])) + counts.sparse_head_ops(bf16)
    assert counts.serve_least_seconds(bf16) == pytest.approx(
        ops / counts.BF16_OPS_PER_S)
    assert counts.serve_least_seconds(int8) < counts.serve_least_seconds(
        bf16)
    assert np.isclose(ops / 1e9, 63.57, rtol=1e-3)
