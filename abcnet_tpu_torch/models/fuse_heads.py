"""Lossless weight conversion between the production per-head OutConv
layout and the fused head-bank layout (UNet(fused_head_bank=True)), in
the npz (Flax) layout of models/weights.py. Counterpart of
abcnet_tpu/models/fuse_heads.py, on numpy trees.

The fusion is exact: the n per-head 3x3 kernels concatenated along the
output-channel axis are one conv whose output slices are the per-head
outputs, and one (n·128)-channel BatchNorm is n 128-channel ones,
because BatchNorm statistics and affine are per channel. The per-head
1x1 convs are unchanged. So production weights train under the fused
model, and fused weights serve (the sparse-head pipeline needs the
per-head layout) after `unfuse_head_variables`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .unet import PRODUCTION_HEADS, head_names


def fuse_head_variables(variables: Dict,
                        heads: Sequence[int] = PRODUCTION_HEADS) -> Dict:
    """Production-layout {"params", "batch_stats"} -> fused head bank."""
    params = dict(variables["params"])
    stats = dict(variables["batch_stats"])
    names = head_names(tuple(heads))

    def cat(get):
        return np.concatenate([get(params[f"out_{n}"]) for n in names],
                              axis=-1)

    def cat_s(get):
        return np.concatenate(
            [get(stats[f"out_{n}"]["BatchNorm_0"]) for n in names], axis=-1)

    params["head_bank"] = {
        "kernel": cat(lambda h: h["Conv_0"]["kernel"]),
        "bias": cat(lambda h: h["Conv_0"]["bias"]),
    }
    params["head_bank_bn"] = {
        "scale": cat(lambda h: h["BatchNorm_0"]["scale"]),
        "bias": cat(lambda h: h["BatchNorm_0"]["bias"]),
    }
    stats["head_bank_bn"] = {"mean": cat_s(lambda s: s["mean"]),
                             "var": cat_s(lambda s: s["var"])}
    for n in names:
        params[f"out1_{n}"] = params[f"out_{n}"]["Conv_1"]
        del params[f"out_{n}"]
        del stats[f"out_{n}"]
    return {"params": params, "batch_stats": stats}


def unfuse_head_variables(variables: Dict,
                          heads: Sequence[int] = PRODUCTION_HEADS) -> Dict:
    """Fused head bank {"params", "batch_stats"} -> per-head layout."""
    params = dict(variables["params"])
    stats = dict(variables["batch_stats"])
    names = head_names(tuple(heads))
    bank = params.pop("head_bank")
    bn = params.pop("head_bank_bn")
    bns = stats.pop("head_bank_bn")
    for i, n in enumerate(names):
        sl = slice(i * 128, (i + 1) * 128)
        params[f"out_{n}"] = {
            "Conv_0": {"kernel": bank["kernel"][..., sl],
                       "bias": bank["bias"][sl]},
            "BatchNorm_0": {"scale": bn["scale"][sl],
                            "bias": bn["bias"][sl]},
            "Conv_1": params.pop(f"out1_{n}"),
        }
        stats[f"out_{n}"] = {"BatchNorm_0": {"mean": bns["mean"][sl],
                                             "var": bns["var"][sl]}}
    return {"params": params, "batch_stats": stats}
