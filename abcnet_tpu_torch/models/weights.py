"""Flax variable trees <-> the port's UNet state_dict, and snapshot I/O.

Plays the role of scripts/snapshot_weights.py:60-68 (`_unflatten`) and
the snapshot fallback of bench.py:303-318. A snapshot is an .npz of
flattened Flax variables, `params/<block>/.../Conv_i/kernel` (HWIO) and
`batch_stats/<block>/.../BatchNorm_i/{mean,var}`, stored f16 or f32,
plus `__step__`.

Name mapping: Conv_i -> conv{i}, BatchNorm_i -> bn{i}, DoubleConv_0 ->
double_conv, ConvTranspose_0 -> up; kernel/scale -> weight, mean/var ->
running_mean/running_var. Kernels: a conv's HWIO kernel becomes OIHW;
a transposed conv's (3, 3, in, out) kernel becomes (in, out, 3, 3)
flipped on both spatial axes, because Flax's ConvTranspose correlates
the dilated input with the kernel as stored while torch's ConvTranspose2d
uses the flipped kernel. `to_flax` is the exact inverse of `from_flax`,
and `save_snapshot` writes the same .npz key layout (f32 arrays), so
weights move both ways between the two packages.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .unet import UNet

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _module_name(flax_name: str) -> str:
    if flax_name == "DoubleConv_0":
        return "double_conv"
    if flax_name == "ConvTranspose_0":
        return "up"
    for prefix, short in (("Conv_", "conv"), ("BatchNorm_", "bn")):
        if flax_name.startswith(prefix):
            return short + flax_name[len(prefix):]
    return flax_name


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """Flax `params` and `batch_stats` trees (numpy leaves) -> a state_dict
    for `UNet` with f32 tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in list(_flatten(params)) + list(_flatten(batch_stats)):
        if path == ("s",):
            sd["s"] = torch.from_numpy(np.array(v))
            continue
        *mods, leaf = path
        if leaf == "kernel":
            if mods[-1] == "ConvTranspose_0":
                v = v[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                v = v.transpose(3, 2, 0, 1)
        name = ".".join([_module_name(m) for m in mods] + [_LEAF[leaf]])
        sd[name] = torch.from_numpy(np.array(v))
        if leaf == "mean":
            sd[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return sd


def _flax_name(module_name: str) -> str:
    if module_name == "double_conv":
        return "DoubleConv_0"
    if module_name == "up":
        return "ConvTranspose_0"
    for short, prefix in (("conv", "Conv_"), ("bn", "BatchNorm_")):
        if module_name.startswith(short) and \
                module_name[len(short):].isdigit():
            return prefix + module_name[len(short):]
    return module_name


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """A `UNet` state_dict -> Flax (`params`, `batch_stats`) trees with
    numpy f32 leaves; the inverse of `from_flax`."""
    flat_p: Dict[str, np.ndarray] = {}
    flat_s: Dict[str, np.ndarray] = {}
    for name, t in state_dict.items():
        v = t.detach().cpu().numpy().astype(np.float32)
        if name == "s":
            flat_p["s"] = v
            continue
        *mods, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        path = [_flax_name(m) for m in mods]
        is_bn = path[-1].startswith("BatchNorm_")
        if leaf == "weight" and not is_bn:
            if path[-1] == "ConvTranspose_0":
                v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                v = v.transpose(2, 3, 1, 0)
            flax_leaf = "kernel"
        else:
            flax_leaf = {"weight": "scale", "bias": "bias",
                         "running_mean": "mean", "running_var": "var"}[leaf]
        target = flat_s if flax_leaf in ("mean", "var") else flat_p
        target["/".join(path + [flax_leaf])] = np.ascontiguousarray(v)
    return _unflatten(flat_p), _unflatten(flat_s)


def save_snapshot(model: UNet, path: str, step: int = 0) -> str:
    """Write `model`'s weights as a snapshot .npz in the key layout of
    scripts/snapshot_weights.py:89-107 (`params/...`, `batch_stats/...`,
    `__step__`), every array f32. `load_snapshot` here and the JAX
    package's snapshot readers both load it. Written to a temporary name
    and renamed into place."""
    params, stats = to_flax(model.state_dict())
    arrays = {"/".join(("params",) + k): v for k, v in _flatten(params)}
    arrays.update({"/".join(("batch_stats",) + k): v
                   for k, v in _flatten(stats)})
    arrays["__step__"] = np.int64(step)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_snapshot(path: str, device="cuda",
                  dtype: torch.dtype = torch.bfloat16) -> Tuple[UNet, int]:
    """Read a weight snapshot (e.g. snapshots/r5_latest.npz), upcast every
    array to f32 master weights, and return (model in eval mode on
    `device` with compute dtype `dtype`, training step)."""
    dev = resolve_device(device)
    z = np.load(path)
    step = int(z["__step__"])
    tree = _unflatten({k: z[k] for k in z.files if k != "__step__"})
    model = UNet(dtype=dtype)
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    return model.to(dev).eval(), step
