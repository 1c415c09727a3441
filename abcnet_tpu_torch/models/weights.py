"""Flax variable trees <-> the port's model state_dicts, and snapshot I/O.

Plays the role of scripts/snapshot_weights.py:60-68 (`_unflatten`) and
the snapshot fallback of bench.py:303-318. A snapshot is an .npz of
flattened Flax variables, `params/<block>/.../Conv_i/kernel` (HWIO) and
`batch_stats/<block>/.../BatchNorm_i/{mean,var}`, stored f16 or f32,
plus `__step__`.

Every layout of the JAX package's models maps: the production UNet, its
fused head bank (`head_bank`, `head_bank_bn`, `out1_<head>`), the
space-to-depth UNetS2D (`stem1`, `stem2`), UNetCBAM, and the port's own
DLA-34 + DCN (models/dla_dcn.py, `dla_up`), which has no JAX module: its
snapshot keeps the same key rules. Name mapping:
Conv_i -> conv{i}, BatchNorm_i -> bn{i}, Dense_i -> dense{i},
DoubleConv_0 -> double_conv, DoubleConvCBAM_0 -> double_conv_cbam,
ConvTranspose_0 -> up, CBAM_0 -> cbam, ChannelAttention_0 -> channel,
SpatialAttention_0 -> spatial; kernel/scale -> weight, mean/var ->
running_mean/running_var. Kernels: a conv's HWIO kernel becomes OIHW; a
Dense kernel (in, out) becomes the Linear weight (out, in); a transposed
conv's (3, 3, in, out) kernel becomes (in, out, 3, 3) flipped on both
spatial axes, because Flax's ConvTranspose correlates the dilated input
with the kernel as stored while torch's ConvTranspose2d uses the flipped
kernel. `to_flax` is the exact inverse of `from_flax`, and
`save_snapshot` writes the same .npz key layout (f32 arrays), so
weights move both ways between the two packages; `save_snapshot_f16`
writes it with the insurance snapshot's storage rule (float16 where
that is exact for the bf16 compute path, scripts/snapshot_weights.py).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .unet import HEAD_NAMES, UNet

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


_MODULES = {"DoubleConv_0": "double_conv",
            "DoubleConvCBAM_0": "double_conv_cbam",
            "ConvTranspose_0": "up", "CBAM_0": "cbam",
            "ChannelAttention_0": "channel",
            "SpatialAttention_0": "spatial"}
_NUMBERED = (("Conv_", "conv"), ("BatchNorm_", "bn"), ("Dense_", "dense"))


def _module_name(flax_name: str) -> str:
    if flax_name in _MODULES:
        return _MODULES[flax_name]
    for prefix, short in _NUMBERED:
        if flax_name.startswith(prefix):
            return short + flax_name[len(prefix):]
    return flax_name


def _flax_name(module_name: str) -> str:
    for flax, short in _MODULES.items():
        if module_name == short:
            return flax
    for prefix, short in _NUMBERED:
        if module_name.startswith(short) and \
                module_name[len(short):].isdigit():
            return prefix + module_name[len(short):]
    return module_name


def _is_bn(module_name: str) -> bool:
    """Whether a torch module's `weight` is a BatchNorm scale."""
    return module_name == "head_bank_bn" or (
        module_name.startswith("bn") and module_name[2:].isdigit())


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
    """Flax `params` and `batch_stats` trees (numpy leaves) of any of the
    JAX package's models -> a state_dict with f32 tensors for the port's
    model of the same layout (`model_for_tree` builds it)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in list(_flatten(params)) + list(_flatten(batch_stats)):
        if path == ("s",):
            sd["s"] = torch.from_numpy(np.array(v))
            continue
        *mods, leaf = path
        if leaf == "kernel":
            if mods[-1] == "ConvTranspose_0":
                v = v[::-1, ::-1].transpose(2, 3, 0, 1)
            elif mods[-1].startswith("Dense_"):
                v = v.T
            else:
                v = v.transpose(3, 2, 0, 1)
        name = ".".join([_module_name(m) for m in mods] + [_LEAF[leaf]])
        sd[name] = torch.from_numpy(np.array(v))
        if leaf == "mean":
            sd[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return sd


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """A state_dict of any of the port's models -> Flax (`params`,
    `batch_stats`) trees with numpy f32 leaves; the inverse of
    `from_flax`."""
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
        if leaf == "weight" and not _is_bn(mods[-1]):
            if path[-1] == "ConvTranspose_0":
                v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif path[-1].startswith("Dense_"):
                v = v.T
            else:
                v = v.transpose(2, 3, 1, 0)
            flax_leaf = "kernel"
        else:
            flax_leaf = {"weight": "scale", "bias": "bias",
                         "running_mean": "mean", "running_var": "var"}[leaf]
        target = flat_s if flax_leaf in ("mean", "var") else flat_p
        target["/".join(path + [flax_leaf])] = np.ascontiguousarray(v)
    return _unflatten(flat_p), _unflatten(flat_s)


def model_for_tree(params: Dict, dtype: torch.dtype = torch.float32
                   ) -> torch.nn.Module:
    """A fresh port model whose layout is that of the Flax `params` tree:
    DLASeg (a `dla_up`), UNetCBAM (CBAM blocks), UNetS2D (a `stem1`), UNet
    with a fused head bank (`head_bank`) or the production UNet."""
    from .dla_dcn import DLASeg
    from .unet_cbam import UNetCBAM
    from .unet_s2d import UNetS2D

    width = {}
    for k, v in params.items():
        if k.startswith("out_"):
            width[k[4:]] = int(v["Conv_1"]["bias"].shape[0])
        elif k.startswith("out1_"):
            width[k[5:]] = int(v["bias"].shape[0])
    names = (HEAD_NAMES if set(width) == set(HEAD_NAMES) else
             [f"head{i}" for i in range(len(width))])
    heads = tuple(width[n] for n in names)
    if "dla_up" in params:
        return DLASeg(heads, dtype)
    if "CBAM_0" in params.get("inc1", {}):
        return UNetCBAM(heads, dtype)
    if "stem1" in params:
        return UNetS2D(heads, dtype)
    return UNet(heads, dtype, fused_head_bank="head_bank" in params)


def _write_snapshot(model: torch.nn.Module, path: str, step: int,
                    store=lambda key, v: v) -> str:
    """`model`'s weights as a snapshot .npz: each parameter as
    `store(key, f32 array)` returns it, batch stats f32, `__step__`;
    written to a temporary name and renamed into place."""
    params, stats = to_flax(model.state_dict())
    arrays = {}
    for k, v in _flatten(params):
        key = "/".join(("params",) + k)
        arrays[key] = store(key, v)
    arrays.update({"/".join(("batch_stats",) + k): v
                   for k, v in _flatten(stats)})
    arrays["__step__"] = np.int64(step)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return path


def save_snapshot(model: torch.nn.Module, path: str, step: int = 0) -> str:
    """Write `model`'s weights as a snapshot .npz in the key layout of
    scripts/snapshot_weights.py:89-107 (`params/...`, `batch_stats/...`,
    `__step__`), every array f32. `load_snapshot` here and the JAX
    package's snapshot readers both load it. Written to a temporary name
    and renamed into place."""
    return _write_snapshot(model, path, step)


def f16_is_exact(v: np.ndarray) -> bool:
    """Whether float16 storage of the f32 array `v` loses nothing the bf16
    compute path sees: every value finite in f16, and f16 -> f32 -> bf16
    equal bit for bit to f32 -> bf16 (an overflow past 65504 or a
    subnormal with fewer f16 than bf16 mantissa bits fails). Rounded to
    bf16 by torch's cast, round to nearest even. BatchNorm's scale and
    bias are consumed in f32 (models/unet.py), so for them f16 storage
    still moves the outputs; the rule is the JAX package's all the same."""
    f16 = v.astype(np.float16)
    if not np.isfinite(f16).all():
        return False

    def bf16_bits(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            torch.bfloat16).view(torch.int16)
    return torch.equal(bf16_bits(f16.astype(np.float32)), bf16_bits(v))


def save_snapshot_f16(model: torch.nn.Module, path: str, step: int = 0,
                      log=print) -> str:
    """Write `model`'s weights as the compact insurance snapshot of
    scripts/snapshot_weights.py:save: each parameter float16 where
    `f16_is_exact` holds and f32 otherwise (`log` names it), batch stats
    f32, `__step__`; written to a temporary name and renamed into place.
    `load_snapshot` and the JAX package's readers load it."""
    def store(key, v):
        if f16_is_exact(v):
            return v.astype(np.float16)
        log(f"  [f16-unsafe] {key}: stored float32")
        return v
    return _write_snapshot(model, path, step, store)


def load_snapshot(path: str, device="cuda",
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.nn.Module, int]:
    """Read a weight snapshot (e.g. snapshots/r5_latest.npz) of any layout,
    upcast every array to f32 master weights, and return (model in eval
    mode on `device` with compute dtype `dtype`, training step)."""
    dev = resolve_device(device)
    z = np.load(path)
    step = int(z["__step__"])
    tree = _unflatten({k: z[k] for k in z.files if k != "__step__"})
    return _model_from_tree(tree["params"], tree["batch_stats"], dtype,
                            dev), step


def load_weights(path: str, device="cuda",
                 dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[torch.nn.Module, int]:
    """The weights that `--ckpt` names: a snapshot .npz (`load_snapshot`)
    or a checkpoint directory that `train --ckpt` wrote, whose latest
    `step_*.pt` is read (the JAX CLI's restore_checkpoint takes the latest
    too). A checkpoint's `model` entry is the state_dict of the unwrapped
    module, with no DDP `module.` prefix: `trainer.save_checkpoint` saves
    `state.model`, and a process group's DDP wrapper is `state.ddp`. It
    goes through `to_flax` and `model_for_tree`, so every layout a
    snapshot can hold loads from a checkpoint too. Returns (model in eval
    mode on `device` with compute dtype `dtype`, training step); anything
    else raises."""
    if path.endswith(".npz"):
        return load_snapshot(path, device, dtype)
    if not os.path.isdir(path):
        raise ValueError(f"--ckpt {path}: neither a weight snapshot (.npz) "
                         "nor a checkpoint directory (step_*.pt)")
    from ..train.trainer import checkpoint_path

    dev = resolve_device(device)
    ckpt = torch.load(checkpoint_path(path), map_location="cpu",
                      weights_only=True)
    params, stats = to_flax(ckpt["model"])
    return _model_from_tree(params, stats, dtype, dev), int(ckpt["step"])


def _model_from_tree(params: Dict, batch_stats: Dict, dtype: torch.dtype,
                     dev: torch.device) -> torch.nn.Module:
    model = model_for_tree(params, dtype)
    model.load_state_dict(from_flax(params, batch_stats))
    return model.to(dev).eval()
