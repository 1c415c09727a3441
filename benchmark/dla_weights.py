"""The seeded weights of the DLA-34 + DCN configuration (`dla34_dcn_bf16`),
the recipe its file gives under `assumed`, on the helpers of
benchmark/cbam_weights.py:

  (a) every conv kernel He-normal, std sqrt(2 / fan_in), fan_in kh kw
      C_in, drawn from numpy `default_rng(weights_seed)` in the order of
      `reference/dla_dcn.py:param_shapes`, the offset / mask convs' then
      scaled by `offset_kernel_scale`; every bias 0, every BatchNorm scale
      1 and shift 0; each depthwise up the source's bilinear
      `fill_up_weights` kernel, for which nothing is drawn;
  (b) every BatchNorm's running mean and variance: the model's own
      float32 batch statistics over `calibration_rows` of the pool, as one
      batch, each after those before it are recalibrated (the plain
      reference's `calibrate`);
  (c) the eight heads' final 1x1 biases from the production snapshot, then
      each heatmap bias the larger of two: the one at which the median
      number of peaks a drawing over the pool is the production
      snapshot's own (`match_median_shift`), and the least at which every
      drawing of the pool has the configuration's `peak_floor` of peaks
      (two atoms, one bond: the fewest a SMILES needs), the last of them
      `peak_floor_margin` above the decode's threshold (`floor_shift`).
      Not the mean the CBAM recipe matches: the seeded DLA's heatmap level
      follows a drawing's ink far more than its peaks spread within one,
      so a mean match leaves 15% of the pool, the drawings with the least
      ink, with fewer than two atom peaks, and a median match 12%; those
      drawings decode to no SMILES at all.

(a) is drawn again at every set-up; (b) and (c) are computed once, on a
card, by benchmark/tools/make_dla_weights.py into the configuration's
`weights_data` (checked against its sha256 at set-up). Nothing here
imports the program under test.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from .cbam_weights import (HEATMAPS, _heatmap_maxima, _tensors, load_data,
                           peak_count)
from .reference import decode as ref_decode
from .reference import dla_dcn as ref_dla
from .reference import unet as ref_unet

UP_KERNEL = re.compile(r"/up\d+/kernel$")
OFFSET_KERNEL = re.compile(r"/(proj|node)\d+/Conv_1/kernel$")


def drawn(cfg: Dict) -> Dict[str, np.ndarray]:
    """(a): every parameter of the model, float32, by Flax key."""
    rng = np.random.default_rng(cfg["weights_seed"])
    out = {}
    for key, shape in ref_dla.param_shapes().items():
        if UP_KERNEL.search(key):
            k = ref_dla.bilinear_up(shape[0]).numpy()
            out[key] = np.ascontiguousarray(np.broadcast_to(
                k[:, :, None, None], shape), np.float32)
        elif key.endswith("/kernel"):
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            if OFFSET_KERNEL.search(key):
                std *= cfg["offset_kernel_scale"]
            out[key] = (rng.standard_normal(shape, dtype=np.float32)
                        * np.float32(std))
        elif key.endswith("/scale"):
            out[key] = np.ones(shape, np.float32)
        else:
            out[key] = np.zeros(shape, np.float32)
    return out


def build_snapshot(cfg: Dict, out_dir: str) -> str:
    """The whole snapshot (a) + (b) + (c), written to out_dir; its path."""
    arrays = drawn(cfg)
    data = load_data(cfg)
    unknown = set(data) - set(arrays) - {
        k for k in data if k.startswith("batch_stats/")}
    if unknown:
        raise SystemExit(f"error: {sorted(unknown)[:3]} in the data file "
                         "are no parameters of the model")
    arrays.update(data)
    path = os.path.join(out_dir, f"{cfg['name']}.npz")
    np.savez(path, __step__=np.int64(0), **with_default_stats(arrays))
    return path


def with_default_stats(arrays: Dict[str, np.ndarray]) -> Dict:
    """`arrays` with torch's initial statistics (mean 0, variance 1) for
    every BatchNorm that has none: those no forward reaches (the unused
    projections of the two-level trees), which calibration skips."""
    for key, v in list(arrays.items()):
        if key.endswith("/scale"):
            stats = "batch_stats/" + key[len("params/"):-len("/scale")]
            arrays.setdefault(stats + "/mean", np.zeros_like(v))
            arrays.setdefault(stats + "/var", np.ones_like(v))
    return arrays


def peak_counts(maxima: torch.Tensor, shift: float = 0.0) -> torch.Tensor:
    """Each drawing's number of peaks (local maxima above the decode's
    logit threshold, at most k) once `shift` is added to every logit."""
    return ((maxima + shift) > ref_decode.LOGIT_THRESHOLD).sum(1).double()


def median_count(maxima: torch.Tensor, shift: float = 0.0) -> float:
    """The median over drawings of `peak_counts` (halfway between the two
    middle drawings of an even number)."""
    return float(torch.quantile(peak_counts(maxima, shift), 0.5))


def match_median_shift(maxima: torch.Tensor, target: float,
                       steps: int = 60) -> float:
    """The shift (bisection over [-64, 64]) at which `median_count` is
    `target`: the count grows with the shift."""
    lo, hi = -64.0, 64.0
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        if median_count(maxima, mid) < target:
            lo = mid
        else:
            hi = mid
    return hi


def floor_shift(maxima: torch.Tensor, floor: int, margin: float) -> float:
    """The least shift at which every drawing's `floor`-th largest local
    maximum lies `margin` above the decode's logit threshold."""
    return (ref_decode.LOGIT_THRESHOLD + margin
            - float(maxima[:, floor - 1].min()))


def make(cfg: Dict, calib_u8: np.ndarray, pool_u8: np.ndarray,
         production: str, device, chunk: int = 16):
    """(b) and (c) for `cfg`: ({key: array} of the data file, {count:
    value} of what was matched), as cbam_weights.make computes them for
    the CBAM U-Net."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        w = _tensors(drawn(cfg), device)
        prod = ref_unet.load_snapshot(production, device)
        for h in ref_unet.HEADS:
            key = f"params/out_{h}/Conv_1/bias"
            w[key] = prod[key].clone()
        ref_dla.forward(w, ref_decode.binarize(calib_u8, device),
                        calibrate=True)
        prod_max = _heatmap_maxima(
            lambda ink: ref_unet.forward_f32(prod, ink), pool_u8, device,
            chunk)
        for h in HEATMAPS:
            w[f"params/out_{h}/Conv_1/bias"].zero_()
        dla_max = _heatmap_maxima(
            lambda ink: ref_dla.forward(w, ink, heads=HEATMAPS), pool_u8,
            device, chunk)
    info = {}
    for h in HEATMAPS:
        target = median_count(prod_max[h])
        shift = max(match_median_shift(dla_max[h], target),
                    floor_shift(dla_max[h], cfg["peak_floor"][h],
                                cfg["peak_floor_margin"]))
        w[f"params/out_{h}/Conv_1/bias"].fill_(shift)
        info[f"info/{h}/production_median_peaks"] = target
        info[f"info/{h}/seeded_median_peaks"] = median_count(dla_max[h],
                                                             shift)
        info[f"info/{h}/production_peaks"] = peak_count(prod_max[h])
        info[f"info/{h}/seeded_peaks"] = peak_count(dla_max[h], shift)
        info[f"info/{h}/seeded_fewest_peaks"] = float(
            peak_counts(dla_max[h], shift).min())
        info[f"info/{h}/production_fewest_peaks"] = float(
            peak_counts(prod_max[h]).min())
        info[f"info/{h}/bias"] = shift
    data = {k: v.cpu().numpy().astype(np.float32) for k, v in w.items()
            if k.startswith("batch_stats/")
            or (k.startswith("params/out_") and k.endswith("Conv_1/bias"))}
    data.update({k: np.float64(v) for k, v in info.items()})
    return data, info
