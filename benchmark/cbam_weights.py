"""The seeded weights of a CBAM U-Net configuration (`unet_cbam_bf16`), the
recipe its file gives under `assumed`:

  (a) every conv and Dense kernel He-normal, std sqrt(2 / fan_in) with
      fan_in the product of the kernel's dimensions but its last (kh kw
      C_in, a Dense's inputs, a transposed conv's as stored), drawn from
      numpy `default_rng(weights_seed)` in the order of
      `reference/unet_cbam.py:param_shapes`; every conv and Dense bias 0,
      every BatchNorm scale 1 and shift 0, `s` 0;
  (b) every BatchNorm's running mean and variance: the model's own
      float32 batch statistics over `calibration_rows` of the pool, as
      one batch, each BatchNorm after those before it are recalibrated
      (the plain reference's `calibrate`);
  (c) the eight heads' final 1x1 biases from the production snapshot
      (its trained class priors), then the two heatmap biases set so that
      the mean number of atom and bond peaks a drawing over the pool
      (3x3 NMS, logit above -1, at most the decode's top-K) is the
      production snapshot's own.

(a) is drawn again at every set-up. (b) and (c) need forwards over the
pool, so `benchmark/tools/make_cbam_weights.py` computes them once, on a
card, into the configuration's `weights_data` (checked against its
sha256 at set-up), with the counts it matched. `build_snapshot` joins
them into a snapshot .npz of the Flax layout that the program loads
through models/weights.py:load_weights and the reference through
reference/unet_cbam.py.

Nothing here imports the program under test.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import harness
from .reference import decode as ref_decode
from .reference import unet as ref_unet
from .reference import unet_cbam as ref_cbam

HEATMAPS = ("atom_target", "bond_target")


def drawn(seed: int) -> Dict[str, np.ndarray]:
    """(a): every parameter of the model, float32, by Flax key."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in ref_cbam.param_shapes().items():
        if key.endswith("/kernel"):
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            out[key] = (rng.standard_normal(shape, dtype=np.float32)
                        * np.float32(std))
        elif key.endswith("/scale"):
            out[key] = np.ones(shape, np.float32)
        else:
            out[key] = np.zeros(shape, np.float32)
    return out


def write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """An .npz whose bytes are a function of `arrays` alone (members in
    key order, fixed time stamps), written to a temporary name and
    renamed into place."""
    from numpy.lib import format as npf

    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
        for key in sorted(arrays):
            info = zipfile.ZipInfo(key + ".npy", (1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            with zf.open(info, "w") as f:
                npf.write_array(f, np.asanyarray(arrays[key]))
    os.replace(tmp, path)


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def data_paths(cfg: Dict) -> Tuple[str, str]:
    """(the data file, its sha256 file) of a configuration."""
    path = os.path.join(harness.ROOT, cfg["weights_data"])
    return path, os.path.splitext(path)[0] + ".sha256"


def load_data(cfg: Dict) -> Dict[str, np.ndarray]:
    """(b) and (c) from the configuration's data file, once its sha256 is
    the one recorded."""
    path, digest = data_paths(cfg)
    with open(digest) as f:
        want = f.read().split()[0]
    got = sha256(path)
    if got != want:
        raise SystemExit(f"error: {path} has sha256 {got}, not {want}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files if not k.startswith("info/")}


def build_snapshot(cfg: Dict, out_dir: str) -> str:
    """The whole snapshot (a) + (b) + (c), written to out_dir; its path."""
    arrays = drawn(cfg["weights_seed"])
    data = load_data(cfg)
    unknown = set(data) - set(arrays) - {
        k for k in data if k.startswith("batch_stats/")}
    if unknown:
        raise SystemExit(f"error: {sorted(unknown)[:3]} in the data file "
                         "are no parameters of the model")
    arrays.update(data)
    path = os.path.join(out_dir, f"{cfg['name']}.npz")
    np.savez(path, __step__=np.int64(0), **arrays)
    return path


# ---------------------------------------------------------------------------
# Computing (b) and (c) (benchmark/tools/make_cbam_weights.py)
# ---------------------------------------------------------------------------

def _tensors(arrays: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in arrays.items()}


def recalibrate(w: Dict, images_u8: np.ndarray, device) -> None:
    """(b): every BatchNorm's statistics from one batch of drawings,
    written into `w` (float32 tensors on `device`)."""
    ref_cbam.forward(w, ref_decode.binarize(images_u8, device),
                     calibrate=True)


def local_maxima(logit: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) logits of each map's k largest 3x3 local maxima (the
    decode's NMS, no threshold), descending, -inf past the last."""
    pooled = F.max_pool2d(logit[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(pooled == logit, logit,
                        torch.full_like(logit, -float("inf")))
    return torch.sort(peaks.flatten(1), dim=1, descending=True)[0][:, :k]


def peak_count(maxima: torch.Tensor, shift: float = 0.0) -> float:
    """The mean number of peaks a drawing (local maxima above the decode's
    logit threshold, at most k) once `shift` is added to every logit."""
    return float(((maxima + shift) > ref_decode.LOGIT_THRESHOLD).sum(1)
                 .double().mean())


def match_shift(maxima: torch.Tensor, target: float,
                steps: int = 60) -> float:
    """The shift (bisection over [-64, 64]) at which `peak_count` is
    `target`: the count grows with the shift."""
    lo, hi = -64.0, 64.0
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        if peak_count(maxima, mid) < target:
            lo = mid
        else:
            hi = mid
    return hi


def _heatmap_maxima(forward, images_u8: np.ndarray, device,
                    chunk: int) -> Dict[str, torch.Tensor]:
    ks = {"atom_target": ref_decode.MAX_ATOMS,
          "bond_target": ref_decode.MAX_BONDS}
    got = {h: [] for h in HEATMAPS}
    for lo in range(0, len(images_u8), chunk):
        heads = forward(ref_decode.binarize(images_u8[lo:lo + chunk],
                                            device))
        for h in HEATMAPS:
            got[h].append(local_maxima(heads[h][:, 0], ks[h]))
    return {h: torch.cat(v) for h, v in got.items()}


def make(cfg: Dict, calib_u8: np.ndarray, pool_u8: np.ndarray,
         production: str, device, chunk: int = 16):
    """(b) and (c) for `cfg`: ({key: array} of the data file, {count:
    value} of what was matched). `calib_u8`: the calibration drawings;
    `pool_u8`: the drawings the peak counts are taken over; `production`:
    the production snapshot's path."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        return _make(cfg, calib_u8, pool_u8, production, device, chunk)


def _make(cfg, calib_u8, pool_u8, production, device, chunk):
    w = _tensors(drawn(cfg["weights_seed"]), device)
    prod = ref_unet.load_snapshot(production, device)
    for h in ref_unet.HEADS:
        key = f"params/out_{h}/Conv_1/bias"
        w[key] = prod[key].clone()
    recalibrate(w, calib_u8, device)

    prod_max = _heatmap_maxima(lambda ink: ref_unet.forward_f32(prod, ink),
                               pool_u8, device, chunk)
    for h in HEATMAPS:
        w[f"params/out_{h}/Conv_1/bias"].zero_()
    cbam_max = _heatmap_maxima(
        lambda ink: ref_cbam.forward(w, ink, heads=HEATMAPS), pool_u8,
        device, chunk)
    info = {}
    for h in HEATMAPS:
        target = peak_count(prod_max[h])
        shift = match_shift(cbam_max[h], target)
        w[f"params/out_{h}/Conv_1/bias"].fill_(shift)
        info[f"info/{h}/production_peaks"] = target
        info[f"info/{h}/seeded_peaks"] = peak_count(cbam_max[h], shift)
        info[f"info/{h}/bias"] = shift
    data = {k: v.cpu().numpy().astype(np.float32) for k, v in w.items()
            if k.startswith("batch_stats/")
            or (k.startswith("params/out_") and k.endswith("Conv_1/bias"))}
    data.update({k: np.float64(v) for k, v in info.items()})
    return data, info
