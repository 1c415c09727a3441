"""Training/eval metric suite, kept on the device.

Counterpart of abcnet_tpu/train/metrics.py. Metric definitions mirror
the reference's AverageMeter suite (reference src/train.py:143-215):

  * atom/bond detection precision/recall after 3x3 max-pool NMS at
    threshold 0.25, exact-cell and 3x3-tolerance ("precision3/recall3")
  * type/charge/hs accuracy at GT peak cells
  * rho MAE over bond-mass cells
  * omega precision/recall via circular (wrap-padded) 1-D NMS

Every metric is a (numerator-sum, weight) pair of device scalars; the
reference's per-step `.cpu().detach().numpy()` fetches are replaced by
one fetch of the accumulated scalars per logging interval (MeterBank).
The NMS here is the 3x3 max-pool form the JAX package left to XLA
(`reduce_window`), so it is `F.max_pool2d`; the serving path's NMS +
top-K kernel (ops/peaks.py) is not on this path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..data import vocab
from ..ops.losses import activations

NO = vocab.NUM_OMEGA_BINS


def maxpool2d_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME max pool over the H, W axes of (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=1,
                        padding=1).permute(0, 2, 3, 1)


def nms_mask(p: torch.Tensor, threshold: float = 0.25) -> torch.Tensor:
    """Local-maximum mask (train.py:145-151)."""
    return ((maxpool2d_same(p) == p) & (p > threshold)).float()


def circular_dilate(m: torch.Tensor) -> torch.Tensor:
    """Max over each omega bin and its two circular neighbours.
    m: (B, H, W, 60)."""
    return torch.maximum(m, torch.maximum(torch.roll(m, 1, -1),
                                          torch.roll(m, -1, -1)))


def circular_nms_mask(p: torch.Tensor,
                      threshold: float = 0.25) -> torch.Tensor:
    """Circular 1-D NMS over the omega axis (train.py:190-193).
    p: (B, H, W, 60)."""
    return ((circular_dilate(p) == p) & (p > threshold)).float()


def _pr(pred_mask, true_mask) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    tp = torch.sum(pred_mask * true_mask)
    tp3_p = torch.sum(pred_mask * maxpool2d_same(true_mask))
    tp3_r = torch.sum(true_mask * maxpool2d_same(pred_mask))
    np_ = torch.sum(pred_mask)
    nt = torch.sum(true_mask)
    return {
        "precision": (tp, np_),
        "recall": (tp, nt),
        "precision3": (tp3_p, np_),
        "recall3": (tp3_r, nt),
    }


def _acc_at_peaks(p, t, dim=-1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accuracy at labeled cells: sum_c t weighting (train.py:164-171)."""
    cell_mass = torch.sum(t, dim=dim)
    hit = (torch.argmax(t, dim=dim) == torch.argmax(p, dim=dim)).float()
    return torch.sum(cell_mass * hit), torch.sum(cell_mass)


def compute_metrics(preds: Dict[str, torch.Tensor],
                    targets_nhwc: Dict[str, torch.Tensor],
                    threshold: float = 0.25) -> Dict[str, Tuple]:
    """Returns dict name -> (numerator, denominator) device scalars. The
    bond-type accuracy (and the bond_type softmax it needs) is computed
    only when the targets carry the dense bond_type tensor."""
    t = targets_nhwc
    act = activations(preds, [n for n in preds
                              if n != "bond_type" or "bond_type" in t])
    out: Dict[str, Tuple] = {}

    atom_true = (t["atom_target"] == 1.0).float()
    atom_pred = nms_mask(act["atom_target"], threshold)
    for k, v in _pr(atom_pred, atom_true).items():
        out[f"atom_target_{k}"] = v

    bond_true = (t["bond_target"] == 1.0).float()
    bond_pred = nms_mask(act["bond_target"], threshold)
    for k, v in _pr(bond_pred, bond_true).items():
        out[f"bond_target_{k}"] = v

    # Peak-count health signals (per image): a forward whose heatmaps
    # rarely clear the threshold quantizes precision to n/tiny-count,
    # which the averaged ratios hide.
    n_img = torch.tensor(float(atom_true.shape[0]), device=atom_true.device)
    out["atom_peaks_per_img"] = (torch.sum(atom_pred), n_img)
    out["atom_true_per_img"] = (torch.sum(atom_true), n_img)
    out["bond_peaks_per_img"] = (torch.sum(bond_pred), n_img)
    out["bond_true_per_img"] = (torch.sum(bond_true), n_img)

    out["atom_types_acc"] = _acc_at_peaks(act["atom_type"], t["atom_type"])
    out["atom_charges_acc"] = _acc_at_peaks(act["atom_charge"],
                                            t["atom_charge"])
    out["atom_hs_acc"] = _acc_at_peaks(act["atom_hs"], t["atom_hs"])

    if "bond_type" in t:                        # (B, G, G, 6, 60)
        out["bond_types_acc"] = _acc_at_peaks(act["bond_type"],
                                              t["bond_type"], dim=-2)

    mass = t["bond_type_mass"]
    out["bond_rhos_mae"] = (
        torch.sum(torch.abs(act["bond_rho"] - t["bond_rho"]) * mass),
        torch.sum(mass))

    omega_true = (t["bond_omega"] == 1.0).float()
    omega_pred = circular_nms_mask(act["bond_omega"], threshold) * bond_true
    tp = torch.sum(omega_true * omega_pred)
    np_ = torch.sum(omega_pred)
    nt = torch.sum(omega_true)
    out["bond_omega_precision"] = (tp, np_)
    out["bond_omega_recall"] = (tp, nt)
    out["bond_omega_precision3"] = (
        torch.sum(circular_dilate(omega_true) * omega_pred), np_)
    out["bond_omega_recall3"] = (
        torch.sum(omega_true * circular_dilate(omega_pred)), nt)
    return out


class MeterBank:
    """Accumulator for (numerator, denominator) metric pairs — the
    AverageMeter equivalent (reference src/meter.py).

    `update` adds device scalars with asynchronous ops (no host sync);
    the single blocking fetch happens in `averages()`, once per logging
    interval."""

    def __init__(self):
        self.num: Dict[str, torch.Tensor] = {}
        self.den: Dict[str, torch.Tensor] = {}

    def update(self, metrics: Dict[str, Tuple]) -> None:
        for k, (n, d) in metrics.items():
            if k in self.num:
                self.num[k] = self.num[k] + n
                self.den[k] = self.den[k] + d
            else:
                self.num[k] = n
                self.den[k] = d

    def averages(self) -> Dict[str, float]:
        """One blocking fetch; metrics whose denominator never fired are
        omitted (e.g. atom_hs on an evaluation where no atom carries an
        hs label): printed as 0.0000 they would read as a broken model."""
        if not self.num:
            return {}
        keys = list(self.num)
        host = torch.stack([torch.stack([self.num[k].float(),
                                         self.den[k].float()])
                            for k in keys]).cpu().tolist()
        return {k: n / d for k, (n, d) in zip(keys, host) if d}

    def reset(self) -> None:
        self.num.clear()
        self.den.clear()
