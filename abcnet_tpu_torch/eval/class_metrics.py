"""Per-class precision/recall tables — test_accuracy.py parity.

Counterpart of abcnet_tpu/eval/class_metrics.py. The reference
accumulates per-class tp/fp/fn for the 14 atom classes, 3 charge classes
and 6 bond classes with a 3x3 spatial tolerance (reference
src/test_accuracy.py:32-186) by looping over peaks on the host. Here the
counts are dense masked reductions on the device, one pass for all the
classes of a group (a one-hot class axis through one 3x3 max pool), and
come back as integer (tp_p, n_p, tp_r, n_t) vectors: the JAX package's
f32 sums of 0/1 products, exactly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..data import vocab
from ..ops.losses import activations
from ..train.metrics import maxpool2d_same, nms_mask

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# The heads whose activations the counts read.
_HEADS = ("atom_target", "atom_type", "atom_charge", "bond_target",
          "bond_omega", "bond_type")


def _per_class_pr(pred_peaks: torch.Tensor, pred_cls: torch.Tensor,
                  true_peaks: torch.Tensor, true_cls: torch.Tensor,
                  n_classes: int) -> Counts:
    """pred_peaks/true_peaks: (B, H, W) {0,1}; *_cls: (B, H, W) int.

    tp (precision side): predicted peak of class c with a true peak of
    class c in its 3x3 neighborhood; recall side symmetric — matching
    the reference's tolerant counting (test_accuracy.py:128-186).
    Returns int64 (tp_p, n_p, tp_r, n_t), each (n_classes,)."""
    p_c = F.one_hot(pred_cls, n_classes) * pred_peaks[..., None].long()
    t_c = F.one_hot(true_cls, n_classes) * true_peaks[..., None].long()
    t_dil = maxpool2d_same(t_c.float()).long()
    p_dil = maxpool2d_same(p_c.float()).long()
    dims = (0, 1, 2)
    return ((p_c * t_dil).sum(dims), p_c.sum(dims),
            (t_c * p_dil).sum(dims), t_c.sum(dims))


def _class_at_best_omega(type_map: torch.Tensor,
                         omega_best: torch.Tensor) -> torch.Tensor:
    """The argmax class of a (B, H, W, 6, 60) bond-type map at each cell's
    omega bin `omega_best` (B, H, W): jnp.take_along_axis as a gather."""
    cls = torch.argmax(type_map, dim=-2)                  # (B, H, W, 60)
    return torch.gather(cls, -1, omega_best[..., None])[..., 0]


@torch.no_grad()
def per_class_counts(preds: Dict[str, torch.Tensor],
                     targets_nhwc: Dict[str, torch.Tensor],
                     threshold: float = 0.25) -> Dict[str, Counts]:
    """Per-class (tp_p, n_p, tp_r, n_t) int64 count vectors, on the
    device of `preds` (NHWC logits; targets NHWC as
    ops.losses._to_nhwc_targets gives them), by group name in sorted
    order. argmax keeps the first index on ties, as jnp.argmax does."""
    act = activations(preds, _HEADS)
    t = targets_nhwc
    out = {}

    atom_pred_peaks = nms_mask(act["atom_target"], threshold)[..., 0]
    atom_true_peaks = (t["atom_target"][..., 0] == 1.0).float()
    out["atom_type"] = _per_class_pr(
        atom_pred_peaks, torch.argmax(act["atom_type"], dim=-1),
        atom_true_peaks, torch.argmax(t["atom_type"], dim=-1),
        vocab.NUM_ATOM_CLASSES)
    out["atom_charge"] = _per_class_pr(
        atom_pred_peaks, torch.argmax(act["atom_charge"], dim=-1),
        atom_true_peaks, torch.argmax(t["atom_charge"], dim=-1),
        vocab.NUM_CHARGE_CLASSES)

    # Bond classes: class at the peak cell's strongest omega bin.
    bond_pred_peaks = nms_mask(act["bond_target"], threshold)[..., 0]
    bond_true_peaks = (t["bond_target"][..., 0] == 1.0).float()
    if "bond_type" in t:
        omega_best_t = torch.argmax(t["bond_type"].sum(dim=-2), dim=-1)
        omega_best_p = torch.argmax(act["bond_omega"], dim=-1)
        out["bond_type"] = _per_class_pr(
            bond_pred_peaks,
            _class_at_best_omega(act["bond_type"], omega_best_p),
            bond_true_peaks,
            _class_at_best_omega(t["bond_type"], omega_best_t),
            vocab.NUM_BOND_CLASSES)
    # Groups in sorted order, as a jitted JAX function returns a dict, so
    # per_class_report prints its tables in the JAX package's order.
    return dict(sorted(out.items()))


def per_class_report(counts: Dict[str, Tuple]) -> str:
    """Format accumulated count vectors into the reference's printed
    precision/recall tables (test_accuracy.py:271-339)."""
    names = {
        "atom_type": list(vocab.ATOM_VOCAB.keys()),
        "atom_charge": ["0", "+1", "-1"],
        "bond_type": ["single", "double", "triple", "aromatic",
                      "wedge", "hash"],
    }
    lines = []
    for group, (tp_p, np_, tp_r, nt) in counts.items():
        lines.append(f"== {group} ==")
        for c, label in enumerate(names.get(group, [])):
            prec = float(tp_p[c]) / max(float(np_[c]), 1e-9)
            rec = float(tp_r[c]) / max(float(nt[c]), 1e-9)
            lines.append(f"  {label:<10s} precision={prec:.4f} "
                         f"recall={rec:.4f} n={int(nt[c])}")
    return "\n".join(lines)
