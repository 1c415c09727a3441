"""Penalty-reduced focal losses under learned uncertainty weighting.

Counterpart of abcnet_tpu/ops/losses.py; math parity with the reference
training loop (reference src/train.py:95-137):

  * heatmaps (atom/bond): CenterNet focal
      -(t==1)(1-p)^2 log p - (1-t)^4 p^2 log(1-p), normalized by #peaks
  * type/charge/hs: focal CE  -w_c t (1-p)^2 log p / sum(t)
    with the rare-element weight vector on atom types (train.py:16)
  * rho: L1 masked by bond-type mass
  * omega: circular multi-label focal BCE weighted by per-cell omega mass
  * every term scaled by exp(-s_i) + s_i with the learned s vector
    (indices 5 and 8 unused, rho scaled by 0.5*exp(-s6)+s6)

Two bond-type implementations:
  * dense: consumes the full (6,60,128,128) target (tests/eval)
  * fused: gathers log-softmax at labeled halo cells only — the focal CE
    over bond types has no negative term, so the dense tensor never
    needs to exist.

PyTorch runs eagerly, so nothing deletes an activation that no loss
reads: `activations` therefore computes only the heads it is asked for.
The f32 softmax over bond_type alone is (64,128,128,6,60) = 1.5 GB at
batch 64, plus its clamp and its backward; on the fused path it is
never built.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data import vocab
from ..models.unet import HEAD_NAMES
from .targets import _CENTER3, _OFF3

EPS_CLAMP = 1e-5
G = vocab.GRID
NO = vocab.NUM_OMEGA_BINS
NB = vocab.NUM_BOND_CLASSES


def _clamp(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, EPS_CLAMP, 1.0 - EPS_CLAMP)


def activations(preds: Dict[str, torch.Tensor],
                names: Optional[Iterable[str]] = None
                ) -> Dict[str, torch.Tensor]:
    """Head activations (train.py:95-105) of the heads in `names` (all
    eight if None). preds are NHWC logits, possibly bf16 straight off
    the heads: each is upcast here, so the loss and metric math runs in
    f32. Outputs keep NHWC with class axes last (bond_type ->
    (B,H,W,6,60))."""
    out = {}
    for name in (HEAD_NAMES if names is None else names):
        x = preds[name].float()
        if name in ("atom_target", "bond_target", "bond_omega"):
            out[name] = _clamp(torch.sigmoid(x))
        elif name in ("atom_type", "atom_charge", "atom_hs"):
            out[name] = _clamp(torch.softmax(x, dim=-1))
        elif name == "bond_type":
            x = x.reshape(*x.shape[:-1], NB, NO)
            out[name] = _clamp(torch.softmax(x, dim=-2))
        elif name == "bond_rho":
            out[name] = torch.abs(x)
        else:
            raise KeyError(name)
    return out


def heatmap_focal(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """CenterNet penalty-reduced focal (train.py:107-108)."""
    pos = (t == 1.0).to(p.dtype)
    loss = torch.sum(-pos * (1 - p) ** 2 * torch.log(p)
                     - (1 - t) ** 4 * p ** 2 * torch.log(1 - p))
    return loss / torch.clamp(torch.sum(pos), min=1.0)


def class_focal(p: torch.Tensor, t: torch.Tensor, weights=None,
                denom_eps: float = 0.0) -> torch.Tensor:
    """Focal CE -w t (1-p)^2 log p / (sum t + eps)  (train.py:109-114);
    without eps the denominator is max(sum t, 1e-6)."""
    term = -t * (1 - p) ** 2 * torch.log(p)
    if weights is not None:
        term = term * weights
    denom = (torch.sum(t) + denom_eps if denom_eps
             else torch.clamp(torch.sum(t), min=1e-6))
    return torch.sum(term) / denom


def omega_focal(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Circular multi-label focal BCE, masked to bond cells via per-cell
    omega mass (train.py:124-125). p, t: (B, H, W, 60)."""
    mass = torch.sum(t, dim=-1, keepdim=True)
    pos = (t == 1.0).to(p.dtype)
    inner = (pos * (1 - p) ** 2 * torch.log(p)
             + (1 - t) ** 4 * p ** 2 * torch.log(1 - p))
    return -torch.sum(mass * inner) / torch.clamp(torch.sum(t), min=1e-6)


def rho_l1(pred: torch.Tensor, rho_t: torch.Tensor,
           mass: torch.Tensor) -> torch.Tensor:
    """Masked L1 (train.py:121); mass = sum over classes of bond_type."""
    return torch.sum(torch.abs(pred - rho_t) * mass) / torch.clamp(
        torch.sum(mass), min=1e-6)


_ATOM_W = np.asarray(vocab.ATOM_TYPE_WEIGHTS, np.float32)


def set_atom_type_weights(weights) -> None:
    """Override the per-class atom-type focal weights for later calls of
    compute_losses. The reference hardcodes (1,.1,.1,.1,1,...,10x5)
    (train.py:16), which stays the default."""
    global _ATOM_W
    w = np.asarray(weights, np.float32)
    if w.shape != (vocab.NUM_ATOM_CLASSES,):
        raise ValueError(f"atom-type weights have shape {w.shape}, want "
                         f"({vocab.NUM_ATOM_CLASSES},)")
    _ATOM_W = w


def _to_nhwc_targets(targets: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Scatter targets are channel-first (reference layout); heads are
    NHWC. Permuted views, no copy."""
    out = {k: v.permute(0, 2, 3, 1) for k, v in targets.items()
           if k != "bond_type"}
    if "bond_type" in targets:
        # (B, 6, 60, G, G) -> (B, G, G, 6, 60)
        out["bond_type"] = targets["bond_type"].permute(0, 3, 4, 1, 2)
    return out


def compute_losses(preds: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor] = None,
                   fused_bond_type: bool = True) -> Dict[str, torch.Tensor]:
    """All eight loss terms. `targets` are scatter-built channel-first
    maps; `batch` (compact labels) is required for the fused bond-type
    path."""
    act = activations(preds, [n for n in HEAD_NAMES
                              if not (fused_bond_type and n == "bond_type")])
    t = _to_nhwc_targets(targets)
    atom_w = torch.from_numpy(_ATOM_W).to(act["atom_type"].device)

    losses = {}
    losses["atom_target"] = heatmap_focal(act["atom_target"],
                                          t["atom_target"])
    losses["bond_target"] = heatmap_focal(act["bond_target"],
                                          t["bond_target"])
    losses["atom_type"] = class_focal(act["atom_type"], t["atom_type"],
                                      weights=atom_w)
    losses["atom_charge"] = class_focal(act["atom_charge"], t["atom_charge"])
    losses["atom_hs"] = class_focal(act["atom_hs"], t["atom_hs"],
                                    denom_eps=0.1)
    losses["bond_omega"] = omega_focal(act["bond_omega"], t["bond_omega"])
    losses["bond_rho"] = rho_l1(act["bond_rho"], t["bond_rho"],
                                t["bond_type_mass"])
    if fused_bond_type:
        if batch is None:
            raise ValueError("the fused bond-type loss needs the compact "
                             "labels (batch)")
        losses["bond_type"] = fused_bond_type_loss(preds["bond_type"], batch)
    else:
        losses["bond_type"] = class_focal(act["bond_type"], t["bond_type"])
    return losses


def fused_bond_type_loss(bond_type_logits: torch.Tensor,
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Gather-based focal CE over bond types.

    The dense loss is -sum t (1-p)^2 log p / sum t with t nonzero only on
    the 27-cell halos of each labeled (type, omega, x, y). The 6-class
    logit vectors at exactly those cells are gathered first, and the
    log-softmax is taken on the small (B, Bn, 27, 6) slice, so the
    (B, G, G, 6, 60) softmax and its backward never exist. Divergence
    from dense: overlapping halos of different bonds double-count (rare;
    the dense overwrite keeps one); spatial out-of-bounds cells are
    masked like the reference's slice clamping."""
    b, gh, gw = bond_type_logits.shape[:3]
    dev = bond_type_logits.device
    logits = bond_type_logits.reshape(b, gh, gw, NB, NO)
    off = torch.from_numpy(_OFF3).to(dev)                       # (27, 3)
    center = torch.from_numpy(_CENTER3).to(dev)                 # (27,)
    bonds_i = batch["bonds_i"].long()
    bn = bonds_i.shape[1]
    valid = (torch.arange(bn, device=dev)[None, :]
             < batch["n_bonds"].long()[:, None]).float()        # (B, Bn)
    ho = torch.remainder(bonds_i[:, :, 3, None] + off[:, 0], NO)
    hx = bonds_i[:, :, 0, None] + off[:, 1]                     # (B, Bn, 27)
    hy = bonds_i[:, :, 1, None] + off[:, 2]
    inb = ((hx >= 0) & (hx < gh) & (hy >= 0) & (hy < gw)).float()
    hxc, hyc = hx.clamp(0, gh - 1), hy.clamp(0, gw - 1)
    img = torch.arange(b, device=dev)[:, None, None]
    # The advanced indices are split by the class slice, so their
    # broadcast shape leads: (B, Bn, 27, 6), as in numpy.
    vecs = logits[img, hxc, hyc, :, ho].float()
    lp_vec = F.log_softmax(vecs, dim=-1)
    lp = torch.gather(lp_vec, -1, bonds_i[:, :, 2, None, None].expand(
        b, bn, 27, 1))[..., 0]                                  # (B, Bn, 27)
    p = torch.exp(lp)
    tvals = torch.where(center, 1.0, 0.5) * inb * valid[:, :, None]
    loss = torch.sum(-tvals * (1 - p) ** 2 * lp)
    return loss / torch.clamp(torch.sum(tvals), min=1e-6)


# Uncertainty weighting (train.py:127-137). s has 10 entries; the mapping
# below reproduces the reference index assignment exactly.
S_INDEX = {"atom_target": 0, "bond_target": 1, "atom_type": 2,
           "atom_charge": 3, "bond_type": 4, "bond_rho": 6,
           "bond_omega": 7, "atom_hs": 9}


def total_loss(losses: Dict[str, torch.Tensor],
               s: torch.Tensor) -> torch.Tensor:
    total = 0.0
    for name, idx in S_INDEX.items():
        scale = torch.exp(-s[idx]) + s[idx]
        if name == "bond_rho":
            scale = 0.5 * torch.exp(-s[idx]) + s[idx]
        total = total + losses[name] * scale
    return total
