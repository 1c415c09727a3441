"""Plain PyTorch reference of the serving decode: binarize, peaks, heads.

From a batch of uint8 drawings to the peak arrays that the host
assembler reads, with the semantics that the configuration's decode
states (the reference's img2smiles2.py:64-170 as the port serves it):

  * ink = gray / 255 < threshold (0.6);
  * 3x3 max-pool NMS on the atom and bond heatmap logits, logit > -1,
    the top K cells by logit (K = 128 atoms, 160 bonds), ties by
    ascending flat index (row-major);
  * at each atom peak the argmax of the type (14), charge (3) and
    hydrogen (2) logits;
  * at each bond peak the 60 omega bins: a circular 3-bin local maximum
    above -1, antipodal suppression, the halo filter (a bin dies where
    the best of the 9 neighbouring cells' 3-bin windows, cells off the
    map excluded, beats it by more than 1), up to 4 bins by logit;
    at each bin the argmax of the 6 bond types, rho = |rho logit|, and
    delta = rho (cos a, sin a), a = bin pi/30 + pi/60 - pi/2;
  * sub-cell offsets: a parabola through each axis's three cells,
    clipped to +-0.49 (edge cells repeat the border value).

The heads come dense from `unet.forward`; evaluating a head at a cell
equals the program's sparse evaluation there. Scores are sigmoids.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

THRESHOLD = 0.6
LOGIT_THRESHOLD = -1.0
MAX_ATOMS, MAX_BONDS, OMEGA_PER_BOND = 128, 160, 4
HALO_MARGIN = 1.0
NO, NB = 60, 6


def binarize(images_u8: np.ndarray, device) -> torch.Tensor:
    """(B, H, W) uint8 -> (B, 1, H, W) float32 ink masks on `device`."""
    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    return ((x.float() / 255.0) < THRESHOLD).float()[:, None]


def _stable_desc(x: torch.Tensor, k: int):
    top, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def nms_topk(logit: torch.Tensor, k: int):
    """logit (B, G, G) -> (score, row, col, valid), each (B, k)."""
    pooled = F.max_pool2d(logit[:, None], 3, stride=1, padding=1)[:, 0]
    keep = (pooled == logit) & (logit > LOGIT_THRESHOLD)
    flat = torch.where(keep, logit, torch.full_like(logit, -math.inf))
    top, idx = _stable_desc(flat.flatten(1), k)
    g = logit.shape[-1]
    return top, idx // g, idx % g, torch.isfinite(top)


def _circ_max3(w: torch.Tensor) -> torch.Tensor:
    return torch.maximum(torch.maximum(w.roll(1, -1), w), w.roll(-1, -1))


def _antipodal_keep(w: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(NO, device=w.device)
    opp = torch.stack([(idx + 29) % NO, (idx + 30) % NO, (idx + 31) % NO])
    opp_max = w[..., opp].amax(dim=-2)
    return torch.where(idx < 30, w >= opp_max, w > opp_max)


def _subcell(logit: torch.Tensor, r: torch.Tensor, c: torch.Tensor):
    g = logit.shape[-1]
    b = torch.arange(logit.shape[0], device=logit.device)[:, None]

    def at(rr, cc):
        return logit[b, rr, cc]

    def off(lo, mid, hi):
        den = torch.clamp(2.0 * mid - lo - hi, min=1e-6)
        return torch.clamp(0.5 * (hi - lo) / den, -0.49, 0.49)

    mid = at(r, c)
    return torch.stack([
        off(at((r - 1).clamp(min=0), c), mid, at((r + 1).clamp(max=g - 1), c)),
        off(at(r, (c - 1).clamp(min=0)), mid, at(r, (c + 1).clamp(max=g - 1))),
    ], dim=-1)


@torch.no_grad()
def decode(heads: Dict[str, torch.Tensor]):
    """NCHW float32 logits of every head -> (host peak arrays with the
    keys, shapes and meaning of the program's peak dict, plus each bond
    entry's omega bin under "bond_bin" and its cell's bond heatmap score
    under "bond_cell_score"; the atom heatmap (B, G, G), the omega logits
    (B, G, G, 60) and every head as (B, G, G, channels) under "heads", on
    the device, where the comparison looks up the program's cells)."""
    a_logit = heads["atom_target"][:, 0]
    b_logit = heads["bond_target"][:, 0]
    bsz, g = a_logit.shape[0], a_logit.shape[-1]
    bi = torch.arange(bsz, device=a_logit.device)[:, None]
    a_raw, ar, ac, a_valid = nms_topk(a_logit, MAX_ATOMS)
    b_raw, br, bc, b_valid = nms_topk(b_logit, MAX_BONDS)

    def at(name, r, c):                        # (B, K, channels)
        return heads[name].permute(0, 2, 3, 1)[bi, r, c]

    out = {
        "atom_score": torch.sigmoid(a_raw),
        "atom_xy": torch.stack([ar, ac], -1),
        "atom_type": at("atom_type", ar, ac).argmax(-1),
        "atom_charge": at("atom_charge", ar, ac).argmax(-1),
        "atom_hs": at("atom_hs", ar, ac).argmax(-1),
        "atom_valid": a_valid,
        "atom_sub": _subcell(a_logit, ar, ac),
    }

    omega = heads["bond_omega"].permute(0, 2, 3, 1)       # (B, G, G, 60)
    w = omega[bi, br, bc]
    # halo: the 3-bin window maxima of the 9 neighbouring cells, cells off
    # the map excluded
    pad = F.pad(_circ_max3(omega).permute(0, 3, 1, 2), (1, 1, 1, 1),
                value=-math.inf).permute(0, 2, 3, 1)
    neigh = torch.stack([pad[bi, br + 1 + dr, bc + 1 + dc]
                         for dr in (-1, 0, 1) for dc in (-1, 0, 1)], 2)
    keep = (_circ_max3(w) == w) & (w > LOGIT_THRESHOLD) & _antipodal_keep(w)
    keep &= w >= neigh.amax(2) - HALO_MARGIN
    o_raw, o_bin = _stable_desc(torch.where(keep, w, torch.full_like(
        w, -math.inf)), OMEGA_PER_BOND)
    o_valid = torch.isfinite(o_raw)
    bt = at("bond_type", br, bc).reshape(bsz, MAX_BONDS, NB, NO)
    btype = torch.gather(bt, 3, o_bin[:, :, None, :].expand(
        -1, -1, NB, -1)).argmax(2)
    rho = torch.gather(at("bond_rho", br, bc), 2, o_bin).abs()
    ang = o_bin * (math.pi / 30) + math.pi / 60 - math.pi / 2
    m = OMEGA_PER_BOND

    def flat(t):
        return t.reshape(bsz, MAX_BONDS * m, *t.shape[3:])

    out.update({
        "bond_score": flat(torch.where(o_valid, torch.sigmoid(o_raw),
                                       torch.zeros_like(o_raw))),
        "bond_xy": flat(torch.stack([br, bc], -1)[:, :, None].expand(
            -1, -1, m, -1)),
        "bond_delta": flat(torch.stack([rho * torch.cos(ang),
                                        rho * torch.sin(ang)], -1)),
        "bond_type": flat(btype),
        "bond_valid": flat(o_valid & b_valid[..., None]),
        "bond_sub": flat(_subcell(b_logit, br, bc)[:, :, None].expand(
            -1, -1, m, -1)),
        "bond_bin": flat(o_bin),
        "bond_cell_score": flat(torch.sigmoid(b_raw)[:, :, None].expand(
            -1, -1, m)),
    })
    peaks = {k: v.cpu().numpy() for k, v in out.items()}
    return peaks, {"atom": a_logit, "omega": omega, "heads": {
        k: v.permute(0, 2, 3, 1) for k, v in heads.items()}}
