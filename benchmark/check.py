"""The comparison that decides `correct` for the conversion cells.

The program's output of a compared batch is its host peak dict (what the
device program produced: unpack, backbone, NMS/top-K, the sparse heads)
and the SMILES its host assembly made of it. The plain reference
(`reference/`) works the peaks out again from the same drawings and the
snapshot file, and the frozen assembler reads the program's peak dict to
judge the program's SMILES. The numbers (a cell holds some of them to a
limit in `limits/<cell>.json`):

  * logit_gap_mean: at every peak the program reports (atom cells; bond
    entries as cell and omega bin, the bin taken modulo the half turn
    where the two sides are matched, since a plain bond is written at
    both of its antipodal bins), the gap between the program's logit
    (from its sigmoid score) and the reference's logit at that same cell
    (the atom heatmap; omega at the entry's bin), both clipped to +-8
    (past it a float32 sigmoid keeps too few digits to invert), the mean
    over all of them;
  * missed_share: the reference's sure peaks (an atom cell scored 0.5
    or more; a bond entry whose cell and omega bin both score 0.5 or
    more) that the program has nowhere near (no atom peak within one
    cell; no bond entry within one cell and one bin), over those peaks;
  * unmatched_share: peaks that one side has and the other lacks at
    exactly that cell (and bin), over all the peaks of both sides;
  * class_mismatch_share: at the peaks both have, the argmax decisions
    that differ (atom type, charge, hydrogens; bond type), over all
    those decisions;
  * class_gap_mean: at the peaks both have, how far the reference's
    logit of the class the program chose lies below the reference's
    best logit of that head at that cell (a bond's type at the program's
    own omega bin), the mean over all those decisions (0 where they
    agree): a flip near a tie costs little, a wrong head much;
  * delta_gap_mean: at the bond entries both have, the widest component
    of the gap between the program's delta and the reference's at the
    program's own omega bin (rho = |bond_rho logit| there, along the
    bin's direction), in grid cells, the mean over those entries;
  * sub_gap_mean: at the atom peaks and bond entries both have, the
    widest component of the gap between the sub-cell offsets (atom_sub,
    bond_sub), in grid cells, the mean over them;
  * smiles_mismatch: images whose SMILES the frozen assembler, reading
    the program's own peaks, spells otherwise than the program did
    (exact: limit 0);
  * smiles_ref_mismatch_share: images whose SMILES the frozen assembler,
    reading the reference's peaks, spells otherwise than the program
    did, over the images compared.

A cell holds the numbers that separate its sound runs from its control
(PERF.md gives the readings); run.py prints the others on standard error
as readings (with logit_gap_max and delta_gap_max, the widest gaps, which
swing by their nature), and readings.py prints them all.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import decode as ref_decode
from .reference import unet as ref_unet

LOGIT_RANGE = 8.0
LINES = 30          # omega bins modulo the half turn


def _logit(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.float64)
    with np.errstate(divide="ignore"):
        return np.log(p) - np.log1p(-p)


def _bins(delta: np.ndarray) -> np.ndarray:
    """Each bond entry's omega bin (0..59) from its delta's direction."""
    ang = np.arctan2(delta[..., 1].astype(np.float64),
                     delta[..., 0].astype(np.float64))
    return np.rint((ang + math.pi / 2 - math.pi / 60) / (math.pi / 30)
                   ).astype(np.int64) % 60


class Tally:
    """Running sums of the comparison over compared images."""

    def __init__(self):
        self.unmatched = self.union = 0
        self.missed = self.sure = 0
        self.class_bad = self.class_n = 0
        self.class_gap = 0.0
        self.delta_gap, self.delta_n = 0.0, 0
        self.sub_gap, self.sub_n = 0.0, 0
        self.smiles_ref_bad = 0
        self.gap_sum = 0.0
        self.gap_n = 0
        self.gap_max = 0.0
        self.delta_max = 0.0
        self.smiles_bad = 0
        self.images = 0

    def numbers(self) -> Dict[str, float]:
        return {
            "logit_gap_mean": (self.gap_sum / self.gap_n if self.gap_n
                               else math.inf),
            "missed_share": self.missed / max(self.sure, 1),
            "unmatched_share": self.unmatched / max(self.union, 1),
            "class_mismatch_share": self.class_bad / max(self.class_n, 1),
            "class_gap_mean": self.class_gap / max(self.class_n, 1),
            "delta_gap_mean": self.delta_gap / max(self.delta_n, 1),
            "sub_gap_mean": self.sub_gap / max(self.sub_n, 1),
            "smiles_mismatch": float(self.smiles_bad),
            "smiles_ref_mismatch_share": self.smiles_ref_bad / max(
                self.images, 1),
            "logit_gap_max": self.gap_max,
            "delta_gap_max": self.delta_max,
            "images_compared": float(self.images),
        }


def _near(ref: np.ndarray, prog: np.ndarray, bins: bool) -> np.ndarray:
    """For each reference key (row, col[, bin]) whether some program key
    lies within one cell (and one bin, circularly)."""
    if not len(prog):
        return np.zeros(len(ref), bool)
    d = np.abs(ref[:, None, :] - prog[None, :, :])
    ok = (d[..., 0] <= 1) & (d[..., 1] <= 1)
    if bins:
        ok &= np.minimum(d[..., 2], LINES - d[..., 2]) <= 1
    return ok.any(1)


def _side(xy, valid, bins=None):
    """{key: index} of the valid entries: an atom's (row, col); a bond
    entry's (row, col, line), its omega bin modulo 30: a plain bond is
    written at both of its antipodal bins, so either stands for it."""
    keys = xy if bins is None else np.concatenate(
        [xy, (bins % LINES)[:, None]], 1)
    return {tuple(k): i for i, k in enumerate(keys.astype(np.int64).tolist())
            if valid[i]}


def _compare_image(t: Tally, P: Dict, R: Dict, b: int, pb: int,
                   maps: Dict) -> None:
    """Program row `pb` of P against reference row `b` of R (whose dense
    maps on the device are `maps`)."""
    dev = maps["atom"].device
    pa = _side(P["atom_xy"][pb], P["atom_valid"][pb])
    ra = _side(R["atom_xy"][b], R["atom_valid"][b])
    pbins = _bins(P["bond_delta"][pb])
    pe = _side(P["bond_xy"][pb], P["bond_valid"][pb], pbins)
    re_ = _side(R["bond_xy"][b], R["bond_valid"][b], R["bond_bin"][b])
    gaps = []
    r_sure = (R["atom_score"][b] >= 0.5,
              (R["bond_score"][b] >= 0.5) & (R["bond_cell_score"][b] >= 0.5))
    for p, r, pscore, rsure, bins in (
            (pa, ra, P["atom_score"][pb], r_sure[0], False),
            (pe, re_, P["bond_score"][pb], r_sure[1], True)):
        both = [k for k in p if k in r]
        t.unmatched += len(p) + len(r) - 2 * len(both)
        t.union += len(p) + len(r) - len(both)
        sure = np.array([k for k, i in r.items() if rsure[i]],
                        np.int64).reshape(-1, 3 if bins else 2)
        t.sure += len(sure)
        t.missed += int((~_near(sure, np.array(list(p), np.int64).reshape(
            -1, 3 if bins else 2), bins)).sum())
        if p:
            keys = torch.tensor(list(p), device=dev)
            if bins:
                full = torch.from_numpy(pbins[list(p.values())]).to(dev)
                ref = maps["omega"][b, keys[:, 0], keys[:, 1], full]
            else:
                ref = maps["atom"][b, keys[:, 0], keys[:, 1]]
            prog = _logit(np.array([pscore[i] for i in p.values()]))
            gaps.append(np.abs(np.clip(prog, -LOGIT_RANGE, LOGIT_RANGE)
                               - np.clip(ref.double().cpu().numpy(),
                                         -LOGIT_RANGE, LOGIT_RANGE)))
    heads = maps["heads"]

    def below_best(logits: torch.Tensor, chosen) -> float:
        """Summed gap of the chosen classes' logits below the best."""
        idx = torch.as_tensor(np.asarray(chosen, np.int64), device=dev)
        sel = logits.gather(-1, idx[:, None])[:, 0]
        return float((logits.amax(-1) - sel).double().sum())

    both = [k for k in pa if k in ra]
    if both:
        cells = torch.tensor(both, device=dev)
        for key in ("atom_type", "atom_charge", "atom_hs"):
            chosen = [int(P[key][pb][pa[k]]) for k in both]
            t.class_bad += sum(c != int(R[key][b][ra[k]])
                               for c, k in zip(chosen, both))
            t.class_gap += below_best(
                heads[key][b, cells[:, 0], cells[:, 1]].float(), chosen)
        t.class_n += 3 * len(both)
        ps = np.array([P["atom_sub"][pb][pa[k]] for k in both], np.float64)
        rs = np.array([R["atom_sub"][b][ra[k]] for k in both], np.float64)
        t.sub_gap += float(np.abs(ps - rs).max(1).sum())
        t.sub_n += len(both)
    both = [k for k in pe if k in re_]
    if both:
        t.class_bad += sum(int(P["bond_type"][pb][pe[k]])
                           != int(R["bond_type"][b][re_[k]]) for k in both)
        t.class_n += len(both)
        rows = [pe[k] for k in both]
        cells = torch.tensor([k[:2] for k in both], device=dev)
        pbin = torch.from_numpy(pbins[rows]).to(dev)
        bt = heads["bond_type"][b, cells[:, 0], cells[:, 1]].float()
        bt = bt.reshape(len(both), -1, 60).gather(
            2, pbin[:, None, None].expand(-1, bt.shape[-1] // 60, 1))[..., 0]
        t.class_gap += below_best(bt, [int(P["bond_type"][pb][i])
                                       for i in rows])
        rho = heads["bond_rho"][b, cells[:, 0], cells[:, 1]].double().gather(
            1, pbin[:, None])[:, 0].abs().cpu().numpy()
        ang = pbins[rows] * (math.pi / 30) + math.pi / 60 - math.pi / 2
        dr = rho[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)
        dp = P["bond_delta"][pb][rows].astype(np.float64)
        d = np.abs(dp - dr).max(1)
        t.delta_gap += float(d.sum())
        t.delta_n += len(both)
        t.delta_max = max(t.delta_max, float(d.max()))
        ps = P["bond_sub"][pb][rows].astype(np.float64)
        rs = np.array([R["bond_sub"][b][re_[k]] for k in both], np.float64)
        t.sub_gap += float(np.abs(ps - rs).max(1).sum())
        t.sub_n += len(both)
    if gaps:
        g = np.concatenate(gaps)
        t.gap_sum += float(g.sum())
        t.gap_n += int(g.size)
        if g.size:
            t.gap_max = max(t.gap_max, float(g.max()))
    t.images += 1


def reference_peaks(w: Dict, images_u8: np.ndarray, q: Optional[Dict],
                    chunk: int = 16):
    """Yield (row offset, reference peaks, device maps) over `images_u8`
    in chunks, the reference's work on the device."""
    dev = next(iter(w.values())).device
    for lo in range(0, len(images_u8), chunk):
        ink = ref_decode.binarize(images_u8[lo:lo + chunk], dev)
        heads = ref_unet.forward(w, ink, q)
        R, maps = ref_decode.decode(heads)
        del heads
        yield lo, R, maps


def compare_batches(w: Dict, q: Optional[Dict], batches: List[Dict],
                    assemble=None) -> Dict[str, float]:
    """Compare each batch {"images": (B, H, W) uint8, "peaks": the
    program's host peak dict, "smiles": its SMILES or None} with the
    reference; `assemble(peaks, i)` is the frozen assembler, run on the
    program's peaks and on the reference's (skipped when None or where a
    batch has no "smiles")."""
    t = Tally()
    for batch in batches:
        P = batch["peaks"]
        smiles = batch.get("smiles") if assemble is not None else None
        for lo, R, maps in reference_peaks(w, batch["images"], q):
            for b in range(R["atom_valid"].shape[0]):
                _compare_image(t, P, R, b, lo + b, maps)
                if smiles is not None:
                    t.smiles_ref_bad += assemble(R, b) != smiles[lo + b]
            del maps
        if smiles is not None:
            for i, s in enumerate(smiles):
                t.smiles_bad += assemble(P, i) != s
    return t.numbers()


def judge(numbers: Dict[str, float], lim: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} of every number the cell holds to a
    limit (a number passes at or under its limit)."""
    return {k: {"value": numbers[k], "limit": lim[k]} for k in lim}


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def frozen_assembler():
    """`assemble(peaks, i)` of the frozen copy of the host assembler,
    with the program's serving defaults (sub-cell matching, re-matching
    of self-loops, the valence prune)."""
    from .reference.frozen.infer.assemble import assemble_smiles

    def assemble(peaks, i):
        return assemble_smiles(peaks, i)
    return assemble
