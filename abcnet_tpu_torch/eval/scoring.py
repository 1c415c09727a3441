"""End-to-end SMILES scoring — parity with the reference's cal_acc.py.

Copy of abcnet_tpu/eval/scoring.py with the `csv` module in place of
pandas. Three numbers over (smiles, smiles_pred) pairs (the reference's
src/cal_acc.py:13-51):
  1. exact match after tautomer canonicalization of both sides
  2. exact match of canonical non-isomeric SMILES
  3. mean Morgan(radius 3) Dice similarity
all computed with the package's own chem stack (no RDKit).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Optional, Sequence

from ..chem import canonical_smiles, from_smiles
from ..chem.fingerprint import morgan_dice
from ..chem.tautomer import canonicalize_tautomer_smiles


@dataclass
class ScoreReport:
    n: int
    n_decoded: int
    exact_match: float           # metric 1: tautomer-insensitive exact
    exact_match_canonical: float  # metric 2: NON-isomeric canonical exact
    tanimoto_like: float         # metric 3: mean Morgan-Dice
    decode_rate: float
    exact_match_isomeric: float = 0.0  # extra: isomeric canonical exact

    def __str__(self) -> str:
        return (f"n={self.n} decoded={self.n_decoded} "
                f"exact={self.exact_match:.4f} "
                f"exact_canonical={self.exact_match_canonical:.4f} "
                f"exact_isomeric={self.exact_match_isomeric:.4f} "
                f"dice={self.tanimoto_like:.4f} "
                f"decode_rate={self.decode_rate:.4f}")


def score_pairs(truths: Sequence[str],
                preds: Sequence[Optional[str]]) -> ScoreReport:
    """The three cal_acc.py counters, computed independently per pair:
    metric 2 compares NON-isomeric canonicals (stereo stripped,
    cal_acc.py:35-36); the isomeric comparison is reported as an extra
    (stricter) column since this framework decodes stereo."""
    assert len(truths) == len(preds)
    n = len(truths)
    hits_taut = 0
    hits_noniso = 0
    hits_iso = 0
    dice_sum = 0.0
    decoded = 0
    for truth, pred in zip(truths, preds):
        if pred is None:
            continue
        decoded += 1
        try:
            iso_eq = canonical_smiles(truth) == canonical_smiles(pred)
            noniso_eq = (canonical_smiles(truth, isomeric=False)
                         == canonical_smiles(pred, isomeric=False))
        except Exception:
            continue
        hits_iso += iso_eq
        hits_noniso += noniso_eq
        if iso_eq:
            hits_taut += 1
            dice_sum += 1.0
            continue
        tt = canonicalize_tautomer_smiles(truth)
        tp = canonicalize_tautomer_smiles(pred)
        if tt is not None and tt == tp:
            hits_taut += 1
            dice_sum += 1.0
            continue
        try:
            dice_sum += morgan_dice(from_smiles(truth), from_smiles(pred))
        except Exception:
            pass
    # All rates divide by n (total pairs), NOT by the decoded count —
    # deliberate reference parity: cal_acc.py:45-51 averages over every
    # row, so an undecodable image counts as a miss, and the Dice mean
    # treats it as similarity 0.
    return ScoreReport(
        n=n, n_decoded=decoded,
        exact_match=hits_taut / n if n else 0.0,
        exact_match_canonical=hits_noniso / n if n else 0.0,
        tanimoto_like=dice_sum / n if n else 0.0,
        decode_rate=decoded / n if n else 0.0,
        exact_match_isomeric=hits_iso / n if n else 0.0,
    )


def write_results_csv(path: str, truths: Sequence[str],
                      preds: Sequence[Optional[str]]) -> None:
    """results/results.csv parity (img2smiles2.py:342-344): an unnamed
    index column, then smiles and smiles_pred ("" where nothing
    decoded), as pandas' DataFrame.to_csv writes it."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["", "smiles", "smiles_pred"])
        for i, (t, p) in enumerate(zip(truths, preds)):
            w.writerow([i, t, "" if p is None else p])


def read_results_csv(path: str):
    """(truths, preds) of a results CSV; an empty prediction is None.
    Truths come from a `smiles` column."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if rows and "smiles" not in rows[0]:
        if "InChI" in rows[0]:
            raise SystemExit("InChI truths need the InChI reader, which "
                             "comes with a later slice of the port")
        raise SystemExit("results csv needs a 'smiles' column")
    return ([r["smiles"] for r in rows],
            [r["smiles_pred"] or None for r in rows])
