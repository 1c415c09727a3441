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
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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


@functools.lru_cache(maxsize=8192)
def _canonical_tautomer(smiles: str) -> Optional[str]:
    """canonicalize_tautomer_smiles, cached by string: a truth is scored
    against each wrong prediction of it, up to one per degradation in
    eval/degraded_bench.py, and its tautomer search costs as much as the
    prediction's."""
    return canonicalize_tautomer_smiles(smiles)


@functools.lru_cache(maxsize=8192)
def _score_pair(truth: str, pred: str) -> Tuple[bool, bool, bool, float]:
    """(isomeric equal, non-isomeric equal, tautomer-insensitive equal,
    Dice contribution) of one decoded pair. A pure function of two
    strings, cached: the tautomer enumeration of a wrong prediction takes
    up to seconds, and an evaluation scores the same pair several times
    (per lineage and overall, two assemblers that mostly agree)."""
    try:
        iso_eq = canonical_smiles(truth) == canonical_smiles(pred)
        noniso_eq = (canonical_smiles(truth, isomeric=False)
                     == canonical_smiles(pred, isomeric=False))
    except Exception:
        return False, False, False, 0.0
    if iso_eq:
        return True, noniso_eq, True, 1.0
    tt = _canonical_tautomer(truth)
    tp = _canonical_tautomer(pred)
    if tt is not None and tt == tp:
        return False, noniso_eq, True, 1.0
    try:
        return False, noniso_eq, False, morgan_dice(from_smiles(truth),
                                                    from_smiles(pred))
    except Exception:
        return False, noniso_eq, False, 0.0


def score_pairs(truths: Sequence[str],
                preds: Sequence[Optional[str]]) -> ScoreReport:
    """The three cal_acc.py counters, computed independently per pair:
    metric 2 compares NON-isomeric canonicals (stereo stripped,
    cal_acc.py:35-36); the isomeric comparison is reported as an extra
    (stricter) column since this framework decodes stereo. A pair whose
    canonicalization raises counts as decoded and as a miss; the Dice sum
    adds the per-pair terms in row order, as the JAX package's loop
    does."""
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
        iso_eq, noniso_eq, taut_eq, dice = _score_pair(truth, pred)
        hits_iso += iso_eq
        hits_noniso += noniso_eq
        hits_taut += taut_eq
        dice_sum += dice
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


# The cells pandas.read_csv reads as NaN by default (its `na_values`);
# the JAX package reads every results CSV through it.
PANDAS_NA = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def read_csv_rows(path: str):
    """(rows as dicts, column names) of a CSV file, each cell as
    pandas.read_csv gives it: NaN where it is one of PANDAS_NA or is
    missing from a short row, else the string."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f, restval="")
        rows = [{k: math.nan if v in PANDAS_NA else v
                 for k, v in r.items()} for r in reader]
        return rows, reader.fieldnames or []


def prediction(cell) -> Optional[str]:
    """The JAX package's rule for a smiles_pred cell: anything but a
    non-empty string (NaN, a missing column's None) is no prediction."""
    return cell if isinstance(cell, str) and cell else None


def read_results_csv(path: str):
    """(truths, preds) of a results CSV, read as the JAX package's cal-acc
    reads it (abcnet_tpu/__main__.py:_cmd_cal_acc, pandas): each
    prediction through `prediction`. Truths come from a `smiles` column
    (NaN where pandas reads NaN) or, where there is none, from an `InChI`
    column converted through chem/inchi.py (None where the cell is not a
    string): the reference's multiprocessing decoder scores against InChI
    truths (multi_proc_img2smiles2.py:329-352), as the JAX package's
    cal-acc does (abcnet_tpu/__main__.py:176-189)."""
    rows, cols = read_csv_rows(path)
    preds = [prediction(r["smiles_pred"]) for r in rows]
    if "smiles" in cols:
        return [r["smiles"] for r in rows], preds
    if "InChI" in cols:
        from ..chem.inchi import inchi_to_smiles
        return [inchi_to_smiles(r["InChI"])
                if isinstance(r["InChI"], str) else None
                for r in rows], preds
    raise SystemExit("results csv needs a 'smiles' or 'InChI' column")
