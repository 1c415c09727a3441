"""Bucket end-to-end decode failures from a results CSV.

    python -m abcnet_tpu_torch.eval.classify_results results.csv
        [max_prints]

Counterpart of the JAX package's scripts/classify_results.py. The
reference reports only scalar accuracies (cal_acc.py:45-51); this splits
the misses of a (smiles, smiles_pred) results file, such as the one
eval/final_eval.py writes, into the decode ceiling's buckets
(eval/decode_ceiling.py:classify: decode0, parse:<Exception>, struct,
stereo+, stereo-, stereo~), so that a report can say where the model
loses molecules. Prints the exact isomeric count, the count of each miss
bucket, and the first `max_prints` misses (default 20). Host only.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

from .decode_ceiling import classify
from .scoring import prediction, read_csv_rows


def read_results_csv(path: str) -> Tuple[List, List[Optional[str]]]:
    """(truths, preds) of every row of a results CSV as the JAX scripts
    read them, through pandas.read_csv (eval/scoring.py:read_csv_rows)
    and their rule for a prediction (eval/scoring.py:prediction); a file
    without a `smiles_pred` column has no prediction (the scripts'
    `row.get`). A truth that pandas reads as NaN stays NaN, which
    `classify` buckets as a parse failure, as the scripts do."""
    rows, _ = read_csv_rows(path)
    return ([r["smiles"] for r in rows],
            [prediction(r.get("smiles_pred")) for r in rows])


def classify_rows(rows: Sequence[Tuple[object, Optional[str]]]
                  ) -> Tuple[Dict[str, int], List[tuple], int]:
    """(buckets, fails, n) of (truth, pred) rows: the count of each
    `classify` bucket in order of first appearance, every miss as
    (bucket, truth, pred) in row order, and the number of rows."""
    buckets: Dict[str, int] = {}
    fails = []
    for truth, pred in rows:
        b = classify(truth, pred)
        buckets[b] = buckets.get(b, 0) + 1
        if b != "ok":
            fails.append((b, truth, pred))
    return buckets, fails, len(rows)


def classify_lines(buckets: Dict[str, int], fails, n: int,
                   max_prints: int = 20) -> List[str]:
    """The script's printout: one entry a print call."""
    ok = buckets.get("ok", 0)
    out = [f"{ok}/{n} exact isomeric ({ok / max(n, 1):.3f})"]
    out += [f"  {k}: {buckets[k]}" for k in sorted(buckets) if k != "ok"]
    out += [f"  FAIL [{b}]\n    T {t}\n    P {p}"
            for b, t, p in fails[:max_prints]]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.eval."
                                     "classify_results")
    p.add_argument("results", help="CSV with smiles and smiles_pred")
    p.add_argument("max_prints", nargs="?", type=int, default=20)
    args = p.parse_args(argv)
    truths, preds = read_results_csv(args.results)
    buckets, fails, n = classify_rows(list(zip(truths, preds)))
    for line in classify_lines(buckets, fails, n, args.max_prints):
        print(line)
    return buckets, fails, n


if __name__ == "__main__":
    main()
