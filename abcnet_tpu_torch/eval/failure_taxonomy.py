"""Graph-level taxonomy of structural end-to-end failures from a results
CSV.

    python -m abcnet_tpu_torch.eval.failure_taxonomy results.csv
        [n_per_lineage]

Counterpart of the JAX package's scripts/failure_taxonomy.py.
eval/classify_results.py says where molecules are lost (struct, stereo,
decode); this says what is wrong inside the struct bucket by diffing the
parsed molecular graphs of truth and prediction. The axes, checked in
this order:

  atoms+k/-k      heavy-atom count differs (detection miss/ghost)
  fragmented      pred splits into more components than truth (a missed
                  bond disconnected the graph)
  elem-swap X>Y   same heavy-atom count, element multiset differs
  bond-order      kekule bond-order multiset differs
  rings+k/-k      ring count differs (extra/missing cycle)
  charge          formal-charge totals differ
  hnum            explicit/implicit H totals differ (hnum misread)
  aromatic-form   aromatic atom count differs (dearomatized form read)

A failure can trip several axes; the first is its primary bucket, and
every tripped axis is counted. `connectivity` (same formula and
bond-order multiset, another graph) is the fallback for a failure that
trips none; a graph that does not parse goes to parse:<Exception>. Rows
before `n_per_lineage` (default 256, eval/final_eval.py's layout) count
as the rdkit lineage, the rest as indigo. Per lineage, in the order of
its first struct failure: primary buckets and tripped axes by count
(ties in order of first appearance), the 12 commonest details and up to
6 examples. Host only.
"""

from __future__ import annotations

import argparse
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from ..chem.smiles import from_smiles
from .classify_results import read_results_csv
from .decode_ceiling import classify

MAX_EXAMPLES = 6
TOP_DETAILS = 12


def _components(mol):
    seen = [False] * mol.num_atoms
    n = 0
    for s in range(mol.num_atoms):
        if seen[s]:
            continue
        n += 1
        stack = [s]
        seen[s] = True
        while stack:
            i = stack.pop()
            for j in mol.neighbors(i):
                if not seen[j]:
                    seen[j] = True
                    stack.append(j)
    return n


def _stats(smiles):
    mol = from_smiles(smiles)
    comps = _components(mol)
    return {
        "mol": mol,
        "elems": Counter(a.symbol for a in mol.atoms),
        "n_atoms": mol.num_atoms,
        "orders": Counter(b.order for b in mol.bonds),
        "comps": comps,
        "rings": mol.num_bonds - mol.num_atoms + comps,
        "charge": sum(a.charge for a in mol.atoms),
        "hs": sum(a.total_hs for a in mol.atoms),
        "arom": sum(1 for a in mol.atoms if a.aromatic),
    }


def _swap_label(te, pe):
    lost = te - pe       # in truth, not in pred
    gained = pe - te     # in pred, not in truth
    pairs = [f"{sym_l}>{sym_g}" for (sym_l, _), (sym_g, _)
             in zip(sorted(lost.items()), sorted(gained.items()))]
    return ",".join(pairs) if pairs else "?"


def diff_axes(truth: str, pred: str) -> List[Tuple[str, str]]:
    """Ordered (axis, detail) list of every failing comparison axis."""
    t, p = _stats(truth), _stats(pred)
    axes = []
    if t["n_atoms"] != p["n_atoms"]:
        axes.append((f"atoms{p['n_atoms'] - t['n_atoms']:+d}", ""))
    if p["comps"] > t["comps"]:
        axes.append(("fragmented", f"{t['comps']}->{p['comps']}"))
    if t["n_atoms"] == p["n_atoms"] and t["elems"] != p["elems"]:
        axes.append(("elem-swap", _swap_label(t["elems"], p["elems"])))
    if t["orders"] != p["orders"]:
        lo = sorted((t["orders"] - p["orders"]).elements())
        hi = sorted((p["orders"] - t["orders"]).elements())
        axes.append(("bond-order", f"{lo}->{hi}"))
    if t["rings"] != p["rings"]:
        axes.append((f"rings{p['rings'] - t['rings']:+d}", ""))
    if t["charge"] != p["charge"]:
        axes.append(("charge", f"{t['charge']}->{p['charge']}"))
    if t["hs"] != p["hs"]:
        axes.append(("hnum", f"{t['hs']}->{p['hs']}"))
    if t["arom"] != p["arom"]:
        axes.append(("aromatic-form", f"{t['arom']}->{p['arom']}"))
    if not axes:
        # Identical multiset stats on every axis -> pure connectivity.
        axes.append(("connectivity", ""))
    return axes


def taxonomy(rows: Sequence[Tuple[object, Optional[str]]],
             n_per_lineage: int = 256) -> Dict[str, dict]:
    """{lineage: record} over the struct failures of (truth, pred) rows,
    lineage by row position; a record holds `n`, Counters `primary`,
    `all` and `details`, and `examples` as (axes, truth, pred)."""
    lineages: Dict[str, dict] = {}
    for i, (truth, pred) in enumerate(rows):
        if classify(truth, pred) != "struct":
            continue
        try:
            axes = diff_axes(truth, pred)
        except Exception as e:  # noqa: BLE001 — bucketed by its type
            axes = [(f"parse:{type(e).__name__}", "")]
        rec = lineages.setdefault(
            "rdkit" if i < n_per_lineage else "indigo",
            {"primary": Counter(), "all": Counter(), "details": Counter(),
             "n": 0, "examples": []})
        rec["n"] += 1
        rec["primary"][axes[0][0]] += 1
        for ax, detail in axes:
            rec["all"][ax] += 1
            if detail:
                rec["details"][f"{ax}:{detail}"] += 1
        if len(rec["examples"]) < MAX_EXAMPLES:
            rec["examples"].append((axes, truth, pred))
    return lineages


def taxonomy_lines(lineages: Dict[str, dict]) -> List[str]:
    """The script's printout: one entry a print call."""
    out = []
    for lin, rec in lineages.items():
        out.append(f"== {lin}: {rec['n']} struct failures ==")
        out.append("  primary buckets:")
        out += [f"    {k:16s} {v}" for k, v in rec["primary"].most_common()]
        out.append("  all tripped axes:")
        out += [f"    {k:16s} {v}" for k, v in rec["all"].most_common()]
        out.append("  top details:")
        out += [f"    {k:28s} {v}"
                for k, v in rec["details"].most_common(TOP_DETAILS)]
        out += [f"  EX {axes}\n    T {t}\n    P {p}"
                for axes, t, p in rec["examples"]]
    return out


def main(argv=None) -> Dict[str, dict]:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.eval."
                                     "failure_taxonomy")
    p.add_argument("results", help="CSV with smiles and smiles_pred")
    p.add_argument("n_per_lineage", nargs="?", type=int, default=256)
    args = p.parse_args(argv)
    truths, preds = read_results_csv(args.results)
    lineages = taxonomy(list(zip(truths, preds)), args.n_per_lineage)
    for line in taxonomy_lines(lineages):
        print(line)
    return lineages


if __name__ == "__main__":
    main()
