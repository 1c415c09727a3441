"""Cross-engine evaluation: train-on-A / eval-on-B generalization.

    python -m abcnet_tpu_torch.eval.cross_engine_eval [n]
        [--ckpt NPZ_OR_DIR] [--device cuda]

Counterpart of the JAX package's scripts/cross_engine_eval.py. The
reference's corpus spans two different drawing programs, so its model
generalizes across pixel conventions; the production weights were
trained on engine A only. This measures the transfer gap: the same
held-out molecule stream is drawn by both engines at reference-condition
settings (rdkit label lineage, 512 px canvas, at most MAX_ATOMS heavy
atoms) and served by the same weights, so the exact-match delta isolates
the shift in pixels from the molecules' difficulty.

Pools come from seed POOL_SEED, n rounded down to a multiple of
EVAL_BATCH; weights as in eval/degraded_bench.py (bf16, the committed
snapshot unless --ckpt names another). Prints the JAX script's
`E2E[engine-x]` lines and its CROSS-ENGINE TABLE.
"""

from __future__ import annotations

import argparse
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .. import __main__ as cli
from ..chem import to_smiles
from ..chem.random_mol import random_molecule
from ..data.generate import Sample, generate_sample
from ..eval.scoring import ScoreReport, score_pairs
from ..infer.assemble import assemble_batch
from ..infer.decode import make_infer_pipeline
from ..models.weights import load_weights
from ..utils.device import resolve_device

EVAL_BATCH = 16
# the refcond heavy-atom cap (scripts/refcond_experiment.py:55)
MAX_ATOMS = 28
POOL_SEED = 881001
ENGINES = ("a", "b")


@dataclass
class EngineResult:
    report: ScoreReport
    truths: List[str]
    preds: List[Optional[str]]
    seconds: float


def gen_paired_pools(seed: int, n: int) -> Dict[str, List[Sample]]:
    """The same molecule stream drawn by both engines.

    Each attempt draws ONE molecule from the molecule rng and draws it
    twice, each engine under its own style rng; an attempt where either
    engine rejects it, or where the two label SMILES differ (depicted
    stereo can differ between layouts), is skipped, so both pools stay
    aligned molecule for molecule."""
    mol_rng = random.Random(seed)
    pools: Dict[str, List[Sample]] = {e: [] for e in ENGINES}
    while len(pools["a"]) < n:
        mol = random_molecule(mol_rng, max_atoms=MAX_ATOMS)
        smi = to_smiles(mol, canonical=True)
        mseed = mol_rng.getrandbits(32)
        pair = {}
        for eng in ENGINES:
            r = random.Random(f"{mseed}-{eng}")
            s = generate_sample(r, mode="rdkit", smiles=smi, engine=eng)
            if s is None:
                break
            pair[eng] = s
        if len(pair) == 2 and pair["a"].smiles == pair["b"].smiles:
            for eng in ENGINES:
                pools[eng].append(pair[eng])
    return pools


def evaluate(model, pools: Dict[str, List[Sample]],
             batch: int = EVAL_BATCH,
             verbose: bool = True) -> Dict[str, EngineResult]:
    """{engine: EngineResult} of `model` (a UNet on its device, in its
    compute dtype) on each pool, in batches of `batch` (the pools are a
    whole number of them); the JAX script's lines printed when
    `verbose`."""
    if any(len(samples) % batch for samples in pools.values()):
        raise ValueError(f"pools of {[len(s) for s in pools.values()]} "
                         f"samples are not whole numbers of batches of "
                         f"{batch}")
    dev = next(model.parameters()).device
    run = make_infer_pipeline(model, dev)
    out = {}
    for eng, samples in pools.items():
        truths, preds = [], []
        t0 = time.time()
        for i in range(0, len(samples), batch):
            chunk = samples[i:i + batch]
            preds.extend(assemble_batch(run(np.stack(
                [s.image for s in chunk]))))
            truths.extend(s.smiles for s in chunk)
        res = EngineResult(score_pairs(truths, preds), truths, preds,
                           time.time() - t0)
        if verbose:
            print(f"E2E[engine-{eng}] {res.report} ({res.seconds:.0f}s)",
                  flush=True)
        out[eng] = res
    if verbose:
        print("CROSS-ENGINE TABLE (trained on engine A):", flush=True)
        for eng in ENGINES:
            print(f"  eval-on-{eng}: {out[eng].report}", flush=True)
    return out


def main(argv=None) -> Dict[str, EngineResult]:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.eval."
                                     "cross_engine_eval")
    p.add_argument("n", nargs="?", type=int, default=256)
    p.add_argument("--ckpt", default=cli.DEFAULT_SNAPSHOT,
                   help="weight snapshot (.npz) or checkpoint directory "
                        "(its latest step_*.pt)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    model, step = load_weights(args.ckpt, device=resolve_device(args.device))
    n = (args.n // EVAL_BATCH) * EVAL_BATCH
    print(f"ckpt step {step}", flush=True)
    print("generating paired pools...", flush=True)
    t0 = time.time()
    pools = gen_paired_pools(POOL_SEED, n)
    print(f"pools ready ({time.time() - t0:.0f}s)", flush=True)
    return evaluate(model, pools)


if __name__ == "__main__":
    main()
