"""Post-training evaluation: heatmap metric suite + end-to-end SMILES
accuracy, overall and split by render lineage.

    python -m abcnet_tpu_torch.eval.final_eval [n_per_mode] [--ckpt NPZ_OR_DIR]
        [--dtype bfloat16] [--device cuda] [--out CSV]

Counterpart of the JAX package's scripts/final_eval.py. Held-out
molecules come from two fresh seed streams of the port's generator, one
per lineage: (777001, rdkit) and (777002, indigo), n_per_mode each
(rounded down to a multiple of the batch of 16). Per lineage: the
heatmap metrics (`trainer.eval_step` at batch 16, summed in a
`MeterBank`), then the serving pipeline through the CLI's serving loop
at batch 16, every batch's peaks assembled twice, with the sub-cell
assembler and with the reference's integer-cell matching
(`assemble_batch(subcell=False)`), each scored with `score_pairs`; then
both lineages together. The results CSV has the layout of the JAX run's
(logs/final_eval_step43100.csv: index, smiles, smiles_pred with the
sub-cell assembler), rdkit rows first; it is written to --out
(default final_eval_step<step>.csv in the working directory) and never
under the repository's logs/.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .. import __main__ as cli
from ..data import pipeline
from ..data.generate import Sample, generate_samples
from ..eval.scoring import ScoreReport, score_pairs, write_results_csv
from ..infer.assemble import assemble_batch
from ..infer.decode import make_infer_pipeline
from ..models.weights import load_weights
from ..train import trainer
from ..train.metrics import MeterBank
from ..utils.device import resolve_device

EVAL_BATCH = 16
# (lineage, seed) of the two held-out pools (scripts/final_eval.py:55-58)
POOLS = (("rdkit", 777001), ("indigo", 777002))
LOGS_DIR = os.path.join(cli.REPO, "logs")


@dataclass
class LineageResult:
    heatmap: Dict[str, float]
    truths: List[str]
    preds: List[Optional[str]]          # sub-cell assembler
    preds_int: List[Optional[str]]      # integer-cell assembler
    e2e: ScoreReport = field(init=False)
    e2e_int: ScoreReport = field(init=False)
    serve_s: float = 0.0

    def __post_init__(self):
        self.e2e = score_pairs(self.truths, self.preds)
        self.e2e_int = score_pairs(self.truths, self.preds_int)


def heatmap_metrics(state: trainer.TrainState,
                    samples: List[Sample]) -> Dict[str, float]:
    """Eval-mode metric suite over `samples` in batches of EVAL_BATCH."""
    rng = random.Random(9)
    examples = [pipeline.sample_to_example(s, rng, train=False)
                for s in samples]
    meters = MeterBank()
    for hb in pipeline.batches_from_examples(examples, EVAL_BATCH,
                                             shuffle=False):
        _, _, mets = trainer.eval_step(state,
                                       trainer.to_device(hb, state.device))
        meters.update(mets)
    return meters.averages()


def serve_both(run, samples: List[Sample]):
    """(sub-cell SMILES, integer-cell SMILES) of every sample, from one
    pass of the serving loop at batch EVAL_BATCH."""
    pairs = cli.img2smiles_loop(
        run, [s.image for s in samples], EVAL_BATCH, log_every=0,
        assemble=lambda peaks: list(zip(assemble_batch(peaks),
                                        assemble_batch(peaks,
                                                       subcell=False))))
    return [p for p, _ in pairs], [q for _, q in pairs]


def evaluate(model, n_per_mode: int = 256, verbose: bool = True,
             pools: Optional[Dict[str, List[Sample]]] = None
             ) -> Dict[str, LineageResult]:
    """Heatmap metrics and end-to-end SMILES of each lineage, with `model`
    (a UNet on its device, in its compute dtype). `pools` overrides the
    generated ones (lineage -> samples)."""
    n = (n_per_mode // EVAL_BATCH) * EVAL_BATCH
    if pools is None:
        pools = {mode: generate_samples(n, seed, mode)
                 for mode, seed in POOLS}
    dev = next(model.parameters()).device
    dtype = str(model.dtype).replace("torch.", "")
    state = trainer.create_state(
        trainer.TrainConfig(dtype=dtype, device=str(dev)), model)
    run = make_infer_pipeline(model, dev)
    out = {}
    for mode, samples in pools.items():
        heat = heatmap_metrics(state, samples)
        if verbose:
            print(f"HEATMAP[{mode}] " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(heat.items())), flush=True)
        t0 = time.time()
        preds, preds_int = serve_both(run, samples)
        res = LineageResult(heat, [s.smiles for s in samples], preds,
                            preds_int, serve_s=time.time() - t0)
        if verbose:
            print(f"E2E[{mode}] {res.e2e} ({res.serve_s:.0f}s)", flush=True)
            print(f"E2E[{mode}/int-cell] {res.e2e_int}", flush=True)
        out[mode] = res
    return out


def overall(results: Dict[str, LineageResult]):
    """(truths, preds, preds_int) of every lineage together, in order."""
    truths = [t for r in results.values() for t in r.truths]
    preds = [p for r in results.values() for p in r.preds]
    preds_int = [p for r in results.values() for p in r.preds_int]
    return truths, preds, preds_int


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.eval."
                                     "final_eval")
    p.add_argument("n_per_mode", nargs="?", type=int, default=256)
    p.add_argument("--ckpt", default=cli.DEFAULT_SNAPSHOT,
                   help="weight snapshot (.npz) or checkpoint "
                        "directory (its latest step_*.pt)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", help="results CSV (default "
                                 "final_eval_step<step>.csv)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    model, step = load_weights(args.ckpt, device=dev,
                               dtype=getattr(torch, args.dtype))
    out_csv = args.out or f"final_eval_step{step}.csv"
    if os.path.abspath(out_csv).startswith(LOGS_DIR + os.sep):
        sys.exit(f"error: {out_csv} is under {LOGS_DIR}, which holds the "
                 "JAX package's retained runs")
    print(f"weights: {args.ckpt} (step {step}), {args.dtype} on {dev}",
          flush=True)
    results = evaluate(model, args.n_per_mode)
    truths, preds, preds_int = overall(results)
    print(f"E2E[all] {score_pairs(truths, preds)}", flush=True)
    print(f"E2E[all/int-cell] {score_pairs(truths, preds_int)}", flush=True)
    write_results_csv(out_csv, truths, preds)
    print(f"wrote {out_csv}", flush=True)


if __name__ == "__main__":
    main()
