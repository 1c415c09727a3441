"""End-to-end slice check: generate -> train (overfit) -> decode -> score.

    python -m abcnet_tpu_torch.eval.e2e_overfit [n_examples] [epochs]
        [amount] [--device cuda]

Counterpart of the JAX package's scripts/e2e_overfit.py: a small
synthetic set (`generate_examples(n, seed=0)`, over its spawn pool),
overfit on one device from a seeded random init at batch BATCH, then the
unaugmented training images (no device noise) decoded through
`make_infer_pipeline` and scored; exact match > 0 is the pass. The
learning rate drops to a tenth at epoch `TrainConfig.lr_drop_epoch`
(epochs / 3); every step runs `train_step` with its metrics, which are
logged every 50 steps with the JAX script's keys (a metric whose
denominator never fired prints nan, where the JAX script raises). The
noise and dropout streams are the port's Philox, seeded through the
train state; they match the JAX package's `PRNGKey(1)` split stream by
distribution only.

Exit code: 0 and "E2E SLICE OK" when exact > 0, else 1 (small runs may
not reach an exact match; decode health is then the evidence).
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data import pipeline
from ..eval.scoring import ScoreReport, score_pairs
from ..infer.assemble import assemble_batch
from ..infer.decode import make_infer_pipeline
from ..train import trainer
from ..train.metrics import MeterBank
from ..utils.device import resolve_device

BATCH = 16
DECODE_MAX = 128
# (printed name, metric) of the log line (scripts/e2e_overfit.py:63-70)
LOG_KEYS = (("atomP", "atom_target_precision"),
            ("atomR", "atom_target_recall"),
            ("bondP", "bond_target_precision"),
            ("omegaP", "bond_omega_precision"),
            ("rhoMAE", "bond_rhos_mae"),
            ("typeAcc", "atom_types_acc"))


@dataclass
class OverfitResult:
    batch: int
    steps: int = 0
    seconds: float = 0.0
    losses: List[float] = field(default_factory=list)    # every step's total
    epoch_lrs: List[float] = field(default_factory=list)  # each epoch's LR
    truths: List[str] = field(default_factory=list)
    preds: List[Optional[str]] = field(default_factory=list)
    report: Optional[ScoreReport] = None

    @property
    def img_per_s(self) -> float:
        return self.steps * self.batch / self.seconds if self.seconds else 0.0


def log_line(epoch: int, step: int, total: float, avg) -> str:
    return (f"epoch {epoch} step {step} loss {total:.4f} "
            + " ".join(f"{name}={avg.get(key, float('nan')):.3f}"
                       for name, key in LOG_KEYS))


def decode_rows(n: int, batch: int = BATCH) -> range:
    """Starts of the decoded batches: whole batches of the first
    min(n, DECODE_MAX) examples."""
    return range(0, min(n, DECODE_MAX) - batch + 1, batch)


def verdict(report: ScoreReport) -> Tuple[int, str]:
    """(exit code, last line) of a run."""
    if report.exact_match > 0:
        return 0, "E2E SLICE OK"
    return 1, ("E2E SLICE: no exact matches yet "
               f"(decode_rate={report.decode_rate:.2f}); train longer")


def overfit(examples: Sequence[pipeline.Example], epochs: int = 40,
            amount: float = 0.05, batch: int = BATCH, device="cuda",
            dtype: str = "bfloat16", log=print) -> OverfitResult:
    """Train a fresh production UNet on `examples`, then decode and score
    the first whole batches of them (at most DECODE_MAX images)."""
    dev = resolve_device(device)
    cfg = trainer.TrainConfig(batch_size=batch, epochs=epochs,
                              amount=amount, log_every=50,
                              eval_every=10 ** 9, dtype=dtype,
                              device=str(dev))
    state = trainer.create_state(cfg)
    meters = MeterBank()
    res = OverfitResult(batch)
    t0 = time.time()
    for epoch in range(cfg.epochs):
        if epoch == cfg.lr_drop_epoch:
            trainer.set_learning_rate(state, cfg.lr * 0.1)
        res.epoch_lrs.append(state.optimizer.param_groups[0]["lr"])
        for hb in pipeline.batches_from_examples(examples, batch,
                                                 seed=epoch):
            state, total, _, mets = trainer.train_step(
                state, trainer.to_device(hb, dev), amount=cfg.amount)
            meters.update(mets)
            res.losses.append(total)
            res.steps += 1
            if res.steps % cfg.log_every == 0:
                log(log_line(epoch, res.steps, float(total),
                             meters.averages()))
                meters.reset()
    res.losses = [float(t) for t in res.losses]
    res.seconds = time.time() - t0
    log(f"trained {res.steps} steps in {res.seconds:.1f}s "
        f"({res.img_per_s:.1f} img/s)")

    run = make_infer_pipeline(state.model, dev)
    for i in decode_rows(len(examples), batch):
        chunk = examples[i:i + batch]
        res.preds.extend(assemble_batch(run(np.stack(
            [e.image_u8 for e in chunk]))))
        res.truths.extend(e.smiles for e in chunk)
    res.report = score_pairs(res.truths, res.preds)
    log(f"E2E: {res.report}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.eval."
                                     "e2e_overfit")
    p.add_argument("n", nargs="?", type=int, default=384)
    p.add_argument("epochs", nargs="?", type=int, default=40)
    p.add_argument("amount", nargs="?", type=float, default=0.05)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)   # before the examples are made
    t0 = time.time()
    examples = pipeline.generate_examples(args.n, seed=0)
    print(f"generated {len(examples)} examples in {time.time()-t0:.1f}s",
          flush=True)
    res = overfit(examples, args.epochs, args.amount, device=dev,
                  log=lambda line: print(line, flush=True))
    code, line = verdict(res.report)
    print(line, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
