"""The production training run: the recipe that made the committed weights.

    python -m abcnet_tpu_torch.train.train_r5 <deadline_epoch_s>
        <total_hours> [pool_npz] [--ckpt-dir weights_torch]
        [--snapshot snapshots/r5_torch_latest.npz] [--device cuda]

Counterpart of the JAX package's scripts/train_r5.py (environment
overrides R5_EVAL_N, R5_BATCH, R5_DEGRADE_P). On the pool of
train/build_pool_r5.py (default data_cache/pool_r5.npz): the first
EVAL_N rows are the frozen eval split, the rest are trained in epochs
ordered by np.random.default_rng(3000 + epoch), augmented with scan-style
degradation at DEGRADE_P from the rng that made the eval examples;
atom-type focal weights ATOM_W_R5 (C/N/O 0.3) for the run; Adam 2.5e-4,
wd 1e-8, batch 64 (plain: 44.2 GiB on the card). The learning rate is
keyed to the absolute deadline, so a relaunch cannot reset it:
recipe.lr_for_fraction of 1 - max(deadline - now, 0) / (total_h·3600).
The metrics step runs every 10th step, a log line every 100. Every 2500
steps: a checkpoint, the float16 snapshot, a git commit of it when 10000
steps have passed since the last one, and an EVAL over the split. At the
deadline: checkpoint, snapshot, commit, EVAL, "RUN COMPLETE".

Divergences from the script, each for the card's machine:
  * checkpoints go to weights_torch/ (the JAX package's weights/ is an
    orbax directory) and resume from it when it holds anything;
  * the snapshot goes to snapshots/r5_torch_latest.npz, never the
    committed snapshots/r5_latest.npz, and is written in-process (the
    script used a CPU subprocess to keep off the TPU client); the commit
    runs `git -C` the snapshot's directory;
  * the per-step noise and dropout streams are the port's, seeded 11
    at each launch as the script's PRNGKey(11) is.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable

import numpy as np

from ..data import pipeline
from ..data.pool import load_pool
from ..utils.device import resolve_device
from . import recipe, trainer

EVAL_N = 256
DEGRADE_P = 0.10
BATCH = 64
LR = 2.5e-4
LOG_EVERY = 100
CKPT_EVERY = 2500
# r4 failure taxonomy: the C/N/O true-class weight raised so the model
# commits to the majority elements (C->P / N->P / N->S swaps).
ATOM_W_R5 = (1, 0.3, 0.3, 0.3, 1, 1, 1, 1, 1, 10, 10, 10, 10, 10)
SNAPSHOT_COMMIT_EVERY = 10000   # steps between git commits of the snapshot
STEP_SEED = 11
DEFAULT_POOL = os.path.join(recipe.DATA_CACHE, "pool_r5.npz")
DEFAULT_SNAPSHOT_OUT = os.path.join(recipe.REPO, "snapshots",
                                    "r5_torch_latest.npz")


def train_r5(deadline: float, total_h: float, pool_path: str = DEFAULT_POOL,
             *, eval_n: int = EVAL_N, batch: int = BATCH,
             degrade_p: float = DEGRADE_P, ckpt_dir: str = recipe.CKPT_DIR,
             snapshot_path: str = DEFAULT_SNAPSHOT_OUT, device="cuda",
             dtype: str = "bfloat16", clock: Callable[[], float] = time.time,
             log=print) -> recipe.RecipeResult:
    """Train until `deadline` (on `clock`); returns what the run did."""
    dev = resolve_device(device)
    with recipe.atom_type_weights(ATOM_W_R5):
        log(f"atom weights {ATOM_W_R5}, degrade_p {degrade_p}")
        _, train_samples, eval_examples, rng = recipe.split_pool(
            load_pool(pool_path), eval_n)
        if len(train_samples) < batch:
            raise ValueError(f"{pool_path}: {len(train_samples)} training "
                             f"rows after the eval split, fewer than one "
                             f"batch of {batch}")
        cfg = trainer.TrainConfig(batch_size=batch, lr=LR, amount=0.2,
                                  log_every=LOG_EVERY, device=str(dev),
                                  dtype=dtype)
        state = trainer.create_state(cfg)
        if recipe.has_checkpoint(ckpt_dir):
            state = trainer.restore_checkpoint(state, ckpt_dir)
        state.generator.manual_seed(STEP_SEED)
        log(f"start step {state.step}")
        loop = recipe.Loop(state, cfg, clock, log)
        last_commit_step = state.step
        epoch, stop = 0, False
        while not stop:
            order = np.random.default_rng(3000 + epoch).permutation(
                len(train_samples))
            for i in range(0, len(order) - batch + 1, batch):
                frac = 1.0 - max(deadline - clock(), 0.0) / (total_h * 3600)
                lr = recipe.lr_for_fraction(frac, cfg.lr)
                loop.set_lr(lr, f"lr -> {lr} (budget fraction {frac:.2f})")
                loop.train([pipeline.sample_to_example(
                    train_samples[j], rng, train=True, degrade_p=degrade_p)
                    for j in order[i:i + batch]], epoch)
                if loop.step % CKPT_EVERY == 0:
                    loop.checkpoint(ckpt_dir)
                    commit = loop.step - last_commit_step >= \
                        SNAPSHOT_COMMIT_EVERY
                    if commit:
                        last_commit_step = loop.step
                    _snapshot(loop, snapshot_path, commit, log)
                    loop.evaluate(eval_examples)
                if clock() > deadline:
                    stop = True
                    break
            epoch += 1

        loop.checkpoint(ckpt_dir)
        _snapshot(loop, snapshot_path, True, log)
        loop.evaluate(eval_examples)
        log(f"trained {loop.step - loop.result.start_step} steps this "
            f"launch; total {loop.step * batch} images")
        log("RUN COMPLETE")
    return loop.result


def _snapshot(loop, path, commit, log):
    if recipe.snapshot_and_commit(loop.state.model, path, loop.step, commit,
                                  log):
        loop.result.snapshots.append((loop.step, commit))


def main(argv=None) -> recipe.RecipeResult:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.train."
                                     "train_r5")
    p.add_argument("deadline", type=float, help="absolute epoch seconds")
    p.add_argument("total_h", type=float, help="the run's whole budget")
    p.add_argument("pool", nargs="?", default=DEFAULT_POOL)
    p.add_argument("--ckpt-dir", default=recipe.CKPT_DIR)
    p.add_argument("--snapshot", default=DEFAULT_SNAPSHOT_OUT)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return train_r5(
        args.deadline, args.total_h, args.pool,
        eval_n=int(os.environ.get("R5_EVAL_N", EVAL_N)),
        batch=int(os.environ.get("R5_BATCH", BATCH)),
        degrade_p=float(os.environ.get("R5_DEGRADE_P", DEGRADE_P)),
        ckpt_dir=args.ckpt_dir, snapshot_path=args.snapshot,
        device=args.device, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main(sys.argv[1:])
