"""Production-lineage low-LR fine-tune with hard-example mining.

    python -m abcnet_tpu_torch.train.finetune_hard <deadline_epoch_s>
        [pool_npz] [--ckpt NPZ_OR_DIR] [--out weights_torch]
        [--cache-dir data_cache] [--device cuda]

Counterpart of the JAX package's scripts/finetune_hard.py. One
end-to-end decode sweep over the pool's train split (`mine_hard`:
make_infer_pipeline at batch MINE_BATCH on the clean images, the
assembler, `_same_mol`) marks the molecules the current weights get
wrong; its indices are cached per start step, and a relaunch reads the
newest cache by numeric step. Then batches of 128 (the plain step, no
remat) draw HARD_FRAC of their rows from
the mined set with replacement and the rest from the whole split, both
from np.random.default_rng(4000 + start step); LR 2.5e-5, 1e-5 from 0.85
of the budget; checkpoint and EVAL every 1000 steps and at the end; then
FINAL: the eval split served at batch 16 and scored.

Divergences from the script, each for the card's machine:
  * the weights: `--ckpt` (default the committed
    snapshots/r5_latest.npz) where the script restores the orbax
    weights/: a checkpoint directory continues whole (moments, step), a
    snapshot .npz with fresh Adam moments at its step; a relaunch resumes
    whole from `--out` (default weights_torch/, as the script continues
    its own weights/) when it holds anything (recipe.finetune_state);
  * the mining cache is data_cache/torch_hard_idx_<step>.npy: the
    script's glob (data_cache/hard_idx_*.npy) would pick up such a name
    and its regex, hard_idx_(\\d+), fails on it.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import time
from typing import Callable, List, Sequence

import numpy as np

from ..chem import canonical_smiles
from ..data import pipeline
from ..data.pool import load_pool
from ..eval.scoring import score_pairs
from ..infer.assemble import assemble_batch
from ..infer.decode import make_infer_pipeline
from ..utils.device import resolve_device
from . import recipe, trainer

EVAL_N = 256          # same held-out split as the earlier rounds
BATCH = 128
LR = 2.5e-5
HARD_FRAC = 0.3       # fraction of each batch drawn from the mined set
MINE_BATCH = 64
LOG_EVERY = 50
CKPT_EVERY = 1000
STEP_SEED = 21
CACHE_PREFIX = "torch_hard_idx_"
DEFAULT_POOL = os.path.join(recipe.DATA_CACHE, "pool_90k.npz")


def _same_mol(pred, truth) -> bool:
    """Canonical-form-insensitive equality: the pool stores aromatic-form
    SMILES while the assembler emits the kekulized form, so a raw compare
    marks nearly every aromatic molecule wrong. Raw equality first, else
    both canonicalized."""
    if pred is None:
        return False
    if pred == truth:
        return True
    try:
        return canonical_smiles(pred) == canonical_smiles(truth)
    except Exception:  # noqa: BLE001 — an unparsable prediction is a miss
        return False


def cache_path(cache_dir: str, start_step: int) -> str:
    """The newest prior mining cache under `cache_dir` by numeric step
    (a lexicographic order would let step 56000 shadow 100000), else
    the name for this start step."""
    pat = re.compile(re.escape(CACHE_PREFIX) + r"(\d+)\.npy$")
    prior = sorted((p for p in glob.glob(os.path.join(
        cache_dir, CACHE_PREFIX + "*.npy")) if pat.search(p)),
        key=lambda p: int(pat.search(p).group(1)))
    return prior[-1] if prior else os.path.join(
        cache_dir, f"{CACHE_PREFIX}{start_step}.npy")


def mine_hard(model, samples: Sequence[pipeline.Sample], path: str,
              device="cuda", log=print,
              clock: Callable[[], float] = time.time) -> np.ndarray:
    """Indices of the `samples` whose SMILES the model misses, over whole
    batches of MINE_BATCH clean images (no noise, as the eval metric);
    read from `path` when it exists, else computed and saved there."""
    if os.path.exists(path):
        idx = np.load(path)
        log(f"mined cache: {len(idx)} hard examples")
        return idx
    run = make_infer_pipeline(model, device)
    wrong: List[int] = []
    t0 = clock()
    n = len(samples)
    for i in range(0, n - MINE_BATCH + 1, MINE_BATCH):
        chunk = samples[i:i + MINE_BATCH]
        preds = assemble_batch(run(np.stack([s.image for s in chunk])))
        wrong.extend(i + j for j, (s, p) in enumerate(zip(chunk, preds))
                     if not _same_mol(p, s.smiles))
        if (i // MINE_BATCH) % 100 == 99:
            log(f"mine {i + MINE_BATCH}/{n} wrong={len(wrong)} "
                f"({clock() - t0:.0f}s)")
    idx = np.asarray(wrong, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, idx)
    log(f"mined {len(idx)}/{n} hard examples ({clock() - t0:.0f}s)")
    return idx


def finetune_hard(deadline: float, pool_path: str = DEFAULT_POOL, *,
                  ckpt: str = recipe.DEFAULT_SNAPSHOT,
                  out_ckpt: str = recipe.CKPT_DIR,
                  cache_dir: str = recipe.DATA_CACHE, device="cuda",
                  dtype: str = "bfloat16",
                  clock: Callable[[], float] = time.time,
                  log=print) -> recipe.RecipeResult:
    """Mine, fine-tune until `deadline` (on `clock`), serve and score the
    eval split; returns what the run did (FINAL's report in `final`)."""
    dev = resolve_device(device)
    batch = BATCH
    eval_samples, train_samples, eval_examples, rng = recipe.split_pool(
        load_pool(pool_path), EVAL_N)
    cfg = trainer.TrainConfig(batch_size=batch, lr=LR, amount=0.2,
                              log_every=LOG_EVERY, device=str(dev),
                              dtype=dtype)
    state, _ = recipe.finetune_state(cfg, ckpt, out_ckpt, log)
    log(f"start step {state.step}")

    hard_set = np.asarray(mine_hard(
        state.model, train_samples, cache_path(cache_dir, state.step), dev,
        log, clock))
    state.generator.manual_seed(STEP_SEED)
    loop = recipe.Loop(state, cfg, clock, log)
    loop.result.hard_idx = hard_set
    loop.set_lr(LR)

    draw = np.random.default_rng(4000 + state.step)
    n_hard = max(1, int(batch * HARD_FRAC))
    total_budget = max(deadline - clock(), 1.0)
    while clock() < deadline:
        frac = 1.0 - max(deadline - clock(), 0.0) / total_budget
        now_lr = recipe.finetune_lr(frac, LR)
        loop.set_lr(now_lr, f"lr -> {now_lr}")
        if len(hard_set):
            hard = draw.choice(hard_set, n_hard)
            rest = draw.integers(0, len(train_samples), batch - n_hard)
            batch_idx = np.concatenate([hard, rest])
        else:
            batch_idx = draw.integers(0, len(train_samples), batch)
        loop.train([pipeline.sample_to_example(train_samples[j], rng,
                                               train=True)
                    for j in batch_idx])
        if loop.step % CKPT_EVERY == 0:
            loop.checkpoint(out_ckpt)
            loop.evaluate(eval_examples)

    loop.checkpoint(out_ckpt)
    loop.evaluate(eval_examples)
    steps = loop.step - loop.result.start_step
    log(f"fine-tuned {steps} steps ({steps * batch / 1e6:.2f}M images)")

    run = make_infer_pipeline(loop.state.model, dev)
    truths, preds = [], []
    for i in range(0, EVAL_N, recipe.EVAL_BATCH):
        chunk = eval_samples[i:i + recipe.EVAL_BATCH]
        preds.extend(assemble_batch(run(np.stack([s.image for s in chunk]))))
        truths.extend(s.smiles for s in chunk)
    loop.result.final = score_pairs(truths, preds)
    log(f"FINAL {loop.result.final}")
    return loop.result


def main(argv=None) -> recipe.RecipeResult:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.train."
                                     "finetune_hard")
    p.add_argument("deadline", type=float, help="absolute epoch seconds")
    p.add_argument("pool", nargs="?", default=DEFAULT_POOL)
    p.add_argument("--ckpt", default=recipe.DEFAULT_SNAPSHOT,
                   help="the weights to continue: a snapshot .npz or a "
                        "checkpoint directory")
    p.add_argument("--out", default=recipe.CKPT_DIR,
                   help="checkpoint directory written, and resumed from")
    p.add_argument("--cache-dir", default=recipe.DATA_CACHE,
                   help="where the mined indices are cached")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return finetune_hard(args.deadline, args.pool, ckpt=args.ckpt,
                         out_ckpt=args.out, cache_dir=args.cache_dir,
                         device=args.device,
                         log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main(sys.argv[1:])
