"""Robustness fine-tune: scan-style degradation plus engine-B pixels.

    python -m abcnet_tpu_torch.train.finetune_robust <deadline_epoch_s>
        [pool_npz] [b_pool_npz] [out_ckpt] [--ckpt NPZ_OR_DIR]
        [--device cuda]

Counterpart of the JAX package's scripts/finetune_robust.py (environment
overrides FT_EVAL_N, FT_BATCH, FT_LR, FT_DEGRADE_P, FT_B_FRAC, FT_HARD,
FT_B_POOL_N). Continues the production weights at batch 128 (the plain
step, no remat) and LR 2.5e-5, 1e-5 from 0.85 of
the budget up to the deadline. Every batch draws BATCH - n_b rows of the
pool's train split and n_b = max(1, int(BATCH·B_FRAC)) rows of an
engine-B pool (data/pool.py:ensure_pool, seed 31, FT_B_POOL_N rows, or
64 when its path is given), both from np.random.default_rng(5000 +
start step); augmentation degrades DEGRADE_P of the images in the
hard-tail regime (FT_HARD=0: the default regime). Checkpoint and EVAL
every 1000 steps and at the end.

The weights: `--ckpt`, a checkpoint directory continued whole (moments,
step), as the script restores its orbax weights/ directory, or a
snapshot .npz (default the committed snapshots/r5_latest.npz) with fresh
Adam moments at its step; a relaunch resumes whole from `out_ckpt`
(default weights_torch_robust/) when it holds anything, as the script
does from weights_robust/ (recipe.finetune_state).

The engine-B pool cached under its default name, pool_b_<n // 1000>k.npz
(the script's, so that the port reads the JAX package's file), must hold
FT_B_POOL_N rows: two counts in one thousand share that name, and the
script loads whichever pool is there.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Optional

import numpy as np

from ..data import pipeline
from ..data.pool import ensure_pool, load_pool
from ..utils.device import resolve_device
from . import recipe, trainer

EVAL_N = 256
BATCH = 128
LR = 2.5e-5
DEGRADE_P = 0.40
B_FRAC = 0.15
B_POOL_N = 24000
LOG_EVERY = 50
CKPT_EVERY = 1000
STEP_SEED = 37
DEFAULT_POOL = os.path.join(recipe.DATA_CACHE, "pool_r5.npz")
DEFAULT_OUT = os.path.join(recipe.REPO, "weights_torch_robust")


def _gen_b(rng):
    from ..data.generate import generate_sample
    return generate_sample(rng, mode="mixed", engine="b")


def finetune_robust(deadline: float, pool_path: str = DEFAULT_POOL,
                    b_pool_path: Optional[str] = None,
                    out_ckpt: str = DEFAULT_OUT, *,
                    ckpt: str = recipe.DEFAULT_SNAPSHOT,
                    eval_n: int = EVAL_N, batch: int = BATCH,
                    lr: float = LR, degrade_p: float = DEGRADE_P,
                    b_frac: float = B_FRAC, hard: bool = True,
                    b_pool_n: int = B_POOL_N, device="cuda",
                    dtype: str = "bfloat16",
                    clock: Callable[[], float] = time.time,
                    log=print) -> recipe.RecipeResult:
    """Fine-tune until `deadline` (on `clock`); returns what the run
    did."""
    dev = resolve_device(device)
    derived = b_pool_path is None
    if derived:
        b_pool_path = os.path.join(recipe.DATA_CACHE,
                                   f"pool_b_{b_pool_n // 1000}k.npz")
    else:
        b_pool_n = 64
    b_samples = ensure_pool(b_pool_path, b_pool_n, sample_fn=_gen_b,
                            seed=31)
    if derived and len(b_samples) != b_pool_n:
        raise ValueError(f"engine-B pool {b_pool_path} holds "
                         f"{len(b_samples)} samples, {b_pool_n} asked for "
                         "(FT_B_POOL_N)")
    _, train_samples, eval_examples, rng = recipe.split_pool(
        load_pool(pool_path), eval_n)

    cfg = trainer.TrainConfig(batch_size=batch, lr=lr, amount=0.2,
                              log_every=LOG_EVERY, device=str(dev),
                              dtype=dtype)
    state, resumed = recipe.finetune_state(cfg, ckpt, out_ckpt, log)
    log(f"start step {state.step} (resume={resumed}) "
        f"degrade_p={degrade_p} hard={hard} b_frac={b_frac} lr={lr}")
    state.generator.manual_seed(STEP_SEED)
    loop = recipe.Loop(state, cfg, clock, log)
    loop.set_lr(lr)

    draw = np.random.default_rng(5000 + state.step)
    n_b = max(1, int(batch * b_frac))
    total_budget = max(deadline - clock(), 1.0)
    while clock() < deadline:
        frac = 1.0 - max(deadline - clock(), 0.0) / total_budget
        now_lr = recipe.finetune_lr(frac, lr)
        loop.set_lr(now_lr, f"lr -> {now_lr}")
        idx_a = draw.integers(0, len(train_samples), batch - n_b)
        idx_b = draw.integers(0, len(b_samples), n_b)
        chosen = [train_samples[j] for j in idx_a] + \
                 [b_samples[j] for j in idx_b]
        loop.train([pipeline.sample_to_example(
            s, rng, train=True, degrade_p=degrade_p, degrade_hard=hard)
            for s in chosen])
        if loop.step % CKPT_EVERY == 0:
            loop.checkpoint(out_ckpt)
            loop.evaluate(eval_examples)

    loop.checkpoint(out_ckpt)
    loop.evaluate(eval_examples)
    steps = loop.step - loop.result.start_step
    log(f"fine-tuned {steps} steps ({steps * batch / 1e6:.2f}M images); "
        f"weights in {out_ckpt}")
    log("next: python -m abcnet_tpu_torch.eval.degraded_bench 128 --ckpt "
        f"{out_ckpt} && python -m abcnet_tpu_torch.eval.cross_engine_eval "
        f"256 --ckpt {out_ckpt} && python -m abcnet_tpu_torch.eval."
        f"final_eval 256 --ckpt {out_ckpt}")
    return loop.result


def main(argv=None) -> recipe.RecipeResult:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.train."
                                     "finetune_robust")
    p.add_argument("deadline", type=float, help="absolute epoch seconds")
    p.add_argument("pool", nargs="?", default=DEFAULT_POOL)
    p.add_argument("b_pool", nargs="?", default=None,
                   help="engine-B pool (64 rows when given)")
    p.add_argument("out_ckpt", nargs="?", default=DEFAULT_OUT)
    p.add_argument("--ckpt", default=recipe.DEFAULT_SNAPSHOT,
                   help="the weights to continue: a snapshot .npz or a "
                        "checkpoint directory")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    env = os.environ.get
    return finetune_robust(
        args.deadline, args.pool, args.b_pool, args.out_ckpt,
        ckpt=args.ckpt, eval_n=int(env("FT_EVAL_N", EVAL_N)),
        batch=int(env("FT_BATCH", BATCH)), lr=float(env("FT_LR", LR)),
        degrade_p=float(env("FT_DEGRADE_P", DEGRADE_P)),
        b_frac=float(env("FT_B_FRAC", B_FRAC)),
        hard=env("FT_HARD", "1") != "0",
        b_pool_n=int(env("FT_B_POOL_N", B_POOL_N)), device=args.device,
        log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main(sys.argv[1:])
