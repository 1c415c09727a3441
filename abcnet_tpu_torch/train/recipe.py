"""What the production training recipe's three trainers share
(train/train_r5.py, train/finetune_robust.py, train/finetune_hard.py).

The JAX package's scripts/train_r5.py, finetune_robust.py and
finetune_hard.py repeat these pieces three times; here each is written
once and keeps the scripts' behaviour:
  * the pool split: the first `eval_n` rows are the frozen eval split,
    turned into examples with `random.Random(1)`, whose stream then
    drives training augmentation (`split_pool`);
  * `run_eval`: eval_step over the split at batch EVAL_BATCH, one
    "EVAL k=v ..." line;
  * `Loop`: the learning-rate changes, one train step on a collated
    batch with the metrics step every METRICS_EVERY-th step, and the log
    line every `log_every` steps with the scripts' keys;
  * `snapshot_and_commit`: the float16 insurance snapshot
    (models/weights.py:save_snapshot_f16), written in-process, then a
    git commit of it (up to three attempts; a failure is logged, never
    raised);
  * the fine-tunes' model: the production UNet with the plain step (no
    block rematerialized), continued from a checkpoint directory whole or
    from a snapshot's weights (`--ckpt`), or resumed whole from the
    trainer's own output directory.

Each trainer takes an injectable `clock` (default time.time), which its
deadline-keyed schedule reads, and a `log` for its lines.
"""

from __future__ import annotations

import contextlib
import os
import random
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import pipeline
from ..models.unet import UNet
from ..models.weights import load_weights, save_snapshot_f16
from ..ops import losses
from . import trainer
from .metrics import MeterBank

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_CACHE = os.path.join(REPO, "data_cache")
DEFAULT_SNAPSHOT = os.path.join(REPO, "snapshots", "r5_latest.npz")
# The port's outputs: never the JAX package's weights/ (orbax) nor the
# committed snapshots/r5_latest.npz, which every gate reads.
CKPT_DIR = os.path.join(REPO, "weights_torch")

EVAL_BATCH = 16
METRICS_EVERY = 10          # the sampled metrics step (every 10th step)
FT_TAIL_FRACTION = 0.85     # the fine-tunes' LR drop point in the budget
FT_TAIL_LR = 1e-5
COMMIT_ATTEMPTS = 3
COMMIT_RETRY_S = 5.0


def lr_for_fraction(f: float, base: float) -> float:
    """train_r5's schedule over the budget fraction: base before 1/3,
    base/10 before 0.8, then 1e-5 (scripts/train_r5.py)."""
    if f < 1 / 3:
        return base
    if f < 0.8:
        return base * 0.1
    return 1e-5


def finetune_lr(frac: float, lr: float) -> float:
    """The fine-tunes' schedule: `lr`, then 1e-5 from 0.85 of the
    budget."""
    return lr if frac < FT_TAIL_FRACTION else FT_TAIL_LR


@contextlib.contextmanager
def atom_type_weights(weights):
    """ops/losses.set_atom_type_weights for the duration of a run: the
    weights are module-global, and a trainer called in a process that
    goes on to other work leaves them as it found them."""
    prev = losses.get_atom_type_weights()
    losses.set_atom_type_weights(weights)
    try:
        yield
    finally:
        losses.set_atom_type_weights(prev)


def split_pool(samples: Sequence[pipeline.Sample], eval_n: int):
    """(eval samples, train samples, eval examples, rng): the first
    `eval_n` rows are the eval split, made into examples with
    random.Random(1) (train=False draws nothing); the same rng then
    drives training augmentation."""
    rng = random.Random(1)
    eval_samples, train_samples = samples[:eval_n], samples[eval_n:]
    eval_examples = [pipeline.sample_to_example(s, rng, train=False)
                     for s in eval_samples]
    return eval_samples, train_samples, eval_examples, rng


def run_eval(state: trainer.TrainState, examples, log=print
             ) -> Dict[str, float]:
    """Eval-mode metrics over `examples` at batch EVAL_BATCH (whole
    batches), printed as one EVAL line; returns the averages."""
    meters = MeterBank()
    for hb in pipeline.batches_from_examples(examples, EVAL_BATCH,
                                             shuffle=False):
        _, _, mets = trainer.eval_step(state,
                                       trainer.to_device(hb, state.device))
        meters.update(mets)
    avg = meters.averages()
    log("EVAL " + " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items())))
    return avg


def log_line(step: int, total: float, ips: float, avg: Dict[str, float],
             epoch: Optional[int] = None) -> str:
    """The scripts' progress line: train_r5's (with the epoch and rho) or
    the fine-tunes' (epoch None)."""
    head = f"step {step} " if epoch is None else f"ep {epoch} step {step} "
    line = (head + f"loss {total:.3f} ips {ips:.0f} "
            f"aP {avg.get('atom_target_precision', 0):.3f} "
            f"bP {avg.get('bond_target_precision', 0):.3f} "
            f"oP {avg.get('bond_omega_precision', 0):.3f}")
    if epoch is not None:
        line += f" rho {avg.get('bond_rhos_mae', 0):.3f}"
    return line


@dataclass
class RecipeResult:
    """What a trainer's run did, beside the lines it printed."""
    start_step: int
    step: int = 0
    batch: int = 0
    lr_changes: List[Tuple[int, float]] = field(default_factory=list)
    metrics_steps: int = 0
    logged: List[Tuple[int, float]] = field(default_factory=list)
    checkpoints: List[int] = field(default_factory=list)
    snapshots: List[Tuple[int, bool]] = field(default_factory=list)
    evals: List[Tuple[int, Dict[str, float]]] = field(default_factory=list)
    step_wall_s: List[float] = field(default_factory=list)
    last_loss: object = None        # the last step's total (a tensor)
    hard_idx: Optional[np.ndarray] = None
    final: object = None            # finetune_hard's ScoreReport

    @property
    def steps(self) -> int:
        return self.step - self.start_step


class Loop:
    """The train-loop mechanics of the three trainers, on a TrainState:
    learning-rate changes (a line each), one step on a list of examples
    (collate, host -> device, train_step with a fresh per-step rng, the
    metrics step on the same batch and rng every METRICS_EVERY-th step),
    the log line every `log_every` steps, checkpoints and evals, all
    recorded in `result`."""

    def __init__(self, state: trainer.TrainState, cfg: trainer.TrainConfig,
                 clock: Callable[[], float], log: Callable[[str], None]):
        self.state, self.cfg, self.clock, self.log = state, cfg, clock, log
        self.step = state.step
        self.result = RecipeResult(start_step=state.step, step=state.step,
                                   batch=cfg.batch_size)
        self.meters = MeterBank()
        self.cur_lr: Optional[float] = None
        self.t0 = clock()
        self._last = None

    def set_lr(self, lr: float, line: Optional[str] = None) -> None:
        """Set the learning rate if it changed (always, with line None:
        the fine-tunes' initial set), printing `line`."""
        if line is not None and lr == self.cur_lr:
            return
        trainer.set_learning_rate(self.state, lr)
        self.cur_lr = lr
        self.result.lr_changes.append((self.step, lr))
        if line is not None:
            self.log(line)

    def train(self, examples: Sequence[pipeline.Example],
              epoch: Optional[int] = None):
        batch = trainer.to_device(pipeline.collate(examples),
                                  self.state.device)
        sub = trainer.next_rng(self.state)
        self.state, total, _, _ = trainer.train_step(
            self.state, batch, sub, amount=self.cfg.amount,
            with_metrics=False)
        if self.step % METRICS_EVERY == 0:
            self.meters.update(trainer.train_metrics_step(
                self.state, batch, sub, amount=self.cfg.amount))
            self.result.metrics_steps += 1
        self.step += 1
        self.result.step = self.step
        self.result.last_loss = total
        now = time.perf_counter()
        if self._last is not None:
            self.result.step_wall_s.append(now - self._last)
        self._last = now
        if self.step % self.cfg.log_every == 0:
            avg = self.meters.averages()
            self.meters.reset()
            ips = self.cfg.log_every * self.cfg.batch_size / (
                self.clock() - self.t0)
            self.t0 = self.clock()
            self.result.logged.append((self.step, float(total)))
            self.log(log_line(self.step, float(total), ips, avg, epoch))
        return total

    def checkpoint(self, ckpt_dir: str) -> None:
        trainer.save_checkpoint(self.state, ckpt_dir, self.step)
        self.result.checkpoints.append(self.step)

    def evaluate(self, examples) -> None:
        self.result.evals.append(
            (self.step, run_eval(self.state, examples, self.log)))
        self.t0 = self.clock()


def commit_snapshot(path: str, step: int, log=print) -> None:
    """`git add` and `git commit` the snapshot in the repository that
    holds it (`git -C` its directory): up to COMMIT_ATTEMPTS attempts, a
    failure logged and never raised."""
    root, name = os.path.split(os.path.abspath(path))
    for attempt in range(COMMIT_ATTEMPTS):
        try:
            subprocess.run(["git", "-C", root, "add", name], check=True,
                           capture_output=True, timeout=60)
            r = subprocess.run(
                ["git", "-C", root, "commit",
                 "-m", f"r5 training snapshot at step {step}", "--", name],
                capture_output=True, text=True, timeout=60)
            log(f"[snapshot] commit step {step}: rc={r.returncode} "
                f"{(r.stdout or r.stderr).strip().splitlines()[:1]}")
            return
        except (OSError, subprocess.SubprocessError) as e:
            log(f"[snapshot] git attempt {attempt}: {e}")
            time.sleep(COMMIT_RETRY_S)


def snapshot_and_commit(model: torch.nn.Module, path: str, step: int,
                        commit: bool, log=print) -> bool:
    """The float16 snapshot of `model` at `path`, then, if `commit`, its
    commit. A failure of either is logged and the run goes on; returns
    whether the snapshot was written."""
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        save_snapshot_f16(model, path, step, log)
    except Exception as e:  # noqa: BLE001 — insurance must not end the run
        log(f"[snapshot] FAILED at step {step}: {e}")
        return False
    if commit:
        commit_snapshot(path, step, log)
    return True


def has_checkpoint(ckpt_dir: str) -> bool:
    """Whether `ckpt_dir` holds anything (the scripts' resume test)."""
    return os.path.isdir(ckpt_dir) and bool(os.listdir(ckpt_dir))


def finetune_state(cfg: trainer.TrainConfig, ckpt: str, out_ckpt: str,
                   log=print) -> Tuple[trainer.TrainState, bool]:
    """The fine-tunes' state: the production UNet with the plain step (at
    the scripts' batch of 128 it fits one H100 80GB without recomputing a
    block: the train-mode BatchNorm keeps only the bf16 conv output for
    its backward, ops/bn_act.py), resumed whole (moments, LR, step,
    generator) from `out_ckpt` when it holds a checkpoint, else continued
    from `ckpt`: a checkpoint directory whole, as the scripts restore their
    source checkpoint, or a snapshot .npz, which holds no optimizer state,
    with fresh Adam moments at its step. Either source must hold the
    production UNet. Returns (state, resumed), resumed only from
    `out_ckpt`."""
    dtype = getattr(torch, cfg.dtype)
    model = UNet(dtype=dtype)
    if has_checkpoint(out_ckpt):
        state = trainer.create_state(cfg, model=model)
        return trainer.restore_checkpoint(state, out_ckpt), True
    src, step = load_weights(ckpt, "cpu", dtype)
    if type(src) is not UNet or src.fused_head_bank:
        raise ValueError(f"--ckpt {ckpt}: the fine-tunes continue the "
                         f"production UNet, not a {type(src).__name__}"
                         + (" with a fused head bank"
                            if getattr(src, "fused_head_bank", False)
                            else ""))
    if has_checkpoint(ckpt):
        state = trainer.create_state(cfg, model=model)
        return trainer.restore_checkpoint(state, ckpt), False
    model.load_state_dict(src.state_dict())
    state = trainer.create_state(cfg, model=model)
    state.step = step
    log(f"weights from {ckpt} (step {step}, fresh Adam moments)")
    return state, False
