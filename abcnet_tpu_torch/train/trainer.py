"""Training on one GPU or data-parallel over several: train/eval steps,
checkpoints, the fit loop.

Counterpart of abcnet_tpu/train/trainer.py; semantics parity with the
reference training loop (reference src/train.py:44-141):
  * Adam lr 2.5e-4, weight_decay 1e-8 added to the gradient before the
    moments (torch.optim.Adam's own weight_decay), dropped to 2.5e-5 at
    epoch floor(epochs/3) keeping the moments (the JAX package's
    documented divergence from the reference, which re-creates the
    optimizer there)
  * batch 64, the eight uncertainty-weighted focal/L1 losses
  * the metric suite sampled every `metrics_every` steps and printed
    every `log_every`, a test-split eval every `eval_every` steps
  * a checkpoint per epoch, with resume (moments, LR, generator state)

One step on the device: packed bits -> unpack + salt/pepper noise
(kernel 2, ops/noise.py), scatter-built targets, forward, losses,
backward, Adam. Host code only feeds packed batches (pinned,
non-blocking copies) and fetches accumulated scalars at logging time;
no step reads a value back.

PyTorch's idiom replaces the JAX package's functional state: a
`TrainState` holds the `nn.Module`, the optimizer, the step count and a
CPU `torch.Generator`. The steps update the module and the optimizer
in place and return the same state object. Randomness is explicit: a
step takes an integer `rng` (drawn from the state's generator when not
given, the counterpart of `key, sub = jax.random.split(key)`), seeds a
generator on the model's device with it and draws the noise rates, the
noise kernel's seed and the dropout masks from that, in this order. So
the same `rng` gives `train_metrics_step` the very images its paired
`train_step` saw, and nothing touches the global random state.

Data parallel (the JAX package's SPMD step over a `data` mesh,
abcnet_tpu/train/trainer.py:385-417) is one process per GPU under
`torchrun`, over the state's `parallel.Mesh`. `cfg.batch_size` stays the
global batch: every rank draws it in the same seeded order and takes its
rows (`parallel.shard_batch`). The module is replicated from rank 0 and
wrapped in DistributedDataParallel; its BatchNorms normalize over the
global batch; every loss term is the rank's share of the global ratio
(ops/losses.py), so the backward of world × the rank's total, averaged
by DDP, is the gradient of the global loss. Totals, terms and metric
(num, den) pairs are summed over the ranks before they are returned.
Each rank draws its noise and dropout from its own stream, derived from
the shared per-step `rng` and its rank (rank 0's is the single-process
stream). Rank 0 writes the checkpoints.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..data import pipeline, vocab
from ..models.unet import PRODUCTION_HEADS, UNet
from ..ops import losses as L
from ..ops.noise import SEED_MAX
from ..ops.targets import build_targets
from ..parallel import (Mesh, all_reduce_sum, make_mesh, replicate_tree,
                        shard_batch, sync_batchnorm)
from ..utils.device import resolve_device
from . import metrics as M

Batch = Dict[str, torch.Tensor]


@dataclass
class TrainConfig:
    heads: Tuple[int, ...] = PRODUCTION_HEADS
    batch_size: int = 64
    lr: float = 2.5e-4
    weight_decay: float = 1e-8
    epochs: int = 30
    lr_drop_factor: float = 0.1
    amount: float = 0.2          # noise amount (utils.py:73-80)
    dtype: str = "bfloat16"      # compute dtype; params/BN stats f32
    seed: int = 0
    log_every: int = 100
    eval_every: int = 100
    # Train metrics are sampled every k-th step (the NMS metric suite
    # costs real step time; the reference computes it every step).
    metrics_every: int = 5
    # Eval materializes the dense (6,60,G,G) bond_type target per sample
    # (~24 MB f32); a smaller eval batch keeps device memory headroom.
    eval_batch_size: int = 16
    ckpt_dir: Optional[str] = None
    # Data-parallel ranks: None takes every rank of the process group
    # (one process per GPU, started by torchrun), or one device without
    # a group; more than one needs the group.
    n_devices: Optional[int] = None
    device: str = "cuda"         # "cpu" runs the plain versions (tests)

    @property
    def lr_drop_epoch(self) -> int:
        return int(self.epochs / 3)


@dataclass
class TrainState:
    model: UNet
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator     # CPU; the source of the per-step rng
    mesh: Optional[Mesh] = None    # None: one device, no process group
    # The module wrapped for the gradient all-reduce (mesh.world > 1)
    ddp: Optional[DistributedDataParallel] = field(default=None,
                                                   repr=False)

    @property
    def device(self) -> torch.device:
        return self.model.s.device

    @property
    def rank(self) -> int:
        return self.mesh.rank if self.mesh is not None else 0

    @property
    def world(self) -> int:
        return self.mesh.world if self.mesh is not None else 1

    @property
    def group(self):
        return self.mesh.group if self.world > 1 else None


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module
                   ) -> torch.optim.Adam:
    """torch-style Adam: wd added to the gradient before the moments
    (train.py:55), eps 1e-8 outside the square root."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Host-side LR update between epochs; the moments stay."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def _train_mesh(cfg: TrainConfig) -> Mesh:
    if dist.is_initialized():
        return make_mesh(cfg.n_devices, cfg.device)
    if cfg.n_devices is not None and cfg.n_devices > 1:
        raise RuntimeError(
            f"n_devices={cfg.n_devices}: data-parallel training runs one "
            "process per GPU; start it with torchrun (python -m torch."
            "distributed.run --nproc-per-node N -m abcnet_tpu_torch train "
            "...) or join a process group with parallel.init_distributed()")
    return Mesh((resolve_device(cfg.device),))


def create_state(cfg: TrainConfig, model: Optional[torch.nn.Module] = None,
                 mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh state on the mesh's device (`cfg.device` without a process
    group): the production UNet initialized from `cfg.seed` (or `model`,
    e.g. one loaded from a snapshot, or a variant such as UNetCBAM),
    Adam, step 0 and the rng generator seeded `cfg.seed + 1`. In a
    process group the module is replicated from rank 0, its BatchNorms
    take the group, and it is wrapped for the gradient all-reduce."""
    mesh = mesh or _train_mesh(cfg)
    dev = mesh.device
    if model is None:
        # Seeded init on the CPU that leaves the global random state as
        # it was.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = UNet(heads=tuple(cfg.heads),
                         dtype=getattr(torch, cfg.dtype))
    model = sync_batchnorm(replicate_tree(model.to(dev), mesh), mesh)
    ddp = None
    if mesh.world > 1:
        ddp = DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False, process_group=mesh.group)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model),
                      step=0,
                      generator=torch.Generator().manual_seed(cfg.seed + 1),
                      mesh=mesh, ddp=ddp)


def next_rng(state: TrainState) -> int:
    """The next per-step seed from the state's generator (on the host:
    no device sync)."""
    return int(torch.randint(0, SEED_MAX, (1,), generator=state.generator))


# Odd 63-bit constant (the golden ratio's) that spreads ranks' streams.
_RANK_STRIDE = 0x1E3779B97F4A7C15


def _step_generator(state: TrainState, rng: Optional[int]
                    ) -> torch.Generator:
    """This rank's generator for one step: seeded with `rng` on rank 0
    and with a seed derived from `rng` and the rank on the others, so
    ranks stamp different noise and dropout on their images."""
    seed = next_rng(state) if rng is None else int(rng)
    seed = (seed + state.rank * _RANK_STRIDE) % (SEED_MAX + 1)
    return torch.Generator(device=state.device).manual_seed(seed)


def _global(state: TrainState, total: torch.Tensor,
            losses: Dict[str, torch.Tensor], metrics: Dict[str, Tuple]):
    """Total, terms and metric pairs summed over the ranks (one
    all-reduce); as they are in a single process."""
    if state.world == 1:
        return total, losses, metrics
    keys = list(metrics)
    flat = torch.stack([total.detach().float()]
                       + [v.detach().float() for v in losses.values()]
                       + [x.float() for pair in metrics.values()
                          for x in pair])
    all_reduce_sum(flat, state.mesh)
    n = len(losses)
    pairs = flat[1 + n:].reshape(-1, 2)
    return (flat[0], dict(zip(losses, flat[1:1 + n])),
            {k: (pairs[i, 0], pairs[i, 1]) for i, k in enumerate(keys)})


def to_device(host_batch: Dict[str, np.ndarray], device) -> Batch:
    """A host batch dict on `device`: pinned, non-blocking copies for a
    GPU (the single-device counterpart of parallel.shard_batch). Tensors
    already there pass through."""
    dev = torch.device(device)
    out = {}
    for k, v in host_batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


def _input_images(batch: Batch, dtype: torch.dtype,
                  generator: Optional[torch.Generator], amount: float,
                  train: bool) -> torch.Tensor:
    """The (B, H, W, 1) ink mask of a batch, noisy if `train`: from packed
    bits through the unpack / noise kernels, or from a uint8 batch."""
    if "image_bits" in batch:
        return pipeline.device_unpack_bits(
            batch["image_bits"], train=train, dtype=dtype, amount=amount,
            generator=generator)
    return pipeline.device_preprocess(
        batch["image_u8"], amount=amount, train=train, generator=generator,
        dtype=dtype)


def loss_and_metrics(model: UNet, batch: Batch,
                     generator: Optional[torch.Generator] = None,
                     amount: float = 0.2, train: bool = True,
                     with_metrics: bool = True, group=None,
                     forward: Optional[torch.nn.Module] = None):
    """One forward: preprocess -> targets -> model -> losses.

    train=True puts the model in train mode (batch-stat BN, whose
    running statistics are updated in place, and dropout), draws the
    input noise, and uses the fused bond-type loss; train=False is the
    eval forward with the dense bond-type target. Returns (total, aux)
    with aux["losses"] and, if asked, aux["metrics"]; `total` carries
    the graph when gradients are enabled. With a process `group` the
    losses are this rank's shares of the global batch's (ops/losses.py);
    `forward` is the module to call in place of `model` (its DDP
    wrapper)."""
    images = _input_images(batch, model.dtype, generator, amount, train)
    grid = images.shape[1] // vocab.STRIDE
    targets = build_targets(batch, with_full_type=not train, grid=grid)

    model.train(train)
    preds = (forward or model)(images,
                               generator=generator if train else None)
    losses = L.compute_losses(preds, targets, batch, fused_bond_type=train,
                              group=group)
    total = L.total_loss(losses, model.s)
    aux = {"losses": losses}
    if with_metrics:
        with torch.no_grad():
            aux["metrics"] = M.compute_metrics(preds,
                                               L._to_nhwc_targets(targets))
    return total, aux


def _detached(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in d.items()}


def _backward(state: TrainState, total: torch.Tensor) -> None:
    """Gradient of the global loss: DDP averages the ranks' gradients, and
    each rank's total is its share, so it is scaled by the world size."""
    (total * state.world if state.world > 1 else total).backward()


def train_step(state: TrainState, batch: Batch, rng: Optional[int] = None,
               amount: float = 0.2, with_metrics: bool = True):
    """One training step on a device batch (this rank's rows); updates
    `state` in place. with_metrics=False skips the NMS metric suite
    (callers may sample it every k-th step with train_metrics_step
    instead). Returns (state, total, losses, metrics) as device tensors,
    those of the global batch."""
    gen = _step_generator(state, rng)
    state.optimizer.zero_grad(set_to_none=True)
    total, aux = loss_and_metrics(state.model, batch, gen, amount, True,
                                  with_metrics, state.group, state.ddp)
    _backward(state, total)
    state.optimizer.step()
    state.step += 1
    total, losses, metrics = _global(state, total.detach(),
                                     _detached(aux["losses"]),
                                     aux.get("metrics", {}))
    return state, total, losses, metrics


def _interleave_split(batch: Batch, n_micro: int) -> Batch:
    """Split a batch into n_micro microbatches along axis 0, interleaved
    (microbatch i takes elements i, i+n, i+2n, ...), as the JAX package
    does to keep a data-sharded batch shard-local: (n_micro, B/n, ...)."""
    def split(v):
        b = v.shape[0]
        return v.reshape(b // n_micro, n_micro,
                         *v.shape[1:]).transpose(0, 1).contiguous()
    return {k: split(v) for k, v in batch.items()}


def train_step_scan(state: TrainState, batch: Batch,
                    rng: Optional[int] = None, amount: float = 0.2,
                    n_micro: int = 2):
    """train_step at effective batch B as a loop over n_micro
    microbatches of B/n_micro and one Adam update.

    Each microbatch's graph is freed by its backward, so activation
    memory is that of one microbatch while the optimizer sees the mean
    of the microbatch gradients. BatchNorm normalizes per microbatch
    and its running statistics move once per microbatch; noise and
    dropout continue one generator stream across the microbatches.
    Returns (state, mean total, mean losses, {})."""
    micro = _interleave_split(batch, n_micro)
    gen = _step_generator(state, rng)
    state.optimizer.zero_grad(set_to_none=True)
    tsum, lsum = 0.0, {}
    for i in range(n_micro):
        mb = {k: v[i] for k, v in micro.items()}
        # Under DDP the gradients are reduced once, after the last one.
        sync = (state.ddp.no_sync() if state.ddp is not None
                and i < n_micro - 1 else contextlib.nullcontext())
        with sync:
            total, aux = loss_and_metrics(state.model, mb, gen, amount,
                                          True, False, state.group,
                                          state.ddp)
            _backward(state, total / n_micro)
        tsum = tsum + total.detach()
        for k, v in aux["losses"].items():
            lsum[k] = lsum.get(k, 0.0) + v.detach()
    state.optimizer.step()
    state.step += 1
    total, losses, _ = _global(state, tsum / n_micro,
                               {k: v / n_micro for k, v in lsum.items()},
                               {})
    return state, total, losses, {}


@torch.no_grad()
def train_metrics_step(state: TrainState, batch: Batch, rng: int,
                       amount: float = 0.2):
    """Detection metrics on the training batch under eval-mode forward
    semantics (running BN stats, no dropout): train-mode batch-stat BN
    and dropout suppress peaks below the 0.25 threshold and quantize
    precision to n/tiny-count. The same `rng` as the paired train step
    regenerates the very same noisy images; only the forward mode
    differs."""
    images = _input_images(batch, state.model.dtype,
                           _step_generator(state, rng), amount, True)
    grid = images.shape[1] // vocab.STRIDE
    targets = build_targets(batch, with_full_type=False, grid=grid)
    state.model.eval()
    preds = state.model(images)
    metrics = M.compute_metrics(preds, L._to_nhwc_targets(targets))
    return _global(state, torch.zeros((), device=state.device), {},
                   metrics)[2]


@torch.no_grad()
def eval_step(state: TrainState, batch: Batch):
    """Eval forward (no noise, running BN stats, dense bond-type target)
    -> (total, losses, metrics) of the global batch."""
    total, aux = loss_and_metrics(state.model, batch, None, 0.0, False,
                                  group=state.group)
    return _global(state, total, aux["losses"], aux["metrics"])


@torch.no_grad()
def predict_step(state: TrainState, images: torch.Tensor):
    """Inference forward on preprocessed images (B, H, W, 1)."""
    state.model.eval()
    return state.model(images)


# ---------------------------------------------------------------------------
# Checkpointing — the reference saves a state_dict per epoch
# (train.py:435); here model, optimizer, step and generator, with resume.
# ---------------------------------------------------------------------------

def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")


def save_checkpoint(state: TrainState, ckpt_dir: str,
                    step: Optional[int] = None) -> str:
    """Persist model, full optimizer state (Adam moments, step counts,
    LR), step and the rng generator's state, so a resume continues with
    identical moments, LR and random stream. Written by rank 0 to a
    temporary name and renamed into place."""
    step = state.step if step is None else step
    path = _ckpt_path(ckpt_dir, step)
    if state.rank == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(step),
                    "generator": state.generator.get_state()}, tmp)
        os.replace(tmp, path)
    if state.world > 1:
        dist.barrier(group=state.group)   # the file exists for every rank
    return path


def checkpoint_path(ckpt_dir: str, step: Optional[int] = None) -> str:
    """The file of the latest (or given-step) checkpoint under
    `ckpt_dir`; raises when the directory holds none."""
    root = os.path.abspath(ckpt_dir)
    if step is None:
        steps = sorted(int(f[len("step_"):-len(".pt")])
                       for f in os.listdir(root)
                       if f.startswith("step_") and f.endswith(".pt"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = steps[-1]
    return _ckpt_path(root, step)


def restore_checkpoint(state: TrainState, ckpt_dir: str,
                       step: Optional[int] = None) -> TrainState:
    """Restore the latest (or given-step) checkpoint into `state`."""
    ckpt = torch.load(checkpoint_path(ckpt_dir, step),
                      map_location=state.device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator"].cpu())
    return state


# ---------------------------------------------------------------------------
# Fit loop
# ---------------------------------------------------------------------------

def _rows(host_batch: Dict[str, np.ndarray], state: TrainState):
    """This rank's rows of a global host batch."""
    return shard_batch(host_batch, state.mesh) if state.world > 1 \
        else host_batch


def fit(cfg: TrainConfig, train_examples, test_examples=None,
        state: Optional[TrainState] = None, verbose: bool = True,
        mesh: Optional[Mesh] = None) -> TrainState:
    """Train over in-memory data (see data/pipeline.py for sources).

    train_examples may be raw Samples — then every epoch re-augments
    them (the reference's dataloader re-runs __getitem__ per epoch,
    utils.py:47-61) — or pre-built Examples (fixed augmentation). In a
    process group every rank calls fit with the same data and config;
    each trains on its rows of every global batch, and only rank 0
    prints."""
    samples_mode = bool(train_examples) and isinstance(
        train_examples[0], pipeline.Sample)
    if state is None:
        state = create_state(cfg, mesh=mesh)
    dev = state.device
    verbose = verbose and state.rank == 0
    meters = M.MeterBank()
    t0 = time.time()
    imgs_done = 0

    steps_per_epoch = max(len(train_examples) // cfg.batch_size, 1)
    start_epoch = min(state.step // steps_per_epoch, cfg.epochs)

    for epoch in range(start_epoch, cfg.epochs):
        if epoch >= cfg.lr_drop_epoch:
            # >= not ==: a resume past the drop point must not train at
            # the full LR again.
            set_learning_rate(state, cfg.lr * cfg.lr_drop_factor)
        if samples_mode:
            it = pipeline.batches_from_samples(
                train_examples, cfg.batch_size, seed=cfg.seed,
                epoch=epoch, train=True)
        else:
            it = pipeline.batches_from_examples(
                train_examples, cfg.batch_size, seed=cfg.seed + epoch)
        for host_batch in pipeline.PrefetchIterator(it):
            batch = to_device(_rows(host_batch, state), dev)
            sub = next_rng(state)
            with_m = state.step % cfg.metrics_every == 0
            state, total, _, _ = train_step(state, batch, sub,
                                            amount=cfg.amount,
                                            with_metrics=False)
            if with_m:
                # Eval-mode forward on the same augmented batch (see
                # train_metrics_step), with the post-update parameters,
                # like the reference's post-step metric reads.
                meters.update(train_metrics_step(state, batch, sub,
                                                 amount=cfg.amount))
            imgs_done += cfg.batch_size
            if verbose and state.step % cfg.log_every == 0:
                avg = meters.averages()
                ips = imgs_done / (time.time() - t0)
                print(f"epoch {epoch} step {state.step} "
                      f"loss {float(total):.4f} ips {ips:.1f} "
                      + " ".join(f"{k}={v:.4f}" for k, v in
                                 sorted(avg.items())), flush=True)
                meters.reset()
            if test_examples and state.step % cfg.eval_every == 0:
                evaluate(state, test_examples, cfg, verbose=verbose)
        if cfg.ckpt_dir:
            save_checkpoint(state, cfg.ckpt_dir)
    return state


def evaluate(state: TrainState, examples, cfg: TrainConfig,
             verbose: bool = True) -> Dict[str, float]:
    """Eval-mode losses and metrics over `examples` in batches of
    `cfg.eval_batch_size` (global batches, sharded like training); one
    host fetch at the end. The mean total loss is returned under "loss"
    beside the metric averages."""
    meters = M.MeterBank()
    total_sum, nb = 0.0, 0
    verbose = verbose and state.rank == 0
    for host_batch in pipeline.batches_from_examples(
            examples, cfg.eval_batch_size, shuffle=False,
            drop_remainder=True):
        total, _, mets = eval_step(state, to_device(_rows(host_batch, state),
                                                    state.device))
        meters.update(mets)
        total_sum = total_sum + total
        nb += 1
    avg = meters.averages()
    loss = float(total_sum) / max(nb, 1)
    if verbose:
        print(f"eval  loss {loss:.4f} "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items())),
              flush=True)
    return {"loss": loss, **avg}
