"""Command-line surface of the port: train, img2smiles and cal-acc.

    python -m abcnet_tpu_torch train --data DIR [-b 64] [--lr 2.5e-4]
        [--epochs 30] [--amount 0.2] [--seed 0] [--ckpt DIR]
        [--dtype bfloat16] [--no-test-split] [--resume DIR]
        [--device cuda]
    torchrun --nproc-per-node N -m abcnet_tpu_torch train --data DIR ...
    python -m abcnet_tpu_torch img2smiles --data DIR_OR_CSV [--ckpt NPZ]
        [--out results.csv] [-b 64] [--processes 0] [--mesh N]
        [--threshold 0.6] [--dtype bfloat16] [--device cuda]
    python -m abcnet_tpu_torch cal-acc results.csv

The flags are those of abcnet_tpu's CLI (abcnet_tpu/__main__.py:289-308)
plus --device; --ckpt names a weight snapshot (.npz, default
snapshots/r5_latest.npz). `train --data DIR` reads DIR/dataset.csv (the
format the JAX package's `gen` writes); training without --data needs
the molecule generator, which is not ported yet. Under torchrun `train`
runs as one rank of a data-parallel job (one process per GPU, -b the
global batch); `img2smiles --mesh N` shards every batch over N GPUs
from one process.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SNAPSHOT = os.path.join(REPO, "snapshots", "r5_latest.npz")


def img2smiles_loop(run, images: Sequence[np.ndarray], batch_size: int,
                    pool=None, log_every: int = 10) -> List[Optional[str]]:
    """Decode `images` (uint8 (512, 512) arrays) with an inference
    pipeline (infer.decode.make_infer_pipeline) in batches of
    `batch_size`; returns one SMILES (or None) per image.

    Three-way overlap: batch i+1's device work is dispatched before batch
    i is assembled, batch i+1's peaks are fetched into pinned host memory
    on a worker thread, and the main thread assembles batch i meanwhile,
    so the steady state is max(device, fetch, assembly), not their sum.
    The trailing chunk is padded to the full batch with its last image
    and the padding dropped afterwards, so every row is scored."""
    from .infer.assemble import assemble_batch

    dispatch = getattr(run, "dispatch", run)
    fetch = getattr(run, "fetch", lambda h: h)
    preds: List[Optional[str]] = []
    pending = None                       # (future -> host peaks, n_real)
    fetcher = ThreadPoolExecutor(max_workers=1)
    try:
        for i in range(0, len(images), batch_size):
            chunk = list(images[i:i + batch_size])
            k = len(chunk)
            if k < batch_size:
                chunk = chunk + [chunk[-1]] * (batch_size - k)
            fut = fetcher.submit(fetch, dispatch(np.stack(chunk)))
            if pending is not None:
                preds.extend(assemble_batch(pending[0].result(),
                                            pool=pool)[:pending[1]])
            pending = (fut, k)
            if log_every and (i // batch_size) % log_every == 0:
                print(f"{min(i + batch_size, len(images))}/{len(images)}",
                      flush=True)
        if pending is not None:
            preds.extend(assemble_batch(pending[0].result(),
                                        pool=pool)[:pending[1]])
    finally:
        fetcher.shutdown(wait=True)
    return preds


def _cmd_train(args) -> None:
    import random

    import torch

    from .data import pipeline
    from .parallel import init_distributed
    from .train.trainer import (TrainConfig, create_state, fit,
                                restore_checkpoint)
    from .utils.device import resolve_device

    resolve_device(args.device)
    if not args.data:
        raise NotImplementedError(
            "train without --data generates molecules on the fly "
            f"(--synthetic {args.synthetic}); the generator stack "
            "(data/generate.py, layout, render, raster canvas, "
            "chem/random_mol.py) is not ported yet: pass --data DIR with a "
            "dataset written by `python -m abcnet_tpu gen`")
    csv_path = os.path.join(args.data, "dataset.csv")
    if not os.path.exists(csv_path):
        sys.exit(f"error: dataset csv not found: {csv_path}")
    cfg = TrainConfig(batch_size=args.batch_size, lr=args.lr,
                      epochs=args.epochs, amount=args.amount,
                      seed=args.seed, ckpt_dir=args.ckpt, dtype=args.dtype,
                      device=args.device)
    # One rank of a data-parallel job when torchrun started the process.
    mesh = init_distributed(args.device)
    state = create_state(cfg, mesh=mesh)
    if args.resume:
        state = restore_checkpoint(state, args.resume)
        if mesh.rank == 0:
            print(f"resumed from step {state.step}")
    samples = pipeline.load_csv_dataset(csv_path)
    n_test = max(len(samples) // 90, 1) if args.test_split else 0
    rng = random.Random(args.seed)
    # Eval split: fixed un-augmented examples; the train split stays raw
    # Samples so fit() re-augments every epoch (utils.py:47-61 role).
    test = [pipeline.sample_to_example(s, rng, train=False)
            for s in samples[:n_test]] if n_test else None
    train = samples[n_test:]
    if mesh.rank == 0:
        print(f"training on {len(train)} samples, eval on {n_test}"
              + (f", {mesh.world} ranks" if mesh.world > 1 else ""),
              flush=True)
    fit(cfg, train, test, state=state)
    if mesh.world > 1:
        torch.distributed.destroy_process_group()


def _cmd_img2smiles(args) -> None:
    import torch

    from .data.pipeline import load_image_csv
    from .eval.scoring import score_pairs, write_results_csv
    from .infer.decode import make_infer_pipeline
    from .models.weights import load_snapshot
    from .utils.device import resolve_device

    resolve_device(args.device)
    csv_path = args.data if args.data.endswith(".csv") \
        else os.path.join(args.data, "dataset.csv")
    if not os.path.exists(csv_path):
        sys.exit(f"error: dataset csv not found: {csv_path}")
    model, step = load_snapshot(args.ckpt, device=args.device,
                                dtype=getattr(torch, args.dtype))
    print(f"weights: {args.ckpt} (step {step})", flush=True)
    images, truths = load_image_csv(csv_path)
    mesh = None
    if args.mesh:
        from .parallel import make_mesh
        mesh = make_mesh(args.mesh, args.device)
    run = make_infer_pipeline(model, args.device, threshold=args.threshold,
                              mesh=mesh)
    pool = None
    if args.processes and args.processes > 1:
        from .infer.assemble import make_assembly_pool
        pool = make_assembly_pool(args.processes)
    try:
        preds = img2smiles_loop(run, images, args.batch_size, pool)
    finally:
        if pool is not None:
            pool.close()
    write_results_csv(args.out, truths, preds)
    print(score_pairs(truths, preds))


def _cmd_cal_acc(args) -> None:
    from .eval.scoring import read_results_csv, score_pairs
    truths, preds = read_results_csv(args.results)
    print(score_pairs(truths, preds))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="abcnet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train the U-Net")
    t.add_argument("--data", help="dataset dir (dataset.csv inside)")
    t.add_argument("--synthetic", type=int, default=2000,
                   help="#examples to generate when --data is omitted "
                        "(needs the generator stack: not ported yet)")
    t.add_argument("-b", "--batch-size", type=int, default=64)
    t.add_argument("--lr", type=float, default=2.5e-4)
    t.add_argument("--epochs", type=int, default=30)
    t.add_argument("--amount", type=float, default=0.2)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--ckpt", help="checkpoint dir")
    t.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    t.add_argument("--test-split", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="hold out 1/90 for eval (--no-test-split to "
                        "train on everything; reference split "
                        "train.py:19-21)")
    t.add_argument("--resume", help="checkpoint dir to resume from")
    t.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    t.set_defaults(fn=_cmd_train)

    i = sub.add_parser("img2smiles", help="decode a dataset to SMILES")
    i.add_argument("--data", required=True,
                   help="dataset dir (dataset.csv inside) or a CSV path; "
                        "label columns optional — a plain (image, smiles) "
                        "CSV like the UOB benchmark works")
    i.add_argument("--ckpt", default=DEFAULT_SNAPSHOT,
                   help="weight snapshot (.npz)")
    i.add_argument("--out", default="results.csv")
    i.add_argument("-b", "--batch-size", type=int, default=64)
    i.add_argument("--processes", type=int, default=0)
    i.add_argument("--mesh", type=int, default=0,
                   help="shard inference batches over N GPUs (-b must "
                        "divide by N)")
    i.add_argument("--threshold", type=float, default=0.6,
                   help="binarize threshold (reference: 0.6 synthetic, "
                        "0.2 scanned benchmarks, utils_for_test.py:23)")
    i.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    i.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    i.set_defaults(fn=_cmd_img2smiles)

    c = sub.add_parser("cal-acc", help="score a results csv")
    c.add_argument("results")
    c.set_defaults(fn=_cmd_cal_acc)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
