"""Command-line surface of the port: gen, train, img2smiles, cal-acc,
test-acc and bench.

    python -m abcnet_tpu_torch gen --out DIR [-n 1000]
        [--mode mixed|rdkit|indigo] [--engine a|b|mix] [--seed 0]
        [--smiles-csv CSV]
    python -m abcnet_tpu_torch train [--data DIR | --synthetic 2000]
        [-b 64] [--lr 2.5e-4] [--epochs 30] [--amount 0.2] [--seed 0]
        [--ckpt DIR] [--dtype bfloat16] [--no-test-split] [--resume DIR]
        [--device cuda]
    torchrun --nproc-per-node N -m abcnet_tpu_torch train ...
    python -m abcnet_tpu_torch img2smiles --data DIR_OR_CSV
        [--ckpt NPZ_OR_DIR]
        [--out results.csv] [-b 64] [--processes 0] [--mesh N]
        [--threshold 0.6] [--dtype bfloat16] [--device cuda]
    python -m abcnet_tpu_torch cal-acc results.csv
    python -m abcnet_tpu_torch test-acc --data DIR [--ckpt NPZ_OR_DIR]
        [-b 16] [--dtype bfloat16] [--device cuda]
    python -m abcnet_tpu_torch bench [--batch 64] [--train-batch 64]
        [--dense] [--skip-train] [--ckpt NPZ_OR_DIR] [--device cuda]

The flags are those of abcnet_tpu's CLI (abcnet_tpu/__main__.py:263-320)
plus --device, and bench's --ckpt; --ckpt of img2smiles, test-acc and
bench names a weight snapshot (.npz, default snapshots/r5_latest.npz) or
a checkpoint directory that `train --ckpt` wrote (its latest step_*.pt).
`gen` writes DIR/dataset.csv and a PNG tree with the port's molecule
generator (the JAX package's bytes for the same seed); `train --data DIR`
reads such a directory, and without --data trains on --synthetic N
samples generated from --seed.
Under torchrun `train` runs as one rank of a data-parallel job (one
process per GPU, -b the global batch; every rank generates the same
samples and keeps its rows of every batch); `img2smiles --mesh N`
shards every batch over N GPUs from one process. `cal-acc` scores a
results CSV against its `smiles` or `InChI` truth column; `test-acc`
prints the per-class precision/recall tables of the reference's
test_accuracy.py. `bench` prints one JSON record of serving and
training throughput (bench.py in this package, the counterpart of the
repo-root bench.py) and exits 1 with an `error` record on any failure.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SNAPSHOT = os.path.join(REPO, "snapshots", "r5_latest.npz")


def img2smiles_loop(run, images: Sequence[np.ndarray], batch_size: int,
                    pool=None, log_every: int = 10,
                    assemble: Optional[Callable] = None) -> List:
    """Decode `images` (uint8 (512, 512) arrays) with an inference
    pipeline (infer.decode.make_infer_pipeline) in batches of
    `batch_size`; returns one SMILES (or None) per image, or, with
    `assemble`, what that function returns for each row of a batch's
    host peak dict (in place of infer.assemble.assemble_batch).

    Three-way overlap: batch i+1's device work is dispatched before batch
    i is assembled, batch i+1's peaks are fetched into pinned host memory
    on a worker thread, and the main thread assembles batch i meanwhile,
    so the steady state is max(device, fetch, assembly), not their sum.
    The trailing chunk is padded to the full batch with its last image
    and the padding dropped afterwards, so every row is scored."""
    from .infer.assemble import assemble_batch

    if assemble is None:
        def assemble(peaks):
            return assemble_batch(peaks, pool=pool)
    dispatch = getattr(run, "dispatch", run)
    fetch = getattr(run, "fetch", lambda h: h)
    preds: List = []
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
                preds.extend(assemble(pending[0].result())[:pending[1]])
            pending = (fut, k)
            if log_every and (i // batch_size) % log_every == 0:
                print(f"{min(i + batch_size, len(images))}/{len(images)}",
                      flush=True)
        if pending is not None:
            preds.extend(assemble(pending[0].result())[:pending[1]])
    finally:
        fetcher.shutdown(wait=True)
    return preds


def _cmd_gen(args) -> None:
    import csv

    from .data.generate import generate_dataset

    smiles_list = None
    if args.smiles_csv:
        # Given-corpus rendering (rdkit_img_generate.py:219-246 role); the
        # SMILES column is found case-insensitively.
        with open(args.smiles_csv, newline="") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
        cols = {c.lower(): c for c in reader.fieldnames or ()}
        col = cols.get("smiles")
        if col is None:
            sys.exit(f"error: no Smiles column in {args.smiles_csv}")
        smiles_list = [r[col] for r in rows]
    rows = generate_dataset(args.out, args.n, seed=args.seed,
                            mode=args.mode, smiles_list=smiles_list,
                            engine=args.engine)
    print(f"wrote {len(rows)} samples to {args.out}")


def _cmd_train(args) -> None:
    import random

    import torch

    from .data import pipeline
    from .data.generate import generate_samples
    from .parallel import init_distributed
    from .train.trainer import (TrainConfig, create_state, fit,
                                restore_checkpoint)
    from .utils.device import resolve_device

    resolve_device(args.device)
    if args.data:
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
    if args.data:
        samples = pipeline.load_csv_dataset(csv_path)
    else:
        # the JAX package's list for the same seed (mixed lineage)
        samples = generate_samples(args.synthetic, args.seed)
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
    from .models.weights import load_weights
    from .utils.device import resolve_device

    resolve_device(args.device)
    csv_path = args.data if args.data.endswith(".csv") \
        else os.path.join(args.data, "dataset.csv")
    if not os.path.exists(csv_path):
        sys.exit(f"error: dataset csv not found: {csv_path}")
    model, step = load_weights(args.ckpt, device=args.device,
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


def _cmd_test_acc(args) -> None:
    import random

    import torch

    from .data import pipeline
    from .eval.class_metrics import per_class_report
    from .models.weights import load_weights
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    csv_path = os.path.join(args.data, "dataset.csv")
    if not os.path.exists(csv_path):
        sys.exit(f"error: dataset csv not found: {csv_path}")
    model, step = load_weights(args.ckpt, device=dev,
                               dtype=getattr(torch, args.dtype))
    print(f"weights: {args.ckpt} (step {step})", flush=True)
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(s, rng, train=False)
                for s in pipeline.load_csv_dataset(csv_path)]
    print(per_class_report(per_class_totals(model, examples,
                                           args.batch_size)))


def per_class_totals(model, examples, batch_size: int):
    """Per-class (tp_p, n_p, tp_r, n_t) counts of `examples` summed over
    full batches of `batch_size` (the remainder is dropped, as the JAX
    package's test-acc drops it): eval unpack (kernel 1), eval forward,
    the dense targets with the full bond-type map, per_class_counts.
    Returns int64 CPU tensors by group."""
    import torch

    from .data import pipeline, vocab
    from .eval.class_metrics import per_class_counts
    from .ops.losses import _to_nhwc_targets
    from .ops.targets import build_targets
    from .train.trainer import to_device

    dev = next(model.parameters()).device
    model.eval()
    acc = None
    for hb in pipeline.batches_from_examples(examples, batch_size,
                                             shuffle=False):
        batch = to_device(hb, dev)
        images = pipeline.device_unpack_bits(batch["image_bits"],
                                             train=False, dtype=model.dtype)
        targets = build_targets(batch, with_full_type=True,
                                grid=images.shape[1] // vocab.STRIDE)
        with torch.no_grad():
            preds = model(images)
        counts = per_class_counts(preds, _to_nhwc_targets(targets))
        acc = counts if acc is None else {
            k: tuple(a + b for a, b in zip(acc[k], counts[k])) for k in acc}
    if acc is None:
        raise SystemExit(f"test-acc needs at least one full batch of "
                         f"{batch_size}; got {len(examples)} examples")
    return {k: tuple(x.cpu() for x in v) for k, v in acc.items()}


def _cmd_bench(args) -> None:
    from . import bench

    code = bench.main(args)
    if code:
        raise SystemExit(code)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="abcnet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate a synthetic dataset")
    g.add_argument("--out", required=True)
    g.add_argument("-n", type=int, default=1000,
                   help="sample count (with --smiles-csv: cap, 0 = all)")
    g.add_argument("--mode", default="mixed",
                   choices=["mixed", "rdkit", "indigo"])
    g.add_argument("--engine", default="a", choices=["a", "b", "mix"],
                   help="drawing program: a = PIL/TTF engine, b = "
                        "stroke-font scanline engine, mix = per-sample "
                        "coin flip (two-renderer corpus diversity)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--smiles-csv",
                   help="render this SMILES corpus (CSV with a Smiles "
                        "column) instead of random molecules — "
                        "rdkit_img_generate.py:219-246 role")
    g.set_defaults(fn=_cmd_gen)

    t = sub.add_parser("train", help="train the U-Net")
    t.add_argument("--data", help="dataset dir (dataset.csv inside; omit "
                                  "to generate)")
    t.add_argument("--synthetic", type=int, default=2000,
                   help="#examples to generate when --data is omitted")
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
                   help="weight snapshot (.npz) or checkpoint "
                        "directory (its latest step_*.pt)")
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

    c = sub.add_parser("cal-acc", help="score a results csv (truths from "
                                       "its smiles or InChI column)")
    c.add_argument("results")
    c.set_defaults(fn=_cmd_cal_acc)

    ta = sub.add_parser("test-acc",
                        help="per-class P/R tables (test_accuracy parity)")
    ta.add_argument("--data", required=True,
                    help="dataset dir (dataset.csv inside)")
    ta.add_argument("--ckpt", default=DEFAULT_SNAPSHOT,
                    help="weight snapshot (.npz) or checkpoint "
                         "directory (its latest step_*.pt)")
    ta.add_argument("-b", "--batch-size", type=int, default=16)
    ta.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ta.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ta.set_defaults(fn=_cmd_test_acc)

    b = sub.add_parser("bench", help="serving and training throughput on "
                                     "the GPU (one JSON record)")
    b.add_argument("--batch", type=int, default=64,
                   help="inference batch (the headline stays 64 for the "
                        "BASELINE.json comparison; larger for sweeps)")
    b.add_argument("--train-batch", type=int, default=64,
                   help="training batch; 64, not the JAX bench's 128: batch "
                        "128 runs out of an H100's 79.18 GiB in its first "
                        "step, at 77.05-77.29 GiB allocated (chip_smoke.py "
                        "phase bench_probe); batch 64 peaks at 44.25 GiB")
    b.add_argument("--dense", action="store_true",
                   help="A/B: dense head maps instead of the sparse "
                        "peak-cell head evaluation")
    b.add_argument("--skip-train", action="store_true")
    b.add_argument("--ckpt", default=DEFAULT_SNAPSHOT,
                   help="weight snapshot (.npz) or checkpoint directory "
                        "served; the record names it")
    b.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    b.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
