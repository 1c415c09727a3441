"""Command-line surface of the port: img2smiles and cal-acc.

    python -m abcnet_tpu_torch img2smiles --data DIR_OR_CSV [--ckpt NPZ]
        [--out results.csv] [-b 64] [--processes 0] [--threshold 0.6]
        [--dtype bfloat16] [--device cuda]
    python -m abcnet_tpu_torch cal-acc results.csv

The flags are those of abcnet_tpu's CLI (abcnet_tpu/__main__.py:289-308)
plus --device; --ckpt names a weight snapshot (.npz, default
snapshots/r5_latest.npz). Multi-device serving (--mesh) is not ported
yet.
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
    run = make_infer_pipeline(model, args.device, threshold=args.threshold)
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
