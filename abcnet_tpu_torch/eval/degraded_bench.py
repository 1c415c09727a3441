"""Scanned-benchmark stand-in: decode accuracy under image degradation.

    python -m abcnet_tpu_torch.eval.degraded_bench [n]
        [--ckpt NPZ_OR_DIR] [--device cuda]

Counterpart of the JAX package's scripts/degraded_bench.py. The
reference's real-world benchmark is the UOB scanned set read with a 0.2
binarize threshold; no scanned corpus ships here, so held-out synthetic
drawings are degraded the way scans degrade documents (resolution loss,
optical blur, JPEG artifacts, stroke erosion, a gray low-contrast
background; data/degrade.py) and the whole serving path's accuracy is
reported per degradation beside the clean number.

The held-out stream is `generate_samples(n, 0)`, the first n accepted
`generate_sample` of random.Random(0) (the training evaluations'
stream), n rounded down to a multiple of BATCH. Weights, served in
bf16: the committed snapshot, or the snapshot .npz or `train --ckpt`
directory that --ckpt names (the JAX script's second positional, an
orbax weights directory). One `make_infer_pipeline` per distinct
binarize threshold (the threshold acts only in the host's bit packing),
batches of BATCH assembled with `assemble_batch` and scored with
`score_pairs`. Prints the JAX script's table: exact, exact_noniso, dice,
decode, and the seconds per variant.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import __main__ as cli
from ..data.degrade import blur, downscale, erode_strokes, gray_scan, jpeg
from ..data.generate import Sample, generate_samples
from ..eval.scoring import ScoreReport, score_pairs
from ..infer.assemble import assemble_batch
from ..infer.decode import make_infer_pipeline
from ..models.weights import load_weights
from ..utils.device import resolve_device

BATCH = 16

# name, transform, binarize threshold (scripts/degraded_bench.py:38-49)
VARIANTS: List[Tuple[str, Callable[[np.ndarray], np.ndarray], float]] = [
    ("clean", lambda im: im, 0.6),
    ("downscale_384", lambda im: downscale(im, 384), 0.6),
    ("downscale_256", lambda im: downscale(im, 256), 0.6),
    ("blur_r1", lambda im: blur(im, 1.0), 0.6),
    ("blur_r2", lambda im: blur(im, 2.0), 0.6),
    ("jpeg_q30", lambda im: jpeg(im, 30), 0.6),
    ("jpeg_q10", lambda im: jpeg(im, 10), 0.6),
    ("erode", erode_strokes, 0.6),
    ("gray_scan_thr0.2", gray_scan, 0.2),
    ("gray_scan_thr0.6_control", gray_scan, 0.6),
]


@dataclass
class VariantResult:
    name: str
    threshold: float
    report: ScoreReport
    seconds: float
    preds: List[Optional[str]]
    first_peaks: Dict[str, np.ndarray]   # the host peak dict of batch 0


def header() -> str:
    return (f"{'variant':<26} {'exact':>7} {'exact_noniso':>12} "
            f"{'dice':>7} {'decode':>7}")


def row(name: str, r: ScoreReport, seconds: float) -> str:
    return (f"{name:<26} {r.exact_match:>7.4f} "
            f"{r.exact_match_canonical:>12.4f} "
            f"{r.tanimoto_like:>7.4f} {r.decode_rate:>7.4f}"
            f"   ({seconds:.0f}s)")


def sweep(model, samples: Sequence[Sample], variants=VARIANTS,
          batch: int = BATCH, verbose: bool = True) -> List[VariantResult]:
    """Every variant's scores over `samples` (a whole number of batches),
    served by `model` (a UNet on its device, in its compute dtype); each
    row printed as it ends when `verbose`."""
    if len(samples) % batch:
        raise ValueError(f"{len(samples)} samples are not a whole number "
                         f"of batches of {batch}")
    dev = next(model.parameters()).device
    truths = [s.smiles for s in samples]
    pipelines = {thr: make_infer_pipeline(model, dev, threshold=thr)
                 for thr in sorted({t for _, _, t in variants})}
    if verbose:
        print(header(), flush=True)
    out = []
    for name, fn, thr in variants:
        run = pipelines[thr]
        preds: List[Optional[str]] = []
        first = None
        t0 = time.time()
        for i in range(0, len(samples), batch):
            imgs = np.stack([fn(s.image) for s in samples[i:i + batch]])
            peaks = run(imgs)
            if first is None:
                first = peaks
            preds.extend(assemble_batch(peaks))
        r = score_pairs(truths, preds)
        res = VariantResult(name, thr, r, time.time() - t0, preds, first)
        if verbose:
            print(row(name, r, res.seconds), flush=True)
        out.append(res)
    return out


def main(argv=None) -> List[VariantResult]:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.eval."
                                     "degraded_bench")
    p.add_argument("n", nargs="?", type=int, default=128)
    p.add_argument("--ckpt", default=cli.DEFAULT_SNAPSHOT,
                   help="weight snapshot (.npz) or checkpoint directory "
                        "(its latest step_*.pt)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    model, step = load_weights(args.ckpt, device=resolve_device(args.device))
    n = (args.n // BATCH) * BATCH
    samples = generate_samples(n, 0)
    print(f"ckpt step {step}; {n} held-out molecules", flush=True)
    return sweep(model, samples)


if __name__ == "__main__":
    main()
