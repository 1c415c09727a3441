"""Make the committed part of the DLA-34 + DCN configuration's seeded
weights: its `weights_data` file (every BatchNorm's statistics, the heads'
final biases) and that file's sha256 (benchmark/dla_weights.py says how).

    python3 benchmark/tools/make_dla_weights.py
        [--config benchmark/configs/dla34_dcn_bf16.json] [--device cuda]
        [--check 0|1]

The calibration batch is the configuration's `calibration_rows` of the
frozen pool, the peak counts are matched over the whole pool, and the
production snapshot is `snapshots/r5_latest.npz`. Forwards of the plain
references over the pool in float32: run it on a card. It prints the
counts it matched, and the spread of the sampling offsets over the
calibration rows. With `--check 1` it compares what it computes with the
committed file (every array within 1e-5 relative) instead of writing it.
No run of the benchmark runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import cbam_weights, dla_weights, harness, pool  # noqa: E402
from benchmark.reference import decode as ref_decode  # noqa: E402
from benchmark.reference import dla_dcn as ref_dla  # noqa: E402

PRODUCTION = os.path.join(ROOT, "snapshots", "r5_latest.npz")


def offset_spread(cfg, images, device):
    """Quantiles in pixels of |dy| and |dx| over every deformable site of
    the built model on `images`, and the share of samples off the grid
    by more than a tenth of a pixel."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        w = ref_dla.load_snapshot(dla_weights.build_snapshot(cfg, tmp),
                                  device)
    got = ref_dla.offsets(w, ref_decode.binarize(images, device))
    v = torch.cat([o.abs().flatten() for o in got.values()])
    q = torch.quantile(v[torch.randperm(len(v), device=v.device)[:1 << 24]],
                       torch.tensor([0.5, 0.9, 0.99], device=v.device))
    return {"sites": len(got), "abs_offset_px_p50": float(q[0]),
            "abs_offset_px_p90": float(q[1]),
            "abs_offset_px_p99": float(q[2]),
            "off_grid_share": float((v > 0.1).double().mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        ROOT, "benchmark", "configs", "dla34_dcn_bf16.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = harness.load_json(args.config)
    images = pool.load()
    calib = images[cfg["calibration_rows"]]
    data, info = dla_weights.make(cfg, calib, images, PRODUCTION,
                                  args.device)
    print(json.dumps(info), flush=True)
    path, digest = cbam_weights.data_paths(cfg)
    if args.check:
        with np.load(path) as z:
            bad = [k for k in data if not np.allclose(
                z[k], data[k], rtol=1e-5, atol=1e-6)]
        print(f"{len(data) - len(bad)} of {len(data)} arrays agree"
              + (f"; differ: {bad[:5]}" if bad else ""))
        return 1 if bad else 0
    cbam_weights.write_npz(path, data)
    with open(digest, "w") as f:
        f.write(cbam_weights.sha256(path) + "\n")
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    print(json.dumps(offset_spread(cfg, calib, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
