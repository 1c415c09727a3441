"""Make the committed part of a CBAM configuration's seeded weights: its
`weights_data` file (every BatchNorm's statistics, the heads' final
biases) and that file's sha256 (benchmark/cbam_weights.py says how).

    python3 benchmark/tools/make_cbam_weights.py
        [--config benchmark/configs/unet_cbam_bf16.json] [--device cuda]
        [--check 0|1]

The calibration batch is the configuration's `calibration_rows` of the
frozen pool, the peak counts are matched over the whole pool, and the
production snapshot is `snapshots/r5_latest.npz`. Forwards of the plain
references over the pool in float32: run it on a card. It prints the
counts it matched. With `--check 1` it compares what it computes with
the committed file (every array within 1e-5 relative) instead of writing
it. No run of the benchmark runs this.
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

from benchmark import cbam_weights, harness, pool  # noqa: E402

PRODUCTION = os.path.join(ROOT, "snapshots", "r5_latest.npz")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        ROOT, "benchmark", "configs", "unet_cbam_bf16.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = harness.load_json(args.config)
    images = pool.load()
    data, info = cbam_weights.make(cfg, images[cfg["calibration_rows"]],
                                   images, PRODUCTION, args.device)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
