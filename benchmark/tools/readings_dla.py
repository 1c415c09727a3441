"""The readings that the limits of the `convert_dla` cell are set from.

    python3 benchmark/tools/readings_dla.py
        [--workload dla34_dcn_bf16.convert_b64_dla] --seeds 1,2,3
        [--modes sound,no_offset,no_mask,fp8] [--out FILE]

For each mode and seed, the batches a run of the cell would compare (the
cell's batch size and `sample_batches`, drawn from the seed as
benchmark/readings.py draws them) go through the cell's timed path and
are compared with the plain reference: "sound" is the program's
conversion loop as `run.py` builds it; "no_offset", "no_mask" and "fp8"
put the reference's controls in its place (kinds/convert_dla.py:
ControlProgram). One JSON line a mode and seed, then one line a mode
with the largest and the smallest reading of each number. The
benchmark's own runs do not run this. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark"))

from benchmark import dla_weights, harness, pool  # noqa: E402
from benchmark.kinds import convert, convert_dla  # noqa: E402

CELL = "dla34_dcn_bf16.convert_b64_dla"


def readings(ctx, images, seed: int, mode: str):
    import torch

    cfg, mix = ctx.cfg, ctx.mix
    bsz, n = mix["batch"], mix["sample_batches"]
    _, _, r_sample, _ = harness.seed_rngs(seed, 4)
    if mode == "sound":
        program = convert.Program(cfg, mix, None, ctx.device)
    else:
        program = convert_dla.ControlProgram(cfg, mode, ctx.device)
    order = r_sample.permutation(len(images))[:n * bsz]
    window = [images[i] for i in order]
    loop = convert.Loop(program, keep=range(n))
    preds, _ = loop(window, bsz)
    program.close()
    del program, loop.program
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    batches = [{"images": np.stack(window[i * bsz:(i + 1) * bsz]),
                **loop.kept[i]} for i in range(n)]
    nums = convert_dla.compare(cfg, None, batches, ctx.device)
    nums["smiles_none_share"] = sum(s is None for s in preds) / len(preds)
    return nums


def summarise(workload: str, mode: str, rows):
    keys = [k for k in rows[0] if k not in ("workload", "mode", "seed")]
    return {"workload": workload, "mode": mode, "seeds": len(rows),
            "max": {k: max(r[k] for r in rows) for k in keys},
            "min": {k: min(r[k] for r in rows) for k in keys}}


def main(argv=None) -> int:
    import torch

    import run as entry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="sound,no_offset,no_mask,fp8")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ctx = entry.context(entry.parse(["--workload", args.workload, "--seed",
                                     "0", "--seconds", "1"]))
    harness.require_cards(ctx.cell["chips"])
    convert_dla.require_model()
    images = pool.load()
    tmp = tempfile.mkdtemp(prefix="seeded_weights_")
    lines = []
    try:
        ctx.cfg = dict(ctx.cfg, weights=dla_weights.build_snapshot(
            ctx.cfg, tmp))
        for mode in args.modes.split(","):
            rows = []
            for seed in (int(s) for s in args.seeds.split(",")):
                row = {"workload": args.workload, "mode": mode,
                       "seed": seed, **readings(ctx, images, seed, mode)}
                rows.append(row)
                print(json.dumps(row), flush=True)
            summary = dict(summarise(args.workload, mode, rows),
                           device=torch.cuda.get_device_name(0))
            print(json.dumps(summary), flush=True)
            lines += rows + [summary]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in lines:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
