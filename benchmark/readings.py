"""The readings that the limits of a conversion cell are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3
        [--control 0|1] [--out FILE]

For each seed, the batches a run of the cell would compare (the cell's
batch size and `sample_batches`, the drawings and the calibration drawn
from the seed) go through the cell's timed path, the conversion loop of
the program as `run.py` builds it, and the comparison with the plain
reference prints its numbers. With `--control 1` the lower-precision
control stands in the program's place: for a bf16 configuration the
program's own int8 backbone (infer/quant.py), for the int8 backbone the
reference's quantization at 4 bits. One JSON line a seed, then one line
with the largest reading of each number over the seeds and the smallest.
The benchmark's own runs do not run this. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import check, harness, pool  # noqa: E402
from benchmark.kinds import convert  # noqa: E402


class ReferenceProgram:
    """The reference at `bits` bits in the program's place: a pipeline
    whose dispatch runs the reference's quantized forward and decode and
    whose fetch hands back its peak dict; assembly by the frozen copy."""

    def __init__(self, cfg, calib, device, bits):
        self.w, self.q = convert.reference_weights(cfg, calib, device, bits)
        self._assemble = check.frozen_assembler()
        self.run = self

    def dispatch(self, images_u8):
        return [R for _, R, _ in check.reference_peaks(self.w, images_u8,
                                                       self.q)]

    @staticmethod
    def fetch(parts):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def assemble(self, peaks):
        return [self._assemble(peaks, i)
                for i in range(peaks["atom_valid"].shape[0])]

    def close(self):
        self.run = self.w = self.q = None


def readings(ctx, seed: int, control: bool):
    import gc

    import torch

    cfg, mix = ctx.cfg, ctx.mix
    bsz, n = mix["batch"], mix["sample_batches"]
    _, r_calib, r_sample, _ = harness.seed_rngs(seed, 4)
    images = pool.load()
    calib_idx = r_calib.choice(len(images), cfg.get("int8", {}).get(
        "calibration_images", 32), replace=False)
    calib = convert.calibration_masks(images[calib_idx], ctx.device)
    if not control:
        program = convert.Program(cfg, mix, calib, ctx.device)
    elif cfg["backbone"] == "int8":
        program = ReferenceProgram(cfg, calib, ctx.device,
                                   cfg["int8"]["bits"] // 2)
    else:
        program = convert.Program(cfg, mix, calib, ctx.device,
                                  backbone="int8")
    order = r_sample.permutation(len(images))[:n * bsz]
    window = [images[i] for i in order]
    loop = convert.Loop(program, keep=range(n))
    loop(window, bsz)
    program.close()
    del program, loop.program
    gc.collect()
    torch.cuda.empty_cache()
    batches = [{"images": np.stack(window[i * bsz:(i + 1) * bsz]),
                **loop.kept[i]} for i in range(n)]
    return convert.compare(cfg, calib, batches, ctx.device)


def main(argv=None) -> int:
    import torch

    import run as entry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ctx = entry.context(entry.parse(["--workload", args.workload, "--seed",
                                     "0", "--seconds", "1"]))
    harness.require_cards(ctx.cell["chips"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = readings(ctx, seed, bool(args.control))
        row = {"workload": args.workload, "control": args.control,
               "seed": seed, **nums}
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = [k for k in rows[0] if k not in ("workload", "control", "seed")]
    summary = {"workload": args.workload, "control": args.control,
               "seeds": len(rows),
               "max": {k: max(r[k] for r in rows) for k in keys},
               "min": {k: min(r[k] for r in rows) for k in keys},
               "device": torch.cuda.get_device_name(0)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
