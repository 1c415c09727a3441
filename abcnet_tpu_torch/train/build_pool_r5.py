"""The production recipe's training pool: eval split frozen, train split
rebalanced.

    python -m abcnet_tpu_torch.train.build_pool_r5 [out_npz] [train_n]
        [--device cuda]

Counterpart of the JAX package's scripts/build_pool_r5.py. One pool file
(data/pool.py, byte-compatible with the JAX package's, so the default
data_cache/pool_r5.npz can be shared):
  [0:EVAL_N]   the eval split, `generate_sample(rng)` on the seed-0
               stream (mixed lineage, engine A), as in every earlier
               round;
  [EVAL_N:]    `train_n` rows continuing the same stream, each drawn
               with lineage indigo at p INDIGO_P (else rdkit) and engine
               B at p ENGINE_B_P (else A), both decisions from a separate
               random.Random(777), so the eval prefix is unchanged.
Host work only: no kernel runs. `--device` is resolved all the same, as
every entry point of the port does (it raises without a GPU unless
`cpu` is given).
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import List

from ..data.generate import Sample, generate_sample
from ..data.pool import save_pool
from ..utils.device import resolve_device
from .recipe import DATA_CACHE

EVAL_N = 256
INDIGO_P = 0.6
ENGINE_B_P = 0.15
DEFAULT_OUT = os.path.join(DATA_CACHE, "pool_r5.npz")


@dataclass
class PoolR5:
    samples: List[Sample]
    modes: List[str] = field(default_factory=list)    # lineage a row
    engines: List[str] = field(default_factory=list)  # engine a row
    seconds: float = 0.0

    @property
    def samples_per_s(self) -> float:
        return len(self.samples) / self.seconds if self.seconds else 0.0


def build_pool_r5(out: str = DEFAULT_OUT, train_n: int = 90000,
                  log=print) -> PoolR5:
    """Generate the pool, write it to `out` and return its rows with the
    lineage and engine each was drawn with ("mixed"/"a" on the EVAL_N
    rows of the eval split)."""
    rng = random.Random(0)        # the sample stream (rounds 2-4 parity)
    bias = random.Random(777)     # the rebalance decisions only
    t0 = time.time()
    res = PoolR5([])
    while len(res.samples) < EVAL_N + train_n:
        if len(res.samples) < EVAL_N:
            mode, engine = "mixed", "a"
            s = generate_sample(rng)
        else:
            mode = "indigo" if bias.random() < INDIGO_P else "rdkit"
            engine = "b" if bias.random() < ENGINE_B_P else "a"
            s = generate_sample(rng, mode=mode, engine=engine)
        if s is not None:
            res.samples.append(s)
            res.modes.append(mode)
            res.engines.append(engine)
            if len(res.samples) % 10000 == 0:
                log(f"gen {len(res.samples)}/{EVAL_N + train_n} "
                    f"({time.time() - t0:.0f}s)")
    res.seconds = time.time() - t0
    save_pool(out, res.samples)
    log(f"pool cached: {len(res.samples)} samples -> {out} "
        f"({time.time() - t0:.0f}s)")
    return res


def main(argv=None) -> PoolR5:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.train."
                                     "build_pool_r5")
    p.add_argument("out", nargs="?", default=DEFAULT_OUT)
    p.add_argument("train_n", nargs="?", type=int, default=90000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    resolve_device(args.device)
    return build_pool_r5(args.out, args.train_n,
                         log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main(sys.argv[1:])
