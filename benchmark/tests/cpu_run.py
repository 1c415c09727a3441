"""Drive a conversion cell's run on the CPU at a size a test can hold:
the harness's look for a card skipped, the mix cut to batches of two
drawings and one compared batch, the rest of a run as run.py does it
(set-up, warm-up, window, the comparison with the reference, the result
line)."""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH))
sys.path.insert(0, BENCH)

import run as entry  # noqa: E402


def cpu_context(workload: str, seed: int = 4000000001, trace: int = 0,
                dtype: str = None, processes: int = 0):
    args = entry.parse(["--workload", workload, "--seed", str(seed),
                        "--seconds", "0.2", "--trace", str(trace)])
    ctx = entry.context(args, device="cpu")
    ctx.mix = dict(ctx.mix, batch=2, warm_batches=1, sample_batches=1,
                   trace_seconds=0.2, processes=processes)
    if dtype:
        ctx.cfg = dict(ctx.cfg, dtype=dtype)
    return ctx


def cpu_run(ctx):
    """(result line, checks) of one run of `ctx` on the CPU."""
    out = ctx.kind.run(ctx)
    return entry.result(ctx, out)
