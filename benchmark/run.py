"""The benchmark of abcnet_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs the cell of BENCHMARK.json named <cell> on this machine's CUDA
devices and prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device`, with
--trace 1 `breakdown`, and last `checks`, each number of the comparison
with the reference beside its limit (also the last lines of standard
error). Exits non-zero, with no result line, where no CUDA device or
too few are found, or where the process holds jax, jaxlib, flax or the
JAX package abcnet_tpu once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


class Context:
    """One run's arguments, configuration, mix and hooks. `make_program`
    builds the system under test, `compare` judges its outputs; a test or
    a control puts its own in their place."""

    def __init__(self, args, cell, cfg, mix, device="cuda"):
        self.args, self.cell, self.cfg, self.mix = args, cell, cfg, mix
        self.device = device
        self.t_start = T_START
        self.kind = harness.kind(mix["kind"])

    def make_program(self, cfg, mix, calib):
        return self.kind.Program(cfg, mix, calib, self.device)

    def compare(self, cfg, calib, batches):
        return self.kind.compare(cfg, calib, batches, self.device)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def context(args, device="cuda") -> Context:
    man = harness.manifest()
    cell = harness.cell(man, args.workload)
    return Context(args, cell, harness.config(man, cell["config"]),
                   harness.traffic(cell["traffic"]), device)


def result(ctx: Context, out) -> tuple:
    """(result line without checks, checks) of a run's outputs."""
    from benchmark import check

    man = harness.manifest()
    name = ctx.args.workload
    checks = check.judge(out["numbers"], harness.limits(name))
    correct = (check.passed(checks) and not out["incomplete"]
               and not out["sample_missing"])
    device = dict(out["device"])
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"]}
    if ctx.args.trace:
        obs = out["obs"]
        metrics = {}
        for m in harness.metrics_of(man, "per_layer", name):
            v = harness.metric_reader(m["name"]).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = obs.trace
        device["busy_s"] = tr.busy_us / 1e6
        device["window_s"] = tr.window_us / 1e6
        line["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in tr.top_ops(10)],
            "idle_gaps": [[label, us / 1e6]
                          for us, label in tr.idle_gaps(10)]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in harness.metrics_of(man, "end_to_end", name)}
    line["metrics"] = metrics
    line["device"] = device
    return line, checks


def main(argv=None) -> int:
    args = parse(argv)
    ctx = context(args)
    harness.require_cards(ctx.cell["chips"])
    out = ctx.kind.run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: this process holds {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line, checks = result(ctx, out)
    for k, v in out["numbers"].items():
        if k not in checks:
            print(f"reading {k} {v!r}", file=sys.stderr)
    harness.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
