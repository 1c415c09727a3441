"""The harness's arithmetic on synthetic timestamps: the p95 over every
batch, the rate over the whole window, the union of device spans, idle
gaps and their labels, and the result line's keys."""

import json
import time

import pytest

from .cpu_run import entry
from benchmark import harness
from benchmark.kinds import convert


def test_percentile_nearest_rank():
    v = list(range(1, 201))                       # 200 batches
    assert harness.percentile(v, 95) == 190        # 10 lie beyond it
    assert harness.percentile([5.0], 95) == 5.0
    assert harness.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        harness.percentile([], 95)


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert harness.union_length(spans) == 3 + 1 + 1
    assert harness.gaps(spans, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert harness.gaps([], 0, 1) == [(0, 1)]


def test_trace_reduction():
    tr = harness.Trace(
        device=[("conv3x3_s8_kernel<1>", 0, 10), ("eval_kernel", 10, 12),
                ("conv3x3_s8_kernel<2>", 30, 41)],
        spans=[("dispatch", 11, 25), ("assemble", 25, 35),
               ("fetch", 40, 50)],
        start=0, end=50)
    assert tr.busy_us == 23 and tr.window_us == 50
    assert tr.kernel_us(("conv3x3_s8_kernel",)) == 21
    assert tr.top_ops(1) == [("conv3x3_s8_kernel<2>", 11)]
    assert tr.idle_gaps() == [(18, "dispatch"), (9, "fetch")]


class FakeRun:
    """A pipeline whose dispatch takes `d` s and whose batches are ready
    at once; assembly takes `a` s a batch."""

    def __init__(self, d, a):
        self.d, self.a = d, a
        self.run = self

    def dispatch(self, x):
        time.sleep(self.d)
        return x

    def fetch(self, h):
        return {"n": len(h)}

    def assemble(self, peaks):
        time.sleep(self.a)
        return ["C"] * peaks["n"]


def test_loop_rate_and_latency():
    loop = convert.Loop(FakeRun(0.01, 0.02), keep=[1])
    preds, wall = loop([None] * 40, 4)              # 10 batches
    assert preds == ["C"] * 40 and loop.kept[1]["smiles"] == ["C"] * 4
    obs = harness.Observation(cfg={}, traffic={}, spans=loop.spans)
    lat = [a[1] - d[0] for d, a in zip(loop.spans["dispatch"],
                                        loop.spans["assemble"])]
    assert len(lat) == 10
    assert harness.metric_reader("smiles_batch_p95_ms").read(obs) == \
        harness.percentile(lat, 95) * 1e3
    # a batch waits for its own dispatch, the next dispatch and its
    # assembly: at least 0.01 + 0.01 + 0.02 (the last lacks the next)
    assert min(lat[:-1]) >= 0.04 and max(lat) < 0.2
    assert wall >= 10 * 0.03
    assert 40 / wall <= 40 / 0.3


def test_result_line_keys():
    args = entry.parse(["--workload", "unet_bf16.convert_b64", "--seed",
                        "1", "--seconds", "1", "--trace", "0"])
    ctx = entry.context(args, device="cpu")
    out = {"attempted": 64, "failed": 1, "incomplete": False,
           "sample_missing": False,
           "e2e": {"smiles_img_per_s": 700.0, "setup_s": 12.0},
           "device": {"platform": "gpu", "kind": "x", "count": 1,
                      "memory_peak_bytes": 1},
           "numbers": {k: 0.0 for k in harness.limits(
               "unet_bf16.convert_b64")}}
    line, checks = entry.result(ctx, out)
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["correct"] is True
    assert set(line["metrics"]) == {"smiles_img_per_s", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 12.0, "unit": "s"}
    out["numbers"]["smiles_mismatch"] = 1.0
    line, checks = entry.result(ctx, out)
    assert line["correct"] is False


def test_emit_puts_checks_last(capsys):
    harness.emit({"correct": True, "metrics": {}}, {"x": {"value": 1,
                                                          "limit": 2}})
    cap = capsys.readouterr()
    line = cap.out.strip().splitlines()[-1]
    assert list(json.loads(line))[-1] == "checks"
    assert cap.err.strip().splitlines()[-1] == "check x 1 limit 2"


def test_host_load_record():
    torch = pytest.importorskip("torch")
    before = torch.get_num_threads()
    try:
        harness.limit_host_threads()
        assert torch.get_num_threads() == harness.HOST_THREADS
        load = harness.HostLoad()
        sum(range(200000))
        rec = load.close()
    finally:
        torch.set_num_threads(before)
    assert rec["host_threads"] == harness.HOST_THREADS
    assert 1 <= rec["affinity_cpus"] <= rec["host_cpus"]
    assert rec["load_avg_1m"] >= 0 and rec["contended_procs"] >= 0
    for key in ("host_busy_pct", "host_steal_pct"):
        assert 0 <= rec.get(key, 0) <= 100
