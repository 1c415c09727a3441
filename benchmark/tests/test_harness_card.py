"""Whole runs of each cell on the card, short: the last line's keys and
`correct`. They skip without a CUDA device (decided inside a fixture)."""

import json
import os
import subprocess
import sys

import pytest

from .cpu_run import BENCH
from benchmark import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark never falls back "
                    "to the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 17), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(BENCH))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
