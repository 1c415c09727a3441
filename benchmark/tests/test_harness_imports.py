"""The import guard: the reference and the comparison load nothing of
the program, and nothing the harness loads is JAX or the JAX package.
Top-level module names are compared whole: abcnet_tpu_torch, the port,
begins with abcnet_tpu, the JAX package, and is not it."""

import json
import os
import subprocess
import sys

from .cpu_run import BENCH

ROOT = os.path.dirname(BENCH)
JAX = {"jax", "jaxlib", "flax", "abcnet_tpu"}


def loaded_top_level(code: str):
    """Top-level names of every module a fresh interpreter holds after
    running `code` from the checkout root."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    names = loaded_top_level(
        "import benchmark.check, benchmark.counts, benchmark.harness\n"
        "import benchmark.reference.unet, benchmark.reference.decode\n"
        "from benchmark.check import frozen_assembler\n"
        "frozen_assembler()\n")
    assert not names & (JAX | {"abcnet_tpu_torch"}), names


def test_a_whole_cpu_run_loads_no_jax():
    names = loaded_top_level(
        "import sys\nsys.path.insert(0, 'benchmark')\n"
        "import torch\ntorch.set_num_threads(4)\n"
        "from benchmark.tests.cpu_run import cpu_context, cpu_run\n"
        "from benchmark import harness\n"
        "line, checks = cpu_run(cpu_context('unet_bf16.convert_b64', "
        "dtype='float32'))\n"
        "assert line['correct'], (line, checks)\n"
        "assert not harness.forbidden_modules()\n")
    assert "abcnet_tpu_torch" in names
    assert not names & JAX, names & JAX


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark import harness

    for m in list(sys.modules):
        if m.split(".")[0] in JAX:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "abcnet_tpu_torch", sys)
    monkeypatch.setitem(sys.modules, "abcnet_tpu_torch.infer", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "abcnet_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["abcnet_tpu", "jaxlib"]
