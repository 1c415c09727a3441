"""eval/e2e_overfit.py against the JAX package's scripts/e2e_overfit.py, on
the CPU, through the function (a 512² JAX training step is minutes of CPU
jit, so the script is read, not run).

One run of `overfit` in f32 on 2 examples, batch 2, 3 epochs (3 steps,
metrics every step), the serving pipeline and the meter bank wrapped to
record what they are given:
  * the learning rate of each epoch: the config's until JAX's
    TrainConfig(epochs=3).lr_drop_epoch, a tenth of it from there on;
  * the decoded images are the examples' own uint8 canvases (no device
    noise), the first min(n, 128) in order, in whole batches;
  * every loss finite; the log line over the steps' metrics has the
    script's keys, each a finite number the metrics computed;
  * the exit code follows exact > 0, with the script's last lines.
Also: the decoded rows for several n against the script's range, the log
keys against the script's source, and the refusal without a GPU.
"""

import os
import re

import numpy as np
import pytest
import torch

from abcnet_tpu_torch.data import pipeline
from abcnet_tpu_torch.eval import e2e_overfit as eo
from abcnet_tpu_torch.eval.scoring import ScoreReport
from torch_parity import REPO

SCRIPT = os.path.join(REPO, "scripts", "e2e_overfit.py")
EPOCHS = 3


@pytest.fixture(scope="module")
def run():
    """(examples, result, images served, log lines, every step's metrics)."""
    examples = pipeline.generate_examples(2, seed=0)
    seen, lines, metrics = [], [], []
    make, bank = eo.make_infer_pipeline, eo.MeterBank

    def recording(model, device, **kw):
        serve = make(model, device, **kw)

        def wrapped(images):
            seen.append(np.array(images))
            return serve(images)
        return wrapped

    class RecordingBank(bank):
        def update(self, m):
            metrics.append(m)
            super().update(m)

    eo.make_infer_pipeline, eo.MeterBank = recording, RecordingBank
    try:
        res = eo.overfit(examples, EPOCHS, 0.05, batch=2, device="cpu",
                         dtype="float32", log=lines.append)
    finally:
        eo.make_infer_pipeline, eo.MeterBank = make, bank
    return examples, res, seen, lines, metrics


def test_learning_rate_drops_at_the_jax_epoch(run):
    from abcnet_tpu.train.trainer import TrainConfig as JaxTrainConfig

    jcfg = JaxTrainConfig(batch_size=2, epochs=EPOCHS, amount=0.05,
                          log_every=50, eval_every=10 ** 9)
    assert 0 < jcfg.lr_drop_epoch < EPOCHS
    _, res, _, _, _ = run
    assert res.epoch_lrs == [jcfg.lr if e < jcfg.lr_drop_epoch
                             else jcfg.lr * 0.1 for e in range(EPOCHS)]


def test_decodes_the_unaugmented_first_examples(run):
    examples, res, seen, _, _ = run
    assert len(seen) == 1
    np.testing.assert_array_equal(
        seen[0], np.stack([e.image_u8 for e in examples[:2]]))
    assert res.truths == [e.smiles for e in examples[:2]]
    assert len(res.preds) == 2 and res.report.n == 2


def test_losses_and_log_lines(run):
    _, res, _, lines, metrics = run
    assert res.steps == EPOCHS and len(res.losses) == EPOCHS
    assert all(np.isfinite(res.losses))
    # every step's metrics (train_step with_metrics=True) carry the log
    # line's keys; the line over them has a finite number for each
    assert len(metrics) == EPOCHS
    bank = eo.MeterBank()
    for m in metrics:
        bank.update(m)
    line = eo.log_line(EPOCHS - 1, EPOCHS, res.losses[-1], bank.averages())
    m = re.fullmatch(r"epoch (\d+) step (\d+) loss (\S+) (.*)", line)
    assert m and float(m[3]) == pytest.approx(res.losses[-1], abs=1e-4)
    fields = dict(t.split("=") for t in m[4].split())
    assert list(fields) == [n for n, _ in eo.LOG_KEYS]
    assert all(np.isfinite(float(v)) for v in fields.values())
    # 3 steps: no log line (one every 50), then the script's two lines
    assert len(lines) == 2
    assert re.fullmatch(rf"trained {EPOCHS} steps in \S+s \(\S+ img/s\)",
                        lines[0])
    assert lines[1] == f"E2E: {res.report}"


def test_log_keys_are_the_scripts():
    src = open(SCRIPT).read()
    want = re.findall(r"(\w+)=\{avg\['(\w+)'\]", src)
    assert tuple(want) == eo.LOG_KEYS
    assert "log_every=50" in src and "batch = 16" in src
    assert eo.BATCH == 16


def test_exit_code_follows_exact(run):
    _, res, _, _, _ = run
    code, line = eo.verdict(res.report)
    assert code == (0 if res.report.exact_match > 0 else 1)
    hit = ScoreReport(n=2, n_decoded=2, exact_match=0.5,
                      exact_match_canonical=0.5, tanimoto_like=0.6,
                      decode_rate=1.0)
    miss = ScoreReport(n=2, n_decoded=1, exact_match=0.0,
                       exact_match_canonical=0.5, tanimoto_like=0.6,
                       decode_rate=0.5)
    assert eo.verdict(hit) == (0, "E2E SLICE OK")
    assert eo.verdict(miss) == (1, "E2E SLICE: no exact matches yet "
                                   "(decode_rate=0.50); train longer")


@pytest.mark.parametrize("n", [1, 2, 17, 64, 127, 128, 384])
def test_decode_rows_are_the_scripts(n):
    batch = 16
    # scripts/e2e_overfit.py:76
    want = range(0, min(n, 128) - batch + 1, batch)
    assert eo.decode_rows(n) == want


def test_main_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eo.main(["2", "1"])
