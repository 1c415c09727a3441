"""abcnet_tpu_torch.train.metrics against abcnet_tpu.train.metrics on the CPU.

Both packages get the same numpy logits and compact labels, in f32, at
grid 32. Every metric is a (numerator, denominator) pair. Peak counts,
hits and masses are sums of the constants 0, 0.5, 0.8 and 1 and must be
equal up to the order of an f32 sum (relative 1e-6); the one pair that
sums real values, the rho error, gets relative 1e-5. Random logits tie
nowhere; the "perfect" logits tie on plateaus, where both packages keep
every cell that equals its window's maximum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.data.pipeline import synthetic_batch
from abcnet_tpu.ops import losses as jax_losses
from abcnet_tpu.ops import targets as jax_targets
from abcnet_tpu.train import metrics as jax_metrics
from abcnet_tpu_torch.models.unet import HEAD_NAMES, PRODUCTION_HEADS
from abcnet_tpu_torch.ops import losses, targets
from abcnet_tpu_torch.train import metrics

GRID = 32
LABEL_KEYS = ("atoms", "n_atoms", "bonds_i", "bonds_f", "n_bonds")
BIG = 12.0      # a logit that saturates the sigmoid / softmax


def _labels(seed):
    rng = np.random.default_rng(seed)
    batch = {k: v for k, v in synthetic_batch(2, seed, GRID * 4).items()
             if k in LABEL_KEYS}
    batch["atoms"][:, :24, 3] = rng.integers(0, 3, (2, 24))
    batch["atoms"][0, :24, 4] = rng.integers(-1, 2, 24)
    batch["bonds_i"][:, :48, 2] = rng.integers(0, 6, (2, 48))
    return batch


def _random_preds(seed):
    rng = np.random.default_rng(seed + 100)
    return {n: (rng.normal(size=(2, GRID, GRID, w)) * 2).astype(np.float32)
            for n, w in zip(HEAD_NAMES, PRODUCTION_HEADS)}


def _perfect_preds(batch):
    """Logits that reproduce the dense targets: large where the target
    is 1, small elsewhere, rho equal to its target."""
    t = jax_losses._to_nhwc_targets(jax_targets.build_targets(
        {k: jnp.asarray(v) for k, v in batch.items()}, with_full_type=True,
        grid=GRID))
    t = {k: np.asarray(v) for k, v in t.items()}
    preds = {}
    for n in HEAD_NAMES:
        if n == "bond_rho":
            preds[n] = t[n].copy()
        else:
            # halo cells (0.5 / 0.8) get a middling logit, below the
            # peak and (sigmoid 0.12) below the 0.25 detection threshold
            preds[n] = np.where(t[n] == 1.0, BIG,
                                np.where(t[n] > 0, -2.0, -BIG)
                                ).astype(np.float32).reshape(2, GRID, GRID, -1)
    return preds


def _both(preds, batch, full):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_metrics.compute_metrics(
        {k: jnp.asarray(v) for k, v in preds.items()},
        jax_losses._to_nhwc_targets(jax_targets.build_targets(
            jb, with_full_type=full, grid=GRID)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = metrics.compute_metrics(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        losses._to_nhwc_targets(targets.build_targets(
            tb, with_full_type=full, grid=GRID)))
    return want, got


@pytest.mark.parametrize("full", [True, False], ids=["dense", "train"])
@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 1),
                                       ("perfect", 2)])
def test_metric_pairs_match_jax(kind, seed, full):
    batch = _labels(seed)
    preds = _random_preds(seed) if kind == "random" else _perfect_preds(batch)
    want, got = _both(preds, batch, full)
    assert sorted(got) == sorted(want)
    assert ("bond_types_acc" in got) == full
    for k, (num, den) in want.items():
        rtol = 1e-5 if k == "bond_rhos_mae" else 1e-6
        np.testing.assert_allclose(float(got[k][0]), float(num), rtol=rtol,
                                   atol=1e-6, err_msg=f"{k} numerator")
        np.testing.assert_allclose(float(got[k][1]), float(den), rtol=rtol,
                                   atol=1e-6, err_msg=f"{k} denominator")
    if kind == "perfect":
        avg = metrics.MeterBank()
        avg.update(got)
        for k, v in avg.averages().items():
            if k.endswith(("precision", "recall", "precision3", "recall3",
                           "_acc")):
                assert v == pytest.approx(1.0, abs=1e-6), k
            if k == "bond_rhos_mae":
                assert v == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("fn", ["nms_mask", "circular_nms_mask",
                                "circular_dilate"])
def test_mask_helpers_match_jax(fn):
    rng = np.random.default_rng(3)
    # quantized values, so plateaus and ties do occur
    p = (rng.integers(0, 8, (2, 16, 16, 60)) / 8).astype(np.float32)
    want = np.asarray(getattr(jax_metrics, fn)(jnp.asarray(p)))
    got = getattr(metrics, fn)(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)


def test_meter_bank_matches_jax_and_fetches_once(monkeypatch):
    batch = _labels(4)
    want_bank, got_bank = jax_metrics.MeterBank(), metrics.MeterBank()
    assert got_bank.averages() == {}
    for seed in (4, 5, 6):
        want, got = _both(_random_preds(seed), batch, False)
        want_bank.update(want)
        got_bank.update(got)
        # accumulation stays in tensors: no host value per update
        assert all(isinstance(v, torch.Tensor) for v in got_bank.num.values())
    fetches = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: (fetches.append(1),
                                               real_cpu(self, *a, **k))[1])
    got_avg = got_bank.averages()
    assert len(fetches) == 1
    want_avg = want_bank.averages()
    assert sorted(got_avg) == sorted(want_avg)
    for k in want_avg:
        assert got_avg[k] == pytest.approx(want_avg[k], rel=1e-5, abs=1e-7), k
    got_bank.reset()
    assert got_bank.averages() == {}


def test_meter_bank_omits_metrics_whose_denominator_never_fired():
    bank = metrics.MeterBank()
    bank.update({"a": (torch.tensor(1.0), torch.tensor(2.0)),
                 "b": (torch.tensor(0.0), torch.tensor(0.0))})
    bank.update({"a": (torch.tensor(2.0), torch.tensor(2.0)),
                 "b": (torch.tensor(0.0), torch.tensor(0.0))})
    assert bank.averages() == {"a": 0.75}
