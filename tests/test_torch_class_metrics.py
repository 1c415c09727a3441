"""eval/class_metrics.py of the port against abcnet_tpu's, on the CPU:
per_class_counts on seeded logits and targets at a 32x32 grid, every
count exactly equal (int64 against the JAX package's f32 sums of 0/1
products), argmax ties resolved to the first index as jnp.argmax does,
and per_class_report printing the same text."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.eval import class_metrics as J
from abcnet_tpu_torch.eval import class_metrics as T

G, B = 32, 3
WIDTHS = {"atom_target": 1, "bond_target": 1, "atom_type": 14,
          "atom_charge": 3, "atom_hs": 2, "bond_omega": 60,
          "bond_type": 360, "bond_rho": 60}


def _inputs(seed, ties=False, with_bond_type=True):
    rng = np.random.default_rng(seed)
    preds = {k: (rng.normal(size=(B, G, G, w)) * 3).astype(np.float32)
             for k, w in WIDTHS.items()}
    if ties:
        # quantized logits: equal maxima everywhere, plateaus in the NMS
        preds = {k: np.round(v).astype(np.float32) for k, v in preds.items()}
    t = {"atom_target": (rng.random((B, G, G, 1)) < 0.1).astype(np.float32),
         "bond_target": (rng.random((B, G, G, 1)) < 0.1).astype(np.float32),
         "atom_type": np.eye(14, dtype=np.float32)[
             rng.integers(0, 14, (B, G, G))],
         "atom_charge": np.eye(3, dtype=np.float32)[
             rng.integers(0, 3, (B, G, G))]}
    if with_bond_type:
        t["bond_type"] = (rng.random((B, G, G, 6, 60)) < 0.02
                          ).astype(np.float32)
    return preds, t


def _jax(preds, t, threshold):
    out = J.per_class_counts({k: jnp.asarray(v) for k, v in preds.items()},
                             {k: jnp.asarray(v) for k, v in t.items()},
                             threshold)
    return {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}


@pytest.mark.parametrize("seed,ties,threshold,with_bond_type", [
    (0, False, 0.25, True), (1, True, 0.25, True), (2, False, 0.6, True),
    (3, True, 0.05, False)])
def test_counts_and_report_equal(seed, ties, threshold, with_bond_type):
    preds, t = _inputs(seed, ties, with_bond_type)
    want = _jax(preds, t, threshold)
    got = T.per_class_counts({k: torch.from_numpy(v) for k, v in preds.items()},
                             {k: torch.from_numpy(v) for k, v in t.items()},
                             threshold)
    assert list(got) == list(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64),
                                          err_msg=k)
    assert sum(int(g.sum()) for v in got.values() for g in v) > 0
    assert T.per_class_report(got) == J.per_class_report(want)


def test_known_configuration_counts():
    """tests/test_class_metrics.py's hand-built case through the port."""
    from abcnet_tpu_torch.data import vocab

    C, N, O = (vocab.ATOM_VOCAB[s] for s in ("C", "N", "O"))
    atom_t = torch.zeros(1, G, G, 1)
    type_t = torch.zeros(1, G, G, 14)
    for (x, y), cls in (((10, 10), C), ((20, 20), N), ((30, 30), O)):
        atom_t[0, x, y, 0] = 1.0
        type_t[0, x, y, cls] = 1.0
    charge_t = torch.zeros(1, G, G, 3)
    charge_t[..., 0] = 1.0
    preds = {k: torch.zeros(1, G, G, w) for k, w in WIDTHS.items()}
    preds["atom_target"] -= 5.0
    preds["bond_target"] -= 5.0
    for (x, y), cls in (((10, 10), C), ((21, 20), N)):
        preds["atom_target"][0, x, y, 0] = 5.0
        preds["atom_type"][0, x, y, cls] = 10.0
    preds["atom_charge"][..., 0] = 10.0
    counts = T.per_class_counts(preds, {
        "atom_target": atom_t, "atom_type": type_t, "atom_charge": charge_t,
        "bond_target": torch.zeros(1, G, G, 1)})
    tp_p, n_p, tp_r, n_t = counts["atom_type"]
    assert (n_t[C], n_t[N], n_t[O]) == (1, 1, 1)
    assert (n_p[C], n_p[N], n_p[O]) == (1, 1, 0)
    assert tp_p[C] == 1 and tp_p[N] == 1 and tp_r[O] == 0
    assert "bond_type" not in counts
