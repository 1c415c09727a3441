"""The test-acc fixture of the torch port: abcnet_tpu_torch/assets/test_acc_step43100.npz.

`chip_smoke.py` runs the port's `test-acc` counting in f32 (TF32 off) on
the GPU over rows 0-15 of the 64 fixture molecules (drawings in
smoke_step43100.npz, label strings in train_step43100.npz) and holds the
per-class counts to the JAX package's. This fixture keeps the JAX
package's `test-acc` path (abcnet_tpu/__main__.py:192-239: eval unpack,
f32 forward on the step-43100 snapshot weights, build_targets with the
full bond-type map, per_class_counts) on the CPU:

  groups                 atom_charge, atom_type, bond_type
  counts_<group>         (4, n_classes) int64: tp_p, n_p, tp_r, n_t over
                         rows 0-15 at batch 16 (the CLI's default)
  small_counts_<group>   the same over rows 0-1 at batch 2, for the
                         tier-1 rebuild

Rebuild (well under a minute of CPU):

    env JAX_PLATFORMS=cpu python tests/test_torch_testacc_fixture.py [out.npz]
"""

import os
import random
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_parity import FIXTURE as SERVING_FIXTURE  # noqa: E402
from torch_parity import SNAPSHOT, TRAIN_FIXTURE  # noqa: E402

FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                       "test_acc_step43100.npz")
ROWS, BATCH = 16, 16
SMALL_ROWS, SMALL_BATCH = 2, 2
GROUPS = ("atom_charge", "atom_type", "bond_type")


def fixture_samples(n):
    """The first n fixture molecules as the port's Samples."""
    from abcnet_tpu_torch.data.generate import Sample

    z, lab = np.load(SERVING_FIXTURE), np.load(TRAIN_FIXTURE)
    return [Sample(z["images"][i], str(lab["atoms_string"][i]),
                   str(lab["bonds_string"][i]), str(lab["smiles"][i]))
            for i in range(n)]


def jax_f32_state():
    """A float32 JAX serving state on the snapshot weights, shaped by
    jax.eval_shape of the Flax init (no init is run)."""
    import types

    import jax
    import jax.numpy as jnp

    from abcnet_tpu.models.unet import UNet, init_unet
    from abcnet_tpu_torch.models.weights import _unflatten

    model = UNet(dtype=jnp.float32)
    ref = jax.eval_shape(lambda: init_unet(jax.random.PRNGKey(0), model,
                                           (1, 64, 64, 1)))
    z = np.load(SNAPSHOT)
    tree = _unflatten({k: z[k] for k in z.files if k != "__step__"})
    like = lambda s, r: np.asarray(s, np.float32).reshape(r.shape)  # noqa: E731
    return types.SimpleNamespace(
        apply_fn=model.apply,
        params=jax.tree_util.tree_map(like, tree["params"], ref["params"]),
        batch_stats=jax.tree_util.tree_map(like, tree["batch_stats"],
                                           ref["batch_stats"]))


def jax_counts(samples, batch_size):
    """The JAX package's test-acc counting (abcnet_tpu/__main__.py:213-239)
    on a float32 state with the snapshot weights: {group: (4, C) int64}."""
    import jax

    from abcnet_tpu.data import pipeline
    from abcnet_tpu.eval.class_metrics import per_class_counts
    from abcnet_tpu.ops.losses import _to_nhwc_targets
    from abcnet_tpu.ops.targets import build_targets

    state = jax_f32_state()
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(s, rng, train=False)
                for s in samples]

    @jax.jit
    def run(batch):
        images = pipeline.device_unpack_bits(batch["image_bits"],
                                             jax.random.PRNGKey(0),
                                             train=False)
        preds = state.apply_fn({"params": state.params,
                                "batch_stats": state.batch_stats},
                               images, train=False)
        targets = _to_nhwc_targets(build_targets(batch,
                                                 with_full_type=True))
        return per_class_counts(preds, targets)

    acc = None
    for hb in pipeline.batches_from_examples(examples, batch_size,
                                             shuffle=False):
        counts = {k: np.stack([np.asarray(x) for x in v])
                  for k, v in run(hb).items()}
        acc = counts if acc is None else {k: acc[k] + counts[k]
                                          for k in acc}
    return {k: np.rint(v).astype(np.int64) for k, v in acc.items()}


def port_counts(samples, batch_size):
    """The port's test-acc counting (abcnet_tpu_torch.__main__:
    per_class_totals) in f32 on the CPU: {group: (4, C) int64}."""
    from abcnet_tpu_torch.__main__ import per_class_totals
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot

    model, _ = load_snapshot(SNAPSHOT, device="cpu", dtype=torch.float32)
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(s, rng, train=False)
                for s in samples]
    return {k: torch.stack(v).numpy()
            for k, v in per_class_totals(model, examples,
                                         batch_size).items()}


def build_fixture(out_path: str) -> None:
    full = jax_counts(fixture_samples(ROWS), BATCH)
    small = jax_counts(fixture_samples(SMALL_ROWS), SMALL_BATCH)
    np.savez_compressed(
        out_path, groups=np.array(GROUPS), rows=np.int64(ROWS),
        batch=np.int64(BATCH),
        **{f"counts_{g}": full[g] for g in GROUPS},
        **{f"small_counts_{g}": small[g] for g in GROUPS})


def test_fixture_rebuilds_at_small_n():
    z = np.load(FIXTURE)
    assert z["groups"].tolist() == list(GROUPS)
    fresh = jax_counts(fixture_samples(SMALL_ROWS), SMALL_BATCH)
    assert sorted(fresh) == list(GROUPS)
    for g in GROUPS:
        np.testing.assert_array_equal(z[f"small_counts_{g}"], fresh[g],
                                      err_msg=g)
        full = z[f"counts_{g}"]
        assert full.dtype == np.int64 and (full >= 0).all()
        # tp never exceeds the count it is a part of
        assert (full[0] <= full[1]).all() and (full[2] <= full[3]).all()
    # the 16 rows hold atoms and bonds of several classes
    assert (z["counts_atom_type"][3] > 0).sum() >= 3
    assert z["counts_bond_type"][3].sum() > 300


def test_port_counts_equal_jax_fixture():
    """The port's f32 counting on the CPU equals the JAX package's on rows
    0-1, every count."""
    z = np.load(FIXTURE)
    got = port_counts(fixture_samples(SMALL_ROWS), SMALL_BATCH)
    for g in GROUPS:
        np.testing.assert_array_equal(got[g], z[f"small_counts_{g}"],
                                      err_msg=g)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    build_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
    print(f"wrote {sys.argv[1] if len(sys.argv) > 1 else FIXTURE}")
