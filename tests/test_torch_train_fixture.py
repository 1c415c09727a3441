"""The training fixture of the torch port: abcnet_tpu_torch/assets/train_step43100.npz.

`chip_smoke.py` trains and evaluates on the GPU with the 64 molecules of
the serving fixture (smoke_step43100.npz holds their drawings). This
fixture adds what training needs, generated exactly as
tests/test_torch_fixture.py generates the drawings (the generator is
deterministic in its seed):

  atoms_string, bonds_string   the label strings of each Sample
  smiles                       its ground-truth SMILES
  images_sha256                checksum of the (64, 512, 512) uint8
                               drawings the labels belong to
  eval_rows                    the rows of the eval batch (0..15)
  eval_loss_names, eval_losses the JAX package's f32 CPU `eval_step` on
                               those rows with the step-43100 snapshot
                               weights: the eight loss terms
  eval_total                   and their uncertainty-weighted total

Rebuild (several minutes of CPU, mostly compiling and running the
512x512 f32 eval step at batch 16):

    env JAX_PLATFORMS=cpu python tests/test_torch_train_fixture.py [out.npz]
"""

import hashlib
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING_FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                               "smoke_step43100.npz")
FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                       "train_step43100.npz")
N_PER_MODE = 32
POOLS = (("rdkit", 777001), ("indigo", 777002))
EVAL_ROWS = 16


def images_sha256(images: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(images, np.uint8).tobytes()
                          ).hexdigest()


def jax_eval_losses(samples):
    """The JAX package's f32 eval_step on `samples` with the snapshot
    weights: ({loss name: value}, total)."""
    import random

    import jax

    from abcnet_tpu.data import pipeline
    from abcnet_tpu.train import trainer
    from test_torch_fixture import _jax_f32_state

    ref = _jax_f32_state()
    state = trainer.create_state(trainer.TrainConfig(dtype="float32"))
    state = state.replace(params=ref.params, batch_stats=ref.batch_stats)
    rng = random.Random(0)
    batch = pipeline.collate([pipeline.sample_to_example(s, rng, train=False)
                              for s in samples])
    total, losses, _ = trainer.eval_step(state, batch, jax.random.PRNGKey(0))
    return {k: float(v) for k, v in losses.items()}, float(total)


def build_fixture(out_path: str) -> None:
    import random

    from abcnet_tpu.data.generate import generate_sample

    samples = []
    for mode, seed in POOLS:
        rng = random.Random(seed)
        n = 0
        while n < N_PER_MODE:
            s = generate_sample(rng, mode=mode)
            if s is None:
                continue
            samples.append(s)
            n += 1
    images = np.stack([s.image for s in samples]).astype(np.uint8)
    losses, total = jax_eval_losses(samples[:EVAL_ROWS])
    names = sorted(losses)
    np.savez_compressed(
        out_path,
        atoms_string=np.array([s.atoms_string for s in samples]),
        bonds_string=np.array([s.bonds_string for s in samples]),
        smiles=np.array([s.smiles for s in samples]),
        images_sha256=np.array(images_sha256(images)),
        eval_rows=np.arange(EVAL_ROWS, dtype=np.int32),
        eval_loss_names=np.array(names),
        eval_losses=np.array([losses[k] for k in names], np.float64),
        eval_total=np.float64(total))


def test_train_fixture_parses_and_matches_the_drawings():
    from abcnet_tpu_torch.data.encode import (compact_labels,
                                              parse_atoms_string,
                                              parse_bonds_string)
    from abcnet_tpu_torch.ops.losses import S_INDEX

    z = np.load(FIXTURE)
    serving = np.load(SERVING_FIXTURE)
    assert str(z["images_sha256"]) == images_sha256(serving["images"])
    assert z["smiles"].tolist() == serving["truth"].tolist()
    assert len(z["atoms_string"]) == len(z["bonds_string"]) == 64
    for a, b in zip(z["atoms_string"], z["bonds_string"]):
        atoms, bonds = parse_atoms_string(str(a)), parse_bonds_string(str(b))
        labels = compact_labels(atoms, bonds)
        assert 0 < int(labels["n_atoms"]) == len(atoms)
        assert int(labels["n_bonds"]) >= len(bonds) > 0
        # every atom lies on the 128x128 grid of its 512x512 drawing
        xy = labels["atoms"][:len(atoms), :2]
        assert xy.min() >= 0 and xy.max() < 128
    assert z["eval_rows"].tolist() == list(range(EVAL_ROWS))
    assert sorted(z["eval_loss_names"].tolist()) == sorted(S_INDEX)
    assert np.isfinite(z["eval_losses"]).all() and np.isfinite(z["eval_total"])
    assert os.path.getsize(FIXTURE) < 2 ** 20


@pytest.mark.slow
def test_train_fixture_reproducible(tmp_path):
    out = str(tmp_path / "fixture.npz")
    build_fixture(out)
    a, b = np.load(FIXTURE), np.load(out)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if a[k].dtype.kind == "f":
            # f32 sums of the CPU backend, reordered between runs by its
            # threading: relative 1e-5
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    build_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
    print(f"wrote {sys.argv[1] if len(sys.argv) > 1 else FIXTURE}")
