"""The serving fixture of the torch port: abcnet_tpu_torch/assets/smoke_step43100.npz.

`chip_smoke.py` holds the port's serving path on the GPU against this
fixture. It holds 64 molecules: the first 32 of the rdkit pool (seed
777001) and the first 32 of the indigo pool (seed 777002), generated
exactly as scripts/final_eval.py:35-62 generates them. Per molecule:

  images    (64, 512, 512) uint8 drawings
  truth     ground-truth SMILES
  jax_f32   SMILES from the JAX package's make_infer_pipeline on a
            float32 state loaded from snapshots/r5_latest.npz, then
            abcnet_tpu.infer.assemble_batch (CPU)
  tpu_bf16  the TPU bf16 predictions of logs/final_eval_step43100.csv
  csv_row   the row of that CSV each molecule comes from

Rebuild (about a minute of CPU, mostly the 512x512 f32 forward):

    env JAX_PLATFORMS=cpu python tests/test_torch_fixture.py [out.npz]
"""

import csv
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                       "smoke_step43100.npz")
CSV = os.path.join(REPO, "logs", "final_eval_step43100.csv")
SNAPSHOT = os.path.join(REPO, "snapshots", "r5_latest.npz")
N_PER_MODE = 32
POOLS = (("rdkit", 777001, 0), ("indigo", 777002, 256))   # (mode, seed, csv offset)
BUILD_BATCH = 8


def _csv_rows():
    with open(CSV, newline="") as f:
        return {int(r[""]): r for r in csv.DictReader(f)}


def _jax_f32_state():
    """A float32 JAX serving state on the snapshot weights (the upcast of
    bench.py:303-318)."""
    import types

    import jax
    import jax.numpy as jnp

    from abcnet_tpu.models.unet import UNet, init_unet

    z = np.load(SNAPSHOT)
    tree = {}
    for key in z.files:
        if key == "__step__":
            continue
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    model = UNet(dtype=jnp.float32)
    ref = init_unet(jax.random.PRNGKey(0), model, (1, 64, 64, 1))
    like = lambda s, r: np.asarray(s, np.float32).reshape(r.shape)  # noqa: E731
    params = jax.tree_util.tree_map(like, tree["params"], ref["params"])
    stats = jax.tree_util.tree_map(like, tree["batch_stats"],
                                   ref["batch_stats"])
    return types.SimpleNamespace(apply_fn=model.apply, params=params,
                                 batch_stats=stats)


def build_fixture(out_path: str) -> None:
    import random

    from abcnet_tpu.data.generate import generate_sample
    from abcnet_tpu.infer import assemble_batch
    from abcnet_tpu.infer.decode import make_infer_pipeline

    rows = _csv_rows()
    images, truth, modes, csv_row, tpu = [], [], [], [], []
    for mode, seed, offset in POOLS:
        rng = random.Random(seed)
        n = 0
        while n < N_PER_MODE:
            s = generate_sample(rng, mode=mode)
            if s is None:
                continue
            images.append(s.image)
            truth.append(s.smiles)
            modes.append(mode)
            csv_row.append(offset + n)
            tpu.append(rows[offset + n]["smiles_pred"])
            n += 1
    images = np.stack(images).astype(np.uint8)

    run = make_infer_pipeline(_jax_f32_state())
    jax_f32 = []
    for i in range(0, len(images), BUILD_BATCH):
        peaks = run(images[i:i + BUILD_BATCH])
        jax_f32.extend(p or "" for p in assemble_batch(peaks))
        print(f"fixture: {i + BUILD_BATCH}/{len(images)}", flush=True)
    z = np.load(SNAPSHOT)
    np.savez_compressed(
        out_path, images=images, truth=np.array(truth),
        jax_f32=np.array(jax_f32), tpu_bf16=np.array(tpu),
        mode=np.array(modes), csv_row=np.array(csv_row, np.int32),
        step=np.int64(z["__step__"]))


def test_fixture_matches_eval_csv():
    z = np.load(FIXTURE)
    rows = _csv_rows()
    assert z["images"].shape == (64, 512, 512)
    assert z["images"].dtype == np.uint8
    assert int(z["step"]) == 43100
    want_rows = list(range(0, 32)) + list(range(256, 288))
    assert z["csv_row"].tolist() == want_rows
    assert z["truth"].tolist() == [rows[r]["smiles"] for r in want_rows]
    assert z["tpu_bf16"].tolist() == [rows[r]["smiles_pred"]
                                      for r in want_rows]
    assert z["mode"].tolist() == ["rdkit"] * 32 + ["indigo"] * 32
    assert len(z["jax_f32"]) == 64
    assert os.path.getsize(FIXTURE) < 8 * 2 ** 20


@pytest.mark.slow
def test_fixture_reproducible(tmp_path):
    out = str(tmp_path / "fixture.npz")
    build_fixture(out)
    a, b = np.load(FIXTURE), np.load(out)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    build_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
    print(f"wrote {sys.argv[1] if len(sys.argv) > 1 else FIXTURE}")
