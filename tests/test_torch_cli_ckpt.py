"""`--ckpt` of the port's img2smiles and test-acc on a checkpoint directory
that `train --ckpt` writes, on the CPU, f32.

The directory is written by `trainer.save_checkpoint`, as `fit` writes it:
a CPU state whose module holds the step-43100 snapshot weights with one
BatchNorm running mean moved (so the checkpoint is told from the
snapshot), saved as step 7. No train step runs: a 512x512 step costs too
much on the CPU, and `fit` only calls save_checkpoint. Then, on the
first two fixture molecules written as a dataset directory:

  * img2smiles --ckpt DIR prints step 7, and every array of its peak
    dicts equals, bit for bit, the pipeline's on the module that
    `restore_checkpoint` gives;
  * test-acc --ckpt DIR prints step 7, and its per-class counts equal
    `per_class_totals` on that module;
  * `load_weights` restores every layout from a checkpoint (the plain
    UNet, its fused head bank, UNetS2D, UNetCBAM) with the module's
    parameters and running statistics exactly; the latest step wins; a
    snapshot .npz loads as before; an empty directory and a file of
    another kind raise.
"""

import numpy as np
import pytest
import torch

import test_torch_testacc_fixture as taf
from abcnet_tpu_torch import __main__ as tcli
from abcnet_tpu_torch.infer import decode
from abcnet_tpu_torch.models import (UNet, UNetCBAM, UNetS2D, load_snapshot,
                                     load_weights)
from abcnet_tpu_torch.train import trainer
from torch_parity import SNAPSHOT

STEP = 7
MOVED = "down4.double_conv.bn1.running_mean"


def _cpu_state(model=None):
    cfg = trainer.TrainConfig(dtype="float32", device="cpu", batch_size=2)
    return trainer.create_state(cfg, model)


def _state_equal(a, b, skip=("num_batches_tracked",)):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        if not k.endswith(skip):
            assert sa[k].dtype == sb[k].dtype, k
            assert torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A checkpoint directory of the moved snapshot at step 7, and the
    dataset directory of fixture rows 0-1."""
    from abcnet_tpu_torch.data import raster
    from abcnet_tpu_torch.data.generate import write_dataset_csv

    root = tmp_path_factory.mktemp("ckpt")
    model, _ = load_snapshot(SNAPSHOT, "cpu", torch.float32)
    with torch.no_grad():
        model.state_dict()[MOVED].add_(0.25)
    trainer.save_checkpoint(_cpu_state(model), str(root / "ck"), step=STEP)
    ds = root / "ds"
    (ds / "images").mkdir(parents=True)
    rows = []
    for i, s in enumerate(taf.fixture_samples(taf.SMALL_ROWS)):
        path = f"images/{i}.png"
        raster.imwrite(str(ds / path), s.image)
        rows.append({"Smiles": s.smiles, "ID": str(i), "path": path,
                     "atoms_string": s.atoms_string,
                     "bonds_string": s.bonds_string})
    write_dataset_csv(str(ds / "dataset.csv"), rows)
    return root / "ck", ds


@pytest.fixture(scope="module")
def restored(ckpt_dir):
    state = trainer.restore_checkpoint(_cpu_state(), str(ckpt_dir[0]))
    assert state.step == STEP
    return state.model


def test_img2smiles_serves_the_checkpoint(ckpt_dir, restored, monkeypatch,
                                          capsys):
    from abcnet_tpu_torch.data.pipeline import load_image_csv

    ck, ds = ckpt_dir
    served, make = [], decode.make_infer_pipeline

    def recording(model, *a, **kw):
        run = make(model, *a, **kw)
        fetch = run.fetch

        def fetch_and_keep(handle):
            served.append(fetch(handle))
            return served[-1]
        run.fetch = fetch_and_keep
        return run

    monkeypatch.setattr(decode, "make_infer_pipeline", recording)
    tcli.main(["img2smiles", "--data", str(ds), "--ckpt", str(ck), "--out",
               str(ds / "results.csv"), "-b", "2", "--dtype", "float32",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"weights: {ck} (step {STEP})" in out.splitlines()[0]
    assert "n=2 decoded=2" in out
    images, _ = load_image_csv(str(ds / "dataset.csv"))
    want = make(restored, "cpu")(np.stack(images))
    assert len(served) == 1
    assert sorted(served[0]) == sorted(want)
    for k in want:
        assert served[0][k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(served[0][k], want[k], err_msg=k)


def test_test_acc_scores_the_checkpoint(ckpt_dir, restored, monkeypatch,
                                        capsys):
    import random

    from abcnet_tpu_torch.data import pipeline

    ck, ds = ckpt_dir
    counted, totals = [], tcli.per_class_totals

    def recording(model, examples, batch_size):
        counted.append(totals(model, examples, batch_size))
        return counted[-1]

    monkeypatch.setattr(tcli, "per_class_totals", recording)
    tcli.main(["test-acc", "--data", str(ds), "--ckpt", str(ck), "-b", "2",
               "--dtype", "float32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == f"weights: {ck} (step {STEP})"
    assert "== atom_type ==" in out
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(s, rng, train=False) for s in
                pipeline.load_csv_dataset(str(ds / "dataset.csv"))]
    want = totals(restored, examples, 2)
    assert len(counted) == 1 and sorted(counted[0]) == sorted(want)
    for g in want:
        for a, b in zip(counted[0][g], want[g]):
            assert torch.equal(a, b), g


def test_checkpoint_holds_the_moved_weights(ckpt_dir, restored):
    model, step = load_weights(str(ckpt_dir[0]), "cpu", torch.float32)
    assert step == STEP and type(model) is UNet and not model.training
    _state_equal(model, restored)
    snap, _ = load_snapshot(SNAPSHOT, "cpu", torch.float32)
    assert not torch.equal(model.state_dict()[MOVED], snap.state_dict()[MOVED])


@pytest.mark.parametrize("layout", ["unet", "fused_head_bank", "s2d",
                                    "cbam"])
def test_every_layout_loads_from_a_checkpoint(tmp_path, layout):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = {"unet": lambda: UNet(),
                 "fused_head_bank": lambda: UNet(fused_head_bank=True),
                 "s2d": UNetS2D, "cbam": UNetCBAM}[layout]()
        with torch.no_grad():
            for name, t in model.state_dict().items():
                if name.endswith(("running_mean", "running_var")):
                    t.uniform_(0.5, 1.5)
    state = _cpu_state(model)
    trainer.save_checkpoint(state, str(tmp_path), step=2)
    trainer.save_checkpoint(state, str(tmp_path), step=11)
    got, step = load_weights(str(tmp_path), "cpu", torch.bfloat16)
    assert step == 11 and type(got) is type(model)
    assert got.dtype == torch.bfloat16
    _state_equal(got, model)


def test_snapshot_loads_as_before():
    got, step = load_weights(SNAPSHOT, "cpu", torch.float32)
    want, want_step = load_snapshot(SNAPSHOT, "cpu", torch.float32)
    assert step == want_step == 43100
    _state_equal(got, want, skip=())


def test_no_checkpoint_or_another_kind_raises(ckpt_dir, tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_weights(str(tmp_path), "cpu")
    other = tmp_path / "weights.pt"
    other.write_bytes(b"not weights")
    with pytest.raises(ValueError, match="weights.pt"):
        load_weights(str(other), "cpu")
    (tmp_path / "empty").mkdir()
    for cmd in ("img2smiles", "test-acc"):
        with pytest.raises(FileNotFoundError, match="no checkpoints"):
            tcli.main([cmd, "--data", str(ckpt_dir[1]), "--ckpt",
                       str(tmp_path / "empty"), "--device", "cpu"])
