"""The torch port's serving and training slices as wholes, on the CPU.

  * make_infer_pipeline + assembler against abcnet_tpu's, f32, snapshot
    weights, 128x128 crops of fixture drawings: equal integer peaks,
    floats within FLOAT_ATOL, equal SMILES;
  * two fixture drawings at 512x512 in f32 against the JAX package's f32
    SMILES stored in the fixture;
  * the serving loop and the CLI;
  * one fixture batch at 128x128 through `loss_and_metrics` of both
    packages on the snapshot weights, eval mode: the total within 1e-4
    relative, every term within 1e-4 relative (+1e-6), every metric pair
    equal to 1e-5;
  * every module of the package and chip_smoke.py import with jax, flax,
    optax, orbax, abcnet_tpu, matplotlib, pandas and the repo-root
    bench.py (JAX code) blocked, and the generator draws a molecule with
    its shipped fonts there;
  * an entry point without device="cpu" raises when there is no GPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from abcnet_tpu.infer import assemble_batch as jax_assemble_batch
from abcnet_tpu.infer.decode import make_infer_pipeline as jax_pipeline
from abcnet_tpu_torch import __main__ as cli
from abcnet_tpu_torch.infer.assemble import assemble_batch
from abcnet_tpu_torch.infer.decode import make_infer_pipeline
from abcnet_tpu_torch.models.weights import load_snapshot
from torch_parity import (FIXTURE, REPO, SNAPSHOT, assert_peaks_equal,
                          flax_variables, jax_state, label_batch, torch_model)

# Floats of the peak dict derive from logits that agree to 1e-4 (see
# test_torch_model.py); the parabolic sub-cell offsets divide logit
# differences by the peak's curvature, which amplifies that. Measured
# worst case on this input: 4.7e-5 (atom_sub); bond_delta 1.5e-5.
FLOAT_ATOL = 2e-4


@pytest.fixture(scope="module")
def fixture():
    return np.load(FIXTURE)


@pytest.mark.parametrize("sparse", [True, False])
def test_pipeline_matches_jax_at_128(fixture, sparse):
    params, stats = flax_variables("snapshot")
    images = np.ascontiguousarray(fixture["images"][:3, 192:320, 192:320])
    want = jax_pipeline(jax_state(params, stats), sparse=sparse)(images)
    got = make_infer_pipeline(torch_model(params, stats), "cpu",
                              sparse=sparse)(images)
    assert_peaks_equal(want, got, atol=FLOAT_ATOL)
    for native in (False, True):
        assert assemble_batch(got, native=native) == \
            jax_assemble_batch(want, native=native)


def test_fixture_512_f32_matches_jax_smiles(fixture):
    model, step = load_snapshot(SNAPSHOT, device="cpu", dtype=torch.float32)
    assert step == int(fixture["step"])
    run = make_infer_pipeline(model, "cpu")
    preds = cli.img2smiles_loop(run, list(fixture["images"][[0, 40]]), 2,
                                log_every=0)
    assert [p or "" for p in preds] == fixture["jax_f32"][[0, 40]].tolist()


def test_training_forward_matches_jax_at_128(fixture):
    """The training slice as a whole: packed bits -> unpack -> targets ->
    UNet -> eight losses -> total (+ metrics), eval mode, f32."""
    import jax
    import jax.numpy as jnp

    from abcnet_tpu.models.unet import UNet as FlaxUNet
    from abcnet_tpu.train import trainer as jax_trainer
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.train import trainer

    rows = (0, 1, 40, 41)
    batch = label_batch(rows)
    # The 128x128 centre crop of each drawing, labels shifted with it.
    batch["image_bits"] = pack_images(np.ascontiguousarray(
        fixture["images"][list(rows), 192:320, 192:320]))
    for k in ("atoms", "bonds_i"):
        batch[k] = batch[k].copy()
        batch[k][..., :2] -= 48                 # (192 / 4) cells
    # The JAX package's scatter applies numpy's negative indexing before it
    # drops what is out of bounds, the port drops every cell outside the
    # grid (tests/test_torch_targets.py pins that). So labels outside the
    # crop, or on its row or column 0, are sent far out on the positive
    # side, where both drop them.
    for k in ("atoms", "bonds_i"):
        xy = batch[k][..., :2]
        outside = ((xy < 1) | (xy > 31)).any(-1)
        batch[k][outside, 0] = 10_000

    params, stats = flax_variables("snapshot")
    want_total, want = jax_trainer.loss_and_metrics(
        params, stats, FlaxUNet(dtype=jnp.float32).apply,
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
        0.0, False)
    with torch.no_grad():
        total, got = trainer.loss_and_metrics(
            torch_model(params, stats), trainer.to_device(batch, "cpu"),
            None, 0.0, train=False)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-4)
    assert sorted(got["losses"]) == sorted(want["losses"])
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(got["losses"][k]), float(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, (num, den) in want["metrics"].items():
        np.testing.assert_allclose(
            [float(x) for x in got["metrics"][k]], [float(num), float(den)],
            rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(want["metrics"]["atom_true_per_img"][0]) > 0


class _FakePipeline:
    """dispatch -> first pixel of each image; fetch on the worker thread."""

    def __init__(self):
        self.dispatched = []

    def dispatch(self, batch):
        self.dispatched.append(len(batch))
        return batch[:, 0, 0].copy()

    def fetch(self, handle):
        return handle


def test_serving_loop_order_and_padding(monkeypatch):
    from abcnet_tpu_torch.infer import assemble as asm
    monkeypatch.setattr(asm, "assemble_batch",
                        lambda peaks, pool=None: [str(v) for v in peaks])
    images = [np.full((4, 4), i, np.uint8) for i in range(7)]
    run = _FakePipeline()
    preds = cli.img2smiles_loop(run, images, 3, log_every=0)
    assert preds == [str(i) for i in range(7)]
    assert run.dispatched == [3, 3, 3]          # trailing chunk padded


def test_cli_img2smiles_and_cal_acc(fixture, tmp_path, capsys):
    from PIL import Image
    rows = ["Smiles,path"]
    for i in (0, 1, 40):
        Image.fromarray(fixture["images"][i]).save(tmp_path / f"{i}.png")
        rows.append(f"{fixture['truth'][i]},{i}.png")
    (tmp_path / "dataset.csv").write_text("\n".join(rows) + "\n")
    out = tmp_path / "results.csv"
    cli.main(["img2smiles", "--data", str(tmp_path), "--out", str(out),
              "-b", "2", "--dtype", "float32", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "n=3 decoded=3" in text
    lines = out.read_text().splitlines()
    assert lines[0] == ",smiles,smiles_pred" and len(lines) == 4
    assert [ln.split(",", 2)[2] for ln in lines[1:]] == \
        fixture["jax_f32"][[0, 1, 40]].tolist()
    cli.main(["cal-acc", str(out)])
    assert "n=3 decoded=3" in capsys.readouterr().out


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_snapshot(SNAPSHOT)
    model, _ = load_snapshot(SNAPSHOT, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_infer_pipeline(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["img2smiles", "--data", FIXTURE + ".csv"])


_BLOCKER = r"""
import importlib, importlib.abc, os, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax", "orbax", "abcnet_tpu",
                   "matplotlib", "pandas", "bench"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, REPO)
import abcnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(abcnet_tpu_torch.__path__,
                                               "abcnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
# the generator draws labels with the shipped fonts, not matplotlib's
import random
from abcnet_tpu_torch.data.generate import generate_sample
assert generate_sample(random.Random(777001), mode="rdkit") is not None
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                              "abcnet_tpu", "matplotlib", "pandas", "bench")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_abcnet_tpu():
    code = _BLOCKER.replace("REPO", repr(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60      # every module was seen
    for name in ("data.augment", "data.encode", "data.raster", "ops.noise",
                 "ops.targets", "ops.losses", "train.metrics",
                 "train.trainer", "parallel.mesh", "models.fuse_heads",
                 "models.unet_s2d", "models.unet_cbam", "infer.quant",
                 "data.binarize", "utils.profiling", "utils.diagnostics",
                 "utils.viz", "chem.random_mol", "chem.inchi", "data.layout",
                 "data.raster2", "data.render", "data.render2",
                 "data.generate", "data.degrade", "data.pool",
                 "eval.class_metrics", "eval.final_eval", "bench"):
        assert os.path.exists(os.path.join(
            REPO, "abcnet_tpu_torch", *name.split(".")) + ".py"), name


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without a card chip_smoke.py exits non-zero and prints no result;
    alone in a directory (no package beside it) it does the same."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"],
                             capture_output=True, text=True, timeout=300,
                             cwd=cwd)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
