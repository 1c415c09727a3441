"""Sharded serving of the torch port on the CPU: make_infer_pipeline over a
single-process mesh of two devices (two CPU stand-ins, parallel.make_mesh)
against the unsharded pipeline, and `img2smiles --mesh`. The mirror of
tests/test_trainer.py:199-221 (the JAX package's mesh serving test), with
the unsharded run as the reference: every array of the peak dict equal,
bit for bit, for run(), for the dispatch/fetch halves and with fetch on a
worker thread.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from abcnet_tpu_torch import __main__ as cli
from abcnet_tpu_torch.infer.decode import make_infer_pipeline
from abcnet_tpu_torch.models.weights import load_snapshot
from abcnet_tpu_torch.parallel import make_mesh
from torch_parity import FIXTURE, SNAPSHOT


@pytest.fixture(scope="module")
def setup():
    z = np.load(FIXTURE)
    images = np.ascontiguousarray(z["images"][[0, 1, 40, 41],
                                              192:320, 192:320])
    model, _ = load_snapshot(SNAPSHOT, "cpu", torch.float32)
    return model, images


def _equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("sparse", [True, False])
def test_sharded_equals_unsharded(setup, sparse):
    model, images = setup
    want = make_infer_pipeline(model, "cpu", sparse=sparse)(images)
    run = make_infer_pipeline(model, "cpu", sparse=sparse,
                              mesh=make_mesh(2, "cpu"))
    assert len(run.devices) == 2
    _equal(want, run(images))
    _equal(want, run.fetch(run.dispatch(images)))
    with ThreadPoolExecutor(1) as ex:
        _equal(want, ex.submit(run.fetch, run.dispatch(images)).result())
    with pytest.raises(ValueError, match="divide"):
        run.dispatch(images[:3])


def test_cli_img2smiles_mesh(tmp_path, capsys):
    from PIL import Image
    z = np.load(FIXTURE)
    rows = ["Smiles,path"]
    for i in (0, 40):
        Image.fromarray(z["images"][i]).save(tmp_path / f"{i}.png")
        rows.append(f"{z['truth'][i]},{i}.png")
    (tmp_path / "dataset.csv").write_text("\n".join(rows) + "\n")
    out = tmp_path / "results.csv"
    cli.main(["img2smiles", "--data", str(tmp_path), "--out", str(out),
              "-b", "2", "--mesh", "2", "--dtype", "float32",
              "--device", "cpu"])
    assert "n=2 decoded=2" in capsys.readouterr().out
    lines = out.read_text().splitlines()
    assert [ln.split(",", 2)[2] for ln in lines[1:]] == \
        z["jax_f32"][[0, 40]].tolist()
