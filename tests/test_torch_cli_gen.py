"""The port's CLI sub-commands of slice 5 against abcnet_tpu's, on the CPU.

  * `gen` writes a byte-equal dataset.csv and PNG tree (engines a and b,
    and the given-corpus mode with --smiles-csv);
  * `train --synthetic N` builds the JAX package's sample list (fit is
    patched in both packages to capture what it is given, so no 512x512
    step runs);
  * `test-acc` prints the JAX package's report of the JAX package's f32
    counts on the same drawings and weights;
  * eval.final_eval: its pools are the rows of the TPU's results CSV, and
    its main() runs end to end at a cut-down batch.
"""

import csv
import filecmp
import os

import numpy as np
import pytest

import test_torch_testacc_fixture as taf
from abcnet_tpu import __main__ as jcli
from abcnet_tpu_torch import __main__ as tcli
from torch_parity import REPO

EVAL_CSV = os.path.join(REPO, "logs", "final_eval_step43100.csv")


def _trees_equal(a, b):
    assert (a / "dataset.csv").read_bytes() == (b / "dataset.csv").read_bytes()
    with open(a / "dataset.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert rows
    for r in rows:
        assert filecmp.cmp(a / r["path"], b / r["path"], shallow=False)
    return rows


@pytest.mark.parametrize("engine", ["a", "b"])
def test_gen_writes_the_jax_packages_tree(tmp_path, engine):
    args = ["-n", "6", "--engine", engine, "--seed", "4", "--mode", "mixed"]
    tcli.main(["gen", "--out", str(tmp_path / "t")] + args)
    jcli.main(["gen", "--out", str(tmp_path / "j")] + args)
    assert len(_trees_equal(tmp_path / "t", tmp_path / "j")) == 6


def test_gen_smiles_csv_corpus(tmp_path, capsys):
    corpus = tmp_path / "corpus.csv"
    corpus.write_text("id,SMILES\n1,C[C@H](N)C(=O)O\n2,not a smiles\n"
                      "3,F/C=C/F\n4,O=C(O)c1ccccc1OC(C)=O\n")
    args = ["--smiles-csv", str(corpus), "-n", "0", "--seed", "2"]
    tcli.main(["gen", "--out", str(tmp_path / "t")] + args)
    jcli.main(["gen", "--out", str(tmp_path / "j")] + args)
    assert len(_trees_equal(tmp_path / "t", tmp_path / "j")) == 3
    out = capsys.readouterr().out
    assert out.count("wrote 3 samples") == 2
    bad = tmp_path / "bad.csv"
    bad.write_text("id,name\n1,x\n")
    with pytest.raises(SystemExit, match="no Smiles column"):
        tcli.main(["gen", "--out", str(tmp_path / "x"), "--smiles-csv",
                   str(bad)])


def test_train_synthetic_builds_the_jax_sample_list(monkeypatch):
    from abcnet_tpu.train import trainer as jtrainer
    from abcnet_tpu_torch.train import trainer as ttrainer

    got = {}

    def capture(key):
        def fit(cfg, train, test, state=None, **kw):
            got[key] = (cfg, train, test)
        return fit

    monkeypatch.setattr(jtrainer, "fit", capture("jax"))
    monkeypatch.setattr(ttrainer, "fit", capture("torch"))
    args = ["--synthetic", "5", "--seed", "3", "-b", "2", "--epochs", "1"]
    jcli.main(["train"] + args)
    tcli.main(["train", "--device", "cpu"] + args)
    (_, jtrain, jtest), (tcfg, ttrain, ttest) = got["jax"], got["torch"]
    assert tcfg.batch_size == 2 and tcfg.device == "cpu"
    assert len(ttrain) == len(jtrain) == 4 and len(ttest) == len(jtest) == 1
    for a, b in zip(ttrain, jtrain):
        np.testing.assert_array_equal(a.image, b.image)
        assert (a.atoms_string, a.bonds_string, a.smiles) == \
            (b.atoms_string, b.bonds_string, b.smiles)
    for a, b in zip(ttest, jtest):
        np.testing.assert_array_equal(a.image_u8, b.image_u8)
        for k in b.labels:
            np.testing.assert_array_equal(a.labels[k], b.labels[k])


def test_test_acc_prints_the_jax_report(tmp_path, capsys):
    """`test-acc` on fixture rows 0-1 written as a dataset directory prints
    the JAX package's report of the JAX package's f32 counts for those
    rows (assets/test_acc_step43100.npz, small_counts_*)."""
    from abcnet_tpu.eval.class_metrics import per_class_report
    from abcnet_tpu_torch.data import raster
    from abcnet_tpu_torch.data.generate import write_dataset_csv

    rows = []
    for i, s in enumerate(taf.fixture_samples(taf.SMALL_ROWS)):
        path = f"images/{i}.png"
        (tmp_path / "images").mkdir(exist_ok=True)
        raster.imwrite(str(tmp_path / path), s.image)
        rows.append({"Smiles": s.smiles, "ID": str(i), "path": path,
                     "atoms_string": s.atoms_string,
                     "bonds_string": s.bonds_string})
    write_dataset_csv(str(tmp_path / "dataset.csv"), rows)
    z = np.load(taf.FIXTURE)
    want = per_class_report({g: tuple(z[f"small_counts_{g}"])
                             for g in taf.GROUPS})
    tcli.main(["test-acc", "--data", str(tmp_path), "-b",
               str(taf.SMALL_BATCH), "--dtype", "float32", "--device",
               "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("weights: ")
    assert "\n".join(out.splitlines()[1:]) == want


def test_final_eval_pools_are_the_tpu_csv_rows():
    from abcnet_tpu_torch.data.generate import generate_samples
    from abcnet_tpu_torch.eval.final_eval import POOLS

    with open(EVAL_CSV, newline="") as f:
        rows = list(csv.DictReader(f))
    for j, (mode, seed) in enumerate(POOLS):
        pool = generate_samples(8, seed, mode)
        assert [s.smiles for s in pool] == \
            [rows[256 * j + i]["smiles"] for i in range(8)]


def test_final_eval_main_end_to_end(tmp_path, monkeypatch, capsys):
    from abcnet_tpu_torch.eval import final_eval as fe

    monkeypatch.setattr(fe, "EVAL_BATCH", 2)
    out = tmp_path / "fe.csv"
    fe.main(["2", "--device", "cpu", "--dtype", "float32", "--out",
             str(out)])
    text = capsys.readouterr().out
    for tag in ("HEATMAP[rdkit]", "HEATMAP[indigo]", "E2E[rdkit]",
                "E2E[indigo/int-cell]", "E2E[all] n=4", "E2E[all/int-cell]"):
        assert tag in text
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    with open(EVAL_CSV, newline="") as f:
        ref = list(csv.DictReader(f))
    assert [r["smiles"] for r in rows] == \
        [ref[i]["smiles"] for i in (0, 1, 256, 257)]
    with pytest.raises(SystemExit, match="logs"):
        fe.main(["2", "--device", "cpu", "--out",
                 os.path.join(REPO, "logs", "x.csv")])


def test_entry_points_of_the_slice_need_cuda_unless_cpu_is_asked(
        monkeypatch, tmp_path):
    import torch

    from abcnet_tpu_torch.eval import final_eval as fe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["test-acc", "--data", str(tmp_path)],
                 ["train", "--synthetic", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fe.main(["16"])
