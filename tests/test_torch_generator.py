"""The port's generator stack against abcnet_tpu's, on the CPU.

  * chem/random_mol.py: random_molecule SMILES, exactly;
  * data/layout.py: layout coordinates, exactly (pure math + random);
  * data/generate.py: generate_sample for every mode x engine and the
    given-corpus mode, several seeds: bit-equal images, equal label
    strings and SMILES, and the same random.Random state after every
    call, so the streams stay in step;
  * generate_dataset: byte-equal dataset.csv and PNG tree;
  * data/pool.py: pool files byte-equal, and each package loads the
    other's;
  * sample_to_example / batches_from_samples with degradation: equal to
    the JAX package's Examples, the same draws from the rng.
"""

import filecmp
import random

import numpy as np
import pytest

from abcnet_tpu.chem.random_mol import random_molecule as jax_random_molecule
from abcnet_tpu.chem.smiles import to_smiles as jax_to_smiles
from abcnet_tpu.data import generate as jgen
from abcnet_tpu.data import pipeline as jpipe
from abcnet_tpu.data import pool as jpool
from abcnet_tpu.data.layout import layout as jax_layout
from abcnet_tpu_torch.chem.random_mol import random_molecule
from abcnet_tpu_torch.chem.smiles import to_smiles
from abcnet_tpu_torch.data import generate as tgen
from abcnet_tpu_torch.data import pipeline as tpipe
from abcnet_tpu_torch.data import pool as tpool
from abcnet_tpu_torch.data.layout import layout


def assert_samples_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.image.dtype == b.image.dtype == np.uint8
    np.testing.assert_array_equal(a.image, b.image)
    assert (a.atoms_string, a.bonds_string, a.smiles) == \
        (b.atoms_string, b.bonds_string, b.smiles)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_molecule_and_layout_exact(seed):
    r_t, r_j = random.Random(seed), random.Random(seed)
    for _ in range(6):
        m_t, m_j = random_molecule(r_t), jax_random_molecule(r_j)
        assert to_smiles(m_t) == jax_to_smiles(m_j)
        assert layout(m_t, random.Random(seed + 1)) == \
            jax_layout(m_j, random.Random(seed + 1))
        assert r_t.getstate() == r_j.getstate()


@pytest.mark.parametrize("mode", ["rdkit", "indigo", "mixed"])
@pytest.mark.parametrize("engine", ["a", "b", "mix"])
def test_generate_sample_every_mode_and_engine(mode, engine):
    for seed in (1, 29):
        r_t, r_j = random.Random(seed), random.Random(seed)
        for _ in range(4):
            assert_samples_equal(
                tgen.generate_sample(r_t, mode=mode, engine=engine),
                jgen.generate_sample(r_j, mode=mode, engine=engine))
            assert r_t.getstate() == r_j.getstate()


def test_generate_sample_corpus_mode_and_max_atoms():
    corpus = ["C[C@H](N)C(=O)O", "F/C=C/F", "O=C(O)c1ccccc1OC(C)=O",
              "C[C@](F)(Cl)Br", "not a smiles", "c1ccc2ccccc2c1"]
    r_t, r_j = random.Random(5), random.Random(5)
    for smi in corpus:
        assert_samples_equal(tgen.generate_sample(r_t, smiles=smi),
                             jgen.generate_sample(r_j, smiles=smi))
        assert r_t.getstate() == r_j.getstate()
    for _ in range(3):
        assert_samples_equal(tgen.generate_sample(r_t, max_atoms=12),
                             jgen.generate_sample(r_j, max_atoms=12))
    assert r_t.getstate() == r_j.getstate()


def test_sample_is_one_class():
    assert tpipe.Sample is tgen.Sample


@pytest.mark.parametrize("engine", ["a", "b"])
def test_generate_dataset_bytes_equal(tmp_path, engine):
    ours, theirs = tmp_path / "t", tmp_path / "j"
    rows = tgen.generate_dataset(str(ours), 5, seed=3, engine=engine,
                                 verbose=False)
    jgen.generate_dataset(str(theirs), 5, seed=3, engine=engine,
                          verbose=False)
    assert len(rows) == 5
    assert (ours / "dataset.csv").read_bytes() == \
        (theirs / "dataset.csv").read_bytes()
    for r in rows:
        assert filecmp.cmp(ours / r["path"], theirs / r["path"],
                           shallow=False)
    # and it reads back as the JAX package's samples
    for a, b in zip(tpipe.load_csv_dataset(str(ours / "dataset.csv")),
                    jpipe.load_csv_dataset(str(theirs / "dataset.csv"))):
        assert_samples_equal(a, b)


def test_generate_dataset_empty_csv_matches_pandas(tmp_path):
    tgen.generate_dataset(str(tmp_path / "t"), 0, verbose=False)
    jgen.generate_dataset(str(tmp_path / "j"), 0, verbose=False)
    assert (tmp_path / "t" / "dataset.csv").read_bytes() == \
        (tmp_path / "j" / "dataset.csv").read_bytes()


def _samples(n, seed=11):
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        s = tgen.generate_sample(rng, mode="indigo")   # canvases 320-512
        if s is not None:
            out.append(s)
    return out


def test_pool_files_cross_load(tmp_path):
    samples = _samples(3)
    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tpool.save_pool(ours, samples)
    jpool.save_pool(theirs, [jgen.Sample(s.image, s.atoms_string,
                                         s.bonds_string, s.smiles)
                             for s in samples])
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for loaded in (tpool.load_pool(theirs), jpool.load_pool(ours)):
        assert len(loaded) == 3
        for a, b in zip(loaded, samples):
            assert_samples_equal(a, b)
    # build_pool / ensure_pool make the same file from the same stream
    bt, bj = str(tmp_path / "bt.npz"), str(tmp_path / "bj.npz")
    tpool.ensure_pool(bt, 2, seed=4)
    jpool.ensure_pool(bj, 2, seed=4)
    assert open(bt, "rb").read() == open(bj, "rb").read()


@pytest.mark.parametrize("hard", [False, True])
def test_sample_to_example_with_degradation(hard):
    samples = _samples(4, seed=2)
    r_t, r_j = random.Random(9), random.Random(9)
    for s in samples:
        a = tpipe.sample_to_example(s, r_t, train=True, degrade_p=1.0,
                                    degrade_hard=hard)
        b = jpipe.sample_to_example(
            jgen.Sample(s.image, s.atoms_string, s.bonds_string, s.smiles),
            r_j, train=True, degrade_p=1.0, degrade_hard=hard)
        np.testing.assert_array_equal(a.image_u8, b.image_u8)
        assert sorted(a.labels) == sorted(b.labels)
        for k in a.labels:
            np.testing.assert_array_equal(a.labels[k], b.labels[k])
        assert a.smiles == b.smiles
        assert r_t.getstate() == r_j.getstate()


def test_batches_from_samples_degrade():
    samples = _samples(4, seed=3)
    jsamples = [jgen.Sample(s.image, s.atoms_string, s.bonds_string,
                            s.smiles) for s in samples]
    got = list(tpipe.batches_from_samples(samples, 2, seed=1, epoch=2,
                                          degrade_p=0.5))
    want = list(jpipe.batches_from_samples(jsamples, 2, seed=1, epoch=2,
                                           degrade_p=0.5))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
