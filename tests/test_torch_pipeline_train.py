"""The train half of abcnet_tpu_torch.data.pipeline against abcnet_tpu's.

Host code (augment, labels, collate, batching, prefetch, the synthetic
batch, the CSV reader) is numpy and `random.Random` in both packages:
the same seeds must give equal arrays, so the tolerance is equality.
The device noise draws from each framework's own generator and matches
by distribution only: realized salt and pepper fractions inside the
bounds that tests/test_pallas_input.py holds the JAX kernel to.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.data import augment as jax_augment
from abcnet_tpu.data import encode as jax_encode
from abcnet_tpu.data import pipeline as jax_pipeline
from abcnet_tpu.data.generate import Sample as JaxSample
from abcnet_tpu_torch.data import augment, encode, pipeline, raster
from torch_parity import fixture_samples

ROWS = (0, 1, 2, 33, 34, 35, 40, 63)


@pytest.fixture(scope="module")
def samples():
    port = fixture_samples(ROWS)
    ref = [JaxSample(s.image, s.atoms_string, s.bonds_string, s.smiles)
           for s in port]
    return port, ref


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_examples_equal(got, want):
    np.testing.assert_array_equal(got.image_u8, want.image_u8)
    assert got.smiles == want.smiles
    assert_batches_equal(got.labels, want.labels)


@pytest.mark.parametrize("train", [True, False])
def test_sample_to_example_matches_jax(samples, train):
    port, ref = samples
    augmented = 0
    for seed in range(6):           # 48 draws: the 20% rescale does occur
        r1, r2 = random.Random(seed), random.Random(seed)
        for s, js in zip(port, ref):
            got = pipeline.sample_to_example(s, r1, train=train)
            want = jax_pipeline.sample_to_example(js, r2, train=train)
            assert_examples_equal(got, want)
            augmented += not np.array_equal(got.image_u8, s.image)
        assert r1.random() == r2.random()       # the same draws were taken
    assert (augmented > 0) == train


def test_sample_to_example_refuses_the_unported_degradation(samples):
    """degrade_p > 0 raised until data/degrade.py came to the port; now it
    degrades as the JAX package does, with the same draws from the rng
    (both regimes), and degrade_p = 0 leaves the drawing as it was."""
    port, ref = samples
    for hard in (False, True):
        r_t, r_j = random.Random(5), random.Random(5)
        for p, r in zip(port[:3], ref[:3]):
            got = pipeline.sample_to_example(p, r_t, degrade_p=0.5,
                                             degrade_hard=hard)
            want = jax_pipeline.sample_to_example(r, r_j, degrade_p=0.5,
                                                  degrade_hard=hard)
            np.testing.assert_array_equal(got.image_u8, want.image_u8)
            assert r_t.getstate() == r_j.getstate()
    plain = pipeline.sample_to_example(port[0], random.Random(0),
                                       train=False, degrade_p=1.0)
    np.testing.assert_array_equal(plain.image_u8, port[0].image)


def test_label_and_augment_copies_match_jax(samples):
    port, _ = samples
    for s in port[:3]:
        atoms = encode.parse_atoms_string(s.atoms_string)
        bonds = encode.parse_bonds_string(s.bonds_string)
        jatoms = jax_encode.parse_atoms_string(s.atoms_string)
        jbonds = jax_encode.parse_bonds_string(s.bonds_string)
        got, want = encode.encode_targets_np(atoms, bonds), \
            jax_encode.encode_targets_np(jatoms, jbonds)
        assert_batches_equal(got, want)
        p = augment.AugmentParams(0.9, 1.0, 25, 0)
        assert_batches_equal(
            encode.compact_labels(atoms, bonds, p.scale_x, p.scale_y,
                                  p.ddx, p.ddy),
            jax_encode.compact_labels(jatoms, jbonds, 0.9, 1.0, 25, 0))
        for seed in (0, 1, 2, 3):
            ink, p = augment.augment_np(s.image, np.random.default_rng(seed))
            jink, jp = jax_augment.augment_np(s.image,
                                              np.random.default_rng(seed))
            np.testing.assert_array_equal(ink, jink)
            assert (p.scale_x, p.scale_y, p.ddx, p.ddy) == \
                (jp.scale_x, jp.scale_y, jp.ddx, jp.ddy)
        np.testing.assert_array_equal(augment.binarize_test_np(s.image),
                                      jax_augment.binarize_test_np(s.image))
    assert (encode.MAX_ATOMS, encode.MAX_BONDS) == \
        (jax_encode.MAX_ATOMS, jax_encode.MAX_BONDS)


def test_collate_matches_jax(samples):
    port, ref = samples
    r1, r2 = random.Random(3), random.Random(3)
    got = pipeline.collate([pipeline.sample_to_example(s, r1) for s in port])
    want = jax_pipeline.collate([jax_pipeline.sample_to_example(s, r2)
                                 for s in ref])
    assert_batches_equal(got, want)
    assert got["image_bits"].shape == (len(ROWS), 512, 64)


@pytest.mark.parametrize("epoch,drop", [(0, True), (3, True), (1, False)])
def test_batches_from_samples_match_jax(samples, epoch, drop):
    port, ref = samples
    got = list(pipeline.batches_from_samples(port, 3, seed=7, epoch=epoch,
                                             drop_remainder=drop))
    want = list(jax_pipeline.batches_from_samples(ref, 3, seed=7, epoch=epoch,
                                                  drop_remainder=drop))
    assert len(got) == len(want) == (2 if drop else 3)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_batches_from_examples_match_jax(samples, shuffle, drop):
    port, ref = samples
    r1, r2 = random.Random(1), random.Random(1)
    ex = [pipeline.sample_to_example(s, r1, train=False) for s in port]
    jex = [jax_pipeline.sample_to_example(s, r2, train=False) for s in ref]
    got = list(pipeline.batches_from_examples(ex, 3, seed=2, shuffle=shuffle,
                                              drop_remainder=drop))
    want = list(jax_pipeline.batches_from_examples(
        jex, 3, seed=2, shuffle=shuffle, drop_remainder=drop))
    assert len(got) == len(want) == (2 if drop else 3)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


@pytest.mark.parametrize("size,seed", [(128, 0), (512, 3)])
def test_synthetic_batch_matches_jax(size, seed):
    assert_batches_equal(pipeline.synthetic_batch(2, seed, size),
                         jax_pipeline.synthetic_batch(2, seed, size))


def test_prefetch_iterator_keeps_order_and_hands_errors_on():
    assert list(pipeline.PrefetchIterator(iter(range(20)), depth=2)) == \
        list(range(20))
    assert list(pipeline.PrefetchIterator(iter(()))) == []

    def broken():
        yield 1
        raise ValueError("source failed")

    it = pipeline.PrefetchIterator(broken())
    assert next(it) == 1
    with pytest.raises(ValueError, match="source failed"):
        next(it)


def test_load_csv_dataset_matches_jax(samples, tmp_path):
    port, _ = samples
    rows = ["Smiles,atoms_string,bonds_string,path"]
    for i, s in enumerate(port[:3]):
        raster.imwrite(str(tmp_path / f"{i}.png"), s.image)
        rows.append(f'{s.smiles},"{s.atoms_string}","{s.bonds_string}",'
                    f"{i}.png")
    csv_path = tmp_path / "dataset.csv"
    csv_path.write_text("\n".join(rows) + "\n")
    got = pipeline.load_csv_dataset(str(csv_path))
    want = jax_pipeline.load_csv_dataset(str(csv_path))
    assert len(got) == len(want) == 3
    for g, w, s in zip(got, want, port):
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.image, s.image)
        assert (g.atoms_string, g.bonds_string, g.smiles) == \
            (w.atoms_string, w.bonds_string, w.smiles) == \
            (s.atoms_string, s.bonds_string, s.smiles)


def test_device_preprocess_eval_matches_jax_and_noise_by_distribution():
    rng = np.random.default_rng(0)
    # ~6% ink, like a drawing; gray levels on both sides of the threshold
    img = np.where(rng.random((8, 256, 256)) < 0.06,
                   rng.integers(0, 153, (8, 256, 256)),
                   rng.integers(153, 256, (8, 256, 256))).astype(np.uint8)
    want = np.asarray(jax_pipeline.device_preprocess(
        jnp.asarray(img), jax.random.PRNGKey(0), train=False))
    t = torch.from_numpy(img)
    got = pipeline.device_preprocess(t, train=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 256, 256, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pipeline.device_preprocess(t, train=False,
                                      dtype=torch.bfloat16).dtype == \
        torch.bfloat16

    clean = got[..., 0] > 0
    gen = torch.Generator().manual_seed(4)
    noisy = pipeline.device_preprocess(t, amount=0.2, train=True,
                                       generator=gen)[..., 0] > 0
    jnoisy = np.asarray(jax_pipeline.device_preprocess(
        jnp.asarray(img), jax.random.PRNGKey(4), amount=0.2,
        train=True))[..., 0] > 0
    for out in (noisy.numpy(), jnoisy):     # the same bounds for both
        salt_rate = out[~clean.numpy()].mean()
        pepper_drop = 1.0 - out[clean.numpy()].mean()
        assert 0.0 < salt_rate < 0.004, salt_rate        # E ~ 0.001
        assert 0.02 < pepper_drop < 0.25, pepper_drop    # E ~ 0.1
    # bool in, bool out; the same generator state, the same mask
    again = pipeline._apply_noise(clean, 0.2,
                                  torch.Generator().manual_seed(4))
    assert again.dtype == torch.bool and torch.equal(again, noisy)
    flips = (noisy != clean).float().mean((1, 2))
    assert len({round(float(f), 6) for f in flips}) > 1   # per-image rates
