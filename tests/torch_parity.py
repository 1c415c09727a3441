"""Shared helpers of the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU (tests/conftest.py) and data crosses as numpy arrays.
"""

import os
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "snapshots", "r5_latest.npz")
FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                       "smoke_step43100.npz")
TRAIN_FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                             "train_step43100.npz")


@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (the kernels have no
    CPU mode, their plain versions are tested on the CPU instead)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def flax_variables(source="snapshot", size=128):
    """(params, batch_stats) numpy f32 trees of the production UNet:
    the committed snapshot ("snapshot"), another snapshot file (a path
    to an .npz), or a random Flax init from the integer seed `source`."""
    import jax
    import jax.numpy as jnp

    from abcnet_tpu.models.unet import UNet, init_unet

    ref = init_unet(jax.random.PRNGKey(0 if isinstance(source, str)
                                       else source),
                    UNet(dtype=jnp.float32), (1, size, size, 1))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    if not isinstance(source, str):
        return ref["params"], ref["batch_stats"]
    from abcnet_tpu_torch.models.weights import _unflatten
    z = np.load(SNAPSHOT if source == "snapshot" else source)
    tree = _unflatten({k: z[k] for k in z.files if k != "__step__"})
    like = lambda s, r: np.asarray(s, np.float32).reshape(r.shape)  # noqa: E731
    return (jax.tree_util.tree_map(like, tree["params"], ref["params"]),
            jax.tree_util.tree_map(like, tree["batch_stats"],
                                   ref["batch_stats"]))


def torch_model(params, stats, dtype=torch.float32):
    from abcnet_tpu_torch.models import UNet, from_flax
    model = UNet(dtype=dtype)
    model.load_state_dict(from_flax(params, stats))
    return model.eval()


def jax_state(params, stats):
    """The fields of a TrainState that the JAX serving pipeline reads."""
    import jax.numpy as jnp

    from abcnet_tpu.models.unet import UNet
    return types.SimpleNamespace(apply_fn=UNet(dtype=jnp.float32).apply,
                                 params=params, batch_stats=stats)


def fixture_samples(rows):
    """Fixture molecules `rows` as the port's raw Samples."""
    from abcnet_tpu_torch.data.pipeline import Sample
    z, lab = np.load(FIXTURE), np.load(TRAIN_FIXTURE)
    return [Sample(z["images"][i], str(lab["atoms_string"][i]),
                   str(lab["bonds_string"][i]), str(lab["smiles"][i]))
            for i in rows]


def label_batch(rows):
    """The collated compact labels (and packed drawings) of fixture
    molecules `rows`, un-augmented."""
    import random

    from abcnet_tpu_torch.data import pipeline
    rng = random.Random(0)
    return pipeline.collate([pipeline.sample_to_example(s, rng, train=False)
                             for s in fixture_samples(rows)])


def ink_images(b, size, seed):
    """{0, 1} float32 NHWC masks: ~6% ink, like rendered drawings."""
    rng = np.random.default_rng(seed)
    return (rng.random((b, size, size, 1)) < 0.06).astype(np.float32)


def packed_bits(kind, b=2):
    """(b, 512, 64) packed rows: random bytes, all zero or all 0xFF."""
    if kind == "random":
        rng = np.random.default_rng(0)
        return rng.integers(0, 256, (b, 512, 64), dtype=np.uint8)
    return np.full((b, 512, 64), 0 if kind == "zeros" else 0xFF, np.uint8)


def plateau_map():
    m = np.full((1, 32, 32), -5.0, np.float32)
    m[0, 4:6, 4:6] = 2.0            # plateau: all four survive
    m[0, 20, 20] = -1.0             # exactly threshold: dropped
    m[0, 10, 25] = 7.0              # isolated peak
    return m


def edge_map():
    m = np.zeros((1, 32, 32), np.float32)
    m[0, 0, 0], m[0, 0, 31], m[0, 31, 31] = 3.0, 4.0, 5.0
    return m


def random_maps(shape):
    return np.random.default_rng(0).normal(size=shape).astype(np.float32) * 3


def band_seams_map():
    """128x128, background -5. The CUDA kernel cuts a map into bands of 32
    rows: 2x2 plateaus and pairs of equal isolated peaks straddle the
    seams at rows 31/32, 63/64 and 95/96, peaks sit on the seam rows in
    the first and last column, and a higher cell just across a seam
    suppresses a candidate on the other side."""
    m = np.full((2, 128, 128), -5.0, np.float32)
    for b in range(2):
        for n, seam in enumerate((32, 64, 96)):
            c = 10 + 30 * n + b
            m[b, seam - 1:seam + 1, c:c + 2] = 2.0 + n      # plateau
            m[b, seam - 1, c + 8] = m[b, seam + 1, c + 8] = 1.5    # equal
            m[b, seam - 1, 0] = m[b, seam, 127] = 4.0 + n   # edge columns
            m[b, seam, 0 + 3] = 3.0                         # on a seam row
            m[b, seam - 1, 60], m[b, seam, 61] = 0.5, 0.75  # suppressed
    return m


def dense_band_map():
    """More than K isolated peaks in rows 0-31, three stronger elsewhere."""
    rng = np.random.default_rng(1)
    m = np.full((2, 128, 128), -5.0, np.float32)
    m[:, 0:32:2, 0:128:2] = rng.uniform(0, 4, (2, 16, 64)).astype(np.float32)
    m[:, 40, 40], m[:, 70, 5], m[:, 127, 127] = 9.0, 8.0, 7.0
    return m


def ties_across_bands_map():
    """One score at cells of every band: the slots order by index."""
    m = np.full((1, 128, 128), -5.0, np.float32)
    for r, c in ((120, 3), (5, 100), (64, 64), (33, 0), (31, 127), (96, 7),
                 (5, 2), (70, 90)):
        m[0, r, c] = 1.25
    m[0, 50, 50] = 6.0
    return m


def late_band_only_map():
    """Fewer than K survivors, all in the last rows: the exhausted slots
    take the cells at the top of the map."""
    m = np.full((2, 128, 128), -5.0, np.float32)
    m[:, 100:128:3, 1:128:9] = np.random.default_rng(2).uniform(
        0, 3, (2, 10, 15)).astype(np.float32)
    m[:, 0, 0] = -1.0                  # at the threshold: dropped
    return m


# NMS/top-K cases, those of tests/test_pallas_peaks.py plus exhausted and
# all-survivor maps, maps that try the seams between the CUDA kernel's
# bands of rows, and shapes that take its scalar route: name -> (make
# maps, k, threshold).
NMS_CASES = {
    "random_small": (lambda: random_maps((3, 32, 32)), 16, -1.0),
    "random_full": (lambda: random_maps((2, 128, 128)), 128, -1.0),
    "plateau_threshold": (plateau_map, 8, -1.0),
    "edges": (edge_map, 4, 0.5),
    "exhausted": (lambda: np.full((2, 16, 16), -3.0, np.float32), 12, -1.0),
    "constant": (lambda: np.zeros((1, 16, 16), np.float32), 40, -1.0),
    "band_seams": (band_seams_map, 128, -1.0),
    "dense_band": (dense_band_map, 128, -1.0),
    "ties_across_bands": (ties_across_bands_map, 160, -1.0),
    "late_band_only": (late_band_only_map, 160, -1.0),
    "odd_shape": (lambda: random_maps((2, 20, 28)), 24, -1.0),
    "k_equals_n": (lambda: random_maps((2, 8, 8)), 64, -1.0),
}


def to_np(d):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in d.items()}


def assert_peaks_equal(want, got, atol=1e-5):
    """Same keys, shapes and dtypes; ints and bools equal; floats within
    `atol` (f32 reassociation between XLA and PyTorch)."""
    want, got = to_np(want), to_np(got)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].shape == got[k].shape, k
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype,
                                               got[k].dtype)
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
