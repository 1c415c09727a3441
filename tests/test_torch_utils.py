"""The torch port's host utilities against abcnet_tpu's, on the CPU: Otsu
(the numpy copy and the tensor version against otsu_threshold and
otsu_threshold_jax), the perfect logits of a fixture molecule
(equal to the JAX package's, exact) and the viz overlays (equal images),
and torch.profiler's chrome trace."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.data import binarize as jb
from abcnet_tpu.utils import diagnostics as jdiag
from abcnet_tpu.utils import viz as jviz
from abcnet_tpu_torch.data import binarize
from abcnet_tpu_torch.utils import diagnostics, profiling, viz
from torch_parity import FIXTURE, fixture_samples


def _images():
    z = np.load(FIXTURE)
    rng = np.random.default_rng(0)
    gray = rng.normal(120, 40, (64, 64)).clip(0, 255).astype(np.uint8)
    return [z["images"][0], z["images"][40], gray,
            np.full((8, 8), 7, np.uint8)]


@pytest.mark.parametrize("which", range(4))
def test_otsu_matches_jax(which):
    img = _images()[which]
    want = jb.otsu_threshold(img)
    assert binarize.otsu_threshold(img) == want
    np.testing.assert_array_equal(binarize.binarize_otsu(img),
                                  jb.binarize_otsu(img))
    got = binarize.otsu_threshold_torch(torch.from_numpy(img))
    assert int(got) == int(jb.otsu_threshold_jax(jnp.asarray(img)))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


@pytest.fixture(scope="module")
def sample():
    return fixture_samples([3])[0]


def test_perfect_logits_match_jax(sample):
    want = jdiag.perfect_logits_production(sample)
    got = diagnostics.perfect_logits_production(sample)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert float(got["atom_target"].max()) == 5.0


def test_viz_overlays_match_jax(sample, tmp_path):
    from abcnet_tpu_torch.data.encode import (encode_targets_np,
                                              parse_atoms_string,
                                              parse_bonds_string)
    t = encode_targets_np(parse_atoms_string(sample.atoms_string),
                          parse_bonds_string(sample.bonds_string))
    img = viz.overlay_targets(sample.image, t, str(tmp_path / "t.png"))
    np.testing.assert_array_equal(img, jviz.overlay_targets(sample.image, t))
    assert (img == [255, 0, 0]).all(-1).any()
    assert (img == [0, 200, 0]).all(-1).any()
    assert (tmp_path / "t.png").exists()

    peaks = {"atom_xy": np.array([[[10, 12], [40, 40]]], np.int32),
             "atom_valid": np.array([[True, False]]),
             "bond_xy": np.array([[[20, 20]]], np.int32),
             "bond_delta": np.array([[[3.0, -2.0]]], np.float32),
             "bond_valid": np.array([[True]])}
    np.testing.assert_array_equal(viz.overlay_peaks(sample.image, peaks, 0),
                                  jviz.overlay_peaks(sample.image, peaks, 0))
