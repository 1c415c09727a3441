"""Peak decode of the torch port against abcnet_tpu/infer/decode.py (CPU).

Both sides get the same numpy logits/features. Every key, shape and
dtype of the peak dict must match; ints and bools are equal; floats are
within 1e-5 absolute: the sparse heads' window contraction is a matmul
in torch and an einsum in XLA (f32, different summation order), and
cos/sin come from different math libraries.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.data.encode import (encode_targets_np, parse_atoms_string,
                                    parse_bonds_string)
from abcnet_tpu.data.generate import generate_sample
from abcnet_tpu.infer import decode as jd
from abcnet_tpu.models.unet import UNet as FlaxUNet
from abcnet_tpu.utils.diagnostics import fake_logits_from_targets
from abcnet_tpu_torch.infer import decode as td
from torch_parity import (assert_peaks_equal, flax_variables, ink_images,
                          to_np, torch_model)

SMALL = jd.DecodeConfig(max_atoms=16, max_bonds=24)


def _random_preds(seed, b=2, g=32):
    rng = np.random.default_rng(seed)
    widths = {"atom_target": 1, "atom_type": 14, "atom_charge": 3,
              "atom_hs": 2, "bond_target": 1, "bond_type": 360,
              "bond_rho": 60, "bond_omega": 60}
    return {k: rng.normal(size=(b, g, g, w)).astype(np.float32)
            for k, w in widths.items()}


def _cfg(jcfg):
    return td.DecodeConfig(max_atoms=jcfg.max_atoms,
                           max_bonds=jcfg.max_bonds,
                           halo_margin=jcfg.halo_margin,
                           subcell=jcfg.subcell)


def _dense_both(preds, jcfg):
    want = jd.extract_peaks({k: jnp.asarray(v) for k, v in preds.items()},
                            jcfg)
    got = td.extract_peaks({k: torch.tensor(v) for k, v in preds.items()},
                           _cfg(jcfg))
    return want, got


@pytest.mark.parametrize("jcfg", [SMALL, jd.DecodeConfig(),
                                  jd.DecodeConfig(halo_margin=0.0,
                                                  subcell=False)],
                         ids=["small", "default", "no_halo_no_subcell"])
def test_dense_random_logits(jcfg):
    assert_peaks_equal(*_dense_both(_random_preds(7), jcfg))


def test_dense_perfect_logits():
    """Rendered molecules, encoded to targets, as 'perfect' logits at the
    full 128 grid: the decode the assembler sees in practice."""
    n = 0
    for seed in range(6):
        sample = generate_sample(random.Random(2000 + seed), mode="mixed")
        if sample is None:
            continue
        t = encode_targets_np(parse_atoms_string(sample.atoms_string),
                              parse_bonds_string(sample.bonds_string))
        preds = {k: np.asarray(v) for k, v in
                 fake_logits_from_targets(t).items()}
        assert_peaks_equal(*_dense_both(preds, jd.DecodeConfig()))
        n += 1
    assert n >= 4


@pytest.fixture(scope="module")
def forward128():
    """Snapshot weights, f32 forward of two 128x128 ink masks in Flax:
    (params, stats, dense preds, sparse-mode heatmaps, features)."""
    params, stats = flax_variables("snapshot")
    x = ink_images(2, 128, seed=3)
    var = {"params": params, "batch_stats": stats}
    net = FlaxUNet(dtype=jnp.float32)
    dense = net.apply(var, x, train=False)
    heat, feats = net.apply(var, x, train=False,
                            dense_heads=jd.DENSE_HEADS_SPARSE_MODE,
                            return_features=True)
    np_ = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return params, stats, np_(dense), np_(heat), np.asarray(feats)


def test_dense_on_forward(forward128):
    _, _, dense, _, _ = forward128
    assert_peaks_equal(*_dense_both(dense, jd.DecodeConfig()))


def _sparse_both(params, stats, heat, feats, jcfg):
    want = jd.extract_peaks_sparse(
        {k: jnp.asarray(v) for k, v in heat.items()}, jnp.asarray(feats),
        params, stats, jcfg, jnp.float32)
    heads = td.sparse_heads(torch_model(params, stats), torch.float32)
    got = td.extract_peaks_sparse(
        {k: torch.tensor(v) for k, v in heat.items()},
        torch.tensor(feats), heads, _cfg(jcfg), torch.float32)
    return want, got


@pytest.mark.parametrize("jcfg", [jd.DecodeConfig(),
                                  jd.DecodeConfig(halo_margin=0.0)],
                         ids=["default", "no_halo"])
def test_sparse_on_forward(forward128, jcfg):
    params, stats, _, heat, feats = forward128
    assert_peaks_equal(*_sparse_both(params, stats, heat, feats, jcfg))


def test_sparse_random_features():
    """Random trunk features and heatmaps on a random-init head set: peaks
    everywhere, borders included (the -inf halo masking)."""
    params, stats = flax_variables(13, size=64)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 16, 16, 128)).astype(np.float32)
    heat = {k: rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
            for k in jd.DENSE_HEADS_SPARSE_MODE}
    assert_peaks_equal(*_sparse_both(params, stats, heat, feats,
                                     jd.DecodeConfig(max_atoms=40,
                                                     max_bonds=48)))


def test_gather_windows_and_fused_heads(forward128):
    params, stats, _, _, feats = forward128
    xs = np.array([[0, 0, 31, 31, 5, 16], [1, 0, 31, 7, 13, 30]])
    ys = np.array([[0, 31, 0, 31, 9, 16], [3, 5, 31, 0, 21, 1]])
    want = jd.gather_windows(jnp.asarray(feats), jnp.asarray(xs),
                             jnp.asarray(ys), 1)
    got = td.gather_windows(torch.tensor(feats), torch.from_numpy(xs),
                            torch.from_numpy(ys), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fz_j = jd.fuse_head_params(params, stats, jd._BOND_HEAD_NAMES,
                               jd._BOND_HEAD_WIDTHS)
    fz_t = td.fuse_head_params(torch_model(params, stats),
                               td._BOND_HEAD_NAMES, td._BOND_HEAD_WIDTHS)
    for a, b in zip(td.apply_heads_fused(fz_t, got),
                    jd.apply_heads_fused(fz_j, want, jnp.float32)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_antipodal_and_subcell_match():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 5, 60)).astype(np.float32)
    w[0, 0, 10] = w[0, 0, 40] = 2.0             # an exact antipodal tie
    np.testing.assert_array_equal(
        td._antipodal_keep(torch.from_numpy(w)).numpy(),
        np.asarray(jd._antipodal_keep(jnp.asarray(w))))
    logit = rng.normal(size=(2, 16, 16)).astype(np.float32)
    xs = rng.integers(0, 16, (2, 7))
    ys = rng.integers(0, 16, (2, 7))
    xs[0, :2], ys[0, :2] = (0, 15), (15, 0)     # clamped borders
    np.testing.assert_allclose(
        td.subcell_offsets(torch.from_numpy(logit), torch.from_numpy(xs),
                           torch.from_numpy(ys)).numpy(),
        np.asarray(jd.subcell_offsets(jnp.asarray(logit), jnp.asarray(xs),
                                      jnp.asarray(ys))), rtol=0, atol=1e-6)


def test_pack_peaks_round_trip_matches_jax():
    preds = _random_preds(11)
    want, got = _dense_both(preds, SMALL)
    spec = td.peaks_spec(got)
    assert spec == jd.peaks_spec(want)
    ibuf, fbuf = td.pack_peaks(got)
    jibuf, jfbuf = jd.pack_peaks(want)
    assert ibuf.dtype == torch.int32 and fbuf.dtype == torch.float32
    np.testing.assert_array_equal(ibuf.numpy(), np.asarray(jibuf))
    np.testing.assert_allclose(fbuf.numpy(), np.asarray(jfbuf), rtol=0,
                               atol=1e-5)
    host = td.unpack_peaks_host(ibuf.numpy(), fbuf.numpy(), spec)
    ref = to_np(got)
    assert sorted(host) == sorted(ref)
    for k in ref:
        assert host[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(host[k], ref[k], err_msg=k)
