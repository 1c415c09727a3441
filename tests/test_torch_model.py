"""Port's UNet (abcnet_tpu_torch/models) against the Flax UNet on the CPU.

Tolerance: 1e-4 absolute on every head and on the trunk features of an
f32 forward. Both sides compute in f32, but XLA's and oneDNN's
convolutions sum in different orders, and BN is (x - mean) * rsqrt(var
+ eps) in Flax but x * (w / sqrt(var + eps)) + shift in torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.models.unet import UNet as FlaxUNet
from abcnet_tpu.models.unet import Up as FlaxUp
from abcnet_tpu_torch.models import UNet, from_flax, load_snapshot, \
    param_count
from abcnet_tpu_torch.models.unet import Up
from torch_parity import SNAPSHOT, flax_variables, ink_images, torch_model

ATOL = 1e-4


def test_param_count():
    assert param_count(UNet()) == 10_698_575


def test_load_snapshot_upcasts_to_f32():
    model, step = load_snapshot(SNAPSHOT, device="cpu")
    assert step == 43100
    assert not model.training
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in model.buffers())


@pytest.mark.parametrize("x_hw,skip_hw", [(5, 10), (5, 12), (4, 9)])
def test_up_block_matches_flax(x_hw, skip_hw):
    """Pins the transposed-conv weight mapping (spatial flip) and the
    crop/pad to the skip: 2H+1 = 11 cropped to 10 (leading row/col
    dropped), padded to 12, and 9 kept."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, x_hw, x_hw, 16)).astype(np.float32)
    skip = rng.normal(size=(2, skip_hw, skip_hw, 8)).astype(np.float32)
    block = FlaxUp(16, 8, dtype=jnp.float32)
    var = block.init(jax.random.PRNGKey(2), x, skip, False)
    var = jax.tree_util.tree_map(np.asarray, var)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        var["batch_stats"])
    want = np.asarray(block.apply({"params": var["params"],
                                   "batch_stats": stats}, x, skip, False))
    up = Up(16, 8, skip=8)
    up.load_state_dict(from_flax(var["params"], stats))
    up.eval()
    with torch.no_grad():
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(skip).permute(0, 3, 1, 2), torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("source", ["snapshot", 5])
def test_forward_matches_flax(source):
    params, stats = flax_variables(source)
    x = ink_images(2, 128, seed=3)
    heads, feats = FlaxUNet(dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, x, train=False,
        return_features=True)
    model = torch_model(params, stats)
    with torch.no_grad():
        got, got_feats = model(torch.from_numpy(x), return_features=True)
    assert sorted(got) == sorted(heads)
    for k in heads:
        assert tuple(got[k].shape) == heads[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(heads[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got_feats.numpy(), np.asarray(feats),
                               rtol=0, atol=ATOL)


def test_dense_heads_subset_matches_full():
    params, stats = flax_variables(7)
    model = torch_model(params, stats)
    x = torch.from_numpy(ink_images(1, 64, seed=4))
    with torch.no_grad():
        full = model(x)
        sub, feats = model(x, dense_heads=("atom_target", "bond_target"),
                           return_features=True)
    assert sorted(sub) == ["atom_target", "bond_target"]
    assert tuple(feats.shape) == (1, 16, 16, 128)
    for k in sub:
        assert torch.equal(sub[k], full[k])


def test_bf16_compute_path():
    """bf16 follows the JAX dtype path: conv in bf16 on f32 master
    weights, heads come out in bf16, and stay near the f32 forward."""
    params, stats = flax_variables(9)
    m32 = torch_model(params, stats)
    m16 = torch_model(params, stats, dtype=torch.bfloat16)
    x = torch.from_numpy(ink_images(1, 64, seed=5))
    with torch.no_grad():
        a, b = m32(x), m16(x)
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    for k in a:
        assert b[k].dtype == torch.bfloat16
        scale = float(a[k].abs().max()) + 1.0
        assert float((a[k] - b[k].float()).abs().max()) < 0.1 * scale, k
