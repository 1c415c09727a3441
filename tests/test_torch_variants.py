"""The model options and families of the torch port against abcnet_tpu on
the CPU, full width, 64x64 inputs, f32, eval mode unless stated:

  * UNet(fused_head_bank=True) on fuse_head_variables of a Flax init
    against the Flax fused model, and against the per-head port model on
    the unfused weights; the port's fuse/unfuse against the JAX
    package's and their round trip (exact);
  * remat_blocks (every block and the heads) in train mode, dropout on:
    outputs, gradients and running statistics equal bit for bit to the
    model without remat; its forward against the Flax remat model;
  * space_to_depth against the JAX function for C = 3; UNetS2D against
    UNetS2D.apply; the S2D model through the sparse serving pipeline of
    both packages (integer peaks equal, floats within FLOAT_ATOL);
  * UNetCBAM: 11,177,340 parameters, the forward against UNetCBAM.apply
    on weights drawn from np.random.default_rng on both sides, and a
    train step through the trainer.

Forward tolerance: FWD_ATOL = 1e-4 on logits, the f32 convolution order
of two frameworks (tests/test_torch_model.py holds the production model
to the same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.models.fuse_heads import fuse_head_variables as jax_fuse
from abcnet_tpu.models.unet import UNet as FlaxUNet
from abcnet_tpu.models.unet_cbam import UNetCBAM as FlaxCBAM
from abcnet_tpu.models.unet_s2d import UNetS2D as FlaxS2D
from abcnet_tpu.models.unet_s2d import space_to_depth as jax_s2d
from abcnet_tpu_torch.models import (UNet, UNetCBAM, UNetS2D, from_flax,
                                     model_for_tree, param_count,
                                     space_to_depth, to_flax)
from abcnet_tpu_torch.models.fuse_heads import (fuse_head_variables,
                                                unfuse_head_variables)
from torch_parity import flax_variables, ink_images

SIZE = 64
FWD_ATOL = 1e-4
FLOAT_ATOL = 2e-4          # peak-dict floats, as tests/test_torch_slice.py


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_tree(flax_model, seed):
    """Variables of `flax_model` in its tree layout, drawn with numpy: conv
    and dense kernels N(0, 2/fan_in), biases N(0, 0.05), BN scales near 1,
    means near 0, variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: flax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, SIZE, SIZE, 1)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:                       # bias, mean, s
            v = rng.normal(0, 0.05, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _x(b=2):
    return ink_images(b, SIZE, seed=4)


def _assert_heads(got, want, atol=FWD_ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def prod():
    return flax_variables(7, SIZE)


def test_fused_head_bank_matches_flax_and_per_head(prod):
    params, stats = prod
    fused = _np(jax_fuse({"params": params, "batch_stats": stats}))
    mine = fuse_head_variables({"params": params, "batch_stats": stats})
    flat_a = jax.tree_util.tree_leaves_with_path(fused)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(mine))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(flat_b[path], v)

    model = model_for_tree(mine["params"])
    assert model.fused_head_bank and param_count(model) == 10_698_575
    model.load_state_dict(from_flax(mine["params"], mine["batch_stats"]))
    x = _x()
    want = FlaxUNet(fused_head_bank=True).apply(fused, jnp.asarray(x),
                                                train=False)
    got = model.eval()(torch.from_numpy(x))
    _assert_heads(got, want)
    per_head = UNet()
    per_head.load_state_dict(from_flax(params, stats))
    _assert_heads(got, {k: v.detach().numpy() for k, v in
                        per_head.eval()(torch.from_numpy(x)).items()}, 1e-5)
    # the npz layout both ways
    back = unfuse_head_variables(
        {"params": to_flax(model.state_dict())[0],
         "batch_stats": to_flax(model.state_dict())[1]})
    for (path, v), (_, w) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(back), key=str),
            sorted(jax.tree_util.tree_leaves_with_path(
                {"params": params, "batch_stats": stats}), key=str)):
        np.testing.assert_array_equal(v, w, err_msg=str(path))
    with pytest.raises(ValueError, match="unfuse"):
        model.head("atom_type")


@pytest.mark.parametrize("fused", [False, True], ids=["per_head", "fused"])
def test_remat_blocks_change_nothing(prod, fused):
    params, stats = prod
    tree = {"params": params, "batch_stats": stats}
    if fused:
        tree = fuse_head_variables(tree)
    sd = from_flax(tree["params"], tree["batch_stats"])
    blocks = UNet.BLOCKS + ("heads",)
    x = torch.from_numpy(_x())
    results = []
    for remat in ((), blocks):
        model = UNet(fused_head_bank=fused, remat_blocks=remat)
        model.load_state_dict(sd)
        model.train()
        out = model(x, generator=torch.Generator().manual_seed(3))
        loss = sum((v.float() ** 2).mean() for v in out.values())
        loss.backward()
        results.append((out, {n: p.grad for n, p in
                              model.named_parameters()},
                        {n: b.clone() for n, b in model.named_buffers()}))
    (out_a, grad_a, buf_a), (out_b, grad_b, buf_b) = results
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), k
    for k in grad_a:
        if grad_a[k] is None:               # `s` feeds no output
            assert grad_b[k] is None, k
        else:
            assert torch.equal(grad_a[k], grad_b[k]), k
    for k in buf_a:
        assert torch.equal(buf_a[k], buf_b[k]), k
    with pytest.raises(ValueError, match="remat_blocks"):
        UNet(remat_blocks=("nope",))


def test_remat_forward_matches_flax_remat(prod):
    params, stats = prod
    blocks = ("inc1", "inc2", "down1", "up3", "dconv1", "heads")
    model = UNet(remat_blocks=blocks)
    model.load_state_dict(from_flax(params, stats))
    x = _x()
    want = FlaxUNet(remat_blocks=blocks).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False)
    _assert_heads(model.eval()(torch.from_numpy(x)), want)


def test_space_to_depth_matches_jax_for_several_channels():
    x = np.random.default_rng(0).normal(size=(2, 8, 12, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_s2d(jnp.asarray(x))))


@pytest.fixture(scope="module")
def s2d_vars():
    return _np(_random_tree(FlaxS2D(), seed=11))


def test_s2d_forward_and_sparse_serving_match_jax(s2d_vars):
    from abcnet_tpu.infer.decode import make_infer_pipeline as jax_pipeline
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline

    model = model_for_tree(s2d_vars["params"])
    assert isinstance(model, UNetS2D)
    model.load_state_dict(from_flax(s2d_vars["params"],
                                    s2d_vars["batch_stats"]))
    model.eval()
    x = _x()
    want = FlaxS2D().apply(s2d_vars, jnp.asarray(x), train=False)
    _assert_heads(model(torch.from_numpy(x)), want)

    class State:
        apply_fn = FlaxS2D(dtype=jnp.float32).apply
        params = s2d_vars["params"]
        batch_stats = s2d_vars["batch_stats"]

    images = np.where(x[..., 0] > 0, 0, 255).astype(np.uint8)
    want = jax_pipeline(State)(images)
    got = make_infer_pipeline(model, "cpu")(images)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k], w, atol=FLOAT_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def cbam_vars():
    return _np(_random_tree(FlaxCBAM(), seed=12))


def test_cbam_forward_matches_jax(cbam_vars):
    model = model_for_tree(cbam_vars["params"])
    assert isinstance(model, UNetCBAM)
    assert param_count(model) == 11_177_340
    model.load_state_dict(from_flax(cbam_vars["params"],
                                    cbam_vars["batch_stats"]))
    x = _x()
    want = FlaxCBAM().apply(cbam_vars, jnp.asarray(x), train=False)
    got = model.eval()(torch.from_numpy(x))
    assert all(v.dtype == torch.float32 for v in got.values())
    _assert_heads(got, want)
    back = to_flax(model.state_dict())
    for (path, v), (_, w) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(
                {"params": back[0], "batch_stats": back[1]}), key=str),
            sorted(jax.tree_util.tree_leaves_with_path(cbam_vars),
                   key=str)):
        np.testing.assert_array_equal(v, w, err_msg=str(path))


def test_cbam_trains_through_the_trainer():
    from abcnet_tpu_torch.data.pipeline import synthetic_batch
    from abcnet_tpu_torch.train import trainer

    cfg = trainer.TrainConfig(dtype="float32", device="cpu", batch_size=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UNetCBAM()
    state = trainer.create_state(cfg, model=model)
    batch = trainer.to_device(synthetic_batch(2, seed=0, size=SIZE), "cpu")
    _, total, losses, _ = trainer.train_step(state, batch, rng=1,
                                             with_metrics=False)
    assert state.step == 1 and np.isfinite(float(total))
    assert all(np.isfinite(float(v)) for v in losses.values())
