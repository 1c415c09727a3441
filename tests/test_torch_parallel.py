"""Data-parallel training of the torch port (parallel/mesh.py, the global
BatchNorm of models/unet.py, trainer under DDP) on the CPU.

  * Two gloo processes (RANK/WORLD_SIZE/MASTER_* in their environment, as
    torchrun sets them), batch 2 each, against one process at batch 4 on
    the same images and weights (the step-43100 snapshot), full model
    width at 64x64, f32, noise and dropout off: losses, gradients and
    BatchNorm running statistics after one `train_step`. Only the order
    of the sums differs. Tolerances: total and terms relative 1e-5;
    running statistics 1e-5 (+1e-5 relative: convolution outputs at
    batch 2 and 4 differ in their last bits, oneDNN blocks by batch, and
    a batch mean that nearly cancels keeps that error absolutely);
    gradients by the relative L2 error of each leaf, GRAD_LEAF, and of
    the whole tree, GRAD_TREE. Those are the f32 noise floor of a
    train-mode BatchNorm backward (tests/test_torch_trainer.py explains
    it), measured here: one process at batch 4 run with 1 thread instead
    of the default moves leaves by up to 1.6e-2 on this input, the two
    ranks sit at most 1.3e-2 from it. A fault of the plumbing (gradients
    averaged instead of summed, a BatchNorm backward without the global
    sums) shows at order 1. Leaves whose analytic gradient is zero (a
    conv bias before a batch-stat BN) hold rounding residue only and are
    held to 1e-3 of the largest leaf. The two ranks end bit-equal in
    gradients and statistics.
  * The global BatchNorm alone: forward and backward of two ranks against
    one F.batch_norm over the concatenated batch, 1e-5.
  * The same two ranks against the JAX package's `train_step` on a
    2-device mesh (conftest's virtual CPU devices): losses within 1e-4.
  * The mesh helpers: shard_batch rows and its divisibility check, and
    n_devices > 1 outside a process group raising.
"""

import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from abcnet_tpu_torch.models import UNet, from_flax, to_flax
from abcnet_tpu_torch.models.unet import OutConv
from abcnet_tpu_torch.parallel import Mesh, make_mesh, shard_batch
from abcnet_tpu_torch.train import trainer
from torch_parity import REPO, flax_variables, ink_images

SIZE = 64
BATCH = 4
REL = 1e-5
SOURCE = "snapshot"
GRAD_LEAF, GRAD_TREE = 3e-2, 1e-2

_WORKER = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "tests"))
from abcnet_tpu_torch.models.unet import OutConv
from abcnet_tpu_torch.parallel import init_distributed, shard_batch
import test_torch_parallel as T
torch.set_num_threads(2)
OutConv.DROP = 0.0
mesh = init_distributed("cpu")
assert mesh.world == 2 and mesh.rank == int(os.environ["RANK"])
batch = shard_batch(T.global_batch(), mesh)
out = T.one_step(batch, torch.load(sys.argv[2]), mesh)
if {bn!r}:
    out.update(T.bn_rank(mesh))
np.savez(sys.argv[1], **out)
torch.distributed.destroy_process_group()
"""


def global_batch():
    from abcnet_tpu_torch.data.pipeline import synthetic_batch
    b = synthetic_batch(BATCH, seed=0, size=SIZE)
    b["image_bits"] = np.packbits(ink_images(BATCH, SIZE, seed=0)[..., 0] > 0,
                                  axis=-1)
    return b


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def weights():
    return from_flax(*flax_variables(SOURCE, SIZE))


def one_step(host_batch, state_dict, mesh=None):
    """One f32 train_step (noise off) from `state_dict`; returns the
    losses, gradients and running statistics as a flat dict."""
    model = UNet(dtype=torch.float32)
    model.load_state_dict(state_dict)
    cfg = trainer.TrainConfig(dtype="float32", device="cpu",
                              batch_size=BATCH)
    state = trainer.create_state(cfg, model, mesh=mesh)
    _, total, losses, _ = trainer.train_step(
        state, trainer.to_device(host_batch, "cpu"), rng=0, amount=0.0,
        with_metrics=False)
    out = {"loss/total": float(total)}
    out.update({f"loss/{k}": float(v) for k, v in losses.items()})
    grads = to_flax({n: p.grad for n, p in model.named_parameters()})[0]
    out.update({f"grad/{k}": v for k, v in _flat(grads).items()})
    out.update({f"stat/{k}": v for k, v in
                _flat(to_flax(model.state_dict())[1]).items()})
    return out


def _bn_input():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(1.5, 2.0, (4, 8, 5, 5)).astype(
        np.float32))
    dy = torch.from_numpy(rng.normal(size=(4, 8, 5, 5)).astype(np.float32))
    return x, dy


def bn_rank(mesh):
    """The global BatchNorm on this rank's half of `_bn_input`: output,
    input gradient, weight/bias gradients and running statistics."""
    from abcnet_tpu_torch.models.unet import BatchNorm
    x, dy = _bn_input()
    half = x.shape[0] // mesh.world
    rows = slice(mesh.rank * half, (mesh.rank + 1) * half)
    bn = BatchNorm(8)
    bn.group = mesh.group
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 8))
        bn.bias.copy_(torch.linspace(-1, 1, 8))
    xr = x[rows].clone().requires_grad_(True)
    y = bn.train()(xr)
    y.backward(dy[rows])
    return {"bn/y": y.detach().numpy(), "bn/dx": xr.grad.numpy(),
            "bn/dw": bn.weight.grad.numpy(), "bn/db": bn.bias.grad.numpy(),
            "bn/mean": bn.running_mean.numpy(),
            "bn/var": bn.running_var.numpy()}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Outputs of the two gloo ranks, [rank 0, rank 1]."""
    tmp = tmp_path_factory.mktemp("ranks")
    torch.save(weights(), tmp / "weights.pt")
    port = _free_port()
    code = _WORKER.format(repo=REPO, bn=True)
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "2"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / f"rank{rank}.npz"),
             str(tmp / "weights.pt")],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def single(monkeypatch_module):
    monkeypatch_module.setattr(OutConv, "DROP", 0.0)
    return one_step(global_batch(), weights())


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_two_ranks_train_like_one_process(two_ranks, single):
    r0, r1 = two_ranks
    for k in [k for k in single if k.startswith("grad/") or
              k.startswith("stat/")]:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    losses = [k for k in single if k.startswith("loss/")]
    assert len(losses) == 9
    for k in losses:
        np.testing.assert_allclose(r0[k], single[k], rtol=REL, atol=1e-7,
                                   err_msg=k)
    stats = [k for k in single if k.startswith("stat/")]
    assert len(stats) == 2 * 34
    for k in stats:
        np.testing.assert_allclose(r0[k], single[k], rtol=REL, atol=1e-5,
                                   err_msg=k)
    grads = [k for k in single if k.startswith("grad/")]
    norms = {k: float(np.linalg.norm(single[k])) for k in grads}
    top = max(norms.values())
    for k in grads:
        err = float(np.linalg.norm(r0[k] - single[k]))
        if norms[k] > 1e-3 * top:
            assert err <= GRAD_LEAF * norms[k], (k, err / norms[k])
        else:
            assert err <= 1e-3 * top, (k, err, top)
    whole = np.sqrt(sum(float(np.sum((r0[k] - single[k]) ** 2))
                        for k in grads))
    assert whole <= GRAD_TREE * np.sqrt(sum(n * n for n in norms.values()))


def test_global_batchnorm_matches_one_batch(two_ranks):
    x, dy = _bn_input()
    w = torch.linspace(0.5, 1.5, 8).requires_grad_(True)
    b = torch.linspace(-1, 1, 8).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y = torch.nn.functional.batch_norm(xr, None, None, w, b, True, 0.0,
                                       1e-5)
    y.backward(dy)
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    for r, half in zip(two_ranks, (slice(0, 2), slice(2, 4))):
        np.testing.assert_allclose(r["bn/y"], y.detach()[half].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["bn/dx"], xr.grad[half].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["bn/mean"], 0.1 * mean.numpy(),
                                   rtol=1e-5, atol=1e-6)
        # Flax's update: the biased variance.
        np.testing.assert_allclose(r["bn/var"], 0.9 + 0.1 * var.numpy(),
                                   rtol=1e-5, atol=1e-6)
    # weight/bias gradients are per-rank sums; the trainer adds them up
    np.testing.assert_allclose(two_ranks[0]["bn/dw"] + two_ranks[1]["bn/dw"],
                               w.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(two_ranks[0]["bn/db"] + two_ranks[1]["bn/db"],
                               b.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_two_ranks_match_jax_mesh_train_step(two_ranks):
    """The JAX package's SPMD train_step over a 2-device data mesh, noise
    and dropout off: the global batch's losses within 1e-4."""
    import flax.linen
    import jax
    import jax.numpy as jnp

    from abcnet_tpu.models.unet import UNet as FlaxUNet
    from abcnet_tpu.parallel import make_mesh as jax_mesh
    from abcnet_tpu.parallel import replicate_tree
    from abcnet_tpu.parallel import shard_batch as jax_shard
    from abcnet_tpu.train import trainer as jt

    params, stats = flax_variables(SOURCE, SIZE)
    cfg = jt.TrainConfig(dtype="float32", batch_size=BATCH)
    tx = jt.make_optimizer(cfg)
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=tx.init(params),
                          tx=tx, apply_fn=FlaxUNet(dtype=jnp.float32).apply)
    mesh = jax_mesh(2)
    identity = lambda self, inputs, *a, **k: inputs  # noqa: E731
    with mock.patch.object(flax.linen.Dropout, "__call__", identity):
        _, total, losses, _ = jt.train_step(
            replicate_tree(state, mesh), jax_shard(global_batch(), mesh),
            jax.random.PRNGKey(0), amount=0.0, with_metrics=False)
    got = two_ranks[0]
    np.testing.assert_allclose(got["loss/total"], float(total), rtol=1e-4)
    for k, v in losses.items():
        np.testing.assert_allclose(got[f"loss/{k}"], float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_shard_batch_rows_and_mesh_outside_a_group():
    b = {"x": np.arange(12).reshape(6, 2)}
    mesh = Mesh((torch.device("cpu"),) * 1, rank=1, world=3)
    np.testing.assert_array_equal(shard_batch(b, mesh)["x"], b["x"][2:4])
    with pytest.raises(ValueError, match="divide"):
        shard_batch({"x": np.zeros((4, 1))}, mesh)
    assert len(make_mesh(3, "cpu").devices) == 3
    with pytest.raises(RuntimeError, match="data-parallel"):
        trainer.create_state(trainer.TrainConfig(device="cpu", n_devices=2))
