"""The port's train-mode BatchNorm -> activation -> cast op
(abcnet_tpu_torch/ops/bn_act.py) on the CPU, where it runs its plain
version.

  * `bn_act_plain` against the chain it replaced in models/unet.py,
    `act(F.batch_norm(x.float(), zeros, zeros, w, b, True, 1.0,
    eps)).to(dtype)` under autograd: outputs, batch mean and biased
    variance, dx, dweight and dbias bit-equal, for each activation, in f32
    and bf16, on odd shapes.
  * Against the JAX package's flax.linen.BatchNorm(momentum=0.9,
    dtype=f32) -> activation -> astype (abcnet_tpu/models/unet.py:41-48):
    outputs, gradients and the running statistics `BatchNorm.act` moves,
    f32, relative 1e-5 (only the order of f32 sums differs).
  * What a train-mode forward of the production UNet(dtype=bf16) at 256²,
    batch 1, keeps for its backward (storages seen by
    torch.autograd.graph.saved_tensors_hooks, each counted once): at most
    100 MB, at most 1 MB of it f32 (per-channel vectors only). The chain
    it replaced kept 181.7 MB, 116.0 MB of it f32.
  * Under remat the running statistics move once.
  * Two gloo ranks: `bn_act(group=...)` on each half of a batch against
    one process on the whole batch, the tolerance of
    tests/test_torch_parallel.py's global BatchNorm test (1e-5).
  * The kernel entry points raise on a CPU tensor; an unknown activation
    raises.
"""

import collections
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from abcnet_tpu_torch.models import UNet
from abcnet_tpu_torch.models.unet import BN_EPS, BatchNorm
from abcnet_tpu_torch.ops import bn_act as ops
from abcnet_tpu_torch.ops.bn_act import ACTS, bn_act, bn_act_plain
from torch_parity import REPO

SHAPES = [(3, 5, 7, 9), (2, 3, 1, 13)]
DTYPES = [torch.float32, torch.bfloat16]
TORCH_ACT = {"relu": F.relu, "none": lambda t: t,
             "leaky_relu": lambda t: F.leaky_relu(t, 0.01)}
JAX_ACT = {"relu": jax.nn.relu, "none": lambda t: t,
           "leaky_relu": lambda t: jax.nn.leaky_relu(t, 0.01)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.7, 2.0, shape).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    c = shape[1]
    w = np.linspace(0.5, 1.5, c).astype(np.float32)
    b = np.linspace(-1.0, 1.0, c).astype(np.float32)
    return x, dy, w, b


def _chain(x, w, b, eps, act):
    """The op sequence models/unet.py ran before bn_act."""
    c = x.shape[1]
    mean, var = torch.zeros(c), torch.zeros(c)
    out = F.batch_norm(x.float(), mean, var, w, b, True, 1.0, eps)
    n = x.numel() // c
    return TORCH_ACT[act](out).to(x.dtype), mean, var * ((n - 1) / n)


def _run(fn, x, dy, w, b, act, dtype):
    x = torch.from_numpy(x).to(dtype).requires_grad_(True)
    w = torch.from_numpy(w).requires_grad_(True)
    b = torch.from_numpy(b).requires_grad_(True)
    y, mean, var = fn(x, w, b, BN_EPS, act)
    y.backward(torch.from_numpy(dy).to(dtype))
    return y.detach(), mean, var, x.grad, w.grad, b.grad


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_plain_is_the_chain_bit_for_bit(act, dtype, shape):
    x, dy, w, b = _inputs(shape)
    want = _run(_chain, x, dy, w, b, act, dtype)
    for fn in (bn_act_plain, bn_act):          # bn_act: plain on the CPU
        got = _run(fn, x, dy, w, b, act, dtype)
        names = ("y", "mean", "var", "dx", "dweight", "dbias")
        for name, g, v in zip(names, got, want):
            assert g.dtype == v.dtype and torch.equal(g, v), (fn, name)
    assert got[0].dtype == dtype and got[3].dtype == dtype


@pytest.mark.parametrize("act", sorted(ACTS))
def test_matches_flax_batchnorm_and_its_running_statistics(act):
    x, dy, w, b = _inputs((4, 6, 5, 7), seed=1)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))     # noqa: E731
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=BN_EPS, dtype=jnp.float32)
    variables = bn.init(jax.random.PRNGKey(0), nhwc(x))
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}

    def f(xx, p):
        out, upd = bn.apply({"params": p,
                             "batch_stats": variables["batch_stats"]}, xx,
                            mutable=["batch_stats"])
        return JAX_ACT[act](out).astype(jnp.float32), upd

    y_j, vjp, upd = jax.vjp(f, nhwc(x), params, has_aux=True)
    dx_j, dp_j = vjp(nhwc(dy))

    layer = BatchNorm(6, BN_EPS, 0.1).train()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer.act(xt, act, torch.float32)
    y.backward(torch.from_numpy(dy))

    def close(got, want, what):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=what)

    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    close(y.detach().numpy(), to_nchw(y_j), "y")
    close(xt.grad.numpy(), to_nchw(dx_j), "dx")
    close(layer.weight.grad.numpy(), dp_j["scale"], "dscale")
    close(layer.bias.grad.numpy(), dp_j["bias"], "dbias")
    close(layer.running_mean.numpy(), upd["batch_stats"]["mean"], "mean")
    close(layer.running_var.numpy(), upd["batch_stats"]["var"], "var")


def _saved_bytes(model, x):
    """{dtype: bytes} of the storages a train-mode forward keeps for its
    backward, each storage counted once."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = (s.nbytes(), t.dtype)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x, generator=torch.Generator().manual_seed(0))
    out = collections.Counter()
    for nbytes, dtype in seen.values():
        out[dtype] += nbytes
    return out


def test_production_unet_keeps_only_bf16_activations():
    torch.manual_seed(0)
    model = UNet(dtype=torch.bfloat16).train()
    x = (torch.rand(1, 256, 256, 1) > 0.9).float()
    saved = _saved_bytes(model, x)
    total = sum(saved.values())
    assert total <= 100e6, {str(k): v for k, v in saved.items()}
    assert saved[torch.float32] <= 1e6, saved[torch.float32]
    # what is left: the bf16 conv inputs and outputs, the max-pool indices
    assert saved[torch.bfloat16] > 0.9 * (total - saved[torch.int64])


def test_remat_moves_the_running_statistics_once():
    heads = (1, 2)
    x = torch.from_numpy((np.random.default_rng(3).random((2, 32, 32, 1))
                          > 0.8).astype(np.float32))
    stats = []
    for remat in ((), UNet.BLOCKS + ("heads",)):
        torch.manual_seed(0)
        model = UNet(heads=heads, remat_blocks=remat).train()
        out = model(x, generator=torch.Generator().manual_seed(1))
        sum(v.float().square().mean() for v in out.values()).backward()
        stats.append({k: v.clone() for k, v in model.named_buffers()})
    plain, remat = stats
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k
    # once: from the initial (0, 1), 0.1 of the batch's moments
    torch.manual_seed(0)
    fresh = UNet(heads=heads).train()
    conv = fresh.inc1.conv0
    first = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                     padding=1)
    var, mean = torch.var_mean(first, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(remat["inc1.bn0.running_mean"], 0.1 * mean,
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(remat["inc1.bn0.running_var"],
                               0.9 + 0.1 * var, rtol=1e-5, atol=1e-7)


_WORKER = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from abcnet_tpu_torch.ops.bn_act import ACTS, bn_act
from abcnet_tpu_torch.parallel import init_distributed
mesh = init_distributed("cpu")
data = np.load(sys.argv[2])
half = data["x"].shape[0] // mesh.world
rows = slice(mesh.rank * half, (mesh.rank + 1) * half)
out = {{}}
for act in sorted(ACTS):
    x = torch.from_numpy(data["x"][rows]).requires_grad_(True)
    w = torch.from_numpy(data["w"]).requires_grad_(True)
    b = torch.from_numpy(data["b"]).requires_grad_(True)
    y, mean, var = bn_act(x, w, b, 1e-5, act, mesh.group)
    y.backward(torch.from_numpy(data["dy"][rows]))
    for k, v in (("y", y), ("mean", mean), ("var", var), ("dx", x.grad),
                 ("dw", w.grad), ("db", b.grad)):
        out[f"{{act}}/{{k}}"] = v.detach().numpy()
np.savez(sys.argv[1], **out)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn_ranks")
    x, dy, w, b = _inputs((4, 8, 5, 5), seed=5)
    np.savez(tmp / "in.npz", x=x, dy=dy, w=w, b=b)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = _WORKER.format(repo=REPO)
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / f"rank{rank}.npz"),
             str(tmp / "in.npz")], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return ranks, (x, dy, w, b)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_two_ranks_normalize_like_one_batch(two_ranks, act):
    ranks, (x, dy, w, b) = two_ranks
    want = _run(bn_act, x, dy, w, b, act, torch.float32)
    y, mean, var, dx, dw, db = (t.numpy() for t in want)
    for r, half in zip(ranks, (slice(0, 2), slice(2, 4))):
        for k, v in (("y", y[half]), ("dx", dx[half]), ("mean", mean),
                     ("var", var)):
            np.testing.assert_allclose(r[f"{act}/{k}"], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    # the weight and bias gradients are each rank's own sums
    for k, v in (("dw", dw), ("db", db)):
        np.testing.assert_allclose(ranks[0][f"{act}/{k}"] +
                                   ranks[1][f"{act}/{k}"], v, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kernel", ["stats", "apply", "grad_sums",
                                    "grad_apply"])
def test_kernel_entry_points_raise_on_a_cpu_tensor(kernel):
    x = torch.zeros(2, 3, 4, 4)
    v = torch.zeros(3)
    st = torch.zeros(3, 3)
    args = {"stats": (x, 1e-5), "apply": (x, st, v, v, "relu"),
            "grad_sums": (x, x, st, v, v, "relu"),
            "grad_apply": (x, x, st, v, v, st[:2], 0.5, "relu")}[kernel]
    before = getattr(ops, kernel).launches
    with pytest.raises(ValueError, match="device"):
        getattr(ops, kernel)(*args)
    assert getattr(ops, kernel).launches == before


def test_unknown_activation_raises():
    x = torch.zeros(2, 3, 4, 4)
    with pytest.raises(ValueError, match="act"):
        bn_act(x, torch.ones(3), torch.zeros(3), 1e-5, "gelu")


@pytest.mark.parametrize("fmt", ["channels_last", "contiguous_format"])
def test_outputs_keep_the_input_layout(fmt):
    """The port's convolutions run channels_last, and the heads' dropout
    draws its mask in memory order: y and dx keep x's layout."""
    x, dy, w, b = _inputs((2, 8, 5, 6), seed=7)
    mf = getattr(torch, fmt)
    xt = torch.from_numpy(x).to(torch.bfloat16, memory_format=mf)
    xt.requires_grad_(True)
    y, _, _ = bn_act(xt, torch.from_numpy(w), torch.from_numpy(b), BN_EPS,
                     "relu")
    y.backward(torch.from_numpy(dy).to(torch.bfloat16, memory_format=mf))
    assert y.is_contiguous(memory_format=mf)
    assert xt.grad.is_contiguous(memory_format=mf)
