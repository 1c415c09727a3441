"""Multi-process serving of the torch port on the CPU: two gloo processes
(RANK/WORLD_SIZE/MASTER_* in their environment, as torchrun sets them),
each serving its own rows through
make_infer_pipeline(mesh=init_distributed("cpu")), the counterpart of the
JAX package's make_infer_pipeline after jax.distributed.initialize.

Four fixture molecules, 128x128 crops, f32, the step-43100 snapshot.
Rank 1 moves one BatchNorm statistic of its weights before it builds its
pipeline; the pipeline replicates rank 0's. Against one process:

  * each rank's peak dict equals, every array bit for bit, the
    single-process pipeline on that rank's two rows (`local_rows`; the
    same per-call shapes, as the card's mesh_serving rule has it);
  * each rank's SMILES, assembled in the rank's own process, equal those
    rows of the single-process run of the whole batch;
  * both ranks end with rank 0's weights (rank 1's moved statistic is
    the snapshot's again, the checksums of the two are equal);
  * `local_rows` gives contiguous blocks and raises when the batch does
    not divide.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from abcnet_tpu_torch import __main__ as cli
from abcnet_tpu_torch.infer.decode import make_infer_pipeline
from abcnet_tpu_torch.models.weights import load_snapshot
from abcnet_tpu_torch.parallel import Mesh, local_rows
from torch_parity import FIXTURE, REPO, SNAPSHOT

ROWS = [0, 1, 40, 41]
THREADS = 2
MOVED = "down4.double_conv.bn1.running_mean"

_WORKER = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "tests"))
from abcnet_tpu_torch.__main__ import img2smiles_loop
from abcnet_tpu_torch.infer.decode import make_infer_pipeline
from abcnet_tpu_torch.models.weights import load_snapshot
from abcnet_tpu_torch.parallel import init_distributed, local_rows
import test_torch_multiproc_serving as T
torch.set_num_threads(T.THREADS)
mesh = init_distributed("cpu")
assert mesh.world == 2 and mesh.rank == int(os.environ["RANK"])
model, _ = load_snapshot(T.SNAPSHOT, "cpu", torch.float32)
if mesh.rank:
    with torch.no_grad():
        model.state_dict()[T.MOVED].add_(0.25)
run = make_infer_pipeline(model, "cpu", mesh=mesh)
images = T.images()[local_rows(len(T.ROWS), mesh)]
peaks = run(images)
smiles = img2smiles_loop(run, list(images), len(images), log_every=0)
state = model.state_dict()
np.savez(sys.argv[1], **{{f"peaks/{{k}}": v for k, v in peaks.items()}},
         smiles=np.array([s or "" for s in smiles]),
         moved=state[T.MOVED].numpy(),
         checksum=sum(float(t.double().sum()) for t in state.values()))
torch.distributed.destroy_process_group()
"""


def images():
    z = np.load(FIXTURE)
    return np.ascontiguousarray(z["images"][ROWS, 192:320, 192:320])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What the two gloo ranks served, [rank 0, rank 1]."""
    tmp = tmp_path_factory.mktemp("serve_ranks")
    port = _free_port()
    code = _WORKER.format(repo=REPO)
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": str(THREADS)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / f"rank{rank}.npz")],
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
def single():
    """One process with the ranks' THREADS (the thread count moves f32
    convolution sums): the snapshot model, the peak dicts of rows 0-1 and
    2-3, the SMILES of the whole batch."""
    model, _ = load_snapshot(SNAPSHOT, "cpu", torch.float32)
    run = make_infer_pipeline(model, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        blocks = [run(images()[2 * r:2 * r + 2]) for r in range(2)]
        whole = cli.img2smiles_loop(run, list(images()), len(ROWS),
                                    log_every=0)
    finally:
        torch.set_num_threads(threads)
    return model, blocks, whole


@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_serves_its_rows_like_one_process(ranks, single, rank):
    rows = local_rows(len(ROWS), Mesh((torch.device("cpu"),), rank, 2))
    assert rows == slice(2 * rank, 2 * rank + 2)
    want = single[1][rank]
    got = {k[len("peaks/"):]: v for k, v in ranks[rank].items()
           if k.startswith("peaks/")}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_each_rank_assembles_the_rows_of_one_process(ranks, single):
    whole = single[2]
    assert all(whole)
    assert [s for r in ranks for s in r["smiles"].tolist()] == whole


def test_every_rank_serves_rank_0s_weights(ranks, single):
    snap = single[0].state_dict()[MOVED].numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["moved"], snap)
    assert float(ranks[0]["checksum"]) == float(ranks[1]["checksum"])


@pytest.mark.parametrize("n,world", [(4, 2), (8, 4), (6, 3), (64, 2)])
def test_local_rows_are_contiguous_blocks(n, world):
    cpu = torch.device("cpu")
    blocks = [local_rows(n, Mesh((cpu,), r, world)) for r in range(world)]
    assert [i for b in blocks for i in range(n)[b]] == list(range(n))
    assert len({b.stop - b.start for b in blocks}) == 1
    with pytest.raises(ValueError, match="divide"):
        local_rows(n + 1, Mesh((cpu,), 0, world))
