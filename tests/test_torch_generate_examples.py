"""`data/pipeline.py:generate_examples` of the torch port against
abcnet_tpu's, on the CPU. Tolerance: exact (images, every label array
with its dtype, SMILES).

  * the serial path (n < 32, or one process) against the JAX package's
    generate_examples for the same (n, seed, mode, train);
  * the pool path with the pool run in this process (multiprocessing's
    spawn context replaced by one that runs `starmap` here, in both
    packages): the same chunk arguments (seeds seed + 7919·w), chunk for
    chunk the same examples, and no JAX worker spawned;
  * one real spawn pool of the port (n = 32, two processes) against the
    serial concatenation of its chunks, and its workers' module
    (data/examples.py) importing no torch;
  * the digest fixture abcnet_tpu_torch/assets/examples_digests.npz,
    which `chip_smoke.py` holds the card's host to: the JAX package's
    list for its arguments, digest by digest.

Rebuild the fixture (a few seconds of CPU):

    env JAX_PLATFORMS=cpu python tests/test_torch_generate_examples.py
"""

import hashlib
import multiprocessing
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from abcnet_tpu.data import pipeline as jpipe  # noqa: E402
from abcnet_tpu_torch.data import pipeline as tpipe  # noqa: E402

FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                       "examples_digests.npz")
# generate_examples(N, SEED, MODE, TRAIN, processes=PROCESSES): 4 chunks
ARGS = dict(n=64, seed=5, mode="mixed", train=True, processes=4)


def _sha(b: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(b).digest(), np.uint8)


def _labels_bytes(labels) -> bytes:
    return b"".join(k.encode() + str(v.dtype).encode() +
                    str(v.shape).encode() + np.ascontiguousarray(v).tobytes()
                    for k, v in sorted(labels.items()))


def digests(examples):
    """{image, labels: (n, 32) uint8 sha256; smiles: (n,) str}."""
    return {"image": np.stack([_sha(np.ascontiguousarray(e.image_u8)
                                    .tobytes()) for e in examples]),
            "labels": np.stack([_sha(_labels_bytes(e.labels))
                                for e in examples]),
            "smiles": np.array([e.smiles for e in examples])}


def assert_examples_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.image_u8, b.image_u8, err_msg=str(i))
        assert a.image_u8.dtype == b.image_u8.dtype
        assert sorted(a.labels) == sorted(b.labels), i
        for k in b.labels:
            assert a.labels[k].dtype == b.labels[k].dtype, (i, k)
            np.testing.assert_array_equal(a.labels[k], b.labels[k],
                                          err_msg=f"{i} {k}")
        assert a.smiles == b.smiles, i


class _InProcessSpawn:
    """Stands in for multiprocessing.get_context("spawn"): its Pool runs
    starmap in this process and records the arguments."""

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, method):
        assert method == "spawn"
        return self

    def Pool(self, processes):  # noqa: N802 — the multiprocessing name
        self.calls.append(("pool", processes))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def starmap(self, fn, args):
        args = list(args)
        self.calls.append(("starmap", args))
        return [fn(*a) for a in args]


@pytest.mark.parametrize("n,seed,mode,train,processes", [
    (6, 0, "mixed", True, None),
    (5, 3, "rdkit", False, 4),
    (4, 11, "indigo", True, 8),
    (33, 2, "mixed", True, 1),
])
def test_serial_path_equals_jax(n, seed, mode, train, processes):
    got = tpipe.generate_examples(n, seed, mode, train, processes)
    want = jpipe.generate_examples(n, seed, mode, train, processes)
    assert_examples_equal(got, want)


@pytest.fixture(scope="module")
def pool_lists():
    """Both packages' pool paths at ARGS with the pool in this process:
    {package: (examples, recorded pool calls)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in (("torch", tpipe), ("jax", jpipe)):
            calls = []
            mp.setattr(multiprocessing, "get_context",
                       _InProcessSpawn(calls))
            out[name] = (mod.generate_examples(**ARGS), calls)
    return out


def test_pool_path_equals_jax_chunk_by_chunk(pool_lists):
    (got, tcalls), (want, jcalls) = pool_lists["torch"], pool_lists["jax"]
    assert tcalls == jcalls
    chunk = ARGS["n"] // ARGS["processes"]
    assert tcalls == [("pool", 4), ("starmap", [
        (ARGS["seed"] + 7919 * w, chunk, ARGS["mode"], ARGS["train"])
        for w in range(4)])]
    for w, args in enumerate(tcalls[1][1]):
        assert_examples_equal(got[w * chunk:(w + 1) * chunk],
                              jpipe._gen_chunk(*args))
    assert_examples_equal(got, want)


def test_fixture_is_the_jax_list(pool_lists):
    z = np.load(FIXTURE)
    for k, v in ARGS.items():
        assert z[k].item() == v, k
    for name in ("jax", "torch"):
        got = digests(pool_lists[name][0])
        for k in got:
            np.testing.assert_array_equal(z[k], got[k],
                                          err_msg=f"{name} {k}")
    assert os.path.getsize(FIXTURE) < 16 * 2 ** 10


def test_spawn_pool_equals_its_chunks():
    got = tpipe.generate_examples(32, seed=9, mode="mixed", train=True,
                                  processes=2)
    want = tpipe._gen_chunk(9, 16, "mixed", True) + \
        tpipe._gen_chunk(9 + 7919, 16, "mixed", True)
    assert_examples_equal(got, want)


def test_pool_workers_import_no_torch():
    """A spawned worker loads the module of `_gen_chunk` and its host
    dependencies only: no torch, so no device and no torch start-up."""
    import subprocess

    code = ("import sys; import {0} as m; m._gen_chunk(1, 1, 'mixed', True);"
            " print('torch' in sys.modules)").format(
                tpipe._gen_chunk.__module__)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "False"


def build_fixture(out_path: str) -> None:
    calls = []
    real = multiprocessing.get_context
    multiprocessing.get_context = _InProcessSpawn(calls)
    try:
        examples = jpipe.generate_examples(**ARGS)
    finally:
        multiprocessing.get_context = real
    np.savez_compressed(out_path, **ARGS, **digests(examples))


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else FIXTURE
    build_fixture(out)
    print(f"wrote {out}")
