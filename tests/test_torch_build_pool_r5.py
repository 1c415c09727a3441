"""train/build_pool_r5.py against the JAX package's scripts/build_pool_r5.py,
on the CPU, and the pool's digest fixture,
abcnet_tpu_torch/assets/pool_r5_digests.npz.

  * both packages' main() at EVAL_N 8 and train_n 16: the pool files equal
    array by array, and the lineage and engine the port records for each
    row equal what the script hands generate_sample (the script's
    generate_sample is wrapped to record them; nothing in scripts/
    changes);
  * the fixture, made by the JAX script's main() at its EVAL_N of 256 and
    train_n 256 (the 256 eval rows and the first 256 train rows): per
    row the SMILES, the lineage, the engine and the sha256 of the two
    label strings and of the image bytes (the label strings themselves
    would take 120 KB compressed); the ink masks (pack_images at the serving
    threshold 0.6) of the first MASK_ROWS eval rows, so that a host whose
    Pillow and FreeType draw engine A's labels otherwise can say by how
    many pixels. The test re-makes all 512 rows with the port and
    compares them;
  * the entry point refuses to run without a GPU unless asked for the CPU.

Rebuild the fixture (about 30 s of CPU):

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_build_pool_r5.py \
        [out.npz]
"""

import hashlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from abcnet_tpu_torch.data.pipeline import pack_images
from abcnet_tpu_torch.train import build_pool_r5 as bp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "abcnet_tpu_torch", "assets",
                       "pool_r5_digests.npz")
FIXTURE_TRAIN_N = 256
MASK_ROWS = 16
POOL_KEYS = ("blob", "shapes", "offsets", "atoms", "bonds", "smiles")


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_build_pool_r5", os.path.join(REPO, "scripts",
                                          "build_pool_r5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(out, train_n, eval_n=None):
    """The script's main() writing `out`; returns the (lineage, engine) of
    each accepted row, as it asked generate_sample for them."""
    mod = jax_script()
    if eval_n is not None:
        mod.EVAL_N = eval_n
    gen, drawn = mod.generate_sample, []

    def recording(rng, mode="mixed", engine="a"):
        s = gen(rng, mode=mode, engine=engine)
        if s is not None:
            drawn.append((mode, engine))
        return s

    mod.generate_sample = recording
    argv = sys.argv
    sys.argv = ["build_pool_r5.py", out, str(train_n)]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return drawn


def sha256(b: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(b).digest(), np.uint8)


def rows_of(samples, modes, engines):
    """The fixture's fields of pool rows."""
    return {
        "atoms": np.stack([sha256(s.atoms_string.encode())
                           for s in samples]),
        "bonds": np.stack([sha256(s.bonds_string.encode())
                           for s in samples]),
        "smiles": np.array([s.smiles for s in samples]),
        "modes": np.array(modes), "engines": np.array(engines),
        "image": np.stack([sha256(np.ascontiguousarray(s.image).tobytes())
                           for s in samples]),
        "masks": pack_images(np.stack([s.image
                                       for s in samples[:MASK_ROWS]])),
    }


def build_fixture(out_path):
    import tempfile

    from abcnet_tpu.data.pool import load_pool
    with tempfile.TemporaryDirectory() as tmp:
        pool = os.path.join(tmp, "pool.npz")
        drawn = run_jax(pool, FIXTURE_TRAIN_N)
        samples = load_pool(pool)
    fields = rows_of(samples, [m for m, _ in drawn], [e for _, e in drawn])
    np.savez_compressed(out_path, eval_n=np.int64(bp.EVAL_N), **fields)


def test_pool_equals_the_scripts(tmp_path, monkeypatch):
    want = str(tmp_path / "jax.npz")
    drawn = run_jax(want, 16, eval_n=8)
    got = str(tmp_path / "torch.npz")
    monkeypatch.setattr(bp, "EVAL_N", 8)
    res = bp.build_pool_r5(got, 16, log=lambda line: None)
    zw, zg = np.load(want), np.load(got)
    assert sorted(zw.files) == sorted(zg.files) == sorted(POOL_KEYS)
    for k in POOL_KEYS:
        np.testing.assert_array_equal(zg[k], zw[k], err_msg=k)
    assert list(zip(res.modes, res.engines)) == drawn
    assert res.modes[:8] == ["mixed"] * 8 and res.engines[:8] == ["a"] * 8
    assert len(res.samples) == 24 and res.samples_per_s > 0


def test_port_remakes_the_digest_fixture(tmp_path):
    z = np.load(FIXTURE)
    n = len(z["smiles"])
    assert int(z["eval_n"]) == bp.EVAL_N and n == bp.EVAL_N + FIXTURE_TRAIN_N
    res = bp.build_pool_r5(str(tmp_path / "pool.npz"), FIXTURE_TRAIN_N,
                           log=lambda line: None)
    got = rows_of(res.samples, res.modes, res.engines)
    for k, v in got.items():
        np.testing.assert_array_equal(v, z[k], err_msg=k)
    # both lineages and both engines occur on the train rows
    assert set(z["modes"][bp.EVAL_N:]) == {"rdkit", "indigo"}
    assert set(z["engines"][bp.EVAL_N:]) == {"a", "b"}


def test_main_refuses_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bp.main([str(tmp_path / "p.npz"), "1"])
    assert not os.path.exists(tmp_path / "p.npz")


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else FIXTURE
    build_fixture(out)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")
