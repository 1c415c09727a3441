"""Make the benchmark's frozen pool of drawings, `benchmark/data/pool.npz`.

    python benchmark/tools/make_pool.py [--n 1024] [--check 0]

The pool holds `n` molecules drawn by the port's generator on the CPU:
the first half by engine A (the PIL/TrueType renderer, RDKit-style), the
second half by engine B (the stroke-font renderer, Indigo-style), each
half from its own fixed seed, lineage mixed. Each molecule is its uint8
512x512 drawing, its atom and bond label strings and its SMILES. Members
are LZMA-compressed .npy arrays, the drawings in 8 members that set-up
decompresses in parallel (`benchmark/pool.py`); `benchmark/data/pool.sha256`
holds the file's digest, which the harness checks at set-up.

This is the only file of the benchmark that imports the port, and no
run of the benchmark imports it. `--check k` rebuilds the first k
molecules of each half and compares them with the file instead of
writing it (the CPU test does the same).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import sys
import zipfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import pool  # noqa: E402
POOL = os.path.join(os.path.dirname(HERE), "data", "pool.npz")
DIGEST = os.path.join(os.path.dirname(HERE), "data", "pool.sha256")
SEEDS = {"a": 190001, "b": 190002}


def draw(engine: str, n: int):
    """The first `n` accepted samples of engine `engine` from its seed."""
    from abcnet_tpu_torch.data.generate import generate_sample

    rng = random.Random(SEEDS[engine])
    out = []
    while len(out) < n:
        s = generate_sample(rng, mode="mixed", engine=engine)
        if s is not None:
            out.append(s)
    return out


CHUNKS = 8         # image members, decompressed in parallel at set-up


def arrays(samples, engines):
    images = np.stack([s.image for s in samples]).astype(np.uint8)
    return {
        **{f"images_{k}": part for k, part in
           enumerate(np.array_split(images, CHUNKS))},
        "atoms": np.array([s.atoms_string for s in samples]),
        "bonds": np.array([s.bonds_string for s in samples]),
        "smiles": np.array([s.smiles for s in samples]),
        "engine": np.array(engines),
    }


def write(path: str, members) -> None:
    from numpy.lib import format as npf

    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_LZMA) as zf:
        for name, arr in members.items():
            with zf.open(name + ".npy", "w") as f:
                npf.write_array(f, np.asanyarray(arr))
    os.replace(tmp, path)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--check", type=int, default=0)
    args = ap.parse_args(argv)
    half = args.n // 2
    if args.check:
        z = np.load(POOL)
        ok = True
        for i, engine in enumerate("ab"):
            got = arrays(draw(engine, args.check), [engine] * args.check)
            for k, v in got.items():
                if k.startswith("images_"):
                    if k != "images_0":
                        continue
                    k, v = "images", np.concatenate(
                        [got[f"images_{j}"] for j in range(CHUNKS)])
                    ref = pool.load_images(POOL)[i * half:
                                                 i * half + args.check]
                else:
                    ref = z[k][i * half:i * half + args.check]
                same = np.array_equal(ref, v)
                ok &= same
                print(f"engine {engine} {k}: {'equal' if same else 'DIFFERS'}")
        return 0 if ok else 1
    samples = draw("a", half) + draw("b", args.n - half)
    write(POOL, arrays(samples, ["a"] * half + ["b"] * (args.n - half)))
    with open(DIGEST, "w") as f:
        f.write(sha256(POOL) + "\n")
    print(f"wrote {POOL} ({os.path.getsize(POOL)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
