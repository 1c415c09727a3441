"""The frozen pool of drawings, `benchmark/data/pool.npz`
(benchmark/tools/make_pool.py makes it): loaded and checked at set-up."""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
POOL = os.path.join(HERE, "data", "pool.npz")
DIGEST = os.path.join(HERE, "data", "pool.sha256")


def load_images(path: str = POOL) -> np.ndarray:
    """The (n, 512, 512) uint8 drawings. They are stored in several LZMA
    members, decompressed here on as many threads (the decompressor lets
    go of the interpreter lock)."""
    def member(k):
        with np.load(path) as z:
            return z[f"images_{k}"]
    with np.load(path) as z:
        n = sum(name.startswith("images_") for name in z.files)
    with ThreadPoolExecutor(n) as ex:
        return np.concatenate(list(ex.map(member, range(n))))


def load() -> np.ndarray:
    """The drawings, once the file's sha256 is the one recorded."""
    with open(POOL, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with open(DIGEST) as f:
        want = f.read().split()[0]
    if digest != want:
        raise SystemExit(f"error: {POOL} has sha256 {digest}, not {want}")
    return load_images()
