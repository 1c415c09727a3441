"""The frozen pool of drawings: its digest, its members, and the first
molecules of each engine rebuilt by the port's generator equal the
file's."""

import hashlib
import os
import subprocess
import sys

import numpy as np

from .cpu_run import BENCH
from benchmark import pool


def test_digest_and_shape():
    images = pool.load()
    assert images.shape == (1024, 512, 512) and images.dtype == np.uint8
    with open(pool.POOL, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == open(
            pool.DIGEST).read().split()[0]
    with np.load(pool.POOL) as z:
        engines = z["engine"]
        assert len(z["smiles"]) == len(z["atoms"]) == len(z["bonds"]) == 1024
    assert (engines[:512] == "a").all() and (engines[512:] == "b").all()


def test_first_eight_rebuild_equal():
    tool = os.path.join(BENCH, "tools", "make_pool.py")
    out = subprocess.run([sys.executable, tool, "--check", "8"],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DIFFERS" not in out.stdout
