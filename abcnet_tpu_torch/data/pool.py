"""Disk-cached sample pools for training/eval runs.

Generating a reference-scale corpus of 90k samples takes tens of
CPU-minutes (data/generate.py is pure Python), so pools are generated
once and cached as a flat uint8 blob + offsets (variable canvas sizes),
making relaunches load in seconds. Uncompressed on purpose — load speed
matters more than disk here.

The reference keeps its corpora as directories of PNGs + a CSV
(rdkit_img_generate.py:219-246); one flat array file suits a
single-machine feed better (no 90k-file stat storm on each launch).
Own copy of abcnet_tpu/data/pool.py: the files are the same bytes, so
pools written by either package load in the other.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import numpy as np

from .generate import Sample, generate_sample


def build_pool(path: str, n: int,
               sample_fn: Optional[Callable] = None,
               seed: int = 0, log_every: int = 10000) -> None:
    """Generate ``n`` accepted samples from ``sample_fn(rng)`` (default:
    the production mixed-lineage stream, seed-0) and cache to ``path``."""
    import random
    rng = random.Random(seed)
    fn = sample_fn or generate_sample
    t0 = time.time()
    samples: List[Sample] = []
    while len(samples) < n:
        s = fn(rng)
        if s is not None:
            samples.append(s)
            if len(samples) % log_every == 0:
                print(f"gen {len(samples)}/{n} ({time.time() - t0:.0f}s)",
                      flush=True)
    save_pool(path, samples)
    print(f"pool cached: {len(samples)} samples, {time.time() - t0:.0f}s",
          flush=True)


def save_pool(path: str, samples: List[Sample]) -> None:
    """Write the corpus cache without materializing the concatenated
    image blob: for the 90k 512x512 pool that transient was ~20+ GB on
    top of the resident Sample list. The blob member is streamed into
    the zip per sample instead; on-disk format is byte-compatible with
    the previous np.savez layout (npz = zip of .npy members), so
    load_pool and existing caches are unaffected."""
    import zipfile

    from numpy.lib import format as npf

    shapes = np.array([s.image.shape for s in samples], np.int32)
    sizes = shapes.prod(axis=1).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    dtype = samples[0].image.dtype if samples else np.dtype(np.uint8)
    assert all(s.image.dtype == dtype for s in samples), \
        "mixed image dtypes in pool"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
        with zf.open("blob.npy", "w", force_zip64=True) as f:
            npf.write_array_header_2_0(
                f, {"descr": npf.dtype_to_descr(dtype),
                    "fortran_order": False,
                    "shape": (int(sizes.sum()),)})
            for s in samples:
                f.write(np.ascontiguousarray(s.image).tobytes())
        small = {"shapes": shapes, "offsets": offsets,
                 "atoms": np.array([s.atoms_string for s in samples]),
                 "bonds": np.array([s.bonds_string for s in samples]),
                 "smiles": np.array([s.smiles for s in samples])}
        for name, arr in small.items():
            with zf.open(name + ".npy", "w") as f:
                npf.write_array(f, np.asanyarray(arr))
    os.replace(tmp, path)


def load_pool(path: str) -> List[Sample]:
    t0 = time.time()
    z = np.load(path)
    # Bind each npz member ONCE — NpzFile.__getitem__ re-reads the whole
    # array from the zip on every access.
    blob, shapes, offsets = z["blob"], z["shapes"], z["offsets"]
    atoms, bonds, smiles = z["atoms"], z["bonds"], z["smiles"]
    samples = []
    for i in range(len(shapes)):
        h, w = shapes[i]
        img = blob[offsets[i]:offsets[i] + h * w].reshape(h, w)
        samples.append(Sample(image=img, atoms_string=str(atoms[i]),
                              bonds_string=str(bonds[i]),
                              smiles=str(smiles[i])))
    print(f"pool loaded: {len(samples)} samples in "
          f"{time.time() - t0:.0f}s", flush=True)
    return samples


def ensure_pool(path: str, n: int, sample_fn: Optional[Callable] = None,
                seed: int = 0) -> List[Sample]:
    if not os.path.exists(path):
        build_pool(path, n, sample_fn, seed)
    return load_pool(path)
