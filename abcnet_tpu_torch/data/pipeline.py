"""Input path: host augment + binarize + 1-bit pack, device unpack (+ noise).

Counterpart of abcnet_tpu/data/pipeline.py. Host workers only read the
uint8 drawing, apply the geometric augmentation (the one transform that
moves labels) and emit compact integer labels; images are binarized and
bit-packed on the host (1 bit per pixel crosses to the device, an eighth
of the uint8 image). On the device, kernel 1 (ops/unpack.py) unpacks the
mask for serving and evaluation, and kernel 2 (ops/noise.py) unpacks it
and adds the per-image salt/pepper noise for training. Dense targets are
scatter-built on the device from the compact labels (ops/targets.py).

Sources: the molecule generator (data/generate.py, whose record
`Sample` this module re-exports, as it re-exports `Example` and
`sample_to_example` of data/examples.py), `generate_examples` (its
examples over a spawn pool of host processes), `load_csv_dataset` (a
dataset directory in the reference CSV format), `synthetic_batch`
(random pixels, for benchmarks).
"""

from __future__ import annotations

import csv
import os
import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.noise import SEED_MAX, unpack_noise
from ..ops.unpack import unpack_bits
from . import raster, vocab
from .encode import MAX_ATOMS, MAX_BONDS
from .examples import SIZE, Example, _gen_chunk, _gen_one, sample_to_example
from .generate import Sample

def pack_images(images_u8: np.ndarray, threshold: float = 0.6) -> np.ndarray:
    """Binarize (ink = gray/255 < threshold, the reference's utils.py:63)
    and bit-pack along the column axis: (B, H, W) uint8 -> (B, H, W//8)
    uint8, MSB first.

    The predicate gray/255 < t is monotone in the uint8 value, so it
    equals x < cutoff, with the cutoff found by evaluating the f32
    predicate over all 256 byte values: no float temporary the size of
    the batch."""
    lut = (np.arange(256, dtype=np.uint8).astype(np.float32)
           / 255.0) < threshold
    cutoff = int(lut.sum())
    if cutoff <= 0:
        ink = np.zeros(images_u8.shape, bool)
    elif cutoff >= 256:
        ink = np.ones(images_u8.shape, bool)
    else:
        ink = images_u8 < np.uint8(cutoff)
    return np.packbits(ink, axis=-1)


def collate(examples: Sequence[Example],
            threshold: float = 0.6) -> Dict[str, np.ndarray]:
    """Stack host examples into one batch dict (bit-packed images)."""
    return {
        "image_bits": pack_images(
            np.stack([e.image_u8 for e in examples]), threshold),
        "atoms": np.stack([e.labels["atoms"] for e in examples]),
        "n_atoms": np.stack([e.labels["n_atoms"] for e in examples]),
        "bonds_i": np.stack([e.labels["bonds_i"] for e in examples]),
        "bonds_f": np.stack([e.labels["bonds_f"] for e in examples]),
        "n_bonds": np.stack([e.labels["n_bonds"] for e in examples]),
    }


def draw_noise_rates(b: int, amount: float, device,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """One (salt, pepper) rate pair per image, (b, 2) f32 on `device`:
    salt ~ U(0, amount/100), pepper ~ U(0, amount) (reference
    src/utils.py:73-80)."""
    u = torch.rand(b, 2, device=device, generator=generator)
    return u * torch.tensor([amount / 100.0, amount], device=device)


def _apply_noise(ink: torch.Tensor, amount: float,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Plain salt/pepper on a bool ink mask (B, H, W): salt adds ink at a
    per-image rate ~ U(0, amount/100), pepper erases at ~ U(0, amount).
    The uniforms come from `generator` through torch.rand, not from the
    noise kernel's Philox layout; `device_preprocess` (uint8 input) uses
    it."""
    rates = draw_noise_rates(ink.shape[0], amount, ink.device, generator)
    salt = torch.rand(ink.shape, device=ink.device,
                      generator=generator) < rates[:, 0, None, None]
    pepper = torch.rand(ink.shape, device=ink.device,
                        generator=generator) < rates[:, 1, None, None]
    return (ink | salt) & ~pepper


def device_preprocess(image_u8: torch.Tensor, amount: float = 0.2,
                      train: bool = True, threshold: float = 0.6,
                      generator: Optional[torch.Generator] = None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 batch (B, H, W) -> foreground mask (B, H, W, 1): ink =
    gray/255 < threshold, then salt/pepper noise (reference
    src/utils.py:63-80)."""
    ink = (image_u8.to(torch.float32) / 255.0) < threshold
    if train and amount > 0:
        ink = _apply_noise(ink, amount, generator)
    return ink.to(dtype)[..., None]


def device_unpack_bits(image_bits: torch.Tensor, train: bool = False,
                       dtype: torch.dtype = torch.float32,
                       amount: float = 0.2,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Bit-packed batch (B, H, W//8) -> {0, 1} mask (B, H, W, 1) in
    `dtype`.

    The binarize threshold was applied at pack time (pack_images).
    train=False (or amount 0) is the pure unpack, kernel 1. train=True
    draws one (salt, pepper) rate pair per image and a 63-bit seed for
    the pixel stream from `generator` (on the tensor's device; the
    default generator if None) and goes through kernel 2, the fused
    unpack + noise: the same generator state gives the same mask. The
    (B, H, W, 1) result is a view of the (B, H, W) buffer the kernel
    writes, which is also the NCHW (B, 1, H, W) input of the stem conv."""
    if not (train and amount > 0):
        return unpack_bits(image_bits, dtype)[..., None]
    dev = image_bits.device
    rates = draw_noise_rates(image_bits.shape[0], amount, dev, generator)
    seed = torch.randint(0, SEED_MAX, (1,), device=dev, generator=generator)
    return unpack_noise(image_bits, rates, seed, dtype)[..., None]


def generate_examples(n: int, seed: int = 0, mode: str = "mixed",
                      train: bool = True,
                      processes: Optional[int] = None) -> List[Example]:
    """Generate n examples, fanned out over a process pool (the
    reference's dataloader-worker role, train.py:44); the JAX package's
    list for the same arguments (abcnet_tpu/data/pipeline.py:195-216).
    Serial below 32 examples or with one process; otherwise chunk w of
    ceil(n / processes) examples comes from random.Random(seed + 7919·w).
    The pool is spawned, not forked: the parent may hold a live CUDA
    context, which a forked child must not inherit. Its workers run
    data/examples.py:_gen_chunk, which imports no torch, so they start
    without it and touch no device."""
    if processes is None:
        processes = max(1, (os.cpu_count() or 4) - 2)
    if processes <= 1 or n < 32:
        rng = random.Random(seed)
        return [_gen_one(rng, mode, train) for _ in range(n)]
    import multiprocessing as mp
    chunk = (n + processes - 1) // processes
    args = [(seed + 7919 * w, min(chunk, n - w * chunk), mode, train)
            for w in range(processes) if w * chunk < n]
    with mp.get_context("spawn").Pool(len(args)) as pool:
        parts = pool.starmap(_gen_chunk, args)
    return [e for part in parts for e in part]


def _read_gray(path: str) -> np.ndarray:
    img = raster.imread_gray(path)
    if img.shape != (SIZE, SIZE):
        img = raster.resize(img, (SIZE, SIZE))
    return img


def load_image_csv(csv_path: str) -> Tuple[List[np.ndarray], List[str]]:
    """Read a dataset CSV: the labelled format the generator writes
    (Smiles/atoms_string/bonds_string/path) or a plain (image, smiles)
    CSV like the UOB benchmark's. Returns (uint8 images resized to
    512 x 512, SMILES). Image paths are relative to the CSV's directory.
    Column names are matched case-insensitively: SMILES from `smiles`,
    the image from path/file/filename/image/image_path."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = {c.lower(): c for c in (rows[0].keys() if rows else ())}
    smi_col = cols.get("smiles")
    img_col = next((cols[k] for k in ("path", "file", "filename", "image",
                                      "image_path") if k in cols), None)
    if smi_col is None or img_col is None:
        raise ValueError(f"{csv_path}: need a SMILES and an image-path "
                         f"column; got {sorted(cols.values())}")
    root = os.path.dirname(csv_path)
    images = [_read_gray(os.path.join(root, r[img_col])) for r in rows]
    return images, [r[smi_col] for r in rows]


def load_csv_dataset(csv_path: str, image_root: Optional[str] = None
                     ) -> List[Sample]:
    """Read a reference-format CSV (Smiles/atoms_string/bonds_string/path)
    + PNG tree back into Samples (parity: src/utils.py:36-42)."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    root = image_root or os.path.dirname(csv_path)
    return [Sample(raster.imread_gray(os.path.join(root, r["path"])),
                   r["atoms_string"], r["bonds_string"], r["Smiles"])
            for r in rows]


def batches_from_samples(samples: Sequence[Sample], batch_size: int,
                         seed: int = 0, epoch: int = 0,
                         train: bool = True,
                         drop_remainder: bool = True,
                         degrade_p: float = 0.0
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Per-epoch batches with fresh augmentation — the reference's
    dataloader re-runs __getitem__ (and so the random rescale/pad) every
    epoch (utils.py:47-61); converting samples to examples once would
    freeze one augmentation forever."""
    rng = random.Random(seed * 1_000_003 + epoch)
    order = np.random.default_rng(seed + epoch).permutation(len(samples))
    stop = len(order) - batch_size + 1 if drop_remainder else len(order)
    for i in range(0, max(stop, 0), batch_size):
        ex = [sample_to_example(samples[j], rng, train=train,
                                degrade_p=degrade_p)
              for j in order[i:i + batch_size]]
        yield collate(ex)


def batches_from_examples(examples: Sequence[Example], batch_size: int,
                          seed: int = 0, shuffle: bool = True,
                          drop_remainder: bool = True
                          ) -> Iterator[Dict[str, np.ndarray]]:
    idx = np.arange(len(examples))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = len(idx) - batch_size + 1 if drop_remainder else len(idx)
    for i in range(0, max(stop, 0), batch_size):
        yield collate([examples[j] for j in idx[i:i + batch_size]])


class PrefetchIterator:
    """Background-thread prefetch of host batches (the reference's
    prefetch_factor=10, train.py:45). An exception in the source
    iterator is raised again in the consumer."""

    def __init__(self, it: Iterator, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _fill(self, it):
        try:
            for item in it:
                self._q.put(item)
        except Exception as e:  # noqa: BLE001 — handed to the consumer
            self._error = e
        finally:
            self._q.put(self._sentinel)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def synthetic_batch(batch_size: int, seed: int = 0,
                    size: int = SIZE) -> Dict[str, np.ndarray]:
    """Random-pixel batch with plausible labels, for benchmarks and
    shape checks (no host generation cost)."""
    rng = np.random.default_rng(seed)
    grid = size // vocab.STRIDE
    n_atoms = 24
    n_bonds = 48
    atoms = np.zeros((batch_size, MAX_ATOMS, 5), np.int32)
    atoms[:, :n_atoms, 0] = rng.integers(2, grid - 2, (batch_size, n_atoms))
    atoms[:, :n_atoms, 1] = rng.integers(2, grid - 2, (batch_size, n_atoms))
    atoms[:, :n_atoms, 2] = rng.integers(1, 4, (batch_size, n_atoms))
    atoms[:, :n_atoms, 4] = -1
    bonds_i = np.zeros((batch_size, MAX_BONDS, 4), np.int32)
    bonds_i[:, :n_bonds, 0] = rng.integers(2, grid - 2, (batch_size, n_bonds))
    bonds_i[:, :n_bonds, 1] = rng.integers(2, grid - 2, (batch_size, n_bonds))
    bonds_i[:, :n_bonds, 3] = rng.integers(0, 60, (batch_size, n_bonds))
    bonds_f = np.zeros((batch_size, MAX_BONDS, 1), np.float32)
    bonds_f[:, :n_bonds, 0] = rng.uniform(2, 8, (batch_size, n_bonds))
    return {
        "image_bits": pack_images(
            rng.integers(0, 256, (batch_size, size, size),
                         dtype=np.uint8)),
        "atoms": atoms,
        "n_atoms": np.full((batch_size,), n_atoms, np.int32),
        "bonds_i": bonds_i,
        "bonds_f": bonds_f,
        "n_bonds": np.full((batch_size,), n_bonds, np.int32),
    }
