"""Host-side training examples: the geometric augment and the compact
labels of one drawing, and the workers of `pipeline.generate_examples`.

Split out of data/pipeline.py (which re-exports `Example` and
`sample_to_example`) so that it imports no torch and no kernel wrapper:
a process that `generate_examples` spawns loads this module and its host
dependencies only, starts in a fraction of the time `import torch`
takes, and cannot touch a device. The draws from `rng` are the JAX
package's (abcnet_tpu/data/pipeline.py:76-90, 219-225).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import raster
from .augment import AugmentParams
from .degrade import random_degrade
from .encode import compact_labels, parse_atoms_string, parse_bonds_string
from .generate import Sample, generate_sample

SIZE = 512


@dataclass
class Example:
    """One host-side training example: uint8 canvas + compact labels."""
    image_u8: np.ndarray          # (512, 512) uint8, white background
    labels: Dict[str, np.ndarray]
    smiles: str = ""


def _geometric_augment(img_u8: np.ndarray, rng: random.Random,
                       train: bool, size: int = SIZE
                       ) -> Tuple[np.ndarray, AugmentParams]:
    """20%: one axis rescaled by U(0.8, 1), re-center-pad with white
    (reference src/utils.py:47-61). Returns the uint8 canvas and the
    params that transform label coordinates."""
    scale_x = scale_y = 1.0
    temp = img_u8
    if train and rng.random() < 0.2:
        if rng.random() < 0.5:
            scale_x = rng.uniform(0.8, 1.0)
            temp = raster.resize(temp, (int(scale_x * size), size))
        else:
            scale_y = rng.uniform(0.8, 1.0)
            temp = raster.resize(temp, (size, int(scale_y * size)))
    ddx = (size - temp.shape[0]) // 2
    ddy = (size - temp.shape[1]) // 2
    if temp.shape != (size, size):
        canvas = np.full((size, size), 255, np.uint8)
        canvas[ddx:ddx + temp.shape[0], ddy:ddy + temp.shape[1]] = temp
    else:
        canvas = temp
    return canvas, AugmentParams(scale_x, scale_y, ddx, ddy)


def sample_to_example(sample: Sample, rng: random.Random,
                      train: bool = True,
                      degrade_p: float = 0.0,
                      degrade_hard: bool = False) -> Example:
    """Geometric augment (train only) + compact labels. degrade_p > 0
    applies one scan-style degradation (blur / erode / downscale / JPEG,
    data/degrade.py) to that fraction of training images, after the
    geometric augment and before binarization; label coordinates are
    unaffected. Default 0 keeps the reference's salt/pepper-only
    training recipe (src/utils.py:73-80). degrade_hard=True draws from
    the hard-tail regime (blur/erode biased; see
    degrade.random_degrade). The draws from `rng` are the JAX package's
    (abcnet_tpu/data/pipeline.py:76-90)."""
    img, p = _geometric_augment(sample.image, rng, train)
    if train and degrade_p > 0 and rng.random() < degrade_p:
        img = random_degrade(img, rng, hard=degrade_hard)
    atoms = parse_atoms_string(sample.atoms_string)
    bonds = parse_bonds_string(sample.bonds_string)
    labels = compact_labels(atoms, bonds, p.scale_x, p.scale_y,
                            p.ddx, p.ddy)
    return Example(img, labels, sample.smiles)


def _gen_one(rng: random.Random, mode: str, train: bool) -> Example:
    while True:
        s = generate_sample(rng, mode=mode)
        if s is not None:
            return sample_to_example(s, rng, train)


def _gen_chunk(seed: int, n: int, mode: str, train: bool) -> List[Example]:
    rng = random.Random(seed)
    return [_gen_one(rng, mode, train) for _ in range(n)]
