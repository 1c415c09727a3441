"""data/degrade.py of the port against abcnet_tpu's, on the CPU: every
transform bit-equal on seeded drawings, random_degrade with the hard-tail
regime off and on drawing the same family from the same rng (same state
after every call)."""

import random

import numpy as np
import pytest

from abcnet_tpu.data import degrade as jd
from abcnet_tpu_torch.data import degrade as td
from torch_parity import FIXTURE


@pytest.fixture(scope="module")
def images():
    z = np.load(FIXTURE)
    # a drawing of each lineage, and a random uint8 image
    rnd = np.random.default_rng(0).integers(0, 256, (512, 512), np.uint8)
    return [z["images"][0], z["images"][40], rnd]


def test_each_transform_bit_equal(images):
    for img in images:
        for to in (224, 333, 448):
            np.testing.assert_array_equal(td.downscale(img, to),
                                          jd.downscale(img, to))
        for r in (0.6, 1.3, 2.6):
            np.testing.assert_array_equal(td.blur(img, r), jd.blur(img, r))
        for q in (10, 27, 45):
            np.testing.assert_array_equal(td.jpeg(img, q), jd.jpeg(img, q))
        np.testing.assert_array_equal(td.erode_strokes(img),
                                      jd.erode_strokes(img))
        np.testing.assert_array_equal(td.gray_scan(img), jd.gray_scan(img))
        for p in (0.5, 1.0):
            a = td.erode_partial(img, random.Random(3), p)
            b = jd.erode_partial(img, random.Random(3), p)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hard", [False, True])
def test_random_degrade_same_draws(images, hard):
    r_t, r_j = random.Random(17), random.Random(17)
    for _ in range(4):
        for img in images[:2]:
            np.testing.assert_array_equal(
                td.random_degrade(img, r_t, hard=hard),
                jd.random_degrade(img, r_j, hard=hard))
            assert r_t.getstate() == r_j.getstate()
