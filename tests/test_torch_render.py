"""The port's drawing stack against abcnet_tpu's, on the CPU: bit-equal.

  * the shipped fonts are the bytes of the files the JAX package loads
    from matplotlib, and a face that is not shipped raises (no fallback);
  * data/raster.py Canvas (every primitive, text in every face) and
    text_size; data/raster2.py Canvas2 and stroke_text_size;
  * data/render.py render and data/render2.py render_b on molecules with
    rings, charges, hetero labels, wedges and hashes, in several styles.
"""

import random

import numpy as np
import pytest

from abcnet_tpu.chem import from_smiles as jax_from_smiles
from abcnet_tpu.chem import perceive_aromaticity as jax_perceive
from abcnet_tpu.data import raster as jraster
from abcnet_tpu.data import raster2 as jraster2
from abcnet_tpu.data import render as jrender
from abcnet_tpu.data import render2 as jrender2
from abcnet_tpu.data.layout import layout as jax_layout
from abcnet_tpu_torch.chem import from_smiles, perceive_aromaticity
from abcnet_tpu_torch.data import raster, raster2, render, render2
from abcnet_tpu_torch.data.layout import layout

TEXTS = ["N", "OH", "NH2+", "Cl", "[O-]", "CH3", "Br", "S", "H2N"]
MOLS = ["CC(=O)Oc1ccccc1C(=O)O", "C[N+](C)(C)Cc1ccncc1", "OC(=O)C(N)Cc1c[nH]cn1",
        "FC(F)(F)c1ccc(Cl)cc1S(=O)(=O)N", "CC(C)(C)OC(=O)N1CCC(CC1)C#N"]


def test_shipped_fonts_are_the_jax_packages_files():
    faces = raster.font_faces()
    assert sorted(faces) == sorted(raster.FONT_FAMILIES)
    for family in raster.FONT_FAMILIES:
        path = jraster._font_path(family)
        assert path is not None, "the JAX package finds no font file"
        with open(path, "rb") as f:
            assert faces[family] == f.read(), family


def test_missing_font_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="not shipped"):
        raster.get_font("DejaVuSansMono.ttf", 20)
    with pytest.raises(FileNotFoundError, match="is missing"):
        raster.font_faces(str(tmp_path / "nothing.tar.xz"))
    import tarfile
    partial = tmp_path / "partial.tar.xz"
    with tarfile.open(partial, "w:xz") as tf:
        src = tmp_path / "DejaVuSans.ttf"
        src.write_bytes(raster.font_faces()["DejaVuSans.ttf"])
        tf.add(src, arcname="DejaVuSans.ttf")
    with pytest.raises(FileNotFoundError, match="missing from"):
        raster.font_faces(str(partial))


@pytest.mark.parametrize("family", raster.FONT_FAMILIES)
def test_text_size_and_canvas_text(family):
    for size in (9, 17, 24, 31):
        for text in TEXTS:
            assert raster.text_size(text, family, size) == \
                jraster.text_size(text, family, size)
    ours, theirs = raster.Canvas(160), jraster.Canvas(160)
    for cv in (ours, theirs):
        for i, text in enumerate(TEXTS):
            cv.text(text, (8 + 16 * i, 4 + 9 * i), family, 11 + 2 * i)
    np.testing.assert_array_equal(ours.to_array(), theirs.to_array())


@pytest.mark.parametrize("ss", [1, 2, 3])
def test_canvas_primitives(ss):
    ours, theirs = raster.Canvas(96, supersample=ss), \
        jraster.Canvas(96, supersample=ss)
    for cv in (ours, theirs):
        cv.line((5.3, 7.1), (80.2, 60.9), 1.4)
        cv.line((10, 90), (90, 10), 4.0, color=40)          # round caps
        cv.polygon([(20, 20), (30.5, 50), (12, 44.2)], color=10)
        cv.rectangle((40, 40), (55.5, 70), color=255)
        cv.ellipse((60, 30), 12.5, 1.5, color=0)
    np.testing.assert_array_equal(ours.to_array(), theirs.to_array())


@pytest.mark.parametrize("aa", [0.0, 0.8, 1.2])
def test_canvas2_and_stroke_text(aa):
    for text in TEXTS:
        for size in (14.0, 22.5):
            assert raster2.stroke_text_size(text, size) == \
                jraster2.stroke_text_size(text, size)
    ours, theirs = raster2.Canvas2(128, aa=aa), jraster2.Canvas2(128, aa=aa)
    for cv in (ours, theirs):
        cv.line((5.5, 6), (120, 100.3), 2.2)
        cv.polyline([(10, 10), (40, 20.5), (30, 60)], 1.3)
        cv.polygon([(60, 60), (70, 90), (50, 80)])
        cv.circle((90, 40), 14.2, 1.8)
        cv.erase_disc((90, 40), 5.0)
        cv.stroke_text("NH2+", (110, 20), 18, 1.6)
    np.testing.assert_array_equal(ours.to_array(), theirs.to_array())


def _both(smiles, seed):
    m_t, m_j = from_smiles(smiles), jax_from_smiles(smiles)
    perceive_aromaticity(m_t)
    jax_perceive(m_j)
    return (m_t, layout(m_t, random.Random(seed))), \
        (m_j, jax_layout(m_j, random.Random(seed)))


def _wedge(mols):
    """Mark the first acyclic single bond of each molecule as a wedge and
    the second as a hash (same bonds on both sides)."""
    from abcnet_tpu_torch.chem.mol import STEREO_HASH, STEREO_WEDGE
    for m in mols:
        ring = m.ring_bond_flags()
        picked = [i for i, b in enumerate(m.bonds)
                  if b.order == 1 and not b.aromatic and not ring[i]][:2]
        for i, tag in zip(picked, (STEREO_WEDGE, STEREO_HASH)):
            m.bonds[i].stereo = tag


@pytest.mark.parametrize("k", range(len(MOLS)))
def test_render_and_render_b_bit_equal(k):
    (m_t, c_t), (m_j, c_j) = _both(MOLS[k], seed=k)
    _wedge([m_t, m_j])
    drawn = {"a": 0, "b": 0}
    for s in range(3):
        rs_t, rs_j = random.Random(100 * k + s), random.Random(100 * k + s)
        for engine in ("a", "b"):
            aromatic = bool(s % 2)
            if engine == "a":
                got = render.render(m_t, c_t, render.RenderStyle.random(rs_t),
                                    rs_t, aromatic_render=aromatic)
                want = jrender.render(m_j, c_j,
                                      jrender.RenderStyle.random(rs_j), rs_j,
                                      aromatic_render=aromatic)
            else:
                got = render2.render_b(
                    m_t, c_t, render2.RenderStyleB.random(rs_t), rs_t,
                    aromatic_render=aromatic)
                want = jrender2.render_b(
                    m_j, c_j, jrender2.RenderStyleB.random(rs_j), rs_j,
                    aromatic_render=aromatic)
            assert (got is None) == (want is None)
            if got is not None:
                drawn[engine] += 1
                np.testing.assert_array_equal(got.image, want.image)
                assert got.atom_rc == want.atom_rc
                assert got.bond_px == want.bond_px
            assert rs_t.getstate() == rs_j.getstate()
    assert min(drawn.values()) >= 1, drawn
