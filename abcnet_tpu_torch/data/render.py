"""Molecule rasterization: graph + 2-D layout -> grayscale training image.

Replaces the reference's RDKit-SVG (rdkit_img_generate.py:89-126) and
Indigo-PNG (indigo_img_generator.py:51-183) renderers with the
framework's own PIL/numpy rasterizer (data/raster.py). Style is
randomized per image the same way the reference randomizes renderer
options: bond line width 1-5, multiple-bond offset 0.1-0.25 of bond
length, global rotation, label modes (all / terminal-hetero / hetero),
four font families (bold variants playing the reference's 25 % bold-font
role), padding.

Returns the image plus per-atom pixel coordinates in the reference's
(row, col) convention (rdkit_img_generate.py:132: x = vertical).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..chem.mol import Mol, STEREO_HASH, STEREO_WEDGE
from . import raster

_FONTS = list(raster.FONT_FAMILIES)

# Nominal glyph height in px at font_scale == 1 (matches cv2's Hershey
# metrics closely enough that the reference's scale range carries over).
_BASE_FONT_PX = 24


@dataclass
class RenderStyle:
    size: int = 512
    bond_width: int = 2
    multiple_bond_offset: float = 0.18   # fraction of bond length
    rotation: float = 0.0                # radians
    label_mode: str = "hetero"           # all | terminal-hetero | hetero
    font: str = "DejaVuSans.ttf"
    font_scale: float = 0.9
    font_thickness: int = 1
    padding: float = 0.12                # fraction of canvas
    aromatic_circles: bool = False       # dashed inner line if False

    @property
    def font_px(self) -> int:
        return max(8, int(round(_BASE_FONT_PX * self.font_scale)))

    @staticmethod
    def random(rng: random.Random, size: int = 512) -> "RenderStyle":
        return RenderStyle(
            size=size,
            bond_width=rng.randint(1, 5),
            multiple_bond_offset=rng.uniform(0.12, 0.25),
            rotation=rng.uniform(0, 2 * math.pi),
            label_mode=rng.choice(["all", "terminal-hetero", "hetero",
                                   "hetero"]),
            font=rng.choice(_FONTS),
            font_scale=rng.uniform(0.65, 1.1),
            font_thickness=rng.choice([1, 1, 2]),
            padding=rng.uniform(0.06, 0.25),
        )


@dataclass
class RenderResult:
    image: np.ndarray                    # (size, size) uint8, white bg
    atom_rc: List[Tuple[float, float]]   # per-atom (row, col) pixel coords
    bond_px: float                       # mean bond length in pixels


def _label_visible(mol: Mol, idx: int, mode: str) -> bool:
    a = mol.atoms[idx]
    if a.symbol != "C":
        return True
    if a.charge != 0:
        return True
    if mode == "all":
        return True
    if mode == "terminal-hetero" and mol.degree(idx) <= 1:
        return True
    return False


def _label_parts(mol: Mol, idx: int) -> List[Tuple[str, str]]:
    """[(text, kind)] with kind in {sym, sub, sup}; H on the left when
    bonds come mostly from the right."""
    a = mol.atoms[idx]
    parts: List[Tuple[str, str]] = [(a.symbol, "sym")]
    h = a.total_hs
    if h >= 1 and (a.symbol != "C" or mol.degree(idx) <= 1):
        parts.append(("H", "h"))
        if h > 1:
            parts.append((str(h), "sub"))
    if a.charge == 1:
        parts.append(("+", "sup"))
    elif a.charge == -1:
        parts.append(("-", "sup"))
    elif a.charge > 1:
        parts.append((f"{a.charge}+", "sup"))
    elif a.charge < -1:
        parts.append((f"{-a.charge}-", "sup"))
    return parts


def render(mol: Mol, coords: Sequence[Tuple[float, float]],
           style: Optional[RenderStyle] = None,
           rng: Optional[random.Random] = None,
           aromatic_render: bool = False) -> Optional[RenderResult]:
    """Rasterize. Returns None when the depiction would be too crowded
    (min atom distance <= 10 px), matching the reference's rejection rule
    (rdkit_img_generate.py:146-148, indigo_img_generator.py:195-197)."""
    rng = rng or random.Random(0)
    style = style or RenderStyle.random(rng)
    size = style.size

    pts = np.asarray(coords, dtype=np.float64)
    if len(pts) == 0:
        return None
    c, s = math.cos(style.rotation), math.sin(style.rotation)
    rot = pts @ np.array([[c, s], [-s, c]])

    span = rot.max(axis=0) - rot.min(axis=0)
    span = np.maximum(span, 1e-6)
    usable = size * (1.0 - 2 * style.padding)
    scale = usable / max(span[0], span[1])
    # Clamp so bond length lands in a readable range.
    scale = float(np.clip(scale, 22.0, 75.0))

    xy = (rot - rot.min(axis=0)) * scale
    extent = xy.max(axis=0)
    offset = (size - extent) / 2.0
    xy = xy + offset
    # (x, y) layout -> pixel (col, row); row = size - y for y-up layouts.
    cols = xy[:, 0]
    rows = xy[:, 1]

    # Rejection rule on pixel distances.
    if len(pts) > 1:
        d2 = ((rows[:, None] - rows[None, :]) ** 2 +
              (cols[:, None] - cols[None, :]) ** 2 +
              np.eye(len(pts)) * 1e9)
        if d2.min() <= 100.0:
            return None
    if rows.min() <= 4 or rows.max() >= size - 4 or \
            cols.min() <= 4 or cols.max() >= size - 4:
        return None

    canvas = raster.Canvas(size, supersample=2)

    bond_lens = []
    for b in mol.bonds:
        bond_lens.append(math.hypot(rows[b.a] - rows[b.b],
                                    cols[b.a] - cols[b.b]))
    bond_px = float(np.mean(bond_lens)) if bond_lens else 30.0

    # Ring centroids for double-bond inner-line placement.
    rings = mol.sssr()
    bond_ring_centroid = {}
    for ring in rings:
        rc = (float(np.mean([rows[i] for i in ring])),
              float(np.mean([cols[i] for i in ring])))
        rset = set(ring)
        n = len(ring)
        for i in range(n):
            a, bq = ring[i], ring[(i + 1) % n]
            bond = mol.bond_between(a, bq)
            if bond is not None:
                key = id(bond)
                bond_ring_centroid.setdefault(key, rc)

    # Label geometry first (bond lines stop at label boundary).
    label_radius = np.zeros(len(pts))
    labels = []
    for i in range(mol.num_atoms):
        if not _label_visible(mol, i, style.label_mode):
            labels.append(None)
            continue
        parts = _label_parts(mol, i)
        labels.append(parts)
        w, h = raster.text_size(mol.atoms[i].symbol, style.font,
                                style.font_px)
        label_radius[i] = max(w, h) * 0.75

    def endpoint(a: int, b: int) -> Tuple[float, float]:
        """Start of the bond line at atom a heading to b (label-trimmed)."""
        ra, ca = rows[a], cols[a]
        rb, cb = rows[b], cols[b]
        d = math.hypot(rb - ra, cb - ca) or 1.0
        t = label_radius[a] / d
        return ra + (rb - ra) * t, ca + (cb - ca) * t

    def draw_line(p, q, width=None):
        canvas.line(p, q, width or style.bond_width)

    off = style.multiple_bond_offset * bond_px

    for b in mol.bonds:
        p = endpoint(b.a, b.b)
        q = endpoint(b.b, b.a)
        dr, dc = q[0] - p[0], q[1] - p[1]
        dlen = math.hypot(dr, dc) or 1.0
        # Perpendicular unit vector.
        ur, uc = -dc / dlen, dr / dlen

        centroid = bond_ring_centroid.get(id(b))
        if centroid is not None:
            mid = ((p[0] + q[0]) / 2, (p[1] + q[1]) / 2)
            to_c = (centroid[0] - mid[0], centroid[1] - mid[1])
            if to_c[0] * ur + to_c[1] * uc < 0:
                ur, uc = -ur, -uc

        if b.stereo == STEREO_WEDGE:
            # Solid wedge: narrow at a, wide at b.
            wnarrow = max(1.0, style.bond_width * 0.7)
            wwide = max(4.0, 0.18 * dlen)
            a0 = endpoint(b.a, b.b)
            b0 = endpoint(b.b, b.a)
            canvas.polygon([
                (a0[0] - ur * wnarrow / 2, a0[1] - uc * wnarrow / 2),
                (a0[0] + ur * wnarrow / 2, a0[1] + uc * wnarrow / 2),
                (b0[0] + ur * wwide / 2, b0[1] + uc * wwide / 2),
                (b0[0] - ur * wwide / 2, b0[1] - uc * wwide / 2),
            ])
        elif b.stereo == STEREO_HASH:
            nticks = max(4, int(dlen / 5))
            for k in range(nticks + 1):
                t = k / nticks
                w = (1 - t) * 1.0 + t * max(4.0, 0.18 * dlen)
                cr = p[0] + dr * t
                cc = p[1] + dc * t
                draw_line((cr - ur * w / 2, cc - uc * w / 2),
                          (cr + ur * w / 2, cc + uc * w / 2),
                          max(1, style.bond_width // 2 + 1))
        elif b.aromatic and aromatic_render:
            # Aromatic render: solid main line + dashed inner line.
            draw_line(p, q)
            _dashed(canvas, (p[0] + ur * off, p[1] + uc * off),
                    (q[0] + ur * off, q[1] + uc * off),
                    style.bond_width, shrink=0.15)
        elif b.order == 1:
            draw_line(p, q)
        elif b.order == 2:
            if centroid is not None:
                draw_line(p, q)
                sp = (p[0] + ur * off + dr * 0.15,
                      p[1] + uc * off + dc * 0.15)
                sq = (q[0] + ur * off - dr * 0.15,
                      q[1] + uc * off - dc * 0.15)
                draw_line(sp, sq)
            else:
                draw_line((p[0] + ur * off / 2, p[1] + uc * off / 2),
                          (q[0] + ur * off / 2, q[1] + uc * off / 2))
                draw_line((p[0] - ur * off / 2, p[1] - uc * off / 2),
                          (q[0] - ur * off / 2, q[1] - uc * off / 2))
        elif b.order == 3:
            draw_line(p, q)
            draw_line((p[0] + ur * off, p[1] + uc * off),
                      (q[0] + ur * off, q[1] + uc * off))
            draw_line((p[0] - ur * off, p[1] - uc * off),
                      (q[0] - ur * off, q[1] - uc * off))

    # Labels last (white backing patch erases bond stubs underneath).
    for i, parts in enumerate(labels):
        if parts is None:
            continue
        _draw_label(canvas, mol, i, parts, rows[i], cols[i], style)

    return RenderResult(image=canvas.to_array(),
                        atom_rc=list(zip(rows, cols)),
                        bond_px=bond_px)


def _dashed(canvas, p, q, width, shrink=0.0, dashes=4):
    dr, dc = q[0] - p[0], q[1] - p[1]
    p = (p[0] + dr * shrink, p[1] + dc * shrink)
    q = (q[0] - dr * shrink, q[1] - dc * shrink)
    dr, dc = q[0] - p[0], q[1] - p[1]
    for k in range(dashes):
        t0 = k / dashes
        t1 = t0 + 0.6 / dashes
        canvas.line((p[0] + dr * t0, p[1] + dc * t0),
                    (p[0] + dr * t1, p[1] + dc * t1), width)


def _draw_label(canvas, mol, idx, parts, row, col, style: RenderStyle):
    font = style.font
    px = style.font_px
    sub_px = max(7, int(px * 0.62))

    # Measure parts.
    sizes = []
    for text, kind in parts:
        scale = px if kind in ("sym", "h") else sub_px
        sizes.append(raster.text_size(text, font, scale))
    sym_w, sym_h = sizes[0]

    total_w = sum(w for (w, h) in sizes)
    # Anchor: element glyph centered at atom position.
    x0 = col - sym_w / 2
    y_base = row + sym_h / 2

    # White backing patch.
    pad = max(2, int(sym_h * 0.25))
    canvas.rectangle((y_base - sym_h - pad, x0 - pad),
                     (y_base + pad, x0 + total_w + pad), 255)

    x = x0
    for (text, kind), (w, h) in zip(parts, sizes):
        if kind in ("sym", "h"):
            canvas.text(text, (y_base - h, x), font, px)
        elif kind == "sub":
            canvas.text(text, (y_base - h + h * 0.35, x), font, sub_px)
        else:  # sup
            canvas.text(text, (y_base - sym_h * 0.6 - h, x), font, sub_px)
        x += w
