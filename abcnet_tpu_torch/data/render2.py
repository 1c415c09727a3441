"""Engine B: second, visually independent molecule drawing program.

The reference's training corpus spans two renderers with different
pixel conventions — RDKit SVG (rdkit_img_generate.py:89-126) and Indigo
PNG (indigo_img_generator.py:51-294). Engine A (data/render.py) covers
the first role; this engine is the second visual family, drawn on the
from-scratch numpy rasterizer (data/raster2.py):

  * stroke-font element labels (polyline glyphs) vs engine A's DejaVu
    TTF rasterization;
  * butt-capped strokes, signed-distance AA (or hard binary edges)
    vs PIL round caps + box-downsample;
  * double bonds ALWAYS as symmetric twin lines (no ring inner-line
    shortening — the Indigo-style convention);
  * aromatic rings drawn as INSCRIBED CIRCLES over single-order outer
    bonds (engine A: per-bond dashed inner line);
  * hash wedges as evenly spaced CONSTANT-width ticks (engine A:
    tapered);
  * labels clear a disc of ink and draw glyphs with no white backing
    rectangle, so bond stubs meet labels with round gaps rather than
    square patches.

The output contract (RenderResult: image / atom pixel coords / mean
bond px) and the rejection rules (min 10 px atom spacing, 4 px border)
are shared with engine A — they are dataset semantics, not style.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..chem.mol import Mol, STEREO_HASH, STEREO_WEDGE
from .raster2 import Canvas2, stroke_text_size
from .render import RenderResult

_SUB = {"0": "0", "1": "1", "2": "2", "3": "3", "4": "4", "5": "5",
        "6": "6", "7": "7", "8": "8", "9": "9"}


@dataclass
class RenderStyleB:
    size: int = 512
    bond_width: float = 2.0
    multiple_bond_offset: float = 0.20   # fraction of bond length
    rotation: float = 0.0
    label_mode: str = "hetero"           # all | terminal-hetero | hetero
    font_px: int = 22                    # stroke-font cap height
    stroke_w: float = 2.0                # glyph stroke width
    padding: float = 0.12
    aa: float = 1.0                      # 0 = hard edges (bitmap look)
    aromatic_circle_r: float = 0.55      # fraction of ring radius

    @staticmethod
    def random(rng: random.Random, size: int = 512) -> "RenderStyleB":
        return RenderStyleB(
            size=size,
            bond_width=rng.uniform(1.0, 4.2),
            multiple_bond_offset=rng.uniform(0.14, 0.27),
            rotation=rng.uniform(0, 2 * math.pi),
            label_mode=rng.choice(["all", "terminal-hetero", "hetero",
                                   "hetero"]),
            font_px=rng.randint(16, 28),
            stroke_w=rng.uniform(1.2, 2.6),
            padding=rng.uniform(0.06, 0.25),
            aa=rng.choice([0.0, 0.8, 1.2]),
            aromatic_circle_r=rng.uniform(0.5, 0.62),
        )


def _label_visible(mol: Mol, idx: int, mode: str) -> bool:
    a = mol.atoms[idx]
    if a.symbol != "C" or a.charge != 0:
        return True
    if mode == "all":
        return True
    if mode == "terminal-hetero" and mol.degree(idx) <= 1:
        return True
    return False


def _label_text(mol: Mol, idx: int) -> List[Tuple[str, str]]:
    """[(text, kind)] with kind in {sym, sub, sup} — same content rules
    as engine A (_label_parts, render.py:88-106), different typography."""
    a = mol.atoms[idx]
    parts: List[Tuple[str, str]] = [(a.symbol, "sym")]
    h = a.total_hs
    if h >= 1 and (a.symbol != "C" or mol.degree(idx) <= 1):
        parts.append(("H", "sym"))
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


def render_b(mol: Mol, coords: Sequence[Tuple[float, float]],
             style: Optional[RenderStyleB] = None,
             rng: Optional[random.Random] = None,
             aromatic_render: bool = False) -> Optional[RenderResult]:
    """Engine-B rasterization. Same rejection contract as engine A's
    render() (render.py:141-150): None when atoms come closer than
    10 px or touch the 4 px border."""
    rng = rng or random.Random(0)
    style = style or RenderStyleB.random(rng)
    size = style.size

    pts = np.asarray(coords, dtype=np.float64)
    if len(pts) == 0:
        return None
    c, s = math.cos(style.rotation), math.sin(style.rotation)
    rot = pts @ np.array([[c, s], [-s, c]])

    span = np.maximum(rot.max(axis=0) - rot.min(axis=0), 1e-6)
    usable = size * (1.0 - 2 * style.padding)
    scale = float(np.clip(usable / max(span[0], span[1]), 22.0, 75.0))
    xy = (rot - rot.min(axis=0)) * scale
    xy = xy + (size - xy.max(axis=0)) / 2.0
    cols = xy[:, 0]
    rows = xy[:, 1]

    if len(pts) > 1:
        d2 = ((rows[:, None] - rows[None, :]) ** 2 +
              (cols[:, None] - cols[None, :]) ** 2 +
              np.eye(len(pts)) * 1e9)
        if d2.min() <= 100.0:
            return None
    if rows.min() <= 4 or rows.max() >= size - 4 or \
            cols.min() <= 4 or cols.max() >= size - 4:
        return None

    canvas = Canvas2(size, aa=style.aa)

    bond_lens = [math.hypot(rows[b.a] - rows[b.b], cols[b.a] - cols[b.b])
                 for b in mol.bonds]
    bond_px = float(np.mean(bond_lens)) if bond_lens else 30.0
    off = style.multiple_bond_offset * bond_px

    # Label footprint radii (bond strokes stop short of label ink).
    label_radius = np.zeros(len(pts))
    labels: List[Optional[List[Tuple[str, str]]]] = []
    for i in range(mol.num_atoms):
        if not _label_visible(mol, i, style.label_mode):
            labels.append(None)
            continue
        parts = _label_text(mol, i)
        labels.append(parts)
        w, h = stroke_text_size(mol.atoms[i].symbol, style.font_px)
        label_radius[i] = max(w, h) * 0.72

    def endpoint(a: int, b: int) -> Tuple[float, float]:
        ra, ca = rows[a], cols[a]
        rb, cb = rows[b], cols[b]
        d = math.hypot(rb - ra, cb - ca) or 1.0
        t = label_radius[a] / d
        return ra + (rb - ra) * t, ca + (cb - ca) * t

    # Aromatic rings drawn as circles: collect SSSR rings whose bonds
    # are all aromatic; their bonds render as plain single strokes.
    circle_bonds = set()
    circles: List[Tuple[float, float, float]] = []
    if aromatic_render:
        for ring in mol.sssr():
            n = len(ring)
            bonds = []
            for i in range(n):
                bd = mol.bond_between(ring[i], ring[(i + 1) % n])
                if bd is None or not bd.aromatic:
                    bonds = None
                    break
                bonds.append(id(bd))
            if bonds:
                rc = float(np.mean([rows[i] for i in ring]))
                cc = float(np.mean([cols[i] for i in ring]))
                rad = float(np.mean([math.hypot(rows[i] - rc, cols[i] - cc)
                                     for i in ring]))
                circles.append((rc, cc, rad * style.aromatic_circle_r))
                circle_bonds.update(bonds)

    w = style.bond_width
    for b in mol.bonds:
        p = endpoint(b.a, b.b)
        q = endpoint(b.b, b.a)
        dr, dc = q[0] - p[0], q[1] - p[1]
        dlen = math.hypot(dr, dc) or 1.0
        ur, uc = -dc / dlen, dr / dlen  # perpendicular unit

        if b.stereo == STEREO_WEDGE:
            wwide = max(4.0, 0.16 * dlen)
            canvas.polygon([
                (p[0] - ur * 0.6, p[1] - uc * 0.6),
                (p[0] + ur * 0.6, p[1] + uc * 0.6),
                (q[0] + ur * wwide / 2, q[1] + uc * wwide / 2),
                (q[0] - ur * wwide / 2, q[1] - uc * wwide / 2),
            ])
        elif b.stereo == STEREO_HASH:
            # Constant-width perpendicular ticks (Indigo convention;
            # engine A tapers them).
            tick_w = max(4.0, 0.16 * dlen) * 0.9
            nticks = max(4, int(dlen / 4.5))
            for k in range(nticks + 1):
                t = k / nticks
                cr = p[0] + dr * t
                cc2 = p[1] + dc * t
                canvas.line((cr - ur * tick_w / 2, cc2 - uc * tick_w / 2),
                            (cr + ur * tick_w / 2, cc2 + uc * tick_w / 2),
                            max(1.0, w * 0.7))
        elif b.aromatic and aromatic_render and id(b) in circle_bonds:
            canvas.line(p, q, w)
        elif b.aromatic and aromatic_render:
            # Aromatic bond outside a fully aromatic SSSR ring: solid
            # line + short dashed partner (rare fallback).
            canvas.line(p, q, w)
            _dashes(canvas, (p[0] + ur * off, p[1] + uc * off),
                    (q[0] + ur * off, q[1] + uc * off), w)
        elif b.order == 1:
            canvas.line(p, q, w)
        elif b.order == 2:
            # Symmetric twin lines, full length — never the ring
            # inner-line style.
            canvas.line((p[0] + ur * off / 2, p[1] + uc * off / 2),
                        (q[0] + ur * off / 2, q[1] + uc * off / 2), w)
            canvas.line((p[0] - ur * off / 2, p[1] - uc * off / 2),
                        (q[0] - ur * off / 2, q[1] - uc * off / 2), w)
        elif b.order == 3:
            canvas.line(p, q, w)
            canvas.line((p[0] + ur * off, p[1] + uc * off),
                        (q[0] + ur * off, q[1] + uc * off), w)
            canvas.line((p[0] - ur * off, p[1] - uc * off),
                        (q[0] - ur * off, q[1] - uc * off), w)

    for (rc, cc, rad) in circles:
        canvas.circle((rc, cc), rad, max(1.0, w * 0.8))

    # Labels: clear a disc (no rectangle patch), then stroke glyphs.
    for i, parts in enumerate(labels):
        if parts is None:
            continue
        _draw_label_b(canvas, parts, rows[i], cols[i], style)

    return RenderResult(image=canvas.to_array(),
                        atom_rc=list(zip(rows, cols)),
                        bond_px=bond_px)


def _dashes(canvas: Canvas2, p, q, width, dashes: int = 5) -> None:
    dr, dc = q[0] - p[0], q[1] - p[1]
    for k in range(dashes):
        t0 = k / dashes + 0.08 / dashes
        t1 = t0 + 0.55 / dashes
        canvas.line((p[0] + dr * t0, p[1] + dc * t0),
                    (p[0] + dr * t1, p[1] + dc * t1), width)


def _draw_label_b(canvas: Canvas2, parts, row, col,
                  style: RenderStyleB) -> None:
    px = style.font_px
    sub_px = max(9, int(px * 0.66))
    sizes = []
    for text, kind in parts:
        sizes.append(stroke_text_size(text, px if kind == "sym" else sub_px))
    sym_w, sym_h = sizes[0]
    total_w = sum(wd for (wd, _) in sizes)

    # Clear ink under the label (disc sized to the full label).
    canvas.erase_disc((row, col + (total_w - sym_w) / 2),
                      max(total_w / 2 + 1.5, sym_h * 0.68))

    x = col - sym_w / 2
    base = row + sym_h / 2
    for (text, kind), (wd, hh) in zip(parts, sizes):
        if kind == "sym":
            canvas.stroke_text(text, (base, x), px, style.stroke_w)
        elif kind == "sub":
            canvas.stroke_text(text, (base + hh * 0.45, x), sub_px,
                               style.stroke_w * 0.9)
        else:  # sup
            canvas.stroke_text(text, (base - sym_h * 0.62, x), sub_px,
                               style.stroke_w * 0.9)
        x += wd
