"""Second rasterization engine: from-scratch numpy scanline renderer.

The reference trains across TWO genuinely different drawing programs —
RDKit SVG via cairosvg (reference rdkit_img_generate.py:89-126)
and the Indigo PNG renderer (indigo_img_generator.py:51-294) — so its
model sees two pixel distributions. Engine A (data/raster.py) plays the
RDKit role; this module is the visually independent second engine:

  * strokes are rasterized analytically from signed distance fields in
    numpy (no PIL), with BUTT/SQUARE line caps — engine A uses PIL
    polylines with round caps + 2x supersampled box-filter AA;
  * antialiasing is a 1-px linear coverage ramp on the true distance
    (optionally disabled for hard-edged bitmap output, the old-Indigo
    look) — a different edge profile from box-downsampling;
  * text is a built-in HERSHEY-STYLE STROKE FONT (polyline glyphs
    defined below, drawn with the same stroke rasterizer) — engine A
    rasterizes DejaVu TTF outlines.

Only the output contract is shared with engine A (grayscale uint8,
white background, ink = dark), so the downstream pipeline and label
records are engine-agnostic.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["Canvas2", "stroke_text_size", "GLYPHS"]


# ---------------------------------------------------------------------------
# Stroke font: each glyph is a list of strokes; a stroke is a list of
# (x, y) points in a 0..10 wide x 0..14 tall em box (y up, baseline 0,
# cap height 14). Arcs are generated as polylines at definition time.
# ---------------------------------------------------------------------------

def _arc(cx: float, cy: float, rx: float, ry: float,
         a0: float, a1: float, n: int = 14) -> List[Tuple[float, float]]:
    """Polyline approximation of an elliptic arc, angles in degrees."""
    return [(cx + rx * math.cos(math.radians(a0 + (a1 - a0) * k / n)),
             cy + ry * math.sin(math.radians(a0 + (a1 - a0) * k / n)))
            for k in range(n + 1)]


def _build_glyphs() -> Dict[str, Tuple[float, List[List[Tuple[float, float]]]]]:
    g: Dict[str, Tuple[float, List[List[Tuple[float, float]]]]] = {}
    # (advance width, strokes)
    g["C"] = (10.0, [_arc(5.5, 7, 4.5, 7, 40, 320)])
    g["O"] = (10.0, [_arc(5, 7, 4.5, 7, 0, 360)])
    g["N"] = (10.0, [[(1, 0), (1, 14)], [(1, 14), (9, 0)], [(9, 0), (9, 14)]])
    g["H"] = (10.0, [[(1, 0), (1, 14)], [(9, 0), (9, 14)], [(1, 7), (9, 7)]])
    g["P"] = (9.0, [[(1, 0), (1, 14)],
                    [(1, 14), (6, 14)] + _arc(6, 10.5, 3, 3.5, 90, -90) +
                    [(6, 7), (1, 7)]])
    g["F"] = (8.0, [[(1, 0), (1, 14)], [(1, 14), (8, 14)], [(1, 7.5), (7, 7.5)]])
    g["S"] = (9.0, [_arc(5, 10.5, 3.8, 3.5, 40, 270) +
                    _arc(5, 3.5, 3.8, 3.5, 90, -130)[1:]])
    g["B"] = (9.0, [[(1, 0), (1, 14)],
                    [(1, 14), (5.5, 14)] + _arc(5.5, 10.75, 3, 3.25, 90, -90) +
                    [(5.5, 7.5), (1, 7.5)],
                    [(1, 7.5), (5.8, 7.5)] + _arc(5.8, 3.75, 3.4, 3.75, 90, -90) +
                    [(5.8, 0), (1, 0)]])
    g["I"] = (4.0, [[(2, 0), (2, 14)]])
    g["l"] = (3.5, [[(1.5, 0), (1.5, 14)]])
    g["r"] = (6.5, [[(1, 0), (1, 9.5)],
                    [(1, 6.5)] + _arc(4.2, 6.2, 3.2, 3.3, 180, 60)])
    g["e"] = (9.0, [[(1, 5), (8.6, 5)] + _arc(4.8, 4.8, 3.8, 4.8, 3, 305)])
    g["i"] = (3.5, [[(1.5, 0), (1.5, 9.5)], [(1.5, 12.2), (1.5, 13.4)]])
    g["u"] = (9.0, [[(1, 9.5), (1, 2.5)] + _arc(4.5, 2.8, 3.5, 2.8, 180, 360) +
                    [(8, 9.5)], [(8, 9.5), (8, 0)]])
    g["a"] = (9.0, [_arc(4.6, 4.8, 3.6, 4.8, 30, 330),
                    [(8.2, 9.5), (8.2, 0)]])
    g["g"] = (9.0, [_arc(4.6, 4.8, 3.6, 4.6, 20, 340),
                    [(8.2, 9.5), (8.2, -2)] + _arc(4.6, -2.2, 3.6, 2.4, 0, -120)])
    g["n"] = (9.0, [[(1, 0), (1, 9.5)],
                    [(1, 6.8)] + _arc(4.5, 6.2, 3.5, 3.2, 180, 0) + [(8, 0)]])
    g["s"] = (8.0, [_arc(4.3, 7.3, 3.1, 2.3, 40, 270) +
                    _arc(4.3, 2.6, 3.1, 2.4, 90, -130)[1:]])
    g["t"] = (6.0, [[(2.5, 13), (2.5, 2)] + _arc(4.3, 2, 1.8, 2, 180, 290),
                    [(0.5, 9.5), (5.5, 9.5)]])
    g["b"] = (9.0, [[(1, 0), (1, 14)], _arc(4.8, 4.8, 3.4, 4.8, 95, -95)])
    g["d"] = (9.0, [[(8, 0), (8, 14)], _arc(4.2, 4.8, 3.4, 4.8, 85, 275)])
    g["c"] = (8.5, [_arc(4.8, 4.8, 3.8, 4.8, 35, 325)])
    g["o"] = (9.0, [_arc(4.5, 4.8, 3.5, 4.8, 0, 360)])
    g["0"] = (9.0, [_arc(4.5, 7, 3.5, 7, 0, 360)])
    g["1"] = (6.0, [[(1, 11), (3.5, 14)], [(3.5, 14), (3.5, 0)]])
    g["2"] = (9.0, [_arc(4.5, 10.5, 3.5, 3.5, 180, 20) +
                    [(1, 0)], [(1, 0), (8, 0)]])
    g["3"] = (9.0, [_arc(4.5, 10.6, 3.3, 3.4, 150, -80),
                    _arc(4.5, 3.6, 3.6, 3.6, 80, -150)])
    g["4"] = (9.0, [[(6.5, 0), (6.5, 14)], [(6.5, 14), (1, 4.5)],
                    [(1, 4.5), (9, 4.5)]])
    g["5"] = (9.0, [[(8, 14), (2, 14)], [(2, 14), (1.6, 8)],
                    [(1.6, 8)] + _arc(4.6, 4.4, 3.8, 4.4, 115, -115)])
    g["6"] = (9.0, [_arc(4.6, 4.2, 3.6, 4.2, 0, 360),
                    [(7.6, 13.8), (5.4, 10.8), (3.4, 7.6), (2.1, 5.2)]])
    g["7"] = (9.0, [[(1, 14), (9, 14)], [(9, 14), (3.5, 0)]])
    g["8"] = (9.0, [_arc(4.5, 10.6, 3.1, 3.4, 0, 360),
                    _arc(4.5, 3.6, 3.6, 3.6, 0, 360)])
    g["9"] = (9.0, [_arc(4.4, 9.8, 3.6, 4.2, 0, 360),
                    [(7.9, 8.8), (6.6, 5.0), (4.8, 1.6), (3.4, 0.2)]])
    g["+"] = (9.0, [[(4.5, 2.5), (4.5, 11.5)], [(0.5, 7), (8.5, 7)]])
    g["-"] = (7.0, [[(0.8, 7), (6.2, 7)]])
    g["("] = (5.0, [_arc(5.4, 6.5, 3.4, 9.0, 120, 240)])
    g[")"] = (5.0, [_arc(-0.4, 6.5, 3.4, 9.0, -60, 60)])
    return g


GLYPHS = _build_glyphs()
_EM_H = 14.0      # cap height in glyph units
_TRACK = 1.6      # inter-glyph tracking in glyph units


def stroke_text_size(text: str, size_px: float) -> Tuple[float, float]:
    """(width, height) in pixels of stroke-font text at cap height
    ``size_px``."""
    s = size_px / _EM_H
    w = 0.0
    for ch in text:
        adv, _ = GLYPHS.get(ch, (8.0, []))
        w += (adv + _TRACK) * s
    return max(0.0, w - _TRACK * s), size_px


class Canvas2:
    """Grayscale coverage canvas; ink accumulates via max-blending.

    Drawing primitives evaluate exact distance fields over the
    primitive's bounding box only. ``aa`` is the antialias ramp width
    in pixels (0 = hard binary edges, the bitmap-renderer look).
    """

    def __init__(self, size: int, aa: float = 1.0, background: int = 255):
        self.size = size
        self.aa = float(aa)
        self._ink = np.zeros((size, size), np.float32)
        self._bg = background

    # -- helpers ------------------------------------------------------
    def _bbox(self, rs, cs, pad: float):
        r0 = max(0, int(math.floor(min(rs) - pad)))
        r1 = min(self.size, int(math.ceil(max(rs) + pad)) + 1)
        c0 = max(0, int(math.floor(min(cs) - pad)))
        c1 = min(self.size, int(math.ceil(max(cs) + pad)) + 1)
        if r0 >= r1 or c0 >= c1:
            return None
        rr = np.arange(r0, r1, dtype=np.float32)[:, None]
        cc = np.arange(c0, c1, dtype=np.float32)[None, :]
        return r0, r1, c0, c1, rr, cc

    def _blend(self, r0, r1, c0, c1, cov):
        region = self._ink[r0:r1, c0:c1]
        np.maximum(region, cov, out=region)

    def _ramp(self, signed_inside: np.ndarray) -> np.ndarray:
        """Coverage from a signed 'inside' distance (>=0 inside)."""
        if self.aa <= 0:
            return (signed_inside >= 0).astype(np.float32)
        return np.clip(signed_inside / self.aa + 0.5, 0.0, 1.0)

    # -- primitives ---------------------------------------------------
    def line(self, p_rc, q_rc, width: float, color: int = 0) -> None:
        """Stroke with BUTT caps (the segment ends exactly at its
        endpoints — engine A's PIL strokes get round caps)."""
        pr, pc = p_rc
        qr, qc = q_rc
        L = math.hypot(qr - pr, qc - pc)
        hw = max(0.35, width / 2.0)
        pad = hw + self.aa + 1
        bb = self._bbox((pr, qr), (pc, qc), pad)
        if bb is None:
            return
        r0, r1, c0, c1, rr, cc = bb
        if L < 1e-6:
            d = np.hypot(rr - pr, cc - pc)
            cov = self._ramp(hw - d)
        else:
            ar, ac = (qr - pr) / L, (qc - pc) / L
            s = (rr - pr) * ar + (cc - pc) * ac        # along-axis
            d = np.abs(-(rr - pr) * ac + (cc - pc) * ar)  # perpendicular
            inside = np.minimum(hw - d, np.minimum(s, L - s))
            cov = self._ramp(inside)
        self._blend(r0, r1, c0, c1, cov * (1 - color / 255.0))

    def polyline(self, pts_rc: Sequence[Tuple[float, float]],
                 width: float, color: int = 0) -> None:
        for a, b in zip(pts_rc[:-1], pts_rc[1:]):
            self.line(a, b, width, color)

    def polygon(self, pts_rc: Sequence[Tuple[float, float]],
                color: int = 0) -> None:
        """Filled polygon via even-odd crossing test at 2x2 subsamples
        (self-contained scanline fill; no PIL)."""
        rs = [p[0] for p in pts_rc]
        cs = [p[1] for p in pts_rc]
        bb = self._bbox(rs, cs, 1.0)
        if bb is None:
            return
        r0, r1, c0, c1, rr, cc = bb
        pr = np.asarray(rs, np.float32)
        pc = np.asarray(cs, np.float32)
        qr = np.roll(pr, -1)
        qc = np.roll(pc, -1)
        cov = np.zeros((r1 - r0, c1 - c0), np.float32)
        for dr in (-0.25, 0.25):
            for dc in (-0.25, 0.25):
                y = rr + dr
                x = cc + dc
                inside = np.zeros_like(cov, dtype=bool)
                for k in range(len(pr)):
                    y0, y1p = pr[k], qr[k]
                    x0, x1p = pc[k], qc[k]
                    if y0 == y1p:
                        continue
                    crosses = ((y0 <= y) != (y1p <= y))
                    xi = x0 + (y - y0) * (x1p - x0) / (y1p - y0)
                    inside ^= crosses & (x < xi)
                cov += inside.astype(np.float32)
        self._blend(r0, r1, c0, c1, cov / 4.0 * (1 - color / 255.0))

    def circle(self, center_rc, radius: float, width: float,
               color: int = 0) -> None:
        cr, cenc = center_rc
        hw = max(0.35, width / 2.0)
        pad = radius + hw + self.aa + 1
        bb = self._bbox((cr,), (cenc,), pad)
        if bb is None:
            return
        r0, r1, c0, c1, rr, cc = bb
        d = np.hypot(rr - cr, cc - cenc)
        cov = self._ramp(hw - np.abs(d - radius))
        self._blend(r0, r1, c0, c1, cov * (1 - color / 255.0))

    def erase_disc(self, center_rc, radius: float) -> None:
        """Clear ink inside a disc (label clearing without a white
        rectangle patch)."""
        cr, cenc = center_rc
        bb = self._bbox((cr,), (cenc,), radius + 1)
        if bb is None:
            return
        r0, r1, c0, c1, rr, cc = bb
        d = np.hypot(rr - cr, cc - cenc)
        keep = 1.0 - self._ramp(radius - d)
        self._ink[r0:r1, c0:c1] *= keep

    def stroke_text(self, text: str, baseline_rc, size_px: float,
                    width: float, color: int = 0) -> None:
        """Draw stroke-font text; baseline_rc = (row of baseline,
        col of left edge); size_px = cap height."""
        s = size_px / _EM_H
        row0, col = baseline_rc
        for ch in text:
            adv, strokes = GLYPHS.get(ch, (8.0, []))
            for st in strokes:
                pts = [(row0 - y * s, col + x * s) for (x, y) in st]
                if len(pts) >= 2:
                    self.polyline(pts, width, color)
            col += (adv + _TRACK) * s

    def to_array(self) -> np.ndarray:
        out = self._bg * (1.0 - self._ink)
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
