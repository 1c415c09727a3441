"""Self-contained 2-D rasterization toolkit (PIL/numpy, no OpenCV).

Own copy of abcnet_tpu/data/raster.py but for where the fonts come from.
The reference delegates rasterization to RDKit-SVG/cairosvg (reference
rdkit_img_generate.py:30-48) and the Indigo renderer
(indigo_img_generator.py:38-49). This package draws molecules itself;
this module is the drawing substrate of engine A (data/render.py):
antialiased lines, filled polygons, rectangles and text on a grayscale
canvas, plus the image I/O and resize of the input path.

Antialiasing strategy: draw on a supersampled canvas (default 2x) and
downsample with a box filter at export time — one resize per image, far
cheaper than per-primitive AA and visually equivalent to cv2.LINE_AA
output for the stroke widths used in molecule depiction.

Fonts: four DejaVu faces play the role of the reference's four Hershey
font families (rdkit .. FONT_HERSHEY_*). The JAX package finds them
inside matplotlib; this package ships the same files (their bytes equal
matplotlib's) in assets/fonts/dejavu.tar.xz, one xz-compressed tar that
is a third of their size, under their licence (LICENSE_DEJAVU beside
it), so every machine draws labels with the same glyphs. The faces are
read into memory once; a missing archive or face raises, there is no
fallback font.
"""

from __future__ import annotations

import functools
import io
import os
import tarfile
from typing import Dict, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

__all__ = ["Canvas", "FONT_FAMILIES", "FONT_ARCHIVE", "font_faces",
           "get_font", "text_size", "resize", "imwrite", "imread_gray"]

FONT_ARCHIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "fonts", "dejavu.tar.xz")

# Font families: member names in FONT_ARCHIVE (matplotlib's file names).
FONT_FAMILIES: Tuple[str, ...] = (
    "DejaVuSans.ttf",
    "DejaVuSans-Bold.ttf",
    "DejaVuSerif.ttf",
    "DejaVuSerif-Bold.ttf",
)


@functools.lru_cache(maxsize=None)
def font_faces(archive: str = FONT_ARCHIVE) -> Dict[str, bytes]:
    """{family: TTF bytes} of every face in `archive`; raises
    FileNotFoundError if the archive or one of FONT_FAMILIES is
    missing."""
    if not os.path.isfile(archive):
        raise FileNotFoundError(f"font archive {archive} is missing")
    with tarfile.open(archive, "r:xz") as tf:
        faces = {m.name: tf.extractfile(m).read()
                 for m in tf.getmembers() if m.isfile()}
    missing = [f for f in FONT_FAMILIES if f not in faces]
    if missing:
        raise FileNotFoundError(f"fonts {missing} are missing from {archive}")
    return faces


@functools.lru_cache(maxsize=None)
def get_font(family: str, size_px: int):
    """Load a sized font; size_px is the nominal glyph height in pixels.
    Raises FileNotFoundError for a family the package does not ship."""
    size_px = max(6, int(size_px))
    faces = font_faces()
    if family not in faces:
        raise FileNotFoundError(
            f"font {family!r} is not shipped: the generator draws labels "
            f"with {FONT_FAMILIES} only")
    return ImageFont.truetype(io.BytesIO(faces[family]), size_px)


def text_size(text: str, family: str, size_px: int) -> Tuple[int, int]:
    """(width, height) of the rendered text in pixels (ascender box)."""
    font = get_font(family, size_px)
    l, t, r, b = font.getbbox(text)
    return int(r - l), int(b - t)


class Canvas:
    """Supersampled grayscale canvas with (row, col) addressing.

    All public drawing methods take (row, col) points in *target* pixel
    units; the supersampling factor is internal.
    """

    def __init__(self, size: int, supersample: int = 2, background: int = 255):
        self.size = size
        self.ss = supersample
        self._img = Image.new("L", (size * supersample, size * supersample),
                              background)
        self._draw = ImageDraw.Draw(self._img)

    # -- coordinate helper: (row, col) -> supersampled (x, y) ---------
    def _xy(self, p_rc: Tuple[float, float]) -> Tuple[float, float]:
        return (p_rc[1] * self.ss, p_rc[0] * self.ss)

    def line(self, p_rc, q_rc, width: float, color: int = 0) -> None:
        w = max(1, int(round(width * self.ss)))
        self._draw.line([self._xy(p_rc), self._xy(q_rc)], fill=color, width=w)
        # Round caps for thick strokes (cv2.line default behavior).
        if w >= 3 * self.ss:
            r = w / 2
            for pt in (p_rc, q_rc):
                x, y = self._xy(pt)
                self._draw.ellipse([x - r, y - r, x + r, y + r], fill=color)

    def polygon(self, pts_rc: Sequence[Tuple[float, float]],
                color: int = 0) -> None:
        self._draw.polygon([self._xy(p) for p in pts_rc], fill=color)

    def rectangle(self, rc_min, rc_max, color: int = 255) -> None:
        x0, y0 = self._xy(rc_min)
        x1, y1 = self._xy(rc_max)
        self._draw.rectangle([min(x0, x1), min(y0, y1),
                              max(x0, x1), max(y0, y1)], fill=color)

    def ellipse(self, center_rc, radius: float, width: float,
                color: int = 0) -> None:
        x, y = self._xy(center_rc)
        r = radius * self.ss
        w = max(1, int(round(width * self.ss)))
        self._draw.ellipse([x - r, y - r, x + r, y + r],
                           outline=color, width=w)

    def text(self, text: str, topleft_rc, family: str, size_px: int,
             color: int = 0) -> None:
        """Draw text with its bounding box's top-left at topleft_rc."""
        font = get_font(family, size_px * self.ss)
        x, y = self._xy(topleft_rc)
        l, t, _, _ = font.getbbox(text)
        self._draw.text((x - l, y - t), text, fill=color, font=font)

    def to_array(self) -> np.ndarray:
        """Downsample to (size, size) uint8."""
        if self.ss == 1:
            return np.asarray(self._img, np.uint8).copy()
        out = self._img.resize((self.size, self.size), Image.BOX)
        return np.asarray(out, np.uint8).copy()


def resize(img: np.ndarray, out_hw: Tuple[int, int],
           resample=Image.BILINEAR) -> np.ndarray:
    """Resize a grayscale array to (rows, cols) — cv2.resize equivalent
    for the augmentation path (reference src/utils.py:50-54)."""
    h, w = out_hw
    pil = Image.fromarray(np.asarray(img).astype(np.uint8))
    return np.asarray(pil.resize((w, h), resample), np.uint8)


def imwrite(path: str, img: np.ndarray) -> None:
    Image.fromarray(np.asarray(img).astype(np.uint8)).save(path)


def imread_gray(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("L"), np.uint8)
