"""Tiny 5x4 bitmap font for stamping labels onto comparison sheets (copy
of `spfsplatv2_tpu/utils/minifont.py`): host-side numpy, needing no font
file.
"""

from __future__ import annotations

import numpy as np

# Each glyph is 5 rows x 4 cols, encoded as 5 4-bit row masks (MSB = left).
_GLYPHS: dict[str, tuple[int, ...]] = {
    "A": (0b0110, 0b1001, 0b1111, 0b1001, 0b1001),
    "B": (0b1110, 0b1001, 0b1110, 0b1001, 0b1110),
    "C": (0b0111, 0b1000, 0b1000, 0b1000, 0b0111),
    "D": (0b1110, 0b1001, 0b1001, 0b1001, 0b1110),
    "E": (0b1111, 0b1000, 0b1110, 0b1000, 0b1111),
    "F": (0b1111, 0b1000, 0b1110, 0b1000, 0b1000),
    "G": (0b0111, 0b1000, 0b1011, 0b1001, 0b0111),
    "H": (0b1001, 0b1001, 0b1111, 0b1001, 0b1001),
    "I": (0b0111, 0b0010, 0b0010, 0b0010, 0b0111),
    "J": (0b0011, 0b0001, 0b0001, 0b1001, 0b0110),
    "K": (0b1001, 0b1010, 0b1100, 0b1010, 0b1001),
    "L": (0b1000, 0b1000, 0b1000, 0b1000, 0b1111),
    "M": (0b1001, 0b1111, 0b1111, 0b1001, 0b1001),
    "N": (0b1001, 0b1101, 0b1011, 0b1001, 0b1001),
    "O": (0b0110, 0b1001, 0b1001, 0b1001, 0b0110),
    "P": (0b1110, 0b1001, 0b1110, 0b1000, 0b1000),
    "Q": (0b0110, 0b1001, 0b1001, 0b1010, 0b0101),
    "R": (0b1110, 0b1001, 0b1110, 0b1010, 0b1001),
    "S": (0b0111, 0b1000, 0b0110, 0b0001, 0b1110),
    "T": (0b1111, 0b0010, 0b0010, 0b0010, 0b0010),
    "U": (0b1001, 0b1001, 0b1001, 0b1001, 0b0110),
    "V": (0b1001, 0b1001, 0b1001, 0b0110, 0b0110),
    "W": (0b1001, 0b1001, 0b1111, 0b1111, 0b1001),
    "X": (0b1001, 0b0110, 0b0110, 0b0110, 0b1001),
    "Y": (0b1001, 0b1001, 0b0110, 0b0010, 0b0010),
    "Z": (0b1111, 0b0001, 0b0110, 0b1000, 0b1111),
    "0": (0b0110, 0b1011, 0b1101, 0b1001, 0b0110),
    "1": (0b0010, 0b0110, 0b0010, 0b0010, 0b0111),
    "2": (0b0110, 0b1001, 0b0010, 0b0100, 0b1111),
    "3": (0b1110, 0b0001, 0b0110, 0b0001, 0b1110),
    "4": (0b1001, 0b1001, 0b1111, 0b0001, 0b0001),
    "5": (0b1111, 0b1000, 0b1110, 0b0001, 0b1110),
    "6": (0b0111, 0b1000, 0b1110, 0b1001, 0b0110),
    "7": (0b1111, 0b0001, 0b0010, 0b0100, 0b0100),
    "8": (0b0110, 0b1001, 0b0110, 0b1001, 0b0110),
    "9": (0b0110, 0b1001, 0b0111, 0b0001, 0b1110),
    " ": (0, 0, 0, 0, 0),
    "(": (0b0010, 0b0100, 0b0100, 0b0100, 0b0010),
    ")": (0b0100, 0b0010, 0b0010, 0b0010, 0b0100),
    "/": (0b0001, 0b0010, 0b0010, 0b0100, 0b1000),
    "-": (0, 0, 0b1111, 0, 0),
    ".": (0, 0, 0, 0, 0b0100),
    "_": (0, 0, 0, 0, 0b1111),
}


def render_text(
    text: str, width: int | None = None, scale: int = 2, pad: int = 2
) -> np.ndarray:
    """Render `text` as a black-on-white (h, w, 3) float strip.

    If `width` is given the strip is right-padded or cropped to it.
    """
    rows = np.zeros((5, 0), np.float32)
    for ch in text.upper():
        glyph = _GLYPHS.get(ch, _GLYPHS[" "])
        cols = np.asarray(
            [[(mask >> (3 - c)) & 1 for c in range(4)] for mask in glyph],
            np.float32,
        )
        rows = np.concatenate(
            [rows, cols, np.zeros((5, 1), np.float32)], axis=1
        )
    img = 1.0 - np.kron(rows, np.ones((scale, scale), np.float32))
    img = np.pad(img, ((pad, pad), (pad, pad)), constant_values=1.0)
    if width is not None:
        if img.shape[1] < width:
            img = np.pad(
                img, ((0, 0), (0, width - img.shape[1])), constant_values=1.0
            )
        else:
            img = img[:, :width]
    return np.repeat(img[..., None], 3, axis=-1)
