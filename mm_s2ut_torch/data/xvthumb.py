"""XV thumbnails without Pillow (numpy only).

:func:`decode_xvthumb` gives ``np.asarray(Image.open(p).convert("RGB"))``
for every file Pillow 12's ``XVThumbImagePlugin`` opens, and
``ValueError`` naming the file for those it refuses. After the ``P7 332``
magic the rest of its line is skipped, then lines that start with ``#``;
the first other line gives the width and height, its first two fields as
Python's ``int`` reads them (fewer than two fields, or one ``int`` does not
read, is refused; a file that ends first, or a size that is not positive,
is passed on). The ``width * height`` bytes after that line index the
3-3-2 palette: red ``r * 255 // 7``, green ``g * 255 // 7``, blue
``b * 255 // 3`` of the index's high 3, middle 3 and low 2 bits.
"""
from __future__ import annotations

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_I = np.arange(256)
PALETTE = np.stack([(_I >> 5) * 255 // 7, ((_I >> 2) & 7) * 255 // 7, (_I & 3) * 255 // 3],
                   -1).astype(np.uint8)


def _line(data: bytes, pos: int):
    """``readline``: the line from ``pos`` with its ``\\n``, and the position after it."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def decode_xvthumb(data: bytes, name: str = "<xvthumb>") -> np.ndarray:
    """An XV thumbnail → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if data[:6] != b"P7 332":
        raise Unidentified(f"{name}: not an XV thumbnail file")
    _, pos = _line(data, 6)
    while True:
        s, pos = _line(data, pos)
        if not s:
            raise Unidentified(f"{name}: XV thumbnail ends in its header")
        if s[0] != 35:  # not a "#" comment
            break
    fields = s.strip().split(maxsplit=2)[:2]
    try:
        width, height = (int(f) for f in fields)
    except ValueError:
        raise ValueError(f"{name}: XV thumbnail size line {s!r}") from None
    if width <= 0 or height <= 0:
        raise Unidentified(f"{name}: XV thumbnail size {width}x{height}")
    check_pixels(width, height, name)
    if len(data) - pos < width * height:
        raise ValueError(f"{name}: XV thumbnail data truncated ({len(data) - pos} of "
                         f"{width * height} bytes)")
    return PALETTE[np.frombuffer(data, np.uint8, width * height, pos).reshape(height, width)]
