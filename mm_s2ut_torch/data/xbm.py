"""X11 bitmaps (XBM) without Pillow (numpy only).

:func:`decode_xbm` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``XbmImagePlugin`` and its ``xbm`` decoder
(``XbmDecode.c``) open, and ``ValueError`` naming the file for those it
refuses:

* the header is Pillow's regular expression over the first 512 bytes:
  leading whitespace, ``#define ..._width N`` and ``#define ..._height N``
  on lines of their own, an optional ``_x_hot``/``_y_hot`` pair, then
  anything up to the last ``_bits[]`` in those bytes, where the data
  starts. A file it does not match, or of width or height 0, passes on;
* each byte is the two characters after the next ``x`` read as hex digits
  (any other character counts 0, so ``0x5,`` is 0x50), the search going
  on three characters later; rows of ``ceil(width / 8)`` bytes, each
  byte's bits least significant first, a set bit white (``1;R``).
"""
from __future__ import annotations

import re

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _HEX[bytes([_c]).upper()[0]] = _i


def decode_xbm(data: bytes, name: str = "<xbm>") -> np.ndarray:
    """An XBM file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    m = _HEAD.match(data[:512])
    if not m:
        raise Unidentified(f"{name}: not an XBM file")
    width, height = int(m.group("width")), int(m.group("height"))
    if width == 0 or height == 0:
        raise Unidentified(f"{name}: XBM size {width}x{height}")
    check_pixels(width, height, name)
    stride = (width + 7) // 8
    total = stride * height
    text = np.frombuffer(data, np.uint8)
    xs = np.flatnonzero(text[m.end():] == ord("x")) + m.end()
    if len(xs) > 1 and (np.diff(xs[: total + 1]) < 3).any():
        xs = _spaced(xs, total)
    xs = xs[:total]
    if len(xs) < total or xs[-1] + 3 > len(data):
        raise ValueError(f"{name}: XBM data ends before byte {min(len(xs), total - 1)} of {total}")
    raw = (_HEX[text[xs + 1]] << 4) | _HEX[text[xs + 2]]
    bits = np.unpackbits(raw.reshape(height, stride), axis=1, bitorder="little")[:, :width]
    return np.ascontiguousarray(np.repeat((bits * np.uint8(255))[..., None], 3, axis=2))


def _spaced(xs: np.ndarray, total: int) -> np.ndarray:
    """The ``x``s the decoder stops at: each at least three on from the last."""
    out = []
    last = -3
    for p in xs.tolist():
        if p >= last + 3:
            out.append(p)
            last = p
            if len(out) == total:
                break
    return np.asarray(out, np.int64)
