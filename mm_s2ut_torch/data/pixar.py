"""PIXAR raster images without Pillow (numpy only).

:func:`decode_pixar` gives ``np.asarray(Image.open(p).convert("RGB"))``
for every file Pillow 12's ``PixarImagePlugin`` opens, and ``ValueError``
naming the file for those it refuses. After the magic ``80 E8 00 00`` the
header is read as little-endian 16-bit words: the width at byte 418, the
height at 416, and the channel and depth pair at 424 and 426. Pillow knows
one pair, (14, 2), as ``RGB``, its pixels raw from byte 1024, top row
first; any other pair leaves no mode (nor does a header cut short, or a
size of 0), and the file is passed on.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels


def decode_pixar(data: bytes, name: str = "<pixar>") -> np.ndarray:
    """A PIXAR file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if data[:4] != b"\x80\xe8\0\0" or len(data) < 428:
        raise Unidentified(f"{name}: not a PIXAR file")
    height, width = struct.unpack_from("<2H", data, 416)
    pair = struct.unpack_from("<2H", data, 424)
    if pair != (14, 2) or width == 0 or height == 0:
        raise Unidentified(f"{name}: PIXAR channels and depth {pair} of {width}x{height}: no "
                           f"mode Pillow reads")
    check_pixels(width, height, name)
    need = 3 * width * height
    if len(data) - 1024 < need:
        raise ValueError(f"{name}: PIXAR image data truncated ({max(0, len(data) - 1024)} of "
                         f"{need} bytes)")
    return np.frombuffer(data, np.uint8, need, 1024).reshape(height, width, 3).copy()
