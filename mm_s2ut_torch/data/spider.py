"""SPIDER images without Pillow (numpy only).

:func:`decode_spider` gives ``np.asarray(Image.open(p).convert("RGB"))``
for every file Pillow 12's ``SpiderImagePlugin`` opens, and ``ValueError``
naming the file for those it refuses. A SPIDER file has no magic: Pillow
tries every file that reaches its plugin, and passes it on where

* its first 27 four-byte floats, read big-endian and then little-endian,
  fail ``isSpiderHeader`` both ways: header words 1, 2, 5, 12, 13, 22 and
  23 must be integral, ``iform`` (word 5) one of 1, 3, -11, -12, -21, -22,
  and the header's bytes (word 22) equal to its records (13) times the
  record's bytes (23), and not 0;
* ``iform`` is not 1 (not a 2-D image), the stack words say neither an
  image nor a stack, or the width (word 12) or height (word 2) is not
  positive.

A stack (``istack`` > 0, ``imgnumber`` 0) gives its first image, after a
second header of the same length. The pixels are 4-byte floats in the
header's byte order (Pillow's mode ``F``), row by row from the top, and
``convert("RGB")`` clips each to 0..255 and truncates it toward zero (NaN
is 0). A file whose header names an image in a stack (``istack`` 0,
``imgnumber`` > 0), or whose stack words are not finite, is refused, as
Pillow's open raises there.
"""
from __future__ import annotations

import math
import struct
from typing import Tuple

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    return math.isfinite(f) and f == int(f)


def _header_bytes(t: Tuple[float, ...]) -> int:
    """``isSpiderHeader``: the header's length in bytes, 0 where it is not one."""
    h = (99.0,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _int(v: float, what: str, name: str) -> int:
    if not math.isfinite(v):
        raise ValueError(f"{name}: SPIDER {what} {v} is not a number")
    return int(v)


def decode_spider(data: bytes, name: str = "<spider>") -> np.ndarray:
    """A SPIDER file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 108:
        raise Unidentified(f"{name}: not a SPIDER file")
    for order in (">", "<"):
        t = struct.unpack_from(f"{order}27f", data)
        hdrlen = _header_bytes(t)
        if hdrlen:
            break
    else:
        raise Unidentified(f"{name}: not a SPIDER file")
    h = (99.0,) + t
    if int(h[5]) != 1:
        raise Unidentified(f"{name}: not a SPIDER 2-D image")
    width, height = int(h[12]), int(h[2])
    istack, imgnumber = _int(h[24], "istack", name), _int(h[27], "imgnumber", name)
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        _int(h[26], "image count", name)
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        raise ValueError(f"{name}: SPIDER header of image {imgnumber} in a stack, without its "
                         f"stack (Pillow cannot open it)")
    else:
        raise Unidentified(f"{name}: inconsistent SPIDER stack header values")
    if width <= 0 or height <= 0:
        raise Unidentified(f"{name}: SPIDER size {width}x{height}")
    check_pixels(width, height, name)
    if offset < 0:
        raise ValueError(f"{name}: SPIDER header of {hdrlen} bytes")
    need = 4 * width * height
    if len(data) - offset < need:
        raise ValueError(f"{name}: SPIDER image data truncated ({max(0, len(data) - offset)} of "
                         f"{need} bytes at {offset})")
    v = np.frombuffer(data, f"{order}f4", width * height, offset).reshape(height, width)
    return np.repeat(f_to_u8(v)[..., None], 3, axis=2)


def f_to_u8(v: np.ndarray) -> np.ndarray:
    """Pillow's ``F`` → ``L``: clipped to 0..255, truncated toward zero, NaN 0."""
    v = v.astype(np.float64)
    return np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(np.uint8)
