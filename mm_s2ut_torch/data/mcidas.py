"""McIdas area files without Pillow (numpy only).

:func:`decode_mcidas` gives ``np.asarray(Image.open(p).convert("RGB"))``
for every file Pillow 12's ``McIdasImagePlugin`` opens, and ``ValueError``
naming the file for those it refuses. The 256-byte area descriptor is 64
big-endian signed words ``w[1..64]`` (``w[1]`` 0 and ``w[2]`` 4 are the
magic); ``w[11]`` bytes a sample, 1, 2 or 4, make ``L``, ``I;16B`` or
``I`` (read as ``I;32B``), anything else passes the file on, as a size
(``w[10]`` by ``w[9]``) that is not positive does. The rows start at
``w[34] + w[15]`` (a negative offset is refused), ``w[15] + w[10] * w[11]
* w[14]`` bytes apart, and are read as Pillow reads them from a path:

* ``L`` and ``I;16B`` through a memory map where the file holds
  ``offset + height * stride`` bytes: a stride of 0 or less is the row's
  width in bytes, one shorter than a row lets the rows overlap (the map
  reads zeros past the end of the file), and a file too short for the
  rows at that stride is refused;
* otherwise (``I``, or where the map's test fails) through the raw
  decoder: a stride of 0 packs the rows, one shorter than a row is refused,
  and so is a file that ends before the last row's end.

``convert("RGB")`` clamps ``I;16B`` to 255 and clips ``I`` to 0..255.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels
from mm_s2ut_torch.data.im import mode_to_rgb

# w[11] → (Pillow's mode, its sample type, whether it is read through a memory map)
MODES = {1: ("L", "u1", True), 2: ("I;16B", ">u2", True), 4: ("I", ">i4", False)}
_INT = 1 << 31


def decode_mcidas(data: bytes, name: str = "<mcidas>") -> np.ndarray:
    """A McIdas area file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 256 or data[:8] != b"\0\0\0\0\0\0\0\4":
        raise Unidentified(f"{name}: not an McIdas area file")
    w = (0,) + struct.unpack_from(">64i", data)
    if w[11] not in MODES:
        raise Unidentified(f"{name}: unsupported McIdas format ({w[11]} bytes a sample)")
    mode, dtype, mapped = MODES[w[11]]
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise Unidentified(f"{name}: McIdas size {width}x{height}")
    check_pixels(width, height, name)
    offset, stride = w[34] + w[15], w[15] + w[10] * w[11] * w[14]
    if offset < 0:
        raise ValueError(f"{name}: McIdas data at negative offset {offset}")
    if not -_INT <= stride < _INT:
        raise ValueError(f"{name}: McIdas stride {stride} overflows a C int")
    row = width * w[11]
    if mapped and offset + height * stride <= len(data):
        step = stride if stride > 0 else row
        if offset + height * step > len(data):
            raise ValueError(f"{name}: McIdas file of {len(data)} bytes: buffer is not large "
                             f"enough for {height} rows {step} bytes apart at {offset}")
        buf = data + bytes(max(0, offset + (height - 1) * step + row - len(data)))
    else:
        step = stride or row
        if step < row:
            raise ValueError(f"{name}: McIdas stride {stride} is shorter than a row of {row} "
                             f"bytes")
        if offset + (height - 1) * step + row > len(data):
            raise ValueError(f"{name}: McIdas image data truncated ({len(data)} bytes, rows "
                             f"{step} apart from {offset})")
        buf = data
    at = offset + np.arange(height)[:, None] * step + np.arange(row)[None, :]
    px = np.frombuffer(buf, np.uint8)[at].reshape(-1).view(dtype).reshape(height, width, 1)
    return mode_to_rgb(mode, px.astype(np.int64))
