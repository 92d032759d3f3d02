"""GIMP brushes (GBR) without Pillow (numpy only).

:func:`decode_gbr` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``GbrImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses. Its header is big-endian unsigned 32-bit
words: the header's size (at least 20), the version (1, or 2 with the
``GIMP`` magic and a spacing word after the five), width, height and
depth (1 for ``L``, 4 for ``RGBA``, whose alpha ``convert("RGB")`` drops);
Pillow passes the file on where these fail or the header is cut short.
The comment runs to the header's end (``size - 20``, or ``size - 28`` for
version 2, where a length of -1 reads to the end of the file and one
below that makes Pillow's read raise) and the pixels follow it,
``width * height * depth`` bytes top row first, or the file is refused
(Pillow's "not enough image data"). A Sun raster 1 pixel wide
whose length field is 1 or 4 passes Pillow's test and opens as a brush
with a huge comment: it is refused, as Pillow refuses to load it.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels


def decode_gbr(data: bytes, name: str = "<gbr>") -> np.ndarray:
    """A GIMP brush → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 20:
        raise Unidentified(f"{name}: not a GIMP brush")
    size, version, width, height, depth = struct.unpack_from(">5I", data)
    if size < 20 or version not in (1, 2) or width == 0 or height == 0 or depth not in (1, 4):
        raise Unidentified(f"{name}: not a GIMP brush")
    start = size
    if version == 2:
        if data[20:24] != b"GIMP" or len(data) < 28:
            raise Unidentified(f"{name}: not a GIMP brush, bad magic number")
        if size < 27:
            raise ValueError(f"{name}: GIMP brush comment of {size - 28} bytes")
        if size == 27:  # a comment length of -1 reads the rest of the file
            start = len(data)
    check_pixels(width, height, name)
    need = width * height * depth
    if len(data) - start < need:
        raise ValueError(f"{name}: GIMP brush of {width}x{height}x{depth} from byte {start}: "
                         f"not enough image data ({max(0, len(data) - start)} of {need} bytes)")
    px = np.frombuffer(data, np.uint8, need, start).reshape(height, width, depth)
    return np.ascontiguousarray(np.repeat(px, 3, axis=2) if depth == 1 else px[..., :3])
