"""FTEX textures (``.ftc``/``.ftu``) without Pillow (numpy only).

:func:`decode_ftex` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``FtexImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses. After the ``FTEX`` magic come little-endian
signed 32-bit words: version, width, height, mipmap count, format count
(which must be 1: Pillow asserts it), then the one format and the offset
of its data, where the first mipmap's byte count and bytes start (-1
reads to the end of the file, below that Pillow's read raises). Format 0 is DXT1 through
Pillow's ``bcn`` decoder (``dds._bc1``: the 3-colour mode's fourth colour
transparent black, alpha then dropped), format 1 raw RGB rows; any other
format is refused. A header cut short, or an offset past the end of the
file, is Pillow's ``struct.error``: the file is passed on.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels
from mm_s2ut_torch.data.dds import _bc1


def decode_ftex(data: bytes, name: str = "<ftex>") -> np.ndarray:
    """An FTEX file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if data[:4] != b"FTEX" or len(data) < 24:
        raise Unidentified(f"{name}: not an FTEX file")
    width, height, _, count = struct.unpack_from("<4i", data, 8)
    if count != 1:
        raise ValueError(f"{name}: FTEX with {count} formats (Pillow asserts 1)")
    if len(data) < 32:
        raise Unidentified(f"{name}: FTEX format directory truncated")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"{name}: FTEX data at negative offset {where}")
    if len(data) < where + 4:
        raise Unidentified(f"{name}: FTEX mipmap size past the end of the file")
    size = struct.unpack_from("<i", data, where)[0]
    if size < -1:
        raise ValueError(f"{name}: FTEX mipmap of {size} bytes")
    mip = data[where + 4:] if size < 0 else data[where + 4: where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"{name}: invalid FTEX texture compression format {fmt}")
    if width <= 0 or height <= 0:
        raise Unidentified(f"{name}: FTEX size {width}x{height}")
    check_pixels(width, height, name)
    if fmt == 1:
        need = 3 * width * height
        if len(mip) < need:
            raise ValueError(f"{name}: FTEX RGB mipmap of {len(mip)} of {need} bytes: truncated")
        return np.frombuffer(mip, np.uint8, need).reshape(height, width, 3).copy()
    bw, bh = -(-width // 4), -(-height // 4)
    if len(mip) < 8 * bw * bh:
        raise ValueError(f"{name}: FTEX DXT1 mipmap of {len(mip)} of {8 * bw * bh} bytes: "
                         f"truncated")
    blocks = np.frombuffer(mip, np.uint8, 8 * bw * bh).reshape(-1, 8)
    img = _bc1(blocks, four=False).reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, 3)[:height, :width].astype(np.uint8))
