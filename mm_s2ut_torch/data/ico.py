"""Windows icons and cursors without Pillow (numpy only).

:func:`decode_ico` and :func:`decode_cur` give
``np.asarray(Image.open(p).convert("RGB"))`` for every file Pillow 12's
``IcoImagePlugin`` and ``CurImagePlugin`` open, and ``ValueError`` naming
the file for those they refuse; a headerless bitmap (Pillow's ``DIB``) is
``bmp.decode_dib`` at offset 0.

* ICO: the entry Pillow opens is the one of the largest area (a width or
  height byte of 0 is 256) and, among those, of the smallest colour depth
  (the entry's bits per pixel, else the bits its colour count needs, else
  256). A PNG payload goes through ``image_io.decode_png``; any other is a
  bitmap through ``bmp.decode_dib``, the first half of the rows its header
  counts (the XOR image). The AND mask (the alpha bytes of an entry of 32
  bits per pixel) only makes alpha, which ``convert("RGB")`` drops, but
  Pillow reads it, so a file too short to hold it is refused.
* CUR: the first entry, or a later one both wider and taller (as bytes);
  its bitmap with half the rows its header counts, no mask read.
"""
from __future__ import annotations

import math
import struct
from typing import List, Tuple

import numpy as np

from mm_s2ut_torch.data import Unidentified
from mm_s2ut_torch.data.bmp import decode_dib

_PNG = b"\x89PNG\r\n\x1a\n"


def _directory(data: bytes, kind: str, name: str) -> Tuple[int, List[bytes]]:
    """The entry count and the 16-byte entries Pillow reads (an entry cut
    short by the end of the file as it is)."""
    if len(data) < 6:
        raise Unidentified(f"{name}: truncated {kind} header")
    count = struct.unpack_from("<H", data, 4)[0]
    return count, [data[6 + 16 * i: 22 + 16 * i] for i in range(count)]


def _icon_entry(data: bytes, name: str) -> Tuple[int, int, int]:
    """``IcoFile``'s choice: (bits per pixel, size, offset) of its first
    entry once sorted by colour depth, then by area, largest first."""
    _, raw = _directory(data, "ICO", name)
    entries = []
    for s in raw:
        if len(s) < 16:
            raise Unidentified(f"{name}: truncated ICO directory entry")
        width, height, colours = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append((width * height, depth, bpp, size, offset))
    if not entries:
        raise Unidentified(f"{name}: ICO file without entries")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)  # stable: the smallest depth first
    return entries[0][2:]


def decode_ico(data: bytes, name: str = "<ico>") -> np.ndarray:
    """An ICO file → (H, W, 3) uint8 RGB of the entry Pillow opens."""
    bpp, size, offset = _icon_entry(data, name)
    if data[offset: offset + 8] == _PNG:
        from mm_s2ut_torch.data.image_io import decode_png

        return decode_png(data[offset:], name)
    rgb, pixels = decode_dib(data, name, offset, halve=True)
    height, width = rgb.shape[:2]
    if bpp == 32:  # alpha from the fourth byte of each pixel
        if len(data) - pixels < width * height * 4:
            raise ValueError(f"{name}: ICO entry too short for the alpha of its "
                             f"{width}x{height} pixels")
    else:  # the AND mask: 1-bit rows padded to 32 bits, at the end of the entry
        stride = -(-width // 32) * 4
        mask = offset + size - stride * height
        if mask < 0 or len(data) - mask < stride * height:
            raise ValueError(f"{name}: ICO entry's AND mask of {stride * height} bytes at "
                             f"{mask} lies outside the file")
    return rgb


def decode_cur(data: bytes, name: str = "<cur>") -> np.ndarray:
    """A CUR file → (H, W, 3) uint8 RGB of the cursor Pillow opens."""
    count, raw = _directory(data, "CUR", name)
    chosen = b""
    for s in raw:
        if not chosen:
            chosen = s
        elif len(s) < 2:
            raise Unidentified(f"{name}: truncated CUR directory entry")
        elif s[0] > chosen[0] and s[1] > chosen[1]:
            chosen = s
    if not chosen:
        raise Unidentified(f"{name}: CUR file without cursors")
    if len(chosen) < 16:
        raise Unidentified(f"{name}: truncated CUR directory entry")
    at = struct.unpack_from("<I", chosen, 12)[0] or min(6 + 16 * count, len(data))
    return decode_dib(data, name, at, halve=True)[0]
