"""Sun raster images without Pillow (numpy only).

:func:`decode_sun` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``SunImagePlugin`` and its ``sun_rle`` decoder
(``SunRleDecode.c``) open, and ``ValueError`` naming the file for those it
refuses:

* the 32-byte big-endian header (magic 0x59A66A95); the length field is
  not read;
* depths 1 (``1;I``: a set bit black), 4 (``L;4``, scaled by 17), 8
  (``L``), 24 (BGR, RGB for type 3) and 32 (BGRX, RGBX for type 3);
* a colour map of type 1 and at most 1024 bytes, stored planar (all its
  reds, then greens, then blues: ``len // 3`` entries, the others black),
  makes a 4- or 8-bit image ``P``; Pillow cannot load a map beside a 1-,
  24- or 32-bit image, nor one of more than 256 entries, and refuses them;
* types 0, 1, 3, 4 and 5: raw rows, each padded to 16 bits (the last
  row's padding not needed); type 2: ``SunRleDecode.c``'s RLE over rows
  that are not padded, 0x80 0x00 a literal 0x80 and 0x80 n v a run of
  n + 1 bytes v that may run on into the next rows.

Another depth, another type, a map of another type or of more than 1024
bytes pass the file on (Pillow's ``SyntaxError``). A file of width 1
whose length field is 1 or 4 is taken first by Pillow's GIMP-brush plugin
(``image_io``'s ``GBR`` entry), which cannot read it.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_MAGIC = 0x59A66A95
_MODES = {1: "1", 4: "L", 8: "L", 24: "RGB", 32: "RGB"}


def decode_sun(data: bytes, name: str = "<sun>") -> np.ndarray:
    """A Sun raster file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 32 or struct.unpack_from(">I", data)[0] != _MAGIC:
        raise Unidentified(f"{name}: not a Sun raster file")
    width, height, depth, _, ftype, maptype, maplen = struct.unpack_from(">7I", data, 4)
    if depth not in _MODES:
        raise Unidentified(f"{name}: Sun raster depth {depth}")
    if maplen and (maplen > 1024 or maptype != 1):
        raise Unidentified(f"{name}: Sun raster colour map of type {maptype}, {maplen} bytes")
    if ftype > 5:
        raise Unidentified(f"{name}: Sun raster type {ftype}")
    if width == 0 or height == 0:
        raise Unidentified(f"{name}: Sun raster size {width}x{height}")
    check_pixels(width, height, name)
    palette = None
    if maplen:
        if _MODES[depth] != "L":
            raise ValueError(f"{name}: Sun raster colour map beside a {depth}-bit image, which "
                             f"Pillow cannot load")
        cmap = data[32: 32 + maplen]
        n = len(cmap) // 3
        if n > 256:
            raise ValueError(f"{name}: Sun raster colour map of {n} entries")
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = np.frombuffer(cmap, np.uint8, 3 * n).reshape(3, n).T
    pos = 32 + maplen
    rowbytes = (width * depth + 7) // 8
    if ftype == 2:
        rows = _rle(data, pos, rowbytes * height, name).reshape(height, rowbytes)
    else:
        stride = (width * depth + 15) // 16 * 2
        need = (height - 1) * stride + rowbytes
        if len(data) - pos < need:
            raise ValueError(f"{name}: Sun raster image data truncated ({max(0, len(data) - pos)} "
                             f"of {need} bytes)")
        padded = np.frombuffer(data[pos: pos + height * stride].ljust(height * stride, b"\0"),
                               np.uint8)
        rows = padded.reshape(height, stride)[:, :rowbytes]
    if depth == 1:
        px = np.where(np.unpackbits(rows, axis=1)[:, :width] != 0, 0, 255).astype(np.uint8)
    elif depth == 4:
        px = np.stack([rows >> 4, rows & 15], -1).reshape(height, -1)[:, :width]
        if palette is None:
            px = px * np.uint8(17)
    elif depth == 8:
        px = rows
    else:
        px = rows.reshape(height, width, depth // 8)[..., :3]
        return np.ascontiguousarray(px if ftype == 3 else px[..., ::-1])
    if palette is not None:
        return palette[px]
    return np.ascontiguousarray(np.repeat(px[..., None], 3, axis=2))


def _rle(data: bytes, pos: int, total: int, name: str) -> np.ndarray:
    """``SunRleDecode.c`` → ``total`` bytes. Literal bytes (all but 0x80)
    are copied in stretches up to the next escape."""
    size = len(data)
    escapes = np.flatnonzero(np.frombuffer(data, np.uint8)[pos:] == 0x80) + pos
    out = bytearray()
    k = 0
    while len(out) < total:
        k += int(np.searchsorted(escapes[k:], pos))
        nxt = int(escapes[k]) if k < len(escapes) else size
        take = min(nxt - pos, total - len(out))
        out += data[pos: pos + take]
        pos += take
        if len(out) >= total:
            break
        if pos + 1 >= size or (data[pos + 1] and pos + 2 >= size):
            raise ValueError(f"{name}: Sun raster RLE data ends after {len(out)} of {total} "
                             f"bytes")
        if data[pos + 1]:  # a run of n + 1
            out += data[pos + 2: pos + 3] * (data[pos + 1] + 1)
            pos += 3
        else:  # a literal 0x80
            out.append(0x80)
            pos += 2
    return np.frombuffer(bytes(out[:total]), np.uint8)
