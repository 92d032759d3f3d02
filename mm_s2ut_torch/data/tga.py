"""Truevision TGA images without Pillow (numpy only).

:func:`decode_tga` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``TgaImagePlugin`` and its ``tga_rle`` decoder
open, and ``ValueError`` naming the file for those it refuses. TGA has no
magic number: a file is one where its 18-byte header passes Pillow's
checks (a colour-map type of 0 or 1, a positive size, a depth of 1, 8, 16,
24 or 32 bits, an image type of 1-3 or 9-11), else :class:`Unidentified`.

* Image types 1 (colour-mapped), 2 (true colour) and 3 (gray) and their
  RLE forms 9, 10 and 11, in Pillow's raw modes: 8-bit indices, 1-bit
  (raw only), 8-bit and 16-bit gray (the second byte is alpha), 16-bit
  colour (5-5-5, the top bit alpha), 24-bit BGR and 32-bit BGRA.
* The image-ID field is skipped; a colour map (16-bit 5-5-5 or 24-bit
  entries, its first index leaving the entries before it black, at most
  256 entries in all) is read wherever the colour-map type is 1, and
  Pillow then looks a gray image's values up in it as indices; an index
  past the map is black.
* Rows are bottom-up unless the descriptor's bit 5 is set, and bit 4
  mirrors them, as Pillow applies it.
* RLE as ``TgaRleDecode.c`` reads it: a literal packet may run on into
  the next rows; a run packet that passes its row's end is an overrun.

Pillow refuses (and so does this reader) 15-bit pixels and colour maps,
32-bit colour maps, a colour map beside a true-colour or 1-bit image, a
colour-mapped image without a map, 1-bit RLE and the other pairs of type
and depth.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

# (image type & 7, depth) → Pillow's raw mode
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
             (2, 24): "BGR", (2, 32): "BGRA"}
_MAP_BYTES = {16: 2, 24: 3}


def _rgb555(v: np.ndarray) -> np.ndarray:
    """16-bit little-endian words, 5-5-5 with blue lowest → RGB uint8."""
    v = v.astype(np.int64)
    return (np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], -1) * 255 // 31).astype(np.uint8)


def decode_tga(data: bytes, name: str = "<tga>") -> np.ndarray:
    """A TGA file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 18:
        raise Unidentified(f"{name}: not a TGA file (a header of {len(data)} bytes)")
    id_len, maptype, imagetype = data[0], data[1], data[2]
    first, entries, mapdepth = struct.unpack_from("<HHB", data, 3)
    width, height, depth, flags = struct.unpack_from("<HHBB", data, 12)
    if maptype not in (0, 1) or width <= 0 or height <= 0 or depth not in (1, 8, 16, 24, 32):
        raise Unidentified(f"{name}: not a TGA file (colour-map type {maptype}, size "
                           f"{width}x{height}, depth {depth})")
    if imagetype not in (1, 2, 3, 9, 10, 11):
        raise Unidentified(f"{name}: not a TGA file (image type {imagetype})")
    check_pixels(width, height, name)
    pos = 18 + id_len
    palette = None
    if maptype:
        if mapdepth not in (16, 24, 32):
            raise Unidentified(f"{name}: not a TGA file (colour-map depth {mapdepth})")
        if mapdepth == 32:
            raise ValueError(f"{name}: TGA colour-map depth 32, which Pillow does not read")
        k = _MAP_BYTES[mapdepth]
        raw = data[pos: pos + k * entries]
        pos += len(raw)
        if first + entries > 256:
            raise ValueError(f"{name}: TGA colour map of {first} + {entries} entries")
        if mapdepth == 16:
            colours = _rgb555(np.frombuffer(raw[: len(raw) // 2 * 2], "<u2"))
        else:
            colours = np.frombuffer(raw[: len(raw) // 3 * 3], np.uint8).reshape(-1, 3)[:, ::-1]
        palette = np.zeros((256, 3), np.uint8)
        palette[first: first + len(colours)] = colours
    rawmode = _RAWMODES.get((imagetype & 7, depth))
    if rawmode is None:
        raise ValueError(f"{name}: TGA image type {imagetype} at depth {depth}, which Pillow "
                         f"does not read")
    if imagetype & 7 == 1 and palette is None:
        raise ValueError(f"{name}: TGA image type {imagetype} without a colour map")
    if palette is not None and rawmode not in ("P", "L", "LA"):
        raise ValueError(f"{name}: TGA colour map beside image type {imagetype} at depth "
                         f"{depth}")
    if depth == 1:
        if imagetype & 8:
            raise ValueError(f"{name}: 1-bit TGA RLE, which Pillow does not read")
        stride = (width + 7) // 8
        rows = _take(data, pos, height * stride, name).reshape(height, stride)
        px = np.where(np.unpackbits(rows, axis=1)[:, :width] != 0, 255, 0).astype(np.uint8)
    else:
        bpp = depth // 8
        total = width * height * bpp
        flat = _rle(data, pos, width * bpp, height, bpp, name) if imagetype & 8 else \
            _take(data, pos, total, name)
        px = flat.reshape(height, width, bpp)
    if not flags & 0x20:  # bottom-up rows
        px = px[::-1]
    if flags & 0x10:  # right to left
        px = px[:, ::-1]
    if rawmode == "1":
        return np.ascontiguousarray(np.repeat(px[..., None], 3, 2))
    if rawmode in ("P", "L", "LA"):
        idx = px[..., 0]
        if palette is not None:
            return palette[idx]
        return np.ascontiguousarray(np.repeat(idx[..., None], 3, 2))
    if rawmode == "BGRA;15Z":
        return _rgb555(px[..., 0].astype(np.int64) | (px[..., 1].astype(np.int64) << 8))
    return np.ascontiguousarray(px[..., 2::-1])


def _take(data: bytes, pos: int, n: int, name: str) -> np.ndarray:
    if len(data) - pos < n:
        raise ValueError(f"{name}: TGA image data truncated ({max(0, len(data) - pos)} of {n} "
                         f"bytes)")
    return np.frombuffer(data, np.uint8, n, pos)


def _rle(data: bytes, pos: int, row: int, height: int, bpp: int, name: str) -> np.ndarray:
    """``TgaRleDecode.c``: packets of a header byte (bit 7 a run, the rest
    the count less one) and one pixel or ``count`` pixels → the image's
    bytes in file row order."""
    total, size = row * height, len(data)
    out = bytearray()
    while len(out) < total:
        if pos >= size:
            raise ValueError(f"{name}: TGA RLE data ends after {len(out)} of {total} bytes")
        head = data[pos]
        n = bpp * ((head & 0x7F) + 1)
        if head & 0x80:
            if size - pos < 1 + bpp:
                raise ValueError(f"{name}: TGA RLE data ends inside a run packet")
            if len(out) % row + n > row:
                raise ValueError(f"{name}: TGA RLE run packet passes the end of row "
                                 f"{len(out) // row}")
            out += data[pos + 1: pos + 1 + bpp] * (n // bpp)
            pos += 1 + bpp
        else:
            if size - pos < 1 + n:
                raise ValueError(f"{name}: TGA RLE data ends inside a literal packet")
            out += data[pos + 1: pos + 1 + n]  # may run on into the next rows
            pos += 1 + n
    return np.frombuffer(bytes(out[:total]), np.uint8)
