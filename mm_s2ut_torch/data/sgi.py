"""SGI images without Pillow (numpy only).

:func:`decode_sgi` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``SgiImagePlugin`` and its ``sgi_rle`` decoder
(``SgiRleDecode.c``) open, and ``ValueError`` naming the file for those it
refuses:

* the 512-byte header: magic 474 (big-endian), storage 0 (verbatim) or 1
  (RLE), 1 or 2 bytes per sample, and the (bytes, dimension, channels)
  Pillow takes: dimension 1 or 2 with one channel (gray), dimension 3
  with 3 (RGB) or 4 (RGBA, alpha dropped);
* two bytes per sample are read as their high byte, as Pillow's
  ``L;16B`` unpacker reads them;
* rows bottom-up; a verbatim file holds each channel's plane in turn;
* RLE: the tables of row offsets and lengths after the header (channel
  by channel), then each row's ops: a count byte (the low byte of a
  16-bit word in 2-byte files) with bit 7 set copies ``count`` samples,
  clear repeats the next one, 0 ends the row. A row's length counts its
  ops (a length from 2**31 up, negative as the C decoder's ``int``, reads
  none); where its last op is not the end, the decoder stops there and the
  rows not reached stay black. A row that stops early keeps the samples
  of the row decoded before it past that point. An op that passes the
  row's width or the end of the file, or an offset inside the header, is
  an overrun.

Pillow refuses the other storage types and layouts, and so does this
reader.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_LAYOUTS = {(1, 1): 1, (2, 1): 1, (3, 3): 3, (3, 4): 4}  # (dimension, channels) → bands
_HEADER = 512


def decode_sgi(data: bytes, name: str = "<sgi>") -> np.ndarray:
    """An SGI file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 12 or struct.unpack_from(">H", data)[0] != 474:
        raise Unidentified(f"{name}: not an SGI file")
    storage, bpc = data[2], data[3]
    dimension, width, height, channels = struct.unpack_from(">HHHH", data, 4)
    bands = _LAYOUTS.get((dimension, channels)) if bpc in (1, 2) else None
    if bands is None:
        raise ValueError(f"{name}: SGI layout of {bpc} bytes per sample, dimension "
                         f"{dimension}, {channels} channels, which Pillow does not read")
    if width <= 0 or height <= 0:
        raise Unidentified(f"{name}: SGI size {width}x{height}")
    check_pixels(width, height, name)
    if storage == 0:
        page = width * height * bpc
        if len(data) - _HEADER < bands * page:
            raise ValueError(f"{name}: SGI image data truncated")
        planes = np.frombuffer(data, np.uint8, bands * page, _HEADER).reshape(bands, height,
                                                                           width, bpc)
        px = planes[..., 0].transpose(1, 2, 0)  # the high byte of a 2-byte sample
    elif storage == 1:
        px = _rle(data, width, height, bands, bpc, name)
    else:
        raise ValueError(f"{name}: SGI storage {storage}, which Pillow does not read")
    px = px[::-1]  # rows bottom-up
    if bands == 1:
        px = np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _rle(data: bytes, width: int, height: int, bands: int, bpc: int, name: str) -> np.ndarray:
    """``SgiRleDecode.c`` → (height, width, bands) uint8 in file row order."""
    body = data[_HEADER:]
    end = len(body) - 1  # the last byte the decoder may read
    n = bands * height
    if len(body) < 8 * n:
        raise ValueError(f"{name}: SGI RLE tables truncated")
    starts = struct.unpack_from(f">{n}I", body)
    lengths = struct.unpack_from(f">{n}I", body, 4 * n)
    out = np.zeros((height, width, bands), np.uint8)
    row = np.zeros((width, bands), np.uint8)  # kept from one row to the next
    for y in range(height):
        for c in range(bands):
            offset, ops = starts[y + c * height], lengths[y + c * height]
            if ops >= 1 << 31:  # a C int there: negative, no op read
                ops = 0
            if offset < _HEADER:
                raise ValueError(f"{name}: SGI RLE row {y} of channel {c} at offset {offset}, "
                                 f"inside the header")
            status = _row(body, offset - _HEADER, ops, width, bpc, end, row[:, c])
            if status < 0:
                raise ValueError(f"{name}: SGI RLE row {y} of channel {c} overruns")
            if status > 0:
                return out
        out[y] = row
    return out


def _row(body: bytes, src: int, ops: int, width: int, bpc: int, end: int, dest: np.ndarray) -> int:
    """``expandrow``/``expandrow2``: one channel's row into ``dest`` (its
    high bytes). 0 at its end, 1 where its last op is not the end, -1 at an
    overrun."""
    x = 0
    while ops > 0:
        if src + bpc - 1 > end:
            return -1
        head = body[src + bpc - 1]
        src += bpc
        if ops == 1 and head != 0:
            return 1
        count = head & 0x7F
        if not count:
            return 0
        if x + count > width:
            return -1
        if head & 0x80:  # copy count samples
            if src + bpc * count > end:
                return -1
            dest[x: x + count] = np.frombuffer(body, np.uint8, bpc * count, src)[::bpc]
            src += bpc * count
        else:  # repeat the next sample
            if src + 2 * (bpc - 1) > end:
                return -1
            dest[x: x + count] = body[src]
            src += bpc
        x += count
        ops -= 1
    return 0
