"""Windows Paint (MSP) images without Pillow (numpy only).

:func:`decode_msp` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``MspImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses:

* the 32-byte header: ``DanM`` (version 1) or ``LinS`` (version 2), the
  width and height at bytes 4 and 6, and the XOR of its 16 little-endian
  words, which must be 0 (Pillow's open raises ``SyntaxError`` otherwise,
  and ``Image.open`` passes the file on to the next plugin), as must the
  width and height;
* version 1: the rows as they are, 1 bit a pixel, most significant bit
  first, a set bit white;
* version 2: a table of each row's byte count, then the rows in Pillow's
  run-length code (``MspDecoder``): a 0 byte, a count and a byte to repeat,
  or a count of bytes taken as they are (cut where the row ends). A row of
  count 0 is white. Whatever each row gives is joined and read as rows of
  ``(width + 7) // 8`` bytes, as Pillow's ``set_as_raw`` reads it, so a row
  longer or shorter than that moves the rows after it.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels


def decode_msp(data: bytes, name: str = "<msp>") -> np.ndarray:
    """An MSP file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if data[:4] not in (b"DanM", b"LinS") or len(data) < 32:
        raise Unidentified(f"{name}: not an MSP file")
    words = struct.unpack_from("<16H", data)
    if np.bitwise_xor.reduce(np.asarray(words, np.int64)) != 0:
        raise Unidentified(f"{name}: bad MSP checksum")
    width, height = words[2], words[3]
    if width == 0 or height == 0:
        raise Unidentified(f"{name}: MSP size {width}x{height}")
    check_pixels(width, height, name)
    stride = (width + 7) // 8
    need = stride * height
    if data[:4] == b"DanM":
        if len(data) - 32 < need:
            raise ValueError(f"{name}: MSP image data truncated ({len(data) - 32} of {need} "
                             f"bytes)")
        rows = data[32: 32 + need]
    else:
        rows = _rle_rows(data, width, height, name)
        if len(rows) < need:
            raise ValueError(f"{name}: MSP rows give {len(rows)} of {need} bytes: not enough "
                             f"image data")
    bits = np.frombuffer(rows, np.uint8, need).reshape(height, stride)
    px = np.unpackbits(bits, axis=1)[:, :width] * np.uint8(255)
    return np.ascontiguousarray(np.repeat(px[..., None], 3, axis=2))


def _rle_rows(data: bytes, width: int, height: int, name: str) -> bytes:
    """``MspDecoder.decode``: the row table, then each row's runs."""
    if len(data) < 32 + 2 * height:
        raise ValueError(f"{name}: MSP file truncated in its row table")
    lengths = struct.unpack_from(f"<{height}H", data, 32)
    blank = b"\xff" * ((width + 7) // 8)
    out = bytearray()
    pos = 32 + 2 * height
    for y, n in enumerate(lengths):
        if n == 0:
            out += blank
            continue
        row = data[pos: pos + n]
        pos += n
        if len(row) != n:
            raise ValueError(f"{name}: MSP file truncated: row {y} wants {n} bytes")
        i = 0
        while i < n:
            count = row[i]
            if count == 0:
                if i + 3 > n:
                    raise ValueError(f"{name}: MSP row {y} ends inside a run")
                out += row[i + 2: i + 3] * row[i + 1]
                i += 3
            else:
                out += row[i + 1: i + 1 + count]
                i += 1 + count
    return bytes(out)
