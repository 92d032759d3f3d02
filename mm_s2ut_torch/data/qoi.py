"""QOI ("Quite OK Image") files without Pillow (numpy only).

:func:`decode_qoi` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``QoiImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses: the 14-byte header (``qoif``, big-endian
width and height, 3 channels or, for any other count, 4; the colour space
is not read), then the six ops from the pixel (0, 0, 0, 255) with an
index of 64 pixels, each (0, 0, 0, 0) until a pixel of its hash
``(3r + 5g + 7b + 11a) % 64`` is seen: RGB (``0xfe``, alpha kept), RGBA
(``0xff``), INDEX, DIFF (-2..1 per channel), LUMA (green -32..31, red and
blue -8..7 beside it) and RUN (1-62 repeats, not entered in the index).
A run past the last pixel is cut; the end marker is not read; alpha is
dropped as ``convert("RGB")`` drops it.

The ops are read one by one (each pixel depends on the one before and on
the index); a run's repeats are expanded with numpy.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels


def decode_qoi(data: bytes, name: str = "<qoi>") -> np.ndarray:
    """A QOI file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 14 or data[:4] != b"qoif":
        raise Unidentified(f"{name}: not a QOI file")
    width, height = struct.unpack_from(">II", data, 4)
    if width <= 0 or height <= 0:
        raise Unidentified(f"{name}: QOI size {width}x{height}")
    check_pixels(width, height, name)
    total, size = width * height, len(data)
    index = [(0, 0, 0, 0)] * 64
    r, g, b, a = 0, 0, 0, 255
    pixels, counts = [], []
    done, pos = 0, 14
    while done < total:
        if pos >= size:
            raise ValueError(f"{name}: QOI data ends after {done} of {total} pixels")
        op = data[pos]
        pos += 1
        if op == 0xFE:  # RGB
            if size - pos < 3:
                raise ValueError(f"{name}: QOI data ends inside an RGB op")
            r, g, b = data[pos], data[pos + 1], data[pos + 2]
            pos += 3
        elif op == 0xFF:  # RGBA
            if size - pos < 4:
                raise ValueError(f"{name}: QOI data ends inside an RGBA op")
            r, g, b, a = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
            pos += 4
        elif op < 0x40:  # INDEX
            r, g, b, a = index[op]
        elif op < 0x80:  # DIFF
            r = (r + ((op >> 4) & 3) - 2) & 0xFF
            g = (g + ((op >> 2) & 3) - 2) & 0xFF
            b = (b + (op & 3) - 2) & 0xFF
        elif op < 0xC0:  # LUMA
            if pos >= size:
                raise ValueError(f"{name}: QOI data ends inside a LUMA op")
            dg = (op & 0x3F) - 32
            second = data[pos]
            pos += 1
            r = (r + dg + (second >> 4) - 8) & 0xFF
            g = (g + dg) & 0xFF
            b = (b + dg + (second & 15) - 8) & 0xFF
        else:  # RUN of the pixel before
            n = (op & 0x3F) + 1
            pixels.append((r, g, b))
            counts.append(n)
            done += n
            continue
        index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
        pixels.append((r, g, b))
        counts.append(1)
        done += 1
    px = np.repeat(np.asarray(pixels, np.uint8).reshape(-1, 3), counts, axis=0)[:total]
    return px.reshape(height, width, 3)
