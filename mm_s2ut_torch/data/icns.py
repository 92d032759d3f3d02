"""Mac OS icon (ICNS) files without Pillow (numpy only).

:func:`decode_icns` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``IcnsImagePlugin`` opens, and ``ValueError``
naming the file for those it refuses:

* the entries (a 4-byte type and a length that counts its own 8 bytes)
  are walked up to the length the file's header gives; a later entry of a
  type replaces an earlier one. A walk that reads past the end, or an entry
  of length 0, passes the file on, and so does a file with no entry of
  Pillow's ``SIZES`` table;
* the size shown is the largest ``(width, height, scale)`` key of
  ``SIZES`` with an entry, compared as tuples, so (48, 48, 1) wins over
  (32, 32, 2); every entry of that size is read, in the table's order;
* ``is32``, ``il32``, ``ih32`` and ``it32`` (after its 4 zero bytes) are
  ``read_32``: raw RGB where the entry's length is exactly w·h·3, else
  each of R, G and B in turn as runs (a byte from 0x80 repeats the next
  byte ``b - 125`` times, one below it takes ``b + 1`` bytes as they are),
  read on past the entry's end, and refused unless each band's counts add
  up to w·h exactly and its bytes are there. The masks (``s8mk``,
  ``l8mk``, ``h8mk``, ``t8mk``) must hold w·h bytes; ``convert("RGB")``
  drops them. An RGB entry wins over none: a mask alone is refused;
* a PNG entry (``ic07``–``ic14``, ``icp4``–``icp6``) wins over the RGB one
  of its size and is read by ``image_io.decode_png`` from its place to the
  end of the file. The image takes the PNG's size, which Pillow accepts only
  where some size with an entry, divided by it, gives one whole factor for
  both sides (a 16x16 PNG in a 128x128 entry, say);
* a JPEG 2000 entry, which Pillow reads through OpenJPEG, is refused, naming
  the codec (not read by the port yet); any other entry data is refused as
  Pillow refuses it.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

from mm_s2ut_torch.data import Unidentified

SIZES = {  # IcnsFile.SIZES: (width, height, scale) → its entry types, in reading order
    (512, 512, 2): [b"ic10"], (512, 512, 1): [b"ic09"], (256, 256, 2): [b"ic14"],
    (256, 256, 1): [b"ic08"], (128, 128, 2): [b"ic13"], (128, 128, 1): [b"ic07", b"it32", b"t8mk"],
    (64, 64, 1): [b"icp6"], (32, 32, 2): [b"ic12"], (48, 48, 1): [b"ih32", b"h8mk"],
    (32, 32, 1): [b"icp5", b"il32", b"l8mk"], (16, 16, 2): [b"ic11"],
    (16, 16, 1): [b"icp4", b"is32", b"s8mk"],
}
_RGB = (b"is32", b"il32", b"ih32", b"it32")
_MASKS = (b"s8mk", b"l8mk", b"h8mk", b"t8mk")


def _entries(data: bytes, name: str) -> Dict[bytes, Tuple[int, int]]:
    """``IcnsFile.__init__``: type → (start, length) of each entry's data."""
    if len(data) < 8 or data[:4] != b"icns":
        raise Unidentified(f"{name}: not an ICNS file")
    filesize = struct.unpack_from(">I", data, 4)[0]
    out, pos = {}, 8
    while pos < filesize:
        if pos + 8 > len(data):
            raise Unidentified(f"{name}: ICNS entry header past the end of the file")
        sig, size = struct.unpack_from(">4sI", data, pos)
        if size == 0:
            raise Unidentified(f"{name}: invalid ICNS block header")
        out[sig] = (pos + 8, size - 8)
        pos += size
    return out


def decode_icns(data: bytes, name: str = "<icns>") -> np.ndarray:
    """An ICNS file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    entries = _entries(data, name)
    present = [size for size, codes in SIZES.items() if any(c in entries for c in codes)]
    if not present:
        raise Unidentified(f"{name}: no ICNS icon of Pillow's sizes")
    best = max(present)
    w, h = best[0] * best[2], best[1] * best[2]
    rgb = png = None
    for code in SIZES[best]:
        if code not in entries:
            continue
        start, length = entries[code]
        if code in _MASKS:
            if len(data) - start < w * h:
                raise ValueError(f"{name}: ICNS mask {code.decode()} truncated")
        elif code in _RGB:
            if code == b"it32":
                if data[start: start + 4] != b"\0\0\0\0":
                    raise ValueError(f"{name}: ICNS it32 without its 4 zero bytes")
                start, length = start + 4, length - 4
            rgb = _read_32(data, start, length, w, h, code, name)
        else:
            png = _png_or_j2k(data, start, code, name)
    if png is not None:
        ph, pw = png.shape[:2]
        if not any((s[0] * s[2]) // pw == (s[1] * s[2]) / ph for s in present):
            raise ValueError(f"{name}: ICNS PNG of {pw}x{ph}, not one of the allowed sizes of "
                             f"this image")
        return png
    if rgb is None:
        raise ValueError(f"{name}: ICNS mask of {w}x{h} without its RGB icon")
    return rgb


def _png_or_j2k(data: bytes, start: int, code: bytes, name: str) -> np.ndarray:
    from mm_s2ut_torch.data.image_io import decode_png

    sig = data[start: start + 12]
    if sig.startswith(b"\x89PNG\r\n\x1a\n"):
        try:
            return decode_png(data[start:], name)
        except Unidentified as e:  # Pillow's PNG open fails at load time here
            raise ValueError(str(e)) from None
    if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or \
            sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        raise ValueError(f"{name}: ICNS {code.decode()} entry in JPEG 2000, which Pillow reads "
                         f"through OpenJPEG and the port does not read yet")
    raise ValueError(f"{name}: unsupported ICNS subimage format in {code.decode()}")


def _read_32(data: bytes, start: int, length: int, w: int, h: int, code: bytes,
             name: str) -> np.ndarray:
    """``read_32``: raw RGB where ``length`` is exactly w·h·3, else three bands of runs."""
    n = w * h
    if length == 3 * n:
        if len(data) - start < length:
            raise ValueError(f"{name}: ICNS {code.decode()} truncated")
        return np.frombuffer(data, np.uint8, length, start).reshape(h, w, 3).copy()
    bands, pos, size = [], start, len(data)
    for band in range(3):
        out = bytearray()
        left = n
        while left > 0 and pos < size:
            b = data[pos]
            if b & 0x80:
                count = b - 125
                out += data[pos + 1: pos + 2] * count
                pos += 2
            else:
                count = b + 1
                out += data[pos + 1: pos + 1 + count]
                pos += 1 + count
            left -= count
        if left != 0:
            raise ValueError(f"{name}: ICNS {code.decode()} band {band}: {left} left")
        if len(out) < n:
            raise ValueError(f"{name}: ICNS {code.decode()} band {band} truncated")
        bands.append(np.frombuffer(bytes(out), np.uint8, n).reshape(h, w))
    return np.stack(bands, -1)
