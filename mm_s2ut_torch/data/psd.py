"""Photoshop (PSD) images without Pillow (numpy only).

:func:`decode_psd` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``PsdImagePlugin`` and its ``packbits`` decoder
(``PackbitsDecode.c``) open, and ``ValueError`` naming the file for those
it refuses. Only the composite image, which is what ``Image.open`` shows:

* the 26-byte header (``8BPS``, version 1) and Pillow's ``MODES`` table of
  (colour mode, bits): bitmap 1-bit (``1``, a set bit white), gray,
  multichannel and duotone (``L``), indexed (``P``), RGB (``RGBA`` with
  exactly 4 channels, alpha dropped) and CMYK (read inverted, ``CMYK;I``),
  all 8-bit; any other pair (16- and 32-bit files among them) passes the
  file on, and too few channels for the mode is refused;
* the colour-mode section: the palette of an indexed image where it is
  768 bytes (its reds, greens, then blues), else a black one;
* the resources (walked as Pillow walks them) and the layer section,
  skipped;
* the image data: compression 0, each channel's plane in turn, or 1, a
  table of byte counts (a 16-bit count per row of each channel) that
  places each channel's PackBits stream. A stream is decoded as
  ``PackbitsDecode.c`` does, from its place until the plane is full: 0x80
  is no op, and a run or literal that passes its row's end is cut there,
  the next op starting the next row. Another compression is refused.

Lab (colour mode 9), which Pillow converts to RGB through LittleCMS, is
refused as not read yet.
"""
from __future__ import annotations

import io
import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels
from mm_s2ut_torch.data.jpeg import _cmyk_to_rgb

# (colour mode, bits) → (Pillow's mode, channels it needs)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}


class _Short(Exception):
    """A field read past the end of the file (Pillow's ``struct.error``)."""


def _read(fp: io.BytesIO, fmt: str) -> int:
    raw = fp.read(struct.calcsize(fmt))
    if len(raw) < struct.calcsize(fmt):
        raise _Short
    return struct.unpack(fmt, raw)[0]


def decode_psd(data: bytes, name: str = "<psd>") -> np.ndarray:
    """A PSD file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    try:
        mode, channels, width, height, palette, offsets, rle = _open(data, name)
    except _Short:
        raise Unidentified(f"{name}: PSD header or section truncated") from None
    if width == 0 or height == 0:
        raise Unidentified(f"{name}: PSD size {width}x{height}")
    check_pixels(width, height, name)
    if offsets is None:
        raise ValueError(f"{name}: PSD compression {rle}, which Pillow does not read")
    if mode == "LAB":
        raise ValueError(f"{name}: PSD mode LAB (colour mode 9), which Pillow converts to RGB "
                         f"through LittleCMS and the port does not read yet")
    stride = (width + 7) // 8 if mode == "1" else width
    planes = [(_packbits(data, at, stride, height, name) if rle else _raw(data, at, stride * height,
                                                                         name))
              .reshape(height, stride) for at in offsets]
    if mode == "1":
        px = np.unpackbits(planes[0], axis=1)[:, :width] * np.uint8(255)
    elif mode == "P":
        px = palette[planes[0]]
    elif mode == "L":
        px = planes[0]
    elif mode == "CMYK":
        return _cmyk_to_rgb([p.astype(np.int64) for p in planes]).astype(np.uint8)
    else:  # RGB, RGBA
        return np.stack(planes[:3], -1)
    if px.ndim == 2:
        px = np.repeat(px[..., None], 3, axis=2)
    return np.ascontiguousarray(px)


def _open(data: bytes, name: str):
    """``PsdImageFile._open`` → (mode, channels, width, height, palette,
    each channel's offset or None for a compression Pillow does not read,
    compression)."""
    if data[:4] != b"8BPS" or len(data) < 6 or struct.unpack_from(">H", data, 4)[0] != 1:
        raise Unidentified(f"{name}: not a PSD file")
    if len(data) < 26:
        raise _Short
    channels, height, width, bits, cmode = struct.unpack_from(">HIIHH", data, 12)
    if (cmode, bits) not in MODES:
        raise Unidentified(f"{name}: PSD colour mode {cmode} at {bits} bits")
    mode, need = MODES[cmode, bits]
    if need > channels:
        raise ValueError(f"{name}: PSD mode {mode} of {channels} channels: not enough channels")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    fp = io.BytesIO(data)
    fp.seek(26)
    size = _read(fp, ">I")
    palette = np.zeros((256, 3), np.uint8)  # a P image without a palette is black
    if size:
        section = fp.read(size)
        if mode == "P" and size == 768:
            n = len(section) // 3
            palette[:n] = np.frombuffer(section, np.uint8, 3 * n).reshape(3, n).T
    size = _read(fp, ">I")
    if size:  # the resources, walked as Pillow walks them (the walk may pass their end)
        end = fp.tell() + size
        while fp.tell() < end:
            fp.read(4)
            _read(fp, ">H")
            label = fp.read(_read(fp, ">B"))
            if not len(label) & 1:
                fp.read(1)
            if len(fp.read(_read(fp, ">I"))) & 1:
                fp.read(1)
    size = _read(fp, ">I")
    if size:  # the layer and mask section
        end = fp.tell() + size
        _read(fp, ">I")
        fp.seek(end)
    rle = _read(fp, ">H")
    offset = fp.tell()
    if rle == 0:
        return mode, channels, width, height, palette, [offset + c * width * height
                                                        for c in range(need)], rle
    if rle != 1:
        return mode, channels, width, height, palette, None, rle
    counts = fp.read(need * height * 2)
    if len(counts) < need * height * 2:
        raise _Short
    sums = np.concatenate([[0], np.cumsum(np.frombuffer(counts, ">u2").astype(np.int64))])
    offsets = [fp.tell() + int(sums[c * height]) for c in range(need)]
    return mode, channels, width, height, palette, offsets, rle


def _raw(data: bytes, at: int, n: int, name: str) -> np.ndarray:
    if len(data) - at < n:
        raise ValueError(f"{name}: PSD image data truncated ({max(0, len(data) - at)} of {n} "
                         f"bytes at {at})")
    return np.frombuffer(data, np.uint8, n, at)


def _packbits(data: bytes, pos: int, row: int, height: int, name: str) -> np.ndarray:
    """``PackbitsDecode.c`` from ``pos`` until ``height`` rows of ``row``
    bytes are full."""
    out = bytearray()
    size = len(data)
    for _ in range(height):
        line = bytearray()
        while len(line) < row:
            if pos >= size:
                raise ValueError(f"{name}: PSD PackBits data ends after {len(out) + len(line)} "
                                 f"bytes")
            head = data[pos]
            if head == 0x80:
                pos += 1
            elif head > 0x80:
                if pos + 1 >= size:
                    raise ValueError(f"{name}: PSD PackBits data ends inside a run")
                line += data[pos + 1: pos + 2] * (257 - head)
                pos += 2
            else:
                if pos + head + 2 > size:
                    raise ValueError(f"{name}: PSD PackBits data ends inside a literal")
                line += data[pos + 1: pos + head + 2]
                pos += head + 2
        out += line[:row]
    return np.frombuffer(bytes(out), np.uint8)
