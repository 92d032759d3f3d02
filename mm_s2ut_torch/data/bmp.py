"""Windows BMP files without Pillow (numpy only).

:func:`decode_bmp` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every ``BM`` file Pillow 12's ``BmpImagePlugin`` opens, and ``ValueError``
naming the file for those it refuses; :func:`decode_dib` reads the same
bitmaps without the 14-byte file header (Pillow's ``DIB``, and the entries
of ICO and CUR files, ``data/ico.py``):

* BITMAPCOREHEADER (12 bytes: 16-bit sizes, 3-byte palette entries) and
  the INFOHEADER family (40, 52, 56, 64, V4 108, V5 124), rows bottom-up
  or top-down (a negative height);
* 1/4/8 bits through the palette; a palette of grays (index i = (i, i, i),
  or black and white at 1 bit) is read as Pillow's ``L``/``1`` modes are,
  and an index past the palette is black;
* 16 bits (5-5-5, and BI_BITFIELDS 5-6-5 or 5-5-5), 24 bits, 32 bits
  (BI_RGB and the BI_BITFIELDS layouts Pillow knows; alpha dropped);
* BI_RLE8 and BI_RLE4 as Pillow's ``BmpRleDecoder`` reads them: a delta
  escape skips the two bytes after it and moves by the next two, pixels
  skipped by a delta or an end of line are index 0, absolute runs align
  on the file's even offsets, and a stream that stops before the last
  pixel is refused.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# Pillow's BI_BITFIELDS layouts: (bits, masks) → byte order of a pixel
_MASK_ORDER = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_ORDER = {16: "BGR;15", 24: "BGR", 32: "BGRX"}


def decode_bmp(data: bytes, name: str = "<bmp>") -> np.ndarray:
    """A ``BM`` file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 18 or data[:2] != b"BM":
        raise ValueError(f"{name}: not a BMP file")
    return _bitmap(data, 14, struct.unpack_from("<I", data, 10)[0], name)[0]


def decode_dib(data: bytes, name: str = "<dib>", at: int = 0,
               halve: bool = False) -> Tuple[np.ndarray, int]:
    """A device-independent bitmap without the file header, its info header
    at ``at`` (Pillow's ``DibImageFile``): the pixels follow the header, the
    masks of a 40-byte BI_BITFIELDS header and the palette. ``halve`` keeps
    the first half of the rows the header counts, as Pillow reads an ICO or
    CUR entry (an XOR image over an AND mask). → (RGB pixels, the offset of
    the pixel rows)."""
    return _bitmap(data, at, 0, name, halve)


def _bitmap(data: bytes, at: int, offset: int, name: str,
            halve: bool = False) -> Tuple[np.ndarray, int]:
    """Pillow's ``BmpImageFile._bitmap``: the info header at ``at``, the
    pixels at ``offset`` (0: right after the header, masks and palette)."""
    if len(data) < at + 4:
        raise Unidentified(f"{name}: truncated BMP header size")
    hsize = struct.unpack_from("<I", data, at)[0]
    hdr = data[at + 4: at + hsize]
    if len(hdr) < hsize - 4:
        raise ValueError(f"{name}: truncated BMP header")
    pos = at + hsize
    direction = -1  # rows bottom-up
    if hsize == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", hdr)
        compression, colors, pad = _RAW, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        width, height = struct.unpack_from("<II", hdr)
        if hdr[7] == 0xFF:
            direction, height = 1, 2 ** 32 - height
        bits, compression = struct.unpack_from("<HI", hdr, 10)
        colors = struct.unpack_from("<I", hdr, 28)[0]
        pad = 4
        if compression == _BITFIELDS:
            n = 4 if len(hdr) >= 52 else 3
            if len(hdr) >= 48:
                masks = struct.unpack_from(f"<{n}I", hdr, 36)
            else:  # a 40-byte header: the three masks follow it
                if len(data) < pos + 12:
                    raise Unidentified(f"{name}: truncated BMP bitfields masks")
                masks = struct.unpack_from("<3I", data, pos)
                pos += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({hsize})")
    if halve:
        height //= 2
    if width <= 0 or height <= 0:
        raise Unidentified(f"{name}: BMP size {width}x{height}")
    check_pixels(width, height * (2 if halve else 1), name)
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")

    order = _RAW_ORDER.get(bits, "P")
    if compression == _BITFIELDS:
        key = (bits, masks) if bits == 32 else (bits, masks[:3])
        if key not in _MASK_ORDER:
            raise ValueError(f"{name}: unsupported BMP bitfields layout {masks}")
        order = _MASK_ORDER[key]
    elif compression not in (_RAW, _RLE8, _RLE4):
        raise ValueError(f"{name}: unsupported BMP compression ({compression})")

    palette = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        raw = np.frombuffer(data[pos: pos + pad * colors], np.uint8)
        pos += len(raw)
        entries = raw[: len(raw) // pad * pad].reshape(-1, pad)[:, 2::-1]  # BGR(X) → RGB
        gray = np.array([0, 255]) if colors == 2 else np.arange(colors)
        if len(entries) == colors and np.array_equal(entries, np.repeat(gray[:, None], 3, 1)):
            order = "1" if colors == 2 else "L"  # Pillow drops a palette of grays
        else:
            palette = np.zeros((max(256, len(entries)), 3), np.uint8)
            palette[: len(entries)] = entries

    offset = offset or pos
    if compression in (_RLE8, _RLE4):
        idx = _rle(data, offset, width, height, compression == _RLE4, name)
    elif order == "L" and bits < 8:  # Pillow reads such rows a byte per pixel
        if (((width * bits + 31) >> 3) & ~3) < width:
            raise ValueError(f"{name}: BMP rows of {bits}-bit grays shorter than a byte "
                             f"per pixel")
        idx = _rows(data, offset, width, height, bits, 8, name)
    else:
        idx = _rows(data, offset, width, height, bits, bits, name)
    if direction == -1:
        idx = idx[::-1]
    if bits > 8:
        return _direct(idx, order), offset
    if order == "1":
        idx = np.where(idx != 0, 255, 0)
    if palette is None:
        return np.ascontiguousarray(np.repeat(idx.astype(np.uint8)[..., None], 3, 2)), offset
    return palette[idx], offset


def _rows(data, offset, width, height, bits, read_bits, name) -> np.ndarray:
    """Uncompressed rows in file order → (height, width) samples of
    ``read_bits`` each (bytes for 16/24/32 bits: (height, width, bytes))."""
    stride = ((width * bits + 31) >> 3) & ~3
    need = stride * (height - 1) + (width * read_bits + 7) // 8
    if height and len(data) < offset + need:
        raise ValueError(f"{name}: truncated BMP pixel data")
    buf = np.frombuffer(data, np.uint8, offset=offset, count=len(data) - offset)
    rows = np.lib.stride_tricks.as_strided(
        buf, (height, (width * read_bits + 7) // 8), (stride, 1)) if height else \
        np.zeros((0, 0), np.uint8)
    if read_bits >= 16:
        return rows.reshape(height, width, read_bits // 8)
    if read_bits == 8:
        return rows.astype(np.int64)
    unpacked = np.unpackbits(rows, axis=1)[:, : width * read_bits].reshape(height, width, -1)
    return (unpacked * (1 << np.arange(read_bits - 1, -1, -1))).sum(-1)


def _direct(px: np.ndarray, order: str) -> np.ndarray:
    """16/24/32-bit pixels (H, W, bytes) in Pillow's raw ``order`` → RGB."""
    if order in ("BGR;15", "BGR;16"):
        v = px[..., 0].astype(np.int64) | (px[..., 1].astype(np.int64) << 8)
        g_bits = 6 if order == "BGR;16" else 5
        b = (v & 31) * 255 // 31
        g = ((v >> 5) & ((1 << g_bits) - 1)) * 255 // ((1 << g_bits) - 1)
        r = ((v >> (5 + g_bits)) & 31) * 255 // 31
        return np.stack([r, g, b], -1).astype(np.uint8)
    return np.ascontiguousarray(px[..., [order.index(c) for c in "RGB"]])


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool, name: str) -> np.ndarray:
    """BI_RLE8 / BI_RLE4 as Pillow's ``BmpRleDecoder`` → (height, width)
    indices in file row order."""
    out = bytearray()
    total, x, n = width * height, 0, len(data)
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded: count pixels of one byte (two alternating nibbles)
            count = min(count, max(0, width - x)) if x + count > width else count
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow skips two bytes, then reads (right, up)
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError(f"{name}: truncated BMP RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # absolute: byte literal pixels, then to an even file offset
            nbytes = byte // 2 if rle4 else byte
            chunk = data[pos: pos + nbytes]
            pos += len(chunk)
            if rle4:
                nib = np.frombuffer(chunk, np.uint8)
                out += np.stack([nib >> 4, nib & 15], 1).tobytes()
            else:
                out += chunk
            if len(chunk) < nbytes:
                break
            x += byte
            pos += pos % 2
    if len(out) < total:
        raise ValueError(f"{name}: not enough BMP RLE image data")
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(height, width).astype(np.int64)
