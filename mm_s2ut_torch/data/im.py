"""IFUNC Image Memory (IM) files without Pillow (numpy only).

:func:`decode_im` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``ImImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses. IM has no magic: Pillow tries every file
that reaches its plugin, and passes it on (``SyntaxError``) where

* no ``\\n`` is in the first 100 bytes, a header line is longer than 100
  bytes or is not ``key: value`` (``^([A-Za-z][^:]*):[ \\t]*(.*)[ \\t]*$``),
  or no line names one of Pillow's nine tags;
* no ``\\x1a`` follows the header, a ``Lut`` has fewer than 768 bytes, the
  image type is empty, or the size is one number, or not positive.

The header's lines run to a ``\\0``, a ``\\x1a`` or the end; a ``\\r`` that
starts a line is skipped. ``Image type`` names a (mode, raw mode) pair of
Pillow's ``OPEN`` table; a type not in it is taken as the mode itself, with
the raw mode of the type before it (``L`` at first). ``Image size (x*y)``,
``Scale (x,y)`` and ``File size (no of images)`` are numbers as Python's
``int``, then ``float``, reads them: one that neither reads is refused, and
so is a size that is not two integers. Without a size the image is
512x512 ``L``.

After the ``\\x1a`` may come a ``Lut`` of 768 bytes (its reds, greens, then
blues): one that is not gray makes an ``L`` or ``P`` image ``P`` (raw mode
``P``) and an ``LA`` one ``PA`` (``PA;L``); a gray one, linear or not,
leaves the image as it is (Pillow keeps a non-linear one aside and never
applies it). Then the pixels, bottom row first (the raw decoder's ``ystep``
-1): 1-bit, gray, 2- and 4-bit indices (a ``P`` image without a palette
is black), each band's line in turn for the ``;L`` raw modes (``RGB;L``,
``RGBA;L``, ``LA;L``, ``CMYK;L``, ``YCbCr;L`` and the rest), interleaved
``RGB``, 16-bit ``I;16`` (little- and big-endian), 32-bit ``I``, and ``F``
from 8, 16 and 32-bit integers (signed or not) or 32-bit floats; the
``RGB;T`` / ``RYB;T`` types as three planes, G, R, then B; ``F`` of
any other width of 2 to 31 bits through Pillow's bit decoder
(``BitDecode.c``: bits taken least significant first, each row starting
on a byte, the row's unused high bits carried into the next row's first
byte). Any pair Pillow has no unpacker for is refused.

``convert("RGB")`` then: ``1`` 0/255, ``I`` clipped to 0..255, ``I;16``
clamped to 255, ``F`` clipped and truncated toward zero (NaN 0), ``CMYK``
and ``YCbCr`` by Pillow's own converters (``Convert.c``'s ``cmyk2rgb``,
``ConvertYCbCr.c``'s tables), alpha dropped. ``LAB`` (an image type
``LAB``), which Pillow converts through LittleCMS, is refused, naming the
mode.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels
from mm_s2ut_torch.data.jpeg import _cmyk_to_rgb
from mm_s2ut_torch.data.spider import f_to_u8

COMMENT, FRAMES, LUT, SCALE, SIZE, MODE = ("Comment", "File size (no of images)", "Lut",
                                          "Scale (x,y)", "Image size (x*y)", "Image type")
TAGS = {COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name", SCALE, SIZE, MODE}

OPEN: Dict[str, Tuple[str, str]] = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

# raw mode → (bits a pixel, sample dtype, bands, bands line by line)
_RAW = {
    "1": (1, None, 1, False), "L": (8, "u1", 1, False), "P": (8, "u1", 1, False),
    "P;2": (2, None, 1, False), "P;4": (4, None, 1, False), "RGB": (24, "u1", 3, False),
    "LA;L": (16, "u1", 2, True), "PA;L": (16, "u1", 2, True), "RGB;L": (24, "u1", 3, True),
    "YCbCr;L": (24, "u1", 3, True), "RGBA;L": (32, "u1", 4, True),
    "RGBX;L": (32, "u1", 4, True), "CMYK;L": (32, "u1", 4, True),
    "I;16": (16, "<u2", 1, False), "I;16L": (16, "<u2", 1, False),
    "I;16B": (16, ">u2", 1, False), "I;32": (32, "<i4", 1, False),
    "I;32S": (32, "<i4", 1, False), "F;8": (8, "u1", 1, False), "F;8S": (8, "i1", 1, False),
    "F;16": (16, "<u2", 1, False), "F;16S": (16, "<i2", 1, False),
    "F;32": (32, "<u4", 1, False), "F;32F": (32, "<f4", 1, False),
}
# the (mode, raw mode) pairs Pillow's raw decoder unpacks (Unpack.c)
PAIRS = {("1", "1"), ("L", "L"), ("P", "L"), ("P", "P"), ("P", "P;2"), ("P", "P;4"),
         ("RGB", "RGB"), ("RGB", "RGB;L"), ("RGB", "RGBA;L"), ("RGB", "RGBX;L"),
         ("RGBA", "RGBA;L"), ("RGBX", "RGB"), ("RGBX", "RGB;L"), ("RGBX", "RGBX;L"),
         ("CMYK", "CMYK;L"), ("YCbCr", "YCbCr;L"), ("LAB", "L"), ("I", "I;16"),
         ("I", "I;16B"), ("I", "I;32"), ("I", "I;32S"), ("F", "F;16"), ("F", "F;16S"),
         ("F", "F;32"), ("F", "F;32F"), ("F", "F;8"), ("F", "F;8S"), ("LA", "LA;L"),
         ("PA", "PA;L"), ("I;16", "I;16"), ("I;16", "I;16B"), ("I;16L", "I;16L"),
         ("I;16B", "I;16B")}

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _number(s: str, name: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            raise ValueError(f"{name}: IM header number {s!r}") from None


def _header(data: bytes, name: str):
    """``ImImageFile._open``'s header walk → (info, raw mode, offset after the ``\\x1a``)."""
    if b"\n" not in data[:100]:
        raise Unidentified(f"{name}: not an IM file")
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, tags, pos = "L", 0, 0
    while True:
        c = data[pos: pos + 1]
        pos += 1
        if c == b"\r":
            continue
        if c in (b"", b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = c + data[pos: end], end
        if len(s) > 100:
            raise Unidentified(f"{name}: not an IM file (a header line of {len(s)} bytes)")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise Unidentified(f"{name}: syntax error in IM header")
        k, v = (g.decode("latin-1") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            v = tuple(_number(x, name) for x in v.replace("*", ",").split(","))
            v = v[0] if len(v) == 1 else v
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k != COMMENT:
            info[k] = v
        tags += k in TAGS
    if not tags:
        raise Unidentified(f"{name}: not an IM file (no IM tag)")
    if c != b"\x1a":
        pos = data.find(b"\x1a", pos) + 1 if c else 0
        if pos == 0:
            raise Unidentified(f"{name}: IM file truncated before its image data")
    return info, rawmode, pos


def decode_im(data: bytes, name: str = "<im>") -> np.ndarray:
    """An IM file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    info, rawmode, pos = _header(data, name)
    mode, size = info[MODE], info[SIZE]
    palette = None
    if LUT in info:
        lut = np.frombuffer(data[pos: pos + 768], np.uint8)
        pos += len(lut)
        if len(lut) < 768:
            raise Unidentified(f"{name}: IM Lut of {len(lut)} bytes")
        lut = lut.reshape(3, 256)
        gray = bool((lut == lut[:1]).all())
        if mode in ("L", "LA", "P", "PA") and not gray:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = np.ascontiguousarray(lut.T)
    if not mode or not isinstance(size, tuple) or size[0] <= 0 or size[1] <= 0:
        raise Unidentified(f"{name}: IM mode {mode!r} of size {size}")
    if not all(isinstance(x, int) for x in size) or len(size) != 2:
        raise ValueError(f"{name}: IM size {size} is not two integers")
    width, height = size
    check_pixels(width, height, name)
    bits = rawmode[2:] if rawmode.startswith("F;") else ""
    if bits.isdigit() and int(bits) not in (8, 16, 32):
        if mode != "F" or not 1 <= int(bits) < 32:
            raise ValueError(f"{name}: IM mode {mode} of {bits}-bit samples, which Pillow's bit "
                             f"decoder does not read")
        return mode_to_rgb(mode, _bit_rows(data, pos, width, height, int(bits), name), None)
    if mode == "LAB" and rawmode == "L":
        raise ValueError(f"{name}: IM mode LAB, which Pillow converts to RGB through LittleCMS "
                         f"and the port does not read yet")
    if mode == "RGB" and rawmode in ("RGB;T", "RYB;T"):
        g, r, b = (_raw(data, pos + k * width * height, "L", width, height, name)[..., 0]
                   for k in range(3))
        return np.stack([r, g, b], -1)
    if (mode, rawmode) not in PAIRS:
        raise ValueError(f"{name}: IM mode {mode!r} with raw mode {rawmode!r}, which Pillow "
                         f"has no unpacker for")
    return mode_to_rgb(mode, _raw(data, pos, rawmode, width, height, name), palette)


def _raw(data: bytes, pos: int, rawmode: str, width: int, height: int, name: str) -> np.ndarray:
    """The raw decoder, bottom row first → (height, width, bands) samples."""
    bits, dtype, bands, lines = _RAW[rawmode]
    stride = (width * bits + 7) // 8
    if len(data) - pos < stride * height:
        raise ValueError(f"{name}: IM image data truncated ({max(0, len(data) - pos)} of "
                         f"{stride * height} bytes at {pos})")
    rows = np.frombuffer(data, np.uint8, stride * height, pos).reshape(height, stride)[::-1]
    if dtype is None:  # 1, 2 or 4 bits, most significant first
        v = np.unpackbits(rows, axis=1)[:, : width * bits].reshape(height, width, bits)
        v = (v.astype(np.int64) << np.arange(bits - 1, -1, -1)).sum(-1)
        return (v * 255 if rawmode == "1" else v)[..., None]
    if lines:
        return np.ascontiguousarray(np.moveaxis(rows.reshape(height, bands, width), 1, 2))
    return np.ascontiguousarray(rows).view(dtype).reshape(height, width, bands)


def _bit_rows(data: bytes, pos: int, width: int, height: int, bits: int,
              name: str) -> np.ndarray:
    """``BitDecode.c`` with Pillow's IM arguments (``fill`` 3, ``pad`` 8, bottom
    row first) → (height, width, 1) float samples."""
    stride = (width * bits + 7) // 8
    if len(data) - pos < stride * height:
        raise ValueError(f"{name}: IM image data truncated ({max(0, len(data) - pos)} of "
                         f"{stride * height} bytes at {pos})")
    rows = np.frombuffer(data, np.uint8, stride * height, pos).reshape(height, stride).copy()
    spare = 8 * stride - width * bits
    if spare:  # the bit buffer keeps a row's unused bits and ORs the next row's first byte in
        for y in range(1, height):
            rows[y, 0] |= rows[y - 1, -1] >> (8 - spare)
    v = np.unpackbits(rows, axis=1, bitorder="little")[:, : width * bits]
    v = (v.reshape(height, width, bits).astype(np.int64) << np.arange(bits)).sum(-1)
    return v[::-1, :, None].astype(np.float64)


def mode_to_rgb(mode: str, px: np.ndarray, palette=None) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of (H, W, bands) samples of ``mode``."""
    if mode in ("P", "PA"):
        if palette is None:  # a P image without a palette is black
            return np.zeros(px.shape[:2] + (3,), np.uint8)
        return palette[px[..., 0]]
    if mode in ("I", "I;16", "I;16L", "I;16B"):
        v = np.clip(px[..., 0].astype(np.int64), 0, 255).astype(np.uint8)
    elif mode == "F":
        v = f_to_u8(px[..., 0])
    elif mode == "CMYK":
        return _cmyk_to_rgb([255 - px[..., i].astype(np.int64) for i in range(4)]).astype(
            np.uint8)
    elif mode == "YCbCr":
        return ycbcr_to_rgb(px)
    elif mode in ("RGB", "RGBA", "RGBX"):
        return np.ascontiguousarray(px[..., :3].astype(np.uint8))
    else:  # 1, L, LA
        v = px[..., 0].astype(np.uint8)
    return np.ascontiguousarray(np.repeat(v[..., None], 3, axis=2))


def _fix(x: np.ndarray) -> np.ndarray:
    return np.trunc(x * 64 + 0.5).astype(np.int64)


_C = np.arange(256) - 128
_R_CR, _G_CB, _G_CR, _B_CB = (_fix(1.402 * _C), _fix(-0.34414 * _C), _fix(-0.71414 * _C),
                              _fix(1.772 * _C))


def ycbcr_to_rgb(px: np.ndarray) -> np.ndarray:
    """Pillow's ``ImagingConvertYCbCr2RGB``: 6-bit fixed-point tables of the
    ITU-R 601 factors, each sum shifted down, then clipped to 0..255."""
    y, cb, cr = (px[..., i].astype(np.int64) for i in range(3))
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
