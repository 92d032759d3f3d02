"""DirectDraw Surface (DDS) textures without Pillow (numpy and the standard
library).

:func:`decode_dds` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``DdsImagePlugin`` and its ``bcn`` decoder
(``BcnDecode.c``) open, and ``ValueError`` naming the file for those it
refuses. Only the first surface is read (the top mip level, the first array
slice or cube face): Pillow reads from the end of the header whatever its
pitch, depth, mip count or caps say.

* ``DDPF_RGB`` (ahead of every other flag): bit masks for R, G and B, and A
  with ``DDPF_ALPHAPIXELS``, over ``bitcount // 8`` little-endian bytes a
  pixel (any bit count, no row pitch). Each channel is
  ``int((v & mask) >> shift) / (mask >> shift) * 255)``: a float division
  then truncation, not the rounding of the specification; a zero mask gives
  0. The pixels are read from a stream that gives zeros past the end of
  the file, as Pillow's Python decoder reads it: a short file is no error.
* ``DDPF_LUMINANCE``: ``L`` at 8 bits, ``LA`` at 16 with
  ``DDPF_ALPHAPIXELS``; any other bit count is refused.
* ``DDPF_PALETTEINDEXED8``: a 1024-byte RGBA palette, then 8-bit indices;
  ``convert("RGB")`` takes the palette's RGB.
* ``DDPF_FOURCC``: DXT1, DXT3 and DXT5 (BC1-BC3), ATI1 and BC4U (BC4, gray),
  ATI2 and BC5U (BC5) and BC5S; DX10 with DXGI BC1-BC5 (TYPELESS, UNORM),
  BC5_SNORM, BC6H_UF16 and _SF16, BC7 (TYPELESS, UNORM, UNORM_SRGB: sRGB
  only sets Pillow's ``info["gamma"]``) and R8G8B8A8 (TYPELESS, UNORM,
  UNORM_SRGB, raw RGBA).

The blocks are decoded as ``BcnDecode.c`` decodes them, 4x4 pixels each in
rows of ``ceil(W / 4)`` blocks, the visible part of an edge block kept:

* BC1 colours: RGB 5:6:5 widened by repeating the high bits; the 4-colour
  mode (c0 > c1, and always for BC2 and BC3) interpolates ⌊(2a + b) / 3⌋,
  the 3-colour mode ⌊(a + b) / 2⌋ and gives index 3 transparent black, so
  RGB (0, 0, 0) in ``convert("RGB")``. BC2's and BC3's alpha is dropped.
* BC4 and BC5 channels: BC3's alpha scheme, 8 values (a0 > a1) or 6 with 0
  and 255; ⌊⌋ divisions. BC5 gives R and G, and B = 0. BC5S takes each
  endpoint byte as a signed value plus 128 (its top bit flipped) and
  interpolates as unsigned; its B is 128.
* BC6H: the 14 modes and their endpoint bit layouts, deltas, sign
  extension, partitions and anchors of the specification, Pillow's
  unquantization (``((x << 15) + 0x4000) >> (prec - 1)``, 0 and the top
  code pinned; a signed mode's endpoints rebuilt from deltas are masked to
  the endpoint bits and, unlike the specification's, not sign-extended
  again, so they read as positive), the 6-bit interpolation weights, then a
  half float of ⌊31v / 64⌋ (signed: ±⌊31|v| / 32⌋) made 8 bits as
  ``(UINT8)(value * 255.0f)``: truncated in float32, below 0 → 0, above 1
  → 255. The four reserved 5-bit mode codes give black.
* BC7: the 8 modes with their partitions, anchors, endpoint and shared
  p-bits, the index selector of mode 4 and the channel rotation of modes 4
  and 5 (alpha swapped into R, G or B). A block whose first byte is 0
  (mode 8, invalid) gives black.

BC1-BC5 and the masks are decoded over all blocks or pixels at once; BC6H
and BC7 over all blocks of one mode at a time.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_RGB, _ALPHAPIXELS, _FOURCC, _PALETTE, _LUMINANCE = 0x40, 0x1, 0x4, 0x20, 0x20000


def _cc(code: bytes) -> int:
    return struct.unpack("<I", code)[0]


# FourCC → (Pillow's pixel format, BCn); DX10's DXGI formats → the same
_FOURCCS = {_cc(b"DXT1"): ("BC1", 1), _cc(b"DXT3"): ("BC2", 2), _cc(b"DXT5"): ("BC3", 3),
            _cc(b"BC4U"): ("BC4", 4), _cc(b"ATI1"): ("BC4", 4), _cc(b"BC5S"): ("BC5S", 5),
            _cc(b"BC5U"): ("BC5", 5), _cc(b"ATI2"): ("BC5", 5)}
_DX10 = _cc(b"DX10")
_DXGI = {70: ("BC1", 1), 71: ("BC1", 1), 73: ("BC2", 2), 74: ("BC2", 2), 76: ("BC3", 3),
         77: ("BC3", 3), 79: ("BC4", 4), 80: ("BC4", 4), 82: ("BC5", 5), 83: ("BC5", 5),
         84: ("BC5S", 5), 95: ("BC6H", 6), 96: ("BC6HS", 6), 97: ("BC7", 7), 98: ("BC7", 7),
         99: ("BC7", 7), 27: ("RGBA", 0), 28: ("RGBA", 0), 29: ("RGBA", 0)}
_BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}

# BC7's and BC6H's partition tables: a bit (two subsets) or two bits (three)
# per pixel, pixel 0 lowest; the anchor pixel of subset 1 of two, and of
# subsets 1 and 2 of three, one hex digit per partition
_P2 = [int(x, 16) for x in """
    cccc 8888 eeee ecc8 c880 feec fec8 ec80 c800 ffec fe80 e800 ffe8 ff00 fff0 f000
    f710 008e 7100 08ce 008c 7310 3100 8cce 088c 3110 6666 366c 17e8 0ff0 718e 399c
    aaaa f0f0 5a5a 33cc 3c3c 55aa 9696 a55a 73ce 13c8 324c 3bdc 6996 c33c 9966 0660
    0272 04e4 4e40 2720 c936 936c 39c6 639c 9336 9cc6 817e e718 ccf0 0fcc 7744 ee22""".split()]
_P3 = [int(x, 16) for x in """
    aa685050 6a5a5040 5a5a4200 5450a0a8 a5a50000 a0a05050 5555a0a0 5a5a5050
    aa550000 aa555500 aaaa5500 90909090 94949494 a4a4a4a4 a9a59450 2a0a4250
    a5945040 0a425054 a5a5a500 55a0a0a0 a8a85454 6a6a4040 a4a45000 1a1a0500
    0050a4a4 aaa59090 14696914 69691400 a08585a0 aa821414 50a4a450 6a5a0200
    a9a58000 5090a0a8 a8a09050 24242424 00aa5500 24924924 24499224 50a50a50
    500aa550 aaaa4444 66660000 a5a0a5a0 50a050a0 69286928 44aaaa44 66666600
    aa444444 54a854a8 95809580 96969600 a85454a8 80959580 aa141414 96960000
    aaaa1414 a05050a0 a0a5a5a0 96000000 40804080 a9a8a9a8 aaaaaa44 2a4a5254""".split()]
_A2 = [int(c, 16) for c in "fffffffffffffffff282288f28228822ff6828ff28222ff66268ff22fffff22f"]
_A3_1 = [int(c, 16) for c in "33ff83ff88666533338f336a588685ff8f356a8ff3f5ffff3f55585a5a8dfc33"]
_A3_2 = [int(c, 16) for c in "f883ff38fffffff8f8f3f8f83f6affa8f3faa89a6f8f3668f3ffffffffff3ff8"]
_WEIGHTS = {2: [0, 21, 43, 64], 3: [0, 9, 18, 27, 37, 46, 55, 64],
            4: [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64]}

# BC7 modes: subsets, partition bits, rotation bits, index-selector bits,
# colour bits, alpha bits, p-bits per endpoint, shared p-bits, index bits,
# second index bits
_BC7 = [(3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
        (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
        (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
        (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0)]

# BC6H modes (in the order of their codes: 2-bit 0, 1, then 5-bit xxx10,
# xxx11): subsets, delta-coded, partition bits, endpoint bits, delta bits
# of R, G, B; then each mode's endpoint bits in stream order, as (endpoint
# value, bit): w, x, y, z are the endpoints (y and z the second subset's),
# "rw0-9" bits 0 to 9 of w's red, "bz5-4" bit 5 then bit 4 of z's blue
_BC6 = [(2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
        (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
        (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
        (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
        (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4)]
_BC6_LAYOUT_SPECS = [
    "gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 "
    "rz0-4 bz3",
    "gy5 gz4-5 rw0-6 bz0-1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5-4 rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 "
    "by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-3 bw10 bz1 by0-3 ry0-4 bz2 "
    "rz0-4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3 bx0-3 bw10 bz1 by0-3 ry0-3 bz0 bz2 "
    "rz0-3 gy4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-4 bw10 by0-3 ry0-3 bz1-2 "
    "rz0-3 bz4-3",
    "rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 "
    "rz0-4 bz3",
    "rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3-4 rx0-5 gy0-3 gx0-4 bz0 gz0-3 bx0-4 bz1 by0-3 ry0-5 "
    "rz0-5",
    "rw0-7 bz0 by4 gw0-7 gy5-4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3 gx0-5 gz0-3 bx0-4 bz1 by0-3 ry0-4 "
    "bz2 rz0-4 bz3",
    "rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5-4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-5 by0-3 ry0-4 "
    "bz2 rz0-4 bz3",
    "rw0-5 gz4 bz0-1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3 bz5-4 rx0-5 gy0-3 gx0-5 gz0-3 "
    "bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9",
    "rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10",
    "rw0-9 gw0-9 bw0-9 rx0-7 rw11-10 gx0-7 gw11-10 bx0-7 bw11-10",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw15-10 gx0-3 gw15-10 bx0-3 bw15-10",
]


def _bc6_layout(spec: str) -> List[Tuple[int, int]]:
    """``"rw0-9 gy4 ..."`` → [(endpoint value 0..11, bit)] in stream order:
    value 3·endpoint + channel, endpoints w, x, y, z."""
    out = []
    for field in spec.split():
        value = "wxyz".index(field[1]) * 3 + "rgb".index(field[0])
        lo, _, hi = field[2:].partition("-")
        lo, hi = int(lo), int(hi or lo)
        step = 1 if hi >= lo else -1
        out += [(value, b) for b in range(lo, hi + step, step)]
    return out


_BC6_LAYOUTS = [_bc6_layout(s) for s in _BC6_LAYOUT_SPECS]


def _refuse(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: DDS {what}, which Pillow does not read")


def decode_dds(data: bytes, name: str = "<dds>") -> np.ndarray:
    """A DDS file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 8:
        raise Unidentified(f"{name}: DDS header size field truncated")
    size = struct.unpack_from("<I", data, 4)[0]
    if size != 124:
        raise ValueError(f"{name}: DDS header size {size}, not 124 (Pillow refuses it)")
    if len(data) < 128:
        raise ValueError(f"{name}: DDS header of {len(data) - 8} bytes, 120 needed after the "
                         "size (Pillow refuses it)")
    height, width = struct.unpack_from("<2I", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<3I", data, 80)
    masks = struct.unpack_from("<4I", data, 92)
    if pfflags & _RGB:
        kind = "masks"
        masks = masks if pfflags & _ALPHAPIXELS else masks[:3]
    elif pfflags & _LUMINANCE:
        if bitcount == 8:
            kind = "L"
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            kind = "LA"
        else:
            raise _refuse(name, f"LUMINANCE at {bitcount} bits (pixel format flags "
                                f"{pfflags:#x})")
    elif pfflags & _PALETTE:
        kind = "P"
    elif pfflags & _FOURCC:
        kind, n = _fourcc_kind(data, fourcc, name)
    else:
        raise _refuse(name, f"pixel format flags {pfflags:#x} (no RGB, LUMINANCE, "
                            "PALETTEINDEXED8 or FOURCC)")
    if width == 0 or height == 0:
        raise Unidentified(f"{name}: DDS of {width}x{height} pixels")
    check_pixels(width, height, name)
    if kind == "masks":
        return _masks(data[128:], masks, bitcount // 8, width, height)
    if kind in ("L", "LA", "P", "RGBA"):
        at, bpp = {"L": (128, 1), "LA": (128, 2), "P": (1152, 1), "RGBA": (148, 4)}[kind]
        px = _surface(data, at, width * height * bpp, name).reshape(height, width, bpp)
        if kind == "P":
            palette = np.frombuffer(data, np.uint8, 1024, 128).reshape(256, 4)
            return palette[px[..., 0], :3]
        return np.ascontiguousarray(px[..., :3] if kind == "RGBA" else np.repeat(px[..., :1], 3, 2))
    at = 148 if fourcc == _DX10 else 128
    bw, bh = -(-width // 4), -(-height // 4)
    blocks = _surface(data, at, bw * bh * _BLOCK_BYTES[n], name).reshape(bw * bh, -1)
    if n <= 3:
        rgb = _bc1(blocks[:, -8:], four=n > 1)
    elif n == 4:
        rgb = np.repeat(_bc4(blocks)[..., None], 3, 2)
    elif n == 5:
        signed = kind == "BC5S"
        rgb = np.stack([_bc4(blocks[:, :8], signed), _bc4(blocks[:, 8:], signed),
                        np.full((len(blocks), 16), 128 if signed else 0)], -1)
    elif n == 6:
        rgb = _bc6(blocks, kind == "BC6HS")
    else:
        rgb = _bc7(blocks)
    img = rgb.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 3)
    return np.ascontiguousarray(img[:height, :width].astype(np.uint8))


def _fourcc_kind(data: bytes, fourcc: int, name: str) -> Tuple[str, int]:
    """(Pillow's pixel format, BCn or 0 for raw RGBA) of a FourCC file."""
    if fourcc in _FOURCCS:
        return _FOURCCS[fourcc]
    if fourcc != _DX10:
        raise _refuse(name, f"FourCC {struct.pack('<I', fourcc)!r} ({fourcc:#x})")
    if len(data) < 132:
        raise Unidentified(f"{name}: DDS DX10 header truncated")
    dxgi = struct.unpack_from("<I", data, 128)[0]
    if dxgi not in _DXGI:
        raise _refuse(name, f"DX10 DXGI format {dxgi}")
    return _DXGI[dxgi]


def _surface(data: bytes, at: int, need: int, name: str) -> np.ndarray:
    if len(data) < at + need:
        raise ValueError(f"{name}: DDS surface of {need} bytes from byte {at}, the file holds "
                         f"{max(0, len(data) - at)} (Pillow: truncated)")
    return np.frombuffer(data, np.uint8, need, at)


def _masks(body: bytes, masks, bytecount: int, width: int, height: int) -> np.ndarray:
    """``DdsRgbDecoder``: each pixel ``bytecount`` little-endian bytes (the
    stream zero past the end), each channel scaled by its mask."""
    npx = width * height
    values = np.zeros(npx, np.int64)
    have = min(npx, -(-len(body) // bytecount)) if bytecount else 0
    if have:
        buf = np.frombuffer(body, np.uint8).astype(np.int64)
        # the masks are 32-bit: each pixel's first 4 bytes, zeros past the end
        at = np.arange(have)[:, None] * bytecount + np.arange(min(bytecount, 4))
        low = np.where(at < len(buf), buf[np.minimum(at, len(buf) - 1)], 0)
        values[:have] = (low << (8 * np.arange(low.shape[1]))).sum(1)
    out = []
    for mask in masks[:3]:
        if mask == 0:
            out.append(np.zeros(npx, np.int64))
            continue
        shift = (mask & -mask).bit_length() - 1
        v = ((values & mask) >> shift).astype(np.float64)
        out.append((v / (mask >> shift) * 255).astype(np.int64))
    return np.stack(out, -1).reshape(height, width, 3).astype(np.uint8)


# -------------------------------------------------------------------- BC1-5

def _bc1(blocks: np.ndarray, four: bool, shift_only: bool = False) -> np.ndarray:
    """(n, 8) BC1 colour blocks → (n, 16, 3): 5:6:5 endpoints, the 4-colour
    mode where c0 > c1 (or ``four``, as BC2 and BC3 use them), else the
    3-colour mode with black at index 3. The endpoints' 5 and 6 bits are
    widened to 8 by repeating their high bits (31 → 255), or, with
    ``shift_only`` (Pillow's BLP decoder), by a shift alone (31 → 248)."""
    b = blocks.astype(np.int64)
    c0, c1 = b[:, 0] | b[:, 1] << 8, b[:, 2] | b[:, 3] << 8
    lut = b[:, 4] | b[:, 5] << 8 | b[:, 6] << 16 | b[:, 7] << 24

    def rgb565(c):
        r, g, bl = (c & 0xF800) >> 8, (c & 0x7E0) >> 3, (c & 0x1F) << 3
        if shift_only:
            return np.stack([r, g, bl], -1)
        return np.stack([r | r >> 5, g | g >> 6, bl | bl >> 5], -1)

    p0, p1 = rgb565(c0), rgb565(c1)
    mode4 = ((c0 > c1) | four)[:, None]
    p2 = np.where(mode4, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(mode4, (p0 + 2 * p1) // 3, 0)
    palette = np.stack([p0, p1, p2, p3], 1)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(palette, idx[..., None], 1)


def _bc4(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(n, 8) BC3-alpha style blocks → (n, 16) values: 8 levels where
    a0 > a1, else 6 and 0, 255; ``signed`` endpoints are int8 + 128."""
    b = blocks.astype(np.int64)
    a0, a1 = (b[:, 0] ^ 0x80, b[:, 1] ^ 0x80) if signed else (b[:, 0], b[:, 1])
    a0, a1 = a0[:, None], a1[:, None]
    k7, k5 = np.arange(1, 7), np.arange(1, 5)
    eight = ((7 - k7) * a0 + k7 * a1) // 7
    six = np.concatenate([((5 - k5) * a0 + k5 * a1) // 5,
                          np.broadcast_to([0, 255], (len(b), 2))], 1)
    levels = np.concatenate([a0, a1, np.where(a0 > a1, eight, six)], 1)
    bits = sum(b[:, 2 + i] << (8 * i) for i in range(6))
    idx = (bits[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(levels, idx, 1)


# ------------------------------------------------------------ BC6H and BC7

def _field(bits: np.ndarray, at: int, count: int) -> np.ndarray:
    """The ``count``-bit field at bit ``at`` of each row of (n, 128) bits."""
    if count == 0:
        return np.zeros(len(bits), np.int64)
    return (bits[:, at: at + count].astype(np.int64) << np.arange(count)).sum(1)


def _indices(bits: np.ndarray, at: int, widths: np.ndarray) -> np.ndarray:
    """(n, 16) indices packed from bit ``at`` on, pixel i ``widths[:, i]`` bits."""
    starts = at + np.cumsum(widths, 1) - widths
    out = np.zeros(widths.shape, np.int64)
    for k in range(int(widths.max())):
        bit = np.take_along_axis(bits, np.minimum(starts + k, 127), 1).astype(np.int64)
        out |= np.where(k < widths, bit << k, 0)
    return out


def _subsets(ns: int, partition: np.ndarray) -> np.ndarray:
    """(n, 16) subset of each pixel."""
    px = np.arange(16)
    if ns == 2:
        return (np.asarray(_P2)[partition][:, None] >> px) & 1
    if ns == 3:
        return (np.asarray(_P3)[partition][:, None] >> (2 * px)) & 3
    return np.zeros((len(partition), 16), np.int64)


def _index_widths(ns: int, partition: np.ndarray, subset: np.ndarray, ib: int) -> np.ndarray:
    """(n, 16) index bits: ``ib``, one fewer at each subset's anchor pixel."""
    px = np.arange(16)[None]
    anchor = px == 0
    if ns == 2:
        anchor = anchor | (px == np.asarray(_A2)[partition][:, None])
    elif ns == 3:
        anchor = anchor | ((subset == 1) & (px == np.asarray(_A3_1)[partition][:, None])) | (
            (subset == 2) & (px == np.asarray(_A3_2)[partition][:, None]))
    return ib - np.broadcast_to(anchor, subset.shape).astype(np.int64)


def _bc7(blocks: np.ndarray) -> np.ndarray:
    """(n, 16) BC7 blocks → (n, 16, 3), all blocks of one mode at a time."""
    first = blocks[:, 0].astype(np.int64)
    mode = np.where(first > 0, np.log2((first & -first).clip(1)).astype(np.int64), 8)
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    out = np.zeros((len(blocks), 16, 3), np.int64)
    for m in range(8):
        sel = np.nonzero(mode == m)[0]
        if len(sel):
            out[sel] = _bc7_mode(bits[sel], m)
    return out


def _bc7_mode(bits: np.ndarray, m: int) -> np.ndarray:
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7[m]
    n, numep = len(bits), 2 * ns
    at = m + 1

    def take(count):
        nonlocal at
        at += count
        return _field(bits, at - count, count)

    partition, rotation, index_sel = take(pb), take(rb), take(isb)
    ep = np.zeros((n, numep, 4), np.int64)
    for c in range(3):
        for i in range(numep):
            ep[:, i, c] = take(cb)
    for i in range(numep):
        ep[:, i, 3] = take(ab) if ab else 255
    chans = 4 if ab else 3
    if epb or spb:  # a p-bit per endpoint, or one per subset's pair
        cb, ab = cb + 1, ab + 1 if ab else 0
        per = 1 if epb else 2
        for i in range(0, numep, per):
            ep[:, i: i + per, :chans] = ep[:, i: i + per, :chans] << 1 | take(1)[:, None, None]
    for c in range(chans):
        width = cb if c < 3 else ab
        v = (ep[..., c] << (8 - width)) & 0xFF
        ep[..., c] = v | v >> width
    subset = _subsets(ns, partition)
    i0 = _indices(bits, at, _index_widths(ns, partition, subset, ib))
    cw = np.asarray(_WEIGHTS[ib])
    if ab and ib2:
        w2 = np.full((n, 16), ib2)
        w2[:, 0] -= 1
        i1 = _indices(bits, at + 16 * ib - ns, w2)
        aw = np.asarray(_WEIGHTS[ib2])
        swap = index_sel[:, None] == 1
        s_rgb = np.where(swap, aw[i1], cw[i0])
        s_a = np.where(swap, cw[i0], aw[i1])
    else:
        s_rgb = s_a = cw[i0]
    e0 = np.take_along_axis(ep, (2 * subset)[..., None], 1)
    e1 = np.take_along_axis(ep, (2 * subset + 1)[..., None], 1)
    s = np.concatenate([np.repeat(s_rgb[..., None], 3, 2), s_a[..., None]], 2)
    px = ((64 - s) * e0 + s * e1 + 32) >> 6  # (n, 16, 4)
    for r in (1, 2, 3):
        rows = rotation == r
        px[rows, :, r - 1], px[rows, :, 3] = px[rows, :, 3], px[rows, :, r - 1].copy()
    return px[..., :3]


def _sign_extend(v: np.ndarray, prec: int) -> np.ndarray:
    """A ``prec``-bit two's complement field widened in 16 bits (UINT16)."""
    return np.where(v & (1 << (prec - 1)), (v | (-1 << prec)) & 0xFFFF, v)


def _bc6(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """(n, 16) BC6H blocks → (n, 16, 3) 8-bit, all blocks of one mode at a time."""
    code = blocks[:, 0].astype(np.int64) & 0x1F
    low = code & 3
    mode = np.where(low < 2, low, np.where(low == 2, 2 + (code >> 2), 10 + (code >> 2)))
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    out = np.zeros((len(blocks), 16, 3), np.int64)
    for m in range(14):
        sel = np.nonzero(mode == m)[0]
        if len(sel):
            out[sel] = _bc6_mode(bits[sel], m, signed)
    return out


def _bc6_unquantize(v: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    if not signed:
        if prec >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << prec) - 1, 0xFFFF,
                                            ((v << 15) + 0x4000) >> (prec - 1)))
    x = np.where(v >= 0x8000, v - 0x10000, v)  # (INT16)
    if prec >= 16:
        return x
    a = np.abs(x)
    a = np.where(a == 0, 0, np.where(a >= (1 << (prec - 1)) - 1, 0x7FFF,
                                     ((a << 15) + 0x4000) >> (prec - 1)))
    return np.where(x < 0, -a, a)


def _bc6_mode(bits: np.ndarray, m: int, signed: bool) -> np.ndarray:
    ns, tr, pb, epb, *delta = _BC6[m]
    n, numep = len(bits), 12 if ns == 2 else 6
    at = 2 if m < 2 else 5
    layout = _BC6_LAYOUTS[m]
    weights = np.zeros((len(layout), 12), np.int64)  # stream bit i → 2^bit in its value
    for i, (value, bit) in enumerate(layout):
        weights[i, value] = 1 << bit
    ep = bits[:, at: at + len(layout)].astype(np.int64) @ weights
    at += {0: 75, 1: 75}.get(m, 72 if m < 10 else 60)
    partition = _field(bits, at, pb)
    at += pb
    if signed:
        for c in range(3):
            ep[:, c] = _sign_extend(ep[:, c], epb)
    if signed or tr:
        for i in range(3, numep):
            ep[:, i] = _sign_extend(ep[:, i], delta[i % 3])
    if tr:
        for i in range(3, numep):
            ep[:, i] = (ep[:, i] + ep[:, i % 3]) & ((1 << epb) - 1)
    ueps = _bc6_unquantize(ep[:, :numep], epb, signed)
    ib = 3 if ns == 2 else 4
    subset = _subsets(ns, partition)
    idx = _indices(bits, at, _index_widths(ns, partition, subset, ib))
    s = np.asarray(_WEIGHTS[ib])[idx][..., None]
    e0 = np.take_along_axis(ueps[:, None, :].repeat(16, 1), 6 * subset[..., None]
                            + np.arange(3), 2)
    e1 = np.take_along_axis(ueps[:, None, :].repeat(16, 1), 6 * subset[..., None]
                            + np.arange(3, 6), 2)
    v = (e0 * (64 - s) + e1 * s) >> 6
    if signed:
        half = np.where(v < 0, 0x8000 | (-v * 31) // 32, v * 31 // 32)
    else:
        half = v * 31 // 64
    f = half.astype(np.uint16).view(np.float16).astype(np.float32)
    scaled = np.trunc(f * np.float32(255)).clip(0, 255)
    return np.where(f < 0, 0, np.where(f > 1, 255, scaled)).astype(np.int64)
