"""TIFF files without Pillow (numpy, ``zlib`` and ``data/jpeg.py``).

:func:`decode_tiff` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
the first image (IFD 0) of a TIFF, as Pillow 12 reads it through libtiff:

* either byte order, strips or tiles, planar configuration 1 or 2, fill
  order 1 or 2 (the bits of every stored byte reversed);
* compression none, PackBits, LZW (TIFF's code-size change one code
  early), Deflate and Adobe Deflate (``zlib``), and new-style JPEG (7):
  each strip or tile a JPEG stream decoded by ``data/jpeg.py`` with the
  JPEGTables tag's tables before it, YCbCr converted to RGB by libjpeg's
  rules (libtiff's ``JPEGCOLORMODE_RGB``);
* the horizontal predictor (2) on 8- and 16-bit samples;
* Pillow's modes: MinIsWhite and MinIsBlack at 1/2/4/8 bits (scaled to
  0..255, inverted for MinIsWhite) and 16 bits (``I;16``/``I;16B``, which
  ``convert("RGB")`` clamps to 255; Pillow reads a 16-bit MinIsWhite
  image uninverted), gray with alpha, RGB and RGBA at 8 and 16 bits (the
  high byte; premultiplied alpha undone as Pillow's ``RGBa`` unpacker
  does, then dropped), palette images at 1/2/4/8 bits (the ColorMap's
  high bytes), and CMYK at 8 bits (Pillow's ``convert("RGB")``).

Anything else Pillow reads (CCITT, old-style JPEG, float or signed
samples, LogLuv, LAB, YCbCr without JPEG, BigTIFF, an Orientation that
swaps the sides, ...) raises ``ValueError`` naming the file and the tag
value; so does a file Pillow refuses.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from mm_s2ut_torch.data.jpeg import _cmyk_to_rgb, decode_jpeg

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I"}
# (photometric, bits per sample, extra samples) → what Pillow makes of it
_GRAY, _PAL, _RGB, _CMYK, _YCBCR = "gray", "palette", "rgb", "cmyk", "ycbcr"
_LAYOUTS = {
    **{(ph, (b,), ()): _GRAY for ph in (0, 1) for b in (1, 2, 4, 8)},
    (1, (16,), ()): _GRAY, (1, (8, 8), (2,)): _GRAY,
    **{(3, (b,), ()): _PAL for b in (1, 2, 4, 8)},
    (3, (8, 8), (0,)): _PAL, (3, (8, 8), (2,)): _PAL,
    **{(2, (b,) * 3, ()): _RGB for b in (8, 16)},
    **{(2, (b,) * 4, (e,)): _RGB for b in (8, 16) for e in (0, 1, 2)},
    (2, (8,) * 4, ()): _RGB, (2, (16,) * 4, ()): _RGB, (2, (8,) * 4, (999,)): _RGB,
    **{(2, (8,) * (4 + n), (e,) + (0,) * n): _RGB for n in (1, 2) for e in (0, 1, 2)},
    (5, (8,) * 4, ()): _CMYK, (5, (8,) * 5, (0,)): _CMYK, (5, (8,) * 6, (0, 0)): _CMYK,
    (6, (8, 8, 8), ()): _YCBCR,
}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _refuse(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what}, which this TIFF reader does not decode")


def _ifd(data: bytes, name: str) -> Tuple[str, Dict[int, tuple]]:
    """IFD 0's tags as tuples of values, with the byte order."""
    bo = "<" if data[:4] == b"II*\0" else ">"
    off = struct.unpack_from(bo + "I", data, 4)[0]
    if off + 2 > len(data):
        raise ValueError(f"{name}: TIFF IFD offset {off} past the end of the file")
    n = struct.unpack_from(bo + "H", data, off)[0]
    tags: Dict[int, tuple] = {}
    for i in range(n):
        pos = off + 2 + 12 * i
        if pos + 12 > len(data):
            raise ValueError(f"{name}: truncated TIFF IFD")
        tag, typ, count = struct.unpack_from(bo + "HHI", data, pos)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize("<" + fmt) * count
        at = pos + 8 if size <= 4 else struct.unpack_from(bo + "I", data, pos + 8)[0]
        if at + size > len(data):
            raise ValueError(f"{name}: TIFF tag {tag} past the end of the file")
        if typ in (2, 7):
            tags[tag] = (data[at: at + count],)
        else:
            vals = struct.unpack_from(bo + fmt * count, data, at)
            if typ in (5, 10):
                vals = tuple(a / b if b else 0.0 for a, b in zip(vals[0::2], vals[1::2]))
            tags[tag] = vals
    return bo, tags


def _packbits(raw: bytes, name: str) -> bytes:
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        c = raw[i]
        i += 1
        if c < 128:
            out += raw[i: i + c + 1]
            i += c + 1
        elif c > 128:
            if i >= n:
                break
            out += raw[i: i + 1] * (257 - c)
            i += 1
    return bytes(out)


def lzw_decode(raw: bytes, name: str = "<tiff>") -> bytes:
    """TIFF's LZW: MSB-first codes from 9 to 12 bits, each width growing one
    code before the table fills it (codes 256 clear, 257 end)."""
    roots = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(roots)
    size, prev = 9, None
    out = bytearray()
    acc = nbits = 0
    for byte in raw:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= size:
            nbits -= size
            c = (acc >> nbits) & ((1 << size) - 1)
            acc &= (1 << nbits) - 1
            if c == 256:
                table, size, prev = list(roots), 9, None
                continue
            if c == 257:
                return bytes(out)
            if prev is None:
                if c > 255:
                    raise ValueError(f"{name}: bad TIFF LZW code {c}")
                entry = table[c]
            elif c < len(table):
                entry = table[c]
                table.append(prev + entry[:1])
            elif c == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"{name}: bad TIFF LZW code {c}")
            out += entry
            prev = entry
            if len(table) + 1 >= (1 << size) and size < 12:
                size += 1
    return bytes(out)


def _undo_predictor(block: np.ndarray, bps: int, spp: int, bo: str) -> np.ndarray:
    """Horizontal differencing (predictor 2) undone on (rows, row bytes)."""
    rows = block.shape[0]
    if bps == 8:
        s = block.reshape(rows, -1, spp)
        return np.cumsum(s, axis=1, dtype=np.uint8).reshape(rows, -1)
    dt = np.dtype(bo + "u2")
    s = block.copy().view(dt).reshape(rows, -1, spp)
    return np.cumsum(s, axis=1, dtype=np.uint16).astype(dt).view(np.uint8).reshape(rows, -1)


def decode_tiff(data: bytes, name: str = "<tiff>") -> np.ndarray:
    """A TIFF file → IFD 0's (H, W, 3) uint8 RGB, as Pillow gives it."""
    if data[:4] not in (b"II*\0", b"MM\0*"):
        raise ValueError(f"{name}: not a TIFF file")
    bo, tags = _ifd(data, name)

    def tag(t, default=None):
        v = tags.get(t)
        return default if v is None else v

    try:
        width, height = tags[256][0], tags[257][0]
    except KeyError:
        raise ValueError(f"{name}: TIFF without ImageWidth or ImageLength") from None
    compression = tag(259, (1,))[0]
    photo = tag(262, (0,))[0]
    fill = tag(266, (1,))[0]
    planar = tag(284, (1,))[0]
    predictor = tag(317, (1,))[0]
    if compression not in (1, 5, 7, 8, 32773, 32946):
        raise _refuse(name, f"TIFF Compression {compression}")
    if tag(274, (1,))[0] in (5, 6, 7, 8):
        raise _refuse(name, f"TIFF Orientation {tag(274)[0]}")
    spp = tag(277, (3 if compression == 7 and photo in (2, 6) else 1,))[0]
    bps = tag(258, (1,))
    extra = tag(338, ())
    fmt = tag(339, (1,))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    if fmt != (1,) and (fmt, photo, bps[0]) != ((2,), 1, 8):  # Pillow reads signed 8-bit gray
        raise _refuse(name, f"TIFF SampleFormat {fmt}")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: TIFF BitsPerSample {bps} for {spp} samples")
    kind = _LAYOUTS.get((photo, bps, extra))
    if (photo, bps, extra, bo) == (0, (16,), (), "<"):
        kind = _GRAY  # Pillow's I;16: a MinIsWhite image read uninverted
    if kind is None:
        raise _refuse(name, f"TIFF PhotometricInterpretation {photo} with "
                            f"BitsPerSample {bps} and ExtraSamples {extra}")
    if kind == _YCBCR and compression != 7:
        raise _refuse(name, "TIFF YCbCr without JPEG compression")
    if predictor not in (1, 2) or (predictor == 2 and bps[0] not in (8, 16)):
        raise _refuse(name, f"TIFF Predictor {predictor} on {bps[0]}-bit samples")
    if compression == 7 and bps[0] != 8:
        raise _refuse(name, f"TIFF JPEG with {bps[0]}-bit samples")

    tiled = 322 in tags
    if tiled:
        tw, th = tag(322)[0], tag(323)[0]
        offsets, counts = tag(324, ()), tag(325, ())
    else:
        tw, th = width, min(tag(278, (height,))[0], height) or height
        offsets, counts = tag(273, ()), tag(279, ())
    if not offsets:
        raise ValueError(f"{name}: TIFF without strip or tile offsets")
    planes = spp if planar == 2 else 1
    per_plane = spp // planes
    across, down = -(-width // tw), -(-height // th)
    if len(offsets) < planes * across * down:
        raise ValueError(f"{name}: {len(offsets)} TIFF strips or tiles for "
                         f"{planes * across * down}")
    if len(counts) < len(offsets):
        counts = tuple(counts) + (len(data),) * (len(offsets) - len(counts))
    tables = tag(347, (b"",))[0]
    row_bytes = (tw * bps[0] * per_plane + 7) // 8

    planes_out = []
    for p in range(planes):
        out = np.zeros((down * th, across * row_bytes), np.uint8)
        for t in range(across * down):
            i = p * across * down + t
            raw = data[offsets[i]: offsets[i] + counts[i]]
            if fill == 2:
                raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
            ty, tx = divmod(t, across)
            rows = th if tiled else min(th, height - ty * th)
            if compression == 7:
                block = _jpeg_block(tables, raw, kind, name)[:rows, :tw]
                block = block.reshape(block.shape[0], -1)
                out[ty * th: ty * th + block.shape[0],
                    tx * row_bytes: tx * row_bytes + block.shape[1]] = block
                continue
            if compression == 1:
                buf = raw
            elif compression == 32773:
                buf = _packbits(raw, name)
            elif compression == 5:
                buf = lzw_decode(raw, name)
            else:
                try:
                    buf = zlib.decompressobj().decompress(raw)
                except zlib.error as e:
                    raise ValueError(f"{name}: bad TIFF Deflate data ({e})") from None
            need = rows * row_bytes
            if len(buf) < need:
                raise ValueError(f"{name}: TIFF strip or tile {i} holds {len(buf)} bytes, "
                                 f"{need} needed")
            block = np.frombuffer(buf, np.uint8, need).reshape(rows, row_bytes)
            if predictor == 2:
                block = _undo_predictor(block, bps[0], per_plane, bo)
            out[ty * th: ty * th + rows, tx * row_bytes: (tx + 1) * row_bytes] = block
        planes_out.append(out)
    return _to_rgb(planes_out, kind, photo, bps, extra, width, height, bo, tags, name,
                   compression == 7)


def _jpeg_block(tables: bytes, raw: bytes, kind: str, name: str) -> np.ndarray:
    """One JPEG strip or tile (its tables from JPEGTables) → (rows, cols, c)."""
    stream = tables[:-2] + raw[2:] if tables[:2] == b"\xff\xd8" and raw[:2] == b"\xff\xd8" \
        else raw
    rgb = decode_jpeg(stream, name)
    return rgb[..., :1] if kind == _GRAY else rgb


def _samples(planes: List[np.ndarray], bps: Tuple[int, ...], width: int, height: int,
             bo: str) -> np.ndarray:
    """Stored bytes of every plane → (height, width, samples) int64."""
    out = []
    for plane in planes:
        b = bps[0]
        if b == 16:
            v = plane.view(np.dtype(bo + "u2")).astype(np.int64)
        elif b == 8:
            v = plane.astype(np.int64)
        else:
            bits = np.unpackbits(plane, axis=1).reshape(plane.shape[0], -1, b)
            v = (bits * (1 << np.arange(b - 1, -1, -1))).sum(-1)
        out.append(v[:height].reshape(height, -1)[:, : width * (len(bps) // len(planes))]
                   .reshape(height, width, -1))
    return np.concatenate(out, axis=2)


def _to_rgb(planes, kind, photo, bps, extra, width, height, bo, tags, name, jpeg) -> np.ndarray:
    if jpeg:  # data/jpeg.py's RGB (or gray) rows already
        c = 1 if kind == _GRAY else 3
        px = planes[0][:height, : width * c].reshape(height, width, c)
        return np.ascontiguousarray(np.repeat(px, 3, 2) if c == 1 else px)
    px = _samples(planes, bps, width, height, bo)
    b = bps[0]
    if kind == _GRAY:
        v = px[..., 0]
        if b == 16:
            v = np.minimum(v, 255)
        elif b < 8:
            v = v * (255 // ((1 << b) - 1))
        if photo == 0 and b <= 8:
            v = 255 - v
        return np.repeat(v.astype(np.uint8)[..., None], 3, 2)
    if kind == _PAL:
        cmap = np.asarray(tags.get(320, ()), np.int64)
        n = 1 << b
        if cmap.size < 3 * n:
            raise ValueError(f"{name}: TIFF ColorMap of {cmap.size} values for {b}-bit indices")
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = (cmap[: 3 * n].reshape(3, n).T // 256)
        return pal[px[..., 0]]
    if b == 16:
        px = px >> 8
    if kind == _CMYK:
        return _cmyk_to_rgb([255 - px[..., i] for i in range(4)]).astype(np.uint8)
    rgb = px[..., :3]
    if extra[:1] == (1,):  # premultiplied: Pillow's RGBa unpacker
        a = px[..., 3:4]
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb,
                                           np.minimum(rgb * 255 // np.maximum(a, 1), 255)))
    return np.ascontiguousarray(rgb.astype(np.uint8))
