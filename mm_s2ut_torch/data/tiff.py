"""TIFF files without Pillow (numpy, the standard library, ``data/jpeg.py``,
``data/ccitt.py`` and ``data/zstd.py``).

:func:`decode_tiff` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
the first image (IFD 0) of a TIFF, as Pillow 12 reads it through libtiff:

* classic TIFF and BigTIFF (8-byte offsets), either byte order, strips or
  tiles, planar configuration 1 or 2, fill order 1 or 2 (the bits of every
  stored byte reversed);
* compression none, PackBits, LZW (TIFF's code-size change one code
  early), Deflate and Adobe Deflate (``zlib``), LZMA (``lzma``), ZSTD
  (``data/zstd.py``), CCITT RLE, Group 3 (1D and 2D) and Group 4
  (``data/ccitt.py``), ThunderScan (4-bit), and new-style JPEG (7): each
  strip or tile a JPEG stream decoded by ``data/jpeg.py`` with the
  JPEGTables tag's tables before it, YCbCr converted to RGB by libjpeg's
  rules (libtiff's ``JPEGCOLORMODE_RGB``), every other kind's samples
  taken as stored, as libtiff's JPEG codec hands them to Pillow (no
  colour conversion: CMYK not inverted, gray with alpha as 2 components,
  RGBA as 4), then converted as those of any other compression; CMYK with
  extra samples (5 or 6 components, more than libjpeg-turbo reads) is
  refused, as Pillow refuses it;
* YCbCr without new-style JPEG as libtiff's ``TIFFRGBAImage`` gives it to
  Pillow: compressed strips of data units at any subsampling it takes, or
  an old-style JPEG (6) through JPEGInterchangeFormat as libjpeg's raw
  components; each block's chroma replicated over its pixels, converted
  by libtiff's fixed-point tables from YCbCrCoefficients and
  ReferenceBlackWhite;
* the horizontal predictor (2) on 8-, 16- and 32-bit samples, and the
  floating-point predictor (3) on 32-bit floats;
* Pillow's modes: MinIsWhite and MinIsBlack at 1/2/4/8 bits (scaled to
  0..255, inverted for MinIsWhite) and 16 bits (``I;16``/``I;16B``, which
  ``convert("RGB")`` clamps to 255; Pillow reads a 16-bit MinIsWhite
  image uninverted), ``I`` (signed 16- and 32-bit gray, unsigned 32-bit
  little-endian gray read as signed) and ``F`` (32-bit float gray), which
  ``convert("RGB")`` clips to 0..255 (``F`` truncated, NaN to 0), gray
  with alpha, RGB and RGBA at 8 and 16 bits (the high byte; premultiplied
  alpha undone as Pillow's ``RGBa`` unpacker does, then dropped), palette
  images at 1/2/4/8 bits (the ColorMap's high bytes), and CMYK at 8 and 16
  bits (the high byte; Pillow's ``convert("RGB")``);
* a compressed big-endian ``I`` or ``F`` image as Pillow reads it on a
  little-endian host: libtiff hands Pillow native-order samples, which
  Pillow unpacks as big-endian, so each sample's bytes come out reversed;
* the Orientation tag, applied as Pillow's ``exif_transpose`` applies it.

Anything else (LAB, which Pillow converts through LittleCMS; 4x4 YCbCr
blocks that libtiff reads short; SGI LogLuv, WebP, big-endian BigTIFF and
uncompressed YCbCr, which Pillow here cannot read; CCITT's uncompressed
mode, ...) raises ``ValueError`` naming the file and the tag value; so does
a file Pillow refuses.
"""
from __future__ import annotations

import lzma
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from mm_s2ut_torch.data import zstd
from mm_s2ut_torch.data.ccitt import decode_ccitt
from mm_s2ut_torch.data.jpeg import (_cmyk_to_rgb, decode_jpeg, decode_jpeg_components,
                                     decode_jpeg_samples)

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
# (photometric, bits per sample, extra samples) → what Pillow makes of it
_GRAY, _PAL, _RGB, _CMYK, _YCBCR = "gray", "palette", "rgb", "cmyk", "ycbcr"
_INT, _FLOAT = "I", "F"  # Pillow's 32-bit modes, clipped to 0..255 by convert("RGB")
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
    (5, (16,) * 4, ()): _CMYK,
    (6, (8, 8, 8), ()): _YCBCR,
}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
_COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32773, 32809, 32946, 34925, 50000)
# the YCbCr subsamplings libtiff's TIFFRGBAImage converts (its putcontig8bitYCbCr*)
_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
# Orientation → Pillow's exif_transpose on (H, W, 3)
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a[::-1, ::-1].transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}


def _refuse(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what}, which this TIFF reader does not decode")


def _ifd(data: bytes, name: str) -> Tuple[str, Dict[int, tuple]]:
    """IFD 0's tags as tuples of values, with the byte order (classic TIFF:
    4-byte offsets and 12-byte entries; BigTIFF: 8 and 20)."""
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    if big and bo == ">":
        raise ValueError(f"{name}: big-endian BigTIFF, which Pillow 12 takes for a classic "
                         "TIFF and refuses")
    off_fmt, count_fmt, entry, inline = ("Q", "Q", 20, 8) if big else ("I", "H", 12, 4)
    head = 8 if big else 4
    if len(data) < head + struct.calcsize(off_fmt):
        raise ValueError(f"{name}: truncated TIFF header")
    off = struct.unpack_from(bo + off_fmt, data, head)[0]
    if off + struct.calcsize(count_fmt) > len(data):
        raise ValueError(f"{name}: TIFF IFD offset {off} past the end of the file")
    n = struct.unpack_from(bo + count_fmt, data, off)[0]
    first = off + struct.calcsize(count_fmt)
    tags: Dict[int, tuple] = {}
    for i in range(n):
        pos = first + entry * i
        if pos + entry > len(data):
            raise ValueError(f"{name}: truncated TIFF IFD")
        tag, typ = struct.unpack_from(bo + "HH", data, pos)
        count = struct.unpack_from(bo + off_fmt, data, pos + 4)[0]
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize("<" + fmt) * count
        value_at = pos + 4 + struct.calcsize(off_fmt)
        at = value_at if size <= inline else struct.unpack_from(bo + off_fmt, data, value_at)[0]
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
    dt = np.dtype(bo + {16: "u2", 32: "u4"}[bps])
    s = block.copy().view(dt).reshape(rows, -1, spp)
    return np.cumsum(s, axis=1, dtype=dt.newbyteorder("=")).astype(dt).view(np.uint8) \
        .reshape(rows, -1)


def _undo_fp_predictor(block: np.ndarray, spp: int, bo: str) -> np.ndarray:
    """libtiff's floating-point predictor (3) on 32-bit samples: bytes
    summed along the row at a stride of one pixel, then each row's four
    byte planes (most significant first) put back together, in the file's
    byte order."""
    rows = block.shape[0]
    summed = np.cumsum(block.reshape(rows, -1, spp), axis=1, dtype=np.uint8).reshape(rows, -1)
    planes = summed.reshape(rows, 4, -1).transpose(0, 2, 1)  # big-endian bytes per sample
    return np.ascontiguousarray(planes if bo == ">" else planes[..., ::-1]).reshape(rows, -1)


def _thunderscan(raw: bytes, width: int, rows: int, name: str) -> bytes:
    """ThunderScan 4-bit rows, as libtiff's ThunderDecode reads them: each
    row from a last pixel of 0; runs of the last pixel, 2- and 3-bit deltas
    from it, and raw values."""
    two, three = (0, 1, 0, -1), (0, 1, 2, 3, 0, -3, -2, -1)
    row_bytes = (width + 1) // 2
    out = bytearray()
    i = 0
    for _ in range(rows):
        px: List[int] = []
        last = 0
        while i < len(raw) and len(px) < width:
            n = raw[i]
            i += 1
            code = n & 0xC0
            if code == 0x00:  # a run of the last pixel
                if len(px) + (n & 0x3F) > width:
                    raise ValueError(f"{name}: ThunderScan run past its row of {width}")
                px += [last] * (n & 0x3F)
            elif code == 0x40:
                for d in ((n >> 4) & 3, (n >> 2) & 3, n & 3):
                    if d != 2:
                        last = (last + two[d]) & 0xF
                        px.append(last)
            elif code == 0x80:
                for d in ((n >> 3) & 7, n & 7):
                    if d != 4:
                        last = (last + three[d]) & 0xF
                        px.append(last)
            else:
                last = n & 0xF
                px.append(last)
        if len(px) != width:
            raise ValueError(f"{name}: ThunderScan row of {len(px)} pixels, not {width}")
        px += [0] * (2 * row_bytes - width)
        out += bytes((a << 4) | b for a, b in zip(px[0::2], px[1::2]))
    return bytes(out)


def _kind(photo: int, fmt: tuple, bps: tuple, extra: tuple, bo: str, name: str) -> str:
    """What Pillow makes of the samples (its OPEN_INFO table)."""
    if fmt == (3,) and photo in (0, 1) and bps == (32,) and not extra:
        return _FLOAT
    if photo == 1 and not extra and (fmt == (2,) and bps in ((16,), (32,))
                                     or (fmt, bps, bo) == ((1,), (32,), "<")):
        return _INT
    if fmt != (1,) and (fmt, photo, bps) != ((2,), 1, (8,)):  # Pillow reads signed 8-bit gray
        raise _refuse(name, f"TIFF SampleFormat {fmt}")
    kind = _LAYOUTS.get((photo, bps, extra))
    if (photo, bps, extra, bo) == (0, (16,), (), "<"):
        kind = _GRAY  # Pillow's I;16: a MinIsWhite image read uninverted
    if kind is None:
        raise _refuse(name, f"TIFF PhotometricInterpretation {photo} with "
                            f"BitsPerSample {bps} and ExtraSamples {extra}")
    return kind


def _decompress(raw: bytes, compression: int, tw: int, rows: int, tags, name: str) -> bytes:
    if compression == 1:
        return raw
    if compression == 32773:
        return _packbits(raw, name)
    if compression == 5:
        return lzw_decode(raw, name)
    if compression in (2, 3, 4):
        options = tags.get(292 if compression == 3 else 293, (0,))[0]
        return decode_ccitt(raw, compression, tw, rows, options, name)
    if compression == 32809:
        return _thunderscan(raw, tw, rows, name)
    try:
        if compression == 34925:
            return lzma.decompress(raw)
        if compression == 50000:
            return zstd.decompress(raw)
        return zlib.decompressobj().decompress(raw)
    except (zlib.error, lzma.LZMAError, ValueError) as e:
        what = {34925: "LZMA", 50000: "ZSTD"}.get(compression, "Deflate")
        raise ValueError(f"{name}: bad TIFF {what} data ({e})") from None


def decode_tiff(data: bytes, name: str = "<tiff>") -> np.ndarray:
    """A TIFF file → IFD 0's (H, W, 3) uint8 RGB, as Pillow gives it."""
    if data[:4] not in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
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
    if compression not in _COMPRESSIONS:
        raise _refuse(name, f"TIFF Compression {compression}")
    if compression == 6:
        photo = 6  # Pillow takes an old-style JPEG for YCbCr whatever the tag says
    spp = tag(277, (3 if compression in (6, 7) and photo in (2, 6) else 1,))[0]
    bps = tag(258, (1,))
    extra = tag(338, ())
    fmt = tag(339, (1,))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: TIFF BitsPerSample {bps} for {spp} samples")
    kind = _kind(photo, fmt, bps, extra, bo, name)
    if kind == _YCBCR and compression != 7:
        rgb = _ycbcr_rgba(data, tags, compression, planar, predictor, fill, width, height, name)
        orient = _ORIENT.get(tag(274, (1,))[0])
        return np.ascontiguousarray(orient(rgb) if orient else rgb)
    if compression == 1:
        predictor = 1  # Pillow reads uncompressed strips itself, ignoring the predictor
    if (predictor not in (1, 2, 3) or (predictor == 2 and bps[0] not in (8, 16, 32))
            or (predictor == 3 and kind != _FLOAT)):
        raise _refuse(name, f"TIFF Predictor {predictor} on {bps[0]}-bit samples")
    if compression == 7 and bps[0] != 8:
        raise _refuse(name, f"TIFF JPEG with {bps[0]}-bit samples")
    if compression in (2, 3, 4) and bps != (1,) or compression == 32809 and bps != (4,):
        raise _refuse(name, f"TIFF Compression {compression} with BitsPerSample {bps}")

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
                block = _jpeg_block(tables, raw, kind, per_plane, name)[:rows, :tw]
                block = block.reshape(block.shape[0], -1)
                out[ty * th: ty * th + block.shape[0],
                    tx * row_bytes: tx * row_bytes + block.shape[1]] = block
                continue
            buf = _decompress(raw, compression, tw, rows, tags, name)
            need = rows * row_bytes
            if len(buf) < need:
                raise ValueError(f"{name}: TIFF strip or tile {i} holds {len(buf)} bytes, "
                                 f"{need} needed")
            block = np.frombuffer(buf, np.uint8, need).reshape(rows, row_bytes)
            if predictor == 2:
                block = _undo_predictor(block, bps[0], per_plane, bo)
            elif predictor == 3:
                block = _undo_fp_predictor(block, per_plane, bo)
            out[ty * th: ty * th + rows, tx * row_bytes: (tx + 1) * row_bytes] = block
        planes_out.append(out)
    # a compressed big-endian I or F image: Pillow unpacks libtiff's native
    # (little-endian) samples as big-endian, reversing each sample's bytes
    sample_bo = "<" if kind in (_INT, _FLOAT) and compression != 1 else bo
    rgb = _to_rgb(planes_out, kind, photo, bps, extra, width, height, sample_bo, tags, name,
                  compression == 7 and kind == _YCBCR)
    orient = _ORIENT.get(tag(274, (1,))[0])
    return np.ascontiguousarray(orient(rgb) if orient else rgb)


def _ycbcr_tables(tags) -> Tuple[np.ndarray, ...]:
    """libtiff's TIFFYCbCrToRGBInit in its own float32 and 16-bit fixed-point
    arithmetic: (Y, Cr→R, Cb→B, Cr→G, Cb→G) tables over the 256 codes, from
    YCbCrCoefficients (529) and ReferenceBlackWhite (532)."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in tags.get(529, (0.299, 0.587, 0.114))[:3])
    rbw = [f32(v) for v in tags.get(532, (0, 255, 128, 255, 128, 255))[:6]]
    if lg == 0:
        raise ValueError("TIFF YCbCrCoefficients with a green coefficient of 0")

    def fix(v):
        return int(float(f32(min(max(v, f32(0)), f32(2))) * f32(65536)) + 0.5)

    def code2v(c, rb, rw, cr):
        span = rw - rb if rw - rb != 0 else f32(1)
        v = (c - np.int64(np.trunc(rb))).astype(f32) * f32(cr) / f32(span)
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)

    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)
    x = np.arange(-128, 128, dtype=np.int64)
    cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    y = code2v(x + 128, rbw[0], rbw[1], 255)
    return y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768


def _ycbcr_rgba(data, tags, compression, planar, predictor, fill, width, height,
                name) -> np.ndarray:
    """YCbCr without new-style JPEG, as Pillow reads it through libtiff's
    TIFFRGBAImage: subsampled data units (h·v Y samples, Cb, Cr) in strips,
    or an old-style JPEG's raw components; each block's chroma replicated
    over its pixels (no interpolation) and converted by libtiff's tables."""
    if compression == 1:
        raise _refuse(name, "TIFF YCbCr without compression (Pillow unpacks its data units "
                            "as RGBX and runs short)")
    if planar != 1 or predictor != 1 or 322 in tags:
        raise _refuse(name, f"TIFF YCbCr with PlanarConfiguration {planar}, Predictor "
                            f"{predictor} or tiles")
    if compression == 6:
        h, v, y, cb, cr = _ojpeg_planes(data, tags, width, height, name)
    else:
        h, v = tuple(tags.get(530, (2, 2))[:2])
        if (h, v) not in _SUBSAMPLINGS:
            raise _refuse(name, f"TIFF YCbCrSubsampling {(h, v)}")
        y, cb, cr = _data_units(data, tags, compression, fill, h, v, width, height, name)
    blocks = -(-width // h)
    if blocks * (h * v + 2) % v:  # libtiff's scanline size rounds the strip down
        raise _refuse(name, f"TIFF YCbCrSubsampling {(h, v)} over {blocks} blocks a row, "
                            "which libtiff reads short")
    up = (lambda c: np.repeat(np.repeat(c, v, 0), h, 1)[:height, :width])
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(tags)
    Y, Cb, Cr = y_tab[y[:height, :width]], up(cb), up(cr)
    rgb = np.stack([Y + cr_r[Cr], Y + ((cb_g[Cb] + cr_g[Cr]) >> 16), Y + cb_b[Cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _data_units(data, tags, compression, fill, h, v, width, height, name):
    """Strips of data units → Y (rows, width·) and the chroma planes."""
    rps = min(tags.get(278, (height,))[0], height) or height
    if rps % v and rps < height:
        raise _refuse(name, f"TIFF YCbCr RowsPerStrip {rps} for YCbCrSubsampling {(h, v)}")
    offsets, counts = tags.get(273, ()), tags.get(279, ())
    blocks = -(-width // h)
    unit = h * v + 2
    ys, cbs, crs = [], [], []
    for i in range(-(-height // rps)):
        if i >= len(offsets):
            raise ValueError(f"{name}: {len(offsets)} TIFF strips for {height} rows")
        raw = data[offsets[i]: offsets[i] + (counts[i] if i < len(counts) else len(data))]
        if fill == 2:
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        rows = -(-min(rps, height - i * rps) // v)
        buf = _decompress(raw, compression, width, rows, tags, name)
        if len(buf) < rows * blocks * unit:
            raise ValueError(f"{name}: TIFF strip {i} holds {len(buf)} bytes, "
                             f"{rows * blocks * unit} needed")
        u = np.frombuffer(buf, np.uint8, rows * blocks * unit).reshape(rows, blocks, unit)
        ys.append(u[..., : h * v].reshape(rows, blocks, v, h).transpose(0, 2, 1, 3)
                  .reshape(rows * v, blocks * h))
        cbs.append(u[..., h * v])
        crs.append(u[..., h * v + 1])
    return (np.concatenate(ys).astype(np.int64), np.concatenate(cbs).astype(np.int64),
            np.concatenate(crs).astype(np.int64))


def _ojpeg_planes(data, tags, width, height, name):
    """An old-style JPEG (6) with JPEGInterchangeFormat (513, 514): libtiff's
    OJPEG hands TIFFRGBAImage libjpeg's raw components, the JPEG's own
    sampling taking the place of YCbCrSubsampling."""
    if 513 not in tags:
        raise _refuse(name, "TIFF Compression 6 without JPEGInterchangeFormat")
    at = tags[513][0]
    length = tags.get(514, (len(data) - at,))[0]
    comps = decode_jpeg_components(data[at: at + length], name)
    if len(comps) != 3 or comps[1][1] != (1, 1) or comps[2][1] != (1, 1):
        raise _refuse(name, "TIFF Compression 6 other than three components with the chroma "
                            "at (1, 1)")
    (y, (h, v)), (cb, _), (cr, _) = comps
    if (h, v) not in _SUBSAMPLINGS or y.shape[0] < height or y.shape[1] < width:
        raise _refuse(name, f"TIFF Compression 6 with sampling {(h, v)} over "
                            f"{y.shape[1]}x{y.shape[0]}")
    return h, v, np.clip(y, 0, 255), np.clip(cb, 0, 255), np.clip(cr, 0, 255)


def _jpeg_block(tables: bytes, raw: bytes, kind: str, samples: int, name: str) -> np.ndarray:
    """One JPEG strip or tile (its tables from JPEGTables) → (rows, cols, c):
    YCbCr as RGB (libtiff's ``JPEGCOLORMODE_RGB``), any other kind its
    ``samples`` components as stored (libtiff asks libjpeg for no colour
    conversion there)."""
    stream = tables[:-2] + raw[2:] if tables[:2] == b"\xff\xd8" and raw[:2] == b"\xff\xd8" \
        else raw
    if kind == _YCBCR:
        return decode_jpeg(stream, name)
    return decode_jpeg_samples(stream, samples, name)


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
    if jpeg:  # data/jpeg.py's RGB rows already
        return np.ascontiguousarray(planes[0][:height, : width * 3].reshape(height, width, 3))
    if kind in (_INT, _FLOAT):
        b = bps[0] // 8
        code = "f" if kind == _FLOAT else "i"
        v = planes[0][:height, : width * b].copy().view(np.dtype(f"{bo}{code}{b}"))
        if kind == _FLOAT:  # Pillow's F→L: clipped, then truncated; NaN is 0
            v = np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(np.uint8)
        else:
            v = np.clip(v, 0, 255).astype(np.uint8)
        return np.repeat(v.reshape(height, width, 1), 3, 2)
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
