"""The containers Pillow opens besides PNG and JPEG, without Pillow:
``data/image_io.read_image`` on BMP, GIF, TIFF and WebP files against
``np.asarray(Image.open(p).convert("RGB"))``, max |difference| 0.

* BMP (``data/bmp.py``): 1/4/8-bit palettes (and Pillow's ``1``/``L``
  for palettes of grays), 16 bits 5-5-5 and BI_BITFIELDS 5-6-5 (every
  one of the 65536 values), 24 and 32 bits (BI_RGB and BI_BITFIELDS
  layouts), RLE8 and RLE4 with delta and end-of-line escapes, top-down
  rows, the 12-byte core header and the V4/V5 headers.
* GIF (``data/gif.py``): the first frame of a global or local palette,
  interlaced rows, a frame at an offset on its screen with a transparent
  index, one that grows the screen, an animation, a full LZW table kept
  without a clear code.
* TIFF (``data/tiff.py``): classic and BigTIFF, strips and tiles, planar
  configuration 2, none / PackBits / LZW / Deflate / JPEG (YCbCr) / LZMA /
  ZSTD (``data/zstd.py``) / CCITT RLE, Group 3 1D and 2D, Group 4
  (``data/ccitt.py``) / ThunderScan, the horizontal predictor on 8-, 16-
  and 32-bit samples and the floating-point one, both byte orders, fill
  order 2, MinIsWhite and MinIsBlack at 1/2/4/8/16 bits, Pillow's ``I``
  and ``F`` (signed 16/32-bit, unsigned 32-bit and float gray), palettes,
  RGB and RGBA at 8 and 16 bits (premultiplied alpha too), CMYK at 8 and
  16 bits, every Orientation.
* WebP (``data/webp.py``): lossless files using each of the four
  transforms, with alpha, animated; lossy files at several qualities, a
  photo-sized one, with an ALPH chunk, animated, and with the simple loop
  filter, a sharpness and loop-filter deltas (libwebp's encoder writes
  none of these, so :func:`vp8_rewrite` re-encodes a file's first
  partition with them set).

What Pillow refuses raises ``ValueError`` naming the file, each refusal
checked against Pillow first (big-endian BigTIFF, WebP-in-TIFF, which
this libtiff lacks, 64-bit floats, a cut ZSTD strip); what Pillow reads
and the port does not decode (CIELab, which Pillow converts through
LittleCMS, YCbCr without JPEG, old-style JPEG) raises ``ValueError``
naming the file and the tag's value. JAX's ``RawImageStore`` (Pillow) and
the port's read one file of each container to equal pixels.

The committed fixtures of Netpbm, TGA, ICO/CUR/DIB, QOI and SGI files
(``test_torch_image_rasters.py``, which holds their sweeps) join these in
the fixture test, the format each is opened as checked against Pillow's,
and in the test against JAX's ``RawImageStore``.

Pillow writes what it can; the small writers here write the rest
(:func:`bmp_bytes` with :func:`rle8`/:func:`rle4`, :func:`gif_bytes` with
its LZW coder, :func:`tiff_bytes` with TIFF's LZW and PackBits, the
floating-point predictor and BigTIFF, :func:`thunderscan`, and
:func:`vp8_rewrite` with RFC 6386's boolean encoder). The committed
fixtures under ``tests/torch_images/formats/`` are
:func:`container_fixture_bytes`, written anew with the other formats by
``PYTHONPATH=. python tests/test_torch_image_formats.py``.
"""
import io
import lzma
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mm_s2ut_torch.data import image_io as I
from mm_s2ut_torch.data import webp as webp_mod
from test_torch_image_formats import FORMATS, pil_refuses, pil_rgb, save, scene


def assert_equals_pil(data: bytes, tmp_path, name: str):
    want = pil_rgb(data)
    (tmp_path / name).write_bytes(data)
    got = I.read_image(tmp_path / name)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------- BMP

def bmp_bytes(pixels, bits, *, palette=None, compression=0, header=40, masks=None,
              top_down=False, data=None, colors=None) -> bytes:
    """A BMP file: ``pixels`` (h, w) indices or (h, w, c) bytes in file
    order (B, G, R[, X]) or (h, w) 16-bit values; ``data`` replaces the
    packed rows (RLE streams)."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    if data is None:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits < 8:
            vals = px.astype(np.int64)
            bitrows = ((vals[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(h, -1)
            rows = np.packbits(bitrows.astype(np.uint8), axis=1)
        elif bits == 16:
            rows = px.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            rows = px.astype(np.uint8).reshape(h, -1)
        rows = np.pad(rows, ((0, 0), (0, stride - rows.shape[1])))
        data = (rows if top_down else rows[::-1]).tobytes()
    pal = b""
    if palette is not None:
        entries = np.asarray(palette, np.uint8)[:, ::-1]  # RGB → BGR
        if header != 12:
            entries = np.pad(entries, ((0, 0), (0, 1)))
        pal = entries.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        ncol = len(palette) if colors is None and palette is not None else colors or 0
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, ncol, 0)
        extra = b""
        if header == 40 and masks is not None:
            extra = struct.pack("<3I", *masks[:3])
        elif header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            info += struct.pack("<4I", *m[:4]) + bytes(header - 56)
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + extra + pal
            + data)


def _rle(rows, rle4: bool) -> bytes:
    """An RLE8/RLE4 stream of (h, w) indices in file order (bottom row
    first): runs, odd and even absolute runs (word-aligned), a delta over
    pixels of index 0, end of line after each row, end of bitmap."""
    out = bytearray()
    for y, row in enumerate(rows):
        row = [int(v) for v in row]
        x = 0
        while x < len(row):
            if y % 5 == 2 and x == 1 and len(row) > 6 and all(v == 0 for v in row[1:4]):
                out += bytes([0, 2, 0xEE, 0xEE, 3, 0])  # Pillow skips two bytes, then (3, 0)
                x += 3
                continue
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 255:
                run += 1
            if rle4 and run == 1 and x + 1 < len(row):  # alternating pair as an encoded run
                run, pair = 2, (row[x] << 4) | row[x + 1]
                out += bytes([run, pair])
                x += 2
                continue
            if run >= 3 or len(row) - x < 3:
                out += bytes([run, row[x] if not rle4 else (row[x] << 4) | row[x]])
                x += run
                continue
            n = 3
            while x + n < len(row) and n < 254 and row[x + n] != row[x + n - 1]:
                n += 1
            if rle4:
                n -= n % 2  # whole bytes only
                lit = bytes((row[x + i] << 4) | row[x + i + 1] for i in range(0, n, 2))
            else:
                lit = bytes(row[x: x + n])
            out += bytes([0, n]) + lit
            if len(lit) % 2:
                out += b"\0"
            x += n
        out += bytes([0, 0])
    return bytes(out + bytes([0, 1]))


def rle8(indices) -> bytes:
    return _rle(np.asarray(indices)[::-1], False)


def rle4(indices) -> bytes:
    return _rle(np.asarray(indices)[::-1], True)


def _palette(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 3))


def _indices(h, w, n, seed):
    """Indices with runs and zeros (so that RLE has runs, literals and deltas)."""
    rng = np.random.RandomState(seed)
    idx = (scene(h, w, seed=seed, noise=0)[..., 0].astype(np.int64) * n // 256)
    idx[rng.rand(h, w) < 0.2] = rng.randint(0, n)
    idx[2::5, 1:4] = 0
    return idx


def bmp_fixtures():
    rgb = scene(37, 45, seed=21)
    bgr = rgb[..., ::-1]
    v16 = (scene(29, 33, seed=22).astype(np.int64) * 257)[..., 0] & 0xFFFF
    bgrx = np.concatenate([bgr, scene(37, 45, c=1, seed=23)], 2)
    return {
        "bmp_bw1.bmp": save(Image.fromarray(rgb).convert("1"), "BMP"),
        "bmp_pal1.bmp": bmp_bytes(_indices(37, 45, 2, 1), 1, palette=_palette(2, 1)),
        "bmp_pal4.bmp": bmp_bytes(_indices(37, 45, 16, 2), 4, palette=_palette(16, 2)),
        "bmp_pal8.bmp": save(Image.fromarray(rgb).quantize(64), "BMP"),
        "bmp_gray8.bmp": save(Image.fromarray(rgb).convert("L"), "BMP"),
        "bmp_core8.bmp": bmp_bytes(_indices(29, 33, 200, 3), 8, palette=_palette(200, 3),
                                   header=12),
        "bmp_555.bmp": bmp_bytes(v16, 16),
        "bmp_565_v4.bmp": bmp_bytes(v16, 16, compression=3, header=108,
                                    masks=(0xF800, 0x7E0, 0x1F, 0)),
        "bmp24.bmp": save(Image.fromarray(rgb), "BMP"),
        "bmp24_topdown.bmp": bmp_bytes(bgr, 24, top_down=True),
        "bmp32.bmp": bmp_bytes(bgrx, 32),
        "bmp32_bitfields_v5.bmp": bmp_bytes(bgrx, 32, compression=3, header=124,
                                            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "bmp_rle8.bmp": bmp_bytes(np.zeros((37, 45)), 8, palette=_palette(40, 4),
                                  compression=1, data=rle8(_indices(37, 45, 40, 4))),
        "bmp_rle4.bmp": bmp_bytes(np.zeros((37, 45)), 4, palette=_palette(16, 5),
                                  compression=2, data=rle4(_indices(37, 45, 16, 5))),
    }


# ----------------------------------------------------------------------- GIF

def gif_lzw(idx: bytes, min_size: int, clear_when_full: bool = True) -> bytes:
    """GIF's LZW of ``idx`` (a clear code first; with ``clear_when_full``
    False the full table is kept: a deferred clear)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    table = {bytes([i]): i for i in range(clear)}
    nxt, size = end + 1, min_size + 1
    codes = [(clear, size)]
    w = b""
    for p in idx:
        wc = w + bytes([p])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], size))
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt - 1 == (1 << size) and size < 12:
                size += 1
        elif clear_when_full:
            codes.append((clear, size))
            table = {bytes([i]): i for i in range(clear)}
            nxt, size = end + 1, min_size + 1
        w = bytes([p])
    codes += [(table[w], size), (end, size)]
    acc = n = 0
    out = bytearray()
    for c, s in codes:
        acc |= c << n
        n += s
        while n >= 8:
            out.append(acc & 255)
            acc >>= 8
            n -= 8
    return bytes(out + (bytes([acc]) if n else b""))


def gif_bytes(screen, frame, *, global_pal=None, local_pal=None, offset=(0, 0),
              transparency=None, interlace=False, min_size=8, clear=True) -> bytes:
    """A GIF89a of one frame: ``frame`` (h, w) indices at ``offset`` on a
    ``screen`` (width, height)."""
    h, w = frame.shape
    flags = (0x80 | 7) if global_pal is not None else 0
    out = b"GIF89a" + struct.pack("<HHBBB", *screen, flags, 0, 0)
    if global_pal is not None:
        out += np.asarray(global_pal, np.uint8).tobytes()
    if transparency is not None:
        out += bytes([0x21, 0xF9, 4, 1, 0, 0, transparency, 0])
    iflags = (0x80 | 7 if local_pal is not None else 0) | (0x40 if interlace else 0)
    out += b"," + struct.pack("<HHHHB", *offset, w, h, iflags)
    if local_pal is not None:
        out += np.asarray(local_pal, np.uint8).tobytes()
    rows = frame
    if interlace:
        rows = frame[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                     np.arange(1, h, 2)])]
    code = gif_lzw(rows.astype(np.uint8).tobytes(), min_size, clear)
    out += bytes([min_size]) + b"".join(bytes([len(code[i: i + 255])]) + code[i: i + 255]
                                        for i in range(0, len(code), 255))
    return out + b"\0;"


def gif_fixtures():
    rgb = Image.fromarray(scene(37, 45, seed=31))
    frames = [Image.fromarray(scene(37, 45, seed=32 + k)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=40)
    idx = _indices(30, 40, 256, 33)
    return {
        "gif_global.gif": save(rgb, "GIF"),
        "gif_gray.gif": save(rgb.convert("L"), "GIF"),
        "gif_interlaced.gif": save(rgb, "GIF", interlace=True),
        "gif_animated.gif": buf.getvalue(),
        "gif_local_palette.gif": gif_bytes((40, 30), idx, global_pal=_palette(256, 34),
                                           local_pal=_palette(256, 35), interlace=True),
        "gif_offset_transparent.gif": gif_bytes((48, 40), idx[:20, :30],
                                                global_pal=_palette(256, 36), offset=(9, 13),
                                                transparency=7),
        "gif_grows.gif": gif_bytes((30, 20), idx[:25, :35], local_pal=_palette(256, 37),
                                   offset=(8, 6)),
    }


# ---------------------------------------------------------------------- TIFF

def tiff_lzw(raw: bytes) -> bytes:
    """TIFF's LZW: MSB-first codes, widths growing one code early, a clear
    code before the table fills."""
    table = {bytes([i]): i for i in range(256)}
    nxt, size = 258, 9
    codes = [(256, 9)]
    w = b""
    for b in raw:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], size))
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << size) and size < 12:
            size += 1
        if nxt >= 4094:
            codes.append((256, size))
            table = {bytes([i]): i for i in range(256)}
            nxt, size = 258, 9
        w = bytes([b])
    if w:
        codes.append((table[w], size))
    codes.append((257, size))
    acc = n = 0
    out = bytearray()
    for c, s in codes:
        acc = (acc << s) | c
        n += s
        while n >= 8:
            n -= 8
            out.append((acc >> n) & 255)
    return bytes(out + (bytes([(acc << (8 - n)) & 255]) if n else b""))


def packbits(raw: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j + 1 < len(raw) and raw[j + 1] == raw[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + raw[i: i + 1]
            i = j + 1
            continue
        k = i + 1
        while k < len(raw) and k - i < 128 and not (k + 1 < len(raw) and raw[k + 1] == raw[k]):
            k += 1
        out += bytes([k - i - 1]) + raw[i:k]
        i = k
    return bytes(out)


_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def fp_predict(rows: np.ndarray, spp: int) -> np.ndarray:
    """libtiff's floating-point predictor (3) on (rows, samples) float32:
    each row's bytes split into planes, most significant first, then
    differenced at a stride of one pixel."""
    be = rows.astype(">f4").view(np.uint8).reshape(rows.shape[0], -1, 4)
    planes = be.transpose(0, 2, 1).reshape(rows.shape[0], -1, spp).astype(np.int64)
    planes[:, 1:] = (planes[:, 1:] - planes[:, :-1]) & 255
    return planes.reshape(rows.shape[0], -1).astype(np.uint8)


def tiff_bytes(samples, bps, photo, *, bo="<", compression=1, predictor=1, tile=None,
               rows_per_strip=None, planar=1, extra=(), colormap=None, fill=1, fmt=None,
               tags=(), big=False, codec=None) -> bytes:
    """A one-page TIFF (or BigTIFF) of (h, w, s) samples; ``codec`` replaces
    the compression of each strip or tile's bytes."""
    samples = np.asarray(samples)
    h, w, spp = samples.shape
    code = {(32, 3): "f4", (32, 2): "i4", (32, 1): "u4", (16, 2): "i2"}.get(
        (bps, fmt or 1), {8: "u1", 16: "u2", 32: "f4"}.get(bps, "u1"))
    dt = np.dtype(bo + code)
    planes = [samples] if planar == 1 else [samples[..., i: i + 1] for i in range(spp)]
    tw, th = tile if tile else (w, rows_per_strip or h)
    chunks = []
    for pl in planes:
        for ty in range(-(-h // th)):
            for tx in range(-(-w // tw)):
                blk = pl[ty * th: (ty + 1) * th, tx * tw: (tx + 1) * tw]
                rows = th if tile else blk.shape[0]
                full = np.zeros((rows, tw, pl.shape[2]), blk.dtype)
                full[: blk.shape[0], : blk.shape[1]] = blk
                if predictor == 2:
                    full = (full.astype(dt).view(np.dtype(bo + f"u{bps // 8}")) if bps >= 16
                            else full).astype(np.int64)
                    full[:, 1:] = (full[:, 1:] - full[:, :-1]) & ((1 << bps) - 1)
                if predictor == 3:
                    raw = fp_predict(full.reshape(rows, -1), pl.shape[2]).tobytes()
                elif bps >= 8:
                    raw = full.astype(dt if predictor != 2 or bps < 16
                                      else np.dtype(bo + f"u{bps // 8}")).tobytes()
                else:
                    vals = full.astype(np.int64).reshape(rows, -1)
                    bits = (vals[..., None] >> np.arange(bps - 1, -1, -1)) & 1
                    raw = np.packbits(bits.reshape(rows, -1).astype(np.uint8), axis=1).tobytes()
                raw = codec(raw) if codec else {
                    5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress, 32773: packbits,
                    34925: lzma.compress}.get(compression, lambda r: r)(raw)
                chunks.append(_REV[np.frombuffer(raw, np.uint8)].tobytes() if fill == 2 else raw)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp), (259, 3, [compression]),
               (262, 3, [photo]), (277, 3, [spp]), (284, 3, [planar])]
    for tag, val in ((266, fill), (317, predictor)):
        if val != 1:
            entries.append((tag, 3, [val]))
    if extra:
        entries.append((338, 3, list(extra)))
    if colormap is not None:
        entries.append((320, 3, [int(v) for v in np.asarray(colormap).reshape(-1)]))
    if fmt is not None:
        entries.append((339, 3, [fmt] * spp))
    entries += list(tags)
    off, head = ("Q", 16) if big else ("I", 8)
    data = bytearray((b"II" if bo == "<" else b"MM") + struct.pack(
        bo + "H", 43 if big else 42)) + bytearray(head - 4)
    if big:
        struct.pack_into(bo + "HH", data, 4, 8, 0)
    offs = []
    for c in chunks:
        offs.append(len(data))
        data += c + b"\0" * (len(c) % 2)
    counts = [len(c) for c in chunks]
    entries += ([(322, 3, [tw]), (323, 3, [th]), (324, 4, offs), (325, 4, counts)] if tile
                else [(273, 4, offs), (278, 4, [th]), (279, 4, counts)])
    entries.sort()
    struct.pack_into(bo + off, data, head - struct.calcsize(off), len(data))
    entry, inline = (20, 8) if big else (12, 4)
    body = bytearray(struct.pack(bo + ("Q" if big else "H"), len(entries)))
    tail = bytearray()
    tail_at = len(data) + len(body) + entry * len(entries) + inline
    for tag, typ, vals in entries:  # RATIONAL (5) values come as numerator, denominator pairs
        raw = b"".join(struct.pack(bo + {3: "H", 4: "I", 5: "I"}[typ], v) for v in vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        if len(raw) <= inline:
            body += struct.pack(bo + "HH" + off, tag, typ, count) + raw.ljust(inline, b"\0")
        else:
            body += struct.pack(bo + "HH" + off + off, tag, typ, count, tail_at + len(tail))
            tail += raw + b"\0" * (len(raw) % 2)
    return bytes(data + body + bytes(inline) + tail)


def thunderscan(px, seed=0) -> bytes:
    """ThunderScan rows of 4-bit pixels, using every code: runs of the last
    pixel, 2-bit and 3-bit deltas (with their skip values) and raw values."""
    rng = np.random.RandomState(seed)
    two, three = {0: 0, 1: 1, 15: 3}, {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
    out = bytearray()
    for row in np.asarray(px).tolist():
        last, i = 0, 0
        while i < len(row):
            run = 0
            while i + run < len(row) and row[i + run] == last and run < 63:
                run += 1
            d = (row[i] - last) & 15
            d2 = (row[i + 1] - row[i]) & 15 if i + 1 < len(row) else None
            if run >= 2:
                out.append(run)
                i += run
            elif d in two and d2 in two and rng.rand() < 0.7:
                out.append(0x40 | two[d] << 4 | two[d2] << 2 | 2)
                last, i = row[i + 1], i + 2
            elif d in three and rng.rand() < 0.7:
                out.append(0x80 | three[d] << 3 | 4)
                last, i = row[i], i + 1
            else:
                out.append(0xC0 | row[i])
                last, i = row[i], i + 1
    return bytes(out)


def _nibbles(h, w, seed):
    rng = np.random.RandomState(seed)
    px = np.cumsum(rng.choice([-1, 0, 0, 0, 1, 2, -3, 5], (h, w)), axis=1) & 15
    if w > 6:
        px[0, -5:] = px[0, -6]  # a run up to the row's end
    return px


def ycbcr_units(y, cb, cr, h, v) -> bytes:
    """TIFF's YCbCr data units: for each block of v rows by h columns, its
    h·v Y samples, then Cb and Cr (``cb``, ``cr``: one per block)."""
    H, W = y.shape
    bh, bw = -(-H // v), -(-W // h)
    Y = np.zeros((bh * v, bw * h), np.int64)
    Y[:H, :W] = y
    blocks = Y.reshape(bh, v, bw, h).transpose(0, 2, 1, 3).reshape(bh, bw, h * v)
    return np.concatenate([blocks, np.asarray(cb)[..., None], np.asarray(cr)[..., None]], -1) \
        .astype(np.uint8).tobytes()


def ycbcr_tiff(H, W, h, v, seed, rows_per_strip=None, compression=8, tags=()) -> bytes:
    """A YCbCr TIFF without JPEG: seeded Y, Cb and Cr in data units."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 256, (H, W))
    cb, cr = rng.randint(0, 256, (2, -(-H // v), -(-W // h)))
    rps = rows_per_strip or H
    strips = iter([ycbcr_units(y[i: i + rps], cb[i // v: -(-(i + rps) // v)],
                               cr[i // v: -(-(i + rps) // v)], h, v) for i in range(0, H, rps)])
    code = {8: zlib.compress, 5: tiff_lzw, 1: lambda r: r}[compression]
    return tiff_bytes(np.zeros((H, W, 3)), 8, 6, compression=compression, rows_per_strip=rps,
                      codec=lambda r: code(next(strips)), tags=[(530, 3, [h, v])] + list(tags))


def old_jpeg_tiff(rgb, subsampling=2, tags=()) -> bytes:
    """An old-style JPEG TIFF (compression 6): the JPEG file as the strip,
    named again by JPEGInterchangeFormat (513) and its length (514)."""
    jpg = save(Image.fromarray(rgb), "JPEG", quality=90, subsampling=subsampling)
    off = tiff_bytes(rgb, 8, 6, compression=6, codec=lambda r: jpg, tags=tags).index(jpg)
    return tiff_bytes(rgb, 8, 6, compression=6, codec=lambda r: jpg,
                      tags=[(513, 4, [off]), (514, 4, [len(jpg)])] + list(tags))


def special_floats(h, w, seed):
    f = (np.random.RandomState(seed).randn(h, w, 1) * 150 + 100).astype(np.float32)
    f[0, :8, 0] = [np.nan, np.inf, -np.inf, 254.99, 255.0, 0.5, -0.0, 1e-40]
    return f


def signed(h, w, bits, seed):
    rng = np.random.RandomState(seed)
    v = rng.randint(-(1 << (bits - 1)), 1 << (bits - 1), (h, w, 1), dtype=np.int64)
    v[1::2] = rng.randint(-50, 300, (len(v[1::2]), w, 1))  # rows inside and around 0..255
    return v


def tiff_fixtures():
    rgb = scene(37, 45, seed=41)
    img = Image.fromarray(rgb)
    rng = np.random.RandomState(42)
    r16 = rgb.astype(np.int64) * 257 + rng.randint(0, 256, rgb.shape)
    r16_cmyk = scene(37, 45, c=4, seed=48, depth=16)
    return {
        "tiff_strips.tif": tiff_bytes(rgb, 8, 2, rows_per_strip=8),
        "tiff_packbits.tif": save(img, "TIFF", compression="packbits"),
        "tiff_lzw.tif": save(img, "TIFF", compression="tiff_lzw"),
        "tiff_deflate.tif": save(img, "TIFF", compression="tiff_adobe_deflate"),
        "tiff_jpeg.tif": save(img, "TIFF", compression="jpeg"),
        "tiff_jpeg_cmyk.tif": save(Image.fromarray(scene(21, 30, c=4, seed=50), "CMYK"),
                                   "TIFF", compression="jpeg"),
        "tiff_jpeg_la.tif": save(img.convert("LA"), "TIFF", compression="jpeg"),
        "tiff_tiles_lzw.tif": tiff_bytes(rgb, 8, 2, compression=5, tile=(16, 16)),
        "tiff_planar2.tif": tiff_bytes(rgb, 8, 2, compression=32773, planar=2,
                                       rows_per_strip=10),
        "tiff_predictor2_lzw.tif": tiff_bytes(rgb, 8, 2, compression=5, predictor=2,
                                              rows_per_strip=16),
        "tiff_rgb16_mm_predictor2.tif": tiff_bytes(r16, 16, 2, compression=8, predictor=2,
                                                   bo=">"),
        "tiff_gray1_miniswhite.tif": tiff_bytes(rng.randint(0, 2, (37, 45, 1)), 1, 0),
        "tiff_gray4_fill2.tif": tiff_bytes(rng.randint(0, 16, (37, 45, 1)), 4, 0, fill=2,
                                           compression=5),
        "tiff_gray8.tif": save(img.convert("L"), "TIFF"),
        "tiff_gray16.tif": save(Image.fromarray(r16[..., 0].astype(np.uint16) // 97), "TIFF",
                                compression="tiff_lzw"),
        "tiff_palette.tif": save(img.quantize(32), "TIFF", compression="tiff_lzw"),
        "tiff_rgba.tif": save(img.convert("RGBA"), "TIFF", compression="tiff_adobe_deflate"),
        "tiff_rgba16_premultiplied.tif": tiff_bytes(
            np.concatenate([r16 // 2, np.full(rgb.shape[:2] + (1,), 40000)], 2), 16, 2,
            extra=(1,)),
        "tiff_cmyk.tif": save(Image.fromarray(scene(37, 45, c=4, seed=43), "CMYK"), "TIFF",
                              compression="packbits"),
        "tiff_bigtiff.tif": tiff_bytes(rgb, 8, 2, big=True, compression=5, rows_per_strip=8),
        "tiff_lzma.tif": save(img, "TIFF", compression="lzma"),
        "tiff_zstd.tif": save(img, "TIFF", compression="zstd"),
        "tiff_ccitt_rle.tif": save(img.convert("1"), "TIFF", compression="tiff_ccitt"),
        "tiff_group3_2d.tif": save(img.convert("1"), "TIFF", compression="group3",
                                   tiffinfo={292: 1}),
        "tiff_group4.tif": save(img.convert("1"), "TIFF", compression="group4"),
        "tiff_float32_predictor3.tif": tiff_bytes(special_floats(37, 45, 44), 32, 1, fmt=3,
                                                  compression=8, predictor=3),
        "tiff_int16_signed_mm.tif": tiff_bytes(signed(37, 45, 16, 45), 16, 1, fmt=2, bo=">"),
        "tiff_int32_signed.tif": tiff_bytes(signed(37, 45, 32, 46), 32, 1, fmt=2,
                                            compression=5, predictor=2),
        "tiff_cmyk16.tif": tiff_bytes(r16_cmyk, 16, 5, compression=8, bo=">"),
        "tiff_orientation6.tif": tiff_bytes(rgb, 8, 2, compression=5,
                                            tags=[(274, 3, [6])]),
        "tiff_ycbcr_deflate.tif": ycbcr_tiff(37, 45, 2, 2, 49, rows_per_strip=8),
        "tiff_old_jpeg.tif": old_jpeg_tiff(rgb),
        "tiff_thunderscan.tif": tiff_bytes(_nibbles(37, 45, 47)[..., None], 4, 1,
                                           compression=32809,
                                           codec=lambda r: thunderscan(_nibbles(37, 45, 47))),
    }


# ---------------------------------------------------------------------- WebP

def bool_encode(seq) -> bytes:
    """RFC 6386's boolean encoder over (probability, bit) pairs."""
    out = bytearray()
    rng, bottom, count = 255, 0, 24

    def carry():
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, bit in seq:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if count == 0:
                out.append(bottom >> 24)
                bottom &= 0xFFFFFF
                count = 8
    if bottom & (1 << (32 - count)):
        carry()
    v = (bottom << (count & 7)) & 0xFFFFFFFF
    for _ in range(count >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _first_partition_log(vp8: bytes):
    """The (probability, bit) pairs the port's decoder reads from a VP8
    frame's first partition."""
    logs = []

    class Recorder(webp_mod._Bool):
        def __init__(self, data):
            super().__init__(data)
            self.log = []
            logs.append(self)

        def bit(self, prob):
            b = super().bit(prob)
            self.log.append((prob, b))
            return b

    original, webp_mod._Bool = webp_mod._Bool, Recorder
    try:
        webp_mod.decode_vp8(vp8)
    finally:
        webp_mod._Bool = original
    return logs[0].log


def vp8_rewrite(data: bytes, simple=None, sharpness=None, lf_deltas=None) -> bytes:
    """A simple lossy WebP with its frame header's loop-filter fields set:
    the first partition is decoded, the fields' bits replaced (``lf_deltas``
    = (ref frame delta 0, mode delta 0) added where none were sent), and
    the partition encoded again; the token partitions are kept."""
    assert data[12:16] == b"VP8 "
    vp8 = data[20: 20 + struct.unpack_from("<I", data, 16)[0]]
    log = _first_partition_log(vp8)
    bits = [b for _, b in log]
    i = 3
    if bits[2]:  # segmentation: update map, update data, then their fields
        update_map, update_data = bits[3], bits[4]
        i = 5
        if update_data:
            i += 1
            for width in (7,) * 4 + (6,) * 4:
                i += 1 + (width + 1 if bits[i] else 0)
        if update_map:
            for _ in range(3):
                i += 1 + (8 if bits[i] else 0)
    seq = list(log)
    if simple is not None:
        seq[i] = (128, int(simple))
    if sharpness is not None:
        seq[i + 7: i + 10] = [(128, (sharpness >> s) & 1) for s in (2, 1, 0)]
    if lf_deltas is not None:
        assert bits[i + 10] == 0, "the file already sends loop-filter deltas"

        def delta(v):
            return [(128, 1)] + [(128, (abs(v) >> s) & 1) for s in range(5, -1, -1)] + [
                (128, int(v < 0))]

        ref, mode = lf_deltas
        seq[i + 10: i + 11] = ([(128, 1), (128, 1)] + delta(ref) + [(128, 0)] * 3 + delta(mode)
                               + [(128, 0)] * 3)
    part = bool_encode(seq)
    tag = (int.from_bytes(vp8[:3], "little") & 0x1F) | (len(part) << 5)
    old = int.from_bytes(vp8[:3], "little") >> 5
    body = tag.to_bytes(3, "little") + vp8[3:10] + part + vp8[10 + old:]
    body += b"\0" * (len(body) % 2)
    chunk = b"VP8 " + struct.pack("<I", len(body)) + body
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def _webp_anim(frames, **kw) -> bytes:
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=40, **kw)
    return buf.getvalue()


def webp_fixtures():
    img = Image.fromarray(scene(48, 64, seed=51))
    small = Image.fromarray(scene(37, 45, seed=52))
    few = Image.fromarray(_palette(6, 53).astype(np.uint8)[_indices(48, 64, 6, 53)])
    rgba = Image.fromarray(np.concatenate([scene(37, 45, seed=54), scene(37, 45, c=1, seed=55)],
                                          2), "RGBA")
    photo = Image.fromarray(scene(375, 500, seed=56, period=(23.0, 17.0), noise=3.0))
    frames = [Image.fromarray(scene(37, 45, seed=57 + k)) for k in range(3)]
    lossy = save(small, "WEBP", quality=50)
    return {
        "webp_lossless.webp": save(img, "WEBP", lossless=True),
        "webp_lossless_m0.webp": save(img, "WEBP", lossless=True, method=0),
        "webp_lossless_palette.webp": save(few, "WEBP", lossless=True),
        "webp_lossless_alpha.webp": save(rgba, "WEBP", lossless=True, exact=True),
        "webp_lossless_animated.webp": _webp_anim(frames, lossless=True),
        "webp_lossy.webp": lossy,
        "webp_lossy_photo.webp": save(photo, "WEBP", quality=60),
        "webp_lossy_alpha.webp": save(rgba, "WEBP", quality=70),
        "webp_lossy_animated.webp": _webp_anim(frames, quality=60),
        "webp_lossy_simple_filter.webp": vp8_rewrite(lossy, simple=True, sharpness=3),
        "webp_lossy_lf_deltas.webp": vp8_rewrite(lossy, sharpness=6, lf_deltas=(5, -9)),
    }


def container_fixture_bytes():
    """name → bytes of the committed container fixtures (each at most
    64x48 but the photo-sized lossy WebP and ICNS's 128x128 ``it32``), the
    Netpbm, TGA, ICO/CUR/DIB, QOI, SGI, PCX/DCX, Sun, XBM, XPM, PSD, IM,
    MSP, SPIDER, BLP, ICNS, FITS, FTEX, GBR, IMT, McIdas, PIXAR and XV
    thumbnail ones of ``test_torch_image_rasters.py`` to
    ``test_torch_image_rasters4.py`` and the DDS ones of
    ``test_torch_image_dds.py`` too."""
    from test_torch_image_dds import dds_fixture_bytes
    from test_torch_image_rasters import raster_fixture_bytes

    return {**bmp_fixtures(), **gif_fixtures(), **tiff_fixtures(), **webp_fixtures(),
            **raster_fixture_bytes(), **dds_fixture_bytes()}


CONTAINERS = {".bmp": "BMP", ".gif": "GIF", ".tif": "TIFF", ".webp": "WEBP", ".pbm": "PPM",
              ".pgm": "PPM", ".ppm": "PPM", ".pfm": "PPM", ".tga": "TGA", ".ico": "ICO",
              ".cur": "CUR", ".dib": "DIB", ".qoi": "QOI", ".sgi": "SGI", ".pcx": "PCX",
              ".dcx": "DCX", ".ras": "SUN", ".xbm": "XBM", ".xpm": "XPM", ".psd": "PSD",
              ".dds": "DDS", ".im": "IM", ".msp": "MSP", ".spi": "SPIDER", ".blp": "BLP",
              ".icns": "ICNS", ".fits": "FITS", ".ftc": "FTEX", ".ftu": "FTEX", ".gbr": "GBR",
              ".imt": "IMT", ".area": "MCIDAS", ".pxr": "PIXAR", ".xvthumb": "XVThumb"}
FIXTURE_NAMES = sorted(p.name for p in FORMATS.iterdir() if p.suffix in CONTAINERS)


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_container_fixture_equals_pil(name):
    data = (FORMATS / name).read_bytes()
    want = np.load(FORMATS / (Path(name).stem + ".npy"))
    assert Image.open(io.BytesIO(data)).format == CONTAINERS[Path(name).suffix]
    np.testing.assert_array_equal(pil_rgb(data), want)
    got = I.read_image(FORMATS / name)
    assert got.dtype == np.uint8
    assert I.decode_image(data, name)[0] == CONTAINERS[Path(name).suffix]
    np.testing.assert_array_equal(got, want)
    big = want.shape[0] * want.shape[1] > 64 * 48
    assert not big or name in ("webp_lossy_photo.webp", "icns_it32.icns"), want.shape


def test_fixtures_cover_each_kind():
    """The committed fixtures hold what the decoders are asked to read."""
    from mm_s2ut_torch.data import psd, webp

    made = container_fixture_bytes()
    assert sorted(made) == FIXTURE_NAMES
    kinds = set()
    for name in FIXTURE_NAMES:
        data = made[name]
        if data[12:16] == b"VP8L":
            br = webp._Bits(data[21:], name)
            w, h = br.read(14) + 1, br.read(14) + 1
            br.read(4)
            kinds |= {t[0] for t in webp._transforms(br, w, h)[0]}
    assert kinds == {0, 1, 2, 3}  # predictor, colour, subtract green, colour indexing
    tiff = [Image.open(io.BytesIO(made[n])) for n in FIXTURE_NAMES if n.endswith(".tif")]
    assert {im.info["compression"] for im in tiff} == {
        "raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "jpeg", "lzma", "zstd",
        "tiff_ccitt", "group3", "group4", "tiff_thunderscan", "tiff_jpeg"}
    assert {im.tag_v2[262] for im in tiff} >= {0, 1, 2, 3, 5, 6}
    assert {im.mode for im in tiff} >= {"1", "L", "I;16", "P", "RGB", "RGBA", "CMYK", "I", "F"}
    assert any(made[n][:4] == b"II+\0" for n in FIXTURE_NAMES)  # BigTIFF
    assert {im.tag_v2.get(274, 1) for im in tiff} == {1, 6}
    assert {Image.open(io.BytesIO(made[n])).info.get("compression") for n in FIXTURE_NAMES
            if n.endswith(".bmp")} == {0, 1, 2, 3}
    pnm = {made[n].split()[0] for n in FIXTURE_NAMES if Path(n).suffix in (".pbm", ".pgm",
                                                                           ".ppm", ".pfm")}
    assert pnm == {b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf"}
    assert {made[n].split(b"\n")[2] for n in FIXTURE_NAMES if n.endswith(".pgm")} >= {
        b"15", b"255", b"1000"}  # maxvals
    tga = [made[n] for n in FIXTURE_NAMES if n.endswith(".tga")]
    assert {(d[2], d[16]) for d in tga} >= {(1, 8), (2, 16), (2, 24), (3, 1), (9, 8), (10, 32),
                                           (11, 8)}  # (image type, depth)
    assert {d[17] & 0x30 for d in tga} >= {0x00, 0x10, 0x20} and any(d[0] for d in tga)
    assert {Image.open(io.BytesIO(made[n])).mode for n in FIXTURE_NAMES
            if n.endswith(".qoi")} == {"RGB", "RGBA"}
    sgi = [made[n] for n in FIXTURE_NAMES if n.endswith(".sgi")]
    assert {(d[2], d[3], struct.unpack(">H", d[10:12])[0]) for d in sgi} == {
        (0, 1, 3), (0, 2, 1), (1, 1, 4), (1, 2, 3)}  # (RLE, bytes per sample, channels)
    payloads = set()  # PNG, or a bitmap's bits per pixel
    for d in (made[n] for n in FIXTURE_NAMES if n.endswith((".ico", ".cur"))):
        for k in range(struct.unpack_from("<H", d, 4)[0]):
            at = struct.unpack_from("<I", d, 18 + 16 * k)[0]
            payloads.add("PNG" if d[at: at + 4] == b"\x89PNG" else d[at + 14])
    assert payloads == {"PNG", 4, 8, 24, 32}
    pcx = [made[n] for n in FIXTURE_NAMES if n.endswith(".pcx")]
    assert {(d[3], d[65]) for d in pcx} == {(1, 1), (1, 4), (8, 1), (8, 3)}  # (bits, planes)
    assert {Image.open(io.BytesIO(made[n])).mode for n in FIXTURE_NAMES
            if n.endswith((".pcx", ".dcx"))} == {"1", "L", "P", "RGB"}
    sun = [made[n] for n in FIXTURE_NAMES if n.endswith(".ras")]
    assert {struct.unpack(">I", d[12:16])[0] for d in sun} == {1, 8, 24, 32}  # depths
    assert {struct.unpack(">I", d[20:24])[0] for d in sun} == {1, 2, 3}  # types
    assert {Image.open(io.BytesIO(made[n])).mode for n in FIXTURE_NAMES
            if n.endswith(".psd")} == {"1", "L", "P", "RGB", "CMYK"}
    assert {psd._open(made[n], n)[6] for n in FIXTURE_NAMES if n.endswith(".psd")} == {0, 1}


@pytest.mark.parametrize("case", ["555", "565", "555_bitfields", "565_v5"])
def test_bmp_16_bit_every_value_equals_pil(case, tmp_path):
    v = np.arange(65536).reshape(256, 256)
    masks = (0xF800, 0x7E0, 0x1F, 0) if "565" in case else (0x7C00, 0x3E0, 0x1F, 0)
    data = bmp_bytes(v, 16, compression=0 if case == "555" else 3,
                     header=124 if case.endswith("v5") else 40,
                     masks=None if case == "555" else masks)
    assert_equals_pil(data, tmp_path, f"{case}.bmp")


@pytest.mark.parametrize("masks", [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                                   (0xFF000000, 0xFF00, 0xFF, 0),
                                   (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                                   (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                   (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)])
def test_bmp_32_bit_layouts_equal_pil(masks, tmp_path):
    px = np.random.RandomState(6).randint(0, 256, (9, 11, 4))
    assert_equals_pil(bmp_bytes(px, 32, compression=3, header=108, masks=masks), tmp_path,
                      "x.bmp")


@pytest.mark.parametrize("bits,header,top_down", [(1, 40, True), (4, 12, False), (8, 56, True),
                                                  (24, 64, False), (24, 12, False)])
def test_bmp_headers_and_row_orders_equal_pil(bits, header, top_down, tmp_path):
    px = (_indices(13, 19, 1 << min(bits, 8), 7) if bits <= 8
          else scene(13, 19, seed=8)[..., ::-1])
    pal = _palette(1 << bits, 9) if bits <= 8 else None
    assert_equals_pil(bmp_bytes(px, bits, palette=pal, header=header, top_down=top_down),
                      tmp_path, "x.bmp")


@pytest.mark.parametrize("four", [False, True])
@pytest.mark.parametrize("h,w", [(13, 19), (8, 7), (1, 30)])
def test_bmp_rle_equals_pil(four, h, w, tmp_path):
    n = 16 if four else 200
    idx = _indices(h, w, n, h + w)
    data = bmp_bytes(np.zeros((h, w)), 4 if four else 8, palette=_palette(n, 3),
                     compression=2 if four else 1, data=(rle4 if four else rle8)(idx))
    assert_equals_pil(data, tmp_path, "x.bmp")


@pytest.mark.parametrize("kw", [dict(min_size=2), dict(min_size=8, clear=False),
                                dict(min_size=8, interlace=True, transparency=255)])
def test_gif_lzw_and_layouts_equal_pil(kw, tmp_path):
    """Code sizes from 3 bits, a table kept full past 4095 codes (a
    deferred clear), interlaced rows of a tall frame."""
    n = 4 if kw["min_size"] == 2 else 256
    idx = (np.arange(512 * 64) * 7919 % 251 % n).astype(np.uint8).reshape(512, 64)
    idx ^= np.random.RandomState(9).randint(0, 2, idx.shape).astype(np.uint8) & (n - 1)
    data = gif_bytes((64, 512), idx, global_pal=_palette(256, 10), **kw)
    assert_equals_pil(data, tmp_path, "x.gif")


TIFF_CASES = {
    "tiles_deflate_mm": dict(bps=8, photo=2, compression=8, tile=(16, 32), bo=">"),
    "planar2_tiles_lzw": dict(bps=8, photo=2, compression=5, planar=2, tile=(16, 16)),
    "planar2_predictor16": dict(bps=16, photo=2, compression=8, planar=2, predictor=2),
    "rgba16_mm": dict(bps=16, photo=2, bo=">", extra=(2,)),
    "rgba8_premultiplied": dict(bps=8, photo=2, extra=(1,)),
    "rgbx": dict(bps=8, photo=2, extra=(0,)),
    "gray2": dict(bps=2, photo=1),
    "gray1_fill2_lzw": dict(bps=1, photo=1, fill=2, compression=5),
    "gray8_miniswhite_deflate": dict(bps=8, photo=0, compression=8),
    "gray16_mm": dict(bps=16, photo=1, bo=">"),
    "gray16_miniswhite": dict(bps=16, photo=0),
    "gray_alpha": dict(bps=8, photo=1, extra=(2,)),
    "palette4": dict(bps=4, photo=3),
    "palette8_tiles": dict(bps=8, photo=3, tile=(16, 16), compression=5),
    "cmyk_tiles": dict(bps=8, photo=5, tile=(32, 16), compression=8),
    "cmyk_planar2": dict(bps=8, photo=5, planar=2),
    "signed8": dict(bps=8, photo=1, fmt=2),
}


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_layouts_equal_pil(case, tmp_path):
    kw = dict(TIFF_CASES[case])
    bps, photo = kw.pop("bps"), kw.pop("photo")
    rng = np.random.RandomState(len(case))
    spp = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4}[photo] + len(kw.get("extra", ()))
    samples = rng.randint(0, 1 << bps, (37, 45, spp))
    if photo == 2 and bps == 8:
        samples[..., :3] = scene(37, 45, seed=11)
        if kw.get("extra") == (1,):  # premultiplied colours never pass their alpha
            samples[..., :3] = samples[..., :3] * samples[..., 3:] // 255
    if photo == 3:
        kw["colormap"] = rng.randint(0, 65536, (3, 1 << bps))
    assert_equals_pil(tiff_bytes(samples, bps, photo, **kw), tmp_path, "x.tif")


SAMPLE_FORMATS = {"float32": (special_floats, 32, 3), "int16": (lambda h, w, s: signed(h, w, 16, s),
                                                                16, 2),
                  "int32": (lambda h, w, s: signed(h, w, 32, s), 32, 2),
                  "uint32": (lambda h, w, s: signed(h, w, 32, s) & 0xFFFFFFFF, 32, 1)}


CODINGS = [(1, 1), (8, 1), (5, 2), (34925, 1), (32773, 1), (1, 2)]


@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("kind,compression,predictor",
                         [(k, c, p) for k in sorted(SAMPLE_FORMATS) for c, p in CODINGS]
                         + [("float32", 8, 3), ("float32", 34925, 3)])
def test_tiff_sample_formats_equal_pil(kind, compression, predictor, bo, tmp_path):
    """Pillow's F and I modes: clipped to 0..255 (F truncated, NaN 0); a
    compressed big-endian file's samples come out byte-swapped (libtiff's
    native order unpacked as big-endian); Pillow ignores the predictor of
    an uncompressed file; big-endian unsigned 32-bit gray is refused."""
    make, bps, fmt = SAMPLE_FORMATS[kind]
    data = tiff_bytes(make(16, 24, bps + compression), bps, 1, fmt=fmt, bo=bo,
                      compression=compression, predictor=predictor, rows_per_strip=5)
    if kind == "uint32" and bo == ">":
        assert pil_refuses(data)
        with pytest.raises(ValueError, match="BitsPerSample"):
            I.read_image(_written(tmp_path, "x.tif", data))
        return
    assert_equals_pil(data, tmp_path, "x.tif")


def _written(tmp_path, name, data):
    (tmp_path / name).write_bytes(data)
    return tmp_path / name


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientations_equal_pil(orientation, tmp_path):
    """Pillow applies every Orientation (exif_transpose); 5-8 swap the sides."""
    rgb = scene(13, 19, seed=orientation)
    for tile in (None, (16, 16)):
        data = tiff_bytes(rgb, 8, 2, compression=8, tile=tile, tags=[(274, 3, [orientation])])
        assert_equals_pil(data, tmp_path, "x.tif")


@pytest.mark.parametrize("layout", ["strips", "tiles_planar2", "gray16_lzma"])
def test_bigtiff_equals_pil(layout, tmp_path):
    """Little-endian BigTIFF (Pillow reads no other): 8-byte counts and
    offsets, 20-byte entries, values of up to 8 bytes inline."""
    rgb = scene(21, 35, seed=30)
    data = {"strips": lambda: tiff_bytes(rgb, 8, 2, big=True, compression=5, rows_per_strip=4),
            "tiles_planar2": lambda: tiff_bytes(rgb, 8, 2, big=True, compression=8,
                                                tile=(16, 16), planar=2),
            "gray16_lzma": lambda: tiff_bytes(rgb[..., :1].astype(np.int64) * 3, 16, 1,
                                              big=True, compression=34925)}[layout]()
    assert data[:4] == b"II+\0"
    assert_equals_pil(data, tmp_path, "x.tif")


CCITT = [("tiff_ccitt", {}), ("group3", {}), ("group3", {"tiffinfo": {292: 1}}),
         ("group3", {"tiffinfo": {292: 5}}), ("group4", {}), ("group4", {"tiffinfo": {266: 2}}),
         ("group3", {"tiffinfo": {262: 0}}), ("group4", {"tiffinfo": {262: 0, 266: 2}})]


@pytest.mark.parametrize("case", range(len(CCITT)))
@pytest.mark.parametrize("h,w", [(37, 45), (12, 3000), (9, 1)])
def test_tiff_ccitt_equals_pil(case, h, w, tmp_path):
    """CCITT RLE, Group 3 1D and 2D (with fill bits to byte-align EOLs),
    Group 4, fill order 2 and MinIsWhite, as libtiff writes them; a row 3000
    wide takes the make-up codes of both colours and the extended ones."""
    comp, kw = CCITT[case]
    bw = scene(h, w, seed=case)[..., 0] > 128
    bw ^= np.random.RandomState(h).rand(h, w) < 0.05
    if w == 3000:
        bw[3, 5:2900], bw[4], bw[5] = True, False, True
        bw[6, 1800:] = False
    data = save(Image.fromarray(bw), "TIFF", compression=comp, **kw)
    assert Image.open(io.BytesIO(data)).info["compression"] == comp
    assert_equals_pil(data, tmp_path, "x.tif")


@pytest.mark.parametrize("content", ["text", "letters", "mixed"])
def test_tiff_zstd_and_lzma_equal_pil(content, tmp_path):
    """Larger strips than the fixtures: ZSTD frames of several blocks with
    raw, RLE, Huffman and treeless literals, one and four streams, and
    predefined, FSE and repeated sequence tables; LZMA over the same."""
    rng = np.random.RandomState(31)
    text = np.frombuffer((Path(__file__).read_bytes() * 8)[:120000], np.uint8).reshape(-1, 600)
    letters = rng.choice(np.arange(97, 105), (200, 600),
                         p=[0.3, 0.2, 0.15, 0.1, 0.1, 0.05, 0.05, 0.05]).astype(np.uint8)
    mixed = np.concatenate([text[:40], np.zeros((20, 600)), rng.randint(0, 256, (20, 600)),
                            np.full((10, 600), 7)]).astype(np.uint8)
    img = Image.fromarray({"text": text, "letters": letters, "mixed": mixed}[content], "L")
    for comp in ("zstd", "lzma"):
        assert_equals_pil(save(img, "TIFF", compression=comp, strip_size=1 << 22), tmp_path,
                          "x.tif")


@pytest.mark.parametrize("h,w", [(9, 16), (7, 13), (5, 1), (6, 64)])
@pytest.mark.parametrize("photo", [0, 1])
def test_tiff_thunderscan_equals_pil(h, w, photo, tmp_path):
    """libtiff decodes ThunderScan (it cannot encode it): rows of 4-bit
    pixels written by :func:`thunderscan`."""
    px = _nibbles(h, w, h * w)
    strips = iter([thunderscan(px[i: i + 3], seed=i) for i in range(0, h, 3)])
    data = tiff_bytes(px[..., None], 4, photo, compression=32809, rows_per_strip=3,
                      codec=lambda r: next(strips))
    want = (px * 17).astype(np.uint8)
    np.testing.assert_array_equal(pil_rgb(data)[..., 0], want if photo else 255 - want)
    assert_equals_pil(data, tmp_path, "x.tif")


@pytest.mark.parametrize("kw", [dict(lossless=True, method=6, quality=100),
                                dict(lossless=True, method=2), dict(quality=5),
                                dict(quality=95, method=6), dict(quality=30, method=0)])
def test_webp_encodings_equal_pil(kw, tmp_path):
    img = Image.fromarray(scene(61, 83, seed=12, noise=12))
    assert_equals_pil(save(img, "WEBP", **kw), tmp_path, "x.webp")


@pytest.mark.parametrize("kw", [dict(simple=True), dict(sharpness=7),
                                dict(simple=True, sharpness=2, lf_deltas=(-20, 30)),
                                dict(lf_deltas=(63, 63))])
def test_vp8_loop_filter_settings_equal_pil(kw, tmp_path):
    """libwebp's encoder writes the normal filter without sharpness or
    deltas; the rewritten first partition sets them (Pillow decodes it)."""
    data = save(Image.fromarray(scene(64, 80, seed=13, noise=25)), "WEBP", quality=40)
    assert_equals_pil(vp8_rewrite(data, **kw), tmp_path, "x.webp")


def test_webp_colours_do_not_depend_on_alpha(tmp_path):
    """libwebp's RGBA output is not premultiplied: a lossless file's
    colours with varying alpha equal the same colours fully opaque."""
    rgb = scene(24, 32, seed=14)
    alpha = np.random.RandomState(15).randint(0, 256, (24, 32, 1)).astype(np.uint8)
    with_alpha = save(Image.fromarray(np.concatenate([rgb, alpha], 2), "RGBA"), "WEBP",
                      lossless=True, exact=True)
    assert_equals_pil(with_alpha, tmp_path, "a.webp")
    np.testing.assert_array_equal(pil_rgb(with_alpha), rgb)
    np.testing.assert_array_equal(I.read_image(tmp_path / "a.webp"), rgb)


def _cut(data: bytes, keep: float) -> bytes:
    return data[: int(len(data) * keep)]


def tif_bad_deflate(rgb) -> bytes:
    """A Deflate TIFF whose strip is not a zlib stream."""
    data = bytearray(tiff_bytes(rgb, 8, 2, compression=8))
    data[8: 8 + 16] = bytes(range(16))
    return bytes(data)


def _strip(data: bytes) -> bytes:
    """The first strip of a TIFF Pillow wrote."""
    im = Image.open(io.BytesIO(data))
    return data[im.tag_v2[273][0]: im.tag_v2[273][0] + im.tag_v2[279][0]]


def _refusals():
    rgb = scene(20, 24, seed=16)
    gif = gif_bytes((24, 20), _indices(20, 24, 256, 17), global_pal=_palette(256, 17))
    lossless = save(Image.fromarray(rgb), "WEBP", lossless=True)
    lossy = save(Image.fromarray(rgb), "WEBP", quality=60)
    tif = tiff_bytes(rgb, 8, 2)
    return {
        "bmp_bitfields_444.bmp": bmp_bytes(np.zeros((4, 4)), 16, compression=3,
                                           masks=(0xF00, 0xF0, 0xF)),
        "bmp_2bit.bmp": bmp_bytes(np.zeros((4, 4)), 2, palette=_palette(4, 1)),
        "bmp_jpeg.bmp": bmp_bytes(np.zeros((4, 4)), 24, compression=4, data=b"\xff\xd8"),
        "bmp_rle_short.bmp": bmp_bytes(np.zeros((6, 6)), 8, palette=_palette(8, 2),
                                       compression=1, data=bytes([6, 1, 0, 0, 0, 1])),
        "bmp_truncated.bmp": _cut(bmp_bytes(rgb, 24), 0.6),
        "gif_lzw_ends_early.gif": gif[:-40] + b"\0;",
        "gif_no_image.gif": gif[:13 + 768] + b";",
        "tiff_no_width.tif": tif.replace(struct.pack("<HHI", 256, 4, 1),
                                         struct.pack("<HHI", 999, 4, 1)),
        "tiff_bad_deflate.tif": tif_bad_deflate(rgb),
        "tiff_bigtiff_mm.tif": tiff_bytes(rgb, 8, 2, bo=">", big=True),
        "tiff_webp.tif": tiff_bytes(rgb, 8, 2, compression=50001,
                                    codec=lambda r: save(Image.fromarray(rgb), "WEBP")),
        "tiff_float64.tif": tiff_bytes(rgb[..., :1].astype(np.float64), 64, 1, fmt=3,
                                       codec=lambda r: rgb[..., 0].astype("<f8").tobytes()),
        "tiff_ycbcr_uncompressed.tif": ycbcr_tiff(16, 24, 1, 1, 18, compression=1),
        "tiff_zstd_truncated.tif": tiff_bytes(rgb, 8, 2, compression=50000, codec=lambda r: (
            _strip(save(Image.fromarray(rgb), "TIFF", compression="zstd"))[:-40])),
        "webp_lossless_truncated.webp": _cut(lossless, 0.5),
        "webp_lossy_truncated.webp": _cut(lossy, 0.5),
    }


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("name", REFUSALS)
def test_what_pillow_refuses_raises_naming_the_file(name, tmp_path):
    data = _refusals()[name]
    assert pil_refuses(data), "Pillow decodes it: not a refusal"
    (tmp_path / name).write_bytes(data)
    with pytest.raises(ValueError, match=name):
        I.read_image(tmp_path / name)


LEFT_TO_PORT = {
    "cielab.tif": (lambda: tiff_bytes(np.random.RandomState(18).randint(0, 256, (16, 24, 3)), 8,
                                      8), "PhotometricInterpretation 8"),
    "ycbcr_44_odd.tif": (lambda: ycbcr_tiff(16, 12, 4, 4, 18), "YCbCrSubsampling (4, 4)"),
}


@pytest.mark.parametrize("name", sorted(LEFT_TO_PORT))
def test_tiff_kinds_left_to_port_raise_naming_the_tag(name, tmp_path):
    """Pillow reads these; the port raises, naming the file and the tag's
    value (ROADMAP §1 item 12 gives each reason: LittleCMS's Lab → sRGB, and
    libtiff's short read of 4x4 blocks when a row's bytes do not divide by
    4)."""
    make, tag = LEFT_TO_PORT[name]
    data = make()
    assert not pil_refuses(data)
    (tmp_path / name).write_bytes(data)
    with pytest.raises(ValueError, match=f"{re.escape(name)}.*{re.escape(tag)}"):
        I.read_image(tmp_path / name)


ONCE_LEFT = {
    "ccitt_g4.tif": lambda: save(Image.fromarray(
        np.random.RandomState(18).randint(0, 2, (16, 24)).astype(bool)), "TIFF",
        compression="group4", tiffinfo={262: 0}),
    "float32.tif": lambda: tiff_bytes(np.random.RandomState(18).rand(16, 24, 1) * 300, 32, 1,
                                      fmt=3),
    "ycbcr_deflate.tif": lambda: ycbcr_tiff(16, 24, 2, 2, 18),
    "ojpeg.tif": lambda: old_jpeg_tiff(scene(16, 24, seed=18)),
}


@pytest.mark.parametrize("name", sorted(ONCE_LEFT))
def test_tiff_kinds_once_left_to_port_equal_pil(name, tmp_path):
    """Kinds the refusal test above pinned before they were ported: a Group 4
    file (MinIsWhite), float samples, YCbCr in data units (Deflate) and an
    old-style JPEG."""
    assert_equals_pil(ONCE_LEFT[name](), tmp_path, name)


YCBCR = [(h, v, H, W, rps) for h, v in [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]
         for H, W, rps in [(8, 16, 8), (7, 13, 4), (16, 8, 4)]
         if not ((h, v) == (4, 4) and -(-W // 4) % 2)]


@pytest.mark.parametrize("tags", ["default", "reference_black_white", "coefficients"])
@pytest.mark.parametrize("h,v,H,W,rps", YCBCR)
def test_tiff_ycbcr_equals_pil(h, v, H, W, rps, tags, tmp_path):
    """YCbCr without JPEG as libtiff's TIFFRGBAImage converts it: every
    subsampling it takes, partial blocks, several strips, a CCIR
    ReferenceBlackWhite and Rec. 709 YCbCrCoefficients (RATIONAL tags)."""
    extra = {"default": [], "reference_black_white": [
        (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])],
        "coefficients": [(529, 5, [2126, 10000, 7152, 10000, 722, 10000])]}[tags]
    data = ycbcr_tiff(H, W, h, v, H * W + h, rows_per_strip=rps, tags=extra,
                      compression=5 if h == v else 8)
    assert_equals_pil(data, tmp_path, "x.tif")


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("tag", [None, (1, 1), (2, 2)])
def test_tiff_old_jpeg_equals_pil(subsampling, tag, tmp_path):
    """Old-style JPEG 4:4:4, 4:2:2 and 4:2:0 (the JPEG's sampling overrides
    YCbCrSubsampling, as libtiff's OJPEG makes it): libjpeg's raw components,
    each chroma sample replicated over its block, libtiff's conversion."""
    tags = [] if tag is None else [(530, 3, list(tag))]
    assert_equals_pil(old_jpeg_tiff(scene(21, 30, seed=subsampling), subsampling, tags),
                      tmp_path, "x.tif")


def test_raw_image_store_equals_jax_over_every_container(tmp_path):
    """JAX's ``RawImageStore`` (Pillow) and the port's over one directory
    holding one fixture of each container: equal (S, S, 3) pixels."""
    from mm_s2ut.data.image_store import RawImageStore as JStore
    from mm_s2ut_torch.data.image_store import RawImageStore

    names = ["bmp_rle8.bmp", "gif_offset_transparent.gif", "tiff_jpeg.tif",
             "webp_lossless.webp", "webp_lossy.webp", "netpbm_p5_maxval1000.pgm",
             "netpbm_pf.pfm", "tga_palette16_rle.tga", "ico_bmp4_bmp8.ico", "cur_bmp24.cur",
             "dib_rgb.dib", "qoi_rgba.qoi", "sgi_rgb16_rle.sgi", "pcx_4planes.pcx",
             "dcx_two_frames.dcx", "sun_rgb_rle.ras", "xbm_hotspot.xbm", "xpm_2cpp.xpm",
             "psd_rgb_packbits.psd", "tiff_jpeg_cmyk.tif", "tiff_jpeg_la.tif", "dds_dxt1.dds",
             "dds_bc7.dds", "dds_r5g6b5.dds", "im_ycbcr.im", "msp_v2_rle.msp",
             "spider_big_endian.spi", "blp2_dxt5.blp", "blp1_jpeg.blp", "icns_it32.icns",
             "fits_gzip_16.fits", "fits_f64.fits", "ftex_dxt1.ftc", "gbr_v2_rgba.gbr",
             "imt_gray.imt", "mcidas_32.area", "pixar_rgb.pxr", "xvthumb_comments.xvthumb"]
    for n in names:
        (tmp_path / n).write_bytes((FORMATS / n).read_bytes())
    for mode, size in (("vit_timm", 32), ("vit_openai", 48)):
        want, got = JStore(str(tmp_path), names, mode, size), RawImageStore(str(tmp_path), names,
                                                                            mode, size)
        for i in range(len(names)):
            (wp, wx, _), (gp, gx, _) = want[i], got[i]
            assert gp == wp and gx.shape == (size, size, 3)
            np.testing.assert_array_equal(gx, wx, err_msg=names[i])


def test_decoders_import_no_pillow():
    """``data/bmp.py``, ``gif.py``, ``tiff.py``, ``webp.py``, ``ccitt.py``,
    ``zstd.py``, ``netpbm.py``, ``tga.py``, ``ico.py``, ``qoi.py``,
    ``sgi.py``, ``pcx.py``, ``sun.py``, ``xbm.py``, ``xpm.py``, ``psd.py``,
    ``dds.py``, ``im.py``, ``msp.py``, ``spider.py``, ``blp.py``, ``icns.py``,
    ``fits.py``, ``ftex.py``, ``gbr.py``, ``imt.py``, ``mcidas.py``,
    ``pixar.py`` and ``xvthumb.py`` import numpy, the standard library's
    ``zlib``, ``gzip``, ``lzma``, ``bisect``, ``math``, ``io`` and ``re``,
    and the port only."""
    import ast
    import importlib

    for mod in ("bmp", "gif", "tiff", "webp", "ccitt", "zstd", "netpbm", "tga", "ico", "qoi",
                "sgi", "pcx", "sun", "xbm", "xpm", "psd", "dds", "im", "msp", "spider", "blp",
                "icns", "fits", "ftex", "gbr", "imt", "mcidas", "pixar", "xvthumb"):
        path = Path(importlib.import_module(f"mm_s2ut_torch.data.{mod}").__file__)
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, (ast.Import, ast.ImportFrom))
                 for a in (n.names if isinstance(n, ast.Import) else [ast.alias(n.module or "")])}
        assert names <= {"__future__", "struct", "zlib", "gzip", "lzma", "bisect", "math",
                         "typing", "io", "re", "numpy", "mm_s2ut_torch"}, \
            (mod, names)
