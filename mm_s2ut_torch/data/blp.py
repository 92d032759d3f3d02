"""Blizzard Mipmap (BLP) textures without Pillow (numpy only).

:func:`decode_blp` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``BlpImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses. Only the first mipmap, which is what
``Image.open`` shows, and Pillow's rules, where they are not the format's:

* the header: ``BLP1`` (compression, alpha flag, size, encoding, subtype)
  or ``BLP2`` (compression, encoding, alpha flag, alpha encoding, mip
  count, size), then 16 mipmap offsets and 16 lengths. The image is
  ``RGBA`` where the alpha flag is set, else ``RGB``; a header cut short or
  of size 0 passes the file on;
* BLP1 JPEG (compression 0): a shared JPEG header, the bytes up to the
  first mipmap's offset skipped where that lies ahead, then its bytes; that
  JPEG converted to RGB (a 4-component one read as CMYK as stored, Pillow's
  ``jpegmode`` ``CMYK``, so a YCCK one is not converted) and its bytes then
  read as raw ``BGR`` rows of the header's size: red and blue come out
  swapped, and a JPEG of another size shears;
* BLP1 palette (compression 1, encodings 4 and 5) and BLP2 palette
  (compression 1, encoding 1): 256 BGRA entries after the offsets, then one
  index a pixel: BLP1 reads them right after the palette, BLP2 from the
  first offset;
* BLP2 DXT (compression 1, encoding 2), alpha encoding 0, 1 and 7: DXT1,
  DXT3 and DXT5 as Pillow's Python decoders do them: 5:6:5 endpoints
  widened by a shift alone (31 → 248), DXT3 and DXT5 always 4-colour,
  DXT1's 3-colour index 3 black (and transparent where the alpha flag is
  set). Each row of blocks gives 4 rows of whole blocks, ``(w + 3) // 4 *
  4`` pixels wide, of 3 bytes a pixel (DXT1 without alpha) or 4, and the
  stream is then read as rows of ``w`` pixels in the image's mode: a width
  that is not a multiple of 4, or an ``RGB`` DXT3 or DXT5, comes out as
  Pillow lays it out.

A file cut short where the decoder reads is refused (Pillow's ``OSError``
"Truncated BLP file"), and so are the compressions and encodings Pillow
does not read.
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels
from mm_s2ut_torch.data.dds import _bc1, _bc4
from mm_s2ut_torch.data.jpeg import decode_jpeg


def _read(data: bytes, at: int, n: int, name: str) -> bytes:
    """``ImageFile._safe_read``: ``n`` bytes at ``at``, or a refusal."""
    if n <= 0:
        return b""
    if len(data) - at < n:
        raise ValueError(f"{name}: truncated BLP file ({max(0, len(data) - at)} of {n} bytes "
                         f"at {at})")
    return data[at: at + n]


def decode_blp(data: bytes, name: str = "<blp>") -> np.ndarray:
    """A BLP file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2") or len(data) < (24 if magic == b"BLP1" else 20):
        raise Unidentified(f"{name}: not a BLP file")
    compression = struct.unpack_from("<i", data, 4)[0]
    if magic == b"BLP1":
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        encoding = struct.unpack_from("<i", data, 20)[0]
        alpha_encoding, pos = None, 28
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha, pos = alpha != 0, 20
    width, height = struct.unpack_from("<II", data, 12)
    if width == 0 or height == 0:
        raise Unidentified(f"{name}: BLP size {width}x{height}")
    check_pixels(width, height, name)
    bands = 4 if alpha else 3
    offsets = struct.unpack("<16I", _read(data, pos, 64, name))
    lengths = struct.unpack("<16I", _read(data, pos + 64, 64, name))
    pos += 128
    if magic == b"BLP1" and compression == 0:
        size = struct.unpack("<I", _read(data, pos, 4, name))[0]
        header = _read(data, pos + 4, size, name)
        pos += 4 + size
        skip = offsets[0] - pos
        _read(data, pos, skip, name)
        pos += max(skip, 0)
        jpeg = header + _read(data, pos, lengths[0], name)
        if jpeg[:3] != b"\xff\xd8\xff":  # JpegImagePlugin's test
            raise ValueError(f"{name}: BLP1 JPEG data that is not a JPEG")
        rgb = decode_jpeg(jpeg, name, cmyk_as_stored=True)
        bgr = _as_raw(rgb.reshape(-1), width, height, 3, name)  # raw BGR, 3 bytes a pixel
        return np.ascontiguousarray(bgr[..., ::-1])
    if compression != 1:
        raise ValueError(f"{name}: {magic.decode()} compression {compression}, which Pillow does "
                         f"not read")
    if magic == b"BLP1" and encoding not in (4, 5) or magic == b"BLP2" and encoding not in (1, 2):
        raise ValueError(f"{name}: {magic.decode()} encoding {encoding}, which Pillow does not "
                         f"read")
    palette = np.frombuffer(_read(data, pos, 1024, name), np.uint8).reshape(256, 4)
    pos = pos + 1024 if magic == b"BLP1" else offsets[0]
    if encoding != 2:
        idx = np.frombuffer(_read(data, pos, lengths[0], name), np.uint8)
        px = palette[idx][:, [2, 1, 0, 3][:bands]]
        return _as_raw(px.reshape(-1), width, height, bands, name)
    if alpha_encoding not in (0, 1, 7):
        raise ValueError(f"{name}: BLP2 alpha encoding {alpha_encoding}, which Pillow does not "
                         f"read")
    bw, bh = (width + 3) // 4, (height + 3) // 4
    block = 8 if alpha_encoding == 0 else 16
    raw = np.frombuffer(_read(data, pos, bw * bh * block, name), np.uint8).reshape(-1, block)
    rgb = _bc1(raw[:, -8:], four=alpha_encoding != 0, shift_only=True)
    if alpha_encoding == 0:
        b = raw.astype(np.int64)
        c0, c1 = b[:, 0] | b[:, 1] << 8, b[:, 2] | b[:, 3] << 8
        idx = ((b[:, 4] | b[:, 5] << 8 | b[:, 6] << 16 | b[:, 7] << 24)[:, None]
               >> (2 * np.arange(16))) & 3
        a = np.where((idx == 3) & (c0 <= c1)[:, None], 0, 255)
    elif alpha_encoding == 1:
        nib = np.stack([raw[:, :8] & 15, raw[:, :8] >> 4], -1).reshape(-1, 16)
        a = nib.astype(np.int64) * 17
    else:
        a = _bc4(raw[:, :8])
    px = np.concatenate([rgb, a[..., None]], -1) if alpha or alpha_encoding else rgb
    stream = px.reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4).reshape(-1)
    return _as_raw(stream, width, height, bands, name)


def _as_raw(stream: np.ndarray, width: int, height: int, bands: int, name: str) -> np.ndarray:
    """``set_as_raw``: rows of ``width`` pixels of ``bands`` bytes from the
    decoded stream → the first three bands."""
    need = width * height * bands
    if stream.size < need:
        raise ValueError(f"{name}: BLP data gives {stream.size} of {need} bytes: not enough "
                         f"image data")
    px = stream[:need].reshape(height, width, bands)[..., :3]
    return np.ascontiguousarray(px.astype(np.uint8))
