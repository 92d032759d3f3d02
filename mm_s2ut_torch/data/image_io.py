"""Images on the host without Pillow: decode, resize, write (numpy only).

What the JAX package asks of PIL (``mm_s2ut/models/vit.py:141-194``,
``mm_s2ut/cli/vit_rollout.py``), for a machine that has no Pillow:

* :func:`read_image` — a file → ``(H, W, 3)`` uint8, equal to
  ``np.asarray(Image.open(path).convert("RGB"))`` for every PNG, JPEG,
  BMP, DIB, GIF, TIFF, WebP, Netpbm, TGA, ICO, CUR, QOI, SGI, PCX, DCX,
  DDS, Sun raster, XBM, XPM, PSD, IM, MSP, SPIDER, BLP, ICNS, FITS, FTEX,
  GBR, IMT, McIdas, PIXAR and XV thumbnail file Pillow opens, and
  ``ValueError`` naming the file for those it refuses.
  :func:`decode_image` picks the container as ``Image.open`` does:
  Pillow's plugins in its order (the six it loads first, then the rest as
  ``Image.ID`` lists them), each behind its test of the first 16 bytes,
  IM, IMT, SPIDER and TGA (which have none) in their places, and a file
  whose header a plugin's open rejects passed on to the next (an RGB TGA
  starts with CUR's magic; a Sun raster 1 pixel wide may pass Pillow's
  GIMP-brush test, and that plugin takes it, then fails to load it). It
  reads ``.npy`` pixels ((H, W, 3) or (H, W) uint8);
  PNG in every colour type and bit depth, Adam7-interlaced or not (gray
  of 1/2/4 bits scaled as Pillow's ``1``/``L;2``/``L;4``, 16-bit gray
  clamped to 255 as Pillow's ``I;16`` converts, the other 16-bit types'
  high bytes, alpha dropped as
  ``convert("RGB")`` drops it; the CRCs of the chunks before the image
  data checked, the Adler-32 only where the stream ends with the image,
  as Pillow reads them); JPEG through ``data/jpeg.py``: Huffman,
  arithmetic, progressive and lossless frames, block smoothing, every
  integral sampling ratio, CMYK and YCCK, all in libjpeg-turbo's integer
  arithmetic; BMP and DIB through ``data/bmp.py``, GIF (the first frame)
  through ``data/gif.py``, TIFF (the first page) through ``data/tiff.py``,
  WebP, lossless and lossy, through ``data/webp.py``, Netpbm (P1-P6,
  ``Pf``) through ``data/netpbm.py``, TGA through ``data/tga.py``, ICO and
  CUR through ``data/ico.py``, QOI through ``data/qoi.py``, SGI through
  ``data/sgi.py``, PCX and DCX through ``data/pcx.py``, DDS through
  ``data/dds.py``, Sun raster through
  ``data/sun.py``, XBM through ``data/xbm.py``, XPM through
  ``data/xpm.py``, PSD through ``data/psd.py``, IM through ``data/im.py``,
  MSP through ``data/msp.py``, SPIDER through ``data/spider.py``, BLP
  through ``data/blp.py``, ICNS through ``data/icns.py``, FITS through
  ``data/fits.py``, FTEX through ``data/ftex.py``, GBR through
  ``data/gbr.py``, IMT through ``data/imt.py``, McIdas through
  ``data/mcidas.py``, PIXAR through ``data/pixar.py`` and XV thumbnails
  through ``data/xvthumb.py``; each module's docstring says what it reads.
* :func:`resize` — Pillow's ``Image.resize`` for ``BICUBIC`` and
  ``BILINEAR`` on 8-bit images (``Resample.c``): a separable filter
  whose support widens with the downscale factor, coefficients
  normalised per output pixel and turned into fixed point (22 fraction
  bits), a horizontal pass then a vertical one, each rounded and clipped
  to uint8; a dimension that keeps its size is not resampled.
* :func:`write_png` — an 8-bit gray or RGB PNG (zlib, filter 0).

The resize is vectorised over whole images.
"""
from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from mm_s2ut_torch.data import Unidentified
from mm_s2ut_torch.data.blp import decode_blp
from mm_s2ut_torch.data.bmp import decode_bmp, decode_dib
from mm_s2ut_torch.data.dds import decode_dds
from mm_s2ut_torch.data.fits import decode_fits
from mm_s2ut_torch.data.ftex import decode_ftex
from mm_s2ut_torch.data.gbr import decode_gbr
from mm_s2ut_torch.data.gif import decode_gif
from mm_s2ut_torch.data.icns import decode_icns
from mm_s2ut_torch.data.ico import decode_cur, decode_ico
from mm_s2ut_torch.data.im import decode_im
from mm_s2ut_torch.data.imt import decode_imt
from mm_s2ut_torch.data.jpeg import decode_jpeg
from mm_s2ut_torch.data.mcidas import decode_mcidas
from mm_s2ut_torch.data.msp import decode_msp
from mm_s2ut_torch.data.netpbm import decode_netpbm
from mm_s2ut_torch.data.pcx import decode_dcx, decode_pcx
from mm_s2ut_torch.data.pixar import decode_pixar
from mm_s2ut_torch.data.psd import decode_psd
from mm_s2ut_torch.data.qoi import decode_qoi
from mm_s2ut_torch.data.sgi import decode_sgi
from mm_s2ut_torch.data.spider import decode_spider
from mm_s2ut_torch.data.sun import decode_sun
from mm_s2ut_torch.data.tga import decode_tga
from mm_s2ut_torch.data.tiff import decode_tiff
from mm_s2ut_torch.data.webp import decode_webp
from mm_s2ut_torch.data.xbm import decode_xbm
from mm_s2ut_torch.data.xpm import decode_xpm
from mm_s2ut_torch.data.xvthumb import decode_xvthumb


def read_image(path: str | Path) -> np.ndarray:
    """``(H, W, 3)`` uint8 RGB pixels of a ``.npy`` file (by its first bytes
    or its suffix) or of any container :func:`decode_image` reads: PNG,
    JPEG, BMP, DIB, GIF, TIFF, WebP, Netpbm, TGA, ICO, CUR, QOI, SGI, PCX,
    DCX, DDS, Sun raster, XBM, XPM, PSD, IM, MSP, SPIDER, BLP, ICNS, FITS,
    FTEX, GBR, IMT, McIdas, PIXAR, XV thumbnail."""
    path = Path(path)
    data = path.read_bytes()
    name = str(path)
    if data[:6] == b"\x93NUMPY" or path.suffix == ".npy":
        arr = np.load(path)
        if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
            raise ValueError(f"{name}: expected (H, W, 3) or (H, W) uint8 pixels, got "
                             f"{arr.dtype} {arr.shape}")
        return _rgb(arr)
    return decode_image(data, name)[1]


# Pillow's plugins in the order Image.open tries them (by their Image.ID keys), each
# with its test of the first 16 bytes (IM, IMT, SPIDER and TGA have none); a decoder
# raising Unidentified passes the file on to the next, as Pillow does where a plugin's
# open raises SyntaxError
_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_CONTAINERS = (
    ("BMP", lambda d: d[:2] == b"BM", decode_bmp),
    ("DIB", lambda d: len(d) >= 4 and struct.unpack_from("<I", d)[0] in _DIB_HEADERS,
     lambda d, n: decode_dib(d, n)[0]),
    ("GIF", lambda d: d[:4] == b"GIF8", decode_gif),
    ("JPEG", lambda d: d[:3] == b"\xff\xd8\xff", decode_jpeg),
    ("PPM", lambda d: d[:1] == b"P" and d[1:2] != b"" and d[1:2] in b"0123456fy",
     decode_netpbm),
    ("PNG", lambda d: d[:8] == b"\x89PNG\r\n\x1a\n", lambda d, n: decode_png(d, n)),
    ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2"), decode_blp),
    ("CUR", lambda d: d[:4] == b"\0\0\2\0", decode_cur),
    ("PCX", lambda d: d[:1] == b"\n" and d[1:2] != b"" and d[1:2] in b"\0\2\3\5", decode_pcx),
    ("DCX", lambda d: d[:4] == b"\xb1\x68\xde\x3a", decode_dcx),
    ("DDS", lambda d: d[:4] == b"DDS ", decode_dds),
    ("FITS", lambda d: d[:6] == b"SIMPLE", decode_fits),
    ("FTEX", lambda d: d[:4] == b"FTEX", decode_ftex),
    ("GBR", lambda d: len(d) >= 8 and struct.unpack_from(">I", d)[0] >= 20
     and struct.unpack_from(">I", d, 4)[0] in (1, 2), decode_gbr),
    ("ICNS", lambda d: d[:4] == b"icns", decode_icns),
    ("ICO", lambda d: d[:4] == b"\0\0\1\0", decode_ico),
    ("IM", lambda d: True, decode_im),
    ("IMT", lambda d: True, decode_imt),
    ("MCIDAS", lambda d: d[:8] == b"\0\0\0\0\0\0\0\4", decode_mcidas),
    ("TIFF", lambda d: d[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"), decode_tiff),
    ("MSP", lambda d: d[:4] in (b"DanM", b"LinS"), decode_msp),
    ("PIXAR", lambda d: d[:4] == b"\x80\xe8\0\0", decode_pixar),
    ("PSD", lambda d: d[:4] == b"8BPS", decode_psd),
    ("QOI", lambda d: d[:4] == b"qoif", decode_qoi),
    ("SGI", lambda d: d[:2] == b"\x01\xda", decode_sgi),
    ("SPIDER", lambda d: True, decode_spider),
    ("SUN", lambda d: d[:4] == b"\x59\xa6\x6a\x95", decode_sun),
    ("TGA", lambda d: True, decode_tga),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP", decode_webp),
    ("XBM", lambda d: d[:16].lstrip().startswith(b"#define"), decode_xbm),
    ("XPM", lambda d: d[:9] == b"/* XPM */", decode_xpm),
    ("XVTHUMB", lambda d: d[:6] == b"P7 332", decode_xvthumb),
)
_FORMATS = {"XVTHUMB": "XVThumb"}  # Pillow's format where it is not its Image.ID key


def decode_image(data: bytes, name: str = "<image>") -> Tuple[str, np.ndarray]:
    """The container Pillow's ``Image.open`` takes the bytes for (its
    ``format``) and ``(H, W, 3)`` uint8 RGB pixels equal to
    ``np.asarray(Image.open(p).convert("RGB"))``."""
    for fmt, accepts, decode in _CONTAINERS:
        if accepts(data):
            try:
                return _FORMATS.get(fmt, fmt), decode(data, name)
            except Unidentified:
                continue
    raise ValueError(f"{name}: not an image the port reads (PNG, JPEG, BMP, DIB, GIF, TIFF, "
                     f"WebP, Netpbm, TGA, ICO, CUR, QOI, SGI, PCX, DCX, DDS, Sun raster, XBM, "
                     f"XPM, PSD, IM, MSP, SPIDER, BLP, ICNS, FITS, FTEX, GBR, IMT, McIdas, "
                     f"PIXAR, XV thumbnail or .npy)")


def _rgb(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.repeat(arr[..., None], 3, axis=2) if arr.ndim == 2 else arr)


# --------------------------------------------------------------------- PNG

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """Undo the five PNG row filters → (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < height * (stride + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    rows = rows[: height * (stride + 1)].reshape(height, stride + 1)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per byte lane, modulo 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = _unfilter_serial(ftype, line.tolist(), prev.tolist(), bpp)
        else:
            raise ValueError(f"{name}: bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_serial(ftype: int, line: List[int], prev: List[int], bpp: int) -> np.ndarray:
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            cur[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))  # (first row, first column, row step, column step) of each pass


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered (h, stride) bytes → (h, width, channels) int64 samples."""
    h = rows.shape[0]
    if depth == 16:
        px = rows[:, : width * channels * 2].reshape(h, -1, 2).astype(np.int64)
        return ((px[..., 0] << 8) | px[..., 1]).reshape(h, width, channels)
    if depth == 8:
        return rows[:, : width * channels].reshape(h, width, channels).astype(np.int64)
    bits = np.unpackbits(rows, axis=1)[:, : width * channels * depth].reshape(h, -1, depth)
    weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.int64)
    return (bits * weights).sum(-1).reshape(h, width, channels)


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """A PNG of any colour type and bit depth, Adam7-interlaced or not → RGB
    uint8 as Pillow's ``convert("RGB")`` gives it."""
    pos, idat = 8, []
    header: Optional[Tuple[int, ...]] = None
    palette = None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc = data[pos + 8 + length: pos + 12 + length]
        pos += 12 + length
        if not idat and ctype != b"IDAT" and (
                len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(ctype + body)):
            # Pillow checks the chunks before the image data; its open fails there
            raise Unidentified(f"{name}: broken PNG file (bad checksum in {ctype!r})")
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: PNG IHDR of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS:
        raise ValueError(f"{name}: bad PNG colour type {color}")
    if depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"{name}: bad PNG bit depth {depth} for colour type {color}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: unknown PNG interlace method {interlace}")
    channels = _PNG_CHANNELS[color]
    stream = b"".join(idat)
    try:
        raw = zlib.decompress(stream)
    except zlib.error as e:
        # Pillow inflates row by row and stops at the image's last byte: it reads
        # the Adler-32 only where the stream ends there too, and a stream cut
        # short after that byte (in its Adler-32, say) still gives the image
        cut = "incomplete or truncated" in str(e)
        try:
            raw = (zlib.decompressobj().decompress(stream) if cut else
                   zlib.decompressobj(-15).decompress(stream[2:]) if "data check" in str(e)
                   else b"")
        except zlib.error:
            raw = b""
        need = sum(-(-(height - y0) // dy) * (1 + (-(-(width - x0) // dx) * channels * depth + 7)
                                                // 8)
                   for y0, x0, dy, dx in (_ADAM7 if interlace else ((0, 0, 1, 1),))
                   if height > y0 and width > x0)
        if len(raw) < need or len(raw) == need and not cut:
            raise ValueError(f"{name}: PNG image data: {e}") from None
    px = np.zeros((height, width, channels), np.int64)
    off = 0
    for y0, x0, dy, dx in _ADAM7 if interlace else ((0, 0, 1, 1),):
        ph, pw = -(-(height - y0) // dy), -(-(width - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue  # an empty pass holds no rows
        stride = (pw * channels * depth + 7) // 8
        rows = _unfilter(raw[off: off + ph * (stride + 1)], ph, stride,
                         max(1, channels * depth // 8), name)
        off += ph * (stride + 1)
        px[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette[:256]
        return full[px[..., 0]]
    if depth == 16:  # I;16 clamps to 255; RGB;16B, RGBA;16B, LA;16B keep the high byte
        px = np.minimum(px, 255) if color == 0 else px >> 8
    elif depth < 8:  # Pillow's 1, L;2, L;4: scaled to 0..255
        px = px * (255 // ((1 << depth) - 1))
    if color in (0, 4):
        return _rgb(px[..., 0].astype(np.uint8))
    return np.ascontiguousarray(px[..., :3].astype(np.uint8))


def write_png(path: str | Path, pixels: np.ndarray) -> None:
    """(H, W) gray or (H, W, 3) RGB uint8 → an 8-bit PNG (filter 0)."""
    px = np.ascontiguousarray(pixels, np.uint8)
    if px.ndim not in (2, 3) or (px.ndim == 3 and px.shape[2] != 3):
        raise ValueError(f"write_png: expected (H, W) or (H, W, 3) uint8, got {px.shape}")
    h, w = px.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if px.ndim == 3 else 0, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                           + chunk(b"IEND", b""))


# ------------------------------------------------------------------ resize

def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}
PRECISION_BITS = 32 - 8 - 2


def _coeffs(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """``Resample.c`` ``precompute_coeffs`` + ``normalize_coeffs_8bpc``
    over the whole input (box 0..in_size): (first input index (out,),
    fixed-point weights (out, ksize) int64, 0 past each pixel's span)."""
    filt, support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)[None, :]
    live = x < xmax[:, None]
    w = np.where(live, filt(((x + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5) * ss),
                 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # the C loop's order of summation
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, np.where(live, fixed, 0)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.where(acc >= (1 << PRECISION_BITS << 8), 255,
                    np.where(acc <= 0, 0, acc >> PRECISION_BITS)).astype(np.uint8)


def _resample_axis(px: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    in_size = px.shape[axis]
    xmin, kk = _coeffs(in_size, out_size, kind)
    src = np.moveaxis(px, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    extra = (1,) * (src.ndim - 1)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)
        acc += src[idx] * kk[:, k].reshape((-1,) + extra)
    return np.moveaxis(_clip8(acc), 0, axis)


def resize(pixels: np.ndarray, size: Tuple[int, int], kind: str = "bicubic") -> np.ndarray:
    """Pillow's ``Image.resize(size, BICUBIC | BILINEAR)`` of an (H, W) or
    (H, W, C) uint8 image; ``size`` is (width, height), as PIL's."""
    if kind not in FILTERS:
        raise ValueError(f"resize: unknown filter {kind!r}")
    width, height = size
    px = np.asarray(pixels, np.uint8)
    if px.shape[1] != width:
        px = _resample_axis(px, width, 1, kind)
    if px.shape[0] != height:
        px = _resample_axis(px, height, 0, kind)
    return np.ascontiguousarray(px)

