"""Images on the host without Pillow: decode, resize, write (numpy only).

What the JAX package asks of PIL (``mm_s2ut/models/vit.py:141-194``,
``mm_s2ut/cli/vit_rollout.py``), for a machine that has no Pillow:

* :func:`read_image` — a file → ``(H, W, 3)`` uint8, equal to
  ``np.asarray(Image.open(path).convert("RGB"))``. It reads ``.npy``
  pixels ((H, W, 3) or (H, W) uint8), PNG (8-bit gray, gray+alpha, RGB,
  RGBA, palette of 1/2/4/8 bits; non-interlaced; alpha dropped as
  ``convert("RGB")`` drops it) and baseline JPEG (SOF0/SOF1, 8-bit
  Huffman, 1 or 3 components, sampling 4:4:4, 4:2:2 or 4:2:0, restart
  markers). The JPEG steps are libjpeg-turbo's defaults, which Pillow
  decodes through, and all integer arithmetic: the "islow" IDCT
  (``jidctint.c``) with its range limit, fancy (triangular) chroma
  upsampling (``jdsample.c`` ``h2v1``/``h2v2_fancy_upsample``, with
  their alternating rounding bias) and fixed-point YCbCr → RGB
  (``jdcolor.c``, 16 fraction bits). Progressive, arithmetic-coded,
  lossless and 12-bit JPEG, CMYK/YCCK, 16-bit and interlaced PNG raise
  ``ValueError`` naming the file (ROADMAP.md §1 item 8).
* :func:`resize` — Pillow's ``Image.resize`` for ``BICUBIC`` and
  ``BILINEAR`` on 8-bit images (``Resample.c``): a separable filter
  whose support widens with the downscale factor, coefficients
  normalised per output pixel and turned into fixed point (22 fraction
  bits), a horizontal pass then a vertical one, each rounded and clipped
  to uint8; a dimension that keeps its size is not resampled.
* :func:`write_png` — an 8-bit gray or RGB PNG (zlib, filter 0).

The IDCT, the upsampling, the colour conversion and the resize are
vectorised over whole images; the Huffman stage is a Python loop over
the symbols.
"""
from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

UNSUPPORTED = "(not ported: ROADMAP.md §1 item 8)"


def _refuse(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what} is not supported {UNSUPPORTED}")


def read_image(path: str | Path) -> np.ndarray:
    """``(H, W, 3)`` uint8 RGB pixels of a ``.npy``, PNG or baseline JPEG
    file (by its first bytes; ``.npy`` also by its suffix)."""
    path = Path(path)
    data = path.read_bytes()
    name = str(path)
    if data[:6] == b"\x93NUMPY" or path.suffix == ".npy":
        arr = np.load(path)
        if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
            raise ValueError(f"{name}: expected (H, W, 3) or (H, W) uint8 pixels, got "
                             f"{arr.dtype} {arr.shape}")
        return _rgb(arr)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data, name)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, name)
    raise ValueError(f"{name}: not a PNG, JPEG or .npy image")


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


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """A non-interlaced 8-bit PNG (palette also 1, 2 or 4 bits) → RGB uint8."""
    pos, idat = 8, []
    header: Optional[Tuple[int, ...]] = None
    palette = None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
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
    if interlace:
        raise _refuse(name, "an interlaced (Adam7) PNG")
    if color not in _PNG_CHANNELS:
        raise ValueError(f"{name}: bad PNG colour type {color}")
    if depth != 8 and not (color == 3 and depth in (1, 2, 4)):
        raise _refuse(name, f"a {depth}-bit PNG of colour type {color}")
    channels = _PNG_CHANNELS[color]
    stride = (width * channels * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride, max(1, channels * depth // 8),
                     name)
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        if depth < 8:
            bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
            rows = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
                -1, dtype=np.uint8)[:, :width]
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette[:256]
        return full[rows]
    px = rows.reshape(height, width, channels)
    if color in (0, 4):
        return _rgb(px[..., 0])
    return np.ascontiguousarray(px[..., :3])


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


# -------------------------------------------------------------------- JPEG

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])  # zigzag position → natural (row-major) position

_SOF_REFUSED = {
    0xC2: "a progressive JPEG", 0xC3: "a lossless JPEG", 0xC5: "a hierarchical JPEG",
    0xC6: "a hierarchical JPEG", 0xC7: "a hierarchical JPEG", 0xC9: "an arithmetic-coded JPEG",
    0xCA: "a progressive arithmetic-coded JPEG", 0xCB: "a lossless arithmetic-coded JPEG",
    0xCD: "a hierarchical JPEG", 0xCE: "a hierarchical JPEG", 0xCF: "a hierarchical JPEG",
    0xCC: "an arithmetic-coded JPEG",
}


def _huffman_table(counts: Sequence[int], symbols: Sequence[int]) -> List[int]:
    """Canonical Huffman code → a 65536-entry lookup over the next 16 bits:
    ``symbol | length << 8`` (0 where no code starts)."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo: lo + (1 << (16 - length))] = symbols[k] | (length << 8)
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _unstuff(seg: bytes) -> List[int]:
    """Entropy-coded bytes (0xFF00 → 0xFF), then each byte's 24-bit window
    (it and the next two), zero-padded past the end as libjpeg pads."""
    b = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + b"\x00" * 4, np.uint8).astype(np.int64)
    return ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()


def _decode_blocks(win: List[int], units, coefs, preds, name: str) -> None:
    """Huffman-decode one restart interval: ``units`` lists, in order,
    (component, block offset into its coefficient list, DC table, AC
    table); coefficients land in zigzag order."""
    p = 0
    for c, base, dc, ac in units:
        w = (win[p >> 3] >> (8 - (p & 7))) & 0xFFFF
        e = dc[w]
        if not e:
            raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
        p += e >> 8
        s = e & 0xFF
        diff = 0
        if s:
            diff = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
            p += s
            if diff < (1 << (s - 1)):
                diff -= (1 << s) - 1
        preds[c] += diff
        out = coefs[c]
        out[base] = preds[c]
        k = 1
        while k < 64:
            w = (win[p >> 3] >> (8 - (p & 7))) & 0xFFFF
            e = ac[w]
            if not e:
                raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
            p += e >> 8
            rs = e & 0xFF
            s = rs & 15
            if s:
                k += rs >> 4
                v = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                if k < 64:
                    out[base + k] = v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


# jidctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x · 2^13).
_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
      "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
      "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(c: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of ``jpeg_idct_islow`` over 8 int64 vectors (the inputs at
    positions 0..7), descaled by ``shift`` bits with rounding."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 + z3 * -_F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return [(o + half) >> shift for o in out]


def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by (value & 1023) for a value
    centred on 0: +128 and clamped for |value| < 512, wrapping beyond."""
    idx = np.arange(1024)
    table = np.zeros(1024, np.int64)
    table[:128] = idx[:128] + 128
    table[128:512] = 255
    table[896:] = idx[896:] - 896
    return table


_RANGE = _range_limit()


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients, (64,) quantization table →
    (N, 8, 8) uint8 samples, as libjpeg-turbo's ``jpeg_idct_islow``."""
    d = coefs.astype(np.int64) * quant.astype(np.int64)[None]
    d = d.reshape(-1, 8, 8)
    # Pass 1: columns (input row k of each column), descale to PASS1_BITS.
    cols = _idct_1d([d[:, k, :] for k in range(8)], 13 - 2)
    ws = np.stack(cols, axis=1)  # (N, 8 rows, 8 cols)
    # Pass 2: rows, descale by CONST_BITS + PASS1_BITS + 3.
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3)
    out = np.stack(rows, axis=2)
    return _RANGE[out & 1023].astype(np.uint8)


def _fancy_h(x: np.ndarray, width: int, bias_even: int, bias_odd: int, scale: int,
             shift: int) -> np.ndarray:
    """The horizontal half of libjpeg's fancy upsampling over the first
    ``width`` columns of ``x`` (int64 rows): output 2j = (scale·x[j] +
    x[j-1] + bias_even) >> shift, 2j+1 = (scale·x[j] + x[j+1] + bias_odd)
    >> shift, the edges replicated."""
    x = x[:, :width]
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * width), np.int64)
    out[:, 0::2] = (scale * x + left + bias_even) >> shift
    out[:, 1::2] = (scale * x + right + bias_odd) >> shift
    return out


def _upsample(plane: np.ndarray, hr: int, vr: int, dw: int, dh: int, name: str) -> np.ndarray:
    """Chroma plane (decoded, block-padded) → full resolution, as
    libjpeg-turbo's ``jdsample.c`` with ``do_fancy_upsampling``: ``dw``,
    ``dh`` the component's own width and height (``downsampled_width``)."""
    p = plane.astype(np.int64)
    if (hr, vr) == (1, 1):
        return p
    if (hr, vr) == (2, 1):
        if dw <= 2:
            return np.repeat(p[:, :dw], 2, axis=1)
        return _fancy_h(p, dw, 1, 2, 3, 2)
    if (hr, vr) == (2, 2):
        if dw <= 2:
            return np.repeat(np.repeat(p[:dh, :dw], 2, axis=0), 2, axis=1)
        p = p[:dh]
        above = np.concatenate([p[:1], p[:-1]], axis=0)
        below = np.concatenate([p[1:], p[-1:]], axis=0)
        out = np.empty((2 * dh, 2 * dw), np.int64)
        out[0::2] = _fancy_h(3 * p + above, dw, 8, 7, 3, 4)
        out[1::2] = _fancy_h(3 * p + below, dw, 8, 7, 3, 4)
        return out
    raise _refuse(name, f"JPEG chroma sampling {hr}x{vr}")


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c`` ``ycc_rgb_convert``: 16-bit fixed point, rounded table
    entries, ``range_limit`` clamping."""
    one_half = 1 << 15

    def fix(v: float) -> int:
        return int(v * (1 << 16) + 0.5)

    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = "<jpeg>") -> np.ndarray:
    """A baseline (sequential, Huffman, 8-bit) JPEG → RGB uint8 pixels."""
    pos = 2
    quant: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    frame = None
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    coefs: List[List[int]] = []
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{name}: JPEG ends before EOI")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        length = struct.unpack(">H", data[pos: pos + 2])[0]
        body = data[pos + 2: pos + length]
        pos += length
        if marker in _SOF_REFUSED:
            raise _refuse(name, _SOF_REFUSED[marker])
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(body[i + 1: i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = raw
                quant[tq] = table
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1: i + 17])
                n = sum(counts)
                table = _huffman_table(counts, list(body[i + 17: i + 17 + n]))
                (ac_tabs if tc else dc_tabs)[th] = table
                i += 17 + n
        elif marker in (0xC0, 0xC1):
            precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise _refuse(name, f"a {precision}-bit JPEG")
            if ncomp not in (1, 3):
                raise _refuse(name, f"a {ncomp}-component (CMYK/YCCK) JPEG"
                              if ncomp == 4 else f"a {ncomp}-component JPEG")
            comps = [(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                      body[8 + 3 * k]) for k in range(ncomp)]
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            frame = dict(width=width, height=height, comps=comps, hmax=hmax, vmax=vmax,
                         mcux=mcux, mcuy=mcuy)
            coefs = [[0] * (mcuy * c[2] * mcux * c[1] * 64) for c in comps]
        elif marker == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe, adobe_transform = True, body[11] if len(body) > 11 else None
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            pos = _scan(data, pos, body, frame, coefs, dc_tabs, ac_tabs, restart, name)
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    return _assemble(frame, coefs, quant, jfif, adobe, adobe_transform, name)


def _scan(data: bytes, pos: int, header: bytes, frame, coefs, dc_tabs, ac_tabs, restart: int,
          name: str) -> int:
    """Decode one scan whose entropy-coded data starts at ``pos``; returns
    the position of the marker that ends it."""
    ns = header[0]
    ids = [c[0] for c in frame["comps"]]
    sel = []
    for k in range(ns):
        cid, tables = header[1 + 2 * k], header[2 + 2 * k]
        ci = ids.index(cid)
        sel.append((ci, dc_tabs[tables >> 4], ac_tabs[tables & 15]))
    ss, se, ahal = header[1 + 2 * ns: 4 + 2 * ns]
    if ss != 0 or se != 63 or ahal != 0:
        raise _refuse(name, "a progressive JPEG scan")
    comps, mcux = frame["comps"], frame["mcux"]
    # The unit order of the scan: (component, block offset, tables).
    units = []
    if ns == 1:
        ci, dc, ac = sel[0]
        _, h, v, _ = comps[ci]
        cw = -(-frame["width"] * h // frame["hmax"])
        ch = -(-frame["height"] * v // frame["vmax"])
        row_blocks = mcux * h
        for by in range(-(-ch // 8)):
            for bx in range(-(-cw // 8)):
                units.append([(ci, (by * row_blocks + bx) * 64, dc, ac)])
    else:
        for my in range(frame["mcuy"]):
            for mx in range(mcux):
                mcu = []
                for ci, dc, ac in sel:
                    _, h, v, _ = comps[ci]
                    for yy in range(v):
                        for xx in range(h):
                            by, bx = my * v + yy, mx * h + xx
                            mcu.append((ci, (by * mcux * h + bx) * 64, dc, ac))
                units.append(mcu)
    # Split the entropy-coded data at its restart markers.
    segments, start = [], pos
    while True:
        nxt = data.find(b"\xff", pos)
        if nxt < 0 or nxt + 1 >= len(data):
            raise ValueError(f"{name}: JPEG scan runs past the end of the file")
        m = data[nxt + 1]
        if m == 0x00 or m == 0xFF:
            pos = nxt + (2 if m == 0x00 else 1)
            continue
        segments.append(data[start:nxt])
        if 0xD0 <= m <= 0xD7:
            start = pos = nxt + 2
            continue
        end = nxt
        break
    per = restart or len(units)
    for i, seg in enumerate(segments):
        chunk = units[i * per: (i + 1) * per]
        if not chunk:
            break
        preds = [0] * len(comps)
        _decode_blocks(_unstuff(seg), [u for mcu in chunk for u in mcu], coefs, preds, name)
    return end


def _assemble(frame, coefs, quant, jfif, adobe, adobe_transform, name) -> np.ndarray:
    width, height, comps = frame["width"], frame["height"], frame["comps"]
    hmax, vmax, mcux, mcuy = frame["hmax"], frame["vmax"], frame["mcux"], frame["mcuy"]
    planes = []
    for (cid, h, v, tq), flat in zip(comps, coefs):
        if hmax % h or vmax % v:
            raise _refuse(name, "JPEG sampling factors that do not divide the largest")
        nbx, nby = mcux * h, mcuy * v
        zz = np.asarray(flat, np.int64).reshape(-1, 64)
        natural = np.zeros_like(zz)
        natural[:, ZIGZAG] = zz
        blocks = idct_islow(natural, quant[tq])
        plane = blocks.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
        dw = -(-width * h // hmax)
        dh = -(-height * v // vmax)
        planes.append(_upsample(plane, hmax // h, vmax // v, dw, dh, name)[:height, :width])
    if len(planes) == 1:
        return _rgb(planes[0].astype(np.uint8))
    ids = [c[0] for c in comps]
    if jfif:
        rgb = False
    elif adobe:
        rgb = adobe_transform == 0
    else:
        rgb = ids == [82, 71, 66]  # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


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

