"""WebP files without Pillow (numpy only).

:func:`decode_webp` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
the WebP files Pillow 12 opens (through libwebp's ``WebPAnimDecoder``):

* the RIFF container: a simple lossless (``VP8L``) or lossy (``VP8 ``)
  file, and the extended one (``VP8X``) with an ``ALPH`` chunk, whose
  alpha ``convert("RGB")`` drops (libwebp's RGBA output is not
  premultiplied, so the colours do not depend on it), or animated
  (``ANIM``/``ANMF``): the first frame at its offset on a canvas of
  transparent black, which is how libwebp's animation decoder starts;
* lossless (VP8L): the predictor, colour, subtract-green and
  colour-indexing transforms (with pixel bundling), the colour cache,
  meta prefix codes, LZ77 with the 120-entry distance map, and the
  canonical prefix codes, simple and normal;
* lossy (VP8): see :func:`decode_vp8`.
"""
from __future__ import annotations

import struct
from typing import List

import numpy as np


class _Bits:
    """VP8L's bit reader: little-endian, least significant bit first."""

    def __init__(self, data: bytes, name: str):
        self.data = data + b"\0" * 8
        self.end = len(data) * 8
        self.pos = 0
        self.name = name

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        v = int.from_bytes(self.data[p >> 3: (p >> 3) + 8], "little") >> (p & 7)
        self.pos = p + n
        if self.pos > self.end:
            raise ValueError(f"{self.name}: truncated WebP lossless bitstream")
        return v & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos
        return (int.from_bytes(self.data[p >> 3: (p >> 3) + 8], "little") >> (p & 7)) & (
            (1 << n) - 1)


class _Code:
    """A canonical prefix code read LSB first: a table indexed by the next
    ``bits`` bits gives (symbol, length)."""

    def __init__(self, lengths: np.ndarray, name: str):
        used = np.nonzero(lengths)[0]
        if len(used) == 0:
            raise ValueError(f"{name}: WebP prefix code without symbols")
        if len(used) == 1:  # one symbol takes no bits
            self.bits, self.sym, self.len = 0, [int(used[0])], [0]
            return
        lens = lengths[used]
        bits = int(lens.max())
        order = used[np.lexsort((used, lens))]
        sl = lengths[order]
        # canonical codes: in order of (length, symbol)
        code, codes, prev = 0, [], int(sl[0])
        for i, ln in enumerate(sl.tolist()):
            if i:
                code = (code + 1) << (ln - prev)
            prev = ln
            codes.append(code)
        if code + 1 != 1 << prev:
            raise ValueError(f"{name}: WebP prefix code is not complete")
        self.bits = bits
        self.sym = np.zeros(1 << bits, np.int64)
        self.len = np.zeros(1 << bits, np.int64)
        for s, ln, c in zip(order.tolist(), sl.tolist(), codes):
            rev = int(f"{c:0{ln}b}"[::-1], 2)
            self.sym[rev::1 << ln] = s
            self.len[rev::1 << ln] = ln
        self.sym, self.len = self.sym.tolist(), self.len.tolist()

    def read(self, br: _Bits) -> int:
        if self.bits == 0:
            return self.sym[0]
        v = br.peek(self.bits)
        br.pos += self.len[v]
        if br.pos > br.end:
            raise ValueError(f"{br.name}: truncated WebP lossless bitstream")
        return self.sym[v]


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _read_code(br: _Bits, alphabet: int) -> _Code:
    lengths = np.zeros(alphabet, np.int64)
    if br.read(1):  # simple: one or two symbols
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        if first >= alphabet:
            raise ValueError(f"{br.name}: WebP symbol {first} past its alphabet")
        lengths[first] = 1
        if n == 2:
            second = br.read(8)
            if second >= alphabet:
                raise ValueError(f"{br.name}: WebP symbol {second} past its alphabet")
            lengths[second] = 1
        return _Code(lengths, br.name)
    cl = np.zeros(19, np.int64)
    for i in range(4 + br.read(4)):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    clc = _Code(cl, br.name)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError(f"{br.name}: WebP max_symbol {max_symbol} past {alphabet}")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = clc.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
            continue
        reps = 3 + br.read(2) if c == 16 else 3 + br.read(3) if c == 17 else 11 + br.read(7)
        if sym + reps > alphabet:
            raise ValueError(f"{br.name}: WebP code lengths past the alphabet")
        lengths[sym: sym + reps] = prev if c == 16 else 0
        sym += reps
    return _Code(lengths, br.name)


# (x, y) offsets of VP8L's 120 short distance codes
_DIST_MAP = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1), (2, 2),
    (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2),
    (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2),
    (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5), (-1, 5), (5, 1), (-5, 1),
    (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6),
    (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5),
    (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5),
    (-5, 5), (7, 1), (-7, 1), (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7),
    (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5),
    (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7)]


def _prefix_value(br: _Bits, code: int) -> int:
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    return ((2 + (code & 1)) << extra) + br.read(extra) + 1


def _entropy_image(br: _Bits, w: int, h: int, top: bool) -> np.ndarray:
    """An entropy-coded image → (h, w) uint32 ARGB. ``top``: the main
    image, which may carry meta prefix codes."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"{br.name}: WebP colour cache of {cache_bits} bits")
    groups_img, gbits = None, 0
    if top and br.read(1):
        gbits = br.read(3) + 2
        gw, gh = -(-w // (1 << gbits)), -(-h // (1 << gbits))
        groups_img = ((_entropy_image(br, gw, gh, False) >> 8) & 0xFFFF).astype(np.int64)
        ngroups = int(groups_img.max()) + 1
    else:
        ngroups = 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = [[_read_code(br, a) for a in (256 + 24 + cache_size, 256, 256, 256, 40)]
              for _ in range(ngroups)]
    gimg = groups_img.tolist() if groups_img is not None else None
    out = [0] * (w * h)
    cache = [0] * cache_size
    shift = 32 - cache_bits
    total = w * h
    pos = 0
    last_cached = 0
    g = groups[0]
    while pos < total:
        if gimg is not None:
            y, x = divmod(pos, w)
            g = groups[gimg[y >> gbits][x >> gbits]]
        s = g[0].read(br)
        if s < 256:
            r = g[1].read(br)
            b = g[2].read(br)
            a = g[3].read(br)
            out[pos] = (a << 24) | (r << 16) | (s << 8) | b
            pos += 1
        elif s < 280:
            length = _prefix_value(br, s - 256)
            dcode = g[4].read(br)
            dist = _prefix_value(br, dcode)
            if dist > 120:
                dist -= 120
            else:
                dx, dy = _DIST_MAP[dist - 1]
                dist = max(1, dx + dy * w)
            if dist > pos or pos + length > total:
                raise ValueError(f"{br.name}: WebP backward reference out of the image")
            for k in range(length):
                out[pos + k] = out[pos + k - dist]
            pos += length
        else:
            k = s - 280
            if k >= cache_size:
                raise ValueError(f"{br.name}: WebP colour cache index {k} past {cache_size}")
            while last_cached < pos:
                c = out[last_cached]
                cache[((c * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = c
                last_cached += 1
            out[pos] = cache[k]
            pos += 1
        if cache_size:
            while last_cached < pos:
                c = out[last_cached]
                cache[((c * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = c
                last_cached += 1
    return np.array(out, np.uint32).reshape(h, w)


def _channels(px: np.ndarray) -> np.ndarray:
    """(…) uint32 ARGB → (…, 4) int64 [A, R, G, B]."""
    p = px.astype(np.int64)
    return np.stack([(p >> 24) & 255, (p >> 16) & 255, (p >> 8) & 255, p & 255], -1)


def _pack(ch: np.ndarray) -> np.ndarray:
    c = ch.astype(np.uint32)
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]


def _avg(a, b):
    return [(x + y) >> 1 for x, y in zip(a, b)]


def _clamp(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode: int, L, T, TL, TR):
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:
        pl = sum(abs(t - tl) for t, tl in zip(T, TL))  # |estimate − L| = |T − TL|
        pt = sum(abs(l_ - tl) for l_, tl in zip(L, TL))
        return L if pl < pt else T
    if mode == 12:
        return [_clamp(a + b - c) for a, b, c in zip(L, T, TL)]
    if mode == 13:
        out = []
        for a, b, c in zip(L, T, TL):
            m = (a + b) >> 1
            d = m - c
            out.append(_clamp(m + (d // 2 if d >= 0 else -((-d) // 2))))
        return out
    return [255, 0, 0, 0]  # modes 0, 14 and 15: opaque black


def _inverse_predictor(res: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    """(h, w, 4) residuals → pixels, row by row (each pixel may read its
    left neighbour's output)."""
    h, w, _ = res.shape
    out = np.zeros_like(res)
    out[0, 0] = (res[0, 0] + [255, 0, 0, 0]) & 255
    out[0, 1:] = np.cumsum(res[0, 1:], axis=0) + out[0, 0]
    out[0] &= 255
    mode_rows = modes.tolist()
    for y in range(1, h):
        prev = out[y - 1].tolist()
        row = res[y].tolist()
        cur: List[List[int]] = [None] * w
        cur[0] = [(r + t) & 255 for r, t in zip(row[0], prev[0])]
        mrow = mode_rows[y >> bits]
        for x in range(1, w):
            tr = prev[x + 1] if x + 1 < w else cur[0]
            p = _predict(mrow[x >> bits], cur[x - 1], prev[x], prev[x - 1], tr)
            cur[x] = [(r + q) & 255 for r, q in zip(row[x], p)]
        out[y] = cur
    return out


def _delta(t: np.ndarray, c: np.ndarray) -> np.ndarray:
    """ColorTransformDelta: (int8 t × int8 c) >> 5."""
    return (((t + 128) & 255) - 128) * (((c + 128) & 255) - 128) >> 5


def decode_vp8l(data: bytes, name: str = "<webp>") -> np.ndarray:
    """A VP8L bitstream → (H, W, 4) uint8 [A, R, G, B]."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError(f"{name}: not a WebP lossless bitstream")
    br = _Bits(data[1:], name)
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)
    if br.read(3) != 0:
        raise ValueError(f"{name}: unknown WebP lossless version")
    transforms, xsize = _transforms(br, w, h)
    px = _channels(_entropy_image(br, xsize, h, True))
    for kind, bits, sub, tw in reversed(transforms):
        if kind == 2:  # add green to red and blue
            px[..., 1] = (px[..., 1] + px[..., 2]) & 255
            px[..., 3] = (px[..., 3] + px[..., 2]) & 255
        elif kind == 1:
            el = _channels(sub)
            el = np.repeat(np.repeat(el, 1 << bits, 0), 1 << bits, 1)[:h, :tw]
            g2r, g2b, r2b = el[..., 3], el[..., 2], el[..., 1]
            red = (px[..., 1] + _delta(g2r, px[..., 2])) & 255
            blue = (px[..., 3] + _delta(g2b, px[..., 2]) + _delta(r2b, red)) & 255
            px[..., 1], px[..., 3] = red, blue
        elif kind == 0:
            modes = _channels(sub)[..., 2] & 15
            px = _inverse_predictor(px, bits, modes)
        else:
            per = 1 << bits
            idx = px[..., 2]
            if per > 1:
                nb = 8 >> bits
                shifts = np.arange(per) * nb
                idx = ((idx[..., None] >> shifts) & ((1 << nb) - 1)).reshape(h, -1)[:, :tw]
            lut = np.zeros((256, 4), np.int64)
            lut[: len(sub)] = sub[:256]
            px = lut[idx]
    return px.astype(np.uint8)


def _transforms(br: _Bits, w: int, h: int):
    """The transforms before the main image, in the order read: (kind,
    bits, data, width at that point) each, and the coded width after them
    (colour indexing packs pixels)."""
    transforms = []
    xsize = w
    seen = set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError(f"{br.name}: WebP transform {kind} given twice")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _entropy_image(br, -(-xsize // (1 << bits)), -(-h // (1 << bits)), False)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 2:
            transforms.append((2, 0, None, xsize))
        else:
            n = br.read(8) + 1
            table = _channels(_entropy_image(br, n, 1, False)[0])
            table = np.cumsum(table, axis=0) & 255
            wbits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
            transforms.append((3, wbits, table, xsize))
            xsize = -(-xsize // (1 << wbits))
    return transforms, xsize


# ------------------------------------------------------------------ container

def _chunks(data: bytes, name: str):
    pos = 12
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    while pos + 8 <= end:
        fourcc, size = data[pos: pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + size]
        if len(body) < size:
            raise ValueError(f"{name}: truncated WebP chunk {fourcc!r}")
        yield fourcc, body
        pos += 8 + size + (size & 1)


def _frame(chunks, name: str) -> np.ndarray:
    """The image chunks of one frame (ALPH, then VP8 or VP8L) → RGB."""
    for fourcc, body in chunks:
        if fourcc == b"VP8L":
            return decode_vp8l(body, name)[..., 1:]
        if fourcc == b"VP8 ":
            return decode_vp8(body, name)
    raise ValueError(f"{name}: WebP without image data")


def decode_webp(data: bytes, name: str = "<webp>") -> np.ndarray:
    """A WebP file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 16 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: not a WebP file")
    chunks = list(_chunks(data, name))
    if not chunks or chunks[0][0] not in (b"VP8 ", b"VP8L", b"VP8X"):
        raise ValueError(f"{name}: not a WebP file")
    if chunks[0][0] != b"VP8X":
        return np.ascontiguousarray(_frame(chunks[:1], name))
    flags = chunks[0][1][0]
    cw = int.from_bytes(chunks[0][1][4:7], "little") + 1
    ch = int.from_bytes(chunks[0][1][7:10], "little") + 1
    if flags & 2:  # animation: the first ANMF frame on a transparent black canvas
        for fourcc, body in chunks:
            if fourcc == b"ANMF":
                x0 = int.from_bytes(body[0:3], "little") * 2
                y0 = int.from_bytes(body[3:6], "little") * 2
                fw = int.from_bytes(body[6:9], "little") + 1
                fh = int.from_bytes(body[9:12], "little") + 1
                sub = list(_chunks(b"RIFF" + struct.pack("<I", len(body) - 12) + b"WEBP"
                                   + body[16:], name))
                rgb = _frame(sub, name)
                if rgb.shape[:2] != (fh, fw) or x0 + fw > cw or y0 + fh > ch:
                    raise ValueError(f"{name}: WebP frame does not fit its canvas")
                canvas = np.zeros((ch, cw, 3), np.uint8)
                canvas[y0: y0 + fh, x0: x0 + fw] = rgb
                return canvas
        raise ValueError(f"{name}: animated WebP without frames")
    rgb = _frame([c for c in chunks[1:] if c[0] in (b"VP8 ", b"VP8L")], name)
    if rgb.shape[:2] != (ch, cw):
        raise ValueError(f"{name}: WebP image {rgb.shape[1]}x{rgb.shape[0]} on a "
                         f"{cw}x{ch} canvas")
    return np.ascontiguousarray(rgb)


# ------------------------------------------------------------------- VP8 lossy

class _Bool:
    """RFC 6386's boolean decoder; ``eof`` is set as libwebp sets it, once
    a bit is read whose 8-bit window passes the end of the partition."""

    def __init__(self, data: bytes):
        self.data = data + b"\0\0"
        self.end = 8 * len(data)
        self.value = (self.data[0] << 8) | self.data[1]
        self.pos = 2
        self.range = 255
        self.count = 0
        self.eof = False

    def bit(self, prob: int) -> int:
        if 8 * self.pos - 8 + self.count > self.end:
            self.eof = True
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            ret = 1
        else:
            self.range = split
            ret = 0
        if self.range < 128:
            shift = _NORM[self.range]
            self.range <<= shift
            self.value <<= shift
            self.count += shift
            if self.count >= 8:
                self.count -= 8
                self.value |= (self.data[self.pos] if self.pos < len(self.data) else 0) \
                    << self.count
                self.pos += 1
        return ret

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def maybe_signed(self, n: int) -> int:
        return self.signed(n) if self.bit(128) else 0


_NORM = [0] + [7 - r.bit_length() + 1 for r in range(1, 128)]
_ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
_BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
_CAT_PROBS = [[173, 148, 140], [176, 155, 140, 135], [180, 157, 141, 134, 130],
              [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129]]
# intra modes: 16x16 and chroma (DC, V, H, TM) and the RFC's ten 4x4 modes
_DC, _V, _H, _TM, _B = 0, 1, 2, 3, 4
B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU = range(10)
_BMODE_TREE = [-B_DC, 2, -B_TM, 4, -B_VE, 6, 8, 12, -B_HE, 10, -B_RD, -B_VR, -B_LD, 14,
               -B_VL, 16, -B_HD, -B_HU]
_B_OF_Y = {_DC: B_DC, _V: B_VE, _H: B_HE, _TM: B_TM}


def _coeffs(br: _Bool, probs, ctx: int, dq, first: int, out: list) -> int:
    """libwebp's ``GetCoeffs``: one block's tokens, dequantised into
    ``out`` (raster order); returns the position after the last token."""
    n = first
    p = probs[_BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n  # end of block
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probs[_BANDS[n]][0]
        if not br.bit(p[2]):
            v, nctx = 1, 1
        else:
            if not br.bit(p[3]):
                v = 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
            elif not br.bit(p[6]):
                v = 5 + br.bit(159) if not br.bit(p[7]) else 7 + 2 * br.bit(165) + br.bit(145)
            else:
                b1 = br.bit(p[8])
                cat = 2 * b1 + br.bit(p[9 + b1])
                v = 0
                for q in _CAT_PROBS[cat]:
                    v = v + v + br.bit(q)
                v += 3 + (8 << cat)
            nctx = 2
        if br.bit(128):
            v = -v
        out[_ZIGZAG[n]] = v * dq[n > 0]
        n += 1
        p = probs[_BANDS[n]][nctx]
    return 16


def _nz_code(nz: int, dc: int) -> int:
    return 3 if nz > 3 else 2 if nz > 1 else int(dc != 0)


def _wht(c: list) -> list:
    """The inverse Walsh-Hadamard transform of the Y2 block → the 16 DCs."""
    t = [0] * 16
    for i in range(4):
        a0, a1 = c[i] + c[12 + i], c[4 + i] + c[8 + i]
        a2, a3 = c[4 + i] - c[8 + i], c[i] - c[12 + i]
        t[i], t[8 + i], t[4 + i], t[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        dc = t[4 * i] + 3
        a0, a1 = dc + t[4 * i + 3], t[4 * i + 1] + t[4 * i + 2]
        a2, a3 = t[4 * i + 1] - t[4 * i + 2], dc - t[4 * i + 3]
        out[4 * i], out[4 * i + 1] = (a0 + a1) >> 3, (a3 + a2) >> 3
        out[4 * i + 2], out[4 * i + 3] = (a0 - a1) >> 3, (a3 - a2) >> 3
    return out


def _idct(c: np.ndarray) -> np.ndarray:
    """libwebp's ``TransformOne`` on (..., 16) raster coefficients → the
    (..., 4, 4) residuals it adds (each ``v >> 3``)."""
    c = c.reshape(c.shape[:-1] + (4, 4)).astype(np.int64)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]  # rows
    a, b = i0 + i2, i0 - i2
    cc, d = mul2(i1) - mul1(i3), mul1(i1) + mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], -2)  # t[..., k, col]: row k of the column pass
    dc = t[..., :, 0] + 4
    a, b = dc + t[..., :, 2], dc - t[..., :, 2]
    cc = mul2(t[..., :, 1]) - mul1(t[..., :, 3])
    d = mul1(t[..., :, 1]) + mul2(t[..., :, 3])
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: list, left: list, tl: int) -> list:
    """A 4x4 block's prediction (rows of 4) from the 8 pixels above it
    (4 top, 4 top-right), the 4 to its left and the corner."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[v] * 4] * 4
    if mode == B_TM:
        return [[min(255, max(0, left[y] + top[x] - X)) for x in range(4)] for y in range(4)]
    if mode == B_VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row] * 4
    if mode == B_HE:
        return [[_avg3(X, I, J)] * 4, [_avg3(I, J, K)] * 4, [_avg3(J, K, L)] * 4,
                [_avg3(K, L, L)] * 4]
    if mode == B_LD:
        e = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G),
             _avg3(F, G, H), _avg3(G, H, H)]
        return [[e[x + y] for x in range(4)] for y in range(4)]
    if mode == B_RD:
        e = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I), _avg3(B, A, X),
             _avg3(C, B, A), _avg3(D, C, B)]  # e[3 - y + x]
        return [[e[3 - y + x] for x in range(4)] for y in range(4)]
    if mode == B_VR:
        return [[_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)],
                [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D)],
                [_avg3(J, I, X), _avg2(X, A), _avg2(A, B), _avg2(B, C)],
                [_avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]]
    if mode == B_VL:
        return [[_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)],
                [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)],
                [_avg2(B, C), _avg2(C, D), _avg2(D, E), _avg3(E, F, G)],
                [_avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(F, G, H)]]
    if mode == B_HD:
        return [[_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)],
                [_avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A)],
                [_avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X)],
                [_avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]]
    # B_HU
    return [[_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L)],
            [_avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L)],
            [_avg2(K, L), _avg3(K, L, L), L, L],
            [L, L, L, L]]


def _pred_block(mode: int, buf: np.ndarray, n: int, mx: int, my: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction from ``buf``'s border (row 0
    above, column 0 to the left), DC as libwebp's ``CheckMode`` picks it."""
    top, left, tl = buf[0, 1: n + 1], buf[1: n + 1, 0], buf[0, 0]
    shift = 5 if n == 16 else 4
    if mode == _DC:
        if mx and my:
            v = (int(top.sum()) + int(left.sum()) + n) >> shift
        elif mx:  # the top row: the left column alone
            v = (int(left.sum()) + n // 2) >> (shift - 1)
        elif my:  # the first column: the top row alone
            v = (int(top.sum()) + n // 2) >> (shift - 1)
        else:
            v = 128
        return np.full((n, n), v, np.int64)
    if mode == _V:
        return np.broadcast_to(top, (n, n))
    if mode == _H:
        return np.broadcast_to(left[:, None], (n, n))
    return np.clip(left[:, None] + top[None, :] - tl, 0, 255)


def _border(plane: np.ndarray, x0: int, y0: int, n: int, extra: int) -> np.ndarray:
    """A work block of (n + 1) x (n + 1 + extra): row 0 the pixels above
    (127 on the top row of macroblocks), column 0 those to the left (129
    on the first column; the corner 129 there below the top row), and
    ``extra`` top-right pixels (the last top pixel repeated at the right
    edge)."""
    buf = np.zeros((n + 1, n + 1 + extra), np.int64)
    if y0 == 0:
        buf[0] = 127
    else:
        buf[0, 1: n + 1] = plane[y0 - 1, x0: x0 + n]
        buf[0, 0] = plane[y0 - 1, x0 - 1] if x0 else 129
        if extra:
            right = plane[y0 - 1, x0 + n: x0 + n + extra]
            buf[0, n + 1:] = right if len(right) == extra else plane[y0 - 1, x0 + n - 1]
    buf[1:, 0] = plane[y0: y0 + n, x0 - 1] if x0 else 129
    return buf


def _filter_lines(x: np.ndarray, thresh, ithresh, hev_t, kind: str) -> np.ndarray:
    """libwebp's loop filter across edges: ``x`` is (n, 8) int64 lines of
    p3 p2 p1 p0 | q0 q1 q2 q3, the thresholds (n,) arrays; ``kind``
    "simple", "mb" (a macroblock edge: 6 taps) or "inner" (4 taps).
    Returns the filtered lines."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (x[:, i] for i in range(8))
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    if kind != "simple":
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            mask &= np.abs(a - b) <= ithresh
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(mask)
    new = x.copy()
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    f1, f2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    two = mask & hev
    new[:, 3] = np.where(two, np.clip(p0 + f2, 0, 255), p0)
    new[:, 4] = np.where(two, np.clip(q0 - f1, 0, 255), q0)
    rest = mask & ~hev
    if kind == "mb":
        a = np.clip(a, -128, 127)
        w1, w2, w3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        for i, base, d in ((1, p2, w3), (2, p1, w2), (3, p0, w1), (4, q0, -w1), (5, q1, -w2),
                           (6, q2, -w3)):
            new[:, i] = np.where(rest, np.clip(base + d, 0, 255), new[:, i])
    elif kind == "inner":
        a = 3 * (q0 - p0)
        f1, f2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
        f3 = (f1 + 1) >> 1
        for i, base, d in ((2, p1, f3), (3, p0, f2), (4, q0, -f1), (5, q1, -f3)):
            new[:, i] = np.where(rest, np.clip(base + d, 0, 255), new[:, i])
    return new


def _loop_filter(planes, info: np.ndarray, simple: bool) -> None:
    """The in-loop filter over the whole frame as libwebp's ``DoFilter``
    runs it, macroblock by macroblock in raster order: the left edge, the
    inner vertical edges, the top edge, the inner horizontal edges (chroma
    only for the normal filter). ``info`` (mbh, mbw, 4): limit, interior
    limit, hev threshold, inner edges. Macroblock (x, y) reads what (x - 1,
    y) and (x + 1, y - 1) wrote and nothing of (x + 2, y - 1), so the
    macroblocks of one wavefront x + 2y = t are filtered together."""
    mbh, mbw = info.shape[:2]
    kinds = ("simple", "simple") if simple else ("mb", "inner")
    ys_all = np.arange(mbh)
    for t in range(mbw + 2 * (mbh - 1)):
        xs_all = t - 2 * ys_all
        ok = (xs_all >= 0) & (xs_all < mbw)
        ys, xs = ys_all[ok], xs_all[ok]
        keep = info[ys, xs, 0] > 0
        ys, xs = ys[keep], xs[keep]
        if not len(ys):
            continue
        limit, ilevel, hev_t, inner = (info[ys, xs, k] for k in range(4))
        for p, plane in enumerate(planes[:1] if simple else planes):
            n = 16 if p == 0 else 8
            steps = (4, 8, 12) if n == 16 else (4,)
            lines = np.arange(n)
            taps = np.arange(-4, 4)

            def edge(sel, off, thr, kind, vertical):
                if not sel.any():
                    return
                y0, x0 = ys[sel] * n, xs[sel] * n
                along = (y0 if vertical else x0)[:, None] + lines  # (k, n)
                across = (x0 if vertical else y0)[:, None, None] + off + taps  # (k, 1, 8)
                along = np.broadcast_to(along[:, :, None], (len(y0), n, 8)).reshape(-1, 8)
                across = np.broadcast_to(across, (len(y0), n, 8)).reshape(-1, 8)
                r, c = (along, across) if vertical else (across, along)
                per = [np.repeat(v[sel], n) for v in (thr, ilevel, hev_t)]
                plane[r, c] = _filter_lines(plane[r, c], *per, kind)

            edge(xs > 0, 0, limit + 4, kinds[0], True)
            for s in steps:
                edge(inner > 0, s, limit, kinds[1], True)
            edge(ys > 0, 0, limit + 4, kinds[0], False)
            for s in steps:
                edge(inner > 0, s, limit, kinds[1], False)


def _upsample_rows(top: np.ndarray, cur: np.ndarray, width: int, bottom: bool) -> np.ndarray:
    """libwebp's fancy upsampler for one output row from the chroma rows
    ``top`` and ``cur`` (the row's own pair: "top" rows weigh ``top`` 3:1,
    "bottom" rows ``cur``); (n, uv_w) → (n, width)."""
    tl, t = top[:, :-1], top[:, 1:]
    l_, c = cur[:, :-1], cur[:, 1:]
    out = np.zeros((top.shape[0], width), np.int64)
    near, far = (cur, top) if bottom else (top, cur)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    avg = tl + t + l_ + c + 8
    d12 = (avg + 2 * (t + l_)) >> 3
    d03 = (avg + 2 * (tl + c)) >> 3
    pairs = (width - 1) >> 1
    if bottom:
        odd, even = (d03 + l_) >> 1, (d12 + c) >> 1
    else:
        odd, even = (d12 + tl) >> 1, (d03 + t) >> 1
    out[:, 1: 2 * pairs: 2] = odd[:, :pairs]
    out[:, 2: 2 * pairs + 1: 2] = even[:, :pairs]
    if width % 2 == 0:
        last = (width - 1) >> 1
        out[:, width - 1] = (3 * near[:, last] + far[:, last] + 2) >> 2
    return out


def _fancy_upsample(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """A (ceil(h/2), ceil(w/2)) chroma plane → (h, w), as libwebp's
    ``EmitFancyRGB`` pairs the rows: row 0 from chroma row 0 alone, rows
    2j-1 and 2j from rows j-1 and j, and the last row of an even height
    from the last chroma row alone."""
    p = plane.astype(np.int64)
    rows = np.arange(height)
    j = (rows + 1) // 2
    top_idx = np.where(rows == 0, 0, j - 1)
    cur_idx = np.minimum(j, p.shape[0] - 1)
    top_idx = np.where(j >= p.shape[0], p.shape[0] - 1, top_idx)
    bottom = (rows % 2 == 0) & (rows > 0)
    out = np.empty((height, width), np.int64)
    for is_bottom in (False, True):
        sel = bottom == is_bottom
        if sel.any():
            out[sel] = _upsample_rows(p[top_idx[sel]], p[cur_idx[sel]], width, is_bottom)
    return out


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's fixed-point ``VP8YuvToRgb`` (14-bit coefficients, 6
    fraction bits)."""
    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = (y * 19077) >> 8
    r = clip8(yy + ((v * 26149) >> 8) - 14234)
    g = clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def decode_vp8(data: bytes, name: str = "<webp>") -> np.ndarray:
    """A lossy VP8 key frame → (H, W, 3) uint8 RGB, as libwebp decodes it
    for Pillow: the boolean decoder, the frame header (segmentation, loop
    filter deltas, token probability updates over the default tables),
    intra 16x16, 4x4 and chroma prediction, the inverse WHT and DCT, the
    normal or simple loop filter, then fancy upsampling and libwebp's
    fixed-point YUV → RGB."""
    if len(data) < 10:
        raise ValueError(f"{name}: truncated VP8 frame")
    tag = data[0] | (data[1] << 8) | (data[2] << 16)
    if tag & 1:
        raise ValueError(f"{name}: VP8 frame is not a key frame")
    if (tag >> 1) & 7 > 3 or not (tag >> 4) & 1:
        raise ValueError(f"{name}: bad VP8 frame header")
    part0 = tag >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: bad VP8 start code")
    width, height = struct.unpack_from("<HH", data, 6)
    width, height = width & 0x3FFF, height & 0x3FFF
    if not width or not height:
        raise ValueError(f"{name}: VP8 frame of size {width}x{height}")
    if 10 + part0 > len(data):
        raise ValueError(f"{name}: truncated VP8 first partition")
    br = _Bool(data[10: 10 + part0])
    br.bit(128), br.bit(128)  # colour space, clamping type
    use_segment = br.bit(128)
    update_map, absolute, seg_q, seg_lf, seg_probs = 0, 0, [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.bit(128)
        if br.bit(128):
            absolute = br.bit(128)
            seg_q = [br.maybe_signed(7) for _ in range(4)]
            seg_lf = [br.maybe_signed(6) for _ in range(4)]
        if update_map:
            seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    simple, level, sharpness = br.bit(128), br.literal(6), br.literal(3)
    ref_lf, mode_lf = [0] * 4, [0] * 4
    use_lf_delta = br.bit(128)
    if use_lf_delta and br.bit(128):
        ref_lf = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        mode_lf = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
    nparts = 1 << br.literal(2)
    q0 = br.literal(7)
    dq = [br.maybe_signed(4) for _ in range(5)]  # y1 dc, y2 dc, y2 ac, uv dc, uv ac
    br.bit(128)  # refresh entropy probabilities: a key frame starts from the defaults
    probs = [[[[br.literal(8) if br.bit(u) else d for u, d in zip(uc, dc)]
               for uc, dc in zip(ub, db)] for ub, db in zip(ut, dt)]
             for ut, dt in zip(_COEFF_UPDATE_PROBS.tolist(), _COEFF_PROBS.tolist())]
    skip_prob = br.literal(8) if br.bit(128) else None
    if br.eof:
        raise ValueError(f"{name}: truncated VP8 frame header")

    # the token partitions
    rest = data[10 + part0:]
    if len(rest) < 3 * (nparts - 1):
        raise ValueError(f"{name}: truncated VP8 partition sizes")
    start, left = 3 * (nparts - 1), len(rest) - 3 * (nparts - 1)
    parts = []
    for p in range(nparts - 1):
        size = min(int.from_bytes(rest[3 * p: 3 * p + 3], "little"), left)
        parts.append(_Bool(rest[start: start + size]))
        start, left = start + size, left - size
    if left <= 0:
        raise ValueError(f"{name}: truncated VP8 token partitions")
    parts.append(_Bool(rest[start:]))

    # quantisers and filter strengths per segment
    def clip(v, m):
        return 0 if v < 0 else m if v > m else v

    quant, fstrength = [], []
    for s in range(4):
        q = (seg_q[s] + (0 if absolute else q0)) if use_segment else q0
        y2ac = (_AC_QUANT[clip(q + dq[2], 127)] * 101581) >> 16
        quant.append(((_DC_QUANT[clip(q + dq[0], 127)], _AC_QUANT[clip(q, 127)]),
                      (_DC_QUANT[clip(q + dq[1], 127)] * 2, max(y2ac, 8)),
                      (_DC_QUANT[clip(q + dq[3], 117)], _AC_QUANT[clip(q + dq[4], 127)])))
        base = (seg_lf[s] + (0 if absolute else level)) if use_segment else level
        per_mode = []
        for i4 in (0, 1):
            lvl = base + (ref_lf[0] + (mode_lf[0] if i4 else 0) if use_lf_delta else 0)
            lvl = clip(lvl, 63)
            if lvl == 0:
                per_mode.append((0, 0, 0))
                continue
            ilevel = lvl
            if sharpness:
                ilevel >>= 2 if sharpness > 4 else 1
                ilevel = min(ilevel, 9 - sharpness)
            ilevel = max(ilevel, 1)
            per_mode.append((2 * lvl + ilevel, ilevel, 2 if lvl >= 40 else 1 if lvl >= 15 else 0))
        fstrength.append(per_mode)
    filter_type = 0 if level == 0 else 1 if simple else 2

    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    coef = np.zeros((mbh, mbw, 24, 16), np.int64)  # 16 Y, 4 U, 4 V blocks, raster order
    modes = [[None] * mbw for _ in range(mbh)]
    finfo = np.zeros((mbh, mbw, 4), np.int64)
    top_b = [[B_DC] * 4 for _ in range(mbw)]  # 4x4 mode context from above
    top_nz = [[0] * 8 for _ in range(mbw)]  # Y columns 0-3, U 4-5, V 6-7
    top_dc = [0] * mbw
    for my in range(mbh):
        tb = parts[my % nparts]
        left_b, left_nz, left_dc = [B_DC] * 4, [0] * 8, 0
        for mx in range(mbw):
            seg = 0
            if update_map:
                seg = br.bit(seg_probs[1]) if not br.bit(seg_probs[0]) else 2 + br.bit(seg_probs[2])
            skip = br.bit(skip_prob) if skip_prob is not None else 0
            i4 = not br.bit(145)
            if not i4:
                ymode = (_TM if br.bit(128) else _H) if br.bit(156) else \
                    (_V if br.bit(163) else _DC)
                bmodes = None
                top_b[mx] = [_B_OF_Y[ymode]] * 4
                left_b = [_B_OF_Y[ymode]] * 4
            else:
                ymode, bmodes = _B, []
                for r in range(4):
                    for c in range(4):
                        pr = _KF_BMODE_PROBS[top_b[mx][c]][left_b[r]]
                        i = 0
                        while True:
                            i = _BMODE_TREE[i + br.bit(pr[i >> 1])]
                            if i <= 0:
                                break
                        top_b[mx][c] = left_b[r] = -i
                        bmodes.append(-i)
            uvmode = _DC if not br.bit(142) else _V if not br.bit(114) else \
                (_TM if br.bit(183) else _H)
            modes[my][mx] = (ymode, bmodes, uvmode)
            if br.eof:
                raise ValueError(f"{name}: premature end of the VP8 first partition")

            qy, qy2, quv = quant[seg]
            blocks = coef[my, mx]
            codes = []
            if skip:
                left_nz, top_nz[mx] = [0] * 8, [0] * 8
                if not i4:
                    left_dc = top_dc[mx] = 0
            else:
                first = 0
                if not i4:
                    dc = [0] * 16
                    nz = _coeffs(tb, probs[1], left_dc + top_dc[mx], qy2, 0, dc)
                    left_dc = top_dc[mx] = int(nz > 0)
                    blocks[:16, 0] = _wht(dc)
                    first = 1
                ac = probs[0] if not i4 else probs[3]
                for r in range(4):
                    for c in range(4):
                        out = [0] * 16
                        if first:
                            out[0] = int(blocks[4 * r + c, 0])
                        nz = _coeffs(tb, ac, left_nz[r] + top_nz[mx][c], qy, first, out)
                        left_nz[r] = top_nz[mx][c] = int(nz > first)
                        codes.append(_nz_code(nz, out[0]))
                        blocks[4 * r + c] = out
                for ch in (0, 1):
                    for r in range(2):
                        for c in range(2):
                            out = [0] * 16
                            k = 4 + 2 * ch
                            nz = _coeffs(tb, probs[2], left_nz[k + r] + top_nz[mx][k + c], quv,
                                         0, out)
                            left_nz[k + r] = top_nz[mx][k + c] = int(nz > 0)
                            codes.append(_nz_code(nz, out[0]))
                            blocks[16 + 4 * ch + 2 * r + c] = out
                skip = not any(codes)
            if filter_type:
                limit, ilevel, hev_t = fstrength[seg][int(i4)]
                finfo[my, mx] = (limit, ilevel, hev_t, int(i4) or not skip)
            if tb.eof:
                raise ValueError(f"{name}: premature end of a VP8 token partition")

    # reconstruction: prediction from unfiltered neighbours plus the residuals
    res = _idct(coef)  # (mbh, mbw, 24, 4, 4)
    Y = np.zeros((mbh * 16, mbw * 16), np.int64)
    U = np.zeros((mbh * 8, mbw * 8), np.int64)
    V = np.zeros((mbh * 8, mbw * 8), np.int64)
    for my in range(mbh):
        for mx in range(mbw):
            ymode, bmodes, uvmode = modes[my][mx]
            r_y = res[my, mx, :16]
            buf = _border(Y, mx * 16, my * 16, 16, 4)
            if bmodes is None:
                pred = _pred_block(ymode, buf, 16, mx, my)
                blk = pred + r_y.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                buf[1:17, 1:17] = np.clip(blk, 0, 255)
            else:
                for row in (4, 8, 12):
                    buf[row, 17:21] = buf[0, 17:21]
                b = buf.tolist()
                for n in range(16):
                    r, c = divmod(n, 4)
                    y0, x0 = 4 * r, 4 * c
                    top = b[y0][x0 + 1: x0 + 9]
                    left = [b[y0 + 1 + k][x0] for k in range(4)]
                    pred = _pred4(bmodes[n], top, left, b[y0][x0])
                    rr = r_y[n].tolist()
                    for k in range(4):
                        b[y0 + 1 + k][x0 + 1: x0 + 5] = [min(255, max(0, p + q))
                                                         for p, q in zip(pred[k], rr[k])]
                buf = np.array(b, np.int64)
            Y[my * 16: my * 16 + 16, mx * 16: mx * 16 + 16] = buf[1:17, 1:17]
            for ch, plane in ((0, U), (1, V)):
                cb = _border(plane, mx * 8, my * 8, 8, 0)
                pred = _pred_block(uvmode, cb, 8, mx, my)
                r_c = res[my, mx, 16 + 4 * ch: 20 + 4 * ch]
                blk = pred + r_c.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[my * 8: my * 8 + 8, mx * 8: mx * 8 + 8] = np.clip(blk, 0, 255)
    if filter_type:
        _loop_filter((Y, U, V), finfo, filter_type == 1)
    cw, ch_ = (width + 1) // 2, (height + 1) // 2
    y = Y[:height, :width]
    u = _fancy_upsample(U[:ch_, :cw], height, width)
    v = _fancy_upsample(V[:ch_, :cw], height, width)
    return _yuv_to_rgb(y, u, v)


# ---------------------------------------------------------------- VP8 tables
# RFC 6386's default tables, as libvpx and libwebp carry them.

# kf_bmode_probs[above][left]: the key frame's 4x4 mode probabilities, in
# the RFC's order of modes (DC, TM, VE, HE, LD, RD, VR, VL, HD, HU)
_KF_BMODE_PROBS = np.array([
    [[231, 120, 48, 89, 115, 113, 120, 152, 112], [152, 179, 64, 126, 170, 118, 46, 70, 95],
     [175, 69, 143, 80, 85, 82, 72, 155, 103], [56, 58, 10, 171, 218, 189, 17, 13, 152],
     [144, 71, 10, 38, 171, 213, 144, 34, 26], [114, 26, 17, 163, 44, 195, 21, 10, 173],
     [121, 24, 80, 195, 26, 62, 44, 64, 85], [170, 46, 55, 19, 136, 160, 33, 206, 71],
     [63, 20, 8, 114, 114, 208, 12, 9, 226], [81, 40, 11, 96, 182, 84, 29, 16, 36]],
    [[134, 183, 89, 137, 98, 101, 106, 165, 148], [72, 187, 100, 130, 157, 111, 32, 75, 80],
     [66, 102, 167, 99, 74, 62, 40, 234, 128], [41, 53, 9, 178, 241, 141, 26, 8, 107],
     [104, 79, 12, 27, 217, 255, 87, 17, 7], [74, 43, 26, 146, 73, 166, 49, 23, 157],
     [65, 38, 105, 160, 51, 52, 31, 115, 128], [87, 68, 71, 44, 114, 51, 15, 186, 23],
     [47, 41, 14, 110, 182, 183, 21, 17, 194], [66, 45, 25, 102, 197, 189, 23, 18, 22]],
    [[88, 88, 147, 150, 42, 46, 45, 196, 205], [43, 97, 183, 117, 85, 38, 35, 179, 61],
     [39, 53, 200, 87, 26, 21, 43, 232, 171], [56, 34, 51, 104, 114, 102, 29, 93, 77],
     [107, 54, 32, 26, 51, 1, 81, 43, 31], [39, 28, 85, 171, 58, 165, 90, 98, 64],
     [34, 22, 116, 206, 23, 34, 43, 166, 73], [68, 25, 106, 22, 64, 171, 36, 225, 114],
     [34, 19, 21, 102, 132, 188, 16, 76, 124], [62, 18, 78, 95, 85, 57, 50, 48, 51]],
    [[193, 101, 35, 159, 215, 111, 89, 46, 111], [60, 148, 31, 172, 219, 228, 21, 18, 111],
     [112, 113, 77, 85, 179, 255, 38, 120, 114], [40, 42, 1, 196, 245, 209, 10, 25, 109],
     [100, 80, 8, 43, 154, 1, 51, 26, 71], [88, 43, 29, 140, 166, 213, 37, 43, 154],
     [61, 63, 30, 155, 67, 45, 68, 1, 209], [142, 78, 78, 16, 255, 128, 34, 197, 171],
     [41, 40, 5, 102, 211, 183, 4, 1, 221], [51, 50, 17, 168, 209, 192, 23, 25, 82]],
    [[125, 98, 42, 88, 104, 85, 117, 175, 82], [95, 84, 53, 89, 128, 100, 113, 101, 45],
     [75, 79, 123, 47, 51, 128, 81, 171, 1], [57, 17, 5, 71, 102, 57, 53, 41, 49],
     [115, 21, 2, 10, 102, 255, 166, 23, 6], [38, 33, 13, 121, 57, 73, 26, 1, 85],
     [41, 10, 67, 138, 77, 110, 90, 47, 114], [101, 29, 16, 10, 85, 128, 101, 196, 26],
     [57, 18, 10, 102, 102, 213, 34, 20, 43], [117, 20, 15, 36, 163, 128, 68, 1, 26]],
    [[138, 31, 36, 171, 27, 166, 38, 44, 229], [67, 87, 58, 169, 82, 115, 26, 59, 179],
     [63, 59, 90, 180, 59, 166, 93, 73, 154], [40, 40, 21, 116, 143, 209, 34, 39, 175],
     [57, 46, 22, 24, 128, 1, 54, 17, 37], [47, 15, 16, 183, 34, 223, 49, 45, 183],
     [46, 17, 33, 183, 6, 98, 15, 32, 183], [65, 32, 73, 115, 28, 128, 23, 128, 205],
     [40, 3, 9, 115, 51, 192, 18, 6, 223], [87, 37, 9, 115, 59, 77, 64, 21, 47]],
    [[104, 55, 44, 218, 9, 54, 53, 130, 226], [64, 90, 70, 205, 40, 41, 23, 26, 57],
     [54, 57, 112, 184, 5, 41, 38, 166, 213], [30, 34, 26, 133, 152, 116, 10, 32, 134],
     [75, 32, 12, 51, 192, 255, 160, 43, 51], [39, 19, 53, 221, 26, 114, 32, 73, 255],
     [31, 9, 65, 234, 2, 15, 1, 118, 73], [88, 31, 35, 67, 102, 85, 55, 186, 85],
     [56, 21, 23, 111, 59, 205, 45, 37, 192], [55, 38, 70, 124, 73, 102, 1, 34, 98]],
    [[102, 61, 71, 37, 34, 53, 31, 243, 192], [69, 60, 71, 38, 73, 119, 28, 222, 37],
     [68, 45, 128, 34, 1, 47, 11, 245, 171], [62, 17, 19, 70, 146, 85, 55, 62, 70],
     [75, 15, 9, 9, 64, 255, 184, 119, 16], [37, 43, 37, 154, 100, 163, 85, 160, 1],
     [63, 9, 92, 136, 28, 64, 32, 201, 85], [86, 6, 28, 5, 64, 255, 25, 248, 1],
     [56, 8, 17, 132, 137, 255, 55, 116, 128], [58, 15, 20, 82, 135, 57, 26, 121, 40]],
    [[164, 50, 31, 137, 154, 133, 25, 35, 218], [51, 103, 44, 131, 131, 123, 31, 6, 158],
     [86, 40, 64, 135, 148, 224, 45, 183, 128], [22, 26, 17, 131, 240, 154, 14, 1, 209],
     [83, 12, 13, 54, 192, 255, 68, 47, 28], [45, 16, 21, 91, 64, 222, 7, 1, 197],
     [56, 21, 39, 155, 60, 138, 23, 102, 213], [85, 26, 85, 85, 128, 128, 32, 146, 171],
     [18, 11, 7, 63, 144, 171, 4, 4, 246], [35, 27, 10, 146, 174, 171, 12, 26, 128]],
    [[190, 80, 35, 99, 180, 80, 126, 54, 45], [85, 126, 47, 87, 176, 51, 41, 20, 32],
     [101, 75, 128, 139, 118, 146, 116, 128, 85], [56, 41, 15, 176, 236, 85, 37, 9, 62],
     [146, 36, 19, 30, 171, 255, 97, 27, 20], [71, 30, 17, 119, 118, 255, 17, 18, 138],
     [101, 38, 60, 138, 55, 70, 43, 26, 142], [138, 45, 61, 62, 219, 1, 81, 188, 64],
     [32, 41, 20, 117, 151, 142, 20, 21, 163], [112, 19, 12, 61, 195, 128, 48, 4, 24]],
]).tolist()

# default_coeff_probs[block type][band][context][node]
_COEFF_PROBS = np.array([
    [[[128] * 11] * 3,
     [[253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128],
      [189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128],
      [106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128]],
     [[1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128],
      [181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128],
      [78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128]],
     [[1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128],
      [184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128],
      [77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128]],
     [[1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128],
      [170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128],
      [37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128]],
     [[1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128],
      [207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128],
      [102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128]],
     [[1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128],
      [177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128],
      [80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128]],
     [[1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128],
      [246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128],
      [255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128]]],
    [[[198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62],
      [131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1],
      [68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128]],
     [[1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128],
      [184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128],
      [81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128]],
     [[1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128],
      [99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128],
      [23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128]],
     [[1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128],
      [109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128],
      [44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128]],
     [[1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128],
      [94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128],
      [22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128]],
     [[1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128],
      [124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128],
      [35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128]],
     [[1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128],
      [121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128],
      [45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128]],
     [[1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128],
      [203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128],
      [137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128]]],
    [[[253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128],
      [175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128],
      [73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128]],
     [[1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128],
      [239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128],
      [155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128]],
     [[1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128],
      [201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128],
      [69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128]],
     [[1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128],
      [223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128],
      [141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128]],
     [[1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128],
      [190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128],
      [149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128]],
     [[1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128],
      [247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128],
      [240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128]],
     [[1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128],
      [213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128],
      [55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128]],
     [[128] * 11] * 3],
    [[[202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255],
      [126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128],
      [61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128]],
     [[1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128],
      [166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128],
      [39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128]],
     [[1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128],
      [124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128],
      [24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128]],
     [[1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128],
      [149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128],
      [28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128]],
     [[1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128],
      [123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128],
      [20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128]],
     [[1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128],
      [168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128],
      [47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128]],
     [[1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128],
      [141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128],
      [42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128]],
     [[1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128],
      [244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128],
      [238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128]]],
], np.int64)

# coeff_update_probs[block type][band][context][node]
_COEFF_UPDATE_PROBS = np.array([
    [[[255] * 11] * 3,
     [[176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255],
      [249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255],
      [234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255],
      [250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255],
      [254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255] * 11] * 3],
    [[[217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255],
      [234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255]],
     [[255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255],
      [250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255] * 11] * 3],
    [[[186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255],
      [234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255],
      [251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255]],
     [[255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255]],
     [[255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255] * 11] * 3, [[255] * 11] * 3, [[255] * 11] * 3],
    [[[248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255],
      [248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255],
      [246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255],
      [252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255]],
     [[255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255],
      [248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255],
      [253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255],
      [252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255],
      [250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]],
     [[255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255],
      [255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255]]],
], np.int64)

_DC_QUANT = [
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157]
_AC_QUANT = [
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90,
    92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134,
    137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274,
    279, 284]
