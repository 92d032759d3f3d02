"""Every image Pillow decodes, without Pillow: ``data/image_io.read_image``
against ``np.asarray(Image.open(p).convert("RGB"))``, max |difference| 0.

JPEG: progressive Huffman scripts (Pillow writes them) and the same
scripts stopped early, where libjpeg's block smoothing fills the
coefficients still unknown; arithmetic coding, sequential (SOF9) and
progressive (SOF10), with the DAC conditioning's defaults and with other
values; lossless (SOF3) with each predictor and point transform; CMYK
(Pillow's and one without an Adobe marker) and YCCK; sampling factors
h1v2, 4:1:1, 1:4 and mixes, restart markers in each coding. PNG: Adam7
interlace in every colour type and bit depth, 16-bit samples in every
colour type, 1/2/4-bit gray. What Pillow refuses (12-bit JPEG,
arithmetic-coded lossless, hierarchical frames, sampling factors that do
not divide the largest) raises ``ValueError`` naming the file; each
refusal is checked against Pillow first.

Pillow writes the progressive and CMYK files; :class:`JpegWriter`, a
small encoder of ITU T.81 kept here, writes the rest: a float DCT and
quantization, Huffman tables built per scan (Annex K.2), the QM
arithmetic coder (Annex D, as libjpeg's ``jcarith.c`` drives it), the
lossless predictors (Annex H), any sampling factors, 8 or 12 bits.

``tests/torch_images/formats/`` holds small fixtures of these kinds (and
of ``tests/test_torch_image_containers.py``'s containers) beside
Pillow's pixels (``chip_smoke.py`` phase 19a decodes them where no Pillow
is installed); ``PYTHONPATH=. python tests/test_torch_image_formats.py``
writes them anew.
"""
import io
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mm_s2ut_torch.data import image_io as I
from mm_s2ut_torch.data.jpeg import ZIGZAG as ZZ  # zigzag position → natural position

FORMATS = Path(__file__).resolve().parent / "torch_images" / "formats"


def scene(h, w, c=3, seed=0, period=(7.0, 5.0), noise=20.0, depth=8):
    """A smooth pattern with noise: (h, w, c) integers of ``depth`` bits."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    top = (1 << depth) - 1
    img = np.stack([top / 2 + top * 0.4 * np.sin(x / period[0] + k) * np.cos(y / period[1] - k)
                    for k in range(c)], -1)
    img = img + rng.randn(h, w, c) * noise * top / 255
    return np.clip(np.round(img), 0, top).astype(np.uint16 if depth > 8 else np.uint8)


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def pil_refuses(data: bytes) -> bool:
    try:
        Image.open(io.BytesIO(data)).convert("RGB")
    except (OSError, SyntaxError, ValueError):
        return True
    return False


def save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def assert_equals_pil(data: bytes, tmp_path, name="x.jpg"):
    want = pil_rgb(data)
    (tmp_path / name).write_bytes(data)
    got = I.read_image(tmp_path / name)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ the encoder

def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def huffman_table(freq):
    """Annex K.2 (libjpeg's ``jpeg_gen_optimal_table``): code lengths of at
    most 16 bits for the symbols of nonzero ``freq`` (256 entries) →
    (BITS, HUFFVAL)."""
    freq = list(freq) + [1]  # the reserved all-ones code point
    size, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        for i in range(257):
            if freq[i] and (c1 < 0 or freq[i] <= freq[c1]):
                c1 = i
        for i in range(257):
            if freq[i] and i != c1 and (c2 < 0 or freq[i] <= freq[c2]):
                c2 = i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [v for n in range(1, 33) for v in range(256) if size[v] == n]
    return bits[1:17], vals


def huffman_codes(bits, vals):
    codes, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            codes[vals[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return codes


class BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        self.acc = 0
        return bytes(self.out)


def _category(v: int) -> int:
    return abs(v).bit_length()


def _bits(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


# Table D.2 (libjpeg's jaricom.c): Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS.
QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
]


class ArithEncoder:
    """The QM coder of Annex D as ``jcarith.c`` runs it (every pending
    byte written out: no trailing-zero elision)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.ct, self.buffer = 0, 0x10000, 0, 11, -1

    def _emit(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _byte_out(self, temp: int) -> None:
        if temp > 0xFF:
            if self.buffer >= 0:
                self._emit(self.buffer + 1)
            self.out.extend(b"\x00" * self.sc)
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer >= 0:
                self._emit(self.buffer)
            for _ in range(self.sc):
                self.out.extend(b"\xff\x00")
            self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st: list, i: int, val: int) -> None:
        sv = st[i]
        qe, nl, nm, switch = QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit(self.buffer + 1)
            self.out.extend(b"\x00" * self.sc)
        else:
            if self.buffer >= 0:
                self._emit(self.buffer)
            for _ in range(self.sc):
                self.out.extend(b"\xff\x00")
        self._emit((self.c >> 19) & 0xFF)
        self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


class ArithModel:
    """The statistics bins of one scan's tables and the coding of one
    value (Figures F.6-F.9)."""

    def __init__(self, enc: ArithEncoder, dac_l=None, dac_u=None, dac_k=None):
        self.enc = enc
        self.dc = {t: [0] * 64 for t in range(4)}
        self.ac = {t: [0] * 256 for t in range(4)}
        self.fixed = [113]
        self.L = dac_l or {t: 0 for t in range(4)}
        self.U = dac_u or {t: 1 for t in range(4)}
        self.K = dac_k or {t: 5 for t in range(4)}

    def reset(self, dc_tables=(), ac_tables=()):
        for t in dc_tables:
            self.dc[t] = [0] * 64
        for t in ac_tables:
            self.ac[t] = [0] * 256

    def dc_diff(self, tbl: int, ctx: int, v: int) -> int:
        """Code DC difference ``v`` in context ``ctx``; returns the next context."""
        st, e = self.dc[tbl], self.enc
        if v == 0:
            e.encode(st, ctx, 0)
            return 0
        e.encode(st, ctx, 1)
        if v > 0:
            e.encode(st, ctx + 1, 0)
            i, nxt = ctx + 2, 4
        else:
            v = -v
            e.encode(st, ctx + 1, 1)
            i, nxt = ctx + 3, 8
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m, v2, i = 1, v, 20
            while v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                i += 1
        e.encode(st, i, 0)
        if m < (1 << self.L[tbl]) >> 1:
            nxt = 0
        elif m > (1 << self.U[tbl]) >> 1:
            nxt += 8
        i += 14
        while m >> 1:
            m >>= 1
            e.encode(st, i, 1 if m & v else 0)
        return nxt

    def ac_value(self, tbl: int, k: int, i: int, v: int) -> None:
        """|v| > 0 at band position ``k`` after its sign; ``i`` = its SP bin."""
        st, e = self.ac[tbl], self.enc
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m, v2 = 1, v
            if v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= self.K[tbl] else 217
                while v2 >> 1:
                    v2 >>= 1
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
        e.encode(st, i, 0)
        i += 14
        while m >> 1:
            m >>= 1
            e.encode(st, i, 1 if m & v else 0)

    def ac_band(self, tbl: int, zz, ss: int, se: int, al: int) -> None:
        """AC first (or sequential with ss=1, se=63, al=0): Figure F.5."""
        st, e = self.ac[tbl], self.enc
        vals = [(abs(int(zz[k])) >> al) * (1 if zz[k] >= 0 else -1) for k in range(64)]
        ke = 0
        for k in range(se, 0, -1):
            if vals[k]:
                ke = k
                break
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while vals[k] == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            e.encode(st, i + 1, 1)
            e.encode(self.fixed, 0, 0 if vals[k] > 0 else 1)
            self.ac_value(tbl, k, i + 2, abs(vals[k]))
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl: int, zz, ss: int, se: int, ah: int, al: int) -> None:
        st, e = self.ac[tbl], self.enc
        mag = [abs(int(zz[k])) for k in range(64)]
        ke = 0
        for k in range(se, 0, -1):
            if mag[k] >> al:
                ke = k
                break
        kex = 0
        for k in range(ke, 0, -1):
            if mag[k] >> ah:
                kex = k
                break
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = mag[k] >> al
                if v:
                    if v >> 1:
                        e.encode(st, i + 2, v & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, 0 if zz[k] > 0 else 1)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


class JpegWriter:
    """A JPEG of component planes: ``comps`` lists (id, h, v, table) and
    ``planes`` the full-size sample planes (``depth`` bits) before
    subsampling. ``mode``: "huffman" (SOF0/SOF1), "arith" (SOF9),
    "arith_prog" (SOF10, ``script`` of (components, Ss, Se, Ah, Al)),
    "lossless" (SOF3, ``predictor``, ``pt``). ``restart``: MCUs per
    restart interval. ``markers``: extra segments before the frame
    (APP14 etc.); ``dac``: (L, U, K) per table index for arithmetic
    coding (written as a DAC segment)."""

    def __init__(self, planes, comps, depth=8, quality_scale=1.0, restart=0, markers=b"",
                 dac=None, sof=None):
        self.depth, self.comps, self.restart = depth, comps, restart
        self.markers, self.dac, self.sof = markers, dac, sof
        self.h, self.w = planes[0].shape
        self.hmax = max(c[1] for c in comps)
        self.vmax = max(c[2] for c in comps)
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        base = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                         14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                         18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                         49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
        scale = quality_scale * (16 if depth == 12 else 1)
        self.quant = {t: np.clip(np.round(base * scale * (1 + 0.3 * t)), 1,
                                 255 if depth == 8 else 65535).astype(np.int64)
                      for t in range(2)}
        self.samples = []  # per component: (rows, cols) at its resolution, MCU-padded
        self.coefs = []  # per component: (rows of blocks, cols of blocks, 64) zigzag ints
        for plane, (_, h, v, tq) in zip(planes, comps):
            cw, ch = -(-self.w * h // self.hmax), -(-self.h * v // self.vmax)
            rows, cols = self.mcuy * v * 8, self.mcux * h * 8
            sub = _downsample(plane.astype(np.float64), self.hmax // h if self.hmax % h == 0
                              else 1, self.vmax // v if self.vmax % v == 0 else 1)[:ch, :cw]
            if sub.shape != (ch, cw):
                sub = np.resize(sub, (ch, cw))
            padded = np.pad(sub, ((0, rows - ch), (0, cols - cw)), mode="edge")
            self.samples.append(np.round(padded).astype(np.int64))
            self.coefs.append(_fdct(padded, depth, self.quant[tq]))

    # -- units of a scan

    def _units(self, cis):
        """[(ci, by, bx)] per MCU of a scan over components ``cis``."""
        if len(cis) == 1:
            ci = cis[0]
            _, h, v, _ = self.comps[ci]
            cw, ch = -(-self.w * h // self.hmax), -(-self.h * v // self.vmax)
            return [[(ci, by, bx)] for by in range(-(-ch // 8)) for bx in range(-(-cw // 8))]
        out = []
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                out.append([(ci, my * self.comps[ci][2] + yy, mx * self.comps[ci][1] + xx)
                            for ci in cis for yy in range(self.comps[ci][2])
                            for xx in range(self.comps[ci][1])])
        return out

    def _intervals(self, units):
        n = self.restart or len(units)
        return [units[i:i + n] for i in range(0, len(units), n)]

    # -- file

    def _header(self, sof: int, tables: bool = True) -> bytes:
        out = b"\xff\xd8" + self.markers
        if sof != 0xC3:
            for t, q in self.quant.items():
                if self.depth == 8:
                    out += _segment(0xDB, bytes([t]) + bytes(q[ZZ].tolist()))
                else:
                    out += _segment(0xDB, bytes([0x10 | t]) + struct.pack(">64H", *q[ZZ]))
        if self.restart:
            out += _segment(0xDD, struct.pack(">H", self.restart))
        body = struct.pack(">BHHB", self.depth, self.h, self.w, len(self.comps))
        for cid, h, v, tq in self.comps:
            body += bytes([cid, (h << 4) | v, tq])
        return out + _segment(self.sof or sof, body)

    def _scan_header(self, cis, ss, se, ah, al, tables) -> bytes:
        body = bytes([len(cis)])
        for ci in cis:
            dc, ac = tables[ci]
            body += bytes([self.comps[ci][0], (dc << 4) | ac])
        return _segment(0xDA, body + bytes([ss, se, (ah << 4) | al]))

    def _tables(self):
        """DC/AC table index per component: 0 for the first, 1 for the rest."""
        return [(0 if ci == 0 else 1, 0 if ci == 0 else 1) for ci in range(len(self.comps))]

    def huffman(self) -> bytes:
        """Sequential Huffman (SOF0, or SOF1 at 12 bits), one interleaved scan."""
        tables = self._tables()
        cis = list(range(len(self.comps)))
        units = self._units(cis)
        symbols = []  # per interval: [(kind, table, symbol, extra value, extra bits)]
        freq = {("dc", t): [0] * 256 for t in (0, 1)}
        freq.update({("ac", t): [0] * 256 for t in (0, 1)})
        for chunk in self._intervals(units):
            pred = [0] * len(self.comps)
            syms = []
            for mcu in chunk:
                for ci, by, bx in mcu:
                    zz = self.coefs[ci][by, bx]
                    dt, at = tables[ci]
                    diff = int(zz[0]) - pred[ci]
                    pred[ci] = int(zz[0])
                    s = _category(diff)
                    syms.append(("dc", dt, s, _bits(diff, s), s))
                    run = 0
                    last = max([k for k in range(1, 64) if zz[k]] or [0])
                    for k in range(1, last + 1):
                        v = int(zz[k])
                        if v == 0:
                            run += 1
                            continue
                        while run > 15:
                            syms.append(("ac", at, 0xF0, 0, 0))
                            run -= 16
                        s = _category(v)
                        syms.append(("ac", at, (run << 4) | s, _bits(v, s), s))
                        run = 0
                    if last < 63:
                        syms.append(("ac", at, 0x00, 0, 0))
            symbols.append(syms)
            for kind, t, sym, _, _ in syms:
                freq[(kind, t)][sym] += 1
        codes, dht = {}, b""
        for (kind, t), f in freq.items():
            if not any(f):
                continue
            bits, vals = huffman_table(f)
            codes[(kind, t)] = huffman_codes(bits, vals)
            dht += _segment(0xC4, bytes([(kind == "ac") << 4 | t] + bits + vals))
        out = self._header(0xC1 if self.depth == 12 else 0xC0) + dht
        out += self._scan_header(cis, 0, 63, 0, 0, tables)
        for i, syms in enumerate(symbols):
            bw = BitWriter()
            for kind, t, sym, extra, n in syms:
                code, length = codes[(kind, t)][sym]
                bw.put(code, length)
                if n:
                    bw.put(extra, n)
            out += bw.flush()
            if i + 1 < len(symbols):
                out += bytes([0xFF, 0xD0 + i % 8])
        return out + b"\xff\xd9"

    def _dac(self) -> bytes:
        if not self.dac:
            return b""
        body = b""
        for t, (L, U, K) in self.dac.items():
            body += bytes([t, L | (U << 4), (1 << 4) | t, K])
        return _segment(0xCC, body)

    def _model(self, enc):
        dac = {t: (0, 1, 5) for t in range(4)}
        dac.update(self.dac or {})
        return ArithModel(enc, {t: v[0] for t, v in dac.items()},
                          {t: v[1] for t, v in dac.items()}, {t: v[2] for t, v in dac.items()})

    def _arith_scan(self, cis, ss, se, ah, al, tables, progressive) -> bytes:
        out = self._scan_header(cis, ss, se, ah, al, tables)
        chunks = self._intervals(self._units(cis))
        for i, chunk in enumerate(chunks):
            enc = ArithEncoder()
            model = self._model(enc)
            ctx, pred = [0] * len(self.comps), [0] * len(self.comps)
            for mcu in chunk:
                for ci, by, bx in mcu:
                    zz = self.coefs[ci][by, bx]
                    dt, at = tables[ci]
                    if not progressive:
                        dc = int(zz[0])
                        ctx[ci] = model.dc_diff(dt, ctx[ci], dc - pred[ci])
                        pred[ci] = dc
                        model.ac_band(at, zz, 1, 63, 0)
                    elif ss == 0 and ah == 0:
                        dc = int(zz[0]) >> al
                        ctx[ci] = model.dc_diff(dt, ctx[ci], dc - pred[ci])
                        pred[ci] = dc
                    elif ss == 0:
                        enc.encode(model.fixed, 0, (int(zz[0]) >> al) & 1)
                    elif ah == 0:
                        model.ac_band(at, zz, ss, se, al)
                    else:
                        model.ac_refine(at, zz, ss, se, ah, al)
            out += enc.finish()
            if i + 1 < len(chunks):
                out += bytes([0xFF, 0xD0 + i % 8])
        return out

    def arith(self) -> bytes:
        """Sequential arithmetic coding (SOF9), one interleaved scan."""
        tables = self._tables()
        cis = list(range(len(self.comps)))
        return (self._header(0xC9) + self._dac()
                + self._arith_scan(cis, 0, 63, 0, 0, tables, False) + b"\xff\xd9")

    def arith_progressive(self, script) -> bytes:
        """Progressive arithmetic coding (SOF10) by ``script``."""
        tables = self._tables()
        out = self._header(0xCA) + self._dac()
        for cis, ss, se, ah, al in script:
            out += self._arith_scan(list(cis), ss, se, ah, al, tables, True)
        return out + b"\xff\xd9"

    def lossless(self, predictor: int, pt: int = 0) -> bytes:
        """Lossless Huffman (SOF3) of the samples (1x1 sampling), one
        interleaved scan with ``predictor`` and point transform ``pt``;
        ``restart`` (MCUs) must be whole rows, each interval's first row
        predicted as the image's."""
        assert all(c[1] == c[2] == 1 for c in self.comps)
        n = len(self.comps)
        x = np.stack([s[:self.h, :self.w] >> pt for s in self.samples], -1)
        rows = self.restart // self.w if self.restart else self.h
        assert rows * self.w == (self.restart or self.h * self.w)
        freq = [0] * 256
        chunks = []
        for y0 in range(0, self.h, rows):
            cats = []
            for d in _predict(x[y0:y0 + rows], predictor, self.depth - pt).reshape(-1).tolist():
                d = ((d + 32768) & 0xFFFF) - 32768
                s = 16 if d == -32768 else _category(d)
                freq[s] += 1
                cats.append((s, d))
            chunks.append(cats)
        bits, vals = huffman_table(freq)
        codes = huffman_codes(bits, vals)
        out = self._header(0xC3) + _segment(0xC4, bytes([0] + bits + vals))
        out += self._scan_header(list(range(n)), predictor, 0, 0, pt, [(0, 0)] * n)
        for i, cats in enumerate(chunks):
            bw = BitWriter()
            for s, d in cats:
                code, length = codes[s]
                bw.put(code, length)
                if 0 < s < 16:
                    bw.put(_bits(d, s), s)
            out += bw.flush()
            if i + 1 < len(chunks):
                out += bytes([0xFF, 0xD0 + i % 8])
        return out + b"\xff\xd9"


def _downsample(p, fx, fy):
    h, w = p.shape
    H, W = -(-h // fy) * fy, -(-w // fx) * fx
    p = np.pad(p, ((0, H - h), (0, W - w)), mode="edge")
    return p.reshape(H // fy, fy, W // fx, fx).mean(axis=(1, 3))


_DCT = np.array([[(np.sqrt(1 / 8) if u == 0 else np.sqrt(2 / 8)) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _fdct(padded, depth, quant):
    rows, cols = padded.shape
    b = padded.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3) - (1 << (depth - 1))
    f = _DCT @ b @ _DCT.T
    q = np.round(f.reshape(rows // 8, cols // 8, 64) / quant).astype(np.int64)
    return q[..., ZZ]


def _predict(x, psv, precision):
    """Annex H differences of (h, w, n) samples: the first row from
    2^(P-1) then its left neighbour, the first column from above."""
    x = x.astype(np.int64)
    h, w, _ = x.shape
    pred = np.zeros_like(x)
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[0, :] = ra[0, :]
    pred[0, 0] = 1 << (precision - 1)
    pred[1:, 0] = rb[1:, 0]
    return x - pred


# ------------------------------------------------------------------- helpers

SIMPLE_SCRIPT = [  # libjpeg's jpeg_simple_progression for 3 components
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0),
]


def ycc_planes(h, w, seed=0):
    px = scene(h, w, seed=seed).astype(np.float64)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return [np.clip(p, 0, 255) for p in (y, cb, cr)]


def jfif():
    return _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform):
    return _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


def drop_scans(data: bytes, keep: int) -> bytes:
    """``data`` with only its first ``keep`` scans, then EOI."""
    pos, n = 2, 0
    while True:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        if marker == 0xD9:
            return data
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            if n == keep:
                return data[:pos] + b"\xff\xd9"
            n += 1
            end = pos + 2 + length
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, 0xFF)
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            pos = end
            continue
        pos += 2 + length


def png_bytes(samples: np.ndarray, color: int, depth: int, interlace: bool = False,
              palette=None, filters=(0, 1, 2, 3, 4), trns: bytes = b"") -> bytes:
    """A PNG of (h, w, channels) ``samples`` (integers of ``depth`` bits),
    colour type ``color``; with ``interlace`` the seven Adam7 passes, each
    filtered on its own; row y of a pass takes filters[y % 5]."""
    h, w = samples.shape[:2]
    x = samples.reshape(h, w, -1).astype(np.int64)
    passes = ([(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
               (0, 1, 2, 2), (1, 0, 2, 1)] if interlace else [(0, 0, 1, 1)])
    raw = bytearray()
    for y0, x0, dy, dx in passes:
        sub = x[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub, depth)
        bpp = max(1, sub.shape[2] * depth // 8)
        prev = np.zeros(rows.shape[1], np.int64)
        for i, cur in enumerate(rows.astype(np.int64)):
            f = filters[i % len(filters)]
            left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            if f == 0:
                row = cur
            elif f == 1:
                row = cur - left
            elif f == 2:
                row = cur - prev
            elif f == 3:
                row = cur - (left + prev) // 2
            else:
                p = left + prev - upleft
                pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
                row = cur - np.where((pa <= pb) & (pa <= pc), left,
                                     np.where(pb <= pc, prev, upleft))
            raw += bytes([f]) + (row % 256).astype(np.uint8).tobytes()
            prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                                             0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


def _pack_rows(sub, depth):
    """(h, w, c) samples → (h, stride) bytes of packed big-endian rows."""
    h, w, c = sub.shape
    if depth == 16:
        return sub.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return sub.astype(np.uint8).reshape(h, w * c)
    flat = sub.reshape(h, w * c)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    pad = (-bits.shape[1]) % 8
    return np.packbits(np.pad(bits, ((0, 0), (0, pad))).astype(np.uint8), axis=1)


# --------------------------------------------------------------------- cases

def _writer(kind: str, h: int = 37, w: int = 53, seed: int = 1, **kw) -> "JpegWriter":
    """Component planes and factors of a named layout."""
    layouts = {
        "420": [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
        "444": [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
        "h1v2": [(1, 1, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
        "411": [(1, 4, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
        "1x4": [(1, 1, 4, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
        "mix": [(1, 2, 2, 0), (2, 1, 2, 1), (3, 2, 1, 1)],
        "42": [(1, 4, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)],  # 10 blocks: libjpeg's most
        "gray": [(1, 1, 1, 0)],
        "gray22": [(1, 2, 2, 0)],
    }
    comps = layouts[kind]
    planes = ycc_planes(h, w, seed=seed)[:len(comps)]
    kw.setdefault("markers", jfif() if len(comps) == 3 else b"")
    return JpegWriter(planes, comps, **kw)


@pytest.mark.parametrize("quality", [40, 90])
@pytest.mark.parametrize("sampling", [0, 1, 2, "gray"])
@pytest.mark.parametrize("h,w", [(37, 53), (17, 9), (64, 48)])
def test_progressive_huffman_equals_pil(quality, sampling, h, w, tmp_path):
    img = Image.fromarray(scene(h, w, seed=quality + h))
    if sampling == "gray":
        data = save(img.convert("L"), "JPEG", quality=quality, progressive=True)
    else:
        data = save(img, "JPEG", quality=quality, subsampling=sampling, progressive=True)
    assert b"\xff\xc2" in data
    assert_equals_pil(data, tmp_path)


@pytest.mark.parametrize("opts", [dict(restart_marker_blocks=2), dict(restart_marker_rows=1)])
def test_progressive_huffman_with_restarts_equals_pil(opts, tmp_path):
    data = save(Image.fromarray(scene(50, 70, seed=3)), "JPEG", quality=80, progressive=True,
                **opts)
    assert b"\xff\xd0" in data
    assert_equals_pil(data, tmp_path)


@pytest.mark.parametrize("keep", range(1, 10))
@pytest.mark.parametrize("sampling", [2, "gray"])
def test_progressive_script_stopped_early_is_smoothed_as_pil(keep, sampling, tmp_path):
    """The file's first ``keep`` scans: libjpeg's block smoothing estimates
    the coefficients not yet refined (and, after the DC scans alone, the
    DC too); the full script needs none."""
    img = Image.fromarray(scene(45, 61, seed=7, period=(11.0, 9.0), noise=6.0))
    if sampling == "gray":
        img = img.convert("L")
        data = save(img, "JPEG", quality=85, progressive=True)
    else:
        data = save(img, "JPEG", quality=85, subsampling=sampling, progressive=True)
    assert_equals_pil(drop_scans(data, keep), tmp_path)


@pytest.mark.parametrize("layout", ["420", "444", "gray", "h1v2", "mix"])
@pytest.mark.parametrize("restart", [0, 3])
def test_arithmetic_sequential_equals_pil(layout, restart, tmp_path):
    data = _writer(layout, restart=restart).arith()
    assert b"\xff\xc9" in data
    assert_equals_pil(data, tmp_path)


@pytest.mark.parametrize("dac", [{0: (1, 5, 2), 1: (0, 3, 10)}, {0: (0, 0, 1), 1: (2, 2, 63)}])
def test_arithmetic_conditioning_equals_pil(dac, tmp_path):
    """DAC segments away from the defaults (L, U) = (0, 1), K = 5."""
    data = _writer("420", quality_scale=0.3, dac=dac).arith()
    assert b"\xff\xcc" in data
    assert_equals_pil(data, tmp_path)


@pytest.mark.parametrize("layout,restart,keep", [("420", 0, None), ("444", 2, None),
                                                 ("420", 0, 4), ("gray", 0, None)])
def test_arithmetic_progressive_equals_pil(layout, restart, keep, tmp_path):
    w = _writer(layout, restart=restart, quality_scale=0.5)
    script = SIMPLE_SCRIPT if layout != "gray" else [
        ((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
        ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]
    data = w.arith_progressive(script)
    assert b"\xff\xca" in data
    assert_equals_pil(data if keep is None else drop_scans(data, keep), tmp_path)


@pytest.mark.parametrize("layout", ["h1v2", "411", "1x4", "mix", "42", "gray22"])
def test_sampling_factors_equal_pil(layout, tmp_path):
    """h1v2 fancy upsampling, replication of the other integral ratios."""
    for h, w in ((37, 53), (9, 5)):
        assert_equals_pil(_writer(layout, h, w).huffman(), tmp_path)


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("layout,pt", [("gray", 0), ("rgb", 2), ("123", 0)])
def test_lossless_equals_pil(predictor, layout, pt, tmp_path):
    """SOF3: 3 components without a JFIF marker are RGB to libjpeg-turbo;
    one component's sampling factors change nothing (2x2 as 1x1)."""
    planes = ycc_planes(23, 31, seed=predictor)
    comps = {"gray": [(1, 1, 1, 0)], "rgb": [(82, 1, 1, 0), (71, 1, 1, 1), (66, 1, 1, 1)],
             "123": [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)]}[layout]
    data = JpegWriter(planes[:len(comps)], comps).lossless(predictor, pt)
    assert b"\xff\xc3" in data
    assert_equals_pil(data, tmp_path)
    if layout == "gray":
        sof = data.index(b"\xff\xc3") + 11  # the component's sampling byte
        assert_equals_pil(data[:sof] + b"\x22" + data[sof + 1:], tmp_path)
    # restart intervals of whole rows: each starts its prediction afresh
    data = JpegWriter(planes[:len(comps)], comps, restart=31 * 5).lossless(predictor, pt)
    assert b"\xff\xd0" in data
    assert_equals_pil(data, tmp_path)


def test_cmyk_and_ycck_equal_pil(tmp_path):
    cmyk = scene(33, 41, c=4, seed=3)
    # Pillow's own CMYK file (Adobe marker, transform 0), at two samplings
    for sub in (0, 2):
        assert_equals_pil(save(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=85,
                               subsampling=sub), tmp_path)
    planes = [cmyk[..., i] for i in range(4)]
    comps = [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 1, 1, 0)]
    assert_equals_pil(JpegWriter(planes, comps, markers=adobe(2)).huffman(), tmp_path)  # YCCK
    assert_equals_pil(JpegWriter(planes, comps).huffman(), tmp_path)  # no marker: CMYK
    assert_equals_pil(JpegWriter(planes, [(1, 2, 2, 0)] + comps[1:], markers=adobe(2)).arith(),
                      tmp_path)


def _refusal(data: bytes, tmp_path, name: str, match: str):
    assert pil_refuses(data), "Pillow decodes it: not a refusal"
    (tmp_path / name).write_bytes(data)
    with pytest.raises(ValueError, match=rf"{name.replace('.', chr(92) + '.')}: .*{match}"):
        I.read_image(tmp_path / name)


def test_what_pillow_refuses_raises_naming_the_file(tmp_path):
    w12 = JpegWriter([scene(21, 19, c=1, depth=12)[..., 0]], [(1, 1, 1, 0)], depth=12)
    _refusal(w12.huffman(), tmp_path, "b12.jpg", "12-bit")
    ll = _writer("gray").lossless(1)
    _refusal(ll.replace(b"\xff\xc3", b"\xff\xcb", 1), tmp_path, "ll_arith.jpg",
             "lossless arithmetic")
    for sof in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        _refusal(_writer("420", sof=sof).huffman(), tmp_path, f"sof{sof - 0xC0}.jpg",
                 "hierarchical")
    _refusal(JpegWriter(ycc_planes(37, 53), [(1, 3, 1, 0), (2, 2, 1, 1), (3, 1, 1, 1)],
                        markers=jfif()).huffman(), tmp_path, "frac.jpg", "do not divide")
    _refusal(_writer("444", markers=jfif()).lossless(4), tmp_path, "ll_ycc.jpg", "YCbCr")

    _refusal(JpegWriter(ycc_planes(9, 9)[:2], [(1, 1, 1, 0), (2, 1, 1, 1)]).huffman(), tmp_path,
             "two.jpg", "2-component")
    _refusal(JpegWriter(ycc_planes(37, 53), [(1, 4, 2, 0), (2, 2, 1, 1), (3, 1, 1, 1)],
                        markers=jfif()).huffman(), tmp_path, "mcu11.jpg", "more than 10 blocks")


PNG_CASES = [  # (colour type, bit depth)
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
    (4, 8), (4, 16), (6, 8), (6, 16),
]


def _png_case(color, depth, h, w, seed, interlace):
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    x = scene(h, w, c=ch, seed=seed, depth=depth if color != 3 else 8).astype(np.int64)
    palette = None
    if color == 3:
        x = x % (1 << depth)
        # fewer entries than indices: Pillow reads the missing ones as black
        palette = np.random.RandomState(seed).randint(0, 256, (max(1, (1 << depth) - 3), 3))
    if depth == 16 and w >= 3:
        x[0, :3, 0] = [65535, 300, 0]
    return png_bytes(x, color, depth, interlace, palette)


@pytest.mark.parametrize("color,depth", PNG_CASES)
@pytest.mark.parametrize("interlace", [False, True])
def test_png_every_colour_type_and_depth_equals_pil(color, depth, interlace, tmp_path):
    """16-bit gray opens as Pillow's I;16 and clamps to 255; the other
    16-bit types keep the high byte; gray of 1/2/4 bits is scaled."""
    for h, w, seed in ((13, 17, 1), (1, 1, 2), (3, 9, 3), (9, 2, 4)):
        assert_equals_pil(_png_case(color, depth, h, w, seed, interlace), tmp_path, "x.png")


# ------------------------------------------------------------------ fixtures

def fixture_bytes():
    """name → bytes of the committed fixtures (a few KB each), the BMP,
    GIF, TIFF and WebP ones of ``test_torch_image_containers.py`` too."""
    from test_torch_image_containers import container_fixture_bytes

    img = Image.fromarray(scene(375, 500, seed=10, period=(23.0, 17.0), noise=3.0))
    small = Image.fromarray(scene(45, 61, seed=7, period=(11.0, 9.0), noise=6.0))
    prog = save(small, "JPEG", quality=85, progressive=True)
    cmyk = scene(33, 41, c=4, seed=3)
    planes = [cmyk[..., i] for i in range(4)]
    comps4 = [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 1, 1, 0)]
    return {
        "flickr420_q50_prog.jpg": save(img, "JPEG", quality=50, subsampling=2,
                                       progressive=True),
        "prog420_q85.jpg": prog,
        "prog420_q85_3scans.jpg": drop_scans(prog, 3),
        "prog420_q85_1scan.jpg": drop_scans(prog, 1),
        "arith420_rst.jpg": _writer("420", restart=3).arith(),
        "arith_prog444_dac.jpg": _writer("444", quality_scale=0.5, dac={0: (1, 5, 2)})
        .arith_progressive(SIMPLE_SCRIPT),
        "lossless_rgb_p5.jpg": JpegWriter(ycc_planes(23, 31, seed=5),
                                          [(82, 1, 1, 0), (71, 1, 1, 1), (66, 1, 1, 1)])
        .lossless(5, 1),
        "cmyk_adobe.jpg": save(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=85),
        "ycck.jpg": JpegWriter(planes, comps4, markers=adobe(2)).huffman(),
        "h1v2.jpg": _writer("h1v2").huffman(),
        "s411.jpg": _writer("411").huffman(),
        "adam7_rgba16.png": _png_case(6, 16, 21, 19, 5, True),
        "adam7_p4.png": _png_case(3, 4, 21, 19, 6, True),
        "gray16.png": _png_case(0, 16, 15, 11, 7, False),
        "gray1.png": _png_case(0, 1, 15, 11, 8, False),
        "gray2_adam7.png": _png_case(0, 2, 15, 11, 9, True),
        "gray4.png": _png_case(0, 4, 15, 11, 10, False),
        **container_fixture_bytes(),
    }


def make_fixtures(out_dir: Path = FORMATS) -> None:
    """Write the fixtures, each beside Pillow's pixels."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, data in fixture_bytes().items():
        (out_dir / name).write_bytes(data)
        np.save(out_dir / (Path(name).stem + ".npy"), pil_rgb(data))


def test_fixtures_equal_pil():
    """The committed fixtures: as :func:`fixture_bytes` writes them, Pillow's
    pixels as committed, and the port's."""
    made = fixture_bytes()
    names = sorted(p.name for p in FORMATS.iterdir() if p.suffix != ".npy")
    assert names == sorted(made)
    for name in names:
        data = (FORMATS / name).read_bytes()
        assert data == made[name], name
        assert len(data) <= 16_000, name
        want = np.load(FORMATS / (Path(name).stem + ".npy"))
        np.testing.assert_array_equal(pil_rgb(data), want, err_msg=name)
        np.testing.assert_array_equal(I.read_image(FORMATS / name), want, err_msg=name)


def test_port_imports_no_pillow_to_decode():
    """``data/image_io.py`` and ``data/jpeg.py`` import numpy only."""
    import ast

    for mod in (I, sys.modules["mm_s2ut_torch.data.jpeg"]):
        tree = ast.parse(Path(mod.__file__).read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, (ast.Import, ast.ImportFrom))
                 for a in (n.names if isinstance(n, ast.Import) else [ast.alias(n.module or "")])}
        assert "PIL" not in names, mod.__file__


if __name__ == "__main__":
    make_fixtures(Path(sys.argv[1]) if len(sys.argv) > 1 else FORMATS)
