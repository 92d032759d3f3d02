"""JPEG decoding on the host without Pillow (numpy and Python only).

What Pillow 12 gives for a JPEG through libjpeg-turbo's defaults
(``np.asarray(Image.open(path).convert("RGB"))``), for every JPEG it
opens:

* frames: sequential (SOF0/SOF1) and progressive (SOF2) Huffman,
  sequential (SOF9) and progressive (SOF10) arithmetic coding, lossless
  Huffman (SOF3), all at 8-bit precision, with 1, 3 or 4 components (a
  TIFF strip's 2 too, through :func:`decode_jpeg_samples`, which gives the
  samples as stored) and
  restart intervals (lossless with 1x1 sampling only where several
  components are interleaved: those alone raise without Pillow's word). Pillow refuses other precisions (its frame parser
  takes 8 bits only) and libjpeg-turbo refuses hierarchical frames
  (SOF5-7, SOF13-15) and lossless arithmetic coding (SOF11): each raises
  ``ValueError`` naming the file here.
* progressive scans (``jdphuff.c``, ``jdarith.c``): DC first and
  refinement, AC first with end-of-band runs and AC refinement with
  correction bits, the coefficients accumulated over the scans; where the
  scans leave low AC coefficients unrefined, libjpeg's block smoothing
  (``jdcoefct.c`` ``decompress_smooth_data``: estimates from a 5 x 5
  neighbourhood of DC values, and of the DC itself while no AC data has
  come) fills them before the IDCT.
* arithmetic coding: the QM decoder of ITU T.81 Annex D as ``jdarith.c``
  runs it, with the DAC conditioning (L, U of each DC table, K of each
  AC table; defaults 0, 1, 5).
* lossless: Annex H's predictors 1-7 with point transform, undifferenced
  modulo 2^16 and shifted back (``jdpred.c``, ``jdlossls.c``). libjpeg-turbo
  converts no colour space in lossless mode: 3 components read as RGB
  unless a JFIF or Adobe marker says YCbCr, which it refuses.
* corrupt data, as libjpeg-turbo reads it where Pillow gets an image: a
  bit pattern that starts no Huffman code is 17 bits and symbol 0, a
  coefficient past 63 lands on 63, and once an MCU has read past its
  interval's data (zero bits) the rest of the interval stays as it was; a
  lossless scan reads the rest of that row of MCUs from zero bits, and
  each later row of the interval is zero differences from a reset
  undifferencer (``jdlhuff.c``). An arithmetic-coded magnitude or AC index
  past its bound (``JWRN_ARITH_BAD_CODE``) stops the interval there: its
  later MCUs keep their coefficients; data that runs into a marker is zero
  bytes to the QM decoder. 0xFF bytes before a 0x00 are one data byte,
  before a marker none; any marker ends a segment of entropy data. Where
  a restart is due, the marker after the segment is taken as
  ``jpeg_resync_to_restart`` takes it: the expected RSTn, one far from it,
  is read and the next segment decoded; a marker below SOF0 or one of the
  two restarts before the expected one is skipped with the data after it;
  any other marker, or one of the next two restarts, is left unread, so
  the interval decodes no data (zero bits: a Huffman interval whose data
  had run out stays as it was). The markers libjpeg stops at are refused
  (reserved ones, a second SOI, bad DHT, DQT, DRI, DAC and SOS lengths or
  indices, a DC table symbol past 15, a Huffman code that overflows, a
  progressive scan whose Al is not Ah - 1), and a baseline image is whole
  after its one scan of every component: the markers after it are read
  only until the data runs out (no EOI needed), as Pillow's decoder stops
  there.
* samples: the "islow" IDCT (``jidctint.c``) as libjpeg-turbo's x86-64
  SIMD code computes it (16-bit lanes, which only corrupt data overflows)
  with its range limit; fancy
  upsampling for 2:1 horizontal, 2:1 vertical and 2:2 ratios
  (``jdsample.c`` ``h2v1``/``h1v2``/``h2v2_fancy_upsample``), replication
  for other integral ratios (``int_upsample``), libjpeg's error
  otherwise; fixed-point YCbCr → RGB (``jdcolor.c``), YCCK → CMYK, and a
  4-component image as Pillow takes it: inverted (``CMYK;I``), then its
  CMYK → RGB (k' = 255 − K, c = k' − c·k'/255 rounded as ``MULDIV255``).

The IDCT, smoothing, upsampling and colour conversion are vectorised over
whole images; the entropy decoders are Python loops over the symbols.
"""
from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])  # zigzag position → natural (row-major) position

_HIERARCHICAL = {0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF}
_FRAMES = {0xC0: "huffman", 0xC1: "huffman", 0xC2: "huffman", 0xC3: "lossless",
           0xC9: "arith", 0xCA: "arith"}


def _refuse(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what} is not decoded (Pillow refuses it too)")


# ------------------------------------------------------------------ Huffman

def _huffman_table(counts: Sequence[int], symbols: Sequence[int]) -> Tuple[List[int], bool]:
    """Canonical Huffman code → a 65536-entry lookup over the next 16 bits:
    ``symbol | length << 8`` (0 where no code starts), and whether the code
    overflows (a length's codes past its all-ones code: libjpeg's
    ``jpeg_make_d_derived_tbl`` refuses the table when a scan uses it)."""
    lut = np.zeros(1 << 16, np.int64)
    code, k, overflow = 0, 0, False
    used = [n for n in range(1, 17) if counts[n - 1]]
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo: lo + (1 << (16 - length))] = symbols[k] | (length << 8)
            code += 1
            k += 1
        overflow |= bool(used) and used[0] <= length <= used[-1] and code >= 1 << length
        code <<= 1
    return lut.tolist(), overflow


# zero windows past a segment's end, added once an MCU could read past its data: enough
# for one MCU of 10 blocks read from zero bits (each coefficient at most a 17-bit code
# and 15 bits)
_PAD = [0] * (10 * 64 * 32 // 8)


def _unstuff(seg: bytes) -> Tuple[List[int], int]:
    """Entropy-coded bytes (0xFF 0x00, or several 0xFF then 0x00, → 0xFF, as
    libjpeg reads them), then each byte's 24-bit window (it and the next
    two), zero-padded past the end as libjpeg pads; and the number of bits
    the segment holds."""
    raw = re.sub(b"\xff+\x00", b"\xff", seg)
    b = np.frombuffer(raw + b"\x00" * 4, np.uint8).astype(np.int64)
    return ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist(), 8 * len(raw)


def _room(win: List[int], p: int, end: int) -> bool:
    """Whether an MCU may start at bit ``p``: not once bits past the data were
    read (libjpeg's ``insufficient_data``); the zero windows are added where
    this MCU could read past the data."""
    if p > end:
        return False
    if p + 8 * len(_PAD) > end and len(win) < end // 8 + len(_PAD):
        win.extend(_PAD)
    return True


class _Bits:
    """A Huffman scan segment: symbols through a lookup table, raw bits. A
    bit pattern that starts no code is libjpeg's bad code: 17 bits read,
    symbol 0 (``jpeg_huff_decode``)."""

    def __init__(self, seg: bytes, name: str, pad: int = 0):
        (self.win, self.end), self.p, self.name = _unstuff(seg), 0, name
        self.win.extend([0] * pad)  # zero windows for reads past the data

    def room(self) -> bool:
        """:func:`_room` at the reader's bit."""
        return _room(self.win, self.p, self.end)

    def symbol(self, lut: List[int]) -> int:
        p = self.p
        e = lut[(self.win[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
        self.p = p + (e >> 8 if e else 17)
        return e & 0xFF

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.p
        self.p = p + n
        return ((self.win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - n)

    def extend(self, s: int) -> int:
        v = self.bits(s)
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _wrap16(v):
    """``v`` (an int or an int64 array) as a JCOEF or a 16-bit SIMD lane holds it."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _huffman_sequential(seg, mcus, coefs, ncomp, short) -> bool:
    """One restart interval of a sequential scan: ``mcus`` lists the MCUs,
    each a list of (component, block offset, DC table, AC table);
    coefficients land in zigzag order. As libjpeg's ``decode_mcu``: a bad
    code reads 17 bits as symbol 0; once an MCU has read past the data
    (``short``: before the interval, where its restart marker was left
    unread), the rest of the interval stays zero. Returns whether it read
    past the data (libjpeg's ``insufficient_data``)."""
    if short:
        return True
    win, end = _unstuff(seg)
    p = 0
    preds = [0] * ncomp
    for mcu in mcus:
        if not _room(win, p, end):
            return True
        for c, base, dc, ac in mcu:
            w = (win[p >> 3] >> (8 - (p & 7))) & 0xFFFF
            e = dc[w]
            p += e >> 8 if e else 17
            s = e & 0xFF
            diff = 0
            if s:
                diff = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                p += s
                if diff < (1 << (s - 1)):
                    diff -= (1 << s) - 1
            preds[c] += diff
            out = coefs[c]
            out[base] = _wrap16(preds[c])
            k = 1
            while k < 64:
                w = (win[p >> 3] >> (8 - (p & 7))) & 0xFFFF
                e = ac[w]
                p += e >> 8 if e else 17
                rs = e & 0xFF
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = ((win[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                    p += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    out[base + min(k, 63)] = v  # past 63: jpeg_natural_order's extra entries
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
    return p > end


def _huffman_progressive(seg, mcus, coefs, ss, se, ah, al, short,
                         name) -> Tuple[bool, int]:
    """One restart interval of a progressive Huffman scan (``jdphuff.c``);
    once an MCU has read past the data (or ``short``), the rest of the
    interval is left as it was (a DC refinement reads on, zeros that change
    nothing). Returns whether it read past the data, and the number of MCUs
    it started before that."""
    bits = _Bits(seg, name)
    if ss == 0 and ah:  # DC refinement: one bit of every block of the MCU
        p1 = 1 << al
        for j, mcu in enumerate(mcus):
            for c, base, _, _ in mcu:
                if bits.p >= bits.end:
                    return True, j + 1
                if bits.bits(1):
                    coefs[c][base] |= p1
        return False, len(mcus)
    if short:
        return True, 0
    if ss == 0:  # DC first: every block of the (possibly interleaved) MCU
        preds: Dict[int, int] = {}
        for j, mcu in enumerate(mcus):
            if not bits.room():
                return True, j
            for c, base, dc, _ in mcu:
                preds[c] = preds.get(c, 0) + bits.extend(bits.symbol(dc))
                coefs[c][base] = _wrap16(preds[c] << al)
        return bits.p > bits.end, len(mcus)
    eobrun = 0
    p1, m1 = 1 << al, -1 << al
    for j, ((c, base, _, ac),) in enumerate(mcus):  # one block per MCU
        if not bits.room():
            return True, j
        out = coefs[c]
        if ah == 0:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                rs = bits.symbol(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    out[base + min(k, 63)] = _wrap16(bits.extend(s) << al)
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + bits.bits(r) - 1
                    break
                k += 1
            continue
        k = ss
        if eobrun == 0:
            while k <= se:
                rs = bits.symbol(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if bits.bits(1) else m1
                elif r != 15:
                    eobrun = (1 << r) + bits.bits(r)
                    break
                while k <= se:
                    v = out[base + k]
                    if v:
                        if bits.bits(1) and not v & p1:
                            out[base + k] = v + (p1 if v >= 0 else m1)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    out[base + min(k, 63)] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                v = out[base + k]
                if v and bits.bits(1) and not v & p1:
                    out[base + k] = v + (p1 if v >= 0 else m1)
                k += 1
            eobrun -= 1
    return bits.p > bits.end, len(mcus)


# --------------------------------------------------------------- arithmetic

# Table D.2 (libjpeg's jaricom.c) packed as jdarith.c reads it: Qe << 16 |
# Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS.
_QE = [(q << 16) | (nm << 8) | (sw << 7) | nl for q, nl, nm, sw in [
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
]]


class _BadCode(Exception):
    """``JWRN_ARITH_BAD_CODE``: ``jdarith.c`` sets ``ct`` to -1, and the rest
    of the restart interval decodes nothing."""


class _Arith:
    """The QM decoder over one restart interval's bytes (``jdarith.c``
    ``arith_decode``): past the end, zeros."""

    def __init__(self, seg: bytes):
        self.data = re.sub(b"\xff+\x00", b"\xff", seg)
        self.pos, self.c, self.a, self.ct = 0, 0, 0, -16

    def decode(self, st: List[int], i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                data = self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
                self.c = (self.c << 8) | data
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = st[i]
        qe = _QE[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:  # the upper interval: the LPS, or the MPS exchanged into it
            self.c -= temp
            if self.a < qe:
                self.a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7


def _arith_dc(dec: _Arith, st: List[int], ctx: int, L: int, U: int) -> Tuple[int, int]:
    """A DC difference in context ``ctx`` (Figures F.19-F.24) → (v, next context)."""
    if dec.decode(st, ctx) == 0:
        return 0, 0
    sign = dec.decode(st, ctx + 1)
    i = ctx + 2 + sign
    m = dec.decode(st, i)
    if m:
        i = 20
        while dec.decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise _BadCode  # magnitude overflow
            i += 1
    if m < (1 << L) >> 1:
        nxt = 0
    elif m > (1 << U) >> 1:
        nxt = 12 + sign * 4
    else:
        nxt = 4 + sign * 4
    v = m
    i += 14
    while m > 1:
        m >>= 1
        if dec.decode(st, i):
            v |= m
    v += 1
    return (-v if sign else v), nxt


def _arith_ac_value(dec: _Arith, st: List[int], i: int, k: int, K: int) -> int:
    """|v| of a nonzero AC coefficient from its SP bin ``i`` (Figure F.23/24)."""
    m = dec.decode(st, i)
    if m:
        if dec.decode(st, i):
            m <<= 1
            i = 189 if k <= K else 217
            while dec.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _BadCode  # magnitude overflow
                i += 1
    v = m
    i += 14
    while m > 1:
        m >>= 1
        if dec.decode(st, i):
            v |= m
    return v + 1


def _arith_scan(seg, units, coefs, ss, se, ah, al, progressive, dc_stats, ac_stats, dac_l,
                dac_u, dac_k) -> None:
    """One restart interval of an arithmetic-coded scan (``jdarith.c``
    ``decode_mcu`` and its four progressive forms); ``units`` lists
    (component, block offset, DC table, AC table). Statistics start at 0; a
    bad code ends the interval, the blocks before it as decoded."""
    try:
        _arith_units(seg, units, coefs, ss, se, ah, al, progressive, dc_stats, ac_stats, dac_l,
                     dac_u, dac_k)
    except _BadCode:
        pass


def _arith_units(seg, units, coefs, ss, se, ah, al, progressive, dc_stats, ac_stats, dac_l,
                 dac_u, dac_k) -> None:
    dec = _Arith(seg)
    fixed = [113]  # the fixed probability 0.5 of signs and DC refinement bits
    dcs = {t: [0] * 64 for t in dc_stats}
    acs = {t: [0] * 256 for t in ac_stats}
    ctx: Dict[int, int] = {}
    last: Dict[int, int] = {}
    first_dc = not progressive or (ss == 0 and ah == 0)
    for c, base, dt, at in units:
        out = coefs[c]
        if first_dc:
            v, ctx[c] = _arith_dc(dec, dcs[dt], ctx.get(c, 0), dac_l[dt], dac_u[dt])
            last[c] = (last.get(c, 0) + v) & 0xFFFF
            out[base] = _wrap16(last[c] << al)
            if progressive:
                continue
        elif ss == 0:
            if dec.decode(fixed, 0):
                out[base] |= 1 << al
            continue
        if not progressive or ah == 0:
            _arith_ac_first(dec, acs[at], fixed, out, base, ss or 1, se, al, dac_k[at])
        else:
            _arith_ac_refine(dec, acs[at], fixed, out, base, ss, se, al)


def _arith_ac_first(dec, st, fixed, out, base, ss, se, al, K) -> None:
    """Figure F.20: the band [ss, se] of one block (``decode_mcu_AC_first``;
    the sequential AC with ss 1, se 63, al 0)."""
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if dec.decode(st, i):
            break
        while dec.decode(st, i + 1) == 0:
            i += 3
            k += 1
            if k > se:
                raise _BadCode  # spectral overflow
        sign = dec.decode(fixed, 0)
        v = _arith_ac_value(dec, st, i + 2, k, K)
        out[base + k] = _wrap16((-v if sign else v) << al)
        k += 1


def _arith_ac_refine(dec, st, fixed, out, base, ss, se, al) -> None:
    """``decode_mcu_AC_refine``: a correction bit for each coefficient
    already nonzero, new ones of ±2^al, until the end of band."""
    p1, m1 = 1 << al, -1 << al
    kex = 0
    for k in range(se, 0, -1):
        if out[base + k]:
            kex = k
            break
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex and dec.decode(st, i):
            break
        while True:
            v = out[base + k]
            if v:
                if dec.decode(st, i + 2):
                    out[base + k] = v + (m1 if v < 0 else p1)
                break
            if dec.decode(st, i + 1):
                out[base + k] = m1 if dec.decode(fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > se:
                raise _BadCode  # spectral overflow
        k += 1


# ----------------------------------------------------------------- lossless

def _lossless_scan(seg, mcus, width, diffs, short, name) -> Tuple[bool, List[int]]:
    """One restart interval of a lossless Huffman scan (``jdlhuff.c``
    ``decode_mcus``, a row of ``width`` MCUs a call): ``mcus`` lists the
    MCUs, each a list of (component, flat sample index, table); differences
    land in ``diffs``. A row whose call starts with the data run out (or
    ``short``) is zero differences, and libjpeg resets the undifferencer
    there; the row that runs out reads on from zero bits. Returns whether
    the data ran out, and the rows of the interval decoded as reset."""
    bits = _Bits(seg, name, pad=width * len(mcus[0]) * 33 // 8 + 8)
    reset = []
    for r in range(0, len(mcus), width):
        if short:
            reset.append(r // width)
            for c, idx, _ in (u for mcu in mcus[r: r + width] for u in mcu):
                diffs[c][idx] = 0
            continue
        for mcu in mcus[r: r + width]:
            for c, idx, tab in mcu:
                s = bits.symbol(tab)
                diffs[c][idx] = 32768 if s == 16 else bits.extend(s)
        short = bits.p > bits.end
    return short, reset


def _undifference(d: np.ndarray, psv: int, precision: int, first: np.ndarray) -> np.ndarray:
    """``jdpred.c``: (h, w) differences → samples modulo 2^16; a first row
    (``first[y]``: the image's, each restart interval's, and each row libjpeg
    reset the undifferencer for) from 2^(P-1) then its left neighbour, the
    first column of the others from above."""
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        row = d[y]
        if first[y]:
            acc = np.cumsum(row) + (1 << (precision - 1))
            out[y] = acc & 0xFFFF
            continue
        rb = out[y - 1]
        if psv in (2, 3):  # no left neighbour in the predictor
            pred = rb if psv == 2 else np.concatenate([rb[:1], rb[:-1]])
            out[y] = (row + pred) & 0xFFFF
            continue
        cur = out[y]
        rbl, rcl, rowl = rb.tolist(), [0] + rb.tolist()[:-1], row.tolist()
        ra = (rowl[0] + rbl[0]) & 0xFFFF
        vals = [ra]
        for x in range(1, w):
            b, c = rbl[x], rcl[x]
            if psv == 1:
                p = ra
            elif psv == 4:
                p = ra + b - c
            elif psv == 5:
                p = ra + ((b - c) >> 1)
            elif psv == 6:
                p = b + ((ra - c) >> 1)
            else:
                p = (ra + b) >> 1
            ra = (rowl[x] + p) & 0xFFFF
            vals.append(ra)
        cur[:] = vals
    return out


# --------------------------------------------------------------------- IDCT

# jidctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x · 2^13).
_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
      "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
      "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(c: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of ``jpeg_idct_islow`` over 8 int64 vectors (the inputs at
    positions 0..7), descaled by ``shift`` bits with rounding. The sums the
    x86-64 SIMD code forms in 16-bit lanes (in0 ± in4, in7 + in3, in5 + in1)
    wrap as there; the rest is exact, as its products and sums in 32 bits."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 + z3 * -_F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = _wrap16(c[0] + c[4]) << 13
    tmp1 = _wrap16(c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, _wrap16(t0 + t2), _wrap16(t1 + t3)
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


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients, (64,) quantization table →
    (N, 8, 8) uint8 samples, as libjpeg-turbo's ``jpeg_idct_islow`` on
    x86-64 (``jidctint-avx2.asm``, which Pillow's libjpeg-turbo runs): equal
    to ``jidctint.c`` wherever no 16-bit lane overflows, which only corrupt
    data makes happen. Dequantized in 16 bits (a product wraps), a block
    whose rows 1-7 are zero takes pass 1's shortcut (the row shifted in 16
    bits), pass 1's outputs saturate to 16 bits, pass 2's to 0..255."""
    c = coefs.astype(np.int64).reshape(-1, 8, 8)
    d = _wrap16(c * quant.astype(np.int64).reshape(8, 8)[None])
    # Pass 1: columns (input row k of each column), descale to PASS1_BITS.
    cols = _idct_1d([d[:, k, :] for k in range(8)], 13 - 2)
    ws = np.clip(np.stack(cols, axis=1), -0x8000, 0x7FFF)  # (N, 8 rows, 8 cols)
    dc_only = ~c[:, 1:, :].any(axis=(1, 2))
    if dc_only.any():
        ws[dc_only] = _wrap16(d[dc_only, :1, :] << 2)
    # Pass 2: rows, descale by CONST_BITS + PASS1_BITS + 3.
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3)
    out = np.stack(rows, axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


# ---------------------------------------------------------- block smoothing

# (zigzag k, the 5 x 5 DC weights with DC interpolation, without) of
# jdcoefct.c's estimates; rows are the block rows r-2..r+2, columns c-2..c+2.
_W = {
    1: ([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
         [-1, -1, 0, 1, 1]],
        [[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5]),
    2: ([[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5, [1, -13, -38, -13, 1],
         [1, 3, 3, 3, 1]],
        [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0] * 5, [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]]),
    3: ([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
        [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]]),
    4: ([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
        [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]),
    5: ([[0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0] * 5],
        [[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5]),
    6: ([[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5], None),
    7: ([[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5], None),
    8: ([[0] * 5, [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0] * 5], None),
    9: ([[0] * 5, [0, 1, 2, 1, 0], [0] * 5, [0, -1, -2, -1, 0], [0] * 5], None),
}
_W_DC = [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
         [-2, -6, -8, -6, -2]]


def _smooth(zz: np.ndarray, bits: List[int], q: np.ndarray, hb: int, wb: int, v: int,
            imcu_rows: int) -> np.ndarray:
    """``decompress_smooth_data`` on one component's (rows, cols, 64)
    zigzag coefficients: estimates of the first nine AC coefficients
    still zero and not fully known (``bits`` = coef_bits, the bits still
    unknown, -1 for none seen), and of the DC while no AC data has come;
    on the blocks [0, hb) x [0, wb), from the unsmoothed DC values of the
    5 x 5 neighbourhood (columns clamped to the component's blocks, rows
    by libjpeg's iMCU-row rules)."""
    out = zz.copy()
    dc = zz[..., 0].astype(np.int64)
    change_dc = all(b == -1 for b in bits[1:10])
    cols = np.clip(np.arange(wb)[:, None] + np.arange(-2, 3)[None, :], 0, wb - 1)  # (wb, 5)
    rows = np.zeros((hb, 5), np.int64)
    for r in range(hb):
        i, br = divmod(r, v)
        block_rows = v if i < imcu_rows - 1 else (hb % v or v)
        ibr, ibrs = i * block_rows + br, block_rows * imcu_rows
        prev = r - 1 if ibr > 0 else r
        nxt = r + 1 if ibr < ibrs - 1 else r
        rows[r] = [r - 2 if ibr > 1 else prev, prev, r, nxt, r + 2 if ibr < ibrs - 2 else nxt]
    win = dc[rows[:, :, None, None], cols[None, None, :, :]]  # (hb, 5, wb, 5)
    win = win.transpose(0, 2, 1, 3)  # (hb, wb, 5 rows, 5 cols)
    q00 = int(q[0])
    for k in range(1, 10):
        al = bits[k]
        weights = _W[k][0] if change_dc else _W[k][1]
        if al == 0 or weights is None:
            continue
        qk = int(q[ZIGZAG[k]])
        num = q00 * np.einsum("ijrc,rc->ij", win, np.asarray(weights, np.int64))
        pred = (np.abs(num) + (qk << 7)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        cur = out[:hb, :wb, k]
        out[:hb, :wb, k] = np.where(cur == 0, pred, cur)
    if change_dc:
        num = q00 * np.einsum("ijrc,rc->ij", win, np.asarray(_W_DC, np.int64))
        pred = (np.abs(num) + (q00 << 7)) // (q00 << 8)
        out[:hb, :wb, 0] = np.where(num >= 0, pred, -pred)
    return out


# --------------------------------------------------------------- upsampling

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


def _upsample(plane: np.ndarray, hr: int, vr: int, dw: int, dh: int) -> np.ndarray:
    """A plane (decoded, block-padded) → full resolution, as libjpeg-turbo's
    ``jdsample.c`` with ``do_fancy_upsampling``: ``dw``, ``dh`` the
    component's own width and height (``downsampled_width``), (``hr``,
    ``vr``) its integral ratios to the largest sampling factors."""
    p = plane.astype(np.int64)
    if (hr, vr) == (1, 1):
        return p
    above = np.concatenate([p[:1], p[:dh - 1]], axis=0)[:dh]
    below = np.concatenate([p[1:dh], p[dh - 1:dh]], axis=0)
    if (hr, vr) == (2, 1) and dw > 2:
        return _fancy_h(p, dw, 1, 2, 3, 2)
    if (hr, vr) == (1, 2):
        out = np.empty((2 * dh, p.shape[1]), np.int64)
        out[0::2] = (3 * p[:dh] + above + 1) >> 2
        out[1::2] = (3 * p[:dh] + below + 2) >> 2
        return out
    if (hr, vr) == (2, 2) and dw > 2:
        p = p[:dh]
        out = np.empty((2 * dh, 2 * dw), np.int64)
        out[0::2] = _fancy_h(3 * p + above, dw, 8, 7, 3, 4)
        out[1::2] = _fancy_h(3 * p + below, dw, 8, 7, 3, 4)
        return out
    return np.repeat(np.repeat(p, vr, axis=0), hr, axis=1)  # int_upsample (and h2v1/h2v2 plain)


# ------------------------------------------------------------------- colour

def _fix(v: float) -> int:
    return int(v * (1 << 16) + 0.5)


def _ycc(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> List[np.ndarray]:
    """``jdcolor.c``'s YCbCr → RGB before its range limit: 16-bit fixed
    point, rounded table entries."""
    one_half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-_fix(0.34414) * cb + one_half - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.77200) * cb + one_half) >> 16)
    return [r, g, b]


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def _cmyk_to_rgb(cmyk: List[np.ndarray]) -> np.ndarray:
    """libjpeg's CMYK samples as Pillow reads them (``CMYK;I``: inverted),
    then Pillow's ``convert("RGB")``."""
    c, m, y, k = (255 - x for x in cmyk)
    nk = 255 - k
    return np.clip(np.stack([nk - _muldiv255(x, nk) for x in (c, m, y)], -1), 0, 255)


# -------------------------------------------------------------------- frame

class _Frame:
    def __init__(self, marker: int, body: bytes, name: str, counts: Sequence[int] = (1, 3, 4)):
        self.precision, self.height, self.width, ncomp = struct.unpack(">BHHB", body[:6])
        if self.precision != 8:
            raise _refuse(name, f"a {self.precision}-bit JPEG")
        if ncomp not in counts:
            raise _refuse(name, f"a {ncomp}-component JPEG")
        if self.height == 0 or self.width == 0:
            raise ValueError(f"{name}: JPEG of {self.width}x{self.height} pixels")
        self.coding = _FRAMES[marker]
        self.progressive = marker in (0xC2, 0xCA)
        self.comps = [(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                       body[8 + 3 * k]) for k in range(ncomp)]
        if any(not (1 <= h <= 4 and 1 <= v <= 4) for _, h, v, _ in self.comps):
            raise _refuse(name, "a JPEG with sampling factors outside 1..4")
        self.hmax = max(c[1] for c in self.comps)
        self.vmax = max(c[2] for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        if self.coding == "lossless":
            if ncomp == 1:  # one component: one sample per MCU whatever its factors
                self.comps = [(self.comps[0][0], 1, 1, self.comps[0][3])]
                self.hmax = self.vmax = 1
            elif any((h, v) != (1, 1) for _, h, v, _ in self.comps):
                raise ValueError(f"{name}: a lossless JPEG with sampling factors other than "
                                 "1x1 in several components is not decoded")
            n = self.width * self.height
            self.diffs = [[0] * n for _ in self.comps]
            self.samples: List[Optional[np.ndarray]] = [None] * ncomp
        else:
            self.coefs = [[0] * (self.mcuy * v * self.mcux * h * 64)
                          for _, h, v, _ in self.comps]
        self.coef_bits = [[-1] * 64 for _ in self.comps]
        # coef_bits[1..9] before each component's latest scan, the number of
        # scans, and the last iMCU row of the last scan an MCU of which
        # started with data left (libjpeg-turbo's last_good_iMCU_row)
        self.prev_bits = [[0] * 10 for _ in self.comps]
        self.scans, self.last_good = 0, 0
        self.quant: List[Optional[np.ndarray]] = [None] * ncomp  # latched at a first scan

    def comp_size(self, ci: int) -> Tuple[int, int]:
        _, h, v, _ = self.comps[ci]
        return -(-self.width * h // self.hmax), -(-self.height * v // self.vmax)


def decode_jpeg(data: bytes, name: str = "<jpeg>", cmyk_as_stored: bool = False) -> np.ndarray:
    """Any JPEG Pillow decodes → its RGB uint8 pixels (module docstring).
    ``cmyk_as_stored``: a 4-component image's samples taken as CMYK whatever
    its Adobe transform says (Pillow's ``jpegmode`` ``CMYK``, which Pillow's
    BLP plugin sets), so a YCCK one is not converted."""
    return _assemble(*_parse(data, name), name, cmyk_as_stored)


def decode_jpeg_components(data: bytes, name: str = "<jpeg>"):
    """A lossy JPEG's components as libjpeg's raw-data interface gives them
    (``jpeg_read_raw_data``): each one's IDCT output at its own resolution,
    cropped to its size, not upsampled or colour-converted. Returns
    [(plane int64, (h, v))]."""
    frame = _parse(data, name)[0]
    if frame.coding == "lossless":
        raise _refuse(name, "a lossless JPEG's raw components")
    out = []
    for ci, (plane, (_, h, v, _)) in enumerate(zip(_idct_planes(frame, name), frame.comps)):
        cw, ch = frame.comp_size(ci)
        out.append((plane[:ch, :cw].astype(np.int64), (h, v)))
    return out


def decode_jpeg_samples(data: bytes, components: int, name: str = "<jpeg>") -> np.ndarray:
    """A JPEG of ``components`` components, each sampled 1x1, as libjpeg gives
    it with no colour conversion (``JCS_UNKNOWN`` in and out, as libtiff's
    JPEG codec asks for everything but YCbCr): (H, W, components) uint8, the
    samples as stored. A TIFF strip of gray and alpha has 2 components, one
    of RGBA or CMYK 4; libjpeg-turbo finds no component past the fourth in a
    scan, so 5 or more (CMYK with extra samples) are refused, as Pillow
    refuses them."""
    frame = _parse(data, name, (components,) if components <= 4 else ())[0]
    if any((h, v) != (1, 1) for _, h, v, _ in frame.comps):
        raise ValueError(f"{name}: JPEG sampling factors other than 1x1 in a JPEG of "
                         "samples without colour conversion")
    if frame.coding == "lossless":
        if any(s is None for s in frame.samples):
            raise ValueError(f"{name}: lossless JPEG with a component no scan carried")
        planes = frame.samples
    else:
        planes = _idct_planes(frame, name)
    return np.stack([p[:frame.height, :frame.width] for p in planes], -1).astype(np.uint8)


def _parse(data: bytes, name: str, counts: Sequence[int] = (1, 3, 4)):
    """The markers and scans of a JPEG → (frame, jfif, adobe, transform);
    ``counts``: the numbers of components read."""
    pos = 2
    quant: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, Tuple[List[int], bool, int]] = {}  # (lookup, overflow, largest symbol)
    ac_tabs: Dict[int, Tuple[List[int], bool, int]] = {}
    dac_l, dac_u, dac_k = [0] * 16, [1] * 16, [5] * 16
    frame: Optional[_Frame] = None
    restart = scans = 0
    jfif = adobe = False
    adobe_transform = None
    # after one scan of every component (not progressive) libjpeg has the image;
    # it reads the markers after it only until the data runs out
    single = False
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            if single:
                break
            raise ValueError(f"{name}: JPEG ends before EOI")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker == 0xD8:
            raise ValueError(f"{name}: a second JPEG SOI marker")
        if 0xD0 <= marker <= 0xD7 or marker in (0x00, 0x01):  # FF 00 outside a scan: junk
            continue
        if marker in _HIERARCHICAL:
            raise _refuse(name, "a hierarchical JPEG")
        if marker < 0xC0 or marker in (0xC8, 0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
            # DHP, EXP, JPG, JPGn, RESn: libjpeg's read_markers stops at them
            raise ValueError(f"{name}: unsupported JPEG marker 0x{marker:02X}")
        if marker == 0xCB:
            raise _refuse(name, "a lossless arithmetic-coded JPEG")
        if single and (marker == 0xDA or marker in _FRAMES):
            raise ValueError(f"{name}: JPEG marker 0x{marker:02X} after the image's one scan")
        if pos + 2 > len(data):
            if single:
                break
            raise ValueError(f"{name}: JPEG ends inside marker 0x{marker:02X}")
        length = struct.unpack_from(">H", data, pos)[0]
        body = data[pos + 2: pos + length]
        cut = pos + max(length, 2) > len(data)  # past the end: libjpeg checks what it reads
        if cut and not single:
            raise ValueError(f"{name}: JPEG marker 0x{marker:02X} runs past the end of the file")
        pos += length
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if tq >= 4:
                    raise ValueError(f"{name}: bogus JPEG DQT index {tq}")
                n = 128 if pq else 64
                raw = np.frombuffer(body[i + 1: i + 1 + n], ">u2" if pq else np.uint8)
                if raw.size < 64:
                    if cut:
                        break
                    raise ValueError(f"{name}: bogus JPEG DQT marker length")
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = raw
                quant[tq] = table
                i += 1 + n
        elif marker == 0xC4:  # libjpeg's get_dht, with its checks
            i, left = 0, length - 2
            while left - i > 16 and i + 17 <= len(body):
                index, counts = body[i], list(body[i + 1: i + 17])
                n = sum(counts)
                if n > 256 or n > left - i - 17:
                    raise ValueError(f"{name}: bogus JPEG Huffman table definition")
                tc, th = (1, index - 0x10) if index & 0x10 else (0, index)
                if th >= 4:
                    raise ValueError(f"{name}: bogus JPEG DHT index {index}")
                symbols = list(body[i + 17: i + 17 + n])
                (ac_tabs if tc else dc_tabs)[th] = (*_huffman_table(counts, symbols),
                                                    max(symbols, default=0))
                i += 17 + n
            if i != left and not cut:
                raise ValueError(f"{name}: bogus JPEG DHT marker length")
        elif marker == 0xCC:  # get_dac: DC tables 0-15 (L <= U), AC tables 16-31
            for i in range(0, len(body) - 1, 2):
                index, cs = body[i], body[i + 1]
                if index >= 32 or index < 16 and cs & 15 > cs >> 4:
                    raise ValueError(f"{name}: bogus JPEG DAC entry {index}, {cs}")
                if index >= 16:
                    dac_k[index - 16] = cs
                else:
                    dac_l[index], dac_u[index] = cs & 15, cs >> 4
            if length % 2 and not cut:
                raise ValueError(f"{name}: bogus JPEG DAC marker length")
        elif marker == 0xDD:
            if length != 4:
                raise ValueError(f"{name}: bogus JPEG DRI marker length")
            if not cut:
                restart = struct.unpack(">H", body[:2])[0]
        elif single:  # APPn, COM, DNL after the one scan: skipped, changing nothing
            pass
        elif marker in _FRAMES:
            frame = _Frame(marker, body, name, counts)
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe, adobe_transform = True, body[11] if len(body) > 11 else None
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            pos = _scan(data, pos, body, frame, quant, dc_tabs, ac_tabs,
                        (dac_l, dac_u, dac_k), restart, name)
            scans += 1
            single = scans == 1 and not frame.progressive and body[0] == len(frame.comps)
        if cut:
            break
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    return frame, jfif, adobe, adobe_transform


class _Segments:
    """The entropy-coded data from ``pos`` split at every marker, as far as
    it is asked for: item ``i`` is (the data before marker ``i``, the
    marker's code, the position of its last 0xFF). Asking past the end of
    the file raises, as Pillow does where libjpeg's reader suspends there."""

    def __init__(self, data: bytes, pos: int, name: str):
        self.data, self.pos, self.name = data, pos, name
        self.parts: List[Tuple[bytes, int, int]] = []

    def __getitem__(self, i: int) -> Tuple[bytes, int, int]:
        data = self.data
        while len(self.parts) <= i:
            start = pos = self.pos
            while True:
                nxt = data.find(b"\xff", pos)
                run = nxt
                while 0 <= nxt < len(data) - 1 and data[nxt + 1] == 0xFF:
                    nxt += 1
                if nxt < 0 or nxt + 1 >= len(data):
                    raise ValueError(f"{self.name}: JPEG scan runs past the end of the file")
                if data[nxt + 1]:
                    break
                pos = nxt + 2
            # the 0xFF bytes before a marker are not data
            self.parts.append((data[start:run], data[nxt + 1], nxt))
            self.pos = nxt + 2
        return self.parts[i]


def _resync(marker: int, expected: int) -> int:
    """What ``read_restart_marker`` does with ``marker`` where RST``expected``
    is due (``jpeg_resync_to_restart``'s actions): 1 read it and go on, 2
    skip to the next marker and decide again, 3 leave it unread."""
    if marker == 0xD0 + expected:
        return 1
    if marker < 0xC0:
        return 2
    if not 0xD0 <= marker <= 0xD7:
        return 3
    n = marker - 0xD0
    if n in ((expected + 1) & 7, (expected + 2) & 7):
        return 3
    return 2 if n in ((expected - 1) & 7, (expected - 2) & 7) else 1


def _scan(data: bytes, pos: int, header: bytes, frame: _Frame, quant, dc_tabs, ac_tabs, dac,
          restart: int, name: str) -> int:
    """Decode one scan whose entropy-coded data starts at ``pos``; returns
    the position of the marker that ends it."""
    ns = header[0] if header else 0
    if not 1 <= ns <= 4 or len(header) != 2 * ns + 4:  # libjpeg's get_sos
        raise ValueError(f"{name}: bogus JPEG SOS marker length")
    ids = [c[0] for c in frame.comps]
    sel = []
    for k in range(ns):
        cid, tables = header[1 + 2 * k], header[2 + 2 * k]
        if cid not in ids:
            raise ValueError(f"{name}: JPEG scan names no component of the frame")
        sel.append((ids.index(cid), tables >> 4, tables & 15))
    if ns > 1 and sum(frame.comps[ci][1] * frame.comps[ci][2] for ci, _, _ in sel) > 10:
        raise _refuse(name, "a JPEG scan of more than 10 blocks per MCU")
    ss, se, ahal = header[1 + 2 * ns: 4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    for ci, _, _ in sel:
        tq = frame.comps[ci][3]
        if frame.coding != "lossless" and frame.quant[ci] is None:
            if tq not in quant:
                raise ValueError(f"{name}: JPEG component without its quantization table")
            frame.quant[ci] = quant[tq].copy()
    if frame.progressive:
        if (ss == 0) != (se == 0) or se > 63 or ss > se or (ss and ns != 1) or al > 13 or (
                ah and al != ah - 1):
            raise ValueError(f"{name}: bad progressive JPEG scan ({ss}, {se}, {ah}, {al})")
    elif frame.coding != "lossless":  # libjpeg only warns where these are not 0, 63, 0, 0
        ss, se, ah, al = 0, 63, 0, 0
    huffman = frame.coding in ("huffman", "lossless")

    def table(tabs, i):
        """The lookup of table ``i``, checked as libjpeg derives it for a scan."""
        if i not in tabs:
            raise ValueError(f"{name}: JPEG scan uses an undefined Huffman table {i}")
        lut, overflow, top = tabs[i]
        if overflow or tabs is dc_tabs and top > (16 if frame.coding == "lossless" else 15):
            raise ValueError(f"{name}: bad JPEG Huffman table {i}")
        return lut

    units = _units(frame, sel, huffman, dc_tabs, ac_tabs, ss, ah, table)
    if frame.coding == "lossless" and restart % frame.width:
        raise ValueError(f"{name}: lossless restart interval {restart} is not whole rows")
    per = restart or len(units)
    first = np.zeros(frame.height, bool)  # lossless: the rows predicted as a first row
    segments = _Segments(data, pos, name)
    at = expected = 0  # the marker that ends the segment being read, the RSTn due next
    parked = short = False  # a marker left unread; the data ran out (insufficient_data)
    good = 0  # the last MCU that started with data left
    for start in range(0, len(units), per):
        before = short
        if start:  # process_restart: read_restart_marker, resyncing where it must
            while (action := _resync(segments[at][1], expected)) == 2:
                at += 1
            parked = action == 3
            if not parked:
                at, short = at + 1, False
            expected = (expected + 1) & 7
        seg = b"" if parked else segments[at][0]
        chunk = units[start: start + per]
        if frame.coding == "lossless":
            short, reset = _lossless_scan(seg, chunk, frame.width, frame.diffs, short, name)
            row = start // frame.width
            first[row] = True
            first[[row + r for r in reset]] = True
        elif frame.coding == "arith":
            _arith_scan(seg, [u for mcu in chunk for u in mcu], frame.coefs, ss, se, ah, al,
                        frame.progressive, {t for _, t, _ in sel}, {t for _, _, t in sel}, *dac)
        elif frame.progressive:
            short, n = _huffman_progressive(seg, chunk, frame.coefs, ss, se, ah, al, short, name)
            # libjpeg reads the flag before an MCU's restart, after the MCU before it
            good = start + n - 1 if n > 1 else start if not before else good
            continue
        else:
            short = _huffman_sequential(seg, chunk, frame.coefs, len(frame.comps), short)
        good = start + len(chunk) - 1
    end = segments[at][2]
    if frame.coding == "lossless":
        for ci, _, _ in sel:
            d = np.asarray(frame.diffs[ci], np.int64).reshape(frame.height, frame.width)
            frame.samples[ci] = _undifference(d, ss, frame.precision - al, first)
            frame.samples[ci] = (frame.samples[ci] << al) & 0xFF
    else:
        frame.scans += 1
        if len(sel) > 1:
            frame.last_good = good // frame.mcux
        else:
            ci = sel[0][0]
            frame.last_good = good // -(-frame.comp_size(ci)[0] // 8) // frame.comps[ci][2]
        for ci, _, _ in sel:
            bits = frame.coef_bits[ci]
            for k in range(1, 10):
                frame.prev_bits[ci][k] = bits[k] if frame.scans > 1 else 0
            for k in range(ss, se + 1):
                bits[k] = al
    return end


def _units(frame: _Frame, sel, huffman: bool, dc_tabs, ac_tabs, ss: int, ah: int, table):
    """The MCUs of a scan, each a list of (component, offset, DC table, AC
    table); for lossless scans (component, sample index, table)."""
    comps, mcux = frame.comps, frame.mcux
    need_dc = ss == 0 and ah == 0 or not frame.progressive
    need_ac = ss > 0 or not frame.progressive

    def tabs(td, ta):
        if not huffman:
            return td, ta
        return (table(dc_tabs, td) if need_dc or frame.coding == "lossless" else None,
                table(ac_tabs, ta) if need_ac and frame.coding != "lossless" else None)

    units = []
    if frame.coding == "lossless":
        for y in range(frame.height):
            for x in range(frame.width):
                units.append([(ci, y * frame.width + x, tabs(td, ta)[0]) for ci, td, ta in sel])
        if len(sel) == 1:  # a non-interleaved scan: one sample per MCU
            units = [[u] for mcu in units for u in mcu]
        return units
    if len(sel) == 1:
        ci, td, ta = sel[0]
        dc, ac = tabs(td, ta)
        _, h, _, _ = comps[ci]
        cw, ch = frame.comp_size(ci)
        row_blocks = mcux * h
        for by in range(-(-ch // 8)):
            for bx in range(-(-cw // 8)):
                units.append([(ci, (by * row_blocks + bx) * 64, dc, ac)])
        return units
    resolved = [(ci, *tabs(td, ta)) for ci, td, ta in sel]
    for my in range(frame.mcuy):
        for mx in range(mcux):
            mcu = []
            for ci, dc, ac in resolved:
                _, h, v, _ = comps[ci]
                for yy in range(v):
                    for xx in range(h):
                        by, bx = my * v + yy, mx * h + xx
                        mcu.append((ci, (by * mcux * h + bx) * 64, dc, ac))
            units.append(mcu)
    return units


def _colour_space(n: int, ids, jfif: bool, adobe: bool, transform, lossless: bool) -> str:
    """libjpeg-turbo's ``default_decompress_parms``: the colour space of the
    samples of an ``n``-component image."""
    if n == 1:
        return "gray"
    if n == 4:
        return "ycck" if adobe and transform != 0 else "cmyk"
    if jfif:
        return "ycc"
    if adobe:
        return "rgb" if transform == 0 else "ycc"
    if list(ids) == [82, 71, 66]:  # 'R', 'G', 'B'
        return "rgb"
    return "rgb" if lossless else "ycc"


def _idct_planes(frame: _Frame, name: str) -> List[np.ndarray]:
    """Each component's samples at its own resolution, over whole blocks
    (block smoothing where libjpeg smooths)."""
    if any(q is None for q in frame.quant):
        raise ValueError(f"{name}: JPEG with a component no scan carried")
    smooth = frame.progressive and all(b[0] >= 0 for b in frame.coef_bits) and any(
        b[k] != 0 for b in frame.coef_bits for k in range(1, 10)) and all(
        (q[:10] != 0).all() for q in frame.quant)
    planes = []
    for ci, ((_, h, v, _), flat) in enumerate(zip(frame.comps, frame.coefs)):
        nbx, nby = frame.mcux * h, frame.mcuy * v
        zz = np.asarray(flat, np.int64).reshape(nby, nbx, 64)
        if smooth:
            cw, ch = frame.comp_size(ci)
            args = frame.quant[ci], -(-ch // 8), -(-cw // 8), v, frame.mcuy
            smoothed = _smooth(zz, frame.coef_bits[ci], *args)
            # iMCU rows past the last scan's last good one: the bits before that scan
            late = np.arange(nby) // v > frame.last_good
            if late.any():
                prev = frame.prev_bits[ci] if frame.scans > 1 else [-1] * 10
                smoothed[late] = _smooth(zz, prev, *args)[late]
            zz = smoothed
        natural = np.zeros((nby * nbx, 64), np.int64)
        natural[:, ZIGZAG] = zz.reshape(-1, 64)
        blocks = idct_islow(natural, frame.quant[ci])
        planes.append(blocks.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3)
                      .reshape(nby * 8, nbx * 8))
    return planes


def _assemble(frame: _Frame, jfif: bool, adobe: bool, adobe_transform, name: str,
              cmyk_as_stored: bool = False) -> np.ndarray:
    width, height, comps = frame.width, frame.height, frame.comps
    n = len(comps)
    space = _colour_space(n, [c[0] for c in comps], jfif, adobe, adobe_transform,
                          frame.coding == "lossless")
    if cmyk_as_stored and n == 4:
        space = "cmyk"
    if frame.coding == "lossless":
        if any(s is None for s in frame.samples):
            raise ValueError(f"{name}: lossless JPEG with a component no scan carried")
        if space in ("ycc", "ycck"):
            raise _refuse(name, "a lossless JPEG in YCbCr (a colour conversion libjpeg-turbo "
                          "does not make in lossless mode)")
        planes = frame.samples
    else:
        for _, h, v, _ in comps:
            if frame.hmax % h or frame.vmax % v:
                raise _refuse(name, "JPEG sampling factors that do not divide the largest")
        planes = []
        for ci, ((_, h, v, _), plane) in enumerate(zip(comps, _idct_planes(frame, name))):
            dw, dh = frame.comp_size(ci)
            planes.append(_upsample(plane, frame.hmax // h, frame.vmax // v, dw, dh)
                          [:height, :width].astype(np.int64))
    planes = [p[:height, :width].astype(np.int64) for p in planes]
    if space == "gray":
        return np.ascontiguousarray(np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2))
    if space == "rgb":
        return np.stack(planes, axis=-1).astype(np.uint8)
    if space == "ycc":
        return np.clip(np.stack(_ycc(*planes), -1), 0, 255).astype(np.uint8)
    if space == "ycck":
        planes = [np.clip(255 - x, 0, 255) for x in _ycc(*planes[:3])] + [planes[3]]
    return _cmyk_to_rgb(planes).astype(np.uint8)
