"""FLAC decode and a minimal encoder, without a codec library (numpy only).

A copy of ``mm_s2ut/data/flac.py`` (the port never imports the JAX
package): metadata blocks, frame headers, constant/verbatim/fixed/LPC
subframes, rice-coded residual partitions (4- and 5-bit parameters,
escape codes) and left/right/mid-side stereo decorrelation, in Python and
numpy. ``data/audio_io.get_waveform`` dispatches here on ``fLaC``; it is
meant for data preparation (``cli/prep_data.py``), not the training loop.

The encoder (fixed predictors of order 0-4, rice partitions) exists for
round-trip tests; it is not a general-purpose compressor.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def read(self, n: int) -> int:
        """Read n bits MSB-first."""
        pos, data = self.pos, self.data
        end = pos + n
        first = pos >> 3
        last = (end + 7) >> 3
        chunk = int.from_bytes(data[first:last], "big")
        chunk >>= (last << 3) - end
        self.pos = end
        return chunk & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1."""
        pos, data = self.pos, self.data
        count = 0
        byte_i = pos >> 3
        bit_i = pos & 7
        while True:
            byte = data[byte_i]
            rest = byte & (0xFF >> bit_i)
            if rest == 0:
                count += 8 - bit_i
                byte_i += 1
                bit_i = 0
                continue
            lead = 7 - rest.bit_length() + 1  # index of highest set bit
            count += lead - bit_i
            self.pos = (byte_i << 3) + lead + 1
            return count

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def read_utf8_number(self) -> int:
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n = 0
        while (b0 << n) & 0x80:
            n += 1
        v = b0 & (0x7F >> n)
        for _ in range(n - 1):
            v = (v << 6) | (self.read(8) & 0x3F)
        return v


_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050, 7: 24000,
    8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _decode_residual(br: _BitReader, n: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    part_order = br.read(4)
    nparts = 1 << part_order
    if n % nparts:
        raise ValueError("bad partition order")
    out: List[int] = []
    for p in range(nparts):
        count = n // nparts - (order if p == 0 else 0)
        param = br.read(pbits)
        if param == escape:
            raw = br.read(5)
            if raw == 0:
                out.extend([0] * count)
            else:
                out.extend(br.read_signed(raw) for _ in range(count))
        else:
            for _ in range(count):
                q = br.read_unary()
                v = (q << param) | br.read(param) if param else q
                out.append((v >> 1) ^ -(v & 1))
    return out


def _decode_subframe(br: _BitReader, bs: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if stype == 0:  # CONSTANT
        x = np.full(bs, br.read_signed(bps), np.int64)
    elif stype == 1:  # VERBATIM
        x = np.array([br.read_signed(bps) for _ in range(bs)], np.int64)
    elif 8 <= stype <= 12:  # FIXED
        order = stype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = _decode_residual(br, bs, order)
        coefs = _FIXED_COEFS[order]
        xs = list(warm)
        for r in resid:
            acc = r
            for i, c in enumerate(coefs):
                acc += c * xs[-1 - i]
            xs.append(acc)
        x = np.array(xs, np.int64)
    elif stype >= 32:  # LPC
        order = stype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision")
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        resid = _decode_residual(br, bs, order)
        xs = list(warm)
        for r in resid:
            acc = 0
            for i, c in enumerate(coefs):
                acc += c * xs[-1 - i]
            xs.append(r + (acc >> shift))
        x = np.array(xs, np.int64)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        x = x << wasted
    return x


def decode_flac_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC stream → (float32 samples (T, C) in [-1, 1], sample_rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = channels = bps = None
    total_samples = 0
    while True:
        header = data[pos : pos + 4]
        last = header[0] & 0x80
        btype = header[0] & 0x7F
        (length,) = struct.unpack(">I", b"\x00" + header[1:4])
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16); br.read(16); br.read(24); br.read(24)
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total_samples = br.read(36)
        pos += 4 + length
        if last:
            break
    if sample_rate is None:
        raise ValueError("missing STREAMINFO")

    chans: List[List[np.ndarray]] = [[] for _ in range(channels)]
    n_decoded = 0
    while pos < len(data) and (total_samples == 0 or n_decoded < total_samples):
        br = _BitReader(data, pos << 3)
        sync = br.read(14)
        if sync != 0x3FFE:
            break
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_number()
        if bs_code == 6:
            bs = br.read(8) + 1
        elif bs_code == 7:
            bs = br.read(16) + 1
        else:
            bs = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = _SAMPLE_SIZES.get(ss_code, bps)
        br.read(8)  # header CRC-8 (not verified)

        if chan_code < 8:
            subs = [_decode_subframe(br, bs, frame_bps) for _ in range(chan_code + 1)]
        elif chan_code == 8:  # left/side
            left = _decode_subframe(br, bs, frame_bps)
            side = _decode_subframe(br, bs, frame_bps + 1)
            subs = [left, left - side]
        elif chan_code == 9:  # right/side
            side = _decode_subframe(br, bs, frame_bps + 1)
            right = _decode_subframe(br, bs, frame_bps)
            subs = [right + side, right]
        elif chan_code == 10:  # mid/side
            mid = _decode_subframe(br, bs, frame_bps)
            side = _decode_subframe(br, bs, frame_bps + 1)
            m2 = (mid << 1) | (side & 1)  # restore the dropped LSB
            subs = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"reserved channel assignment {chan_code}")
        br.align()
        br.read(16)  # frame CRC-16 (not verified)
        pos = br.pos >> 3

        for c in range(channels):
            chans[c].append(subs[c])
        n_decoded += bs

    if not chans[0]:
        raise ValueError("no FLAC frames decoded")
    x = np.stack([np.concatenate(c) for c in chans], axis=1).astype(np.float32)
    if total_samples:
        x = x[:total_samples]
    return x / float(1 << (bps - 1)), sample_rate


# --- minimal encoder (tests/data prep round-trips) -------------------------


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        value &= (1 << n) - 1
        self.acc = (self.acc << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def encode_flac(
    samples: np.ndarray, sample_rate: int, order: int = 2, block_size: int = 4096
) -> bytes:
    """Encode int16-range samples (T,) or (T, C) as a FLAC stream using
    fixed-predictor subframes with single-partition rice residuals. Small
    and correct, not competitive with libFLAC compression."""
    x = np.asarray(samples)
    if x.dtype.kind == "f":
        x = np.clip(x, -1.0, 1.0)
        x = (x * 32767.0).astype(np.int64)
    else:
        x = x.astype(np.int64)
    if x.ndim == 1:
        x = x[:, None]
    T, C = x.shape
    bps = 16

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(block_size, 16); si.write(block_size, 16)
    si.write(0, 24); si.write(0, 24)
    si.write(sample_rate, 20); si.write(C - 1, 3); si.write(bps - 1, 5)
    si.write(T, 36)
    si_body = bytes(si.buf) + b"\x00" * 16  # md5 unset
    out += bytes([0x80]) + struct.pack(">I", len(si_body))[1:] + si_body

    for frame_idx, start in enumerate(range(0, T, block_size)):
        blk = x[start : start + block_size]
        bs = blk.shape[0]
        w = _BitWriter()
        w.write(0x3FFE, 14); w.write(0, 1); w.write(0, 1)
        w.write(7, 4)        # block size: 16-bit at end of header
        w.write(0, 4)        # sample rate: from STREAMINFO
        w.write(C - 1, 4)    # independent channels
        w.write(4, 3)        # 16 bps
        w.write(0, 1)
        # UTF-8 frame number (frame_idx < 2^7 assumed for simplicity)
        if frame_idx >= 128:
            w.write(0xC0 | (frame_idx >> 6), 8)
            w.write(0x80 | (frame_idx & 0x3F), 8)
        else:
            w.write(frame_idx, 8)
        w.write(bs - 1, 16)
        header = bytes(w.buf)
        w.write(_crc8(header), 8)

        for c in range(C):
            ch = blk[:, c]
            w.write(0, 1)
            o = min(order, bs - 1, 4)
            w.write(8 + o, 6)  # FIXED subframe, order o
            w.write(0, 1)      # no wasted bits
            for i in range(o):
                w.write(int(ch[i]), bps)
            resid = ch[o:].copy()
            hist = ch
            coefs = _FIXED_COEFS[o]
            for i, cf in enumerate(coefs):
                resid = resid - cf * hist[o - 1 - i : bs - 1 - i]
            # residual: method 0 (4-bit rice), partition order 0
            w.write(0, 2); w.write(0, 4)
            zz = (np.abs(resid) << 1) - (resid < 0)
            mean = int(zz.mean()) if len(zz) else 0
            param = min(max(mean.bit_length() - 1, 0), 14)
            w.write(param, 4)
            for v in zz:
                v = int(v)
                w.write_unary(v >> param)
                if param:
                    w.write(v & ((1 << param) - 1), param)
        w.align()
        body = bytes(w.buf)
        w.write(_crc16(body), 16)
        out += bytes(w.buf)
    return bytes(out)
