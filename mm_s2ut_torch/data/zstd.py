"""A Zstandard decoder after RFC 8878 (numpy-free, standard library only).

:func:`decompress` reads one or more frames (skippable frames skipped):
raw, RLE and compressed blocks; literals raw, RLE, Huffman-coded with a
tree of their own or the previous block's (one or four streams); sequences
with predefined, RLE, FSE-coded or repeated tables for literal lengths,
match lengths and offsets, and the three repeat offsets. The frame's
content checksum (XXH64) is skipped, not verified; a dictionary ID other
than 0 raises ``ValueError``, as does any malformed input.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

# RFC 8878 3.1.1.3.2.2: the predefined distributions
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
                1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (baseline, extra bits) of literal-length codes 16..35 and match-length codes 32..52
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]
_MAGIC = 0xFD2FB528


class ZstdError(ValueError):
    pass


class _Forward:
    """A little-endian bit stream read from its first byte."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.bit = data, pos * 8

    def read(self, n: int) -> int:
        byte, off = divmod(self.bit, 8)
        chunk = int.from_bytes(self.data[byte: byte + (off + n + 7) // 8], "little")
        self.bit += n
        if self.bit > 8 * len(self.data):
            raise ZstdError("FSE table description runs past its block")
        return (chunk >> off) & ((1 << n) - 1)

    def byte_pos(self) -> int:
        return (self.bit + 7) // 8


class _Backward:
    """A bit stream read from its last bit down, after the final byte's
    padding (its highest set bit); bits past the start read as 0."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bit stream without its end mark")
        self.v = int.from_bytes(data, "little")
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        self.pos -= n
        if self.pos >= 0:
            return (self.v >> self.pos) & ((1 << n) - 1)
        return (self.v << -self.pos) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos - n
        return (self.v >> p if p >= 0 else self.v << -p) & ((1 << n) - 1)


def _fse_description(data: bytes, pos: int, max_symbol: int,
                     max_log: int) -> Tuple[List[int], int, int]:
    """An FSE table description → (probabilities, accuracy log, end)."""
    bits = _Forward(data, pos)
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    probs: List[int] = []
    while remaining > 1 and len(probs) <= max_symbol:
        biggest = 2 * threshold - 1 - remaining
        low = bits.read(nbits - 1)
        if low < biggest:
            count = low
        else:
            bits.bit -= nbits - 1
            count = bits.read(nbits)
            if count >= threshold:
                count -= biggest
        count -= 1
        remaining -= abs(count)
        probs.append(count)
        if count == 0:
            while True:
                rep = bits.read(2)
                probs += [0] * rep
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(probs) > max_symbol + 1:
        raise ZstdError("bad FSE table description")
    return probs, log, bits.byte_pos()


def _fse_table(probs: List[int], log: int) -> List[Tuple[int, int, int]]:
    """Decoding table: for each state (symbol, bits to read, next base)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    for s, p in enumerate(probs):
        if p == -1:
            symbols[high] = s
            high -= 1
    pos, step = 0, (size >> 1) + (size >> 3) + 3
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("bad FSE distribution")
    nxt = [1 if p == -1 else max(p, 0) for p in probs]
    table = []
    for s in symbols:
        n = nxt[s]
        nxt[s] += 1
        nb = log - (n.bit_length() - 1)
        table.append((s, nb, (n << nb) - size))
    return table


class _Huffman:
    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if not total:
            raise ZstdError("Huffman weights all zero")
        self.max_bits = total.bit_length()  # the next power of two's log
        left = (1 << self.max_bits) - total
        if left & (left - 1):
            raise ZstdError("Huffman weights do not complete a tree")
        weights = weights + [left.bit_length()]
        if self.max_bits > 11:
            raise ZstdError(f"Huffman code of {self.max_bits} bits")
        self.symbol, self.nbits = [], []
        for w in range(1, max(weights) + 1):
            for s, sw in enumerate(weights):
                if sw == w:
                    self.symbol += [s] * (1 << (w - 1))
                    self.nbits += [self.max_bits + 1 - w] * (1 << (w - 1))

    def decode(self, stream: bytes, n: int) -> bytes:
        bits = _Backward(stream)
        out = bytearray()
        mb, sym, nb = self.max_bits, self.symbol, self.nbits
        for _ in range(n):
            k = bits.peek(mb)
            out.append(sym[k])
            bits.pos -= nb[k]
        if bits.pos != 0:
            raise ZstdError("Huffman stream not consumed exactly")
        return bytes(out)


def _huffman_tree(data: bytes, pos: int) -> Tuple[_Huffman, int]:
    head = data[pos]
    pos += 1
    if head >= 128:  # direct 4-bit weights
        n = head - 127
        raw = data[pos: pos + (n + 1) // 2]
        weights = [(raw[i // 2] >> (0 if i % 2 else 4)) & 15 for i in range(n)]
        return _Huffman(weights), pos + (n + 1) // 2
    end = pos + head
    probs, log, start = _fse_description(data[:end], pos, 255, 6)
    table = _fse_table(probs, log)
    bits = _Backward(data[start:end])
    states = [bits.read(log), bits.read(log)]  # two states interleaved on one stream
    weights: List[int] = []
    while len(weights) <= 255:
        for a in (0, 1):
            sym, nb, base = table[states[a]]
            weights.append(sym)
            states[a] = base + bits.read(nb)
            if bits.pos < 0:  # the stream is spent: the other state's symbol is the last
                weights.append(table[states[1 - a]][0])
                return _Huffman(weights), end
    raise ZstdError("too many Huffman weights")


class _Frame:
    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables: List[Optional[list]] = [None, None, None]  # LL, OF, ML
        self.rep = [1, 4, 8]


def _literals(data: bytes, pos: int, state: _Frame) -> Tuple[bytes, int]:
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("raw literals past their block")
            return data[pos: pos + size], pos + size
        return data[pos: pos + 1] * size, pos + 1
    head_len, field = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    v = int.from_bytes(data[pos: pos + head_len], "little") >> 4
    size, csize = v & ((1 << field) - 1), v >> field
    streams = 1 if fmt == 0 else 4
    pos += head_len
    end = pos + csize
    if kind == 2:
        state.huffman, pos = _huffman_tree(data[:end], pos)
    elif state.huffman is None:
        raise ZstdError("treeless literals without a previous Huffman tree")
    if streams == 1:
        return state.huffman.decode(data[pos:end], size), end
    s1, s2, s3 = (int.from_bytes(data[pos + 2 * i: pos + 2 * i + 2], "little") for i in range(3))
    pos += 6
    each = (size + 3) // 4
    out = b""
    for i, length in enumerate((s1, s2, s3, end - pos - s1 - s2 - s3)):
        out += state.huffman.decode(data[pos: pos + length], each if i < 3 else size - 3 * each)
        pos += length
    return out, end


def _table_for(mode: int, data: bytes, pos: int, which: int, state: _Frame):
    default, max_symbol, max_log = [(_LL_DEFAULT, 35, 9), (_OF_DEFAULT, 31, 8),
                                    (_ML_DEFAULT, 52, 9)][which]
    if mode == 0:
        table = _fse_table(*default)
    elif mode == 1:
        table, pos = [(data[pos], 0, 0)], pos + 1  # every state the one symbol
    elif mode == 2:
        probs, log, pos = _fse_description(data, pos, max_symbol, max_log)
        table = _fse_table(probs, log)
    else:
        table = state.tables[which]
        if table is None:
            raise ZstdError("repeated sequence table without a previous one")
    state.tables[which] = table
    return table, pos


def _block(data: bytes, out: bytearray, state: _Frame) -> None:
    lits, pos = _literals(data, 0, state)
    n = data[pos]
    if n < 128:
        pos += 1
    elif n < 255:
        n, pos = ((n - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if n == 0:
        out += lits
        return
    modes = data[pos]
    pos += 1
    tables = []
    for which, shift in ((0, 6), (1, 4), (2, 2)):
        t, pos = _table_for((modes >> shift) & 3, data, pos, which, state)
        tables.append(t)
    ll_t, of_t, ml_t = tables
    bits = _Backward(data[pos:])
    log = lambda t: (len(t) - 1).bit_length()  # noqa: E731
    ll_s, of_s, ml_s = bits.read(log(ll_t)), bits.read(log(of_t)), bits.read(log(ml_t))
    rep = state.rep
    lit_pos = 0
    for i in range(n):
        of_code, ml_code, ll_code = of_t[of_s][0], ml_t[ml_s][0], ll_t[ll_s][0]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ZstdError("sequence code out of range")
        offset_value = (1 << of_code) + bits.read(of_code)
        base, nb = _ML_CODES[ml_code]
        ml = base + bits.read(nb)
        base, nb = _LL_CODES[ll_code]
        ll = base + bits.read(nb)
        if offset_value > 3:
            offset = offset_value - 3
            rep[:] = [offset, rep[0], rep[1]]
        else:
            idx = offset_value - 1 + (ll == 0)
            if idx == 0:
                offset = rep[0]
            elif idx == 3:
                offset = rep[0] - 1
                rep[:] = [offset, rep[0], rep[1]]
            else:
                offset = rep[idx]
                rep[:] = [offset] + [r for j, r in enumerate(rep) if j != idx]
        if i < n - 1:  # the states move in this order: literal lengths, match lengths, offsets
            ll_s = ll_t[ll_s][2] + bits.read(ll_t[ll_s][1])
            ml_s = ml_t[ml_s][2] + bits.read(ml_t[ml_s][1])
            of_s = of_t[of_s][2] + bits.read(of_t[of_s][1])
        if lit_pos + ll > len(lits):
            raise ZstdError("sequence takes more literals than the block has")
        out += lits[lit_pos: lit_pos + ll]
        lit_pos += ll
        if offset <= 0 or offset > len(out):
            raise ZstdError(f"match offset {offset} before the start of the output")
        start = len(out) - offset
        if offset >= ml:
            out += out[start: start + ml]
        else:
            for j in range(ml):
                out.append(out[start + j])
    if bits.pos != 0:
        raise ZstdError("sequence bit stream not consumed exactly")
    out += lits[lit_pos:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    desc = data[pos]
    pos += 1
    fcs_flag, single, dict_flag, checksum = desc >> 6, (desc >> 5) & 1, desc & 3, (desc >> 2) & 1
    if desc & 8:
        raise ZstdError("reserved bit set in a frame header")
    if not single:
        pos += 1  # window descriptor
    dict_id = int.from_bytes(data[pos: pos + (0, 1, 2, 4)[dict_flag]], "little")
    pos += (0, 1, 2, 4)[dict_flag]
    if dict_id:
        raise ZstdError(f"frame needs dictionary {dict_id}")
    fcs_len = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = int.from_bytes(data[pos: pos + fcs_len], "little") + (256 if fcs_len == 2 else 0)
    pos += fcs_len
    start = len(out)
    state = _Frame()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("frame ends inside a block header")
        head = int.from_bytes(data[pos: pos + 3], "little")
        pos += 3
        last, kind, bsize = head & 1, (head >> 1) & 3, head >> 3
        if kind == 1:
            out += data[pos: pos + 1] * bsize
            pos += 1
        else:
            if pos + bsize > len(data):
                raise ZstdError("block past the end of the data")
            if kind == 0:
                out += data[pos: pos + bsize]
            elif kind == 2:
                _block(data[pos: pos + bsize], out, state)
            else:
                raise ZstdError("reserved block type")
            pos += bsize
        if last:
            break
    if fcs_len and len(out) - start != size:
        raise ZstdError(f"frame of {len(out) - start} bytes, its header says {size}")
    return pos + 4 * checksum


def decompress(data: bytes) -> bytes:
    out = bytearray()
    pos = 0
    while pos < len(data):
        magic = int.from_bytes(data[pos: pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # skippable frame
            pos += 8 + int.from_bytes(data[pos + 4: pos + 8], "little")
            continue
        if magic != _MAGIC:
            raise ZstdError("not a Zstandard frame")
        try:
            pos = _frame(data, pos + 4, out)
        except IndexError:
            raise ZstdError("Zstandard data ends early") from None
    return bytes(out)
