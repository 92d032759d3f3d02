"""CCITT bilevel codings of TIFF (compressions 2, 3 and 4), as libtiff
decodes them: ITU-T T.4's modified Huffman (1D) and modified READ (2D)
codes, and T.6's modified modified READ.

* Compression 2 (CCITT RLE): every row 1D, no EOL, each row starting on a
  byte boundary.
* Compression 3 (Group 3): an EOL (eleven or more zeros, then a one) before
  each row, fill zeros before it allowed; with bit 0 of T4Options the EOL
  is followed by a tag bit, 1 for a 1D row and 0 for a 2D row.
* Compression 4 (Group 4): every row 2D against the row above (an
  all-white row before the first), no EOL.

The codes' white runs come out as 0 bits and their black runs as 1 bits,
each row packed MSB-first into ``ceil(width / 8)`` bytes; libtiff inverts
nothing, so what a bit means is the photometric interpretation's (the
caller's). Uncompressed mode (T4Options bit 1, the 2D extension
codes) raises ``ValueError``.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Tuple

import numpy as np

# T.4 tables 2 and 3: terminating codes 0..63, then make-up codes 64..1728.
_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100 "
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 010011011")
_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111 "
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101")
# T.4 table 4: make-up codes 1792..2560 of either colour
_EXTENDED = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
             "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
             "000000011111")
# T.4 table 5: the 2D modes (vertical offsets a1 - b1)
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
          "000010": -2, "0000010": -3}


def _table(codes: str) -> Dict[str, int]:
    words = codes.split()
    runs = list(range(64)) + [64 * (i + 1) for i in range(len(words) - 64)]
    table = dict(zip(words, runs))
    table.update(zip(_EXTENDED.split(), range(1792, 2561, 64)))
    return table


_RUNS = (_table(_WHITE), _table(_BLACK))


class _Bits:
    """The stream as a string of '0'/'1' characters, read from ``pos``."""

    def __init__(self, data: bytes, name: str):
        self.s = "".join(np.unpackbits(np.frombuffer(data, np.uint8)).astype("U1"))
        self.pos = 0
        self.name = name

    def code(self, table: dict, what: str, longest: int = 13):
        for n in range(1, longest + 1):
            v = table.get(self.s[self.pos: self.pos + n])
            if v is not None:
                self.pos += n
                return v
        raise ValueError(f"{self.name}: bad CCITT {what} code at bit {self.pos}")

    def run(self, colour: int) -> int:
        """A run: make-up codes, then the terminating code below 64."""
        total = 0
        while True:
            r = self.code(_RUNS[colour], "black run" if colour else "white run")
            total += r
            if r < 64:
                return total

    def eol(self) -> bool:
        """Skip fill zeros and an EOL; False (and nothing skipped) if none."""
        end = self.s.find("1", self.pos)
        if end < 0 or end - self.pos < 11:
            return False
        self.pos = end + 1
        return True

    def align(self) -> None:
        self.pos = -(-self.pos // 8) * 8


def _row_1d(bits: _Bits, width: int) -> List[int]:
    """A 1D row → its changing elements (alternately to black and white)."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 += bits.run(colour)
        if a0 > width:
            raise ValueError(f"{bits.name}: CCITT row runs past its width {width}")
        changes.append(a0)
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, width: int, ref: List[int]) -> List[int]:
    """A 2D row coded against ``ref``'s changing elements."""
    changes: List[int] = []
    ref = ref + [width, width]
    a0, colour = -1, 0
    while a0 < width:
        # b1: the first change of ref right of a0 into the colour opposite a0's
        i = bisect_right(ref, a0)
        i = min(i + (i % 2 != colour), len(ref) - 2)
        b1, b2 = ref[i], ref[i + 1]
        mode = bits.code(_MODES, "2D mode", 7)
        if mode == "P":
            a0 = b2
        elif mode == "H":
            start = max(a0, 0)
            r1 = bits.run(colour)
            r2 = bits.run(colour ^ 1)
            a1, a0 = start + r1, start + r1 + r2
            if a0 > width:
                raise ValueError(f"{bits.name}: CCITT row runs past its width {width}")
            changes += [a1, a0]
        else:
            a1 = b1 + mode
            if not (max(a0, 0) <= a1 <= width):
                raise ValueError(f"{bits.name}: CCITT vertical code to {a1} outside the row")
            changes.append(a1)
            a0, colour = a1, colour ^ 1
    return changes


def _pack(changes: List[int], width: int) -> np.ndarray:
    row = np.zeros(width, np.uint8)
    edges = changes + [width] * (len(changes) % 2)
    for start, stop in zip(edges[0::2], edges[1::2]):
        row[start:stop] = 1
    return np.packbits(row)


def decode_ccitt(data: bytes, compression: int, width: int, rows: int, options: int = 0,
                 name: str = "<tiff>") -> bytes:
    """One strip or tile of CCITT data (FillOrder already 1) → ``rows`` packed
    rows of ``width`` pixels, the codes' black 1. ``options`` is T4Options
    (tag 292) for compression 3 and T6Options (293) for 4."""
    if options & 2:
        raise ValueError(f"{name}: CCITT uncompressed mode, which this reader does not decode")
    bits = _Bits(data, name)
    ref: List[int] = []
    out: List[np.ndarray] = []
    for _ in range(rows):
        if compression == 2:
            changes = _row_1d(bits, width)
            bits.align()
        elif compression == 3:
            bits.eol()
            two_d = bool(options & 1) and bits.s[bits.pos: bits.pos + 1] == "0"
            if options & 1:
                bits.pos += 1
            changes = _row_2d(bits, width, ref) if two_d else _row_1d(bits, width)
        else:
            changes = _row_2d(bits, width, ref)
        ref = _normalised(changes, width)
        out.append(_pack(ref, width))
    return b"".join(r.tobytes() for r in out)


def _normalised(changes: List[int], width: int) -> List[int]:
    """Changing elements strictly increasing inside the row (a zero-length
    run leaves two equal positions, which cancel)."""
    out: List[int] = []
    for c in changes:
        if out and out[-1] == c:
            out.pop()
        else:
            out.append(c)
    return [c for c in out if c < width]

