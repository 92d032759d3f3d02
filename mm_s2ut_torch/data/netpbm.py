"""Netpbm images without Pillow (numpy only).

:func:`decode_netpbm` gives ``np.asarray(Image.open(p).convert("RGB"))``
for every file Pillow 12's ``PpmImagePlugin`` opens, and ``ValueError``
naming the file for those it refuses:

* P1-P6, plain (ASCII) and raw: the header's tokens separated by any run
  of whitespace, a ``#`` comment anywhere in a header token running to the
  end of its line (the token goes on after it), one whitespace byte after
  the last token; the plain data's comments cut out with their line ends
  (so the tokens on either side join), P1's bits with or without
  whitespace between them;
* maxval 1-65535: 8-bit samples of maxval 255 as they are, a 16-bit gray
  of maxval 65535 as Pillow's ``I;16B``, every other sample scaled as
  ``round(v / maxval * top)`` (half to even) and capped at ``top``, where
  ``top`` is 65535 for a gray of maxval above 255 (Pillow's ``I``) and 255
  otherwise; ``convert("RGB")`` then clips ``I`` at 255;
* P1 and P4: a 1 bit is black;
* ``Pf``: one 32-bit float per pixel, little-endian where the scale is
  negative, rows bottom-up; ``convert("RGB")`` clips to 0..255 and
  truncates, NaN 0.

Pillow refuses ``PF`` (colour floats), P7 (PAM) and every other magic; the
port raises for them, and for Pillow's own test-only ``P0CMYK``, ``PyP``,
``PyRGBA`` and ``PyCMYK``, which it does not read yet.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mm_s2ut_torch.data import check_pixels

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"Pf": "F"}
_NOT_YET = {b"P0CMYK": "CMYK", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BLOCK = 1 << 20  # Pillow's SAFEBLOCK: the plain decoders read this much at a time


def _magic(data: bytes) -> Tuple[bytes, int]:
    """Up to six bytes before the first whitespace, and the offset past it."""
    magic, pos = b"", 0
    for _ in range(6):
        c = data[pos: pos + 1]
        pos += len(c)
        if not c or c in _WHITESPACE:
            break
        magic += c
    return magic, pos


def _token(data: bytes, pos: int, name: str) -> Tuple[bytes, int]:
    """A header token from ``pos`` as Pillow's ``_read_token`` reads it."""
    token = b""
    while len(token) <= 10:
        c = data[pos: pos + 1]
        pos += len(c)
        if not c:
            break
        if c in _WHITESPACE:
            if token:
                break
            continue
        if c == b"#":  # a comment, to CR or LF or the end of the file
            while True:
                d = data[pos: pos + 1]
                pos += len(d)
                if d in b"\r\n":
                    break
            continue
        token += c
    if not token:
        raise ValueError(f"{name}: Netpbm header ends early")
    if len(token) > 10:
        raise ValueError(f"{name}: Netpbm header token too long: {token!r}")
    return token, pos


def _number(token: bytes, kind, what: str, name: str):
    try:
        return kind(token)
    except ValueError:
        raise ValueError(f"{name}: Netpbm {what} {token!r} is not a number") from None


class _Plain:
    """The plain data in blocks, each with its comments cut out, as Pillow's
    ``PpmPlainDecoder`` reads it."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.spans = data, pos, False

    def read(self) -> bytes:
        block = self.data[self.pos: self.pos + _BLOCK]
        self.pos += len(block)
        return block

    def strip(self, block: bytes) -> bytes:
        if self.spans:  # a comment from the block before
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.read()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                return block
            end = _comment_end(block, start)
            if end == -1:
                self.spans = True
                return block[:start]
            block = block[:start] + block[end + 1:]


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _plain_bits(data: bytes, pos: int, total: int, name: str) -> np.ndarray:
    reader, out = _Plain(data, pos), b""
    while len(out) != total:
        block = reader.read()
        if not block:
            break
        tokens = b"".join(reader.strip(block).split())
        bad = tokens.translate(None, b"01")
        if bad:
            raise ValueError(f"{name}: Netpbm P1 data holds {bad[:1]!r}, not 0 or 1")
        out = (out + tokens)[:total]
    if len(out) < total:
        raise ValueError(f"{name}: Netpbm data ends after {len(out)} of {total} pixels")
    return np.frombuffer(out, np.uint8) == ord("1")


def _plain_values(data: bytes, pos: int, total: int, maxval: int, name: str) -> List[int]:
    reader, values, half = _Plain(data, pos), [], b""
    while len(values) != total:
        block = reader.read()
        if not block:
            if not half:
                break
            block = b" "  # the end of the file ends the last token
        block = reader.strip(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()  # a token the next block may go on
            if len(half) > 10:
                raise ValueError(f"{name}: Netpbm data token too long: {half[:11]!r}")
        for token in tokens:
            if len(token) > 10:
                raise ValueError(f"{name}: Netpbm data token too long: {token[:11]!r}")
            value = _number(token, int, "sample", name)
            if not 0 <= value <= maxval:
                raise ValueError(f"{name}: Netpbm sample {value} outside 0..{maxval}")
            values.append(value)
            if len(values) == total:
                break
    if len(values) < total:
        raise ValueError(f"{name}: Netpbm data ends after {len(values)} of {total} samples")
    return values


def _scaled(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """Pillow's ``min(top, round(v / maxval * top))``, half to even."""
    return np.minimum(top, np.rint(v.astype(np.float64) / maxval * top)).astype(np.int64)


def _rgb(px: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.repeat(px[..., None], 3, 2) if px.ndim == 2 else px)


def decode_netpbm(data: bytes, name: str = "<netpbm>") -> np.ndarray:
    """A P1-P6 or ``Pf`` file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    magic, pos = _magic(data)
    if magic in _NOT_YET:
        raise ValueError(f"{name}: Netpbm magic {magic.decode()} (Pillow's own test-only mode "
                         f"{_NOT_YET[magic]}) is not read yet")
    if magic not in _MODES:
        raise ValueError(f"{name}: not a Netpbm file Pillow opens (magic {magic!r})")
    mode = _MODES[magic]
    tok, pos = _token(data, pos, name)
    width = _number(tok, int, "width", name)
    tok, pos = _token(data, pos, name)
    height = _number(tok, int, "height", name)
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = scale = 0
    if mode == "F":
        tok, pos = _token(data, pos, name)
        scale = _number(tok, float, "scale", name)
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError(f"{name}: Netpbm Pf scale {scale} is not finite and non-zero")
    elif mode != "1":
        tok, pos = _token(data, pos, name)
        maxval = _number(tok, int, "maxval", name)
        if not 0 < maxval < 65536:
            raise ValueError(f"{name}: Netpbm maxval {maxval} outside 1..65535")
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: Netpbm size {width}x{height}")
    check_pixels(width, height, name)
    bands = 3 if mode == "RGB" else 1
    total = width * height * bands

    if mode == "1":
        if plain:
            black = _plain_bits(data, pos, width * height, name).reshape(height, width)
        else:
            stride = (width + 7) // 8
            raw = _raw(data, pos, height * stride, name).reshape(height, stride)
            black = np.unpackbits(raw, axis=1)[:, :width].astype(bool)
        return _rgb(np.where(black, 0, 255).astype(np.uint8))
    if mode == "F":
        order = "<" if scale < 0 else ">"
        v = _raw(data, pos, 4 * width * height, name).view(f"{order}f4").reshape(height, width)
        v = v[::-1].astype(np.float64)
        return _rgb(np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(np.uint8))

    top = 65535 if mode == "L" and maxval > 255 else 255  # Pillow's I, then clipped at 255
    if plain:
        px = _scaled(np.asarray(_plain_values(data, pos, total, maxval, name), np.int64),
                     maxval, top)
    elif maxval == 255:
        px = _raw(data, pos, total, name)
    elif maxval == 65535 and mode == "L":
        px = _raw(data, pos, 2 * total, name).view(">u2")
    else:
        size = 2 if maxval > 255 else 1
        have = min(total, (len(data) - pos) // size // bands * bands)
        if have < total:
            raise ValueError(f"{name}: Netpbm data ends after {have} of {total} samples")
        v = np.frombuffer(data, ">u2" if size == 2 else np.uint8, total, pos)
        px = _scaled(v, maxval, top)
    px = np.minimum(np.asarray(px, np.int64), 255).astype(np.uint8)
    return _rgb(px.reshape(height, width, bands) if bands == 3 else px.reshape(height, width))


def _raw(data: bytes, pos: int, n: int, name: str) -> np.ndarray:
    if len(data) - pos < n:
        raise ValueError(f"{name}: Netpbm data truncated ({max(0, len(data) - pos)} of {n} "
                         f"bytes)")
    return np.frombuffer(data, np.uint8, n, pos)
