"""IM Tools (IMT) images without Pillow (numpy only).

:func:`decode_imt` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``ImtImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses. IMT has no magic: Pillow tries every file
that reaches its plugin, and passes it on where no ``\\n`` is in its first
100 bytes, or where the header leaves no mode or a size that is not
positive. The header is read as Pillow reads it, a byte then the rest of
its line (through a 100-byte buffer, topped up by 100 bytes where it holds
no ``\\n``): a ``\\x0c`` ends it and the data start after it; a line of
one byte or of more than 100, or one the field pattern
(``([a-z]*) ([^ \\r\\n]*)``) does not match, ends it with no data (Pillow
then cannot load the image); ``*`` starts a comment; ``width`` and
``height`` are numbers as Python's ``int`` reads them (one it does not
read is refused), and ``pixel n8`` makes the image ``L``. The pixels are
``width * height`` bytes, top row first.
"""
from __future__ import annotations

import re

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _number(v: bytes, name: str) -> int:
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}: IMT size {v!r} is not a number") from None


def decode_imt(data: bytes, name: str = "<imt>") -> np.ndarray:
    """An IMT file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    buffer, pos = data[:100], min(100, len(data))
    if b"\n" not in buffer:
        raise Unidentified(f"{name}: not an IMT file")
    width = height = 0
    size, gray, start = (0, 0), False, None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos: pos + 1], pos + 1
        if not s:
            break
        if s == b"\x0c":
            start = min(pos, len(data)) - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += data[pos: pos + 100]
            pos += 100
        line, _, buffer = buffer.partition(b"\n")
        s += line
        if len(s) == 1 or len(s) > 100:
            break
        if s[:1] == b"*":
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            width = _number(v, name)
            size = width, height
        elif k == b"height":
            height = _number(v, name)
            size = width, height
        elif k == b"pixel" and v == b"n8":
            gray = True
    w, h = size
    if not gray or w <= 0 or h <= 0:
        raise Unidentified(f"{name}: IMT header without pixel n8 or a size ({w}x{h})")
    check_pixels(w, h, name)
    if start is None:
        raise ValueError(f"{name}: IMT header that ends before its data: Pillow cannot load it")
    if len(data) - start < w * h:
        raise ValueError(f"{name}: IMT image data truncated ({max(0, len(data) - start)} of "
                         f"{w * h} bytes at {start})")
    px = np.frombuffer(data, np.uint8, w * h, start).reshape(h, w)
    return np.ascontiguousarray(np.repeat(px[..., None], 3, axis=2))
