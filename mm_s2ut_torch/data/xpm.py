"""X11 pixmaps (XPM) without Pillow (numpy only).

:func:`decode_xpm` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``XpmImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses. It reads the file line by line as the
plugin does:

* ``/* XPM */``, then the first line that starts ``"W H N C`` (width,
  height, colours, characters per pixel); no such line passes the file on;
* N colour lines: the key is the C characters after the line's first,
  the rest up to the line's last two characters is split into words, and
  the first ``c`` word's value is the colour: ``#`` and a hex number, of
  which only the low 24 bits count (``#111122223333`` is (34, 51, 51)), or
  ``None``, which is left out of the palette. A named colour, a line with
  no ``c`` word, or a bad number is refused; a ``c`` with no value passes
  the file on;
* up to 256 colours make a ``P`` image, its palette in the order the keys
  were first seen (a key given twice keeps the later colour); more make
  ``RGB``;
* then the pixel lines: a first ``/* pixels */`` line is skipped, each
  other line's text between its first and last double quote is cut into
  keys of C characters, and the keys of all lines are read in turn, row
  after row, until the image is full. A key that is not in the palette
  (``None``'s too) is refused, and so is data that ends early.
"""
from __future__ import annotations

import io
import re

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def decode_xpm(data: bytes, name: str = "<xpm>") -> np.ndarray:
    """An XPM file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    if not data.startswith(b"/* XPM */"):
        raise Unidentified(f"{name}: not an XPM file")
    fp = io.BytesIO(data)
    fp.read(9)
    while True:
        line = fp.readline()
        if not line:
            raise Unidentified(f"{name}: XPM without a header string")
        m = _HEAD.match(line)
        if m:
            break
    try:
        width, height, ncolours, cpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{name}: XPM header {line.strip()!r}") from None
    palette = {}
    for _ in range(ncolours):
        line = fp.readline().rstrip()
        key, words = line[1: cpp + 1], line[cpp + 1: -2].split()
        for i in range(0, len(words), 2):
            if words[i] != b"c":
                continue
            if i + 1 == len(words):
                raise Unidentified(f"{name}: XPM colour key {key!r} without a value")
            value = words[i + 1]
            if value == b"None":
                pass
            elif value.startswith(b"#"):
                try:
                    rgb = int(value[1:], 16)
                except ValueError:
                    raise ValueError(f"{name}: XPM colour {value!r}") from None
                palette[key] = ((rgb >> 16) & 255, (rgb >> 8) & 255, rgb & 255)
            else:
                raise ValueError(f"{name}: XPM colour {value!r} of key {key!r}, which Pillow "
                                 f"does not read (only #hex and None)")
            break
        else:
            raise ValueError(f"{name}: XPM colour line {line!r} without a c key")
    if width == 0 or height == 0:
        raise Unidentified(f"{name}: XPM size {width}x{height}")
    check_pixels(width, height, name)
    index = {k: i for i, k in enumerate(palette)}
    colours = np.asarray(list(palette.values()), np.uint8).reshape(-1, 3)
    total = width * height
    if cpp == 0:
        raise ValueError(f"{name}: XPM of 0 characters per pixel")
    keys: list = []
    seen_header = False
    while len(keys) < total:
        line = fp.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not seen_header:
            seen_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        keys += (line[i: i + cpp] for i in range(0, len(line), cpp))
    try:  # every key read is looked up, those past the image's end too
        idx = np.fromiter((index[k] for k in keys), np.int64, len(keys))
    except KeyError as e:
        raise ValueError(f"{name}: XPM pixel key {e.args[0]!r} not in the palette") from None
    if len(keys) < total:
        raise ValueError(f"{name}: XPM data ends after {len(keys)} of {total} pixels")
    return colours[idx[:total]].reshape(height, width, 3)
