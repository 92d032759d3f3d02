"""PCX and DCX images without Pillow (numpy only).

:func:`decode_pcx` and :func:`decode_dcx` give
``np.asarray(Image.open(p).convert("RGB"))`` for every file Pillow 12's
``PcxImagePlugin``, ``DcxImagePlugin`` and their ``pcx`` decoder
(``PcxDecode.c``) open from a path, and ``ValueError`` naming the file for
those they refuse:

* the 128-byte header: a box whose size must not be empty, the version,
  the bits per pixel and the planes; the encoding byte is not read (every
  file is read as RLE). A header of under 68 bytes or an empty box passes
  the file on (Pillow's ``SyntaxError``);
* the modes Pillow takes: 1 bit x 1 plane (``1``, a set bit white), 1 bit
  x 2 or 4 planes (``P;2L``/``P;4L``: a pixel's bits from the planes of its
  row, plane 0 the low bit, over the header's 16-entry palette), version 5
  with 8 bits x 1 plane (``L``, or ``P`` where the file's last 769 bytes
  are byte 12 and a palette that is not the gray ramp) and 8 bits x 3
  planes (``RGB;L``: a row's red, green and blue planes in turn). Pillow
  refuses every other mode (2 or 4 bits in one plane, 8 bits before
  version 5); it also cannot seek 769 bytes back in an 8-bit one-plane file
  shorter than that, opened from its path, and refuses it;
* the row's stride: the header's own is not trusted; the stride computed
  from the width is rounded up to even where the header's differs;
* the RLE: a byte of 0xC0 or more repeats the next byte its low 6 bits
  times, any other byte is itself. A run may not pass its row's end
  (Pillow's buffer overrun); a literal may;
* each row's planes are closed up as the decoder does before unpacking:
  for 2 and 4 planes, each plane's stride to ``ceil(width / 8)``; else,
  where ``row // width`` planes fit the row, to ``width`` (so a 3-wide RGB
  row padded to 4 bytes a plane is unpacked as it stands).

DCX: the magic 0x3ADE68B1, a table of up to 1024 offsets ended by 0, and
the first frame, a PCX at the first offset (the 769 bytes are the file's
last).
"""
from __future__ import annotations

import struct

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels

_DCX_MAGIC = 0x3ADE68B1
_HEADER = 128


def decode_pcx(data: bytes, name: str = "<pcx>") -> np.ndarray:
    """A PCX file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    return _frame(data, 0, name)


def decode_dcx(data: bytes, name: str = "<dcx>") -> np.ndarray:
    """A DCX file → its first frame, (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 4 or struct.unpack_from("<I", data)[0] != _DCX_MAGIC:
        raise Unidentified(f"{name}: not a DCX file")
    first = 0
    for k in range(1024):
        if len(data) < 8 + 4 * k:
            raise Unidentified(f"{name}: DCX offset table ends after {k} entries")
        offset = struct.unpack_from("<I", data, 4 + 4 * k)[0]
        if not offset:
            break
        first = first or offset
    if not first:
        raise Unidentified(f"{name}: DCX without frames")
    return _frame(data, first, name)


def _frame(data: bytes, start: int, name: str) -> np.ndarray:
    s = data[start: start + 68]
    if len(s) < 2 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        raise Unidentified(f"{name}: not a PCX file")
    if len(s) < 68:
        raise Unidentified(f"{name}: not a PCX file (a header of {len(s)} bytes)")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise Unidentified(f"{name}: not a PCX file (box {x0},{y0} to {x1},{y1})")
    version, bits, planes = s[1], s[3], s[65]
    provided = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        rawmode = f"P;{planes}L"
        palette = np.frombuffer(s, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        rawmode = "L"
        if len(data) < 769:
            raise ValueError(f"{name}: 8-bit PCX of {len(data)} bytes, which Pillow cannot seek "
                             f"769 bytes back in")
        tail = np.frombuffer(data, np.uint8, 769, len(data) - 769)
        if tail[0] == 12 and (tail[1:].reshape(256, 3) != np.arange(256)[:, None]).any():
            rawmode, palette = "P", tail[1:].reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        rawmode = "RGB;L"
    else:
        raise ValueError(f"{name}: PCX version {version} of {bits} bits x {planes} planes, which "
                         f"Pillow does not read")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    check_pixels(width, height, name)
    stride = (width * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    row = planes * stride
    rows = _rle(data, start + _HEADER, row, height, name).reshape(height, row)
    rows = _close_up(rows, width, {"P;2L": 2, "P;4L": 4}.get(rawmode, 0))
    if rawmode == "1":
        px = np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255)
    elif rawmode.startswith("P;"):
        s8 = (width + 7) // 8
        bit = [np.unpackbits(rows[:, k * s8: (k + 1) * s8], axis=1)[:, :width]
               for k in range(planes)]
        px = palette[sum(b << k for k, b in enumerate(bit))]
    elif rawmode == "RGB;L":
        px = np.stack([rows[:, k * width: (k + 1) * width] for k in range(3)], -1)
    else:
        px = rows[:, :width] if palette is None else palette[rows[:, :width]]
    if px.ndim == 2:
        px = np.repeat(px[..., None], 3, axis=2)
    return np.ascontiguousarray(px, np.uint8)


def _close_up(rows: np.ndarray, width: int, bands: int) -> np.ndarray:
    """``PcxDecode.c``'s shuffle of a full row before it is unpacked: each
    band after the first moved down to ``i * xsize`` from ``i * stride``."""
    row = rows.shape[1]
    if bands:  # P;2L, P;4L: one band a plane of ceil(width / 8) bytes
        xsize, stride = (width + 7) // 8, row // bands
    else:
        xsize, bands = width, row // width
        stride = row // bands if bands else 0
    if stride <= xsize:
        return rows
    rows = rows.copy()
    for i in range(1, bands):
        rows[:, i * xsize: (i + 1) * xsize] = rows[:, i * stride: i * stride + xsize]
    return rows


def _rle(data: bytes, pos: int, row: int, height: int, name: str) -> np.ndarray:
    """``PcxDecode.c`` → the image's ``row * height`` bytes. Literal bytes
    (under 0xC0) are copied in stretches up to the next run."""
    total, size = row * height, len(data)
    arr = np.frombuffer(data, np.uint8)
    runs = np.flatnonzero(arr[pos:] >= 0xC0) + pos  # where a run may start
    out = bytearray()
    k = 0
    while len(out) < total:
        k += int(np.searchsorted(runs[k:], pos))
        nxt = int(runs[k]) if k < len(runs) else size
        take = min(nxt - pos, total - len(out))
        out += data[pos: pos + take]
        pos += take
        if len(out) >= total:
            break
        if pos + 1 >= size:
            raise ValueError(f"{name}: PCX image data ends after {len(out)} of {total} bytes")
        n = data[pos] & 0x3F
        if len(out) % row + n > row:
            raise ValueError(f"{name}: PCX run of {n} passes the end of row {len(out) // row}")
        out += data[pos + 1: pos + 2] * n
        pos += 2
    return np.frombuffer(bytes(out), np.uint8)
