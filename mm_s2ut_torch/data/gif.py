"""GIF files without Pillow (numpy and the standard library only).

:func:`decode_gif` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
GIF87a/89a files as Pillow 12's ``GifImagePlugin`` opens them: the first
frame only, in the mode Pillow gives it (``P`` through the frame's local
palette, else the global one; ``L`` where there is none or it is the gray
ramp i → (i, i, i)), an index past the palette black. The frame sits at
its offset on the logical screen, which grows to hold a frame that passes
its edge; the rest of the screen holds the frame's transparent index
where its graphic control extension names one, else index 0, and
``convert("RGB")`` gives the palette's colour for either. The LZW
decoder follows the code size up to 12 bits, restarts at a clear code,
keeps a full table (a deferred clear) and stops at the end code; rows of
an interlaced frame come in its four passes.
"""
from __future__ import annotations

import struct

import numpy as np


def _blocks(data: bytes, pos: int, name: str):
    """The data sub-blocks from ``pos``: (their bytes joined, the offset past them)."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: truncated GIF data block")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(data[pos: pos + n])
        pos += n


def _palette(raw: bytes, n: int, name: str):
    """A colour table of ``n`` bytes, or None where it is the gray ramp
    (Pillow's ``L``)."""
    if len(raw) < n:
        raise ValueError(f"{name}: truncated GIF colour table")
    pal = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if np.array_equal(pal, np.repeat(np.arange(len(pal))[:, None], 3, 1)):
        return None
    return pal


def lzw_decode(code: bytes, min_size: int, count: int, name: str = "<gif>") -> bytes:
    """GIF's LZW: at most ``count`` indices from the code stream."""
    if not 0 <= min_size <= 11:
        raise ValueError(f"{name}: bad GIF LZW code size {min_size}")
    clear = 1 << min_size
    end = clear + 1
    roots = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(roots)
    size = min_size + 1
    prev = None
    out = bytearray()
    acc = nbits = 0
    for byte in code:
        acc |= byte << nbits
        nbits += 8
        while nbits >= size:
            c = acc & ((1 << size) - 1)
            acc >>= size
            nbits -= size
            if c == clear:
                table = list(roots)
                size, prev = min_size + 1, None
                continue
            if c == end:
                return bytes(out[:count])
            if prev is None:
                if c >= len(table):
                    raise ValueError(f"{name}: bad GIF LZW code {c}")
                entry = table[c]
            elif c < len(table):
                entry = table[c]
                if len(table) < 4096:
                    table.append(prev + entry[:1])
            elif c == len(table) and len(table) < 4096:
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"{name}: bad GIF LZW code {c}")
            out += entry
            prev = entry
            if len(table) == (1 << size) and size < 12:
                size += 1
            if len(out) >= count:
                return bytes(out[:count])
    return bytes(out[:count])


def decode_gif(data: bytes, name: str = "<gif>") -> np.ndarray:
    """A GIF file → its first frame as (H, W, 3) uint8 RGB, as Pillow gives it."""
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{name}: not a GIF file")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13
    global_pal = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        global_pal = _palette(data[pos: pos + n], n, name)
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos: pos + 1] == b";":
            raise ValueError(f"{name}: no image in the GIF file")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # extension: a label, then sub-blocks
            label = data[pos]
            body, pos = _blocks(data, pos + 1, name)
            if label == 0xF9 and body and body[0] & 1 and len(body) >= 4:
                transparency = body[3]
            continue
        if kind != 0x2C:
            continue  # Pillow skips a stray byte between blocks
        if pos + 10 > len(data):
            raise ValueError(f"{name}: truncated GIF image descriptor")
        x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
        pos += 9
        pal = global_pal
        has_pal = global_pal is not None
        if iflags & 128:
            n = 3 << ((iflags & 7) + 1)
            pal = _palette(data[pos: pos + n], n, name)
            has_pal = pal is not None
            pos += n
        break
    min_size = data[pos]
    code, _ = _blocks(data, pos + 1, name)
    idx = np.frombuffer(lzw_decode(code, min_size, w * h, name), np.uint8)
    if idx.size < w * h:
        raise ValueError(f"{name}: GIF image data ends after {idx.size} of {w * h} pixels")
    frame = idx.reshape(h, w)
    if iflags & 64:  # interlaced: rows 0::8, 4::8, 2::4, 1::2 in that order
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        frame = np.empty_like(frame)
        frame[order] = idx.reshape(h, w)
    W, H = max(width, x0 + w), max(height, y0 + h)
    screen = np.full((H, W), transparency or 0, np.uint8)
    screen[y0: y0 + h, x0: x0 + w] = frame
    if not has_pal:
        return np.ascontiguousarray(np.repeat(screen[..., None], 3, 2))
    full = np.zeros((256, 3), np.uint8)
    full[: len(pal)] = pal
    return full[screen]
