"""FITS images without Pillow (numpy and the standard library's ``gzip``).

:func:`decode_fits` gives ``np.asarray(Image.open(p).convert("RGB"))`` for
every file Pillow 12's ``FitsImagePlugin`` opens, and ``ValueError`` naming
the file for those it refuses. It walks the 80-byte cards as Pillow does:

* the first card must be ``SIMPLE = T`` (else Pillow's open raises
  ``SyntaxError`` and ``Image.open`` passes the file on); a card's value is
  what comes before a ``/``, stripped, less a leading ``=``; every header
  unit's cards go into one table, a later one overwriting;
* at ``END`` the reader moves to the next 2880-byte boundary and, until it
  has an image, reads the table: ``NAXIS`` 0 gives none (the next unit is
  read), 1 an image one pixel wide and ``NAXIS1`` high, more ``NAXIS1`` by
  ``NAXIS2``; the first card after that header that starts no header unit
  is the data (where fewer than 80 bytes were left, Pillow takes the data
  to start that many bytes before the end of the card it meant to read);
* ``BITPIX`` 8 is ``L``, 16 ``I;16``, 32 ``I`` and -32 and -64 ``F``, read as
  Pillow reads them, not as the standard has them: little-endian,
  -64 as 4-byte floats over the first half of the data, and the rows
  bottom up. Any other ``BITPIX`` leaves no mode, and the file is passed
  on; a missing key passes it on too, a number Python's ``int`` does not
  read is refused, and so is a file with no image (Pillow's "No image
  data") or one that ends at a card's start;
* a ``BINTABLE`` extension with ``ZIMAGE = T`` and ``ZCMPTYPE = 'GZIP_1  '``
  is Pillow's ``FitsGzipDecoder``: size and ``BITPIX`` from the ``Z`` keys,
  everything after the table's ``NAXIS1 * NAXIS2 * (BITPIX // 8)`` bytes
  gunzipped, of each 4-byte word the last ``ZBITPIX / 8`` bytes (at most
  4; a negative ``ZBITPIX`` takes none, and Pillow finds too little data),
  the rows reversed.

``convert("RGB")`` as :func:`mm_s2ut_torch.data.im.mode_to_rgb` has it.
"""
from __future__ import annotations

import gzip
import math
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from mm_s2ut_torch.data import Unidentified, check_pixels
from mm_s2ut_torch.data.im import mode_to_rgb

# BITPIX → (Pillow's mode, the raw decoder's sample type)
MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"), -32: ("F", "<f4"),
         -64: ("F", "<f4")}


def _int(headers: Dict[bytes, bytes], key: bytes, name: str) -> int:
    if key not in headers:  # Pillow's KeyError, a SyntaxError to Image.open
        raise Unidentified(f"{name}: FITS header without {key.decode('latin-1')}")
    try:
        return int(headers[key])
    except ValueError:
        raise ValueError(f"{name}: FITS {key.decode('latin-1')} {headers[key]!r} is not an "
                         f"integer") from None


def _size(headers: Dict[bytes, bytes], prefix: bytes, name: str) -> Optional[Tuple[int, int]]:
    naxis = _int(headers, prefix + b"NAXIS", name)
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers, prefix + b"NAXIS1", name)
    return _int(headers, prefix + b"NAXIS1", name), _int(headers, prefix + b"NAXIS2", name)


def _image(headers: Dict[bytes, bytes], name: str):
    """``_parse_headers``: (gzip or not, offset past the data start, size,
    BITPIX), or None where the header unit holds no image."""
    gz, offset, prefix = False, 0, b""
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T":
        if b"ZCMPTYPE" not in headers:
            raise Unidentified(f"{name}: FITS tile compression without ZCMPTYPE")
        if headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
            w, h = _size(headers, b"", name) or (0, 0)
            offset = w * h * (_int(headers, b"BITPIX", name) // 8)
            gz, prefix = True, b"Z"
    size = _size(headers, prefix, name)
    if not size:
        return None
    return gz, offset, size, _int(headers, prefix + b"BITPIX", name)


def decode_fits(data: bytes, name: str = "<fits>") -> np.ndarray:
    """A FITS file → (H, W, 3) uint8 RGB, as Pillow gives it."""
    headers: Dict[bytes, bytes] = {}
    in_header, found, pos = False, None, 0
    while True:
        card = data[pos: pos + 80]
        pos += len(card)
        if not card:
            raise ValueError(f"{name}: truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break  # the data unit
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:
                found = _image(headers, name)
            in_header = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise Unidentified(f"{name}: not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError(f"{name}: FITS file with no image data")
    gz, offset, (width, height), bitpix = found
    if bitpix not in MODES or width <= 0 or height <= 0:
        raise Unidentified(f"{name}: FITS image of BITPIX {bitpix}, {width}x{height}")
    check_pixels(width, height, name)
    mode, dtype = MODES[bitpix]
    offset += pos - 80
    if gz:
        return mode_to_rgb(mode, _gzip_rows(data, offset, width, height, bitpix, name)[::-1])
    need = width * height * np.dtype(dtype).itemsize
    if len(data) - offset < need:
        raise ValueError(f"{name}: FITS image data truncated ({max(0, len(data) - offset)} of "
                         f"{need} bytes at {offset})")
    px = np.frombuffer(data, dtype, width * height, offset).reshape(height, width)
    return mode_to_rgb(mode, px[::-1, :, None])


def _gzip_rows(data: bytes, offset: int, width: int, height: int, bitpix: int,
               name: str) -> np.ndarray:
    """``FitsGzipDecoder``: (height, width, 1) samples in the file's row order."""
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"{name}: FITS GZIP_1 data: {e}") from None
    nb = min(bitpix // 8, 4)
    if nb <= 0 or len(value) < 4 * width * height:
        raise ValueError(f"{name}: FITS GZIP_1 data of {len(value)} bytes for {width}x{height} "
                         f"pixels of BITPIX {bitpix}: not enough image data")
    words = np.frombuffer(value, np.uint8, 4 * width * height).reshape(-1, 4)[:, 4 - nb:]
    dtype = MODES[bitpix][1]
    return np.ascontiguousarray(words).view(dtype).reshape(height, width, 1)
