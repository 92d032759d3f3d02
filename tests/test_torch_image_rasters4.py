"""FITS, FTEX, GBR, IMT, McIdas, PIXAR and XV thumbnails without Pillow:
``data/image_io.decode_image`` against ``Image.open(path)``: the container
it picks equals Pillow's ``format`` and the pixels equal
``np.asarray(Image.open(path).convert("RGB"))``, max |difference| 0; where
Pillow refuses a file, the port raises ``ValueError`` naming it.

* FITS (``data/fits.py``): every BITPIX (8, 16, 32, -32, -64) written
  big-endian as the standard has it and little-endian, NAXIS 1 and 2, a
  primary header with no image before the extension that has one, the
  ``GZIP_1`` tiles of a ``BINTABLE``, the header's rules.
* FTEX (``data/ftex.py``): DXT1 and raw RGB at widths that are and are not
  multiples of 4, a mipmap size below 0 or past the end.
* GBR (``data/gbr.py``): versions 1 and 2, depths 1 and 4, comments.
* IMT (``data/imt.py``): comments, the header's ends, lines past the
  first 100 bytes.
* McIdas (``data/mcidas.py``): 1, 2 and 4 bytes a sample, line prefixes,
  strides that pack the rows, overlap them or pad them, as Pillow's memory
  map and raw decoder read them.
* PIXAR (``data/pixar.py``) and XV thumbnails (``data/xvthumb.py``).

Pillow writes none of these formats; the writers here do.
:func:`raster4_fixture_bytes` gives the committed fixtures under
``tests/torch_images/formats/``, written anew with the other formats by
``PYTHONPATH=. python tests/test_torch_image_formats.py``. Run on the CPU
with ``python -m pytest -q tests/test_torch_image_rasters4.py``.
"""
import gzip
import random
import struct

import numpy as np
import pytest
from PIL import Image

from mm_s2ut_torch.data import Unidentified
from mm_s2ut_torch.data import image_io as I
from mm_s2ut_torch.data.im import decode_im
from mm_s2ut_torch.data.imt import decode_imt
from mm_s2ut_torch.data.spider import decode_spider
from mm_s2ut_torch.data.tga import decode_tga
from mm_s2ut_torch.data.xvthumb import PALETTE
from test_torch_image_formats import FORMATS, scene
from test_torch_image_rasters2 import _runny, assert_as_pil, assert_refused
from test_torch_image_rasters3 import dxt_blocks, same_as_pil

# ---------------------------------------------------------------------- FITS


def card(key: str, value=None, comment: str = "") -> bytes:
    """An 80-byte card: ``key``, then ``= value`` (strings quoted as given)."""
    s = f"{key:<8}"
    if value is not None:
        s += f"= {value:>20}" if isinstance(value, int) else f"= {value}"
    if comment:
        s += f" / {comment}"
    return s.encode("latin-1").ljust(80)[:80]


def fits_unit(cards) -> bytes:
    """A header unit: the cards, ``END``, spaces to the next 2880 bytes."""
    head = b"".join(cards) + card("END")
    return head + b" " * (-len(head) % 2880)


FITS_DTYPES = {8: "u1", 16: "i2", 32: "i4", -32: "f4", -64: "f8"}


def fits_values(bitpix: int, h: int, w: int, seed: int) -> np.ndarray:
    """Samples of ``bitpix`` over ``convert("RGB")``'s clip: negatives, past
    255, fractions (NaN and ±inf for floats)."""
    rng = np.random.RandomState(seed)
    if bitpix == 8:
        return _runny((h, w), seed)
    if bitpix > 0:
        v = rng.randint(-60, 330, (h, w))
        v.flat[:4] = [0, 255, 256, 1 << 10]
        return v.astype(FITS_DTYPES[bitpix])
    v = rng.uniform(-40, 300, (h, w))
    v.flat[:6] = [-3.7, 0.6, 254.5, np.nan, np.inf, -np.inf]
    return v.astype(FITS_DTYPES[bitpix])


def fits_bytes(bitpix: int, px: np.ndarray, order: str = ">", naxis: int = 2,
               cards=(), pad: bool = True) -> bytes:
    """A primary unit of ``px`` (NAXIS 1: its values as one axis), its data
    in ``order`` (FITS is big-endian), zeros to the next 2880 bytes (or,
    without ``pad``, none)."""
    h, w = px.shape
    axes = [card("NAXIS1", w * h)] if naxis == 1 else [card("NAXIS1", w), card("NAXIS2", h)]
    unit = fits_unit([card("SIMPLE", "T"), card("BITPIX", bitpix), card("NAXIS", naxis), *axes,
                      *cards])
    body = px.astype(order + FITS_DTYPES[bitpix]).tobytes()
    return unit + body + bytes(-len(body) % 2880 if pad else 0)


def fits_gzip(zbitpix: int, words: np.ndarray, table=(8, 2), ext_cards=(), stream=None) -> bytes:
    """A primary unit without an image, then a ``BINTABLE`` of ``GZIP_1``
    tiles: the table's bytes, then ``words`` (h, w) as gzipped big-endian
    32-bit words (or ``stream``), zeros to the next 2880 bytes."""
    h, w = words.shape
    primary = fits_unit([card("SIMPLE", "T"), card("BITPIX", 8), card("NAXIS", 0)])
    ext = fits_unit([card("XTENSION", "'BINTABLE'"), card("BITPIX", 8), card("NAXIS", 2),
                     card("NAXIS1", table[0]), card("NAXIS2", table[1]), card("PCOUNT", 0),
                     card("GCOUNT", 1), card("TFIELDS", 1), card("ZIMAGE", "T"),
                     card("ZBITPIX", zbitpix), card("ZNAXIS", 2), card("ZNAXIS1", w),
                     card("ZNAXIS2", h), card("ZCMPTYPE", "'GZIP_1  '"), *ext_cards])
    if stream is None:
        stream = gzip.compress(words.astype(">i4").tobytes(), mtime=0)
    body = bytes(range(table[0] * table[1])) + stream
    return primary + ext + body + bytes(-len(body) % 2880)


@pytest.mark.parametrize("naxis", [1, 2])
@pytest.mark.parametrize("order", [">", "<"])
@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
def test_fits_bitpix_orders_equal_pil(bitpix, order, naxis, tmp_path):
    """Every BITPIX in both byte orders: Pillow reads little-endian (16 and
    32 bits as ``I;16`` and ``I``, -32 and -64 as 4-byte floats), bottom
    row first."""
    px = fits_values(bitpix, 6, 11, bitpix + 100 + len(order))
    assert_as_pil(fits_bytes(bitpix, px, order, naxis), tmp_path, "x.fits")


@pytest.mark.parametrize("zbitpix", [8, 16, 32])
@pytest.mark.parametrize("w", [1, 7, 20])
def test_fits_gzip_tiles_equal_pil(zbitpix, w, tmp_path):
    words = np.random.RandomState(w + zbitpix).randint(-2 ** 31, 2 ** 31, (12, w), np.int64)
    words.flat[:3] = [7, 255 << 8, 1]
    assert_as_pil(fits_gzip(zbitpix, words), tmp_path, "x.fits")


FITS_HEADERS = {  # name → cards after NAXIS2 of a 4x3 8-bit image
    "comment_after_value": [card("OBJECT", "'M31 / a galaxy'")],
    "duplicate_bitpix_later_wins": [card("BITPIX", 16)],
    "bitpix_unknown": [card("BITPIX", 24)],
    "bitpix_not_a_number": [card("BITPIX", "8.0")],
    "naxis1_zero": [card("NAXIS1", 0)],
    "naxis_negative": [card("NAXIS", -2)],
    "naxis_3_no_naxis2_number": [card("NAXIS", 3), b"NAXIS2  = no".ljust(80)],
    "no_naxis2": [card("NAXIS2")],
    "blank_and_history_cards": [b" " * 80, card("HISTORY")],
}


@pytest.mark.parametrize("case", sorted(FITS_HEADERS))
def test_fits_header_rules_equal_pil(case, tmp_path):
    """Cards as ``FitsImageFile._open`` reads them: the value before ``/``, a
    later card overwriting an earlier one, numbers as Python's ``int`` reads
    them; headers Pillow passes on or refuses, as the port does."""
    same_as_pil(fits_bytes(8, _runny((3, 4), 9), cards=FITS_HEADERS[case]), tmp_path, "x.fits")


@pytest.mark.parametrize("case", ["image_in_extension", "data_shorter_than_a_card",
                                  "simple_false", "simplex", "no_end", "no_image_then_data",
                                  "gzip_without_zcmptype", "gzip_rice", "gzip_negative_bitpix",
                                  "gzip_short", "gzip_trailing_zeros"])
def test_fits_units_equal_pil(case, tmp_path):
    """Header units as Pillow walks them: the image of a later unit, data
    that fewer than 80 bytes hold (Pillow's offset then starts before it),
    first cards it does not take, a header without ``END``, a unit with no
    image and data after it, the ``GZIP_1`` path's keys and data."""
    px = _runny((3, 4), 10)
    words = np.arange(12).reshape(3, 4) * 77
    data = {
        "image_in_extension": lambda: fits_unit([card("SIMPLE", "T"), card("NAXIS", 0)])
        + fits_unit([card("XTENSION", "'IMAGE   '"), card("BITPIX", 8), card("NAXIS", 2),
                     card("NAXIS1", 4), card("NAXIS2", 3)]) + px.tobytes(),
        "data_shorter_than_a_card": lambda: fits_bytes(8, px, pad=False),
        "simple_false": lambda: fits_bytes(8, px).replace(b"SIMPLE  = T",
                                                          b"SIMPLE  = F", 1),
        "simplex": lambda: b"SIMPLEX " + fits_bytes(8, px)[8:],
        "no_end": lambda: b"".join([card("SIMPLE", "T"), card("BITPIX", 8), card("NAXIS", 2),
                                    card("NAXIS1", 4), card("NAXIS2", 3)]) + px.tobytes(),
        "no_image_then_data": lambda: fits_unit([card("SIMPLE", "T"), card("NAXIS", 0)])
        + bytes(range(100)),
        "gzip_without_zcmptype": lambda: fits_gzip(8, words).replace(b"ZCMPTYPE", b"ZCMPTYPX"),
        "gzip_rice": lambda: fits_gzip(8, words).replace(b"'GZIP_1  '", b"'RICE_1  '"),
        "gzip_negative_bitpix": lambda: fits_gzip(-32, words),
        "gzip_short": lambda: fits_gzip(8, words, stream=gzip.compress(bytes(47), mtime=0)),
        "gzip_trailing_zeros": lambda: fits_gzip(16, words) + bytes(9),
    }[case]()
    same_as_pil(data, tmp_path, "x.fits")


# ---------------------------------------------------------------------- FTEX

def ftex_bytes(fmt: int, w: int, h: int, payload: bytes, count: int = 1, where=None,
               size=None) -> bytes:
    where = 32 if where is None else where
    head = b"FTEX" + struct.pack("<5i", 1, w, h, 1, count) + struct.pack("<2i", fmt, where)
    return head + bytes(max(0, where - 32)) + struct.pack(
        "<i", len(payload) if size is None else size) + payload


@pytest.mark.parametrize("w,h", [(4, 4), (6, 5), (13, 9), (1, 1), (16, 3)])
@pytest.mark.parametrize("fmt", [0, 1])
def test_ftex_formats_equal_pil(fmt, w, h, tmp_path):
    """DXT1 through the ``bcn`` decoder (3-colour blocks' fourth colour
    black once alpha is dropped) and raw RGB."""
    payload = dxt_blocks(w, h, 0, w * h) if fmt == 0 else _runny((h, w, 3), w).tobytes()
    assert_as_pil(ftex_bytes(fmt, w, h, payload), tmp_path, "x.ftc")


@pytest.mark.parametrize("case", ["size_minus_1_reads_on", "size_minus_7", "size_short",
                                  "size_long", "where_later", "where_past_end", "where_negative",
                                  "two_formats", "format_2", "height_0", "header_cut"])
def test_ftex_header_rules_equal_pil(case, tmp_path):
    """The mipmap's byte count (-1 the rest of the file, below that Pillow's
    read raises), its offset (past the end Pillow's ``struct.error`` passes
    the file on, below 0 its seek raises), the asserted format count, the
    format, the size."""
    rgb = _runny((5, 6, 3), 3).tobytes()
    data = {"size_minus_1_reads_on": lambda: ftex_bytes(1, 6, 5, rgb, size=-1),
            "size_minus_7": lambda: ftex_bytes(1, 6, 5, rgb, size=-7),
            "size_short": lambda: ftex_bytes(1, 6, 5, rgb, size=len(rgb) - 1),
            "size_long": lambda: ftex_bytes(1, 6, 5, rgb + b"xyz", size=len(rgb) + 99),
            "where_later": lambda: ftex_bytes(1, 6, 5, rgb, where=40),
            "where_past_end": lambda: ftex_bytes(1, 6, 5, b"", where=200)[:100],
            "where_negative": lambda: ftex_bytes(1, 6, 5, rgb, where=-4),
            "two_formats": lambda: ftex_bytes(1, 6, 5, rgb, count=2),
            "format_2": lambda: ftex_bytes(2, 6, 5, rgb),
            "height_0": lambda: ftex_bytes(1, 6, 0, rgb),
            "header_cut": lambda: ftex_bytes(1, 6, 5, rgb)[:30]}[case]()
    same_as_pil(data, tmp_path, "x.ftu")


# ----------------------------------------------------------------------- GBR

def gbr_bytes(version: int, px: np.ndarray, comment: bytes = b"a brush\0", spacing: int = 25,
              size=None) -> bytes:
    h, w, depth = px.shape
    fixed = 20 if version == 1 else 28
    head = struct.pack(">5I", fixed + len(comment) if size is None else size, version, w, h,
                       depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", spacing)
    return head + comment + px.tobytes()


@pytest.mark.parametrize("w", [1, 7, 32])
@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("version", [1, 2])
def test_gbr_versions_depths_equal_pil(version, depth, w, tmp_path):
    """Depth 1 is ``L``; depth 4 ``RGBA``, its alpha dropped."""
    assert_as_pil(gbr_bytes(version, _runny((5, w, depth), w + depth)), tmp_path, "x.gbr")


@pytest.mark.parametrize("case", ["no_comment", "long_comment", "v2_header_27", "v2_header_24",
                                  "v2_bad_magic", "depth_3", "width_0", "data_short",
                                  "version_3"])
def test_gbr_header_rules_equal_pil(case, tmp_path):
    """The comment's length from the header's size (version 2's -1 reads the
    rest of the file, one below that raises), the magic, depth, size and version Pillow
    passes the file on for, data short of the image."""
    px = _runny((3, 5, 1), 4)
    data = {"no_comment": lambda: gbr_bytes(1, px, b""),
            "long_comment": lambda: gbr_bytes(2, px, bytes(range(1, 200)) + b"\0"),
            "v2_header_27": lambda: gbr_bytes(2, px, b"", size=27),
            "v2_header_24": lambda: gbr_bytes(2, px, b"", size=24),
            "v2_bad_magic": lambda: gbr_bytes(2, px).replace(b"GIMP", b"GIMQ"),
            "depth_3": lambda: gbr_bytes(1, np.concatenate([px] * 3, 2)),
            "width_0": lambda: gbr_bytes(1, px[:, :0]),
            "data_short": lambda: gbr_bytes(1, px)[:-1],
            "version_3": lambda: gbr_bytes(1, px)[:4] + struct.pack(">I", 3)
            + gbr_bytes(1, px)[8:]}[case]()
    same_as_pil(data, tmp_path, "x.gbr")


# ----------------------------------------------------------------------- IMT

def imt_bytes(lines, px: np.ndarray, ff: bytes = b"\x0c") -> bytes:
    return b"".join(line + b"\n" for line in lines) + ff + px.tobytes()


def imt_lines(w: int, h: int, *extra: bytes):
    return [b"width %d" % w, b"height %d" % h, b"pixel n8", *extra]


@pytest.mark.parametrize("w,h", [(1, 1), (9, 4), (64, 3)])
def test_imt_equals_pil(w, h, tmp_path):
    assert_as_pil(imt_bytes(imt_lines(w, h), _runny((h, w), w)), tmp_path, "x.imt")


IMT_HEADERS = {
    "comments": [b"* made by hand", b"width 6", b"* more", b"height 4", b"pixel n8"],
    "pixel_first": [b"pixel n8", b"height 4", b"width 6"],
    "no_n8": [b"width 6", b"height 4", b"pixel n16"],
    "width_later_wins": [b"width 9", b"height 4", b"pixel n8", b"width 6"],
    "cr_lf": [b"width 6\r", b"height 4\r", b"pixel n8\r"],
    "number_rules": [b"width +0_6", b"height 04", b"pixel n8"],
    "not_a_number": [b"width six", b"height 4", b"pixel n8"],
    "empty_line_ends": [b"width 6", b"", b"height 4", b"pixel n8"],
    "one_byte_line_ends": [b"width 6", b"height 4", b"pixel n8", b"x"],
    "one_space_line_ends": [b"width 6", b" ", b"height 4", b"pixel n8"],
    "bad_line_ends": [b"width 6", b"height 4", b"pixel n8", b"Width 3"],
    "long_line_ends": [b"width 6", b"height 4", b"pixel n8", b"* " + b"c" * 99],
    "late_lines": [b"* " + b"c" * 60, b"* " + b"d" * 60, b"width 6", b"height 4", b"pixel n8"],
    "no_newline_in_100": [b"* " + b"c" * 99, b"width 6", b"height 4", b"pixel n8"],
    "no_newline_early": [b"width" + b" " * 101 + b"6"],
    "size_negative": [b"width -6", b"height 4", b"pixel n8"],
}


@pytest.mark.parametrize("case", sorted(IMT_HEADERS))
def test_imt_header_rules_equal_pil(case, tmp_path):
    """``ImtImageFile._open``'s lines: comments, any order, a later line
    winning, ``\\r`` kept in the value (``int`` strips it), lines that end
    the header (no data then: Pillow cannot load it), lines past the first
    100 bytes; without ``pixel n8`` or a positive size the file is passed
    on."""
    same_as_pil(imt_bytes(IMT_HEADERS[case], _runny((4, 6), 5)), tmp_path, "x.imt")


def test_imt_header_ending_without_data_is_refused(tmp_path):
    assert_refused(imt_bytes(imt_lines(6, 4), _runny((4, 6), 6), ff=b""), tmp_path, "x.imt",
                   "ends before its data")


# -------------------------------------------------------------------- McIdas

def mcidas_bytes(px: np.ndarray, nbytes: int, prefix: int = 0, bands: int = 1,
                 offset: int = 256, stride=None, tail: int = 0, words=None) -> bytes:
    """An area descriptor, then rows ``stride`` bytes apart (``prefix`` bytes
    of line prefix before each, the other bands' bytes after it) from
    ``offset``; ``words``: descriptor words by their 1-based index."""
    h, w = px.shape
    wd = [0] * 65
    wd[2], wd[9], wd[10], wd[11], wd[14], wd[15], wd[34] = 4, h, w, nbytes, bands, prefix, offset
    for k, v in (words or {}).items():
        wd[k] = v
    row = w * nbytes
    step = prefix + row * bands if stride is None else stride
    raw = px.astype({1: "u1", 2: ">u2", 4: ">i4"}[nbytes]).tobytes()
    body = bytearray(np.random.RandomState(w).randint(0, 256, max(0, offset - 256 + prefix + (
        h - 1) * step + row + tail)).astype(np.uint8).tobytes())
    at = offset - 256 + prefix
    for y in range(h):
        body[at + y * step: at + y * step + row] = raw[y * row: (y + 1) * row]
    return struct.pack(">64i", *wd[1:]) + bytes(body)


def mcidas_values(nbytes: int, h: int, w: int, seed: int) -> np.ndarray:
    if nbytes == 1:
        return _runny((h, w), seed)
    v = np.random.RandomState(seed).randint(-300 if nbytes == 4 else 0, 600, (h, w))
    v.flat[:3] = [255, 256, 0]
    return v


@pytest.mark.parametrize("bands", [1, 3])
@pytest.mark.parametrize("prefix", [0, 12])
@pytest.mark.parametrize("nbytes", [1, 2, 4])
def test_mcidas_widths_prefixes_bands_equal_pil(nbytes, prefix, bands, tmp_path):
    """``L``, ``I;16B`` clamped to 255 and ``I`` clipped to 0..255, with line
    prefixes and the other bands' bytes between the rows."""
    px = mcidas_values(nbytes, 5, 9, nbytes * 10 + prefix + bands)
    assert_as_pil(mcidas_bytes(px, nbytes, prefix, bands, tail=prefix + 40), tmp_path, "x.area")


@pytest.mark.parametrize("stride", ["packed_0", "negative", "short", "no_padding_after_last",
                                    "padded", "long_past_end"])
@pytest.mark.parametrize("nbytes", [1, 2, 4])
def test_mcidas_strides_equal_pil(nbytes, stride, tmp_path):
    """The stride word as Pillow uses it: ``L`` and ``I;16B`` through its
    memory map (0 or less is a row; shorter than a row overlaps the rows;
    the file must hold every row's stride) where the file holds height
    strides, else through the raw decoder (0 packs the rows, shorter than a
    row is refused, the last row needs no padding after it)."""
    px = mcidas_values(nbytes, 4, 7, nbytes + len(stride))
    row = 7 * nbytes
    kw = {"packed_0": dict(stride=0, words={14: 0}), "negative": dict(stride=row, words={14: -1}),
          "short": dict(stride=row, words={15: 0, 14: 0}, tail=3),
          "no_padding_after_last": dict(prefix=5, bands=2),
          "padded": dict(prefix=5, bands=2, tail=row + 5),
          "long_past_end": dict(prefix=200)}[stride]
    data = mcidas_bytes(px, nbytes, **kw)
    if stride == "short":  # the stride word says 3 bytes, the rows lie a row apart
        data = data[:56] + struct.pack(">i", 3) + data[60:]
    same_as_pil(data, tmp_path, "x.area")


# --------------------------------------------------------------- PIXAR and XV

def pixar_bytes(px: np.ndarray, pair=(14, 2)) -> bytes:
    h, w, _ = px.shape
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<2H", head, 416, h, w)
    struct.pack_into("<2H", head, 424, *pair)
    return bytes(head) + px.tobytes()


@pytest.mark.parametrize("w,h", [(1, 1), (7, 5), (40, 3)])
def test_pixar_equals_pil(w, h, tmp_path):
    assert_as_pil(pixar_bytes(_runny((h, w, 3), w)), tmp_path, "x.pxr")


@pytest.mark.parametrize("pair", [(14, 1), (8, 2), (15, 2), (0, 0)])
def test_pixar_other_modes_are_passed_on(pair, tmp_path):
    """Pillow reads one channel and depth pair; any other leaves no mode, and
    no other plugin takes the file."""
    data = pixar_bytes(_runny((3, 4, 3), 1), pair)
    assert same_as_pil(data, tmp_path, "x.pxr") is None


XV_COMMENTS = (b"#XVVERSION:Version 2.28  Rev: 9/26/92", b"#IMGINFO:512x440 Color JPEG",
               b"#END_OF_COMMENTS")


def xv_bytes(idx: np.ndarray, comments=XV_COMMENTS, size_line=None, first=b"\n") -> bytes:
    h, w = idx.shape
    size_line = b"%d %d 255" % (w, h) if size_line is None else size_line
    return (b"P7 332" + first + b"".join(c + b"\n" for c in comments) + size_line + b"\n"
            + idx.tobytes())


def test_xvthumb_palette_is_pillows():
    from PIL import XVThumbImagePlugin
    np.testing.assert_array_equal(PALETTE.reshape(-1), np.frombuffer(
        XVThumbImagePlugin.PALETTE, np.uint8))


@pytest.mark.parametrize("case", ["comments", "no_comments", "rest_of_first_line",
                                  "size_only", "size_tabs", "size_one_field", "size_not_int",
                                  "size_zero", "ends_in_comments", "hash_later_is_data"])
def test_xvthumb_header_rules_equal_pil(case, tmp_path):
    """The rest of the magic's line skipped, ``#`` lines skipped, the first
    two fields of the next line as Python's ``int`` reads them."""
    idx = _runny((5, 8), 12)
    data = {"comments": lambda: xv_bytes(idx),
            "no_comments": lambda: xv_bytes(idx, ()),
            "rest_of_first_line": lambda: xv_bytes(idx, first=b" extra words\n"),
            "size_only": lambda: xv_bytes(idx, size_line=b"8 5"),
            "size_tabs": lambda: xv_bytes(idx, size_line=b"\t8\t5  7 9"),
            "size_one_field": lambda: xv_bytes(idx, size_line=b"8"),
            "size_not_int": lambda: xv_bytes(idx, size_line=b"8 five"),
            "size_zero": lambda: xv_bytes(idx, size_line=b"0 5"),
            "ends_in_comments": lambda: b"P7 332\n#a\n#b",
            "hash_later_is_data": lambda: xv_bytes(np.full((5, 8), 35, np.uint8))}[case]()
    same_as_pil(data, tmp_path, "x.xv")


# ------------------------------------------------------- Image.open's order

def test_magicless_plugins_pass_an_xv_thumbnail_on(tmp_path):
    """IM, IMT, SPIDER and TGA come before XVThumb and have no magic: each
    refuses the file's header as Pillow's open does, so it reaches XVThumb."""
    data = xv_bytes(_runny((6, 10), 13))
    for decode in (decode_im, decode_imt, decode_spider, decode_tga):
        with pytest.raises(Unidentified):
            decode(data, "x.xv")
    assert same_as_pil(data, tmp_path, "x.xv") == "XVThumb"


def test_im_passes_an_imt_file_on(tmp_path):
    """IM comes before IMT: a line without a colon is its ``SyntaxError``."""
    data = imt_bytes(imt_lines(5, 3), _runny((3, 5), 14))
    with pytest.raises(Unidentified):
        decode_im(data, "x.imt")
    assert same_as_pil(data, tmp_path, "x.imt") == "IMT"


def test_im_and_imt_pass_a_mcidas_file_with_a_newline_on(tmp_path):
    """A McIdas descriptor holding a ``\\n`` (a width of 10) reaches IM and
    IMT first; both refuse its header."""
    data = mcidas_bytes(_runny((3, 10), 15), 1)
    assert b"\n" in data[:100]
    for decode in (decode_im, decode_imt):
        with pytest.raises(Unidentified):
            decode(data, "x.area")
    assert same_as_pil(data, tmp_path, "x.area") == "MCIDAS"


def _passed_on_cases():
    """Pillow's rules where its plugin's open raises ``SyntaxError`` and
    ``Image.open`` passes the file on: name → (bytes, the port's decoder)."""
    from mm_s2ut_torch.data.fits import decode_fits
    from mm_s2ut_torch.data.gbr import decode_gbr
    from mm_s2ut_torch.data.mcidas import decode_mcidas
    from mm_s2ut_torch.data.pixar import decode_pixar
    from mm_s2ut_torch.data.xvthumb import decode_xvthumb

    px = _runny((3, 4), 16)
    return {
        "fits_bitpix_24_no_mode": (fits_bytes(8, px, cards=[card("BITPIX", 24)]), decode_fits),
        "fits_first_card_not_simple_t": (fits_bytes(8, px).replace(b"SIMPLE  = T",
                                                                  b"SIMPLE  = F", 1),
                                         decode_fits),
        "pixar_only_14_2_is_rgb": (pixar_bytes(_runny((3, 4, 3), 16), (14, 1)), decode_pixar),
        "imt_without_n8_no_mode": (imt_bytes(IMT_HEADERS["no_n8"], _runny((4, 6), 5)),
                                   decode_imt),
        "gbr_depth_2": (gbr_bytes(1, np.concatenate([px[..., None]] * 2, 2)), decode_gbr),
        "mcidas_w11_3": (mcidas_bytes(px, 1, words={11: 3}), decode_mcidas),
        "xvthumb_size_0": (xv_bytes(px, size_line=b"0 3"), decode_xvthumb),
    }


@pytest.mark.parametrize("case", sorted(_passed_on_cases()))
def test_table_of_files_pillow_passes_on(case, tmp_path):
    """Each plugin's open raises what ``Image.open`` passes on, and no later
    plugin (the magic-less IM, IMT, SPIDER and TGA among them) takes the
    file: Pillow cannot identify it; the port's decoder raises
    ``Unidentified`` there and ``decode_image`` a ``ValueError``."""
    from PIL import UnidentifiedImageError

    data, decode = _passed_on_cases()[case]
    (tmp_path / "x.img").write_bytes(data)
    with pytest.raises(UnidentifiedImageError):
        Image.open(tmp_path / "x.img")
    with pytest.raises(Unidentified):
        decode(data, "x.img")
    assert same_as_pil(data, tmp_path, "x.img") is None


def test_sun_raster_one_pixel_wide_goes_to_gbr_and_is_refused(tmp_path):
    """A Sun raster 1 pixel wide whose length field is 1 passes GBR's test
    (its magic is a header size past 20, its width version 1); Pillow's GBR
    plugin opens it and fails to load it, before SUN is tried."""
    sun = struct.pack(">8I", 0x59A66A95, 1, 3, 8, 1, 1, 0, 0) + bytes(3)
    assert_refused(sun, tmp_path, "x.ras", "GIMP brush")


# ------------------------------------------------- Pillow's rules, one case each

def _table_cases():
    return {  # name → (bytes, Pillow's format, mode, first row's first channel)
        "fits_rows_bottom_up": (fits_bytes(8, np.array([[1, 2], [3, 4]])), "FITS", "L", [3, 4]),
        "fits_16_little_endian": (fits_bytes(16, np.array([[0x100, 0x500]])), "FITS", "I;16",
                                  [1, 5]),
        "fits_32_little_endian": (fits_bytes(32, np.array([[1, 1 << 24]])), "FITS", "I",
                                  [255, 1]),
        "fits_minus64_as_floats": (fits_bytes(-64, np.array([[0.0, 0.0]])).replace(
            bytes(16), np.array([3.7, 200.2, 0, 0], "<f4").tobytes()), "FITS", "F", [3, 200]),
        "fits_naxis1_one_column": (fits_bytes(8, np.array([[1, 2, 3]]), naxis=1), "FITS", "L",
                                   [3]),
        "fits_gzip_low_bytes_rows_reversed": (fits_gzip(8, np.array([[0x107, 0x208]] * 11
                                                                    + [[0x309, 0x40A]])),
                                              "FITS", "L", [9, 10]),
        "ftex_dxt1_fourth_colour_black": (ftex_bytes(0, 4, 4, struct.pack("<HHI", 0, 0xFFFF,
                                                                          0xFFFFFFFF)),
                                          "FTEX", "RGBA", [0] * 4),
        "gbr_rgba_alpha_dropped": (gbr_bytes(2, np.array([[[9, 8, 7, 0]]], np.uint8)), "GBR",
                                   "RGBA", [9]),
        "imt_gray": (imt_bytes(imt_lines(2, 1), np.array([[5, 6]], np.uint8)), "IMT", "L",
                     [5, 6]),
        "mcidas_i16b_clamps": (mcidas_bytes(np.array([[7, 300]]), 2), "MCIDAS", "I;16B",
                               [7, 255]),
        "mcidas_i32_clips": (mcidas_bytes(np.array([[-5, 300, 9]]), 4), "MCIDAS", "I",
                             [0, 255, 9]),
        "pixar_rgb_from_1024": (pixar_bytes(np.array([[[4, 5, 6]]], np.uint8)), "PIXAR", "RGB",
                                [4]),
        "xvthumb_332_palette": (xv_bytes(np.array([[0xFF, 0b00100101, 0]], np.uint8)),
                                "XVThumb", "P", [255, 36, 0]),
    }


TABLE = sorted(_table_cases())


@pytest.mark.parametrize("case", TABLE)
def test_table_of_pillow_rules(case, tmp_path):
    data, fmt, mode, first_row = _table_cases()[case]
    (tmp_path / "x.img").write_bytes(data)
    with Image.open(tmp_path / "x.img") as im:
        assert (im.format, im.mode) == (fmt, mode)
    got = assert_as_pil(data, tmp_path, "x.img")
    assert got[0, :, 0].tolist() == first_row


# ------------------------------------------------------------------ refusals

def _refusals():
    px = _runny((3, 4), 17)
    fits = fits_bytes(8, px)
    return {
        "fits_truncated.fits": (fits_bytes(16, _runny((8, 9), 1), pad=False)[:-1], "truncated"),
        "fits_ends_at_a_card.fits": (fits_unit([card("SIMPLE", "T"), card("NAXIS", 0)]),
                                     "truncated FITS"),
        "fits_no_image_data.fits": (fits_unit([card("SIMPLE", "T"), card("NAXIS", 0)])
                                    + bytes(80), "no image data"),
        "fits_naxis_not_int.fits": (fits.replace(card("NAXIS", 2), card("NAXIS", "2.5")),
                                    "NAXIS"),
        "fits_gzip_negative_bitpix.fits": (fits_gzip(-64, np.ones((12, 9), np.int64)),
                                           "not enough"),
        "fits_gzip_not_gzip.fits": (fits_gzip(8, px, stream=b"\x1f\x8bnot gzip"), "GZIP_1"),
        "ftex_two_formats.ftc": (ftex_bytes(0, 4, 4, bytes(8), count=2), "formats"),
        "ftex_format_2.ftc": (ftex_bytes(2, 4, 4, bytes(8)), "format 2"),
        "ftex_where_negative.ftc": (ftex_bytes(0, 4, 4, bytes(8), where=-1), "negative"),
        "ftex_dxt1_truncated.ftc": (ftex_bytes(0, 8, 4, bytes(15)), "truncated"),
        "ftex_rgb_truncated.ftu": (ftex_bytes(1, 2, 2, bytes(11)), "truncated"),
        "gbr_truncated.gbr": (gbr_bytes(1, px[..., None])[:-1], "not enough"),
        "gbr_v2_header_short.gbr": (gbr_bytes(2, px[..., None], b"", size=27), "not enough"),
        "imt_width_not_a_number.imt": (imt_bytes([b"width x", b"height 3", b"pixel n8"], px),
                                       "number"),
        "imt_truncated.imt": (imt_bytes(imt_lines(4, 3), px)[:-1], "truncated"),
        "mcidas_truncated.area": (mcidas_bytes(px, 2)[:-1], "buffer|truncated"),
        "mcidas_negative_offset.area": (mcidas_bytes(px, 1, words={34: -300}), "negative"),
        "mcidas_i32_stride_short.area": (mcidas_bytes(px, 4, prefix=3, words={14: 0}),
                                         "shorter"),
        "mcidas_map_too_short.area": (mcidas_bytes(px, 1, prefix=0, words={14: -1}, tail=0)[:-1],
                                      "buffer"),
        "pixar_truncated.pxr": (pixar_bytes(_runny((3, 4, 3), 1))[:-1], "truncated"),
        "xvthumb_one_field.xv": (xv_bytes(px, size_line=b"4"), "size line"),
        "xvthumb_truncated.xv": (xv_bytes(px)[:-1], "truncated"),
    }


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("name", REFUSALS)
def test_what_pillow_refuses_raises_naming_the_file(name, tmp_path):
    data, match = _refusals()[name]
    assert_refused(data, tmp_path, name, match)


# ------------------------------------------------------------------ fixtures

def raster4_fixture_bytes():
    """name → bytes of the committed FITS, FTEX, GBR, IMT, McIdas, PIXAR and
    XV thumbnail fixtures (each at most 64x48, a few KB)."""
    rgb = scene(17, 23, seed=120)
    gray = scene(17, 23, c=1, seed=121)[..., 0]
    wide = np.asarray(Image.fromarray(scene(37, 45, seed=122)).convert(
        "P", palette=Image.Palette.ADAPTIVE))
    return {
        "fits_8.fits": fits_bytes(8, gray),
        "fits_16.fits": fits_bytes(16, fits_values(16, 17, 23, 123)),
        "fits_16_le.fits": fits_bytes(16, gray.astype(np.int64) + 100, "<"),
        "fits_32.fits": fits_bytes(32, fits_values(32, 17, 23, 124)),
        "fits_32_le.fits": fits_bytes(32, gray.astype(np.int64) * 2 - 100, "<"),
        "fits_f32.fits": fits_bytes(-32, fits_values(-32, 17, 23, 125), "<"),
        "fits_f64.fits": fits_bytes(-64, fits_values(-64, 17, 23, 126)),
        "fits_naxis1.fits": fits_bytes(8, gray[:2, :20], naxis=1),
        "fits_gzip_8.fits": fits_gzip(8, gray.astype(np.int64) + (5 << 8)),
        "fits_gzip_16.fits": fits_gzip(16, (gray.astype(np.int64) << 8) | 1),
        "fits_gzip_32.fits": fits_gzip(32, gray.astype(np.int64) << 24),
        "ftex_dxt1.ftc": ftex_bytes(0, 23, 17, dxt_blocks(23, 17, 0, 127)),
        "ftex_rgb.ftu": ftex_bytes(1, 23, 17, rgb.tobytes()),
        "gbr_v1_gray.gbr": gbr_bytes(1, gray[..., None], b"v1 brush\0"),
        "gbr_v1_rgba.gbr": gbr_bytes(1, scene(17, 23, c=4, seed=128), b"v1 colour\0"),
        "gbr_v2_gray.gbr": gbr_bytes(2, gray[..., None], b"v2 brush\0"),
        "gbr_v2_rgba.gbr": gbr_bytes(2, scene(17, 23, c=4, seed=129), b"v2 colour\0", 10),
        "imt_gray.imt": imt_bytes([b"* an IM Tools image", *imt_lines(23, 17)], gray),
        "mcidas_8.area": mcidas_bytes(gray, 1, prefix=8, tail=20),
        "mcidas_16.area": mcidas_bytes(mcidas_values(2, 17, 23, 130), 2),
        "mcidas_32.area": mcidas_bytes(mcidas_values(4, 17, 23, 131), 4, bands=2, tail=92),
        "pixar_rgb.pxr": pixar_bytes(rgb),
        "xvthumb_comments.xvthumb": xv_bytes(wide),
    }


RASTER4_SUFFIXES = (".fits", ".ftc", ".ftu", ".gbr", ".imt", ".area", ".pxr", ".xvthumb")
RASTER4_FIXTURES = sorted(p.name for p in FORMATS.iterdir() if p.suffix in RASTER4_SUFFIXES)
FORMAT_NAMES = {".fits": "FITS", ".ftc": "FTEX", ".ftu": "FTEX", ".gbr": "GBR", ".imt": "IMT",
                ".area": "MCIDAS", ".pxr": "PIXAR", ".xvthumb": "XVThumb"}


@pytest.mark.parametrize("name", RASTER4_FIXTURES)
def test_fixture_equals_pil(name, tmp_path):
    """Each committed fixture: Pillow's format, its pixels as committed, the
    port's; at most 64x48 and a few KB."""
    data = (FORMATS / name).read_bytes()
    fmt = FORMAT_NAMES[name[name.rindex("."):]]
    want = np.load(FORMATS / (name[: name.rindex(".")] + ".npy"))
    got = assert_as_pil(data, tmp_path, name)
    assert I.decode_image(data, name)[0] == fmt
    np.testing.assert_array_equal(got, want)
    assert want.shape[0] * want.shape[1] <= 64 * 48, want.shape
    assert len(data) <= 16_000


def test_fixtures_cover_each_format():
    """Every format, every FITS BITPIX and the GZIP_1 tiles, both FTEX
    formats, both GBR versions and depths, every McIdas width."""
    made = raster4_fixture_bytes()
    assert sorted(RASTER4_FIXTURES) == sorted(made)
    assert {FORMAT_NAMES[n[n.rindex("."):]] for n in made} == set(FORMAT_NAMES.values())
    fits = [made[n] for n in made if n.endswith(".fits")]
    assert {int(d[d.index(b"BITPIX") + 10: d.index(b"BITPIX") + 30]) for d in fits} >= {
        8, 16, 32, -32, -64}
    assert sum(b"GZIP_1" in d for d in fits) == 3
    assert {made[n][24] for n in made if n.startswith("ftex")} == {0, 1}
    assert {(made[n][7], made[n][19]) for n in made if n.endswith(".gbr")} == {
        (1, 1), (1, 4), (2, 1), (2, 4)}
    assert {made[n][43] for n in made if n.endswith(".area")} == {1, 2, 4}
    assert made["xvthumb_comments.xvthumb"].count(b"\n#") == 3


@pytest.mark.parametrize("name", RASTER4_FIXTURES)
def test_mutated_fixtures_equal_pil_or_are_refused(name, tmp_path):
    """40 mutations of each fixture (a cut, 1-3 bytes of the first 64, 1-4
    anywhere), opened from their path: where Pillow reads one, the port
    gives its format and pixels; where Pillow raises, the port raises
    ``ValueError``."""
    data = (FORMATS / name).read_bytes()
    rng = random.Random(name)
    for k in range(40):
        b = bytearray(data)
        kind = k % 3
        if kind == 0:
            b = b[: rng.randrange(len(b))]
        for _ in range(0 if kind == 0 else rng.randint(1, 4)):
            b[rng.randrange(min(len(b), 64) if kind == 1 else len(b))] = rng.randrange(256)
        b = bytes(b)
        path = tmp_path / f"m{k}"
        path.write_bytes(b)
        try:
            with Image.open(path) as im:
                if im.size[0] * im.size[1] > 1 << 22:
                    continue
                want = im.format, np.asarray(im.convert("RGB"))
        except Exception:
            want = None
        try:
            got = I.decode_image(b, name)
        except ValueError:
            got = None
        if want is None:
            assert got is None, (name, k, got[0])
        else:
            assert got is not None and got[0] == want[0], (name, k)
            np.testing.assert_array_equal(got[1], want[1], err_msg=f"{name} mutation {k}")
