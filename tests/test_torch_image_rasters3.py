"""IM, MSP, SPIDER, BLP and ICNS without Pillow:
``data/image_io.decode_image`` against ``Image.open(path)``: the container
it picks equals Pillow's ``format`` and the pixels equal
``np.asarray(Image.open(path).convert("RGB"))``, max |difference| 0; where
Pillow refuses a file, the port raises ``ValueError`` naming it.

* IM (``data/im.py``): every image type of Pillow's ``OPEN`` table
  (line-interleaved ``;L`` layouts, the bit decoder's 2 to 31-bit ``F``,
  the three planes of ``RGB3``), the ``Lut`` (a colour palette, a gray one,
  linear or not), the header's rules (``\\r``, ``\\0`` before the
  ``\\x1a``, numbers as Python reads them, the default 512x512), each mode
  Pillow writes, Pillow's YCbCr converter over every input.
* MSP (``data/msp.py``): version 1 as Pillow writes it, version 2's
  run-length rows (empty rows, rows that give more or fewer bytes than a
  row holds), the header checksum.
* SPIDER (``data/spider.py``): as Pillow writes it (native byte order),
  big-endian, a stack, the F → RGB rule, headers Pillow passes on.
* BLP (``data/blp.py``): BLP1 and BLP2 palettes as Pillow writes them,
  BLP1 JPEG (RGB, CMYK, YCCK, another size), BLP2 DXT1/3/5 with and without
  the alpha flag at widths that are and are not multiples of 4.
* ICNS (``data/icns.py``): the RLE and raw RGB entries, masks, ``it32``,
  PNG entries, the best size, duplicate entries; the JPEG 2000 entry the
  port refuses although Pillow reads it.

Pillow writes IM, MSP (version 1), SPIDER and BLP (palettes); the writers
here write the rest. :func:`raster3_fixture_bytes` gives the committed
fixtures under ``tests/torch_images/formats/``, written anew with the other
formats by ``PYTHONPATH=. python tests/test_torch_image_formats.py``.
"""
import random
import re
import struct

import numpy as np
import pytest
from PIL import Image, ImImagePlugin

from mm_s2ut_torch.data import image_io as I
from mm_s2ut_torch.data.im import OPEN, PAIRS, ycbcr_to_rgb
from test_torch_image_formats import FORMATS, JpegWriter, adobe, save, scene
from test_torch_image_rasters2 import _runny, assert_as_pil, assert_refused, pillow


def same_as_pil(data: bytes, tmp_path, name: str = "x.img"):
    """The port gives Pillow's format and pixels, or raises where Pillow
    does; returns Pillow's format or None."""
    want = pillow(data, tmp_path / name)
    if want is None:
        with pytest.raises(ValueError, match=name):
            I.decode_image(data, name)
        return None
    fmt, got = I.decode_image(data, name)
    assert fmt == want[0]
    np.testing.assert_array_equal(got, want[1])
    return fmt


# ------------------------------------------------------------------------ IM

def im_bytes(lines, body: bytes, lut: bytes = b"", pad: bool = True) -> bytes:
    """An IM file: header ``lines`` (CRLF), ``\\0`` up to byte 511, ``\\x1a``,
    the ``lut``, then ``body``."""
    head = b"".join(line + b"\r\n" for line in lines)
    if pad:
        head += b"\0" * (511 - len(head))
    return head + b"\x1a" + lut + body


def im_typed(kind: bytes, w: int, h: int, body: bytes, lut: bytes = b"") -> bytes:
    lines = [b"Image type: " + kind, b"Image size (x*y): %d*%d" % (w, h)]
    return im_bytes(lines + ([b"Lut: 1"] if lut else []), body, lut)


def test_open_table_is_pillows():
    assert OPEN == ImImagePlugin.OPEN


def test_pairs_table_is_pillows():
    """The (mode, raw mode) pairs the port unpacks are those Pillow's raw
    decoder has, over every mode and every raw mode IM can name."""
    modes = ["1", "L", "P", "RGB", "RGBA", "RGBX", "CMYK", "YCbCr", "LAB", "HSV", "I", "F",
             "LA", "La", "PA", "RGBa", "I;16", "I;16L", "I;16B", "I;16N"]
    raws = sorted({r for _, r in OPEN.values()
                   if not (r.startswith("F;") and r[2:].isdigit()) or int(r[2:]) in (8, 16, 32)}
                  | {"L", "P", "PA;L"})
    have = set()
    for m in modes:
        for r in raws:
            try:
                Image.frombytes(m, (4, 2), bytes(512), "raw", r)
            except ValueError:
                continue
            have.add((m, r))
    assert have == PAIRS


@pytest.mark.parametrize("w", [5, 13])
@pytest.mark.parametrize("kind", sorted(OPEN))
def test_im_open_table_types_equal_pil(kind, w, tmp_path):
    """Every image type of Pillow's table over random bytes, 5 and 13 pixels
    wide (the bit decoder's rows then end inside a byte); the two Pillow has
    no unpacker for (``RLB``, and ``PA`` without a palette) refused."""
    seed = sum(kind.encode()) + w
    body = np.random.RandomState(seed).randint(0, 256, 4 * 4 * w * 4).astype(np.uint8).tobytes()
    data = im_typed(kind.encode(), w, 4, body)
    if OPEN[kind][1] in ("RLB", "PA;L"):
        assert_refused(data, tmp_path, "x.im", "no unpacker")
        return
    assert_as_pil(data, tmp_path, "x.im")


GRAY_LINEAR = bytes(range(256)) * 3
GRAY_REVERSED = bytes(range(255, -1, -1)) * 3


@pytest.mark.parametrize("lut", ["colour", "gray_linear", "gray_reversed"])
@pytest.mark.parametrize("kind", [b"Greyscale image", b"LA image", b"PA image", b"B2 image",
                                  b"B4 image", b"RGB image", b"0 1 image", b"CMYK image",
                                  b"L 16 image", b"L*12 image", b"P", b"L"])
def test_im_lut_equals_pil(kind, lut, tmp_path):
    """A colour Lut makes L and P images P (raw mode P: B2's and B4's 2 and
    4-bit indices are read as bytes) and LA ones PA; a gray Lut, linear or
    not, changes no pixel; any other image skips its 768 bytes."""
    table = {"colour": np.random.RandomState(len(kind)).randint(0, 256, 768).astype(
        np.uint8).tobytes(), "gray_linear": GRAY_LINEAR, "gray_reversed": GRAY_REVERSED}[lut]
    body = _runny((4 * 7 * 8,), len(kind)).tobytes()
    data = im_typed(kind, 7, 4, body, table)
    if kind == b"PA image" and lut != "colour":
        assert_refused(data, tmp_path, "x.im", "no unpacker")
        return
    assert_as_pil(data, tmp_path, "x.im")


IM_MODES = ["1", "L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "CMYK", "YCbCr", "I", "I;16",
            "I;16B", "F"]


def im_image(mode: str, h: int, w: int, seed: int) -> Image.Image:
    """A scene in ``mode``; I, I;16 and F spread past 0..255."""
    img = Image.fromarray(scene(h, w, seed=seed))
    if mode in ("I", "I;16", "I;16B", "F"):
        g = scene(h, w, c=1, seed=seed)[..., 0].astype(np.int64) * 3 - 200
        if mode == "F":
            return Image.fromarray(g.astype(np.float32) / 1.7, "F")
        if mode == "I":
            return Image.fromarray(g.astype(np.int32), "I")
        return Image.fromarray(np.abs(g).astype(np.uint16), "I;16").convert(mode) \
            if mode == "I;16B" else Image.fromarray(np.abs(g).astype(np.uint16), "I;16")
    if mode == "PA":
        return img.convert("P", palette=Image.Palette.ADAPTIVE, colors=30).convert("PA")
    if mode == "P":
        return img.convert("P", palette=Image.Palette.ADAPTIVE, colors=50)
    return img.convert(mode)


@pytest.mark.parametrize("w", [8, 13])
@pytest.mark.parametrize("mode", IM_MODES)
def test_im_as_pillow_writes_equals_pil(mode, w, tmp_path):
    assert_as_pil(save(im_image(mode, 5, w, len(mode)), "IM"), tmp_path, "x.im")


def test_im_p_with_default_palette_reads_as_l(tmp_path):
    """Pillow writes a P image's palette as the Lut; its default palette is a
    linear gray, so the file reads back as L."""
    data = save(Image.fromarray(scene(4, 6, c=1, seed=3)[..., 0]).convert("P"), "IM")
    (tmp_path / "x.im").write_bytes(data)
    with Image.open(tmp_path / "x.im") as im:
        assert im.mode == "L"
    assert_as_pil(data, tmp_path, "x.im")


IM_HEADERS = {  # name → header lines (the body fits a 4x3 gray image)
    "cr_lines_skipped": [b"\rImage type: Greyscale image", b"Image size (x*y): 4*3"],
    "spaces_and_underscores": [b"Image type: Greyscale image", b"Image size (x*y):  4 * 1_0"],
    "comments": [b"Comment: a", b"Image type: Greyscale image", b"Comment: b",
                 b"Image size (x*y): 4*3", b"Scale (x,y): 1.5,2"],
    "unknown_key": [b"Foo bar: baz", b"Image size (x*y): 4*3"],
    "no_type_is_l": [b"Image size (x*y): 4*3", b"File size (no of images): 2"],
    "mode_as_type": [b"Image type: L", b"Image size (x*y): 4*3"],
    "p_without_palette": [b"Image type: P", b"Image size (x*y): 4*3"],
    "type_after_type": [b"Image type: RGBA image", b"Image type: RGB", b"Image size (x*y): 4*3"],
    "rgbx_after_rgb": [b"Image type: X 24 image", b"Image type: RGBX", b"Image size (x*y): 4*3"],
    "i16_after_i16b": [b"Image type: L 16B image", b"Image type: I;16", b"Image size (x*y): 4*3"],
    "default_512": [b"Name: x.im"],
    "size_one_number": [b"Image type: Greyscale image", b"Image size (x*y): 12"],
    "size_negative": [b"Image type: Greyscale image", b"Image size (x*y): -4*3"],
    "empty_type": [b"Image type: ", b"Image size (x*y): 4*3"],
    "no_tag": [b"Foo: bar"],
    "line_of_101": [b"Image type: Greyscale image", b"Name: " + b"n" * 93],
    "not_key_value": [b"Image type: Greyscale image", b"no colon here"],
}


@pytest.mark.parametrize("case", sorted(IM_HEADERS))
def test_im_header_rules_equal_pil(case, tmp_path):
    """Lines as ``ImImageFile._open`` reads them: a ``\\r`` that starts a line
    skipped, numbers as Python's ``int`` then ``float`` read them, a type
    that is not in the table taken as the mode (with the raw mode before
    it), 512x512 L without a size; headers Pillow passes on go to the next
    plugin, as the port's do."""
    body = _runny((512 * 512 * 2,), 7).tobytes() if case == "default_512" else \
        _runny((600,), 8).tobytes()
    same_as_pil(im_bytes(IM_HEADERS[case], body), tmp_path, "x.im")


@pytest.mark.parametrize("case", ["nul_then_eof", "nul_then_1a", "1a_at_once", "no_newline",
                                  "lf_only"])
def test_im_header_ends_equal_pil(case, tmp_path):
    """The header ends at a ``\\0`` (then the data follows the next ``\\x1a``,
    if any), at a ``\\x1a``, or at the end of the file."""
    head = b"Image type: Greyscale image\r\nImage size (x*y): 4*3\r\n"
    body = bytes(range(40, 52))
    data = {"nul_then_eof": head + b"\0\0\0" + body,
            "nul_then_1a": head + b"\0" + b"xyz" + b"\x1a" + body,
            "1a_at_once": head + b"\x1a" + body,
            "no_newline": b"Image type: Greyscale image" + b"\x1a" + body,
            "lf_only": head.replace(b"\r\n", b"\n") + b"\x1a" + body}[case]
    same_as_pil(data, tmp_path, "x.im")


def test_ycbcr_converter_is_pillows():
    """Pillow's YCbCr → RGB over every (Y, Cb, Cr)."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y0 in range(0, 256, 16):
        ycc = np.stack([np.broadcast_to((y0 + np.arange(16))[:, None, None], (16, 256, 256)),
                        np.broadcast_to(cb, (16, 256, 256)),
                        np.broadcast_to(cr, (16, 256, 256))], -1).reshape(4096, 256, 3)
        ycc = ycc.astype(np.uint8)
        want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
        np.testing.assert_array_equal(ycbcr_to_rgb(ycc), want)


def test_im_lab_left_to_port_raises_naming_the_mode(tmp_path):
    """Pillow reads an image type ``LAB`` (its L band from the data) and
    converts it through LittleCMS; the port raises, naming the file and the
    mode, beside TIFF's CIELab and PSD's Lab."""
    data = im_typed(b"LAB", 4, 3, bytes(range(100, 112)))
    (tmp_path / "lab.im").write_bytes(data)
    with Image.open(tmp_path / "lab.im") as im:
        assert im.mode == "LAB"
        np.asarray(im.convert("RGB"))
    with pytest.raises(ValueError, match="lab.im.*LAB.*LittleCMS"):
        I.read_image(tmp_path / "lab.im")


# ----------------------------------------------------------------------- MSP

def msp_bytes(magic: bytes, w: int, h: int, body: bytes, checksum: bool = True) -> bytes:
    """An MSP header (the checksum word set so all 16 XOR to 0), then ``body``."""
    words = list(struct.unpack("<2H", magic)) + [w, h, 1, 1, 1, 1, w, h, 0, 0, 0, 0, 0, 0]
    x = 0
    for v in words:
        x ^= v
    words[12] = x if checksum else x ^ 1
    return struct.pack("<16H", *words) + body


def msp_rle(row: bytes) -> bytes:
    """Runs of 3 or more as (0, count, byte), the rest as literals (at most 255)."""
    out, lit, i = bytearray(), bytearray(), 0
    while i < len(row):
        j = i
        while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 254:
            j += 1
        if j - i >= 2:
            if lit:
                out += bytes([len(lit)]) + lit
                lit = bytearray()
            out += bytes([0, j - i + 1, row[i]])
        else:
            lit += row[i: j + 1]
            if len(lit) >= 250:
                out += bytes([len(lit)]) + lit
                lit = bytearray()
        i = j + 1
    if lit:
        out += bytes([len(lit)]) + lit
    return bytes(out)


def msp_v2(rows, w: int, extra=None) -> bytes:
    """Version 2: the row table, then each row's runs (``extra``: row → raw
    bytes that replace its coding)."""
    coded = [msp_rle(r.tobytes()) for r in rows]
    for y, raw in (extra or {}).items():
        coded[y] = raw
    table = struct.pack(f"<{len(coded)}H", *map(len, coded))
    return msp_bytes(b"LinS", w, len(rows), table + b"".join(coded))


@pytest.mark.parametrize("w", [1, 7, 8, 13, 32, 45])
def test_msp_v1_as_pillow_writes_equals_pil(w, tmp_path):
    bits = Image.fromarray(scene(6, w, seed=w)).convert("1")
    assert_as_pil(save(bits, "MSP"), tmp_path, "x.msp")


@pytest.mark.parametrize("w", [1, 9, 16, 45, 300])
def test_msp_v2_random_rows_equal_pil(w, tmp_path):
    rows = _runny((7, (w + 7) // 8), w)
    assert_as_pil(msp_v2(rows, w), tmp_path, "x.msp")


@pytest.mark.parametrize("case", ["empty_row_white", "long_row_moves_rest", "short_row",
                                  "literal_cut_at_row_end", "run_of_0"])
def test_msp_v2_rules_equal_pil(case, tmp_path):
    """A row of count 0 is white; the rows' bytes are joined and read as
    whole rows (a long row moves the rest, a short row short of data is
    refused); a literal is cut at its row's end; a run may be of 0."""
    rows = _runny((5, 3), 11)
    extra = {"empty_row_white": {1: b""}, "long_row_moves_rest": {0: bytes([5, 1, 2, 3, 4, 5])},
             "short_row": {2: bytes([1, 9])}, "literal_cut_at_row_end": {3: bytes([9, 1, 2, 3])},
             "run_of_0": {4: bytes([0, 0, 7, 3, 1, 2, 3])}}[case]
    same_as_pil(msp_v2(rows, 20, extra), tmp_path, "x.msp")


@pytest.mark.parametrize("magic", [b"DanM", b"LinS"])
def test_msp_bad_checksum_passes_the_file_on(magic, tmp_path):
    """A non-zero checksum is Pillow's ``SyntaxError``: the file goes on to
    the next plugin (here no other takes it)."""
    data = msp_bytes(magic, 8, 2, bytes(20), checksum=False)
    assert same_as_pil(data, tmp_path, "x.msp") != "MSP"


# -------------------------------------------------------------------- SPIDER

def spider_bytes(px: np.ndarray, order: str = ">", stack: bool = False, **words) -> bytes:
    """A SPIDER image (``px`` (h, w) floats) in ``order``, or a stack of one
    image; ``words``: header words by their 1-based index, as ``w5=3``."""
    h, w = px.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    hdr = np.zeros(labrec * lenbyt // 4, np.float64)
    for k, v in {1: 1, 2: h, 3: h, 5: 1, 12: w, 13: labrec, 22: labrec * lenbyt,
                 23: lenbyt, 24: 1 if stack else 0, 26: 1 if stack else 0}.items():
        hdr[k - 1] = v
    for k, v in words.items():
        hdr[int(k[1:]) - 1] = v
    body = px.astype(f"{order}f4").tobytes()
    out = hdr.astype(f"{order}f4").tobytes()
    if stack:
        image = hdr.copy()
        image[23], image[26] = 0, 1
        out += image.astype(f"{order}f4").tobytes()
    return out + body


def spider_values(h: int, w: int, seed: int) -> np.ndarray:
    """Floats over the F → RGB rule: negatives, fractions, past 255, NaN, ±inf."""
    v = np.random.RandomState(seed).uniform(-40, 300, (h, w)).astype(np.float32)
    v.flat[:8] = [-3.7, 0.6, 1.5, 254.5, 255.49, np.nan, np.inf, -np.inf]
    return v


@pytest.mark.parametrize("w", [3, 21, 64])
def test_spider_as_pillow_writes_equals_pil(w, tmp_path):
    assert_as_pil(save(Image.fromarray(spider_values(5, w, w), "F"), "SPIDER"), tmp_path,
                  "x.spi")


@pytest.mark.parametrize("stack", [False, True])
@pytest.mark.parametrize("order", [">", "<"])
def test_spider_orders_and_stacks_equal_pil(order, stack, tmp_path):
    assert_as_pil(spider_bytes(spider_values(6, 11, len(order)), order, stack), tmp_path,
                  "x.spi")


SPIDER_HEADERS = {
    "iform_3": dict(w5=3), "iform_not_listed": dict(w5=2), "labbyt_wrong": dict(w22=1000),
    "fractional_size": dict(w12=11.5), "image_in_stack": dict(w27=1),
    "negative_stack": dict(w24=-1), "nan_istack": dict(w24=np.nan),
    "nan_image_count": dict(w24=1, w26=np.nan), "negative_header": dict(w13=-1, w22=-44),
}


@pytest.mark.parametrize("case", sorted(SPIDER_HEADERS))
def test_spider_header_rules_equal_pil(case, tmp_path):
    """``isSpiderHeader``'s tests in both byte orders, ``iform`` 1, the stack
    words; where Pillow passes the file on, no other plugin takes it."""
    same_as_pil(spider_bytes(spider_values(4, 11, 3), ">", **SPIDER_HEADERS[case]), tmp_path,
                "x.spi")


# ----------------------------------------------------------------------- BLP

def blp2_bytes(w, h, encoding, alpha, alpha_encoding, payload, palette=None,
               compression=1) -> bytes:
    if palette is None:
        palette = np.random.RandomState(w * h).randint(0, 256, 1024).astype(np.uint8).tobytes()
    head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 0, w, h)
    at = len(head) + 128 + len(palette)
    return (head + struct.pack("<16I", at, *[0] * 15) + struct.pack("<16I", len(payload),
                                                                     *[0] * 15)
            + palette + payload)


def blp1_jpeg(w, h, jpeg: bytes, alpha: int = 0, gap: int = 3, offset=None) -> bytes:
    """BLP1 JPEG: the JPEG's markers before its scan as the shared header,
    ``gap`` bytes, then the rest at the first offset (or at ``offset``)."""
    cut = jpeg.index(b"\xff\xda")
    head = b"BLP1" + struct.pack("<iIIIii", 0, alpha, w, h, 5, 0)
    at = len(head) + 128 + 4 + cut + gap
    return (head + struct.pack("<16I", at if offset is None else offset, *[0] * 15)
            + struct.pack("<16I", len(jpeg) - cut, *[0] * 15) + struct.pack("<I", cut)
            + jpeg[:cut] + bytes(range(gap)) + jpeg[cut:])


def blp1_palette(w, h, idx: bytes, alpha=0, encoding=5, palette=None) -> bytes:
    if palette is None:
        palette = np.random.RandomState(h).randint(0, 256, 1024).astype(np.uint8).tobytes()
    head = b"BLP1" + struct.pack("<iIIIii", 1, alpha, w, h, encoding, 0)
    return (head + struct.pack("<16I", 0, *[0] * 15) + struct.pack("<16I", len(idx), *[0] * 15)
            + palette + idx)


def dxt_blocks(w, h, alpha_encoding, seed) -> bytes:
    """Random DXT blocks; a third of the colour pairs with c0 <= c1."""
    rng = np.random.RandomState(seed)
    n = ((w + 3) // 4) * ((h + 3) // 4)
    blocks = rng.randint(0, 256, (n, 8 if alpha_encoding == 0 else 16)).astype(np.uint8)
    colour = blocks[:, -8:]
    c0 = colour[:, 0].astype(np.int64) | colour[:, 1].astype(np.int64) << 8
    c1 = colour[:, 2].astype(np.int64) | colour[:, 3].astype(np.int64) << 8
    swap = (np.arange(n) % 3 == 0) == (c0 > c1)
    colour[swap, :2], colour[swap, 2:4] = colour[swap, 2:4].copy(), colour[swap, :2].copy()
    if alpha_encoding == 7:
        blocks[::2, :2] = np.sort(blocks[::2, :2], 1)  # half with a0 <= a1
    return blocks.tobytes()


@pytest.mark.parametrize("alpha", [0, 1])
@pytest.mark.parametrize("w,h", [(4, 4), (6, 5), (8, 3), (13, 9), (1, 1)])
@pytest.mark.parametrize("alpha_encoding", [0, 1, 7])
def test_blp2_dxt_equals_pil(alpha_encoding, w, h, alpha, tmp_path):
    """DXT1/3/5 as Pillow's Python decoders give them (shift-only 5:6:5,
    DXT3/5 4-colour), laid out as ``set_as_raw`` reads the block rows."""
    blocks = dxt_blocks(w, h, alpha_encoding, w * 10 + h + alpha_encoding)
    assert_as_pil(blp2_bytes(w, h, 2, alpha, alpha_encoding, blocks), tmp_path, "x.blp")


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("palette_mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("w", [5, 16])
def test_blp_palette_as_pillow_writes_equals_pil(version, palette_mode, w, tmp_path):
    img = Image.fromarray(scene(7, w, seed=w)).convert("P", palette=Image.Palette.ADAPTIVE,
                                                       colors=40)
    if palette_mode == "RGBA":
        pal = np.asarray(img.getpalette("RGB"), np.uint8).reshape(-1, 3)
        img.putpalette(np.concatenate([pal, np.full((len(pal), 1), 99, np.uint8)], 1)
                       .reshape(-1).tolist(), "RGBA")
    assert_as_pil(save(img, "BLP", blp_version=version), tmp_path, "x.blp")


@pytest.mark.parametrize("case", ["rgb", "rgb_alpha_flag", "gray", "cmyk", "ycck", "other_size",
                                  "offset_behind", "offset_behind_gap", "progressive"])
def test_blp1_jpeg_equals_pil(case, tmp_path):
    """The JPEG's RGB bytes read as raw BGR (red and blue swap), a CMYK one's
    samples as stored (a YCCK one not converted), a JPEG of another size
    sheared into the header's; with the first offset behind the shared
    header, the mipmap's bytes are read on from there, so bytes between the
    two cut the JPEG's end off (Pillow refuses it)."""
    rgb = Image.fromarray(scene(12, 20, seed=4))
    jpeg = {"gray": lambda: save(rgb.convert("L"), "JPEG", quality=90),
            "cmyk": lambda: save(Image.fromarray(scene(12, 20, c=4, seed=5), "CMYK"), "JPEG"),
            "ycck": lambda: JpegWriter([scene(12, 20, c=1, seed=k)[..., 0] for k in range(4)],
                                       [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 1, 1, 0)],
                                       markers=adobe(2)).huffman(),
            "progressive": lambda: save(rgb, "JPEG", progressive=True)}.get(
        case, lambda: save(rgb, "JPEG", quality=90))()
    w, h = (16, 13) if case == "other_size" else (20, 12)
    behind = case.startswith("offset_behind")
    data = blp1_jpeg(w, h, jpeg, alpha=int(case == "rgb_alpha_flag"),
                     gap=3 if case != "offset_behind" else 0, offset=100 if behind else None)
    assert same_as_pil(data, tmp_path, "x.blp") == (None if case == "offset_behind_gap" else "BLP")


@pytest.mark.parametrize("encoding", [4, 5])
@pytest.mark.parametrize("alpha", [0, 8])
def test_blp1_palette_encodings_equal_pil(encoding, alpha, tmp_path):
    idx = _runny((5 * 9 + 4,), encoding).tobytes()
    assert_as_pil(blp1_palette(9, 5, idx, alpha, encoding), tmp_path, "x.blp")


# ---------------------------------------------------------------------- ICNS

def icns_rle(band: bytes) -> bytes:
    """``read_32``'s runs: 3-130 equal bytes as (0x80 + n - 3, byte), others
    as literals of at most 128."""
    out, lit, i = bytearray(), bytearray(), 0
    while i < len(band):
        j = i
        while j + 1 < len(band) and band[j + 1] == band[i] and j - i < 129:
            j += 1
        if j - i >= 2:
            if lit:
                out += bytes([len(lit) - 1]) + lit
                lit = bytearray()
            out += bytes([0x80 + j - i + 1 - 3, band[i]])
        else:
            lit += band[i: j + 1]
            while len(lit) >= 128:
                out += bytes([127]) + lit[:128]
                lit = lit[128:]
        i = j + 1
    if lit:
        out += bytes([len(lit) - 1]) + lit
    return bytes(out)


def icns_rgb(px: np.ndarray, raw: bool = False) -> bytes:
    if raw:
        return px.tobytes()
    return b"".join(icns_rle(px[..., c].tobytes()) for c in range(3))


def icns_bytes(entries, filesize=None) -> bytes:
    body = b"".join(t + struct.pack(">I", len(b) + 8) + b for t, b in entries)
    return b"icns" + struct.pack(">I", 8 + len(body) if filesize is None else filesize) + body


def icon_px(n: int, seed: int) -> np.ndarray:
    return _runny((n, n, 3), seed)


def _png(n: int, seed: int, mode: str = "RGBA") -> bytes:
    return save(Image.fromarray(icon_px(n, seed)).convert(mode), "PNG")


ICNS_CASES = {
    "is32_rle_s8mk": lambda: [(b"is32", icns_rgb(icon_px(16, 1))), (b"s8mk", bytes(256))],
    "il32_raw": lambda: [(b"il32", icns_rgb(icon_px(32, 2), raw=True))],
    "ih32_h8mk": lambda: [(b"h8mk", bytes(range(256)) * 9), (b"ih32", icns_rgb(icon_px(48, 3)))],
    "it32": lambda: [(b"it32", bytes(4) + icns_rgb(icon_px(128, 4)))],
    "png_icp4": lambda: [(b"icp4", _png(16, 5))],
    "png_ic07_small": lambda: [(b"ic07", _png(16, 6, "RGB"))],
    "png_ic07_palette": lambda: [(b"ic07", _png(32, 7, "P"))],
    "png_over_it32": lambda: [(b"it32", bytes(4) + icns_rgb(icon_px(128, 8))),
                              (b"ic07", _png(64, 9))],
    "best_48_over_32x2": lambda: [(b"ic12", _png(64, 10)), (b"ih32", icns_rgb(icon_px(48, 11)))],
    "best_of_several": lambda: [(b"is32", icns_rgb(icon_px(16, 12))),
                                (b"il32", icns_rgb(icon_px(32, 13)))],
    "later_duplicate_wins": lambda: [(b"is32", icns_rgb(icon_px(16, 14))),
                                     (b"is32", icns_rgb(icon_px(16, 15)))],
    "unknown_entries_skipped": lambda: [(b"TOC ", bytes(16)), (b"icnV", bytes(4)),
                                        (b"is32", icns_rgb(icon_px(16, 16)))],
}


@pytest.mark.parametrize("case", sorted(ICNS_CASES))
def test_icns_entries_equal_pil(case, tmp_path):
    """RLE and raw RGB entries, masks (dropped), ``it32``'s zero bytes, PNG
    entries (winning over the RGB one of their size; the image takes the
    PNG's size), the largest (w, h, scale) key, a later duplicate."""
    assert_as_pil(icns_bytes(ICNS_CASES[case]()), tmp_path, "x.icns")


@pytest.mark.parametrize("seed", range(6))
def test_icns_random_rle_equals_pil(seed, tmp_path):
    """Random run-length bands, cut short or not (Pillow then refuses)."""
    rng = np.random.RandomState(seed)
    body = icns_rgb(_runny((16, 16, 3), seed + 30))
    if seed % 2:
        body = body[: rng.randint(1, len(body))]
    same_as_pil(icns_bytes([(b"is32", body)]), tmp_path, "x.icns")


def test_icns_jpeg2000_left_to_port_raises_naming_the_codec(tmp_path):
    """Pillow reads a JPEG 2000 entry through OpenJPEG; the port raises,
    naming the file and the codec, until it reads JPEG 2000."""
    j2k = save(Image.fromarray(icon_px(32, 20)), "JPEG2000")
    data = icns_bytes([(b"icp5", j2k)])
    (tmp_path / "j2k.icns").write_bytes(data)
    with Image.open(tmp_path / "j2k.icns") as im:
        assert im.format == "ICNS" and np.asarray(im.convert("RGB")).shape == (32, 32, 3)
    with pytest.raises(ValueError, match="j2k.icns.*JPEG 2000"):
        I.read_image(tmp_path / "j2k.icns")


# ------------------------------------------- JPEG data as a BLP1 file may carry it

def _jpegs():
    return {"baseline": save(Image.fromarray(scene(24, 40, seed=70)), "JPEG", quality=85),
            "cmyk": save(Image.fromarray(scene(16, 24, c=4, seed=71), "CMYK"), "JPEG"),
            "progressive": save(Image.fromarray(scene(24, 40, seed=72)), "JPEG", quality=85,
                                progressive=True)}


# the committed lossless and arithmetic-coded fixtures (test_torch_image_formats.py)
CODED = {"lossless": "lossless_rgb_p5.jpg", "arith_progressive": "arith_prog444_dac.jpg",
         "arith_restarts": "arith420_rst.jpg"}


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("kind", ["baseline", "cmyk", "progressive", *CODED])
def test_jpeg_corrupt_scan_data_equals_pil(kind, seed, tmp_path):
    """Bytes of a JPEG past its first scan header changed (markers among
    them), as libjpeg-turbo reads them: a bad code is 17 bits and symbol 0,
    coefficients past 63 land on 63, the rest of an interval stays zero
    once the data ran out (a lossless row reads on from zero bits, the rows
    after it reset the undifferencer), an arithmetic-coded bad code ends
    its interval, a restart marker out of sequence is resynced, the x86-64
    IDCT's 16-bit lanes wrap and saturate, markers libjpeg stops at are
    refused, and after a baseline image's one scan only the markers it
    then reads matter."""
    jpeg = (FORMATS / CODED[kind]).read_bytes() if kind in CODED else _jpegs()[kind]
    first = jpeg.index(b"\xff\xda") + 14
    rng = random.Random(f"{kind}{seed}")
    for k in range(12):
        b = bytearray(jpeg)
        for _ in range(rng.randint(1, 3)):
            b[rng.randrange(first, len(b) - 2)] = rng.choice([rng.randrange(256), 0xFF])
        same_as_pil(bytes(b), tmp_path, f"x{k}.jpg")


@pytest.mark.parametrize("case", ["no_eoi", "app0_then_junk", "rst_then_end", "res_marker",
                                  "dht_after_scan", "sos_after_scan", "eoi_then_junk",
                                  "junk_after_soi"])
@pytest.mark.parametrize("kind", ["baseline", "progressive"])
def test_jpeg_endings_equal_pil(kind, case, tmp_path):
    """A baseline image is whole after its one scan: libjpeg reads the
    markers after it only until the data runs out; a progressive one needs
    its EOI. Pillow's JPEG plugin takes a file only from ``FF D8 FF``."""
    j = _jpegs()[kind][:-2]
    data = {"no_eoi": j, "app0_then_junk": j + b"\xff\xe0\x99\x99abc",
            "rst_then_end": j + b"\xff\xd3", "res_marker": j + b"\xff\x78\xff\xd9",
            "dht_after_scan": j + b"\xff\xc4\x00\x05\x10\xff\xd9",
            "sos_after_scan": j + b"\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00\xff\xd9",
            "eoi_then_junk": j + b"\xff\xd9junk",
            "junk_after_soi": j[:2] + b"\x00" + j[2:] + b"\xff\xd9"}[case]
    same_as_pil(data, tmp_path, "x.jpg")


def _restart_markers(jpeg: bytes):
    """The positions of the RSTn markers in a JPEG's scans."""
    at, out = jpeg.index(b"\xff\xda"), []
    while (at := jpeg.find(b"\xff", at + 1)) >= 0:
        if 0xD0 <= jpeg[at + 1] <= 0xD7:
            out.append(at)
    return out


def _restart_cases(jpeg: bytes, change: str):
    """``jpeg`` with its restart markers renumbered (each to every other
    number), dropped, repeated, replaced by other markers, or three of them
    renumbered at random."""
    marks = _restart_markers(jpeg)
    if change == "random":
        rng = random.Random(len(jpeg))
        for _ in range(16):
            b = bytearray(jpeg)
            for at in rng.sample(marks, 3):
                b[at + 1] = 0xD0 + rng.randrange(8)
            yield bytes(b)
        return
    for at in marks:
        if change == "renumbered":
            for n in range(8):
                if 0xD0 + n != jpeg[at + 1]:
                    yield jpeg[: at + 1] + bytes([0xD0 + n]) + jpeg[at + 2:]
        elif change == "dropped":
            yield jpeg[:at] + jpeg[at + 2:]
        elif change == "repeated":
            yield jpeg[:at] + jpeg[at: at + 2] * 2 + jpeg[at + 2:]
        else:  # another marker: below SOF0 (skipped), TEM, DHT, APP1, SOI, EOI (left unread)
            for m in (0x05, 0x01, 0xC4, 0xE1, 0xD8, 0xD9):
                yield jpeg[: at + 1] + bytes([m]) + jpeg[at + 2:]


@pytest.mark.parametrize("change", ["renumbered", "dropped", "repeated", "other_marker",
                                    "random"])
@pytest.mark.parametrize("name", ["rst422_q80.jpg", "arith420_rst.jpg"])
def test_jpeg_restart_sequence_equals_pil(name, change, tmp_path):
    """Restart markers out of sequence, as ``jpeg_resync_to_restart`` takes
    them: the expected one, or one 3 to 5 ahead, read; one of the two
    before the expected one, or a marker below SOF0, skipped with the data
    after it; one of the next two, or another marker, left unread, and the
    interval decoded from no data (a Huffman one left as it was where the
    data before had run out; an arithmetic one from zero bytes)."""
    path = FORMATS / name if (FORMATS / name).exists() else FORMATS.parent / name
    jpeg = path.read_bytes()
    assert len(_restart_markers(jpeg)) >= 3
    for k, data in enumerate(_restart_cases(jpeg, change)):
        same_as_pil(data, tmp_path, f"x{k}.jpg")


@pytest.mark.parametrize("name", ["rst422_q80.jpg", "arith420_rst.jpg", "lossless_rgb_p5.jpg",
                                  "arith_prog444_dac.jpg"])
def test_jpeg_ff_runs_before_a_stuffed_zero_equal_pil(name, tmp_path):
    """0xFF bytes before a stuffed 0x00 are one data byte to the Huffman and
    the arithmetic decoders alike: an 0xFF added before each of the scan
    data's ``FF 00`` pairs in turn."""
    path = FORMATS / name if (FORMATS / name).exists() else FORMATS.parent / name
    jpeg = path.read_bytes()
    pairs = [m.start() for m in re.finditer(b"\xff\x00", jpeg)
             if m.start() > jpeg.index(b"\xff\xda")]
    assert pairs, name
    for k, at in enumerate(pairs[:6]):
        assert same_as_pil(jpeg[:at] + b"\xff" + jpeg[at:], tmp_path, f"x{k}.jpg") == "JPEG"


@pytest.mark.parametrize("cut", [0.2, 0.5, 0.8])
@pytest.mark.parametrize("scan", [2, 4, 6])
def test_jpeg_scan_cut_by_eoi_smooths_as_pil(scan, cut, tmp_path):
    """A progressive JPEG whose EOI comes inside a scan: libjpeg-turbo
    smooths the iMCU rows past the last one that scan started with data
    left by the coefficient bits from before that scan (its
    ``last_good_iMCU_row``)."""
    jpeg = _jpegs()["progressive"]
    starts = [m.start() for m in re.finditer(b"\xff\xda", jpeg)]
    body = starts[scan] + 2 + struct.unpack_from(">H", jpeg, starts[scan] + 2)[0]
    end = jpeg.index(b"\xff", body + 1)
    while jpeg[end + 1] == 0:
        end = jpeg.index(b"\xff", end + 2)
    at = body + int(cut * (end - body))
    assert same_as_pil(jpeg[:at] + b"\xff\xd9", tmp_path, "x.jpg") == "JPEG"


# ------------------------------------------------- Pillow's rules, one case each

def _table_cases():
    white = bytes([0xFF])
    return {  # name → (bytes, Pillow's format, mode, first row's first channel)
        "im_bottom_row_first": (im_typed(b"Greyscale image", 2, 2, bytes([1, 2, 3, 4])), "IM",
                                "L", [3, 4]),
        "im_rgb_line_interleaved": (im_typed(b"RGB image", 2, 1, bytes([1, 2, 3, 4, 5, 6])), "IM",
                                    "RGB", [1, 2]),
        "im_rgb3_planes_g_r_b": (im_typed(b"RGB3 image", 2, 1, bytes([1, 2, 3, 4, 5, 6])), "IM",
                                 "RGB", [3, 4]),
        "im_f_truncates": (im_typed(b"L 32F image", 4, 1, np.array([-3.7, 0.6, 254.5, 300],
                                                                   "<f4").tobytes()), "IM", "F",
                           [0, 0, 254, 255]),
        "im_i16_clamps": (im_typed(b"L 16 image", 2, 1, np.array([7, 300], "<u2").tobytes()),
                          "IM", "I;16", [7, 255]),
        "im_b4_black": (im_typed(b"B4 image", 2, 1, bytes([0x12])), "IM", "P", [0, 0]),
        "msp_v1_set_bit_white": (msp_bytes(b"DanM", 3, 1, bytes([0b10100000])), "MSP", "1",
                                 [255, 0, 255]),
        "msp_v2_empty_row_white": (msp_v2([np.zeros(1, np.uint8)], 3, {0: b""}), "MSP", "1",
                                   [255, 255, 255]),
        "spider_nan_is_0": (spider_bytes(np.array([[np.nan, 1.9]], np.float32)), "SPIDER", "F",
                            [0, 1]),
        "blp1_jpeg_red_blue_swapped": (blp1_jpeg(8, 8, save(Image.new("RGB", (8, 8), (0, 0, 250)),
                                                            "JPEG", quality=100)),
                                       "BLP", "RGB", [250] * 8),
        "blp2_dxt1_shift_only": (blp2_bytes(4, 4, 2, 0, 0, struct.pack("<HHI", 0xFFFF, 0, 0)),
                                 "BLP", "RGB", [248] * 4),
        "blp2_palette_bgra": (blp2_bytes(1, 1, 1, 0, 0, bytes([1]), bytes([0, 0, 0, 0, 9, 8, 7, 6])
                                         + bytes(1016)), "BLP", "RGB", [7]),
        "icns_mask_dropped": (icns_bytes([(b"is32", icns_rgb(np.full((16, 16, 3), 5, np.uint8))),
                                          (b"s8mk", white * 256)]), "ICNS", "RGBA", [5] * 16),
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
    gray = im_typed(b"Greyscale image", 4, 3, bytes(12))
    v2 = msp_v2(_runny((3, 2), 1), 16)
    dxt1 = blp2_bytes(8, 8, 2, 0, 0, dxt_blocks(8, 8, 0, 1))
    jpeg = save(Image.fromarray(scene(8, 8, seed=1)), "JPEG")
    return {
        "im_truncated.im": (gray[:-1], "truncated"),
        "im_rlb.im": (im_typed(b"RLB image", 4, 3, bytes(36)), "no unpacker"),
        "im_pa_without_lut.im": (im_typed(b"PA image", 4, 3, bytes(24)), "no unpacker"),
        "im_size_not_a_number.im": (gray.replace(b"4*3", b"4*x"), "number"),
        "im_size_empty_number.im": (gray.replace(b"4*3", b"4* "), "number"),
        "im_size_float.im": (gray.replace(b"4*3", b"4.0*3"), "two integers"),
        "im_size_three.im": (gray.replace(b"4*3", b"4*3*1"), "two integers"),
        "im_scale_not_a_number.im": (im_bytes([b"Image size (x*y): 4*3", b"Scale (x,y): a"],
                                              bytes(12)), "number"),
        "im_mode_unknown.im": (im_typed(b"HSV image", 4, 3, bytes(12)), "no unpacker"),
        "im_bits_not_f.im": (im_bytes([b"Image type: L*12 image", b"Image type: L",
                                       b"Image size (x*y): 4*3"], bytes(40)), "bit decoder"),
        "im_bits_truncated.im": (im_typed(b"L*12 image", 4, 3, bytes(17)), "truncated"),
        "im_rgb3_truncated.im": (im_typed(b"RGB3 image", 4, 3, bytes(35)), "truncated"),
        "msp_v1_truncated.msp": (msp_bytes(b"DanM", 16, 3, bytes(5)), "truncated"),
        "msp_v2_table_truncated.msp": (msp_bytes(b"LinS", 16, 3, bytes(5)), "row table"),
        "msp_v2_row_truncated.msp": (v2[:-1], "truncated"),
        "msp_v2_run_cut.msp": (msp_v2(_runny((1, 2), 1), 16, {0: bytes([0, 5])}), "inside a run"),
        "msp_v2_too_few_bytes.msp": (msp_v2(_runny((2, 2), 1), 16, {1: bytes([1, 7])}),
                                     "not enough"),
        "spider_truncated.spi": (spider_bytes(spider_values(3, 5, 1))[:-1], "truncated"),
        "spider_image_in_stack.spi": (spider_bytes(spider_values(3, 5, 1), w27=2), "stack"),
        "spider_inf_istack.spi": (spider_bytes(spider_values(3, 5, 1), w24=np.inf), "istack"),
        "blp2_jpeg.blp": (blp2_bytes(8, 8, 1, 0, 0, jpeg, compression=0), "compression 0"),
        "blp2_encoding_3.blp": (blp2_bytes(2, 2, 3, 0, 0, bytes(16)), "encoding 3"),
        "blp2_alpha_encoding_8.blp": (blp2_bytes(4, 4, 2, 0, 8, bytes(16)),
                                      "alpha encoding 8"),
        "blp2_dxt_truncated.blp": (dxt1[:-1], "truncated"),
        "blp2_palette_truncated.blp": (dxt1[:600], "truncated"),
        "blp2_palette_too_few.blp": (blp2_bytes(4, 4, 1, 0, 0, bytes(15)), "not enough"),
        "blp1_encoding_3.blp": (blp1_palette(2, 2, bytes(4), encoding=3), "encoding 3"),
        "blp1_compression_2.blp": (blp1_palette(2, 2, bytes(4))[:4] + struct.pack("<i", 2)
                                   + blp1_palette(2, 2, bytes(4))[8:], "compression 2"),
        "blp1_jpeg_too_small.blp": (blp1_jpeg(20, 20, jpeg), "not enough"),
        "blp1_jpeg_not_jpeg.blp": (blp1_jpeg(8, 8, b"\0\0" + jpeg[2:]), "not a JPEG"),
        "icns_mask_alone.icns": (icns_bytes([(b"s8mk", bytes(256))]), "without its RGB"),
        "icns_mask_truncated.icns": (icns_bytes([(b"is32", icns_rgb(icon_px(16, 1))),
                                                 (b"s8mk", bytes(100))]), "mask"),
        "icns_rle_overrun.icns": (icns_bytes([(b"is32", bytes([0x80 + 127, 1]) * 3 + bytes(700))]),
                                  "left"),
        "icns_it32_signature.icns": (icns_bytes([(b"it32", b"\0\0\0\1" + bytes(49152))]),
                                     "zero bytes"),
        "icns_png_wrong_size.icns": (icns_bytes([(b"ic07", _png(20, 1))]), "allowed sizes"),
        "icns_unknown_subimage.icns": (icns_bytes([(b"ic07", bytes(40))]), "unsupported"),
        "icns_raw_truncated.icns": (icns_bytes([(b"il32", bytes(3072))])[:-5], "truncated"),
    }


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("name", REFUSALS)
def test_what_pillow_refuses_raises_naming_the_file(name, tmp_path):
    data, match = _refusals()[name]
    assert_refused(data, tmp_path, name, match)


# ------------------------------------------------------------------ fixtures

def raster3_fixture_bytes():
    """name → bytes of the committed IM, MSP, SPIDER, BLP and ICNS fixtures
    (each at most 64x48 but the 128x128 of ``it32``)."""
    small = Image.fromarray(scene(17, 23, seed=80))
    bits = Image.fromarray(scene(37, 45, seed=81)).convert("1")
    ims = {f"im_{m.lower().replace(';', '')}.im": save(im_image(m, 17, 23, 82 + k), "IM")
           for k, m in enumerate(IM_MODES)}
    lut = np.random.RandomState(83).randint(0, 256, 768).astype(np.uint8).tobytes()
    v2_rows = np.packbits(scene(30, 40, seed=84)[..., 0] > 128, axis=1)
    cmyk_jpeg = save(Image.fromarray(scene(16, 24, c=4, seed=85), "CMYK"), "JPEG", quality=85)
    rgba_pal = small.convert("P", palette=Image.Palette.ADAPTIVE, colors=60)
    pal = np.asarray(rgba_pal.getpalette("RGB"), np.uint8).reshape(-1, 3)
    rgba_pal.putpalette(np.concatenate([pal, np.arange(len(pal), dtype=np.uint8)[:, None]], 1)
                        .reshape(-1).tolist(), "RGBA")
    it32 = np.repeat(np.repeat(_runny((16, 16, 3), 86), 8, 0), 8, 1)
    return {
        **ims,
        "im_lut_colour.im": im_typed(b"Greyscale image", 23, 17, _runny((17 * 23,), 87).tobytes(),
                                     lut),
        "im_f12_bits.im": im_typed(b"L*12 image", 23, 17, _runny((17 * 35,), 88).tobytes()),
        "msp_v1.msp": save(bits, "MSP"),
        "msp_v2_rle.msp": msp_v2(v2_rows, 40, {3: b"", 7: bytes([0, 9, 0x55])}),
        "spider_pillow.spi": save(Image.fromarray(spider_values(17, 23, 89), "F"), "SPIDER"),
        "spider_big_endian.spi": spider_bytes(spider_values(17, 23, 90), ">"),
        "spider_stack.spi": spider_bytes(spider_values(17, 23, 91), "<", stack=True),
        "blp1_palette.blp": save(small.convert("P"), "BLP", blp_version="BLP1"),
        "blp2_palette_alpha.blp": save(rgba_pal, "BLP"),
        "blp1_jpeg.blp": blp1_jpeg(24, 16, save(Image.fromarray(scene(16, 24, seed=92)), "JPEG",
                                                quality=85)),
        "blp1_jpeg_cmyk.blp": blp1_jpeg(24, 16, cmyk_jpeg),
        "blp2_dxt1.blp": blp2_bytes(24, 16, 2, 0, 0, dxt_blocks(24, 16, 0, 93)),
        "blp2_dxt1_alpha_w6.blp": blp2_bytes(6, 13, 2, 1, 0, dxt_blocks(6, 13, 0, 94)),
        "blp2_dxt3.blp": blp2_bytes(24, 16, 2, 1, 1, dxt_blocks(24, 16, 1, 95)),
        "blp2_dxt5.blp": blp2_bytes(24, 16, 2, 1, 7, dxt_blocks(24, 16, 7, 96)),
        "blp2_dxt5_rgb.blp": blp2_bytes(24, 16, 2, 0, 7, dxt_blocks(24, 16, 7, 97)),
        "icns_is32_s8mk.icns": icns_bytes([(b"is32", icns_rgb(icon_px(16, 98))),
                                           (b"s8mk", bytes(range(256)))]),
        "icns_ih32_h8mk.icns": icns_bytes([(b"ih32", icns_rgb(icon_px(48, 99))),
                                           (b"h8mk", bytes(48 * 48))]),
        "icns_it32.icns": icns_bytes([(b"it32", bytes(4) + icns_rgb(it32))]),
        "icns_png.icns": icns_bytes([(b"is32", icns_rgb(icon_px(16, 100))),
                                     (b"ic11", _png(32, 101))]),
    }


RASTER3_SUFFIXES = (".im", ".msp", ".spi", ".blp", ".icns")
RASTER3_FIXTURES = sorted(p.name for p in FORMATS.iterdir() if p.suffix in RASTER3_SUFFIXES)
FORMAT_NAMES = {".im": "IM", ".msp": "MSP", ".spi": "SPIDER", ".blp": "BLP", ".icns": "ICNS"}


@pytest.mark.parametrize("name", RASTER3_FIXTURES)
def test_fixture_equals_pil(name, tmp_path):
    """Each committed fixture: Pillow's format, its pixels as committed, the
    port's; at most 64x48 but ``it32``'s 128x128, and a few KB."""
    data = (FORMATS / name).read_bytes()
    fmt = FORMAT_NAMES[name[name.rindex("."):]]
    want = np.load(FORMATS / (name[: name.rindex(".")] + ".npy"))
    got = assert_as_pil(data, tmp_path, name)
    assert I.decode_image(data, name)[0] == fmt
    np.testing.assert_array_equal(got, want)
    assert want.shape[0] * want.shape[1] <= 64 * 48 or want.shape[:2] == (128, 128), want.shape
    assert len(data) <= 16_000


def test_fixtures_cover_each_format():
    assert {FORMAT_NAMES[n[n.rindex("."):]] for n in RASTER3_FIXTURES} == set(FORMAT_NAMES.values())
    assert sorted(RASTER3_FIXTURES) == sorted(raster3_fixture_bytes())


@pytest.mark.parametrize("name", RASTER3_FIXTURES)
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
