"""PCX/DCX, Sun raster, XBM, XPM and PSD without Pillow:
``data/image_io.decode_image`` against ``Image.open(path)``: the container
it picks equals Pillow's ``format`` and the pixels equal
``np.asarray(Image.open(path).convert("RGB"))``, max |difference| 0.
Pillow opens each file from its path here, as the JAX package does (an
8-bit PCX shorter than 769 bytes opens from a ``BytesIO`` but not from a
path).

* PCX (``data/pcx.py``): 1 bit x 1, 2 and 4 planes, 8 bits x 1 plane (gray
  and palette) and x 3 planes, odd and even widths, the header's stride
  equal to the computed one or not, runs that end at a row's end; DCX's
  offset table and first frame.
* Sun raster (``data/sun.py``): depths 1, 4, 8, 24 and 32, types 1, 2
  (RLE, runs across rows) and 3, colour maps.
* XBM (``data/xbm.py``): widths not a multiple of 8, a hotspot, leading
  whitespace, hex bytes as ``XbmDecode.c`` finds them.
* XPM (``data/xpm.py``): 1 and 2 characters per pixel, up to 256 colours
  and more, ``None``, keys given twice, the ``/* pixels */`` line.
* PSD (``data/psd.py``): every mode of Pillow's table, raw and PackBits
  (ops cut at a row's end, no-ops), with and without resources and a layer
  section.

Pillow writes PCX (``1``, ``L``, ``P``, ``RGB``) and XBM; the writers here
write the rest. :func:`raster2_fixture_bytes` gives the committed fixtures
under ``tests/torch_images/formats/``, written anew with the other formats
by ``PYTHONPATH=. python tests/test_torch_image_formats.py``.
"""
import random
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from mm_s2ut_torch.data import image_io as I
from test_torch_image_formats import FORMATS, save, scene


def pillow(data: bytes, path):
    """(format, RGB pixels) of ``Image.open(path)``, or None where Pillow
    raises."""
    path.write_bytes(data)
    try:
        with Image.open(path) as im:
            return im.format, np.asarray(im.convert("RGB"))
    except Exception:
        return None


def assert_as_pil(data: bytes, tmp_path, name: str = "x.img") -> np.ndarray:
    """Pillow's format and pixels for ``data`` equal the port's."""
    want = pillow(data, tmp_path / name)
    assert want is not None, "Pillow refuses it"
    fmt, got = I.decode_image(data, name)
    assert fmt == want[0]
    assert got.shape == want[1].shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want[1])
    np.testing.assert_array_equal(I.read_image(tmp_path / name), want[1])
    return got


def assert_refused(data: bytes, tmp_path, name: str, match: str = ""):
    assert pillow(data, tmp_path / name) is None, "Pillow decodes it: not a refusal"
    with pytest.raises(ValueError, match=f"{name}.*{match}"):
        I.read_image(tmp_path / name)


def _runny(shape, seed, top=256):
    """Random bytes with runs (of every length up to 80) and repeats."""
    rng = np.random.RandomState(seed)
    flat = rng.randint(0, top, int(np.prod(shape)))
    at = 0
    while at < flat.size:
        n = int(rng.choice([1, 1, 2, 3, 5, 40, 70, 80]))
        flat[at: at + n] = flat[at]
        at += n
    return flat.reshape(shape).astype(np.uint8)


# ----------------------------------------------------------------------- PCX

def pcx_stride(w: int, bits: int, provided) -> int:
    """Pillow's stride: computed, rounded up to even where the header's differs."""
    stride = (w * bits + 7) // 8
    return stride + stride % 2 if provided != stride else stride


def pcx_rle(rows: np.ndarray, runs_past: bool = False) -> bytes:
    """RLE row by row: runs of equal bytes (at most 63), other bytes under
    0xC0 as literals, those from 0xC0 up as runs of one; ``runs_past`` lets
    a row's last run go on into the next row."""
    flat, row = rows.reshape(-1).tolist(), rows.shape[1]
    out = bytearray()
    i = 0
    while i < len(flat):
        end = len(flat) if runs_past else (i // row + 1) * row
        j = i
        while j + 1 < end and flat[j + 1] == flat[i] and j - i < 62:
            j += 1
        if j > i or flat[i] >= 0xC0:
            out += bytes([0xC0 | (j - i + 1), flat[i]])
        else:
            out.append(flat[i])
        i = j + 1
    return bytes(out)


def pcx_bytes(rows: np.ndarray, w: int, h: int, bits: int, planes: int, *, version: int = 5,
              stride=None, palette16: bytes = bytes(48), tail: bytes = b"", origin=(0, 0),
              body=None) -> bytes:
    """A PCX file: the header (box from ``origin``), then ``rows`` (h, planes
    x stride bytes) RLE-coded (or ``body``), then ``tail``."""
    x0, y0 = origin
    if stride is None:
        stride = (w * bits + 7) // 8
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x0 + w - 1, y0 + h - 1,
                        72, 72) + palette16 + bytes([0, planes]) + struct.pack("<HH", stride, 1))
    head += bytes(128 - len(head))
    return head + (pcx_rle(rows) if body is None else body) + tail


GRAY_RAMP = b"\x0c" + bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
PCX_MODES = {"1": (1, 1), "P2": (1, 2), "P4": (1, 4), "L": (8, 1), "P": (8, 1),
             "RGB": (8, 3)}


def pcx_case(mode: str, w: int, h: int, seed: int, stride_off: bool, runs_past: bool = False):
    """A PCX of ``mode`` with random rows (padding bytes too); ``runs_past``
    codes runs across rows."""
    bits, planes = PCX_MODES[mode]
    computed = (w * bits + 7) // 8
    provided = computed + 1 if stride_off else computed
    row = planes * pcx_stride(w, bits, provided)
    rows = _runny((h, row), seed)
    tail = b""
    if mode == "L":
        tail = GRAY_RAMP if seed % 2 else bytes(769)
    elif mode == "P":
        tail = b"\x0c" + np.random.RandomState(seed).randint(0, 256, 768).astype(np.uint8).tobytes()
    pal = np.random.RandomState(seed + 1).randint(0, 256, 48).astype(np.uint8).tobytes()
    data = pcx_bytes(rows, w, h, bits, planes, stride=provided, palette16=pal, tail=tail,
                     origin=(seed % 3, seed % 5), body=pcx_rle(rows, runs_past))
    return data + bytes(max(0, 769 - len(data)))  # Pillow seeks 769 bytes back in 8-bit files


@pytest.mark.parametrize("runs_past", [False, True])
@pytest.mark.parametrize("stride_off", [False, True])
@pytest.mark.parametrize("w", [1, 2, 3, 5, 8, 13, 16, 21])
@pytest.mark.parametrize("mode", sorted(PCX_MODES))
def test_pcx_modes_widths_strides_equal_pil(mode, w, stride_off, runs_past, tmp_path):
    """Each mode Pillow reads, odd and even widths, the header's stride equal
    to the computed one or not (Pillow then rounds the computed one up to
    even, and its decoder closes the planes up only where they fit), runs
    that end at their row's end or run past it (Pillow's buffer overrun)."""
    seed = w * 7 + len(mode)
    data = pcx_case(mode, w, 5, seed, stride_off, runs_past)
    if data != pcx_case(mode, w, 5, seed, stride_off):  # a run passes a row's end
        assert_refused(data, tmp_path, "x.pcx", "passes the end of row")
        return
    assert_as_pil(data, tmp_path, "x.pcx")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("odd", [False, True])
def test_pcx_as_pillow_writes_equals_pil(mode, odd, tmp_path):
    img = Image.fromarray(scene(9, 15 if odd else 16, seed=3)).convert(mode)
    assert_as_pil(save(img, "PCX"), tmp_path, "x.pcx")


@pytest.mark.parametrize("case", ["run_ends_at_row_end", "run_of_0", "literal_rows",
                                  "encoding_byte_0", "version_0_bits", "data_after_image"])
def test_pcx_rle_rules_equal_pil(case, tmp_path):
    """A run may end at its row's end; 0xC0 is a run of none; any encoding
    byte is read as RLE; data past the image is not read."""
    w, h = 6, 3
    rows = _runny((h, w), 5)
    body = {"run_ends_at_row_end": bytes([0xC6, 9, 0xC2, 1, 0xC4, 2, 0xC6, 3]),
            "run_of_0": bytes([0xC0, 7]) + pcx_rle(rows),
            "literal_rows": bytes(range(18)),
            "data_after_image": pcx_rle(rows) + bytes([0xFF, 1, 2, 3])}.get(case)
    data = pcx_bytes(rows, w, h, 8, 1, body=body, tail=GRAY_RAMP)
    if case == "encoding_byte_0":
        data = data[:2] + b"\0" + data[3:]
    if case == "version_0_bits":
        data = pcx_bytes(np.packbits(rows > 100, axis=1), w, h, 1, 1, version=0)
    assert_as_pil(data, tmp_path, "x.pcx")


def dcx_bytes(frames, order=None) -> bytes:
    """A DCX of PCX ``frames``, its offset table in ``order`` of the frames."""
    order = order or list(range(len(frames)))
    at = 4 + 4 * (len(frames) + 1)
    offsets, body = [0] * len(frames), b""
    for k in order:
        offsets[k] = at + len(body)
        body += frames[k]
    return struct.pack("<I", 0x3ADE68B1) + struct.pack(f"<{len(frames) + 1}I", *offsets, 0) + body


@pytest.mark.parametrize("case", ["one", "two", "frames_out_of_order", "last_frame_palette"])
def test_dcx_equals_pil(case, tmp_path):
    """The first offset's frame; an 8-bit frame is ``L`` or ``P`` by the
    file's last 769 bytes (the last frame's palette)."""
    a = save(Image.fromarray(scene(7, 9, seed=1)), "PCX")
    b = save(Image.fromarray(scene(5, 6, seed=2)).convert("P"), "PCX")
    gray = save(Image.fromarray(scene(7, 9, seed=3)).convert("L"), "PCX")
    frames, order = {"one": ([a], None), "two": ([a, b], None),
                     "frames_out_of_order": ([a, b], [1, 0]),
                     "last_frame_palette": ([gray, b], None)}[case]
    assert_as_pil(dcx_bytes(frames, order), tmp_path, "x.dcx")


# ----------------------------------------------------------------------- Sun

def sun_rle(flat: bytes) -> bytes:
    """SunRleDecode's stream: runs of 3 or more (at most 256) as 0x80 n-1 v,
    a 0x80 as 0x80 0x00, other bytes as themselves; runs cross rows."""
    out = bytearray()
    i = 0
    while i < len(flat):
        j = i
        while j + 1 < len(flat) and flat[j + 1] == flat[i] and j - i < 255:
            j += 1
        if j - i >= 2 or flat[i] == 0x80 and j > i:
            out += bytes([0x80, j - i, flat[i]])
        elif flat[i] == 0x80:
            out += b"\x80\x00"
        else:
            out += bytes(flat[i: j + 1])
        i = j + 1
    return bytes(out)


def sun_bytes(w, h, depth, ftype, body: bytes, cmap: bytes = b"", maptype=None) -> bytes:
    maptype = (1 if cmap else 0) if maptype is None else maptype
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype, maptype,
                       len(cmap)) + cmap + body


def sun_case(w, h, depth, ftype, cmap=b"", seed=0) -> bytes:
    """Random pixels (with runs, 0x80s and padding bytes) of a Sun raster."""
    rowbytes = (w * depth + 7) // 8
    if ftype == 2:
        flat = _runny((h * rowbytes,), seed)
        flat[::7] = 0x80
        return sun_bytes(w, h, depth, ftype, sun_rle(flat.tobytes()), cmap)
    stride = (w * depth + 15) // 16 * 2
    return sun_bytes(w, h, depth, ftype, _runny((h * stride,), seed).tobytes(), cmap)


SUN_MAPS = {"none": b"", "16": bytes(range(48)), "256": bytes(range(256)) * 3,
            "10_entries": bytes(range(100, 130))}


@pytest.mark.parametrize("cmap", sorted(SUN_MAPS))
@pytest.mark.parametrize("ftype", [1, 2, 3])
@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
def test_sun_depths_types_maps_equal_pil(depth, ftype, cmap, tmp_path):
    """Depths 1 (a set bit black), 4, 8, 24 and 32, raw (rows padded to 16
    bits; type 3 RGB order) and RLE (rows not padded); a planar colour map
    makes a 4- or 8-bit image ``P`` (entries past it black), and Pillow
    cannot load one beside 1, 24 or 32 bits."""
    data = sun_case(13, 6, depth, ftype, SUN_MAPS[cmap], depth + ftype)
    if cmap != "none" and depth in (1, 24, 32):
        assert_refused(data, tmp_path, "x.ras", "colour map beside")
        return
    assert_as_pil(data, tmp_path, "x.ras")


@pytest.mark.parametrize("ftype", [0, 4, 5])
def test_sun_other_raw_types_equal_pil(ftype, tmp_path):
    assert_as_pil(sun_case(9, 4, 8, ftype, seed=ftype), tmp_path, "x.ras")


@pytest.mark.parametrize("w", [1, 2, 7, 16, 17])
def test_sun_widths_equal_pil(w, tmp_path):
    """Narrow rows: width 1 (GIMP brush's test reads the length field, here
    not 1 or 4) and 2 (brush version 2 wants 'GIMP' at byte 20)."""
    for depth in (1, 8, 24):
        for ftype in (1, 2):
            data = sun_case(w, 3, depth, ftype, seed=w + depth)
            if w == 1 and struct.unpack_from(">I", data, 16)[0] in (1, 4):
                data = data[:16] + struct.pack(">I", 99) + data[20:]
            assert_as_pil(data, tmp_path, "x.ras")


def test_sun_rle_runs_across_rows_equal_pil(tmp_path):
    """A run longer than the image's rows, runs of 0x80 and a literal 0x80."""
    body = bytes([0x80, 40, 7, 0x80, 0, 1, 0x80, 2, 0x80, 0x80, 255, 9])
    assert_as_pil(sun_bytes(5, 60, 8, 2, body), tmp_path, "x.ras")


# ----------------------------------------------------------------------- XBM

def xbm_bytes(bits: np.ndarray, *, name: bytes = b"im", hotspot=None, lead: bytes = b"",
              fmt: bytes = b"0x%02x", sep: bytes = b", ") -> bytes:
    h, w = bits.shape
    head = lead + b"#define %s_width %d\n#define %s_height %d\n" % (name, w, name, h)
    if hotspot:
        head += b"#define %s_x_hot %d\n#define %s_y_hot %d\n" % (name, hotspot[0], name,
                                                                 hotspot[1])
    raw = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little").reshape(-1)
    return head + b"static char %s_bits[] = {\n" % name + sep.join(fmt % v for v in raw) + b"\n};\n"


@pytest.mark.parametrize("lead", [b"", b"\n", b" \t\r\n", b" " * 9, b" " * 10])
@pytest.mark.parametrize("hotspot", [None, (3, 1)])
@pytest.mark.parametrize("w", [1, 5, 8, 13, 20])
def test_xbm_widths_hotspots_whitespace_equal_pil(w, hotspot, lead, tmp_path):
    """Widths not a multiple of 8, a hotspot, whitespace before the first
    ``#define`` (Pillow's test of the first 16 bytes strips it: 10 bytes
    of it leave ``#defin``, and no plugin takes the file)."""
    bits = np.random.RandomState(w).rand(4, w) < 0.5
    data = xbm_bytes(bits, hotspot=hotspot, lead=lead)
    if len(lead) > 9:
        assert_refused(data, tmp_path, "x.xbm", "not an image the port reads")
        return
    assert_as_pil(data, tmp_path, "x.xbm")


@pytest.mark.parametrize("case", ["short_hex", "upper_hex", "x_in_comment", "no_spaces",
                                  "uppercase_X", "x_as_a_digit", "bits_twice_in_header", "crlf"])
def test_xbm_hex_as_xbmdecode_reads_it_equals_pil(case, tmp_path):
    """Each byte is the two characters after the next ``x`` (others 0):
    ``0x5,`` is 0x50; an ``x`` in a comment counts, one of those two
    characters does not start the next byte; ``0X`` does not."""
    bits = np.random.RandomState(7).rand(3, 12) < 0.5
    kw = {"short_hex": dict(fmt=b"0x%x"), "upper_hex": dict(fmt=b"0x%02X"),
          "no_spaces": dict(sep=b",")}.get(case, {})
    data = xbm_bytes(bits, **kw)
    if case == "uppercase_X":
        data = data.replace(b"{\n", b"{\n0XFF, ")
    if case == "x_as_a_digit":
        data = data.replace(b"{\n", b"{\n0xxx, 0x5x, ")
    if case == "x_in_comment":
        data = data.replace(b"{\n", b"{\n/* x1 */ ")
    if case == "bits_twice_in_header":
        data = data.replace(b"static", b"/* a_bits[] */ static")
    if case == "crlf":
        data = data.replace(b"\n", b"\r\n")
    assert_as_pil(data, tmp_path, "x.xbm")


@pytest.mark.parametrize("hotspot", [None, (2, 9)])
def test_xbm_as_pillow_writes_equals_pil(hotspot, tmp_path):
    img = Image.fromarray(scene(11, 19, seed=9)).convert("1")
    kw = {"hotspot": hotspot} if hotspot else {}
    assert_as_pil(save(img, "XBM", **kw), tmp_path, "x.xbm")


# ----------------------------------------------------------------------- XPM

_KEY_CHARS = [bytes([c]) for c in range(33, 127) if c not in b'"\\']


def xpm_keys(n: int, cpp: int):
    """``n`` distinct keys of ``cpp`` printable characters."""
    keys = []
    for k in range(n):
        key = b""
        for _ in range(cpp):
            key += _KEY_CHARS[k % len(_KEY_CHARS)]
            k //= len(_KEY_CHARS)
        keys.append(key)
    return keys


def xpm_bytes(w, h, colours, rows, cpp, *, pixels_comment=False) -> bytes:
    """An XPM: ``colours`` [(key, spec words)], ``rows`` the pixel lines' text."""
    out = b"/* XPM */\nstatic char *image[] = {\n/* columns rows colors chars-per-pixel */\n"
    out += b'"%d %d %d %d",\n' % (w, h, len(colours), cpp)
    out += b"".join(b'"%s %s",\n' % (k, spec) for k, spec in colours)
    if pixels_comment:
        out += b"/* pixels */\n"
    return out + b"".join(b'"%s",\n' % r for r in rows) + b"};\n"


def xpm_case(w, h, n, cpp, seed, *, none=False, pixels_comment=False) -> bytes:
    rng = np.random.RandomState(seed)
    keys = xpm_keys(n, cpp)
    colours = [(k, b"c #%06x" % rng.randint(0, 1 << 24)) for k in keys]
    if none:
        colours[1] = (keys[1], b"c None")
    live = [k for k, (_, spec) in zip(keys, colours) if spec != b"c None"]
    idx = rng.randint(0, len(live), (h, w))
    rows = [b"".join(live[i] for i in r) for r in idx]
    return xpm_bytes(w, h, colours, rows, cpp, pixels_comment=pixels_comment)


@pytest.mark.parametrize("pixels_comment", [False, True])
@pytest.mark.parametrize("cpp,n", [(1, 2), (1, 60), (2, 200), (2, 256), (2, 257), (2, 600),
                                   (3, 40)])
def test_xpm_keys_and_colours_equal_pil(cpp, n, pixels_comment, tmp_path):
    """1, 2 and 3 characters per pixel; up to 256 colours (``P``) and more
    (``RGB``); an unused ``None``; the ``/* pixels */`` line skipped."""
    data = xpm_case(9, 7, n, cpp, n + cpp, none=n > 2, pixels_comment=pixels_comment)
    assert_as_pil(data, tmp_path, "x.xpm")


XPM_COLOURS = {  # colour lines of a 2-pixel image "ab": what Pillow makes of them
    "hex_48_bit": [(b"a", b"c #111122223333"), (b"b", b"c #0a0b0c")],
    "hex_12_bit": [(b"a", b"c #f0a"), (b"b", b"c #0x_ff")],
    "other_keys_first": [(b"a", b"s sym m white c #123456"), (b"b", b"g4 #000 c #654321")],
    "key_twice": [(b"a", b"c #010203"), (b"b", b"c #040506"), (b"a", b"c #070809")],
    "none_unused": [(b"c", b"c None"), (b"a", b"c #ff0000"), (b"b", b"c #00ff00")],
}


@pytest.mark.parametrize("case", sorted(XPM_COLOURS))
def test_xpm_colour_rules_equal_pil(case, tmp_path):
    """Only the low 24 bits of a hex number (Python's ``int(.., 16)``); the
    first ``c`` word; a key given twice keeps its first place and its later
    colour; ``None`` out of the palette."""
    assert_as_pil(xpm_bytes(2, 1, XPM_COLOURS[case], [b"ab"], 1), tmp_path, "x.xpm")


@pytest.mark.parametrize("case", ["rows_spill", "quotes_inside", "comment_lines",
                                  "no_trailing_comma", "data_past_image"])
def test_xpm_pixel_lines_equal_pil(case, tmp_path):
    """Keys are read across lines in turn (a long line fills the next row);
    the text between a line's first and last quote; lines without quotes
    add none; a colour line without its trailing comma loses its last
    character; keys past the image's end must be in the palette too."""
    colours = [(b"a", b"c #010203"), (b"b", b"c #040506"), (b'"', b"c #070809")]
    rows = {"rows_spill": [b"abb", b"a"], "quotes_inside": [b'a"', b"ba"],
            "comment_lines": [b"ab", b"ba"], "no_trailing_comma": [b"ab", b"ba"],
            "data_past_image": [b"ab", b"baab"]}[case]
    data = xpm_bytes(2, 2, colours, rows, 1)
    if case == "comment_lines":
        data = data.replace(b'"ba"', b'/* a comment */\n\n"ba"')
    if case == "no_trailing_comma":
        data = data.replace(b'"b c #040506",', b'"b c #0405060"')
    assert_as_pil(data, tmp_path, "x.xpm")


# ----------------------------------------------------------------------- PSD

def psd_packbits(row: bytes, cut: bool = False, nops: bool = False) -> bytes:
    """PackBits ops for one row: runs of 2-128 equal bytes, literals of up to
    128; ``cut`` lengthens the row's last op past its end (Pillow cuts it),
    ``nops`` puts 0x80 between ops."""
    out, ops = bytearray(), []
    i = 0
    while i < len(row):
        j = i
        while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            ops.append([True, row[i: j + 1]])
        elif ops and not ops[-1][0] and len(ops[-1][1]) < 128:
            ops[-1][1] += row[i: i + 1]
        else:
            ops.append([False, bytearray(row[i: i + 1])])
        i = j + 1
    if cut and ops:
        run, px = ops[-1]
        ops[-1][1] = bytes(px) + (bytes(px[:1]) * 3 if run else bytes([1, 2, 3]))[: 128 - len(px)]
    for run, px in ops:
        if nops:
            out.append(0x80)
        out += bytes([257 - len(px), px[0]]) if run else bytes([len(px) - 1]) + bytes(px)
    return bytes(out)


RESOURCES = (b"8BIM" + struct.pack(">H", 1005) + b"\x00\x00" + struct.pack(">I", 5) + bytes(6)
             + b"8BIM" + struct.pack(">H", 1039) + b"\x03abc" + struct.pack(">I", 4) + bytes(4))
LAYERS = struct.pack(">I", 12) + bytes(12) + bytes(8)


def psd_bytes(cmode, bits, planes, w, h, *, channels=None, rle=False, cmdata=b"",
              resources=b"", layers=b"", cut=False, nops=False) -> bytes:
    """A PSD: ``planes`` (c, h, row bytes) as the composite image."""
    planes = np.asarray(planes, np.uint8)
    channels = len(planes) if channels is None else channels
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels, h, w, bits, cmode)
    for section in (cmdata, resources, layers):
        out += struct.pack(">I", len(section)) + section
    if not rle:
        return out + struct.pack(">H", 0) + planes.tobytes()
    rows = [psd_packbits(r.tobytes(), cut and y % 2 == 0, nops and y % 3 == 0)
            for p in planes for y, r in enumerate(p)]
    return (out + struct.pack(">H", 1) + struct.pack(f">{len(rows)}H", *map(len, rows))
            + b"".join(rows))


PSD_KINDS = {  # name → (colour mode, bits, channels)
    "bitmap": (0, 1, 1), "gray": (1, 8, 1), "gray_mode0": (0, 8, 1), "indexed": (2, 8, 1),
    "rgb": (3, 8, 3), "rgba": (3, 8, 4), "rgb_5_channels": (3, 8, 5), "cmyk": (4, 8, 4),
    "cmyk_alpha": (4, 8, 5), "multichannel": (7, 8, 3), "duotone": (8, 8, 1)}


def psd_case(kind, w, h, seed, **kw) -> bytes:
    cmode, bits, channels = PSD_KINDS[kind]
    row = (w + 7) // 8 if bits == 1 else w
    planes = _runny((channels, h, row), seed)
    if kind == "indexed" and "cmdata" not in kw:
        kw["cmdata"] = np.random.RandomState(seed).randint(0, 256, 768).astype(np.uint8).tobytes()
    return psd_bytes(cmode, bits, planes, w, h, **kw)


@pytest.mark.parametrize("sections", [False, True])
@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("kind", sorted(PSD_KINDS))
def test_psd_modes_compressions_sections_equal_pil(kind, rle, sections, tmp_path):
    """Every (mode, bits) of Pillow's table but Lab, raw and PackBits, with
    and without image resources and a layer section."""
    kw = dict(resources=RESOURCES, layers=LAYERS) if sections else {}
    assert_as_pil(psd_case(kind, 11, 6, len(kind), rle=rle, **kw), tmp_path, "x.psd")


@pytest.mark.parametrize("case", ["cut_ops", "no_ops", "indexed_without_palette",
                                  "indexed_palette_of_767", "odd_resource_name",
                                  "zero_counts_channel"])
def test_psd_rules_equal_pil(case, tmp_path):
    """PackBits ops past a row's end cut there, 0x80 no op; an indexed image
    without a 768-byte colour-mode section is black; resource names padded
    to even; a channel whose counts are all 0 reads the next one's bytes."""
    w, h = 10, 5
    if case in ("cut_ops", "no_ops"):
        data = psd_case("rgb", w, h, 3, rle=True, cut=case == "cut_ops", nops=case == "no_ops")
    elif case == "indexed_without_palette":
        data = psd_case("indexed", w, h, 4, cmdata=b"")
    elif case == "indexed_palette_of_767":
        data = psd_case("indexed", w, h, 4, cmdata=bytes(range(256)) * 2 + bytes(255))
    elif case == "odd_resource_name":
        res = b"8BIM" + struct.pack(">H", 7) + b"\x02ab" + b"\0" + struct.pack(">I", 3) + b"xyz\0"
        data = psd_case("gray", w, h, 5, resources=res, layers=LAYERS)
    else:
        planes = _runny((3, h, w), 6)
        rows = [psd_packbits(r.tobytes()) for p in planes for r in p]
        for y in range(h):
            rows[h + y] = b""
        data = (psd_bytes(3, 8, planes, w, h, rle=True)[:26 + 12 + 2]
                + struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows))
    assert_as_pil(data, tmp_path, "x.psd")


# ------------------------------------------------- Pillow's rules, one case each

def _table_cases():
    one_row = np.asarray([[[0b10100000]]], np.uint8)
    palette8 = bytes(range(0, 256)) * 3
    return {  # name → (bytes, Pillow's format, mode, first channel of the first row)
        "pcx_1bit": (pcx_bytes(one_row[0], 8, 1, 1, 1, tail=bytes(700)), "PCX", "1",
                     [255, 0, 255, 0, 0, 0, 0, 0]),
        "pcx_8bit_no_palette": (pcx_bytes(np.asarray([[7, 200]], np.uint8), 2, 1, 8, 1,
                                          tail=bytes(769)), "PCX", "L", [7, 200]),
        "pcx_as_pillow_writes_p": (save(Image.fromarray(scene(4, 6, seed=1)).convert("P"),
                                        "PCX"), "PCX", "P", None),
        "dcx_first_frame": (dcx_bytes([save(Image.fromarray(scene(3, 4, seed=2)), "PCX")]),
                            "DCX", "RGB", None),
        "sun_1bit": (sun_bytes(8, 1, 1, 1, bytes([0b10100000, 0])), "SUN", "1",
                     [0, 255, 0, 255, 255, 255, 255, 255]),
        "sun_8bit_planar_map": (sun_bytes(2, 1, 8, 1, bytes([0, 1]), bytes([10, 20, 30, 40,
                                                                          50, 60])),
                                "SUN", "P", [10, 20]),
        "sun_24bit_type1": (sun_bytes(2, 1, 24, 1, bytes([1, 2, 3, 4, 5, 6])), "SUN", "RGB",
                            [3, 6]),
        "sun_24bit_type3": (sun_bytes(2, 1, 24, 3, bytes([1, 2, 3, 4, 5, 6])), "SUN", "RGB",
                            [1, 4]),
        "sun_32bit_two_pixels": (sun_bytes(2, 1, 32, 1, bytes(range(1, 9))), "SUN", "RGB",
                                 [3, 7]),
        "xbm_lsb_first": (xbm_bytes(np.asarray([[1, 0, 1, 0, 0, 0, 0, 0]], bool)), "XBM", "1",
                          [255, 0, 255, 0, 0, 0, 0, 0]),
        "xpm_two_colours": (xpm_bytes(2, 1, [(b"a", b"c #0a0b0c"), (b"b", b"c #ff0000")],
                                      [b"ab"], 1), "XPM", "P", [10, 255]),
        "xpm_48_bit": (xpm_bytes(1, 1, [(b"a", b"c #111122223333")], [b"a"], 1), "XPM", "P",
                       [34]),
        "xpm_none_unused": (xpm_bytes(2, 1, XPM_COLOURS["none_unused"], [b"ab"], 1), "XPM", "P",
                            [255, 0]),
        "psd_rgb_raw": (psd_bytes(3, 8, [[[1, 2]], [[3, 4]], [[5, 6]]], 2, 1), "PSD", "RGB",
                        [1, 2]),
        "psd_rgba": (psd_bytes(3, 8, [[[1, 2]], [[3, 4]], [[5, 6]], [[7, 8]]], 2, 1), "PSD",
                     "RGBA", [1, 2]),
        "psd_cmyk_inverted": (psd_bytes(4, 8, [[[0]], [[255]], [[255]], [[255]]], 1, 1), "PSD",
                              "CMYK", [0]),
        "psd_bitmap": (psd_bytes(0, 1, one_row, 3, 1), "PSD", "1", [255, 0, 255]),
        "psd_indexed_no_palette": (psd_bytes(2, 8, [[[0, 1, 2]]], 3, 1), "PSD", "P", [0, 0, 0]),
        "psd_indexed_palette": (psd_bytes(2, 8, [[[0, 1, 200]]], 3, 1, cmdata=palette8), "PSD",
                                "P", [0, 1, 200]),
    }


TABLE = sorted(_table_cases())


@pytest.mark.parametrize("case", TABLE)
def test_table_of_pillow_rules(case, tmp_path):
    data, fmt, mode, first_row = _table_cases()[case]
    (tmp_path / "x.img").write_bytes(data)
    with Image.open(tmp_path / "x.img") as im:
        assert (im.format, im.mode) == (fmt, mode)
    got = assert_as_pil(data, tmp_path, "x.img")
    if first_row is not None:
        assert got[0, :, 0].tolist() == first_row
    if case == "psd_cmyk_inverted":
        assert got[0, 0].tolist() == [0, 255, 255]


# ------------------------------------------------------------------ refusals

def _refusals():
    pcx_rows = _runny((3, 6), 1)
    rgb = psd_case("rgb", 6, 4, 2)
    rgb_rle = psd_case("rgb", 6, 4, 2, rle=True)
    sun_rle_data = sun_case(6, 4, 8, 2, seed=3)
    xpm_ab = [(b"a", b"c #010203"), (b"b", b"c #040506")]
    return {
        "pcx_cga.pcx": (pcx_bytes(_runny((2, 2), 2), 8, 2, 2, 1), "2 bits x 1 planes"),
        "pcx_4bit_1plane.pcx": (pcx_bytes(_runny((2, 4), 2), 8, 2, 4, 1), "4 bits x 1 planes"),
        "pcx_v3_8bit.pcx": (pcx_bytes(pcx_rows, 6, 3, 8, 1, version=3, tail=bytes(769)),
                            "version 3 of 8 bits"),
        "pcx_1bit_3planes.pcx": (pcx_bytes(_runny((2, 3), 2), 8, 2, 1, 3), "1 bits x 3 planes"),
        "pcx_8bit_short_file.pcx": (pcx_bytes(pcx_rows, 6, 3, 8, 1), "769 bytes"),
        "pcx_run_past_row.pcx": (pcx_bytes(pcx_rows, 6, 3, 8, 1, body=bytes([0xC8, 1]) + bytes(
            10), tail=bytes(769)), "passes the end of row 0"),
        "pcx_truncated.pcx": (pcx_bytes(pcx_rows, 6, 3, 8, 3)[:-2], "ends after"),
        "dcx_empty_table.dcx": (struct.pack("<2I", 0x3ADE68B1, 0), "not an image the port"),
        "dcx_frame_past_end.dcx": (struct.pack("<3I", 0x3ADE68B1, 400, 0), "not an image"),
        "sun_1x1_32bit_is_gbr.ras": (sun_bytes(1, 1, 32, 1, bytes([1, 2, 3, 4])), "GIMP brush"),
        "sun_1x2_1bit_is_gbr.ras": (sun_bytes(1, 2, 1, 1, bytes(4)), "GIMP brush"),
        "sun_map_beside_24bit.ras": (sun_case(3, 2, 24, 1, bytes(6)), "colour map beside"),
        "sun_map_beside_1bit.ras": (sun_case(9, 2, 1, 2, bytes(6)), "colour map beside"),
        "sun_map_of_257.ras": (sun_case(3, 2, 8, 1, bytes(771)), "257 entries"),
        "sun_map_type2.ras": (sun_case(3, 2, 8, 1, bytes(6))[:24] + struct.pack(">I", 2)
                              + sun_case(3, 2, 8, 1, bytes(6))[28:], "not an image"),
        "sun_depth16.ras": (sun_bytes(3, 2, 16, 1, bytes(12)), "not an image"),
        "sun_type6.ras": (sun_bytes(3, 2, 8, 6, bytes(8)), "not an image"),
        "sun_truncated.ras": (sun_case(5, 4, 24, 1)[:-7], "truncated"),
        "sun_rle_truncated.ras": (sun_rle_data[:-3], "ends after"),
        "xbm_truncated.xbm": (xbm_bytes(np.ones((4, 9), bool))[:-12], "XBM data ends"),
        "xbm_size0.xbm": (xbm_bytes(np.ones((0, 9), bool)), "not an image"),
        "xpm_none_used.xpm": (xpm_bytes(2, 1, [(b"a", b"c None"), (b"b", b"c #ff0000")],
                                        [b"ab"], 1), "not in the palette"),
        "xpm_named_colour.xpm": (xpm_bytes(2, 1, [(b"a", b"c red")] + xpm_ab[1:], [b"ab"], 1),
                                 "red"),
        "xpm_no_c_key.xpm": (xpm_bytes(2, 1, [(b"a", b"m #ffffff")] + xpm_ab[1:], [b"ab"], 1),
                             "without a c key"),
        "xpm_bad_hex.xpm": (xpm_bytes(2, 1, [(b"a", b"c #12g")] + xpm_ab[1:], [b"ab"], 1),
                            "#12g"),
        "xpm_c_without_value.xpm": (xpm_bytes(2, 1, [(b"a", b"c")] + xpm_ab[1:], [b"ab"], 1),
                                    "not an image"),
        "xpm_empty_number.xpm": (xpm_bytes(2, 1, xpm_ab, [b"ab"], 1).replace(b'"2 1', b'" 1'),
                                 "header"),
        "xpm_short.xpm": (xpm_bytes(2, 2, xpm_ab, [b"ab"], 1), "ends after 2 of 4"),
        "xpm_0_cpp.xpm": (xpm_bytes(2, 1, [(b"", b"c #010203")], [b"ab"], 0), "0 characters"),
        "xpm_key_past_image.xpm": (xpm_bytes(2, 1, xpm_ab, [b"abz"], 1), "not in the palette"),
        "xpm_no_header.xpm": (b"/* XPM */\nstatic char *x[] = {\n};\n", "not an image"),
        "psd_rgb_2_channels.psd": (psd_bytes(3, 8, _runny((2, 2, 3), 1), 3, 2),
                                   "not enough channels"),
        "psd_gray16.psd": (psd_bytes(1, 16, _runny((1, 2, 6), 1), 3, 2), "not an image"),
        "psd_version2.psd": (rgb[:5] + b"\2" + rgb[6:], "not an image"),
        "psd_zip.psd": (rgb[:26 + 12] + struct.pack(">H", 2) + rgb[26 + 14:], "compression 2"),
        "psd_truncated.psd": (rgb[:-1], "truncated"),
        "psd_packbits_truncated.psd": (rgb_rle[:-2], "PackBits data ends"),
        "psd_counts_truncated.psd": (rgb_rle[:26 + 12 + 2 + 10], "not an image"),
    }


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("name", REFUSALS)
def test_what_pillow_refuses_raises_naming_the_file(name, tmp_path):
    data, match = _refusals()[name]
    assert_refused(data, tmp_path, name, match)


def test_psd_lab_left_to_port_raises_naming_the_mode(tmp_path):
    """Pillow reads Lab through LittleCMS (``ImageCms``); the port raises,
    naming the file and the mode, until it models that transform."""
    data = psd_bytes(9, 8, [[[128]], [[128]], [[128]]], 1, 1)
    (tmp_path / "lab.psd").write_bytes(data)
    with Image.open(tmp_path / "lab.psd") as im:
        assert im.mode == "LAB" and np.asarray(im.convert("RGB"))[0, 0].tolist() == [119] * 3
    with pytest.raises(ValueError, match="lab.psd.*LAB.*LittleCMS"):
        I.read_image(tmp_path / "lab.psd")


# ----------------------------------------------------------- choice of format

def test_container_order_is_pillows():
    """``decode_image`` tries the containers in the order ``Image.open``
    tries Pillow's plugins (those it loads first, then ``Image.ID``)."""
    out = subprocess.run([sys.executable, "-c", "from PIL import Image; Image.preinit(); "
                          "Image.init(); print(' '.join(Image.ID))"], capture_output=True,
                         text=True, check=True).stdout.split()
    ours = [fmt for fmt, _, _ in I._CONTAINERS]
    assert [f for f in out if f in ours] == ours


# ------------------------------------------------------------------ fixtures

def raster2_fixture_bytes():
    """name → bytes of the committed PCX/DCX, Sun, XBM, XPM and PSD fixtures
    (each at most 64x48)."""
    img = Image.fromarray(scene(37, 45, seed=60))
    small = Image.fromarray(scene(19, 21, seed=61))
    bits = scene(37, 45, seed=62)[..., 0] > 128
    pal16 = np.random.RandomState(63).randint(0, 256, 48).astype(np.uint8).tobytes()
    pcx4_rows = _runny((24, 4 * pcx_stride(31, 1, 5)), 64)
    sun_rgb = np.asarray(img)[..., ::-1].reshape(-1).tobytes()  # BGR
    sun_idx = np.asarray(img.convert("P")).reshape(-1)
    sun_map = np.random.RandomState(65).randint(0, 256, (3, 256)).astype(np.uint8).tobytes()
    rgbx = np.concatenate([np.asarray(small), np.full((19, 21, 1), 7, np.uint8)], 2)
    gray = np.asarray(img.convert("L"))
    cmyk = np.moveaxis(np.asarray(small.convert("CMYK")), 2, 0)
    adaptive = img.convert("P", palette=Image.Palette.ADAPTIVE, colors=40)
    pal = np.zeros((256, 3), np.uint8)
    used = np.asarray(adaptive.getpalette("RGB"), np.uint8).reshape(-1, 3)
    pal[: len(used)] = used
    return {
        "pcx_rgb.pcx": save(img, "PCX"),
        "pcx_palette.pcx": save(img.convert("P"), "PCX"),
        "pcx_gray.pcx": save(img.convert("L"), "PCX"),
        "pcx_bilevel.pcx": save(Image.fromarray(bits), "PCX"),
        "pcx_4planes.pcx": pcx_bytes(pcx4_rows, 31, 24, 1, 4, stride=5, palette16=pal16,
                                     origin=(10, 20)),
        "dcx_two_frames.dcx": dcx_bytes([save(small, "PCX"), save(img.convert("L"), "PCX")]),
        "sun_rgb_rle.ras": sun_bytes(45, 37, 24, 2, sun_rle(sun_rgb)),
        "sun_palette.ras": sun_bytes(45, 37, 8, 1, np.pad(sun_idx.reshape(37, 45), ((0, 0), (
            0, 1))).tobytes(), sun_map),
        "sun_bilevel.ras": sun_bytes(45, 37, 1, 1, np.packbits(bits, axis=1).tobytes()),
        "sun_rgbx.ras": sun_bytes(21, 19, 32, 3, rgbx.tobytes()),
        "xbm_hotspot.xbm": save(Image.fromarray(bits[:30, :45]), "XBM", hotspot=(4, 7)),
        "xpm_2cpp.xpm": xpm_case(30, 20, 150, 2, 66, none=True),
        "xpm_1cpp.xpm": xpm_case(24, 16, 20, 1, 67, pixels_comment=True),
        "psd_rgb_packbits.psd": psd_bytes(3, 8, np.moveaxis(np.asarray(img), 2, 0), 45, 37,
                                          rle=True, resources=RESOURCES, layers=LAYERS),
        "psd_cmyk.psd": psd_bytes(4, 8, cmyk, 21, 19),
        "psd_indexed.psd": psd_bytes(2, 8, np.asarray(adaptive)[None], 45, 37, rle=True,
                                     cmdata=pal.T.tobytes()),
        "psd_bitmap.psd": psd_bytes(0, 1, np.packbits(bits, axis=1)[None], 45, 37),
        "psd_gray.psd": psd_bytes(1, 8, gray[None], 45, 37, resources=RESOURCES),
    }


RASTER2_SUFFIXES = (".pcx", ".dcx", ".ras", ".xbm", ".xpm", ".psd")
RASTER2_FIXTURES = sorted(p.name for p in FORMATS.iterdir() if p.suffix in RASTER2_SUFFIXES)


@pytest.mark.parametrize("name", RASTER2_FIXTURES)
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
