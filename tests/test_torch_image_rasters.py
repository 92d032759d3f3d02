"""Netpbm, TGA, ICO/CUR/DIB, QOI and SGI without Pillow:
``data/image_io.decode_image`` against ``Image.open(p)``: the container
it picks equals Pillow's ``format`` and the pixels equal
``np.asarray(Image.open(p).convert("RGB"))``, max |difference| 0.

* Netpbm (``data/netpbm.py``): P1-P6 raw and plain at maxval 1 to 65535
  (Pillow's scaling, half to even, 16-bit gray clipped at 255), comments
  in the header and the plain data, ``Pf`` in both byte orders.
* TGA (``data/tga.py``): image types 1, 2, 3 and their RLE forms 9, 10,
  11 at every depth Pillow takes, each origin, colour maps of 16 and 24
  bits with a first index, the image-ID field, literal packets running on
  into the next rows.
* ICO, CUR and DIB (``data/ico.py`` over ``data/bmp.py``): the entry
  Pillow picks among BMP payloads of 1, 4, 8, 24 and 32 bits and PNG
  payloads, the bitmap's doubled height, the AND mask's bounds.
* QOI (``data/qoi.py``): images whose op streams hold all six ops.
* SGI (``data/sgi.py``): verbatim and RLE, 1 and 2 bytes per sample, 1, 3
  and 4 channels, dimension 1, and the RLE decoder's stops and overruns.

Pillow writes Netpbm, TGA, ICO, DIB, QOI and 8-bit SGI; the writers here
write what it does not (plain Netpbm, odd maxvals, RLE with spanning
literals, hand-made ICO and CUR directories, 16-bit and RLE SGI).
:func:`raster_fixture_bytes` gives the committed fixtures under
``tests/torch_images/formats/``, written anew with the other formats by
``PYTHONPATH=. python tests/test_torch_image_formats.py``.
"""
import io
import random
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from mm_s2ut_torch.data import image_io as I
from test_torch_image_containers import _indices, _palette, bmp_bytes
from test_torch_image_formats import FORMATS, pil_refuses, save, scene


def assert_as_pil(data: bytes, tmp_path, name: str = "x.img") -> np.ndarray:
    """Pillow's format and pixels for ``data`` equal the port's."""
    im = Image.open(io.BytesIO(data))
    want_format = im.format
    want = np.asarray(im.convert("RGB"))
    fmt, got = I.decode_image(data, name)
    assert fmt == want_format
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    (tmp_path / name).write_bytes(data)
    np.testing.assert_array_equal(I.read_image(tmp_path / name), want)
    return got


def assert_refused(data: bytes, tmp_path, name: str, match: str = ""):
    assert pil_refuses(data), "Pillow decodes it: not a refusal"
    (tmp_path / name).write_bytes(data)
    with pytest.raises(ValueError, match=f"{name}.*{match}"):
        I.read_image(tmp_path / name)


# -------------------------------------------------------------------- Netpbm

def pnm_bytes(magic: bytes, samples, maxval=None, *, plain_sep=b" ", header=None) -> bytes:
    """A Netpbm file of (h, w) or (h, w, 3) samples (bits for P1/P4);
    ``header`` replaces the text between the magic and the data."""
    px = np.asarray(samples)
    h, w = px.shape[:2]
    if header is None:
        header = b"\n%d %d\n" % (w, h) + (b"" if magic in (b"P1", b"P4") else b"%d\n" % maxval)
    if magic == b"P4":
        body = np.packbits(px.astype(np.uint8), axis=1).tobytes()
    elif magic == b"P1":
        body = plain_sep.join(b"1" if v else b"0" for v in px.reshape(-1))
    elif magic in (b"P2", b"P3"):
        body = plain_sep.join(b"%d" % v for v in px.reshape(-1))
    else:
        body = px.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return magic + header + body


def pfm_bytes(values, scale: float) -> bytes:
    v = np.asarray(values, np.float32)
    h, w = v.shape
    return (b"Pf\n%d %d\n%r\n" % (w, h, scale)
            + v[::-1].astype("<f4" if scale < 0 else ">f4").tobytes())


def _samples(h, w, bands, top, seed, over=0):
    """Samples 0..top with runs of both ends, ``over`` past it (raw only)."""
    rng = np.random.RandomState(seed)
    px = rng.randint(0, top + 1 + over, (h, w, bands))
    px[0, :2] = 0
    px[-1, -2:] = top
    return px[..., 0] if bands == 1 else px


MAXVALS = [1, 15, 100, 255, 256, 1000, 65535]


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("bands", [1, 3])
@pytest.mark.parametrize("maxval", MAXVALS)
def test_netpbm_maxvals_equal_pil(maxval, bands, plain, tmp_path):
    """Scaled as ``round(v / maxval * top)``: raw samples past maxval capped."""
    over = 0 if plain else min(maxval, 255 if maxval < 256 else 65535 - maxval)
    px = _samples(7, 11, bands, maxval, maxval + bands, over)
    magic = {(1, True): b"P2", (3, True): b"P3", (1, False): b"P5", (3, False): b"P6"}
    assert_as_pil(pnm_bytes(magic[bands, plain], px, maxval), tmp_path, "x.pnm")


@pytest.mark.parametrize("magic", [b"P1", b"P4"])
@pytest.mark.parametrize("h,w", [(1, 1), (5, 8), (7, 13), (3, 30)])
def test_netpbm_bits_equal_pil(magic, h, w, tmp_path):
    bits = np.random.RandomState(h * w).rand(h, w) < 0.4
    assert_as_pil(pnm_bytes(magic, bits), tmp_path, "x.pbm")


HEADERS = {
    "comments": b"\n# a comment\n5 #width\n#more\n 3\n# maxval next\n200\n",
    "tabs_and_crs": b"\t\r\n 5\x0b3\x0c\x0c200\r",
    "comment_inside_token": b" 5 3 2#c\n00\n",  # the token goes on after it: maxval 200
    "comment_to_cr": b" #c\r5 3 200 ",
}


@pytest.mark.parametrize("case", sorted(HEADERS))
@pytest.mark.parametrize("magic", [b"P2", b"P5"])
def test_netpbm_headers_equal_pil(case, magic, tmp_path):
    px = _samples(3, 5, 1, 200, 3)
    assert_as_pil(pnm_bytes(magic, px, 200, header=HEADERS[case]), tmp_path, "x.pgm")


@pytest.mark.parametrize("case", ["comments", "no_separators", "newlines"])
def test_netpbm_plain_data_equals_pil(case, tmp_path):
    """Plain data: a comment is cut out with its line end (the tokens on its
    sides join); P1's bits need no separators."""
    if case == "comments":
        data = b"P2\n3 2\n300\n1 2# x\n3 4 #y\r 5\n#z\n6 7"
    elif case == "no_separators":
        data = b"P1 4 3 0110\n1#c\n001 1110"
    else:
        data = pnm_bytes(b"P3", _samples(4, 6, 3, 99, 4), 99, plain_sep=b"\n")
    assert_as_pil(data, tmp_path, "x.pnm")


@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.5, 2.5])
def test_pf_equals_pil(scale, tmp_path):
    """Floats truncated and clipped to 0..255, NaN 0, rows bottom-up."""
    v = np.random.RandomState(5).randn(6, 9) * 200 + 100
    v[0, :4] = [np.nan, np.inf, -np.inf, 254.999]
    assert_as_pil(pfm_bytes(v, scale), tmp_path, "x.pfm")


# ----------------------------------------------------------------------- TGA

def tga_bytes(body: bytes, w, h, imagetype, depth, flags=0x20, *, ident=b"", cmap=b"",
              first=0, entries=0, mapdepth=0, maptype=None) -> bytes:
    if maptype is None:
        maptype = 1 if cmap else 0
    return struct.pack("<BBBHHBHHHHBB", len(ident), maptype, imagetype, first, entries,
                       mapdepth, 0, 0, w, h, depth, flags) + ident + cmap + body


def tga_rle(rows: np.ndarray, bpp: int, span: bool = False) -> bytes:
    """RLE packets row by row: a run of 2 or more equal pixels, else a
    literal; ``span`` joins a row's last literal with the next row's first."""
    packets = []  # [is_run, pixels]
    for row in rows:
        px = [bytes(row[i: i + bpp]) for i in range(0, len(row), bpp)]
        first = True
        i = 0
        while i < len(px):
            j = i
            while j + 1 < len(px) and px[j + 1] == px[i] and j - i < 127:
                j += 1
            if j > i:
                packets.append([True, px[i: j + 1]])
            elif (packets and not packets[-1][0] and len(packets[-1][1]) < 128
                  and (span or not first)):
                packets[-1][1].append(px[i])
            else:
                packets.append([False, [px[i]]])
            first = False
            i = j + 1
    out = b""
    for run, px in packets:
        out += bytes([(0x80 if run else 0) | (len(px) - 1)]) + (px[0] if run else b"".join(px))
    return out


def _tga_rows(h, w, depth, seed) -> np.ndarray:
    """(h, bytes per row) in file order, with runs for RLE."""
    rng = np.random.RandomState(seed)
    if depth == 1:
        return np.packbits(rng.rand(h, w) < 0.5, axis=1)
    bpp = depth // 8
    colours = rng.randint(0, 256, (5, bpp))
    idx = np.repeat(rng.randint(0, 5, (h, (w + 2) // 3)), 3, axis=1)[:, :w]
    idx[rng.rand(h, w) < 0.3] = rng.randint(0, 5)
    return colours[idx].reshape(h, -1).astype(np.uint8)


TGA_KINDS = [(1, 8), (2, 16), (2, 24), (2, 32), (3, 1), (3, 8), (3, 16)]


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("flags", [0x00, 0x10, 0x20, 0x30])
@pytest.mark.parametrize("kind,depth", TGA_KINDS)
def test_tga_types_depths_origins_equal_pil(kind, depth, flags, rle, tmp_path):
    """Every (type, depth) Pillow reads, each origin (bit 5 top-down, bit 4
    mirrored), raw and RLE (1-bit RLE Pillow refuses)."""
    h, w = 6, 9
    rows = _tga_rows(h, w, depth, kind * 100 + depth + flags)
    body = tga_rle(rows, depth // 8, span=flags & 0x10) if rle and depth > 1 else rows.tobytes()
    kw = {}
    if kind == 1:
        kw = dict(cmap=_palette(200, depth).astype(np.uint8)[:, ::-1].tobytes(), entries=200,
                  mapdepth=24)
    data = tga_bytes(body, w, h, kind | (8 if rle else 0), depth, flags | 8 * (depth == 32),
                     **kw)
    if rle and depth == 1:
        assert_refused(data, tmp_path, "x.tga", "1-bit TGA RLE")
        return
    assert_as_pil(data, tmp_path, "x.tga")


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("mapdepth,first,entries", [(24, 0, 256), (24, 7, 30), (16, 0, 16),
                                                    (16, 200, 56)])
def test_tga_colour_maps_equal_pil(mapdepth, first, entries, gray, tmp_path):
    """16-bit (5-5-5) and 24-bit maps from a first index; indices before it
    and past the map are black; a gray image with a map is looked up in it."""
    rng = np.random.RandomState(entries)
    cmap = rng.randint(0, 256, (entries, mapdepth // 8)).astype(np.uint8).tobytes()
    idx = rng.randint(0, 256, (5, 12)).astype(np.uint8)
    idx[0, :3] = [first, first + entries - 1, 255]
    data = tga_bytes(idx.tobytes(), 12, 5, 3 if gray else 1, 8, 0x20, cmap=cmap, first=first,
                     entries=entries, mapdepth=mapdepth)
    assert_as_pil(data, tmp_path, "x.tga")


def test_tga_16_bit_every_value_equals_pil(tmp_path):
    v = np.arange(65536, dtype="<u2").reshape(256, 256)
    assert_as_pil(tga_bytes(v.tobytes(), 256, 256, 2, 16, 0x21), tmp_path, "x.tga")


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
@pytest.mark.parametrize("rle", [False, True])
def test_tga_as_pillow_writes_equals_pil(mode, rle, tmp_path):
    """Pillow writes descriptor bits 0 (bottom-up rows), an ID field and a
    footer; an RGB(A) file starts \\0\\0\\2\\0, CUR's magic, and CUR's open
    passes it on (no cursors)."""
    img = Image.fromarray(scene(11, 14, seed=2)).convert(mode)
    data = save(img, "TGA", compression="tga_rle" if rle else None, id_section=b"id")
    if rle and mode == "1":  # Pillow writes 1-bit RLE but cannot read it back
        assert_refused(data, tmp_path, "x.tga", "1-bit TGA RLE")
        return
    assert_as_pil(data, tmp_path, "x.tga")
    assert_as_pil(save(img, "TGA", compression="tga_rle" if rle else None), tmp_path, "y.tga")


@pytest.mark.parametrize("ident,h,w", [(0, 4, 7), (10, 1, 1), (28, 4, 7), (255, 4, 7)])
def test_tga_id_fields_equal_pil(ident, h, w, tmp_path):
    """An ID field of any length; 10 and 28 start files that PCX and IPTC
    accept, whose opens pass them on (PCX where the file is under 68 bytes:
    a longer one it takes, see the refusals)."""
    rows = _tga_rows(h, w, 24, ident)
    data = tga_bytes(rows.tobytes(), w, h, 2, 24, 0x00, ident=bytes(range(ident)))
    assert_as_pil(data, tmp_path, "x.tga")


def test_tga_literal_runs_over_rows_equal_pil(tmp_path):
    """A literal packet may run on into the next rows (as far as three)."""
    flat = np.random.RandomState(3).randint(0, 256, 15 * 4 * 3).astype(np.uint8).tobytes()
    body = (bytes([40 - 1]) + flat[: 40 * 3] + bytes([0x80 | 3]) + flat[120: 123]
            + bytes([16 - 1]) + flat[132:])
    data = tga_bytes(body, 4, 15, 10, 24, 0x20)
    assert_as_pil(data, tmp_path, "x.tga")


# ------------------------------------------------------------ ICO, CUR, DIB

def icon_bytes(entries, kind: int = 1) -> bytes:
    """An ICO (kind 1) or CUR (kind 2): entries of (payload, width, height,
    bits per pixel, colour count); 256 is written as 0."""
    head = struct.pack("<HHH", 0, kind, len(entries))
    offset = 6 + 16 * len(entries)
    directory, body = b"", b""
    for payload, w, h, bpp, colours in entries:
        directory += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, 1, bpp,
                                 len(payload), offset + len(body))
        body += payload
    return head + directory + body


def dib_entry(h, w, bits, seed, mask=True) -> bytes:
    """A bitmap payload: the DIB of an (h, w) image of ``bits`` bits per
    pixel with its height doubled, then the AND mask."""
    rng = np.random.RandomState(seed)
    if bits <= 8:
        pal = _palette(1 << bits, seed)
        px = _indices(h, w, 1 << bits, seed)
    else:
        pal, px = None, rng.randint(0, 256, (h, w, bits // 8))
    dib = bytearray(bmp_bytes(px, bits, palette=pal)[14:])
    dib[8:12] = struct.pack("<i", 2 * h)
    stride = -(-w // 32) * 4
    and_mask = rng.randint(0, 256, (h, stride)).astype(np.uint8).tobytes() if mask else b""
    return bytes(dib) + and_mask


def png_entry(h, w, seed, mode="RGBA") -> bytes:
    rgba = np.concatenate([scene(h, w, seed=seed), np.full((h, w, 1), 200, np.uint8)], 2)
    return save(Image.fromarray(rgba, "RGBA").convert(mode), "PNG")


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("h,w", [(16, 16), (13, 7), (32, 48)])
def test_ico_bitmap_entries_equal_pil(bits, h, w, tmp_path):
    assert_as_pil(icon_bytes([(dib_entry(h, w, bits, bits + w), w, h, bits, 0)]), tmp_path,
                  "x.ico")


ICO_CHOICES = {
    "largest": [(8, 8, 8), (16, 16, 4), (12, 12, 32)],
    "depth_ties_smallest": [(16, 16, 32), (16, 16, 4), (16, 16, 8)],
    "same_area_other_shape": [(8, 32, 24), (16, 16, 8), (32, 8, 4)],
    "colour_count_depth": [(16, 16, 0, 16), (16, 16, 8)],
    "png_largest": [(16, 16, "png"), (32, 32, "png"), (24, 24, 32)],
    "bmp_over_png": [(16, 16, "png"), (32, 32, 24)],
    "size_256": [(16, 16, 8), (256, 256, "png")],
}


@pytest.mark.parametrize("case", sorted(ICO_CHOICES))
def test_ico_entry_choice_equals_pil(case, tmp_path):
    """The entry of the largest area, the smallest colour depth among equals;
    a bpp of 0 takes the colour count's bits."""
    entries = []
    for k, (h, w, bits, *count) in enumerate(ICO_CHOICES[case]):
        if bits == "png":
            entries.append((png_entry(h, w, k), w, h, 32, 0))
        else:
            payload = dib_entry(h, w, bits or 4, k)
            entries.append((payload, w, h, bits, count[0] if count else 0))
    assert_as_pil(icon_bytes(entries), tmp_path, "x.ico")


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "P", "L", "LA", "1"])
def test_ico_as_pillow_writes_equals_pil(mode, tmp_path):
    """Pillow's ICO of PNG entries (16, 32 and 64: the 64 opens), and of
    bitmap entries (its bitmap depth per mode, an AND mask below 32 bits)."""
    img = Image.fromarray(scene(64, 64, seed=4)).convert(mode)
    got = assert_as_pil(save(img, "ICO", sizes=[(16, 16), (32, 32), (64, 64)]), tmp_path,
                        "x.ico")
    assert got.shape == (64, 64, 3)
    if mode in ("RGBA", "RGB", "P", "L", "1"):
        small = img.resize((32, 32))
        got = assert_as_pil(save(small, "ICO", sizes=[(16, 16), (32, 32)], bitmap_format="bmp"),
                            tmp_path, "y.ico")
        assert got.shape == (32, 32, 3)


@pytest.mark.parametrize("bits", [1, 8, 24, 32])
def test_cur_equals_pil(bits, tmp_path):
    """The first cursor, or a later one both wider and taller; an entry's
    offset of 0 reads the bitmap right after the directory."""
    small, big = dib_entry(16, 16, bits, 1), dib_entry(32, 32, bits, 2)
    assert_as_pil(icon_bytes([(small, 16, 16, 0, 0), (big, 32, 32, 0, 0)], 2), tmp_path,
                  "x.cur")
    taller = dib_entry(16, 40, bits, 3)
    assert_as_pil(icon_bytes([(small, 16, 16, 0, 0), (taller, 40, 16, 0, 0)], 2), tmp_path,
                  "y.cur")
    zero = bytearray(icon_bytes([(small, 16, 16, 0, 0)], 2))
    zero[18:22] = bytes(4)
    assert_as_pil(bytes(zero), tmp_path, "z.cur")


@pytest.mark.parametrize("mode", ["RGB", "P", "L", "1", "RGBA"])
def test_dib_equals_pil(mode, tmp_path):
    """A headerless bitmap (Pillow's DIB), found by its header size."""
    img = Image.fromarray(scene(13, 17, seed=6)).convert(mode)
    assert_as_pil(save(img, "DIB"), tmp_path, "x.dib")


# ----------------------------------------------------------------------- QOI

def qoi_ops(data: bytes, total: int) -> set:
    """The op kinds in a QOI stream."""
    pos, n, ops = 14, 0, set()
    while n < total:
        b = data[pos]
        if b == 0xFE:
            ops.add("RGB")
            pos, n = pos + 4, n + 1
        elif b == 0xFF:
            ops.add("RGBA")
            pos, n = pos + 5, n + 1
        elif b >> 6 == 3:
            ops.add("RUN")
            pos, n = pos + 1, n + (b & 63) + 1
        else:
            ops.add(("INDEX", "DIFF", "LUMA")[b >> 6])
            pos, n = pos + (2 if b >> 6 == 2 else 1), n + 1
    return ops


def qoi_image(h, w, seed, alpha: bool) -> np.ndarray:
    """Runs, small and larger steps, colours that come back (index hits)
    and alpha changes."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (8, 4))
    idx = np.repeat(rng.randint(0, 8, (h, (w + 3) // 4)), 4, axis=1)[:, :w]
    px = base[idx].copy()
    step = rng.choice([0, 0, 1, -1, 2, -2, 9, -13, 40], (h, w, 3))
    px[..., :3] = (px[..., :3] + np.cumsum(step, axis=1)) % 256
    px[rng.rand(h, w) < 0.2] = base[rng.randint(0, 8)]
    if not alpha:
        px[..., 3] = 255
    return px.astype(np.uint8)


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("h,w,seed", [(1, 1, 0), (9, 13, 1), (32, 40, 2), (64, 3, 3),
                                      (50, 70, 4)])
def test_qoi_equals_pil(h, w, seed, alpha, tmp_path):
    px = qoi_image(h, w, seed, alpha)
    img = Image.fromarray(px, "RGBA") if alpha else Image.fromarray(px[..., :3])
    data = save(img, "QOI")
    assert data[12] == (4 if alpha else 3)
    if h * w > 100:
        assert qoi_ops(data, h * w) >= {"RGB", "INDEX", "DIFF", "LUMA", "RUN"} | (
            {"RGBA"} if alpha else set())
    assert_as_pil(data, tmp_path, "x.qoi")


def test_qoi_channels_byte_and_alpha_ops_equal_pil(tmp_path):
    """A count of 3 channels over a stream with RGBA ops (their alpha still
    hashes), and a count other than 3 or 4 (Pillow's RGBA)."""
    data = bytearray(save(Image.fromarray(qoi_image(20, 20, 5, True), "RGBA"), "QOI"))
    for channels in (3, 4, 7):
        data[12] = channels
        assert_as_pil(bytes(data), tmp_path, "x.qoi")


# ----------------------------------------------------------------------- SGI

def sgi_bytes(planes, bpc: int, rle: bool, dim=None, rows_per_op=None) -> bytes:
    """An SGI file of (channels, h, w) samples (``bpc`` 2: 16-bit), rows
    bottom-up; RLE rows as runs of 3 or more and copies, 0 at each end."""
    planes = np.asarray(planes)
    z, h, w = planes.shape
    dim = dim or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHHii4x80si404x", 474, int(rle), bpc, dim, w, h, z, 0,
                       (1 << 8 * bpc) - 1, b"fixture", 0)
    word = ">u2" if bpc == 2 else np.uint8
    rows = [planes[c, h - 1 - y] for c in range(z) for y in range(h)]
    if not rle:
        return head + b"".join(r.astype(word).tobytes() for r in rows)
    encoded = [_sgi_rle_row(r, bpc) for r in rows]
    offset, starts = 512 + 8 * len(rows), []
    for e in encoded:
        starts.append(offset)
        offset += len(e)
    return (head + struct.pack(f">{len(rows)}I", *starts)
            + struct.pack(f">{len(rows)}I", *map(len, encoded)) + b"".join(encoded))


def _sgi_rle_row(row, bpc: int) -> bytes:
    word = ">u2" if bpc == 2 else np.uint8
    out, i, n = b"", 0, len(row)

    def count(c):
        return np.asarray([c], word).tobytes()

    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 126:
            j += 1
        if j - i >= 2:
            out += count(j - i + 1) + np.asarray([row[i]], word).tobytes()
            i = j + 1
            continue
        k = i
        while k < n and k - i < 127 and not (k + 2 < n and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        out += count(0x80 | (k - i)) + np.asarray(row[i:k], word).tobytes()
        i = k
    return out + count(0)


def _sgi_planes(z, h, w, bpc, seed):
    rng = np.random.RandomState(seed)
    top = (1 << 8 * bpc) - 1
    px = rng.randint(0, top + 1, (z, h, w))
    px[:, :, 2:7] = px[:, :, 2:3]  # runs
    px[:, h // 2, :] = top
    return px


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("rle", [False, True])
def test_sgi_equals_pil(rle, bpc, channels, tmp_path):
    planes = _sgi_planes(channels, 9, 14, bpc, channels * 10 + bpc)
    assert_as_pil(sgi_bytes(planes, bpc, rle), tmp_path, "x.sgi")


@pytest.mark.parametrize("rle", [False, True])
def test_sgi_one_dimension_equals_pil(rle, tmp_path):
    assert_as_pil(sgi_bytes(_sgi_planes(1, 1, 30, 1, 7), 1, rle, dim=1), tmp_path, "x.bw")


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("bpc", [1, 2])
def test_sgi_as_pillow_writes_equals_pil(mode, bpc, tmp_path):
    img = Image.fromarray(scene(10, 15, seed=8)).convert(mode)
    assert_as_pil(save(img, "SGI", bpc=bpc), tmp_path, "x.sgi")


SGI_ROWS = {  # the second row's stream (w = 4, gray): what Pillow makes of it
    "row_short_keeps_the_row_before": bytes([0x02, 9, 0]),
    "last_op_not_the_end": bytes([0x02, 9, 0x82, 7, 8, 0]),
    "lengths_count_ops": bytes([0x02, 9, 0x82, 7, 8, 0]),
    "length_past_int_max_reads_no_op": bytes([0x02, 9, 0x82, 7, 8, 0]),
}


@pytest.mark.parametrize("case", sorted(SGI_ROWS))
def test_sgi_rle_row_rules_equal_pil(case, tmp_path):
    """A row's length counts ops: where its last op is not 0 the decoder
    stops and the rows not reached stay black; a row ending early keeps the
    samples of the row before past its end; a length of 2**31 or more (a
    negative C int) reads no op, so the row is the one before."""
    first, second = bytes([0x84, 1, 2, 3, 4, 0]), SGI_ROWS[case]
    lengths = {"last_op_not_the_end": [6, 2], "lengths_count_ops": [6, 3],
               "length_past_int_max_reads_no_op": [6, (1 << 31) + 6]}.get(
        case, [len(first), len(second)])
    head = struct.pack(">HBBHHHH", 474, 1, 1, 2, 4, 2, 1) + bytes(500)
    data = (head + struct.pack(">2I", 528, 528 + len(first)) + struct.pack(">2I", *lengths)
            + first + second)
    assert_as_pil(data, tmp_path, "x.sgi")


# ------------------------------------------------- Pillow's rules, one case each

def _table_cases():
    px16 = np.asarray([[0, 256, 1000, 65535]])
    ico_png = save(Image.fromarray(scene(64, 64, seed=1)).convert("RGBA"), "ICO",
                   sizes=[(16, 16), (32, 32), (64, 64)])
    ico_bmp = save(Image.fromarray(scene(32, 32, seed=1)).convert("RGBA"), "ICO",
                   sizes=[(16, 16), (32, 32)], bitmap_format="bmp")
    rgba = np.random.RandomState(2).randint(0, 256, (5, 6, 4)).astype(np.uint8)
    return {  # name → (bytes, Pillow's mode, first channel of the first row or None)
        "p5_maxval100": (pnm_bytes(b"P5", [[0, 50, 100, 99]], 100), "L", [0, 128, 255, 252]),
        "p2_maxval15": (pnm_bytes(b"P2", [[0, 7, 15, 3]], 15), "L", [0, 119, 255, 51]),
        "p1_bits": (pnm_bytes(b"P1", [[0, 1, 1, 0]]), "1", [255, 0, 0, 255]),
        "p5_16bit_maxval1000": (pnm_bytes(b"P5", [[0, 500, 1000, 999]], 1000), "I",
                                [0, 255, 255, 255]),
        "pf": (pfm_bytes([[0.5, 300.0]], -1.0), "F", [0, 255]),
        "tga_16bit_attribute": (tga_bytes(struct.pack("<2H", 0x7C00, 0x801F), 2, 1, 2, 16,
                                          0x21), "RGBA", [255, 0]),
        "tga_as_pillow_writes": (save(Image.fromarray(scene(3, 4, seed=3)), "TGA"), "RGB",
                                 None),
        "ico_png_16_32_64": (ico_png, "RGBA", None),
        "ico_bmp_16_32": (ico_bmp, "RGBA", None),
        "sgi_16bit_gray": (sgi_bytes(px16[None], 2, False), "L", [0, 1, 3, 255]),
        "qoi_rgba": (save(Image.fromarray(rgba, "RGBA"), "QOI"), "RGBA", None),
    }


TABLE = sorted(_table_cases())


@pytest.mark.parametrize("case", TABLE)
def test_table_of_pillow_rules(case, tmp_path):
    data, mode, first_row = _table_cases()[case]
    im = Image.open(io.BytesIO(data))
    assert im.mode == mode
    got = assert_as_pil(data, tmp_path, "x.img")
    if first_row is not None:
        assert got[0, :, 0].tolist() == first_row
    if case == "tga_as_pillow_writes":
        assert data[17] == 0 and data[:4] == b"\0\0\2\0"  # bottom-up, CUR's magic
    if case.startswith("ico_"):
        assert got.shape == ((64, 64, 3) if "64" in case else (32, 32, 3))
    if case == "qoi_rgba":
        np.testing.assert_array_equal(got, rgba_of(data)[..., :3])


def rgba_of(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


# ------------------------------------------------------------------ refusals

def _refusals():
    rows = _tga_rows(4, 6, 24, 1)
    run_over = tga_bytes(bytes([0x80 | 7, 1, 2, 3]), 6, 4, 10, 24)  # a run of 8 in rows of 6
    ico = icon_bytes([(dib_entry(16, 16, 8, 1), 16, 16, 8, 0)])
    qoi = save(Image.fromarray(qoi_image(8, 8, 1, False)), "QOI")
    sgi_rle = sgi_bytes(_sgi_planes(1, 4, 6, 1, 2), 1, True)
    return {
        "p7.pam": (b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n"
                   b"\0\1", "not an image the port reads"),
        "colour_floats.pfm": (b"PF\n1 1\n-1.0\n" + bytes(12), "not an image the port reads"),
        "magic_p0.pgm": (b"P0\n1 1\n255\n\0", "not a Netpbm"),
        "maxval0.pgm": (b"P5\n1 1\n0\n\0", "maxval 0"),
        "maxval65536.pgm": (b"P5\n1 1\n65536\n\0\0", "maxval 65536"),
        "p2_past_maxval.pgm": (b"P2\n2 1\n9\n3 10", "sample 10"),
        "p1_bad_token.pbm": (b"P1\n2 1\n01 2", "not 0 or 1"),
        "p6_truncated.ppm": (b"P6\n2 2\n255\n" + bytes(11), "truncated"),
        "p3_short.ppm": (b"P3\n1 2\n255\n1 2 3 4", "ends after"),
        "pf_scale0.pfm": (b"Pf\n1 1\n0\n" + bytes(4), "scale"),
        "token_too_long.pgm": (b"P5\n123456789012 1\n255\n", "too long"),
        "tga_15bit.tga": (tga_bytes(bytes(8), 2, 2, 2, 15), "cannot identify|not an image"),
        "tga_map15.tga": (tga_bytes(bytes(2), 2, 1, 1, 8, cmap=bytes(4), entries=2,
                                    mapdepth=15), "not an image"),
        "tga_map32.tga": (tga_bytes(bytes(2), 2, 1, 1, 8, cmap=bytes(8), entries=2,
                                    mapdepth=32), "colour-map depth 32"),
        "tga_map_257.tga": (tga_bytes(bytes(2), 2, 1, 1, 8, cmap=bytes(3 * 257), entries=257,
                                      mapdepth=24), "257 entries"),
        "tga_rgb_with_map.tga": (tga_bytes(rows.tobytes(), 6, 4, 2, 24, cmap=bytes(6),
                                           entries=2, mapdepth=24), "colour map beside"),
        "tga_mapped_without_map.tga": (tga_bytes(bytes(12), 6, 2, 1, 8, ident=b"x"),
                                       "without a colour map"),
        "tga_gray24.tga": (tga_bytes(bytes(36), 6, 2, 3, 24), "depth 24"),
        "tga_run_over_row.tga": (run_over, "passes the end of row"),
        "tga_id10_as_pcx.tga": (tga_bytes(rows.tobytes(), 6, 4, 2, 24, ident=bytes(10)), "PCX"),
        "tga_truncated.tga": (tga_bytes(rows.tobytes()[:-5], 6, 4, 2, 24), "truncated"),
        "tga_rle_truncated.tga": (tga_bytes(tga_rle(rows, 3)[:-2], 6, 4, 10, 24), "ends"),
        "ico_mask_outside.ico": (ico[:-40], "AND mask"),
        "ico_png_bad_ihdr_crc.ico": (_bad_ihdr_crc(icon_bytes([(png_entry(16, 16, 1), 16, 16,
                                                                32, 0)])), "not an image"),
        "png_bad_ihdr_crc.png": (_bad_ihdr_crc(png_entry(5, 7, 2, "RGB")), "not an image"),
        "png_bad_adler.png": (_png_adler(png_entry(5, 7, 3, "RGB"), extra=0), "data check"),
        "ico_no_entries.ico": (b"\0\0\1\0\0\0" + bytes(30), "not an image"),
        "cur_bad_header.cur": (icon_bytes([(b"\x11" * 60, 16, 16, 0, 0)], 2),
                               "BMP header"),
        "qoi_truncated.qoi": (qoi[:-20], "QOI data ends"),
        "qoi_size0.qoi": (b"qoif" + bytes(8) + b"\3\0" + bytes(8), "not an image"),
        "sgi_dimension3_gray.sgi": (struct.pack(">HBBHHHH", 474, 0, 1, 3, 2, 2, 1) + bytes(504),
                                    "dimension 3, 1 channels"),
        "sgi_storage2.sgi": (struct.pack(">HBBHHHH", 474, 2, 1, 2, 2, 2, 1) + bytes(504),
                             "storage 2"),
        "sgi_rle_overrun.sgi": (sgi_rle[:-3], "overruns"),
        "sgi_truncated.sgi": (sgi_bytes(_sgi_planes(3, 4, 6, 2, 3), 2, False)[:-1],
                              "truncated"),
    }


def _bad_ihdr_crc(data: bytes) -> bytes:
    """The first IHDR's CRC flipped (Pillow checks the chunks before IDAT)."""
    at = data.index(b"IHDR") + 4 + 13
    return data[:at] + bytes([data[at] ^ 0xFF]) + data[at + 1:]


def _png_adler(png: bytes, extra: int) -> bytes:
    """``png`` (one IDAT) with its rows deflated again, ``extra`` zero bytes
    after them in the stream, and the stream's Adler-32 wrong."""
    start = png.index(b"IDAT") + 4
    length = struct.unpack(">I", png[start - 8: start - 4])[0]
    stream = zlib.compress(zlib.decompress(png[start: start + length]) + bytes(extra))
    stream = stream[:-4] + bytes(b ^ 0x5A for b in stream[-4:])
    chunk = struct.pack(">I", len(stream)) + b"IDAT" + stream
    chunk += struct.pack(">I", zlib.crc32(b"IDAT" + stream))
    return png[: start - 8] + chunk + png[start + length + 4:]


@pytest.mark.parametrize("extra", [1, 100])
def test_png_adler_is_read_only_where_the_stream_ends_with_the_image(extra, tmp_path):
    """Pillow inflates row by row and stops at the image's last byte: a
    stream longer than the image never reaches its (wrong) Adler-32."""
    for data in (_png_adler(png_entry(5, 7, 3, "RGB"), extra),
                 icon_bytes([(_png_adler(png_entry(16, 16, 4), extra), 16, 16, 32, 0)])):
        assert_as_pil(data, tmp_path, "x.img")


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("name", REFUSALS)
def test_what_pillow_refuses_raises_naming_the_file(name, tmp_path):
    data, match = _refusals()[name]
    assert_refused(data, tmp_path, name, match)


NOT_YET = {
    "p0cmyk.ppm": b"P0CMYK\n2 1\n255\n" + bytes([0, 0, 0, 0, 100, 50, 0, 30]),
    "pyp.ppm": b"PyP\n2 1\n255\n\0\5",
    "pyrgba.ppm": b"PyRGBA\n2 1\n255\n" + bytes(range(8)),
    "pycmyk.ppm": b"PyCMYK\n1 1\n255\n" + bytes(4),
}


@pytest.mark.parametrize("name", sorted(NOT_YET))
def test_netpbm_kinds_left_to_port_raise_naming_the_magic(name, tmp_path):
    """Pillow's own test-only Netpbm modes: Pillow reads them, the port
    raises naming the file and the magic (the other families hold no kind
    Pillow reads that the port does not)."""
    data = NOT_YET[name]
    assert not pil_refuses(data)
    (tmp_path / name).write_bytes(data)
    magic = data.split(b"\n")[0].decode()
    with pytest.raises(ValueError, match=f"{name}.*magic {magic}"):
        I.read_image(tmp_path / name)


# ------------------------------------------------------------------ fixtures

def raster_fixture_bytes():
    """name → bytes of the committed Netpbm, TGA, ICO/CUR/DIB, QOI and SGI
    fixtures (each at most 64x48), the PCX/DCX, Sun, XBM, XPM and PSD ones
    of ``test_torch_image_rasters2.py``, the IM, MSP, SPIDER, BLP and ICNS
    ones of ``test_torch_image_rasters3.py`` and the FITS, FTEX, GBR, IMT,
    McIdas, PIXAR and XV thumbnail ones of ``test_torch_image_rasters4.py``."""
    from test_torch_image_rasters2 import raster2_fixture_bytes
    from test_torch_image_rasters3 import raster3_fixture_bytes
    from test_torch_image_rasters4 import raster4_fixture_bytes

    img = Image.fromarray(scene(37, 45, seed=40))
    small = Image.fromarray(scene(19, 21, seed=41))
    bits = scene(37, 45, seed=42)[..., 0] > 128
    gray = scene(21, 19, c=1, seed=43)[..., 0]
    pal_rows = _indices(24, 30, 40, 44).astype(np.uint8)
    cmap16 = np.random.RandomState(45).randint(0, 1 << 15, 40).astype("<u2").tobytes()
    rgb16 = np.random.RandomState(46).randint(0, 1 << 16, (20, 33)).astype("<u2")
    ico_entries = [(dib_entry(16, 16, 4, 47), 16, 16, 4, 16), (dib_entry(32, 32, 4, 48), 32, 32,
                                                               4, 16),
                   (dib_entry(32, 32, 8, 49), 32, 32, 8, 0)]
    rgba = qoi_image(40, 48, 50, True)
    return {
        "netpbm_p1.pbm": pnm_bytes(b"P1", bits[:20, :30], header=b"\n# plain bits\n30 20\n"),
        "netpbm_p4.pbm": save(Image.fromarray(bits), "PPM"),
        "netpbm_p2.pgm": pnm_bytes(b"P2", np.asarray(gray) * 15 // 255, 15),
        "netpbm_p5.pgm": save(img.convert("L"), "PPM"),
        "netpbm_p5_maxval1000.pgm": pnm_bytes(b"P5", np.asarray(img.convert("L")).astype(
            np.int64) * 4, 1000),
        "netpbm_p3.ppm": pnm_bytes(b"P3", np.asarray(small) * 100 // 255, 100),
        "netpbm_p6.ppm": save(img, "PPM"),
        "netpbm_p6_16bit.ppm": pnm_bytes(b"P6", np.asarray(img).astype(np.int64) * 257, 65535),
        "netpbm_pf.pfm": pfm_bytes(np.asarray(img.convert("L"), np.float32) * 1.3 - 20, -1.0),
        "tga_rgb.tga": save(img, "TGA"),
        "tga_rgba_rle.tga": save(img.convert("RGBA"), "TGA", compression="tga_rle"),
        "tga_gray_rle.tga": save(img.convert("L"), "TGA", compression="tga_rle"),
        "tga_palette.tga": save(img.convert("P"), "TGA"),
        "tga_bilevel.tga": save(Image.fromarray(bits), "TGA"),
        "tga_palette16_rle.tga": tga_bytes(tga_rle(pal_rows + 3, 1, span=True), 30, 24, 9, 8,
                                           0x20, cmap=cmap16, first=3, entries=40, mapdepth=16),
        "tga_16bit_id_mirrored.tga": tga_bytes(rgb16.tobytes(), 33, 20, 2, 16, 0x10,
                                               ident=b"mm_s2ut fixture"),
        "ico_png.ico": save(img.convert("RGBA").resize((48, 48)), "ICO",
                            sizes=[(16, 16), (32, 32), (48, 48)]),
        "ico_bmp32.ico": save(img.convert("RGBA").resize((32, 32)), "ICO",
                              sizes=[(16, 16), (32, 32)], bitmap_format="bmp"),
        "ico_bmp4_bmp8.ico": icon_bytes(ico_entries),
        "cur_bmp24.cur": icon_bytes([(dib_entry(16, 16, 24, 51), 16, 16, 0, 0),
                                     (dib_entry(32, 24, 24, 52), 24, 32, 0, 0)], 2),
        "dib_rgb.dib": save(small, "DIB"),
        "qoi_rgb.qoi": save(img, "QOI"),
        "qoi_rgba.qoi": save(Image.fromarray(rgba, "RGBA"), "QOI"),
        "sgi_rgb.sgi": save(img, "SGI"),
        "sgi_gray16.sgi": sgi_bytes(_sgi_planes(1, 24, 30, 2, 53), 2, False),
        "sgi_rgba_rle.sgi": sgi_bytes(np.moveaxis(rgba, 2, 0), 1, True),
        "sgi_rgb16_rle.sgi": sgi_bytes(_sgi_planes(3, 20, 24, 2, 54), 2, True),
        **raster2_fixture_bytes(),
        **raster3_fixture_bytes(),
        **raster4_fixture_bytes(),
    }


RASTER_SUFFIXES = (".pbm", ".pgm", ".ppm", ".pfm", ".tga", ".ico", ".cur", ".dib", ".qoi", ".sgi")
RASTER_FIXTURES = sorted(p.name for p in FORMATS.iterdir() if p.suffix in RASTER_SUFFIXES)


def _pillow(data: bytes):
    """(format, RGB pixels), None where Pillow raises, "big" for an image
    of over 4M pixels (not decoded here)."""
    try:
        im = Image.open(io.BytesIO(data))
        if im.size[0] * im.size[1] > 1 << 22:
            return "big"
        return im.format, np.asarray(im.convert("RGB"))
    except Exception:
        return None


@pytest.mark.parametrize("name", RASTER_FIXTURES)
def test_mutated_fixtures_equal_pil_or_are_refused(name):
    """40 mutations of each fixture (a cut, 1-3 bytes of the first 64, 1-4
    anywhere): where Pillow reads one, the port gives its format and pixels;
    where Pillow raises, the port raises ``ValueError``."""
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
        want = _pillow(b)
        if want == "big":
            continue
        try:
            got = I.decode_image(b, name)
        except ValueError:
            got = None
        if want is None:
            assert got is None, (name, k, got[0])
        else:
            assert got is not None and got[0] == want[0], (name, k)
            np.testing.assert_array_equal(got[1], want[1], err_msg=f"{name} mutation {k}")
