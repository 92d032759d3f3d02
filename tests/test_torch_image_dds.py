"""DDS textures without Pillow: ``data/image_io.decode_image`` against
``Image.open(path)``: the container it picks is Pillow's ``DDS`` and the
pixels equal ``np.asarray(Image.open(path).convert("RGB"))``, max
|difference| 0 (``data/dds.py``).

* What Pillow writes (DXT1, DXT3, DXT5, BC2, BC3 and BC5 through its BCn
  encoder; L, LA, RGB and RGBA uncompressed), at 1x1, at sizes that are not
  a multiple of 4 and at whole blocks.
* What Pillow reads and does not write, built here: BC4 under ATI1, BC4U
  and DX10; BC5S; BC6H and BC6HS from constructed blocks of every mode
  whose endpoints lie in [1/8, 1] (BC6HS with negative ones too), so that
  the half float → 8-bit rounding is pinned rather than saturated; BC7 with
  one block of each mode and an invalid one (first byte 0); the bit-mask
  layouts R5G6B5, A1R5G5B5, A4R4G4B4, X8R8G8B8 and 24-bit BGR, odd masks
  and bit counts, a file cut short (Pillow's decoder reads zeros past the
  end); 8-bit palettes; DX10 R8G8B8A8.
* Random block payloads of every FourCC and DXGI code Pillow reads, many
  seeds each, against Pillow live.
* Every header Pillow refuses raises ``ValueError`` naming the file and
  the format; 40 mutations of each committed fixture are read as Pillow
  reads them or refused where it refuses.

:func:`dds_fixture_bytes` gives the committed fixtures under
``tests/torch_images/formats/``, written anew with the other formats by
``PYTHONPATH=. python tests/test_torch_image_formats.py``.
"""
import functools
import random
import struct

import numpy as np
import pytest
from PIL import Image

from mm_s2ut_torch.data import dds as dds_mod
from mm_s2ut_torch.data import image_io as I
from test_torch_image_formats import FORMATS, save, scene

RGB, ALPHAPIXELS, FOURCC, PALETTE, LUMINANCE = 0x40, 0x1, 0x4, 0x20, 0x20000


def cc(code: bytes) -> int:
    return struct.unpack("<I", code)[0]


def dds_bytes(w, h, pfflags, *, fourcc=b"\0\0\0\0", bitcount=0, masks=(0, 0, 0, 0),
              body=b"", dxgi=None, header_size=124) -> bytes:
    """A DDS file: magic, the 124-byte header, DX10's 20 bytes where
    ``dxgi`` is given, then ``body``."""
    head = struct.pack("<7I", header_size, 0x1007, h, w, 0, 0, 0) + bytes(44)
    head += struct.pack("<4I", 32, pfflags, cc(fourcc), bitcount) + struct.pack("<4I", *masks)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    out = b"DDS " + head
    if dxgi is not None:
        out += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return out + bytes(body)


def pillow(data: bytes, path):
    """(format, RGB pixels) of ``Image.open(path)``, or None where Pillow
    raises."""
    path.write_bytes(data)
    try:
        with Image.open(path) as im:
            return im.format, np.asarray(im.convert("RGB"))
    except Exception:
        return None


def assert_as_pil(data: bytes, tmp_path, name: str = "x.dds") -> np.ndarray:
    want = pillow(data, tmp_path / name)
    assert want is not None, "Pillow refuses it"
    fmt, got = I.decode_image(data, name)
    assert fmt == want[0] == "DDS"
    assert got.shape == want[1].shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want[1])
    np.testing.assert_array_equal(I.read_image(tmp_path / name), want[1])
    return got


def blocks(w: int, h: int) -> int:
    return -(-w // 4) * -(-h // 4)


# ------------------------------------------------------------- BC6H and BC7

def _pack(fields) -> bytes:
    """[(value, bits)] → a 16-byte block, the first field at bit 0."""
    acc, at = 0, 0
    for value, n in fields:
        n = int(n)
        acc |= (int(value) & ((1 << n) - 1)) << at
        at += n
    assert at == 128, at
    return acc.to_bytes(16, "little")


def _index_fields(ns, partition, idx, ib):
    subset = dds_mod._subsets(ns, np.array([partition]))
    widths = dds_mod._index_widths(ns, np.array([partition]), subset, ib)[0]
    return [(v & ((1 << w) - 1), w) for v, w in zip(idx, widths)]


def _bc6_code(mode: int):
    if mode < 2:
        return mode, 2
    return ((mode - 2) << 2 | 2, 5) if mode < 10 else ((mode - 10) << 2 | 3, 5)


@functools.lru_cache(maxsize=None)
def _bc6_limit(prec: int, signed: bool) -> int:
    """The largest endpoint code whose half float is at most 1.0."""
    x = np.arange(1 << (prec - 1 if signed else prec))
    u = dds_mod._bc6_unquantize(x, prec, signed)
    over = (u * 31 // 32 if signed else u * 31 // 64) > 0x3C00
    return int(np.argmax(over)) - 1 if over.any() else int(x[-1])


def bc6_block(mode: int, rng, signed: bool) -> bytes:
    """A block of BC6H ``mode`` whose endpoints lie in [1/8, 1] (signed: in
    [-1, -1/8] too), random partition and indices. The codes are a half
    float's bits, so the top quarter of those up to 1.0 spans 1/8 to 1."""
    ns, tr, pb, epb, *delta = dds_mod._BC6[mode]
    numep = 6 * ns
    top = _bc6_limit(epb, signed)
    low = top - top // 4

    def endpoint():
        x = int(rng.randint(low, top + 1))
        return -x if signed and rng.rand() < 0.5 else x

    ep = [endpoint() for _ in range(3)]
    for i in range(3, numep):
        if tr:  # the delta must fit its bits (two's complement), the sum the range
            half = 1 << (delta[i % 3] - 1)
            ep.append(int(np.clip(ep[i % 3] + rng.randint(-half, half), -top if signed else 0,
                                  top)))
        else:
            ep.append(endpoint())
    stored = [e if i < 3 or not tr else e - ep[i % 3] for i, e in enumerate(ep)] + [0] * 6
    code, nbits = _bc6_code(mode)
    fields = [(code, nbits)]
    fields += [((stored[value] >> bit) & 1, 1) for value, bit in dds_mod._BC6_LAYOUTS[mode]]
    fields.append((0, {0: 75, 1: 75}.get(mode, 72 if mode < 10 else 60)
                   - len(dds_mod._BC6_LAYOUTS[mode])))
    partition = int(rng.randint(0, 32)) if ns == 2 else 0
    fields.append((partition, pb))
    ib = 3 if ns == 2 else 4
    fields += _index_fields(ns, partition, rng.randint(0, 1 << ib, 16), ib)
    return _pack([f for f in fields if f[1]])


def bc6_texture(signed: bool, seed: int) -> bytes:
    """16x16: one block of each of the 14 modes, a reserved mode code, and
    mode 13 again."""
    rng = np.random.RandomState(seed)
    data = b"".join(bc6_block(m, rng, signed) for m in range(14))
    data += bytes([0b10011]) + rng.randint(0, 256, 15).astype(np.uint8).tobytes()
    return data + bc6_block(13, rng, signed)


def bc7_blocks(modes, rng) -> bytes:
    """Random BC7 blocks of the given modes (8: the invalid first byte 0)."""
    out = bytearray(rng.randint(0, 256, 16 * len(modes)).astype(np.uint8).tobytes())
    for i, m in enumerate(modes):
        out[16 * i] = 0 if m == 8 else ((out[16 * i] >> (m + 1)) << (m + 1)) | (1 << m)
    return bytes(out)


# --------------------------------------------------------------- fixtures

MASKS = {  # name → (bit count, masks R, G, B, A)
    "r5g6b5": (16, (0xF800, 0x07E0, 0x001F, 0)),
    "a1r5g5b5": (16, (0x7C00, 0x03E0, 0x001F, 0x8000)),
    "a4r4g4b4": (16, (0x0F00, 0x00F0, 0x000F, 0xF000)),
    "x8r8g8b8": (32, (0xFF0000, 0x00FF00, 0x0000FF, 0)),
    "bgr24": (24, (0xFF0000, 0x00FF00, 0x0000FF, 0)),
}


def mask_case(name, w, h, seed, cut=0) -> bytes:
    bits, masks = MASKS[name]
    rng = np.random.RandomState(seed)
    body = rng.randint(0, 256, w * h * bits // 8).astype(np.uint8).tobytes()
    flags = RGB | (ALPHAPIXELS if masks[3] else 0)
    return dds_bytes(w, h, flags, bitcount=bits, masks=masks, body=body[: len(body) - cut])


def dds_fixture_bytes():
    """name → bytes of the committed DDS fixtures (each at most 16x16)."""
    rgb = Image.fromarray(scene(10, 13, seed=70))
    rgba = Image.fromarray(scene(12, 16, c=4, seed=71), "RGBA")
    rng = np.random.RandomState(72)

    def rand(n):
        return rng.randint(0, 256, n).astype(np.uint8).tobytes()

    palette = rand(1024)
    return {
        "dds_dxt1.dds": save(rgb, "DDS", pixel_format="DXT1"),
        "dds_dxt3.dds": save(rgba, "DDS", pixel_format="DXT3"),
        "dds_dxt5.dds": save(rgba.crop((0, 0, 12, 12)), "DDS", pixel_format="DXT5"),
        "dds_bc2.dds": save(rgba.crop((0, 0, 8, 8)), "DDS", pixel_format="BC2"),
        "dds_bc3.dds": save(rgba.crop((0, 0, 9, 7)), "DDS", pixel_format="BC3"),
        "dds_bc5.dds": save(Image.fromarray(scene(16, 16, seed=73)), "DDS", pixel_format="BC5"),
        "dds_l_1x1.dds": save(rgb.convert("L").crop((0, 0, 1, 1)), "DDS"),
        "dds_la.dds": save(rgba.convert("LA").crop((0, 0, 11, 6)), "DDS"),
        "dds_rgb_1x1.dds": save(rgb.crop((3, 3, 4, 4)), "DDS"),
        "dds_rgba.dds": save(rgba.crop((0, 0, 10, 9)), "DDS"),
        "dds_bc4_ati1.dds": dds_bytes(8, 8, FOURCC, fourcc=b"ATI1", body=rand(4 * 8)),
        "dds_bc4u.dds": dds_bytes(6, 5, FOURCC, fourcc=b"BC4U", body=rand(4 * 8)),
        "dds_bc4_dx10.dds": dds_bytes(12, 8, FOURCC, fourcc=b"DX10", dxgi=80, body=rand(6 * 8)),
        "dds_bc5s.dds": dds_bytes(8, 8, FOURCC, fourcc=b"BC5S", body=rand(4 * 16)),
        "dds_bc6h.dds": dds_bytes(16, 16, FOURCC, fourcc=b"DX10", dxgi=95,
                                  body=bc6_texture(False, 74)),
        "dds_bc6hs.dds": dds_bytes(16, 16, FOURCC, fourcc=b"DX10", dxgi=96,
                                   body=bc6_texture(True, 75)),
        "dds_bc7.dds": dds_bytes(12, 12, FOURCC, fourcc=b"DX10", dxgi=98,
                                 body=bc7_blocks(range(9), rng)),
        **{f"dds_{k}.dds": mask_case(k, 9, 7, 76 + i) for i, k in enumerate(MASKS)},
        "dds_p8.dds": dds_bytes(10, 6, PALETTE, bitcount=8, body=palette + rand(60)),
        "dds_dx10_rgba.dds": dds_bytes(7, 5, FOURCC, fourcc=b"DX10", dxgi=28, body=rand(140)),
    }


DDS_FIXTURES = sorted(p.name for p in FORMATS.iterdir() if p.suffix == ".dds")


def test_fixtures_cover_every_layout():
    made = dds_fixture_bytes()
    assert sorted(made) == DDS_FIXTURES
    assert len(DDS_FIXTURES) == 24


@pytest.mark.parametrize("name", DDS_FIXTURES)
def test_dds_fixture_equals_pil_and_its_twin(name, tmp_path):
    data = (FORMATS / name).read_bytes()
    want = np.load(FORMATS / name.replace(".dds", ".npy"))
    got = assert_as_pil(data, tmp_path, name)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] <= 16 and got.shape[1] <= 16


# ----------------------------------------------------------- what Pillow writes

WRITES = {"DXT1": "RGB", "DXT3": "RGBA", "DXT5": "RGBA", "BC2": "RGBA", "BC3": "RGBA",
          "BC5": "RGB", "L": "L", "LA": "LA", "RGB": "RGB", "RGBA": "RGBA"}


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (16, 12), (30, 2)])
@pytest.mark.parametrize("kind", sorted(WRITES))
def test_what_pillow_writes_equals_pil(kind, size, tmp_path):
    w, h = size
    mode = WRITES[kind]
    img = Image.fromarray(scene(h, w, c=4, seed=w * h), "RGBA").convert(mode)
    kw = {} if kind == mode else {"pixel_format": kind}
    assert_as_pil(save(img, "DDS", **kw), tmp_path)


# ------------------------------------------------------- random BCn payloads

CODES = ([(f, None) for f in (b"DXT1", b"DXT3", b"DXT5", b"ATI1", b"BC4U", b"ATI2", b"BC5U",
                              b"BC5S")]
         + [(b"DX10", d) for d in (70, 71, 73, 74, 76, 77, 79, 80, 82, 83, 84, 95, 96, 97, 98,
                                   99)])


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("fourcc,dxgi", CODES, ids=[f"{f.decode()}-{d}" for f, d in CODES])
def test_random_payloads_equal_pil(fourcc, dxgi, seed, tmp_path):
    """Random blocks at random sizes (BC7: each mode, and the invalid first
    byte 0, in turn)."""
    rng = np.random.RandomState(seed * 100 + (dxgi or 0))
    w, h = rng.randint(1, 30, 2)
    n = dds_mod._DXGI[dxgi][1] if dxgi else dds_mod._FOURCCS[cc(fourcc)][1]
    count = blocks(w, h)
    if n == 7:
        body = bc7_blocks([(seed + i) % 9 for i in range(count)], rng)
    else:
        body = rng.randint(0, 256, count * dds_mod._BLOCK_BYTES[n]).astype(np.uint8).tobytes()
    assert_as_pil(dds_bytes(w, h, FOURCC, fourcc=fourcc, dxgi=dxgi, body=body), tmp_path)


@pytest.mark.parametrize("mode", range(9))
def test_bc7_each_mode_equals_pil(mode, tmp_path):
    """64 blocks of one mode (8: first byte 0, black)."""
    rng = np.random.RandomState(mode)
    got = assert_as_pil(dds_bytes(32, 32, FOURCC, fourcc=b"DX10", dxgi=98,
                                  body=bc7_blocks([mode] * 64, rng)), tmp_path)
    assert (got == 0).all() if mode == 8 else got.std() > 0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("signed", [False, True])
def test_bc6h_constructed_blocks_pin_the_rounding(signed, seed, tmp_path):
    """Every mode with endpoints in [1/8, 1] (signed: ±): most channel
    values lie strictly between 0 and 255, so the half → 8-bit rounding
    is what is held equal, not saturation."""
    body = bc6_texture(signed, seed)
    got = assert_as_pil(dds_bytes(16, 16, FOURCC, fourcc=b"DX10", dxgi=96 if signed else 95,
                                  body=body), tmp_path)
    inner = ((got > 0) & (got < 255)).mean()
    assert inner > (0.3 if signed else 0.85), inner
    assert (got[12:, 8:12] == 0).all()  # the reserved mode code


# ------------------------------------------------------------ uncompressed

@pytest.mark.parametrize("size", [(1, 1), (9, 7), (16, 3)])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_mask_layouts_equal_pil(name, size, tmp_path):
    assert_as_pil(mask_case(name, *size, seed=size[0]), tmp_path)


ODD_MASKS = {  # bit count, masks, alpha
    "r3g3b2": (8, (0xE0, 0x1C, 0x03, 0)),
    "zero_green": (16, (0xF800, 0, 0x001F, 0)),
    "non_contiguous": (16, (0x8421, 0x0A50, 0x0006, 0)),
    "r10g10b10a2": (32, (0x3FF00000, 0x000FFC00, 0x000003FF, 0xC0000000)),
    "wide_pixels_64": (64, (0xFF, 0xFF00, 0xFF0000, 0)),
    "bitcount_0": (0, (0xFF, 0xFF00, 0xFF0000, 0)),
    "bitcount_12": (12, (0xF00, 0x0F0, 0x00F, 0)),
    "top_bit": (32, (0x80000000, 0x40000000, 0x0000FFFF, 0)),
}


@pytest.mark.parametrize("name", sorted(ODD_MASKS))
def test_odd_masks_and_bit_counts_equal_pil(name, tmp_path):
    """Masks Pillow writes none of: 3:3:2, a zero mask (0), non-contiguous
    bits, 10-bit channels, 8-byte pixels, bit counts 0 and 12 (one byte a
    pixel), the top bit."""
    bits, masks = ODD_MASKS[name]
    rng = np.random.RandomState(len(name))
    body = rng.randint(0, 256, 8 * 6 * 8).astype(np.uint8).tobytes()
    assert_as_pil(dds_bytes(8, 6, RGB | (ALPHAPIXELS if masks[3] else 0), bitcount=bits,
                            masks=masks, body=body), tmp_path)


@pytest.mark.parametrize("cut", [1, 2, 7, 64, 126])
def test_a_short_mask_layout_reads_zeros_as_pillow(cut, tmp_path):
    """Pillow's DdsRgbDecoder reads past the end as zeros: no error."""
    got = assert_as_pil(mask_case("r5g6b5", 9, 7, 3, cut=cut), tmp_path)
    if cut >= 64:
        assert (got[-1, -1] == 0).all()


def test_the_mask_rule_truncates(tmp_path):
    """``int(v / max * 255)``: a 5-bit 1 is 8 (8.22...), 30 is 246 (246.77...)."""
    body = struct.pack("<2H", 1 << 11 | 1, 30 << 11 | 30)
    got = assert_as_pil(dds_bytes(2, 1, RGB, bitcount=16,
                                  masks=(0xF800, 0x07E0, 0x001F, 0), body=body), tmp_path)
    assert got[0, 0].tolist() == [8, 0, 8] and got[0, 1].tolist() == [246, 0, 246]


def test_bc1_three_colour_mode_gives_black_at_index_3(tmp_path):
    """c0 <= c1: index 2 the mean, index 3 transparent black, RGB 0."""
    block = struct.pack("<2HI", 0x001F, 0xF800, 0b11100100 * 0x01010101)
    got = assert_as_pil(dds_bytes(4, 4, FOURCC, fourcc=b"DXT1", body=block), tmp_path)
    assert got[0].tolist() == [[0, 0, 255], [255, 0, 0], [127, 0, 127], [0, 0, 0]]


def test_bc5_blue_is_0_and_bc5s_blue_is_128(tmp_path):
    rng = np.random.RandomState(5)
    body = rng.randint(0, 256, 16).astype(np.uint8).tobytes()
    u = assert_as_pil(dds_bytes(4, 4, FOURCC, fourcc=b"BC5U", body=body), tmp_path)
    s = assert_as_pil(dds_bytes(4, 4, FOURCC, fourcc=b"BC5S", body=body), tmp_path)
    flipped = bytearray(body)
    for i in (0, 1, 8, 9):
        flipped[i] ^= 0x80
    f = assert_as_pil(dds_bytes(4, 4, FOURCC, fourcc=b"BC5U", body=bytes(flipped)), tmp_path)
    assert (u[..., 2] == 0).all() and (s[..., 2] == 128).all()
    np.testing.assert_array_equal(s[..., :2], f[..., :2])


@pytest.mark.parametrize("kind", ["L", "LA", "P", "dx10_rgba", "dx10_rgba_srgb"])
def test_luminance_palette_and_dx10_rgba_equal_pil(kind, tmp_path):
    rng = np.random.RandomState(len(kind))

    def rand(n):
        return rng.randint(0, 256, n).astype(np.uint8).tobytes()

    w, h = 7, 5
    data = {"L": dds_bytes(w, h, LUMINANCE, bitcount=8, body=rand(35)),
            "LA": dds_bytes(w, h, LUMINANCE | ALPHAPIXELS, bitcount=16, body=rand(70)),
            "P": dds_bytes(w, h, PALETTE, bitcount=8, body=rand(1024 + 35)),
            "dx10_rgba": dds_bytes(w, h, FOURCC, fourcc=b"DX10", dxgi=27, body=rand(140)),
            "dx10_rgba_srgb": dds_bytes(w, h, FOURCC, fourcc=b"DX10", dxgi=29, body=rand(140)),
            }[kind]
    assert_as_pil(data, tmp_path)


def test_rgb_flag_comes_before_the_others(tmp_path):
    """``DDPF_RGB`` with ``FOURCC`` and ``LUMINANCE`` set: bit masks."""
    body = np.random.RandomState(1).randint(0, 256, 32).astype(np.uint8).tobytes()
    assert_as_pil(dds_bytes(4, 4, RGB | FOURCC | LUMINANCE, fourcc=b"DXT1", bitcount=16,
                            masks=(0xF800, 0x07E0, 0x001F, 0), body=body), tmp_path)


def test_extra_surfaces_after_the_first_are_ignored(tmp_path):
    """Mip levels or array slices after the top surface: not read."""
    rng = np.random.RandomState(2)
    body = rng.randint(0, 256, 4 * 8 + 8 + 8).astype(np.uint8).tobytes()
    assert_as_pil(dds_bytes(8, 8, FOURCC, fourcc=b"DXT1", body=body), tmp_path)


# ----------------------------------------------------------------- refusals

def _refusals():
    rgb16 = dict(bitcount=16, masks=(0xF800, 0x07E0, 0x001F, 0))
    return {
        "header_size_100.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DXT1", body=bytes(8),
                                          header_size=100), "header size 100"),
        "header_cut.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DXT1")[:90], "header of 82 bytes"),
        "luminance_16_no_alpha.dds": (dds_bytes(2, 2, LUMINANCE, bitcount=16, body=bytes(8)),
                                      "LUMINANCE at 16 bits"),
        "luminance_4.dds": (dds_bytes(2, 2, LUMINANCE, bitcount=4, body=bytes(8)),
                            "LUMINANCE at 4 bits"),
        "fourcc_dxt2.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DXT2", body=bytes(16)),
                            "FourCC b'DXT2'"),
        "fourcc_ati3.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"ATI3", body=bytes(16)),
                            "FourCC b'ATI3'"),
        "dxgi_bc1_srgb.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DX10", dxgi=72, body=bytes(8)),
                              "DXGI format 72"),
        "dxgi_bc4_snorm.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DX10", dxgi=81, body=bytes(8)),
                               "DXGI format 81"),
        "dxgi_bc6h_typeless.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DX10", dxgi=94,
                                             body=bytes(16)), "DXGI format 94"),
        "dxgi_r8g8b8a8_uint.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DX10", dxgi=30,
                                             body=bytes(64)), "DXGI format 30"),
        "flags_alpha_only.dds": (dds_bytes(4, 4, 0x2, body=bytes(64)), "flags 0x2"),
        "flags_none.dds": (dds_bytes(4, 4, 0, body=bytes(64)), "flags 0x0"),
        "bc1_short.dds": (dds_bytes(5, 4, FOURCC, fourcc=b"DXT1", body=bytes(15)),
                          "surface of 16 bytes"),
        "bc7_short.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DX10", dxgi=98, body=bytes(15)),
                          "surface of 16 bytes"),
        "l_short.dds": (dds_bytes(3, 2, LUMINANCE, bitcount=8, body=bytes(5)),
                        "surface of 6 bytes"),
        "palette_short.dds": (dds_bytes(3, 2, PALETTE, bitcount=8, body=bytes(1000)),
                              "surface of 6 bytes"),
        "rgba_short.dds": (dds_bytes(3, 2, FOURCC, fourcc=b"DX10", dxgi=28, body=bytes(23)),
                           "surface of 24 bytes"),
        "zero_width.dds": (dds_bytes(0, 4, FOURCC, fourcc=b"DXT1", body=bytes(8)),
                           "not an image the port reads"),
        "dx10_header_cut.dds": (dds_bytes(4, 4, FOURCC, fourcc=b"DX10")[:130],
                                "not an image the port reads"),
        "size_field_cut.dds": (b"DDS |\0", "not an image the port reads"),
    }


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("name", REFUSALS)
def test_what_pillow_refuses_raises_naming_the_file_and_format(name, tmp_path):
    data, match = _refusals()[name]
    assert pillow(data, tmp_path / name) is None, "Pillow decodes it: not a refusal"
    with pytest.raises(ValueError, match=f"{name}.*{match}"):
        I.read_image(tmp_path / name)


def test_the_bomb_check_comes_before_the_surface(tmp_path):
    data = dds_bytes(1 << 16, 1 << 16, FOURCC, fourcc=b"DXT1")
    assert pillow(data, tmp_path / "big.dds") is None
    with pytest.raises(ValueError, match="big.dds.*more pixels than Pillow opens"):
        I.read_image(tmp_path / "big.dds")


@pytest.mark.parametrize("name", DDS_FIXTURES)
def test_mutated_fixtures_equal_pil_or_are_refused(name, tmp_path):
    """40 mutations of each fixture (a cut, 1-3 bytes of the first 64, 1-4
    anywhere), opened from their path: where Pillow reads one, the port
    gives its format and pixels; where Pillow raises, the port raises
    ``ValueError``. Sizes over 64K pixels are skipped (Pillow's mask decoder
    is a Python loop)."""
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
                if im.size[0] * im.size[1] > 1 << 16:
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
