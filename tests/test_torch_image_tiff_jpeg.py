"""JPEG-compressed TIFFs whose samples are not YCbCr, without Pillow:
``data/tiff.py`` takes each strip's JPEG components as stored, as
libtiff's JPEG codec hands them to Pillow (no colour conversion), then
converts them as for any other compression. Against
``np.asarray(Image.open(p).convert("RGB"))``, max |difference| 0.

* CMYK: libjpeg's samples as stored, not inverted as Pillow's JPEG plugin
  reads a CMYK JPEG file (``CMYK;I``).
* Gray with alpha (photometric 1, SamplesPerPixel 2, ExtraSamples 2): a
  2-component JPEG, which a stand-alone JPEG file may not be (Pillow
  refuses ``two.jpg`` in ``test_torch_image_formats.py``, and so does the
  port).
* RGBA (4 components, no Adobe marker), MinIsWhite gray (inverted as
  Pillow's ``L;I``), a palette, planar configuration 2: the same rule.
* CMYK with one or two extra samples: 5 or 6 components, which
  libjpeg-turbo cannot read (it looks for a scan's components among the
  first four only): refused by both.

Pillow writes the CMYK, gray + alpha and RGBA files; ``tiff_bytes`` with
the T.81 writer of ``test_torch_image_formats.py`` writes the rest.
"""
import io
import re

import numpy as np
import pytest
from PIL import Image

from mm_s2ut_torch.data import image_io as I
from test_torch_image_containers import tiff_bytes
from test_torch_image_formats import FORMATS, JpegWriter, pil_refuses, pil_rgb, save, scene


def assert_equals_pil(data: bytes, tmp_path, name: str = "x.tif") -> np.ndarray:
    want = pil_rgb(data)
    (tmp_path / name).write_bytes(data)
    got = I.read_image(tmp_path / name)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("name", ["tiff_jpeg_cmyk.tif", "tiff_jpeg_la.tif"])
def test_fixture_equals_pil_live_and_its_twin(name, tmp_path):
    data = (FORMATS / name).read_bytes()
    im = Image.open(io.BytesIO(data))
    assert im.tag_v2[259] == 7 and im.mode == {"tiff_jpeg_cmyk.tif": "CMYK",
                                                "tiff_jpeg_la.tif": "LA"}[name]
    got = assert_equals_pil(data, tmp_path, name)
    np.testing.assert_array_equal(got, np.load(FORMATS / name.replace(".tif", ".npy")))


def test_the_cmyk_fixture_is_not_whole_mcus():
    """21 x 30 pixels: neither side a multiple of the 8x8 MCU."""
    im = Image.open(FORMATS / "tiff_jpeg_cmyk.tif")
    assert im.size == (30, 21) and im.size[0] % 8 and im.size[1] % 8


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mode", ["CMYK", "LA", "RGBA"])
def test_random_pillow_written_jpeg_tiffs_equal_pil(mode, seed, tmp_path):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 40, 2)
    pixels = rng.randint(0, 256, (h, w, len(mode))).astype(np.uint8)
    data = save(Image.fromarray(pixels, mode), "TIFF", compression="jpeg")
    assert_equals_pil(data, tmp_path)


def _strip_jpeg(width: int, components: int, progressive: bool = False):
    """A ``tiff_bytes`` codec: each strip's samples as a JPEG of
    ``components`` 1x1 components (sequential Huffman, or progressive
    arithmetic with each component's scans of its own)."""
    comps = [(i + 1, 1, 1, min(i, 1)) for i in range(components)]

    def codec(raw: bytes) -> bytes:
        px = np.frombuffer(raw, np.uint8).reshape(-1, width, components)
        writer = JpegWriter([px[..., i] for i in range(components)], comps)
        if not progressive:
            return writer.huffman()
        return writer.arith_progressive([((i,), 0, 0, 0, 0) for i in range(components)]
                                        + [((i,), 1, 63, 0, 0) for i in range(components)])
    return codec


CASES = {  # name → (samples per pixel, photometric, tiff_bytes keywords)
    "miniswhite": (1, 0, {}),
    "palette": (1, 3, {"colormap": np.random.RandomState(3).randint(0, 65536, 768)}),
    "gray_alpha": (2, 1, {"extra": (2,)}),
    "rgba_premultiplied": (4, 2, {"extra": (1,)}),
    "cmyk_strips": (4, 5, {"rows_per_strip": 8}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_written_jpeg_tiffs_equal_pil(name, tmp_path):
    spp, photo, kw = CASES[name]
    rng = np.random.RandomState(len(name))
    px = rng.randint(0, 256, (19, 13, spp))
    assert_equals_pil(tiff_bytes(px, 8, photo, compression=7, codec=_strip_jpeg(13, spp), **kw),
                      tmp_path)


def test_planar_jpeg_tiff_equals_pil(tmp_path):
    """Planar configuration 2: a 1-component JPEG per plane."""
    px = scene(17, 22, seed=9)
    assert_equals_pil(tiff_bytes(px, 8, 2, compression=7, planar=2, codec=_strip_jpeg(22, 1)),
                      tmp_path)


@pytest.mark.parametrize("extra", [(0,), (0, 0)])
def test_cmyk_with_extra_samples_is_refused_as_pillow_refuses_it(extra, tmp_path):
    spp = 4 + len(extra)
    px = np.random.RandomState(spp).randint(0, 256, (13, 18, spp))
    data = tiff_bytes(px, 8, 5, compression=7, extra=extra,
                      codec=_strip_jpeg(18, spp, progressive=True))
    assert pil_refuses(data)
    (tmp_path / "x.tif").write_bytes(data)
    with pytest.raises(ValueError, match=re.escape(f"x.tif: a {spp}-component JPEG")):
        I.read_image(tmp_path / "x.tif")


def test_a_strip_of_another_component_count_is_refused(tmp_path):
    """libtiff's "Improper JPEG component count": RGB samples over a
    1-component JPEG."""
    px = scene(9, 12, seed=4)
    data = tiff_bytes(px, 8, 2, compression=7, codec=lambda r: save(
        Image.fromarray(np.frombuffer(r, np.uint8).reshape(9, 12, 3)[..., 0]), "JPEG"))
    assert pil_refuses(data)
    (tmp_path / "x.tif").write_bytes(data)
    with pytest.raises(ValueError, match="x.tif: a 1-component JPEG"):
        I.read_image(tmp_path / "x.tif")


def test_jpeg_files_keep_their_colour_conversion():
    """A JPEG file's CMYK (inverted, ``CMYK;I``) and YCCK, and a TIFF's
    YCbCr strips, are read as before: equal to their committed twins."""
    for name in ("cmyk_adobe.jpg", "ycck.jpg", "tiff_jpeg.tif"):
        np.testing.assert_array_equal(I.read_image(FORMATS / name),
                                      np.load(FORMATS / (name.rsplit(".", 1)[0] + ".npy")))
