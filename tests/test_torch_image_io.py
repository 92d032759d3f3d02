"""The port's image decoding and preprocessing against Pillow's pixels
(``mm_s2ut_torch/data/image_io.py``, ``models/vit.preprocess_images``).

Every case is exact (max |difference| 0): baseline JPEG at 4:4:4, 4:2:2,
4:2:0 and grayscale, quality 50/75/95, sizes that are not multiples of 8
or 16, restart markers; PNG in its five colour modes (and palettes of
fewer bits), each of the five row filters; ``preprocess_images`` in its
three modes against JAX's (which resizes with PIL); the rollout overlay's
mask resize; ``write_png`` read back by PIL. Progressive JPEG and
interlaced PNG equal Pillow's pixels (``test_torch_image_formats.py``
holds every other format).

``tests/torch_images/`` holds four small JPEGs (one flickr30k-sized)
beside the PIL-decoded pixels of each (the card smoke run decodes them
without Pillow and holds them to these); ``PYTHONPATH=. python
tests/test_torch_image_io.py`` writes them anew with PIL."""
import io
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mm_s2ut_torch.data import image_io as I

FIXTURES = Path(__file__).resolve().parent / "torch_images"
# name: (height, width, PIL save options); gray when "gray" leads the name.
# The first is flickr30k-sized (500 x 375) and smooth, to stay near 12 KB.
FIXTURE_SPECS = {
    "flickr420_q50.jpg": (375, 500, dict(quality=50, subsampling=2)),
    "f444_q90.jpg": (33, 40, dict(quality=90, subsampling=0)),
    "gray_q50.jpg": (29, 37, dict(quality=50)),
    "rst422_q80.jpg": (50, 70, dict(quality=80, subsampling=1, restart_marker_blocks=3)),
}


def scene(h: int, w: int, seed: int = 0, period=(7.0, 5.0), noise: float = 20.0) -> np.ndarray:
    """A smooth colour pattern with noise: (h, w, 3) uint8."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / period[0] + c) * np.cos(y / period[1] - c)
                    for c in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * noise, 0, 255).astype(np.uint8)


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def make_fixtures(out_dir: Path = FIXTURES) -> None:
    """Write the fixture JPEGs with PIL, each beside its decoded pixels."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, (name, (h, w, kw)) in enumerate(sorted(FIXTURE_SPECS.items())):
        smooth = dict(period=(23.0, 17.0), noise=3.0) if name.startswith("flickr") else {}
        img = Image.fromarray(scene(h, w, seed=10 + i, **smooth))
        if name.startswith("gray"):
            img = img.convert("L")
        data = _save(img, "JPEG", **kw)
        (out_dir / name).write_bytes(data)
        np.save(out_dir / (name[:-4] + ".npy"), _pil_rgb(data))


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
@pytest.mark.parametrize("h,w", [(37, 53), (17, 9), (40, 64)])
def test_jpeg_equals_pil(sampling, quality, h, w):
    img = Image.fromarray(scene(h, w, seed=quality))
    if sampling == "gray":
        data = _save(img.convert("L"), "JPEG", quality=quality)
    else:
        sub = {"444": 0, "422": 1, "420": 2}[sampling]
        data = _save(img, "JPEG", quality=quality, subsampling=sub)
    np.testing.assert_array_equal(I.decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("opts", [dict(restart_marker_rows=1), dict(restart_marker_blocks=3)])
def test_jpeg_restart_markers_equal_pil(opts):
    data = _save(Image.fromarray(scene(50, 70, seed=3)), "JPEG", quality=80, **opts)
    assert b"\xff\xd0" in data
    np.testing.assert_array_equal(I.decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P4"])
def test_png_modes_equal_pil(mode, tmp_path):
    img = Image.fromarray(scene(37, 53, seed=4))
    if mode.startswith("P"):
        img = img.quantize(16 if mode == "P4" else 60)
    else:
        img = img.convert(mode)
    img.save(tmp_path / "x.png", bits=4) if mode == "P4" else img.save(tmp_path / "x.png")
    np.testing.assert_array_equal(I.read_image(tmp_path / "x.png"),
                                  np.asarray(Image.open(tmp_path / "x.png").convert("RGB")))


def _png_with_filters(px: np.ndarray, filters) -> bytes:
    """An RGB PNG whose row y is stored with filter filters[y % 5]."""
    h, w, c = px.shape
    out, prev = [], np.zeros(w * c, np.int64)
    for y in range(h):
        cur = px[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        f = filters[y % len(filters)]
        if f == 0:
            row = cur
        elif f == 1:
            row = cur - left
        elif f == 2:
            row = cur - prev
        elif f == 3:
            row = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            row = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + (row % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def test_png_filters_equal_pil():
    px = scene(11, 13, seed=5)
    data = _png_with_filters(px, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(_pil_rgb(data), px)
    np.testing.assert_array_equal(I.decode_png(data), px)


def test_write_png_reads_back_in_pil(tmp_path):
    px = scene(19, 23, seed=6)
    I.write_png(tmp_path / "rgb.png", px)
    I.write_png(tmp_path / "gray.png", px[..., 1])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "rgb.png")), px)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "gray.png")), px[..., 1])
    np.testing.assert_array_equal(I.read_image(tmp_path / "gray.png"),
                                  np.repeat(px[..., 1:2], 3, axis=2))


def test_read_image_npy(tmp_path):
    px = scene(7, 9, seed=7)
    np.save(tmp_path / "rgb.npy", px)
    np.save(tmp_path / "gray.npy", px[..., 0])
    np.testing.assert_array_equal(I.read_image(tmp_path / "rgb.npy"), px)
    assert I.read_image(tmp_path / "gray.npy").shape == (7, 9, 3)
    np.save(tmp_path / "feats.npy", px.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        I.read_image(tmp_path / "feats.npy")


def test_progressive_jpeg_and_interlaced_png_raise(tmp_path):
    """Once refused, now decoded: a progressive JPEG and an Adam7 PNG, both
    written by Pillow, equal Pillow's pixels (the kept name is this test's
    history; ``tests/test_torch_image_formats.py`` covers the formats)."""
    data = _save(Image.fromarray(scene(20, 20)), "JPEG", progressive=True)
    (tmp_path / "prog.jpg").write_bytes(data)
    np.testing.assert_array_equal(I.read_image(tmp_path / "prog.jpg"), _pil_rgb(data))
    px = scene(20, 20)
    # An Adam7 image of the same pixels: Pillow writes none, so the passes
    # are filtered here (filter 0) and packed.
    passes = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
              (1, 0, 2, 1)]
    raw = b"".join(bytes([0]) + row.tobytes() for y0, x0, dy, dx in passes
                   for row in px[y0::dy, x0::dx] if row.size)
    ihdr = struct.pack(">IIBBBBB", 20, 20, 8, 2, 0, 0, 1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))
    (tmp_path / "adam7.png").write_bytes(data)
    np.testing.assert_array_equal(_pil_rgb(data), px)
    np.testing.assert_array_equal(I.read_image(tmp_path / "adam7.png"), px)


@pytest.mark.parametrize("mode", ["timm", "vit_openai", "vit_huggingface"])
@pytest.mark.parametrize("h,w,size", [(37, 53, 32), (375, 500, 384), (53, 37, 48)])
def test_preprocess_equals_jax_with_pil(mode, h, w, size):
    from mm_s2ut.models.vit import preprocess_images as j_preprocess
    from mm_s2ut_torch.models.vit import preprocess_images

    px = scene(h, w, seed=h)
    want = j_preprocess([Image.fromarray(px)], size, mode=mode)
    got = preprocess_images([px], size, mode=mode)
    assert got.dtype == np.float32 and got.shape == (1, size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(53, 37), (384, 384), (17, 90)])
def test_mask_upscale_equals_pil(size):
    """The rollout overlay's resize: a mode "L" mask, bicubic (PIL's
    default), to the image's size."""
    m = (np.random.RandomState(8).rand(24, 24) * 255).astype(np.uint8)
    np.testing.assert_array_equal(I.resize(m, size),
                                  np.asarray(Image.fromarray(m).resize(size)))


def test_fixtures_still_equal_pil():
    """The committed fixtures: PIL's pixels as committed, and the port's."""
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    assert names == sorted(FIXTURE_SPECS)
    for name in names:
        data = (FIXTURES / name).read_bytes()
        assert len(data) <= 13_000
        want = np.load(FIXTURES / (name[:-4] + ".npy"))
        np.testing.assert_array_equal(_pil_rgb(data), want)
        np.testing.assert_array_equal(I.read_image(FIXTURES / name), want)
    assert b"\xff\xd0" in (FIXTURES / "rst422_q80.jpg").read_bytes()


if __name__ == "__main__":
    make_fixtures(Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURES)
