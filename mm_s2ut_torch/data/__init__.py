"""Data on the host: images, audio, corpora, batches."""


class Unidentified(ValueError):
    """A file whose first bytes name a container that, read further, is not
    one: Pillow's plugin raises ``SyntaxError`` there and ``Image.open``
    tries the next plugin, the magic-less TGA last. ``read_image`` does the
    same; where no container takes the file, it raises ``ValueError``."""


# Pillow's Image.MAX_IMAGE_PIXELS: Image.open refuses an image of more than twice as many
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def check_pixels(width: int, height: int, name: str) -> None:
    """Pillow's decompression-bomb check, made as each container's header is read."""
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: {width}x{height} is more pixels than Pillow opens "
                         f"({MAX_PIXELS})")
