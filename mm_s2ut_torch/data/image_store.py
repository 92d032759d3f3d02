"""Image sources of the dataset (numpy, torch for ``.pth`` blobs).

A copy of ``mm_s2ut/data/image_store.py``: ``ImageFeatureStore``, per-split
``{root}/{split}.(npy|npz|pth)`` features (N, T_img, D) with optional
``{split}_mask.*`` padding masks; ``RawImageStore``, the on-line path's
preprocessed pixels of the split's flickr30k images in caption order
(decoded by ``data/image_io.py``, no Pillow); the flickr30k split maps;
and ``audio_stem_to_image_index``, the reference's
``int(stem(audio_filename)) - 1``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from mm_s2ut_torch.data.image_io import read_image

SUFFIXES = (".npy", ".npz", ".pth", ".pt")
# Split name → flickr30k image directory / caption-order file list.
SPLIT_IMG_DIR = {
    "test2017": "test2017", "testcoco": "testcoco", "test2016": "flickr30k",
    "train": "flickr30k", "val": "flickr30k", "valid": "flickr30k",
    "test.2017": "test2017", "test.coco": "testcoco", "test.2016": "flickr30k",
}
SPLIT_TXT = {
    "test2017": "test_2017_flickr.txt", "testcoco": "test_2017_mscoco.txt",
    "test2016": "test_2016_flickr.txt", "train": "train.txt", "val": "val.txt",
    "valid": "val.txt", "test.2017": "test_2017_flickr.txt",
    "test.coco": "test_2017_mscoco.txt", "test.2016": "test_2016_flickr.txt",
}


def _load_blob(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        return np.load(path, mmap_mode="r")
    if path.suffix == ".npz":
        with np.load(path) as z:
            return z[list(z.keys())[0]]
    import torch

    return torch.load(path, map_location="cpu", weights_only=True).numpy()


def _find(root: Path, stem: str) -> Optional[Path]:
    return next((root / f"{stem}{ext}" for ext in SUFFIXES if (root / f"{stem}{ext}").exists()),
                None)


class ImageFeatureStore:
    """Per-split image features (N, T_img, D) + optional padding masks."""

    def __init__(self, feats: np.ndarray, masks: Optional[np.ndarray] = None):
        self.feats = feats
        self.masks = masks

    @classmethod
    def for_split(cls, feat_root: str | Path, split: str) -> "ImageFeatureStore":
        root = Path(feat_root)
        feat_path = _find(root, split)
        if feat_path is None:
            raise FileNotFoundError(f"no {split}.(npy|npz|pth) under {root}")
        mask_path = _find(root, f"{split}_mask")
        return cls(_load_blob(feat_path), _load_blob(mask_path) if mask_path else None)

    def __len__(self) -> int:
        return int(self.feats.shape[0])

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        mask = self.masks[idx] if self.masks is not None else None
        return np.asarray(self.feats[idx]), mask


class RawImageStore:
    """The split's raw images, preprocessed for the on-line extractor
    (``multimodal.load_visual_extractor_type``): item ``idx`` is
    ``(path, (S, S, 3) float32 pixels, None)``, the file read by
    ``image_io.read_image`` and shaped by ``models.vit.preprocess_images``
    in the extractor's mode."""

    def __init__(self, img_dir: str, img_path_list: List[str], mode: str = "vit_timm",
                 image_size: int = 224, mean: Optional[Tuple[float, ...]] = None,
                 std: Optional[Tuple[float, ...]] = None):
        self.img_dir = img_dir
        self.img_path_list = list(img_path_list)
        self.mode = mode
        self.image_size = image_size
        self.mean, self.std = mean, std

    @classmethod
    def for_split(cls, flickr30k_root: str | Path, split: str, mode: str = "vit_timm",
                  image_size: int = 224, mean=None, std=None) -> "RawImageStore":
        """Unknown split names fall back to the flickr30k image dir and a
        literal ``{split}.txt`` list."""
        img_dir = os.path.join(str(flickr30k_root),
                               SPLIT_IMG_DIR.get(split, "flickr30k") + "-images")
        txt = Path(flickr30k_root) / SPLIT_TXT.get(split, f"{split}.txt")
        if not txt.exists():
            raise FileNotFoundError(f"flickr30k caption list missing: {txt}")
        names = [line.strip() for line in txt.read_text().splitlines() if line.strip()]
        return cls(img_dir, names, mode, image_size, mean, std)

    def __len__(self) -> int:
        return len(self.img_path_list)

    def __getitem__(self, idx: int) -> Tuple[str, np.ndarray, None]:
        from mm_s2ut_torch.models.vit import preprocess_images

        path = os.path.join(self.img_dir, self.img_path_list[idx])
        pixels = preprocess_images([read_image(path)], self.image_size, mean=self.mean or None,
                                   std=self.std or None, mode=self.mode)[0]
        return path, pixels, None


def audio_stem_to_image_index(audio_path: str) -> int:
    """The reference's lookup: ``int(stem(audio_filename)) - 1`` into the
    flickr30k caption order."""
    return int(os.path.splitext(os.path.basename(audio_path))[0]) - 1
