"""Precomputed image-feature store (numpy, torch for ``.pth`` blobs).

A copy of ``ImageFeatureStore`` and ``audio_stem_to_image_index`` from
``mm_s2ut/data/image_store.py``: per-split ``{root}/{split}.(npy|npz|pth)``
features (N, T_img, D) and optional ``{split}_mask.*`` padding masks,
looked up by the reference's ``int(stem(audio_filename)) - 1``. The
flickr30k file lists and the raw-image store are not carried over.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SUFFIXES = (".npy", ".npz", ".pth", ".pt")


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


def audio_stem_to_image_index(audio_path: str) -> int:
    """The reference's lookup: ``int(stem(audio_filename)) - 1`` into the
    flickr30k caption order."""
    return int(os.path.splitext(os.path.basename(audio_path))[0]) - 1
