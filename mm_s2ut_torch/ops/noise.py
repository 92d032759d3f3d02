"""Host-side noise helpers of the training data (numpy only).

A copy of ``tile_noise_to_length`` and ``select_noise`` from
``mm_s2ut/ops/noise.py``, which the dataset's per-utterance noise mixing
(``data/dataset.SpeechToSpeechDataset._maybe_add_noise``) calls with its
own ``np.random.RandomState``, so that the same seed and clips give the
reference's mixed waves bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def tile_noise_to_length(noise: np.ndarray, length: int, start: int = -1,
                         rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Repeat, then crop, a noise clip to exactly ``length`` samples (a
    random start when ``start`` < 0)."""
    if len(noise) < length:
        noise = np.tile(noise, int(np.ceil(length / len(noise))))
    if len(noise) > length:
        if start < 0:
            rng = rng or np.random
            start = int(rng.randint(0, len(noise) - length))
        noise = noise[start : start + length]
    return noise


def select_noise(noise_wavs: Sequence[np.ndarray], noise_num: int,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """``noise_num`` random clips; several are cut to the shortest and
    averaged, then floored (the reference's quirk)."""
    rng = rng or np.random
    idx = rng.randint(0, len(noise_wavs), size=noise_num)
    clips = [np.asarray(noise_wavs[int(i)], np.float32) for i in idx]
    if noise_num == 1:
        return clips[0]
    min_len = min(len(c) for c in clips)
    return np.floor(np.stack([c[:min_len] for c in clips]).mean(axis=0))
