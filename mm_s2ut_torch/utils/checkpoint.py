"""Parameter averaging over exported checkpoints.

Port of ``average_checkpoints`` from ``mm_s2ut/utils/checkpoint.py``,
over the port's model format: directories holding ``params.npz`` (flax
leaves joined by '/'). ``load_component``'s counterpart is
``train/trainer.load_pretrained_encoder``; orbax checkpoints are not read
by the port.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np


def average_checkpoints(ckpt_dirs: Sequence[str | Path]) -> Dict[str, np.ndarray]:
    """The leaf-wise mean of the ``params.npz`` of each directory, as
    flat {"a/b/leaf": array} (``np.savez`` writes it back). The
    checkpoints must hold the same leaves with the same shapes."""
    if not ckpt_dirs:
        raise ValueError("average_checkpoints: no checkpoint given")
    flats = []
    for d in ckpt_dirs:
        with np.load(Path(d) / "params.npz") as z:
            flats.append({k: z[k] for k in z.files})
    first = flats[0]
    for d, flat in zip(ckpt_dirs[1:], flats[1:]):
        diff = sorted(set(flat) ^ set(first))
        diff += sorted(k for k in set(flat) & set(first) if flat[k].shape != first[k].shape)
        if diff:
            raise ValueError(f"{d} does not hold {ckpt_dirs[0]}'s parameters: {diff[:10]}")
    n = np.float32(len(flats))
    return {k: sum(flat[k] for flat in flats) / n for k in first}
