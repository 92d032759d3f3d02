"""Token-bucketed batching with static padded shapes (numpy only).

A copy of ``mm_s2ut/data/bucketing.py``: samples go to ``num_buckets``
length buckets at source-length quantiles; every batch of a bucket pads
to the bucket's (quantized) ceiling, and the batch size is
``max_tokens // src_len``. The batch order of an epoch comes from a
seeded ``numpy.random.RandomState(seed + epoch)``, so the port's batches
are the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def quantize(n: int, q: int) -> int:
    return int(math.ceil(n / q) * q)


@dataclass
class Bucket:
    src_len: int  # padded source length (samples or frames)
    tgt_len: int  # padded target length
    batch_size: int
    indices: np.ndarray


class LengthBucketBatcher:
    """Assign samples to buckets by source length; yield index batches."""

    def __init__(
        self,
        src_lengths: Sequence[int],
        tgt_lengths: Sequence[int],
        max_tokens: int,
        num_buckets: int = 8,
        quantum: int = 32,
        tgt_quantum: int = 32,
        min_batch_size: int = 1,
        max_batch_size: Optional[int] = None,
        seed: int = 1,
        drop_last: bool = False,
    ):
        self.src_lengths = np.asarray(src_lengths, np.int64)
        self.tgt_lengths = np.asarray(tgt_lengths, np.int64)
        self.seed = seed
        self.drop_last = drop_last
        num_buckets = max(1, min(num_buckets, len(self.src_lengths)))
        qs = np.quantile(self.src_lengths, np.linspace(0, 1, num_buckets + 1)[1:])
        edges = np.unique([quantize(int(q), quantum) for q in qs])
        bucket_of = np.minimum(np.searchsorted(edges, self.src_lengths, side="left"),
                               len(edges) - 1)
        self.buckets: List[Bucket] = []
        for b in range(len(edges)):
            idx = np.nonzero(bucket_of == b)[0]
            if idx.size == 0:
                continue
            src_len = quantize(int(self.src_lengths[idx].max()), quantum)
            tgt_len = quantize(int(self.tgt_lengths[idx].max()), tgt_quantum or 1)
            bsz = max(min_batch_size, max_tokens // max(src_len, 1))
            if max_batch_size:
                bsz = min(bsz, max_batch_size)
            self.buckets.append(Bucket(src_len, tgt_len, bsz, idx))

    def epoch(self, epoch: int = 0, shuffle: bool = True) -> Iterator[Tuple[Bucket, np.ndarray]]:
        """Yield (bucket, indices) batches; shuffled within buckets and
        across batch order per epoch (seeded, reproducible)."""
        rng = np.random.RandomState(self.seed + epoch)
        batches: List[Tuple[Bucket, np.ndarray]] = []
        for bucket in self.buckets:
            idx = bucket.indices.copy()
            if shuffle:
                rng.shuffle(idx)
            for i in range(0, len(idx), bucket.batch_size):
                chunk = idx[i : i + bucket.batch_size]
                if self.drop_last and len(chunk) < bucket.batch_size:
                    continue
                batches.append((bucket, chunk))
        if shuffle:
            rng.shuffle(batches)
        yield from batches
