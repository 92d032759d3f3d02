"""k-means unit quantization: assignment and Lloyd training on the
features' device, and the unit-sequence beam decode on the host.

Port of ``mm_s2ut/ops/kmeans.py`` (HuBERT features → discrete units, the
reference's ``quantize_with_kmeans`` step). Distances use the GEMM
identity ‖x‖² − 2x·Cᵀ + ‖C‖², one ``torch.matmul`` per call, as the JAX
package computes them outside any Pallas kernel; ``kmeans_assign`` then
re-ranks the nearest few by direct differences, where the identity
cancels (JAX's assignment keeps the identity's pick). ``kmeans_plusplus_init``
draws from a ``torch.Generator``, so its picks differ from ``jax.random``'s;
what it keeps is the rule: uniform candidates, then greedily the farthest.
"""
from __future__ import annotations

from itertools import groupby
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def squared_distances(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N, D) × (K, D) → (N, K) squared euclidean distances."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (centroids * centroids).sum(-1)[None, :]
    return x2 - 2.0 * (x @ centroids.T) + c2


REFINE = 8  # the identity's nearest centroids that kmeans_assign re-ranks


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(..., D) features → (...,) nearest-centroid indices (exact ties to
    the lower index). The GEMM identity ranks every centroid, then its
    ``REFINE`` nearest are re-ranked by ‖x − c‖² summed from the
    differences. The identity's fp32 rounding is ~2⁻²⁴ (‖x‖² + ‖c‖²), so
    for a frame close to its centroids beside their norms it exceeds gaps
    of 0.1% between the two nearest, and a card and a CPU, or the identity
    and float64, then pick apart; the differences do not cancel."""
    flat = x.reshape(-1, x.shape[-1])
    k = min(REFINE, centroids.shape[0])
    cand = squared_distances(flat, centroids).topk(k, dim=-1, largest=False).indices
    cand = cand.sort(dim=-1).values  # argmin takes the first of equal distances
    diff = flat[:, None, :] - centroids[cand]
    best = torch.argmin((diff * diff).sum(-1), dim=-1)
    return cand.gather(1, best[:, None])[:, 0].reshape(x.shape[:-1])


def kmeans_fit(x: torch.Tensor, init_centroids: torch.Tensor,
               n_steps: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations from ``init_centroids`` (K, D) over ``x`` (N, D);
    an empty cluster keeps its centroid. Returns (centroids, (n_steps,)
    inertia before each step's update)."""
    K = init_centroids.shape[0]
    centroids = init_centroids
    inertia = []
    for _ in range(n_steps):
        d = squared_distances(x, centroids)
        assign = torch.argmin(d, dim=-1)
        inertia.append(torch.gather(d, 1, assign[:, None]).sum())
        one_hot = torch.nn.functional.one_hot(assign, K).to(x.dtype)  # (N, K)
        counts = one_hot.sum(0)[:, None]
        sums = one_hot.T @ x  # (K, D)
        centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    return centroids, torch.stack(inertia)


def kmeans_plusplus_init(x: torch.Tensor, k: int, generator: Optional[torch.Generator] = None,
                         oversample: int = 4) -> torch.Tensor:
    """k far-apart centroids: k·oversample candidates drawn uniformly
    (without replacement when x has enough rows), then, from the first,
    greedily the candidate farthest from those kept."""
    n = x.shape[0]
    m = k * oversample
    if n >= m:
        cand_idx = torch.randperm(n, generator=generator)[:m]
    else:
        cand_idx = torch.randint(n, (m,), generator=generator)
    cand = x[cand_idx.to(x.device)]
    chosen = cand[:1].expand(k, -1).clone()
    for i in range(1, k):
        d = squared_distances(cand, chosen).amin(-1)
        chosen[i] = cand[torch.argmax(d)]
    return chosen


class KMeansQuantizer:
    """Centroids from a ``.npy``/``.npz`` file or from the reference's
    ``joblib.dump`` of an sklearn k-means (read by ``utils/joblib_pickle``,
    without joblib or sklearn) → units.

    The quantizer has no device of its own: each call assigns on its
    features' device (an array is a CPU tensor), with the centroids
    copied there once and kept for later calls."""

    def __init__(self, centroids):
        self.centroids = torch.as_tensor(np.asarray(centroids, np.float32))
        self._on_device = {self.centroids.device: self.centroids}

    @classmethod
    def load(cls, path: str | Path) -> "KMeansQuantizer":
        if str(path).endswith((".npy", ".npz")):
            arr = np.load(path)
            if hasattr(arr, "keys"):
                arr = arr[list(arr.keys())[0]]
            return cls(arr)
        from mm_s2ut_torch.utils.joblib_pickle import load_kmeans_centroids

        return cls(load_kmeans_centroids(path))  # the reference's joblib.dump of sklearn

    def save(self, path: str | Path) -> None:
        np.save(path, self.centroids.numpy())

    @property
    def n_units(self) -> int:
        return int(self.centroids.shape[0])

    def centroids_on(self, device: torch.device) -> torch.Tensor:
        """The centroids on ``device``, copied there at the first call."""
        c = self._on_device.get(device)
        if c is None:
            c = self._on_device[device] = self.centroids.to(device)
        return c

    def __call__(self, features) -> torch.Tensor:
        """(..., D) features (a tensor, or an array) → (...,) units on the
        features' device."""
        x = torch.as_tensor(features, dtype=torch.float32)
        return kmeans_assign(x, self.centroids_on(x.device))

    def decode(self, features, beamsearch: bool = False, top_k: int = 10,
               beamsize: int = 200) -> dict:
        """The reference's HubertCode.decode: the greedy code and its
        run-length merge, and with ``beamsearch`` a search over each
        frame's top-k units scoring (deduplicated length / T) × (distance
        / the row's top-k distance sum), lower is better."""
        x = torch.as_tensor(features, dtype=torch.float32)
        d = squared_distances(x, self.centroids_on(x.device)).cpu().numpy()
        dist = np.sqrt(np.maximum(d, 0.0))
        order = np.argsort(dist, axis=-1)[:, :top_k]
        values = np.take_along_axis(dist, order, axis=-1)
        code = order[:, 0]
        out = {
            "code": code,
            "distance": dist,
            "center_diff": x.cpu().numpy() - self.centroids.numpy()[code],
            "merged_code": [k for k, _ in groupby(code.tolist())],
        }
        if beamsearch:
            sequences: List[Tuple[List[int], float]] = [([], 1.0)]
            T = len(code)
            for i_row, v_row in zip(order, values):
                vsum = float(np.sum(v_row))
                candidates = []
                for tokens, score in sequences:
                    for k_i, v in zip(i_row, v_row):
                        cand = tokens + [int(k_i)]
                        norm_len_rate = len([k for k, _ in groupby(cand)]) / T
                        candidates.append((cand, score + norm_len_rate * (float(v) / vsum)))
                candidates.sort(key=lambda t: t[1])
                sequences = candidates[:beamsize]
            best = sequences[0][0]
            out["beam_code"] = np.asarray(best)
            out["beam_merged_code"] = [k for k, _ in groupby(best)]
        return out


def dedup_units(units: Sequence[int]) -> List[int]:
    """Run-length dedup (the reference's ``--reduce-unit``)."""
    return [k for k, _ in groupby(list(units))]
