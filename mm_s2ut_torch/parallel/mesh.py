"""Data parallelism of the port over ``torch.distributed``.

Port of the data-parallel half of ``mm_s2ut/parallel/mesh.py``. JAX lays
the rows of one padded host batch over the mesh's ``data`` axis and
lets jit insert the gradient all-reduce; here each process (one per
card, started by ``torchrun``) takes a contiguous slice of the same
padded batch's rows (:func:`shard_rows`, :func:`shard_batch`) and the
trainer sums the gradients and the loss statistics across processes
(``train/trainer.py``). A batch whose rows do not divide by the world
size splits unevenly (the first processes take one row more), where JAX
replicates it: both compute the same sums. The tensor-parallel ``model``
axis and the ``pipe`` axis are not ported (ROADMAP.md §1).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DataParallel:
    """This process's place among the data-parallel processes."""

    rank: int
    world: int


def init_distributed(device: str = "cuda") -> Tuple[Optional[DataParallel], torch.device]:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
    NCCL with the device ``cuda:LOCAL_RANK``, gloo with ``cpu``. Without
    those variables there is no group: (None, ``device``)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None, torch.device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if not torch.distributed.is_initialized():
        torch.distributed.init_process_group(backend, rank=rank, world_size=world)
    return DataParallel(rank, world), dev


def check_mesh(mesh, world: int) -> None:
    """``mesh.data`` must be -1 or the world size; a ``model`` or ``pipe``
    axis raises."""
    if mesh.model > 1 or mesh.pipe > 1:
        raise NotImplementedError(
            f"mesh.model={mesh.model}, mesh.pipe={mesh.pipe}: the port has data parallelism "
            "only; tensor and pipeline parallelism are not ported (ROADMAP.md §1)")
    if mesh.data not in (-1, world):
        raise ValueError(f"mesh.data={mesh.data} must be -1 or the world size {world}")


def shard_rows(n: int, rank: int, world: int) -> Tuple[int, int]:
    """[start, stop) of ``rank``'s contiguous rows of an ``n``-row batch;
    the first ``n % world`` processes take one row more, and a process
    past the rows gets an empty slice."""
    per, extra = divmod(n, world)
    start = rank * per + min(rank, extra)
    return start, start + per + (rank < extra)


def batch_rows(batch: dict) -> int:
    return len(batch["src_lengths"])


def shard_batch(batch: Any, rank: int, world: int) -> Any:
    """``rank``'s rows (:func:`shard_rows`) of every array or tensor of
    ``batch`` (nested in tuples, lists and dicts) whose leading dimension
    is the batch's rows; scalars and other leaves are kept whole."""
    n = batch_rows(batch)
    start, stop = shard_rows(n, rank, world)

    def cut(x):
        if isinstance(x, (tuple, list)):
            return type(x)(cut(v) for v in x)
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1 and x.shape[0] == n:
            return x[start:stop]
        return x

    return cut(batch)
