"""The process grid of the port over ``torch.distributed``.

Port of ``mm_s2ut/parallel/mesh.py`` without its ``pipe`` axis. The
world is ``data`` × ``model`` processes (one per card, started by
``torchrun``), the model axis innermost as JAX lays it out: rank r sits
at (d, m) = (r // model, r % model). JAX lays the rows of one padded
host batch over the ``data`` axis and lets jit insert the gradient
all-reduce; here each data-parallel group of ranks (one ``d``) takes a
contiguous slice of the same padded batch's rows (:func:`shard_rows`,
:func:`shard_batch`) and the trainer sums the gradients and the loss
statistics over the ranks of one ``m`` (``train/trainer.py``). A batch
whose rows do not divide splits unevenly (the first take one row more),
where JAX replicates it: both compute the same sums. The ranks of one
``d`` split the parameters that ``_TP_RULES`` matches (:func:`tp_axis`,
``parallel/tensor.py``).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DataParallel:
    """This process's place in the (data, model) grid of ``world`` ranks."""

    rank: int
    world: int
    model: int = 1  # mesh.model: the tensor-parallel group's size

    @property
    def dp_rank(self) -> int:
        return self.rank // self.model

    @property
    def dp_world(self) -> int:
        return self.world // self.model

    @property
    def tp_rank(self) -> int:
        return self.rank % self.model


def process_groups(parallel: DataParallel):
    """(data-parallel group, tensor-parallel group) of this rank: the
    ranks of its ``m`` and of its ``d``. Every rank makes every group, in
    one order, as ``torch.distributed.new_group`` needs; with model 1 the
    data-parallel group is the world's and there is no other."""
    if parallel.model == 1:
        return None, None
    model, dp_world = parallel.model, parallel.dp_world
    dp = tp = None
    for d in range(dp_world):
        g = torch.distributed.new_group([d * model + m for m in range(model)])
        if d == parallel.dp_rank:
            tp = g
    for m in range(model):
        g = torch.distributed.new_group([d * model + m for d in range(dp_world)])
        if m == parallel.tp_rank:
            dp = g
    return dp, tp


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


def check_mesh(mesh, world: int) -> int:
    """The model axis's size: the world must divide by ``mesh.model``
    (JAX's ``make_mesh`` raises ``ValueError`` otherwise, one device
    with model 2 among such cases) and ``mesh.data`` must be -1 or
    world / model; a ``pipe`` axis raises."""
    if mesh.pipe > 1:
        raise NotImplementedError(
            f"mesh.pipe={mesh.pipe}: pipeline parallelism is not ported (ROADMAP.md §1 item 9)")
    model = max(mesh.model, 1)
    if world % model:
        raise ValueError(f"{world} devices not divisible by model={model} x pipe=1")
    if mesh.data not in (-1, world // model):
        raise ValueError(f"mesh.data={mesh.data} must be -1 or the world size {world} "
                         f"over mesh.model={model}")
    return model


# (regex on the flax path 'a/b/leaf', the axis the model axis cuts): the
# port's copy of the reference's _TP_RULES (mm_s2ut/parallel/mesh.py), first
# match wins. Attention q/k/v column-parallel (the kernel's out axis and
# the bias), out_proj row-parallel (the kernel's in axis; its bias whole),
# the FFN's fc1 column- and fc2 row-parallel, the unit table by vocabulary.
TP_RULES = [
    (re.compile(r".*(q_proj|k_proj|v_proj)/kernel$"), 1),
    (re.compile(r".*(q_proj|k_proj|v_proj)/bias$"), 0),
    (re.compile(r".*out_proj/kernel$"), 0),
    (re.compile(r".*fc1/kernel$"), 1),
    (re.compile(r".*fc1/bias$"), 0),
    (re.compile(r".*fc2/kernel$"), 0),
    (re.compile(r".*embed_tokens/embedding$"), 0),
]


def tp_axis(path: str) -> Optional[int]:
    """The axis of the flax leaf ``path`` that the model axis cuts, or None
    (replicated)."""
    for rx, axis in TP_RULES:
        if rx.match(path):
            return axis
    return None


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
