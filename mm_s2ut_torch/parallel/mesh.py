"""The process grid of the port over ``torch.distributed``.

Port of ``mm_s2ut/parallel/mesh.py``. The world is ``data`` × ``pipe`` ×
``model`` processes (one per card, started by ``torchrun``), laid out as
JAX's ``make_mesh`` lays its devices, the model axis innermost: rank
r = (d·pipe + p)·model + m. JAX lays the rows of one padded host batch
over the ``data`` axis and lets jit insert the gradient all-reduce; here
each data-parallel place ``d`` takes a contiguous slice of the same
padded batch's rows (:func:`shard_rows`, :func:`shard_batch`), shared by
its pipe and model ranks, and the trainer sums the gradients and the
loss statistics over the ranks of one (p, m) (``train/trainer.py``). A
batch whose rows do not divide splits unevenly (the first take one row
more), where JAX replicates it: both compute the same sums. The ranks of
one (d, p) split the parameters that ``_TP_RULES`` matches
(:func:`tp_axis`, ``parallel/tensor.py``); the ranks of one (d, m) are
the stages of a pipelined encoder (``parallel/pipeline.py``), each
holding its L/S layers, and hold every other parameter whole.
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
    """This process's place in the (data, pipe, model) grid of ``world`` ranks."""

    rank: int
    world: int
    model: int = 1  # mesh.model: the tensor-parallel group's size
    pipe: int = 1  # mesh.pipe: the pipeline's stages

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.pipe * self.model)

    @property
    def dp_world(self) -> int:
        return self.world // (self.pipe * self.model)

    @property
    def pp_rank(self) -> int:
        return self.rank // self.model % self.pipe

    @property
    def tp_rank(self) -> int:
        return self.rank % self.model

    def rank_at(self, d: int, p: int, m: int) -> int:
        return (d * self.pipe + p) * self.model + m

    def pipe_ranks(self):
        """The global ranks of this rank's pipe group, in stage order."""
        return [self.rank_at(self.dp_rank, p, self.tp_rank) for p in range(self.pipe)]


def process_groups(parallel: DataParallel):
    """(data-parallel, pipe, tensor-parallel) groups of this rank: the
    ranks of its (p, m), of its (d, m) and of its (d, p). Every rank makes
    every group, in one order, as ``torch.distributed.new_group`` needs;
    an axis of size 1 gets no group (None), and with pipe and model both 1
    the data-parallel group is the world's (None)."""
    P, M, D = parallel.pipe, parallel.model, parallel.dp_world
    if P == 1 and M == 1:
        return None, None, None
    d0, p0, m0 = parallel.dp_rank, parallel.pp_rank, parallel.tp_rank
    dp = pp = tp = None
    if M > 1:
        for d in range(D):
            for p in range(P):
                g = torch.distributed.new_group([parallel.rank_at(d, p, m) for m in range(M)])
                if (d, p) == (d0, p0):
                    tp = g
    if P > 1:
        for d in range(D):
            for m in range(M):
                g = torch.distributed.new_group([parallel.rank_at(d, p, m) for p in range(P)])
                if (d, m) == (d0, m0):
                    pp = g
    for p in range(P):
        for m in range(M):
            g = torch.distributed.new_group([parallel.rank_at(d, p, m) for d in range(D)])
            if (p, m) == (p0, m0):
                dp = g
    return dp, pp, tp


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


def check_mesh(mesh, world: int) -> Tuple[int, int]:
    """(model, pipe), the sizes of those axes: the world must divide by
    ``mesh.model`` × ``mesh.pipe`` (JAX's ``make_mesh`` raises
    ``ValueError`` otherwise, one device with model 2 or pipe 2 among such
    cases) and ``mesh.data`` must be -1 or world / (model × pipe)."""
    model, pipe = max(mesh.model, 1), max(mesh.pipe, 1)
    if world % (model * pipe):
        raise ValueError(f"{world} devices not divisible by model={model} x pipe={pipe}")
    if mesh.data not in (-1, world // (model * pipe)):
        raise ValueError(f"mesh.data={mesh.data} must be -1 or the world size {world} "
                         f"over mesh.model={model} x mesh.pipe={pipe}")
    return model, pipe


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


_STACKED = re.compile(r".*pipe_stack/layers/(?!\d+/)")  # a pipelined stack's stacked leaf


def tp_axis(path: str) -> Optional[int]:
    """The axis of the flax leaf ``path`` that the model axis cuts, or None
    (replicated). A pipelined stack's stacked leaf (``…/pipe_stack/layers/…``,
    leading axis L) is cut on the per-layer axis, one further on, as the
    reference's ``_spec_for`` does."""
    for rx, axis in TP_RULES:
        if rx.match(path):
            return axis + 1 if _STACKED.match(path) else axis
    return None


def is_stacked(path: str) -> bool:
    """Whether the flax leaf ``path`` is a pipelined stack's, rows per layer."""
    return _STACKED.match(path) is not None


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
