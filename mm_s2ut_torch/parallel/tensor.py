"""Tensor and sequence parallelism of the port over ``torch.distributed``.

Port of the ``model`` axis of ``mm_s2ut/parallel/mesh.py``. JAX places
the parameters that ``_TP_RULES`` matches on the model axis and lets XLA
insert the collectives; here :func:`shard_model_` cuts those parameters
in place (each rank keeps its 1/model of the matched dimension, by
:func:`~mm_s2ut_torch.parallel.mesh.tp_axis`) and turns their modules
into the parallel layers below, which do the collectives themselves:

* :class:`ColumnParallelLinear` (``q_proj``/``k_proj``/``v_proj``,
  ``fc1``): the rank's output columns. Called as a module it gathers
  them, so any caller sees the whole output; :meth:`~ColumnParallelLinear.local`
  gives the rank's columns to a Megatron partner (the attention's local
  heads, the FFN's local activations).
* :class:`RowParallelLinear` (``out_proj``, ``fc2``): the rank's input
  rows. Called as a module on the whole input it takes its columns of it;
  :meth:`~RowParallelLinear.partial` takes the partner's local columns.
  Either way the partial products are summed over the group and the
  bias (replicated) added once.
* :class:`ParallelEmbedding` (``embed_tokens``): the rank's rows of the
  vocabulary. A lookup masks the ids outside them and sums over the
  group; :meth:`~ParallelEmbedding.attend` gives the tied output
  projection's logits, gathered over the vocabulary.

The conjugate pair carries the gradients: :func:`copy_to` (identity
forward, all-reduce backward) where a replicated activation enters a
sharded layer, :func:`reduce_from` (all-reduce forward, identity
backward) where the partial products leave it. Under sequence
parallelism (:class:`SeqShard`) the speech encoder's activations stay cut
on T between layers: :func:`gather_seq` (all-gather forward,
reduce-scatter backward) before the column-parallel layers and
:func:`reduce_scatter_seq` (the reverse) after the row-parallel ones take
their places. T is padded to a multiple of the group's size for the
collectives; the padded rows never reach a real one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mm_s2ut_torch.parallel.mesh import tp_axis


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place in its tensor-parallel group."""

    group: object  # a torch.distributed process group
    rank: int  # m, the place on the model axis
    size: int  # mesh.model

    def span(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's 1/size of ``n``."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


def _all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=tp.group)
    return x


def _all_gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n).contiguous()


def _reduce_scatter(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's chunk of ``dim``: NCCL's
    reduce-scatter, or an all-reduce then the chunk where the backend has
    none (gloo)."""
    if dist.get_backend(tp.group) == "nccl":
        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((xt.shape[0] // tp.size, *xt.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, xt, group=tp.group)
        return out.movedim(0, dim)
    return _chunk(_all_reduce(x, tp), tp, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """All-gather over the last dimension; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather(x, tp, -1)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.tp, -1), None


def copy_to(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Identity forward; the gradient summed over the group."""
    return _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the group; the gradient passes as it is."""
    return _ReduceFrom.apply(x, tp)


def gather_last(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _GatherLast.apply(x, tp)


# ------------------------------------------------------------ sequence shards

@dataclass(frozen=True)
class SeqShard:
    """The speech encoder's T cut over the tensor-parallel group: this
    rank holds rows [t0, t0 + per) of T padded to ``per`` · size."""

    tp: TensorParallel
    T: int

    @property
    def per(self) -> int:
        return -(-self.T // self.tp.size)

    @property
    def t0(self) -> int:
        return self.tp.rank * self.per

    def at(self, width: int):
        """The shard's place in the whole (B, T, width) tensor, as
        ``ops.dropout.hash_dropout`` takes it."""
        return (self.t0, 0), (self.T, width)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        extra = self.per * self.tp.size - x.shape[1]
        return F.pad(x, (0, 0, 0, extra)) if extra else x


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _chunk(seq.pad(x), seq.tp, 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.seq.tp, 1)[:, :ctx.seq.T], None


class _GatherSeq(torch.autograd.Function):
    """All-gather T, its gradient reduce-scattered (the layers after it
    are sharded: each rank's gradient is partial)."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _all_gather(x, seq.tp, 1)[:, :seq.T]

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.seq.pad(g), ctx.seq.tp, 1), None


class _GatherSeqOut(torch.autograd.Function):
    """All-gather T where the encoder's output leaves the sharded region;
    the computation after it is replicated, so its gradient is whole on
    every rank and each takes its rows."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _all_gather(x, seq.tp, 1)[:, :seq.T]

    @staticmethod
    def backward(ctx, g):
        return _chunk(ctx.seq.pad(g), ctx.seq.tp, 1), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _reduce_scatter(seq.pad(x), seq.tp, 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.seq.tp, 1)[:, :ctx.seq.T], None


def scatter_seq(x: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    """(B, T, D) replicated → this rank's (B, per, D) rows (zeros past T)."""
    return _ScatterSeq.apply(x, seq)


def gather_seq(x: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    return _GatherSeq.apply(x, seq)


def gather_seq_out(x: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    return _GatherSeqOut.apply(x, seq)


def reduce_scatter_seq(x: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    return _ReduceScatterSeq.apply(x, seq)


def enter(x: torch.Tensor, tp: TensorParallel, seq: Optional[SeqShard]) -> torch.Tensor:
    """A replicated (or, under ``seq``, T-sharded) activation → the whole
    input of the column-parallel layers."""
    return copy_to(x, tp) if seq is None else gather_seq(x, seq)


def leave(x: torch.Tensor, tp: TensorParallel, seq: Optional[SeqShard]) -> torch.Tensor:
    """The row-parallel layers' partial products → their sum (under
    ``seq``, this rank's rows of it)."""
    return reduce_from(x, tp) if seq is None else reduce_scatter_seq(x, seq)


# -------------------------------------------------------------- the layers

class ColumnParallelLinear(nn.Linear):
    """A Linear holding the rows [o0, o1) of its (out, in) weight and bias;
    ``in_features``/``out_features`` stay the whole layer's."""

    tp: TensorParallel

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's output columns of an input already through
        :func:`enter`."""
        return F.linear(x, self.weight, self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gather_last(self.local(copy_to(x, self.tp)), self.tp)


class RowParallelLinear(nn.Linear):
    """A Linear holding the columns [i0, i1) of its weight; the bias whole."""

    tp: TensorParallel

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's partial product of its local input columns (no bias)."""
        return F.linear(x, self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i0, i1 = self.tp.span(self.in_features)
        y = reduce_from(self.partial(copy_to(x, self.tp)[..., i0:i1]), self.tp)
        return y if self.bias is None else y + self.bias


class ParallelEmbedding(nn.Embedding):
    """An Embedding holding the rows [v0, v1) of the vocabulary;
    ``num_embeddings`` stays the whole vocabulary's."""

    tp: TensorParallel

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        v0, v1 = self.tp.span(self.num_embeddings)
        inside = (ids >= v0) & (ids < v1)
        rows = F.embedding((ids - v0).clamp(0, v1 - v0 - 1), self.weight)
        return reduce_from(rows * inside[..., None].to(rows.dtype), self.tp)

    def attend(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """fp32 logits x · tableᵀ over the whole vocabulary, the operands
        rounded to ``dt`` (``StackedEmbedding.attend``)."""
        w = self.weight.to(dt).float()
        return gather_last(torch.matmul(copy_to(x, self.tp).to(dt).float(), w.t()), self.tp)


def _cut(p: nn.Parameter, dim: int, tp: TensorParallel, name: str) -> nn.Parameter:
    n = p.shape[dim]
    if n % tp.size:
        raise ValueError(f"{name}: dimension {dim} of {tuple(p.shape)} ({n}) does not divide "
                         f"by mesh.model={tp.size}")
    out = nn.Parameter(p.detach().narrow(dim, tp.rank * (n // tp.size), n // tp.size).clone(),
                       requires_grad=p.requires_grad)
    out.tp_sharded, out.tp_dim = True, dim
    return out


def gather_param(t: torch.Tensor, p: nn.Parameter, tp: TensorParallel) -> torch.Tensor:
    """``t`` (shaped as the parameter ``p``, e.g. an Adam moment) whole:
    gathered over the group where ``p`` is cut, else itself."""
    return _all_gather(t, tp, p.tp_dim) if getattr(p, "tp_sharded", False) else t


def shard_param(t: torch.Tensor, p: nn.Parameter, tp: TensorParallel) -> torch.Tensor:
    """The inverse of :func:`gather_param`: this rank's part of a whole ``t``."""
    return _chunk(t, tp, p.tp_dim) if getattr(p, "tp_sharded", False) else t


def shard_model_(model: nn.Module, tp: TensorParallel) -> nn.Module:
    """Cut every parameter that ``_TP_RULES`` matches (by its flax path) to
    this rank's 1/size, in place, and make its module the parallel layer;
    every other parameter stays whole. A matched dimension that does not
    divide by the size raises ``ValueError`` naming the parameter."""
    for name, mod in list(model.named_modules()):
        prefix = name.replace(".", "/")
        if isinstance(mod, nn.Linear) and not isinstance(mod, (ColumnParallelLinear,
                                                               RowParallelLinear)):
            axis = tp_axis(f"{prefix}/kernel")
            if axis is None:
                continue
            if axis == 1:  # flax (in, out) cut on out: torch rows, and the bias
                mod.weight = _cut(mod.weight, 0, tp, f"{prefix}/kernel")
                if mod.bias is not None:
                    mod.bias = _cut(mod.bias, 0, tp, f"{prefix}/bias")
                mod.__class__ = ColumnParallelLinear
            else:
                mod.weight = _cut(mod.weight, 1, tp, f"{prefix}/kernel")
                mod.__class__ = RowParallelLinear
            mod.tp = tp
        elif isinstance(mod, nn.Embedding) and not isinstance(mod, ParallelEmbedding):
            if tp_axis(f"{prefix}/embedding") is None:
                continue
            mod.weight = _cut(mod.weight, 0, tp, f"{prefix}/embedding")
            mod.__class__ = ParallelEmbedding
            mod.tp = tp
    return model


def heads_of(mha: nn.Module) -> Optional[TensorParallel]:
    """The group whose ranks each hold a head slice of ``mha``
    (``models.layers.MultiHeadAttention``), or None: not sharded, or its
    heads do not divide by the group's size (its projections then gather
    and the attention runs on every head)."""
    tp = getattr(mha.q_proj, "tp", None)
    if (tp is None or mha.num_heads % tp.size
            or not all(isinstance(p, ColumnParallelLinear) for p in (mha.k_proj, mha.v_proj))
            or not isinstance(mha.out_proj, RowParallelLinear)):
        return None
    return tp
