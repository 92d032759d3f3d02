"""Dropout of the training path: counter-hash and Bernoulli.

Port of ``mm_s2ut/ops/dropout.py``. :func:`hash_dropout` keeps element
``i`` (the row-major flat index of the contiguous tensor) when the
reference's hash of ``(i, seed)`` clears the rate, bit for bit as JAX
computes it; its backward recomputes the mask from the seed, as the
reference's ``_hd_bwd`` does, so nothing but the seed is saved. It is
elementwise, so plain PyTorch is the right tool (no kernel).

JAX draws its seeds from flax's "dropout" stream, which no torch
generator reproduces. The port draws every hash seed (and the modality
dropout's two uniforms) from a CPU ``torch.Generator`` and the Bernoulli
masks (decoder embedding, dense attention weights, fusion) from a
generator on the model's device, both held by one :class:`DropoutRng`
that the trainer hands the model (``MMS2UTModel.set_dropout_rng``). A
module in training mode with a rate > 0 and no rng raises.

Under data parallelism (``train/trainer.py``) every process holds the same
generators and a contiguous slice of the batch's rows
(:meth:`DropoutRng.shard`). JAX's jit sees the global batch, so each
process draws what the whole batch would: the hash keys on the global
flat index and the global (b·H + h) row, and a Bernoulli mask or a
uniform over rows is drawn for every row of the batch and sliced, so all
processes move their generators alike. Tensor parallelism cuts other
dimensions too (an FFN's columns, attention's heads, the sequence under
sequence parallelism): a hash site then names where its block sits in
the whole tensor (``hash_dropout``'s ``at``), and a Bernoulli site draws
the whole tensor and slices its block (``BernoulliDropout``'s ``at``).

:func:`checkpoint` rematerialises a layer (``torch.utils.checkpoint``,
non-reentrant) and puts both generators back to their state at the
forward for the recompute, then returns them to where the run stands:
``torch.utils.checkpoint`` restores only the global generators, so the
recompute would otherwise draw new seeds and build other dropout masks
than the forward did, and move the run's seed stream on.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from mm_s2ut_torch.ops.attention import _H1, _H3, _M32, _keep_from_hash, _mix


class DropoutRng:
    """The generators of one training run, seeded by ``train.seed``."""

    def __init__(self, seed: int, device):
        self.seeds = torch.Generator().manual_seed(seed)
        self.bernoulli = torch.Generator(device=device).manual_seed(seed)
        self.row0 = 0  # this process's first row of the batch
        self.rows: Optional[int] = None  # the batch's rows; None: this process holds them all

    def shard(self, row0: int, rows: Optional[int]) -> None:
        """This process's rows of the next batches start at ``row0`` of ``rows``."""
        self.row0, self.rows = int(row0), rows

    def uniform(self, shape, generator: torch.Generator, device=None) -> torch.Tensor:
        """``torch.rand(shape)`` for a batch-leading ``shape``, drawn for all
        the batch's rows and sliced to this process's."""
        if self.rows is None:
            return torch.rand(shape, generator=generator, device=device)
        full = torch.rand((self.rows, *shape[1:]), generator=generator, device=device)
        return full[self.row0:self.row0 + shape[0]]

    def next_seed(self) -> int:
        """A uint32 seed for one hash-dropout or attention-dropout call."""
        return int(torch.randint(0, 1 << 32, (), generator=self.seeds))

    def state_dict(self):
        return {"seeds": self.seeds.get_state(), "bernoulli": self.bernoulli.get_state()}

    def load_state_dict(self, state) -> None:
        self.seeds.set_state(state["seeds"].cpu())
        self.bernoulli.set_state(state["bernoulli"].cpu())


def checkpoint(fn: Callable, rng: Optional[DropoutRng], *args) -> torch.Tensor:
    """``fn(*args)`` under non-reentrant activation checkpointing, its
    recompute drawing from ``rng`` what its forward drew."""
    at_forward = rng.state_dict() if rng is not None else None
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or rng is None:
            return fn(*a)
        now = rng.state_dict()
        rng.load_state_dict(at_forward)
        try:
            return fn(*a)
        finally:
            rng.load_state_dict(now)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


Block = Tuple[Tuple[int, ...], Tuple[int, ...]]


def keep_mask(shape, seed: int, rate: float, device, offset: int = 0,
              at: Optional[Block] = None) -> torch.Tensor:
    """The reference's ``_keep_mask``: keep where the hash of the flat
    index (plus ``offset``, the global index of element 0) and the seed
    clears the rate. ``at`` = (starts, sizes) of the dimensions after the
    first: the tensor is the block at those starts of a whole tensor of
    those sizes (row 0 at ``offset`` / a row's elements of the whole), and
    each element hashes its index in the whole."""
    if at is None:
        idx = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64, device=device)
    else:
        starts, sizes = at
        row = math.prod(sizes)
        idx = (offset // row + torch.arange(shape[0], dtype=torch.int64, device=device))
        for n, s0, size in zip(shape[1:], starts, sizes):
            idx = idx[..., None] * size + (s0 + torch.arange(n, dtype=torch.int64,
                                                             device=device))
        idx = idx.reshape(-1)
    h = _mix(((idx * _H3) & _M32) ^ ((int(seed) * _H1) & _M32))
    return _keep_from_hash(h, rate).reshape(shape)


def _weak(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as JAX's weak typing uses it: rounded to the
    other operand's dtype first (bf16 rounds 1/0.9 to 1.109375)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _apply(x: torch.Tensor, seed: int, rate: float, offset: int,
           at: Optional[Block] = None) -> torch.Tensor:
    keep = keep_mask(x.shape, seed, rate, x.device, offset, at)
    return torch.where(keep, x * _weak(1.0 / (1.0 - rate), x), torch.zeros_like(x))


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, offset, at):
        ctx.cfg = (seed, rate, offset, at)
        return _apply(x, seed, rate, offset, at)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, *ctx.cfg), None, None, None, None


def hash_dropout(x: torch.Tensor, seed: int, rate: float, row0: int = 0,
                 at: Optional[Block] = None) -> torch.Tensor:
    """Counter-hash dropout of ``x`` with a uint32 ``seed``; ``row0``: the
    batch row of ``x``'s first row (its flat index starts at row0 times a
    row's elements). ``at`` = (starts, sizes): ``x`` is the block at
    ``starts`` of rows whose other dimensions have ``sizes`` (a column
    shard of an FFN's activations, a sequence shard), hashed at its
    indices in those rows (:func:`keep_mask`)."""
    row = math.prod(x.shape[1:] if at is None else at[1])
    at = None if at is None else (tuple(map(int, at[0])), tuple(map(int, at[1])))
    return _HashDropout.apply(x, int(seed) & _M32, float(rate), int(row0) * row, at)


class HashDropout(nn.Module):
    """Hash dropout with a fresh seed per call from ``self.rng`` (set by
    ``MMS2UTModel.set_dropout_rng``); the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.rng: Optional[DropoutRng] = None

    def forward(self, x: torch.Tensor, at: Optional[Block] = None) -> torch.Tensor:
        """``at``: where ``x`` sits in the whole tensor (:func:`hash_dropout`)."""
        if not self.training or self.rate == 0.0:
            return x
        rng = need_rng(self)
        return hash_dropout(x, rng.next_seed(), self.rate, rng.row0, at)


class BernoulliDropout(nn.Module):
    """``flax.linen.Dropout``'s semantics (keep with probability 1 − rate,
    scale by 1/(1 − rate)) drawn from the device generator of ``self.rng``;
    the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.rng: Optional[DropoutRng] = None

    def forward(self, x: torch.Tensor, at: Optional[Block] = None) -> torch.Tensor:
        """``at`` = (starts, sizes): ``x`` is that block of the whole
        tensor's rows, whose uniforms are drawn and sliced."""
        if not self.training or self.rate == 0.0:
            return x
        rng = need_rng(self)
        if at is None:
            u = rng.uniform(x.shape, rng.bernoulli, x.device)
        else:
            u = rng.uniform((x.shape[0], *at[1]), rng.bernoulli, x.device)
            u = u[(slice(None),) + tuple(slice(s, s + n) for s, n in zip(at[0], x.shape[1:]))]
        return torch.where(u >= self.rate, x / _weak(1.0 - self.rate, x), torch.zeros_like(x))


def need_rng(module: nn.Module) -> DropoutRng:
    if module.rng is None:
        raise RuntimeError(
            f"{type(module).__name__}: training with dropout needs a DropoutRng "
            "(MMS2UTModel.set_dropout_rng)")
    return module.rng
