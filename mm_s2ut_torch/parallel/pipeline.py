"""GPipe pipeline parallelism of the port over ``torch.distributed``.

Port of ``mm_s2ut/parallel/pipeline.py``. JAX stores the L layers of a
pipelined stack stacked (leading axis L), shards them ``P("pipe", ...)``
and runs the GPipe schedule as a ``lax.scan`` of ``ppermute`` hops under
``shard_map``, its backward derived by autodiff. Here each rank of the
``pipe`` axis holds the L/S layers of its stage (:func:`pipe_model_`) and
:func:`gpipe` runs the schedule itself:

* forward: stage 0 takes microbatch t at tick t, a stage s > 0 takes what
  stage s − 1 sent it, so the M microbatches pass in M + S − 1 ticks; the
  last stage's outputs are broadcast to every pipe rank, as JAX's output
  is replicated over ``pipe``;
* backward (one ``torch.autograd.Function`` around the schedule, so the
  order of the hops is the schedule's and never the autograd engine's):
  the last stage takes its own copy of the output's cotangent (every pipe
  rank computes the same loss from the broadcast output; JAX's loss is one
  logical value, so the S copies are not summed), the stages run their
  microbatches' backwards in reverse tick order and hand the input's
  cotangent down the ring, and stage 0's is broadcast to every pipe rank:
  the transpose of JAX's replicated input, so the subsampler and the
  positions before the stack get one gradient, the same on every rank.

Each layer runs on one rank with the same math as a sequential run over
the same microbatches (kernel A and, in the backward, kernel H once per
layer per microbatch), so the forward is that run's bit for bit.

A :class:`Transport` moves the hops: :class:`DistributedTransport` over a
pipe group (``batch_isend_irecv``, NCCL on the card, gloo on the CPU), or
:class:`Loopback`, every stage in one process (the fast CPU tests and one
card); the trainer builds the first. There is no fallback between them:
a pipelined stack with neither raises, as JAX's ``shard_map`` does
without a pipe axis.

Checkpoints: :func:`stack_layer_params` / :func:`unstack_layer_params`
(numpy copies of JAX's) move a tree between the sequential encoder's
``layer{i}`` subtrees and the stacked ``pipe_stack/layers``;
:func:`sequential_params` turns a whole pipelined checkpoint into the
sequential layout that ``cli.generate`` loads.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mm_s2ut_torch.ops.dropout import DropoutRng, checkpoint
from mm_s2ut_torch.parallel.mesh import is_stacked


# ----------------------------------------------- layer{i} ↔ stacked checkpoints

def _tree_map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def stack_layer_params(params: Mapping, prefix: str = "layer") -> Dict:
    """``{layer0: t0, layer1: t1, ...}`` → one tree whose leaves have a
    leading axis L. ``params`` is the parent tree holding the per-layer
    subtrees (other keys are ignored); layers are ordered by their
    integer suffix, which must run 0 … L − 1."""
    idx = sorted(int(k[len(prefix):]) for k in params
                 if k.startswith(prefix) and k[len(prefix):].isdigit())
    if idx != list(range(len(idx))) or not idx:
        raise ValueError(f"non-contiguous or missing {prefix}{{i}} keys: {idx}")
    per_layer = [params[f"{prefix}{i}"] for i in idx]
    return _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *per_layer)


def unstack_layer_params(stacked: Mapping, prefix: str = "layer") -> Dict:
    """Inverse of :func:`stack_layer_params`."""
    n = np.shape(_first_leaf(stacked))[0]
    return {f"{prefix}{i}": _tree_map(lambda a, i=i: np.asarray(a)[i], stacked)
            for i in range(n)}


def sequential_params(params: Mapping) -> Dict:
    """A whole parameter tree with pipelined encoders (``…/pipe_stack/layers``)
    → the sequential encoders' ``layer{i}`` layout; other trees as they are."""
    out = {}
    for k, v in params.items():
        if k == "pipe_stack":
            out.update(unstack_layer_params(v["layers"]))
        else:
            out[k] = sequential_params(v) if isinstance(v, Mapping) else v
    return out


# ------------------------------------------------------------------ transports

class Loopback:
    """Every stage in this process: a hop is handed over in memory, the
    broadcast is the last stage's tensor itself."""

    def __init__(self, n_stages: int):
        self.n_stages = n_stages
        self.stages = list(range(n_stages))
        self._boxes: Dict = collections.defaultdict(collections.deque)

    def send(self, t: torch.Tensor, src: int, dst: int) -> None:
        self._boxes[(src, dst)].append(t)

    def recv(self, src: int, dst: int, like: torch.Tensor) -> torch.Tensor:
        return self._boxes[(src, dst)].popleft()

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        return t


class DistributedTransport:
    """The stage ``stage`` of a pipe group of ``len(ranks)`` processes
    (``ranks``: the group's global ranks in stage order)."""

    def __init__(self, group, ranks: Sequence[int], stage: int, device: torch.device):
        self.group, self.ranks = group, list(ranks)
        self.n_stages = len(self.ranks)
        self.stages = [stage]
        # One collective first: NCCL builds the group's communicator in a
        # call that all its ranks join, which a first hop between two
        # stages of more than two would not be.
        dist.all_reduce(torch.zeros(1, device=device), group=group)

    def _p2p(self, op, t: torch.Tensor, stage: int) -> None:
        for work in dist.batch_isend_irecv([dist.P2POp(op, t, self.ranks[stage], self.group)]):
            work.wait()

    def send(self, t: torch.Tensor, src: int, dst: int) -> None:
        self._p2p(dist.isend, t.contiguous(), dst)

    def recv(self, src: int, dst: int, like: torch.Tensor) -> torch.Tensor:
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        self._p2p(dist.irecv, buf, src)
        return buf

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        t = t.contiguous()
        dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t


Transport = Any  # Loopback or DistributedTransport


# ------------------------------------------------------------------ the schedule

class _Schedule:
    """One GPipe pass over the stages ``transport`` runs here; holds each
    (stage, microbatch)'s graph from the forward to the backward."""

    def __init__(self, layer_fn, layers, spans, extras, n_stages, transport):
        self.layer_fn, self.layers, self.spans = layer_fn, layers, spans
        self.extras, self.n_stages, self.transport = extras, n_stages, transport
        self.per_stage = len(layers) // n_stages
        self.saved: Dict = {}
        self.params = {s: [p for layer in self.stage_layers(s) for p in layer.parameters()
                           if p.requires_grad] for s in transport.stages}

    def stage_layers(self, s: int) -> List:
        return self.layers[s * self.per_stage:(s + 1) * self.per_stage]

    def run_stage(self, s: int, h: torch.Tensor, m: int) -> torch.Tensor:
        start, stop = self.spans[m]
        e = {k: v[start:stop] for k, v in self.extras.items()}
        for i, layer in enumerate(self.stage_layers(s)):
            out = self.layer_fn(layer, s * self.per_stage + i, h, e, start)
            if out.shape != h.shape or out.dtype != h.dtype:
                raise ValueError(f"gpipe: a layer must keep its input's shape and dtype "
                                 f"({tuple(h.shape)} {h.dtype} → {tuple(out.shape)} {out.dtype})")
            h = out
        return h

    def forward(self, x: torch.Tensor, grad: bool) -> torch.Tensor:
        M, last, tr = len(self.spans), self.n_stages - 1, self.transport
        xm = [x[a:b] for a, b in self.spans]
        outs: Dict[int, torch.Tensor] = {}
        for t in range(M + self.n_stages - 1):
            for s in tr.stages:
                m = t - s
                if not 0 <= m < M:
                    continue
                h = xm[m] if s == 0 else tr.recv(s - 1, s, like=xm[m])
                if grad:
                    h_in = h.detach().requires_grad_(True)
                    with torch.enable_grad():
                        out = self.run_stage(s, h_in, m)
                    self.saved[(s, m)] = (h_in, out)
                    out = out.detach()
                else:
                    out = self.run_stage(s, h, m)
                if s == last:
                    outs[m] = out
                else:
                    tr.send(out, s, s + 1)
        y = torch.cat([outs[m] for m in range(M)]) if last in tr.stages else torch.empty_like(x)
        return tr.broadcast(y, last)

    def backward(self, g: torch.Tensor):
        M, last, tr = len(self.spans), self.n_stages - 1, self.transport
        gm = [g[a:b] for a, b in self.spans]
        sums: Dict[int, Optional[torch.Tensor]] = {}
        dx: Dict[int, torch.Tensor] = {}
        for t in reversed(range(M + self.n_stages - 1)):
            for s in reversed(tr.stages):
                m = t - s
                if not 0 <= m < M:
                    continue
                h_in, out = self.saved.pop((s, m))
                go = gm[m] if s == last else tr.recv(s + 1, s, like=out)
                params = self.params[s]
                got = torch.autograd.grad(out, [h_in, *params], go, allow_unused=True)
                for p, gp in zip(params, got[1:]):
                    if gp is not None:
                        sums[id(p)] = gp if sums.get(id(p)) is None else sums[id(p)] + gp
                if s == 0:
                    dx[m] = got[0]
                else:
                    tr.send(got[0], s, s - 1)
        y = torch.cat([dx[m] for m in range(M)]) if 0 in tr.stages else torch.empty_like(g)
        return tr.broadcast(y, 0), [sums.get(id(p)) for s in tr.stages for p in self.params[s]]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x: torch.Tensor, *params):
        ctx.sched = sched
        return sched.forward(x, grad=True)

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.sched.backward(g)
        ctx.sched = None
        return (None, dx, *grads)


def gpipe(
    layer_fn: Callable[[nn.Module, int, torch.Tensor, Dict[str, torch.Tensor], int],
                       torch.Tensor],
    layers: Sequence[Optional[nn.Module]],
    x: torch.Tensor,
    extras: Optional[Dict[str, torch.Tensor]] = None,
    *,
    n_stages: int,
    n_micro: int,
    transport: Transport,
    remat: bool = False,
    rng: Optional[DropoutRng] = None,
    rows: Optional[int] = None,
) -> torch.Tensor:
    """Run an L-layer stack as an S-stage GPipe on the stages ``transport``
    runs in this process.

    ``layer_fn(layer, layer_idx, x_mb, extras_mb, row)`` runs one layer on
    one microbatch whose first row is ``row`` of ``x``, and keeps its
    shape and dtype; ``layers``: the L layers by index, None where another
    process holds them; ``x`` (B, ...); ``extras``: per-row side inputs
    with leading B (padding biases), cut into microbatches with ``x`` and
    held constant (no gradient); ``rows``: the rows of the batch across
    the data-parallel ranks (``x``'s by default), which must divide by
    ``n_micro`` as JAX's global batch must; this process cuts its own rows
    into ``n_micro`` contiguous microbatches (the first ones a row larger
    where they do not divide, empty ones left out). ``remat``
    rematerialises each layer in the backward (``ops.dropout.checkpoint``
    with ``rng``). Returns the (B, ...) outputs on every pipe rank."""
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    total = x.shape[0] if rows is None else rows
    if total % n_micro:
        raise ValueError(f"batch {total} not divisible by {n_micro} microbatches")
    if transport.n_stages != n_stages:
        raise ValueError(f"gpipe: {n_stages} stages over a transport of {transport.n_stages}")
    per = n_layers // n_stages
    for s in transport.stages:
        if any(layer is None for layer in layers[s * per:(s + 1) * per]):
            raise ValueError(f"gpipe: stage {s}'s layers are not held here")
    sizes = [len(c) for c in torch.arange(x.shape[0]).tensor_split(n_micro) if len(c)]
    starts = np.cumsum([0, *sizes]).tolist()
    spans = list(zip(starts[:-1], starts[1:]))
    fn = layer_fn
    if remat:
        def fn(layer, idx, h, e, row):
            return checkpoint(lambda h: layer_fn(layer, idx, h, e, row), rng, h)
    sched = _Schedule(fn, list(layers), spans, dict(extras or {}), n_stages, transport)
    params = [p for s in transport.stages for p in sched.params[s]]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _GPipe.apply(sched, x, *params)
    return sched.forward(x, grad=False)


# ------------------------------------------------------------------ the stack

class PipelinedEncoderStack(nn.Module):
    """``num_layers`` homogeneous layers run as a GPipe of ``n_stages``
    stages and ``n_micro`` microbatches (0: ``n_stages``), the counterpart
    of JAX's ``PipelinedEncoderStack``. Its layers are ``layers.{i}``
    (flax ``pipe_stack/layers`` with a leading axis L in a checkpoint,
    ``convert.py``); built whole, a stage keeps its L/S
    (:func:`pipe_model_`). A layer is called as the sequential encoder
    calls it: ``layer(x, key_bias)``.

    Dropout draws what the port's sequential run draws, where JAX's
    pipeline draws another sample than its own sequential run: every hash
    site keys on the global batch row, each layer's seeds are the ones the
    sequential run draws for it (the stack draws all L layers' seeds from
    the run's generator first, then puts each layer back to its own for
    every microbatch), and the generator ends where the sequential run's
    does, on every rank."""

    def __init__(self, layer_factory: Callable[[], nn.Module], num_layers: int, n_stages: int,
                 n_micro: int = 0, remat: bool = False):
        super().__init__()
        self.layers = nn.ModuleDict({str(i): layer_factory() for i in range(num_layers)})
        self.num_layers, self.n_stages = num_layers, n_stages
        self.n_micro = n_micro or n_stages
        self.remat = remat
        self.transport: Optional[Transport] = None  # set by pipe_model_
        self.rng: Optional[DropoutRng] = None

    def hold(self, transport: Transport) -> None:
        """Run over ``transport``, keeping the layers of its stages only."""
        if transport.n_stages != self.n_stages:
            raise ValueError(f"pipeline_stages={self.n_stages} over a pipe group of "
                             f"{transport.n_stages} ranks")
        if self.num_layers % self.n_stages:
            raise ValueError(f"{self.num_layers} layers not divisible by {self.n_stages} stages")
        per = self.num_layers // self.n_stages
        keep = {str(s * per + i) for s in transport.stages for i in range(per)}
        for name in [n for n in self.layers if n not in keep]:
            del self.layers[name]
        self.transport = transport

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        """``key_bias`` (B, T): the padding's additive key bias."""
        if self.transport is None:
            raise ValueError(
                f"pipeline_stages={self.n_stages} needs a pipe group of {self.n_stages} ranks "
                f"(mesh.pipe={self.n_stages} under torchrun), as JAX's needs a mesh with a pipe "
                f"axis of that size; to decode a pipelined checkpoint, turn it sequential "
                f"(parallel.pipeline.sequential_params)")
        layers = [self.layers[str(i)] if str(i) in self.layers else None
                  for i in range(self.num_layers)]
        rng = self.rng
        held = [layer for layer in layers if layer is not None]
        n = held[0].seed_draws() if held and self.training else 0
        drawing = rng is not None and n > 0
        if drawing:
            starts = []
            for _ in range(self.num_layers):
                starts.append(rng.seeds.get_state())
                for _ in range(n):
                    rng.next_seed()
            end, row0 = rng.seeds.get_state(), rng.row0

        def layer_fn(layer, idx, h, e, row):
            if not drawing:
                return layer(h, e["bias"])
            rng.seeds.set_state(starts[idx])
            rng.row0 = row0 + row
            try:
                return layer(h, e["bias"])
            finally:
                rng.row0 = row0

        extras = {"bias": key_bias}
        remat = self.remat and self.training and torch.is_grad_enabled()
        try:
            return gpipe(layer_fn, layers, x, extras, n_stages=self.n_stages,
                         n_micro=self.n_micro, transport=self.transport, remat=remat, rng=rng,
                         rows=rng.rows if rng is not None else None)
        finally:
            if drawing:
                rng.seeds.set_state(end)


def pipe_model_(model: nn.Module, transport: Transport) -> nn.Module:
    """Hand every :class:`PipelinedEncoderStack` of ``model`` the
    transport, each keeping only the layers of the stages it runs here."""
    for mod in model.modules():
        if isinstance(mod, PipelinedEncoderStack):
            mod.hold(transport)
    return model


def gather_stages(flat: Dict[str, np.ndarray],
                  transport: DistributedTransport) -> Dict[str, np.ndarray]:
    """Flat flax leaves of this stage → the whole model's: each stacked
    leaf (a stage's L/S rows of a pipelined stack, ``mesh.is_stacked``)
    concatenated over the pipe group in stage order, the others (the
    same on every stage) as they are. Every rank of the group calls."""
    mine = {k: v for k, v in flat.items() if is_stacked(k)}
    parts: List = [None] * transport.n_stages
    dist.all_gather_object(parts, mine, group=transport.group)
    out = dict(flat)
    for k in mine:
        out[k] = np.concatenate([p[k] for p in parts])
    return out
