"""Optimizer and LR schedule, in optax's order of operations.

Port of ``mm_s2ut/train/optimizer.py``, whose update is the optax chain
clip_by_global_norm → scale_by_adam → add_decayed_weights →
scale_by_schedule → scale(−1), wrapped in ``optax.MultiSteps`` when
``update_freq`` > 1. :class:`Optimizer` does the same arithmetic on the
model's fp32 parameters, in place, with ``torch._foreach`` ops:

* clip: g ← g / ‖g‖ · max_norm when ‖g‖ ≥ max_norm (the global norm over
  every tensor);
* Adam: μ ← (1 − b1)·g + b1·μ, ν ← (1 − b2)·g² + b2·ν, then
  (μ / (1 − b1ⁿ)) / (√(ν / (1 − b2ⁿ)) + eps), n counting updates from 1
  (eps outside the square root, bias-corrected as optax does);
* decoupled weight decay: + wd·p;
* the schedule's rate at the update count BEFORE this update, floored at
  1 (optax's scale_by_schedule with the reference's ``max(step, 1)``, so
  the first two updates share one rate);
* p ← p − rate·update.

MultiSteps (``update_freq`` = k > 1): the running mean
acc ← acc + (g − acc)/(m + 1) over mini-steps m = 0 … k−1; the k-th
mini-step runs the chain above on acc and resets it, the others change
no parameter and no Adam state.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mm_s2ut_torch.config import TrainConfig

Schedule = Callable[[int], float]


def inverse_sqrt_schedule(lr: float, warmup_updates: int, warmup_init_lr: float) -> Schedule:
    """Linear warmup from warmup_init_lr to lr, then lr·√(warmup / step),
    in float32 as the reference's jnp arithmetic on an int32 step."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = max(step, 1)
        if step < warmup_updates:
            return float(f32(warmup_init_lr) + f32(lr - warmup_init_lr) * f32(step)
                         / f32(max(warmup_updates, 1)))
        return float(f32(lr) * (f32(warmup_updates) / f32(step)) ** f32(0.5))

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 − decayⁿ in float32, as optax computes it."""
    return float(np.float32(1) - np.power(np.float32(decay), np.int32(count), dtype=np.float32))


def build_schedule(cfg: TrainConfig) -> Schedule:
    if cfg.lr_scheduler == "inverse_sqrt":
        return inverse_sqrt_schedule(cfg.lr, cfg.warmup_updates, cfg.warmup_init_lr)
    if cfg.lr_scheduler == "constant":
        return lambda step: cfg.lr
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


def global_norm(tensors: List[torch.Tensor], cut: Optional[Sequence[bool]] = None,
                group=None, local: Optional[Sequence[bool]] = None,
                pipe_group=None) -> torch.Tensor:
    """√(Σ over every tensor of Σ x²), a 0-dim fp32 tensor. Under tensor
    parallelism ``cut`` marks the tensors each rank of ``group`` holds a
    part of: their squares are summed over the group, the others' (whole
    on every rank) counted once. Under pipeline parallelism ``local``
    marks a stage's own tensors: their squares (after the sum over
    ``group`` where also cut) are summed over ``pipe_group``."""
    sq = torch.stack([n.float() for n in torch._foreach_norm(tensors)]).square()
    if cut is None and local is None:
        return sq.sum().sqrt()
    zero, none = torch.zeros_like(sq), [False] * len(sq)
    tp, pp = cut is not None, local is not None
    cut = torch.tensor(list(cut) if tp else none, device=sq.device)
    local = torch.tensor(list(local) if pp else none, device=sq.device)
    parts = torch.stack([torch.where(cut & ~local, sq, zero).sum(),
                         torch.where(cut & local, sq, zero).sum()])
    if tp:
        torch.distributed.all_reduce(parts, group=group)
    if not pp:
        return (torch.where(cut, zero, sq).sum() + parts[0]).sqrt()
    staged = torch.stack([torch.where(local & ~cut, sq, zero).sum(), parts[1]])
    torch.distributed.all_reduce(staged, group=pipe_group)
    return (torch.where(cut | local, zero, sq).sum() + parts[0] + staged.sum()).sqrt()


class Optimizer:
    """Clip → Adam → weight decay → schedule → step, with MultiSteps
    accumulation, on a list of parameters updated in place."""

    def __init__(self, params: List[torch.Tensor], cfg: TrainConfig,
                 norm: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm):
        """``norm``: the global norm of a gradient list (the trainer's counts
        tensor-parallel parts once)."""
        self.params = list(params)
        self.cfg = cfg
        self.schedule = build_schedule(cfg)
        self.count = 0  # Adam updates done (optax's count)
        self.mini_step = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if cfg.update_freq > 1 else []
        self.norm = norm

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], grad_norm: Optional[torch.Tensor] = None,
             frozen: Sequence[int] = ()) -> None:
        """One call of the optax update (one mini-step under MultiSteps).
        ``grad_norm``, when given, is ``global_norm(grads)``. The parameters
        at the indices ``frozen`` take no update (their gradients still
        enter the norm and Adam's moments)."""
        k = self.cfg.update_freq
        if k <= 1:
            self._update(grads, grad_norm, frozen)
            return
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step == k - 1:
            self._update(self.acc, None, frozen)
            torch._foreach_zero_(self.acc)
        self.mini_step = (self.mini_step + 1) % k

    def _update(self, grads: List[torch.Tensor], grad_norm: Optional[torch.Tensor],
                frozen: Sequence[int] = ()) -> None:
        cfg = self.cfg
        if cfg.clip_norm > 0:
            norm = self.norm(grads) if grad_norm is None else grad_norm
            if not bool(norm < cfg.clip_norm):
                grads = torch._foreach_div(grads, norm)
                torch._foreach_mul_(grads, cfg.clip_norm)
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, sq)
        rate = self.schedule(self.count)
        self.count += 1
        den = torch._foreach_div(self.nu, _bias_correction(b2, self.count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.adam_eps)
        upd = torch._foreach_div(self.mu, _bias_correction(b1, self.count))
        torch._foreach_div_(upd, den)
        if cfg.weight_decay > 0:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, cfg.weight_decay))
        torch._foreach_mul_(upd, rate)
        params = self.params
        if frozen:
            keep = sorted(set(range(len(params))) - set(frozen))
            params, upd = [params[i] for i in keep], [upd[i] for i in keep]
        torch._foreach_sub_(params, upd)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu,
                "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for mine, saved in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                            (self.acc, state["acc"])):
            if len(mine) != len(saved):
                raise ValueError("optimizer state does not match the model's parameters")
            for a, b in zip(mine, saved):
                a.copy_(b)
