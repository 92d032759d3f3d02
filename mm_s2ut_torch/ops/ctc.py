"""CTC loss and greedy decoding of the port (the CTC and multitask heads).

Port of ``mm_s2ut/ops/ctc.py``: the alpha recursion over the extended
label sequence (a blank between labels and at both ends, 2L+1 states) in
the log semiring, vectorised over the batch and the states and looped
over time. Every state starts at ``NEG_INF`` (-1e30, not -inf), and a
row stops moving past its own length, so a row whose labels cannot fit
in its frames gives a loss of about 1e30 rather than ``inf``; PyTorch's
``F.ctc_loss`` gives ``inf`` there (and its ``zero_infinity`` changes the
gradient), so it is not used. Plain PyTorch: each step is a few
elementwise ops over (B, 2L+1), and autograd takes the backward.

:func:`logaddexp` differentiates as JAX's ``jnp.logaddexp`` does: each
operand's gradient is exp(operand − output), the output as rounded. The
two agree wherever the sum is representable; at -1e30 (an infeasible
row, or the states no path reaches yet) the rounded output equals its
operands, so JAX passes the whole gradient to both, where
``torch.logaddexp`` would split it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) with JAX's derivative."""
    return _LogAddExp.apply(a, b)


def ctc_loss(
    logits: torch.Tensor,  # (B, T, V) unnormalised
    logit_lengths: torch.Tensor,  # (B,)
    labels: torch.Tensor,  # (B, L) padded with any id
    label_lengths: torch.Tensor,  # (B,)
    blank_id: int = 0,
) -> torch.Tensor:
    """Per-row negative log likelihood, (B,) fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    B, T, _ = logp.shape
    labels = labels.long()
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logp.device
    ext = torch.full((B, S), blank_id, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    # From s-2 only onto a label that differs from the one two states back.
    can_skip = torch.zeros((B, S), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != blank_id) & (ext[:, 2:] != ext[:, :-2])
    neg = torch.full((B, S), NEG_INF, device=dev)
    lab_len = label_lengths.to(dev)
    first = torch.where(lab_len > 0, logp[:, 0].gather(1, ext[:, 1:2])[:, 0],
                        torch.full((B,), NEG_INF, device=dev))
    alpha = torch.cat([logp[:, 0, blank_id:blank_id + 1], first[:, None], neg[:, 2:]], dim=1)
    live = torch.arange(T, device=dev)[:, None] < logit_lengths.to(dev)[None, :]  # (T, B)
    emits = logp.gather(2, ext[:, None, :].expand(B, T, S))  # (B, T, S)
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip, torch.cat([neg[:, :2], alpha[:, :-2]], dim=1), neg)
        new = logaddexp(logaddexp(alpha, prev1), prev2) + emits[:, t]
        alpha = torch.where(live[t][:, None], new, alpha)
    end = 2 * lab_len.long()  # the final blank
    last_blank = alpha.gather(1, end[:, None])[:, 0]
    last_label = alpha.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    last_label = torch.where(lab_len > 0, last_label, torch.full_like(last_label, NEG_INF))
    return -logaddexp(last_blank, last_label)


def ctc_greedy_decode(
    logits: torch.Tensor,  # (B, T, V)
    logit_lengths: torch.Tensor,  # (B,)
    blank_id: int = 0,
    pad_id: int = -1,
) -> torch.Tensor:
    """Argmax per frame, repeats merged, blanks dropped: (B, T) with the
    kept ids first in frame order and ``pad_id`` after them."""
    ids = logits.argmax(-1)
    B, T = ids.shape
    prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype, device=ids.device), ids[:, :-1]], 1)
    valid = (ids != blank_id) & (ids != prev)
    valid &= torch.arange(T, device=ids.device)[None, :] < logit_lengths.to(ids.device)[:, None]
    # Stable compaction: the kept frames first, each group in frame order.
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    collapsed = ids.gather(1, order)
    keep = valid.gather(1, order)
    return torch.where(keep, collapsed, torch.full_like(collapsed, pad_id))
