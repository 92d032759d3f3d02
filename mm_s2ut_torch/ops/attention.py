"""Encoder self-attention: kernels A and G and their plain PyTorch twin.

Port of ``mm_s2ut/ops/attention.py``. :func:`flash_attention` runs the
hand-written CUDA kernel ``csrc/flash_attention.cu`` for a CUDA tensor
and :func:`reference_attention` (the reference's XLA formulation, without
dropout) for a CPU tensor — the same split the reference makes between
its Pallas kernels on the TPU and ``reference_attention`` on the CPU.
Nothing falls back: a CUDA input the kernel does not take raises.

Kernel A is the dense tile loop, with the causal/window mask applied
in-kernel when asked; kernel G (:func:`causal_skip_attention`, reached
through ``flash_attention(..., causal=True, block_k=...)``) visits only
the key tiles that meet each query tile's band. Both equal
:func:`reference_attention` on every row, including the padded rows
whose whole band is padding (see ``csrc/flash_attention.cu``).
"""
from __future__ import annotations

from typing import Optional

import torch

from mm_s2ut_torch.ops import _build

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)


def reference_attention(
    q: torch.Tensor,  # (B, Tq, H, D), pre-scaled
    k: torch.Tensor,  # (B, Tk, H, D)
    v: torch.Tensor,  # (B, Tk, H, D)
    bias: Optional[torch.Tensor] = None,  # (B, 1|H, Tq|1, Tk) additive
    causal: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """softmax(q.kᵀ + bias).v with fp32 logits and softmax; weights are
    cast to q's dtype before the second product, as in the reference.
    ``causal`` REPLACES the logits of keys after the query (and, with
    ``window`` > 0, at or before query − window) by −1e9; query and key
    positions both start at 0."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        allowed = kpos <= qpos
        if window > 0:
            allowed = allowed & (kpos > qpos - window)
        logits = torch.where(allowed, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _padding_bias(key_padding_mask, B, S, device) -> torch.Tensor:
    bias = torch.zeros((B, S), dtype=torch.float32, device=device)
    return bias if key_padding_mask is None else bias.masked_fill(key_padding_mask, NEG_INF)


def _launch(entry: str, q, k, v, bias, scale: float, causal: bool, window: int) -> torch.Tensor:
    """Check a CUDA input and launch kernel A or G (``entry``)."""
    B, Tq, H, D = q.shape
    S = k.shape[1]
    if q.device.type != "cuda":
        raise RuntimeError(f"{entry}: unsupported device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.shape != v.shape:
        raise ValueError("q, k, v must share one dtype, and k, v one shape")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 or t.device != q.device for t in (k, v)) or q.stride(-1) != 1:
        raise ValueError("flash_attention: q, k, v must share a device and a dense head dim")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = getattr(_build.library(), entry)(
            _build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, Tq, S, H, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), int(window), _build.stream_ptr(q.device),
        )
    _build.check(rc, entry)
    return out


def causal_skip_attention(
    q: torch.Tensor,  # (B, Tq, H, D), Tq <= S
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """Kernel G: causal (and optionally windowed) attention that computes
    only the key tiles meeting each query tile's band — the reference's
    ``_flash_call(..., causal=True, block_k=...)``, which also takes
    Tq <= S (query t sits at position t)."""
    B, Tq, H, D = q.shape
    S = k.shape[1]
    if Tq > S:
        raise ValueError(f"causal_skip_attention: Tq={Tq} > S={S}")
    scale = D ** -0.5 if scale is None else scale
    bias = _padding_bias(key_padding_mask, B, S, q.device)
    if q.device.type == "cpu":
        return reference_attention(q * scale, k, v, bias[:, None, None, :], True, window)
    out = _launch("mm_flash_attention_causal_skip", q, k, v, bias, scale, True, window)
    causal_skip_attention.launches += 1
    return out


causal_skip_attention.launches = 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, Tk) True = pad
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    dropout_rate: float = 0.0,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """(B, Tq, H, D) attention; ``scale`` defaults to D^-1/2. ``causal``
    (+ ``window``) masks in-kernel and needs Tq == Tk, as the reference's
    ``flash_attention``. ``block_k=None`` runs kernel A over every key
    tile; an integer runs kernel G, the reference's opt-in into its
    key-block-skipping kernel. G's key tile on the card is the kernel's
    own (64 keys for D <= 64, 32 for D = 128), so the integer selects the
    kernel and its value is not read. Attention dropout (training, with
    the backward kernel H) is not ported and raises."""
    B, Tq, H, D = q.shape
    S = k.shape[1]
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout is not ported")
    if causal and Tq != S:
        raise ValueError("causal flash attention requires Tq == Tk")
    if window and not causal:
        raise ValueError("window needs causal=True")
    if causal and block_k is not None:
        return causal_skip_attention(q, k, v, key_padding_mask, scale, window)
    scale = D ** -0.5 if scale is None else scale
    bias = _padding_bias(key_padding_mask, B, S, q.device)
    if q.device.type == "cpu":
        return reference_attention(q * scale, k, v, bias[:, None, None, :], causal, window)
    out = _launch("mm_flash_attention", q, k, v, bias, scale, causal, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
