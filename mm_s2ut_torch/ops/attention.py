"""Encoder self-attention: kernels A, G and H and their plain PyTorch twins.

Port of ``mm_s2ut/ops/attention.py``. :func:`flash_attention` is a
``torch.autograd.Function``: for a CUDA tensor its forward runs the
hand-written kernel A (or G with ``block_k``) and its backward kernel H,
all on the tensor cores and all reading 16-byte-aligned rows: in fp32
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` (3xTF32:
every operand split into two tf32 halves, three products each), in bf16
``csrc/flash_attention_mma.cu`` and ``csrc/flash_attention_bwd_mma.cu``,
which round the softmax weights (times the dropout factor) and dS to bf16
before their products; for a CPU
tensor the forward is :func:`reference_attention` (the reference's XLA
formulation) and the backward :func:`reference_attention_bwd` (H's
formulas, ``attention.py:385-392``) — the same split the reference makes
between its Pallas kernels on the TPU and the XLA path on the CPU.
Nothing falls back: a CUDA input the kernels do not take raises.

Kernel A is the dense tile loop, with the causal/window mask applied
in-kernel when asked; kernel G (:func:`causal_skip_attention`, reached
through ``flash_attention(..., causal=True, block_k=...)``) visits only
the key tiles that meet each query tile's band. Both equal
:func:`reference_attention` on every row, including the padded rows
whose whole band is padding (see ``csrc/flash_attention.cu``).

Attention dropout (training) drops softmax weights by the reference's
counter-based hash (:func:`dropout_keep`) of the absolute coordinates
(b·H + h, query t, key s) and a per-call uint32 seed, so A, G, H and the
twins rebuild the same mask from the seed alone; nothing is stored. ``b``
is the row of the global batch: a data-parallel process that holds rows
``dropout_row0`` onwards passes that offset, and draws the masks that
rows of one process over the whole batch would draw (JAX's jit sees the
global batch). Likewise ``h`` is the layer's global head: a
tensor-parallel rank that holds heads [h0, h0 + H) of ``h_total`` passes
the pair, and its local head j hashes as (row0 + b)·h_total + h0 + j; the
defaults (H, 0) are the unsharded call. The
hash is computed bit-exactly on uint32 values held in int64 (torch has no
uint32 right shift on the CPU): every product is masked back to 32 bits,
and int64 multiplication wraps, which keeps the low 32 bits right.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from mm_s2ut_torch.ops import _build

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)

_H1, _H2, _H3 = 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """The reference's murmur3-style finalizer on uint32 values held in an
    int64 tensor (each in [0, 2^32))."""
    x = x ^ (x >> 16)
    x = (x * _H1) & _M32
    x = x ^ (x >> 13)
    x = (x * _H2) & _M32
    return x ^ (x >> 16)


def _keep_from_hash(h: torch.Tensor, rate: float) -> torch.Tensor:
    """Top 24 bits → uniform [0, 1) in float32, kept where ≥ the rate
    rounded to float32 (JAX's weak typing compares in float32)."""
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u >= float(np.float32(rate))


def dropout_keep(
    bh: torch.Tensor,  # (...,) batch·head coordinate, any integer dtype
    qpos: torch.Tensor,  # (...,) absolute query position
    kpos: torch.Tensor,  # (...,) absolute key position
    seed: int,  # uint32 per-call seed
    rate: float,
) -> torch.Tensor:
    """Boolean keep-mask broadcast over the operands' common shape, equal
    bit for bit to the reference's ``dropout_keep``."""
    h = (
        ((qpos.to(torch.int64) * _H3) & _M32)
        ^ ((kpos.to(torch.int64) * _H1) & _M32)
        ^ ((bh.to(torch.int64) * _H2) & _M32)
        ^ (int(seed) & _M32)
    )
    return _keep_from_hash(_mix(h), rate)


def attention_keep(B: int, H: int, Tq: int, S: int, seed: int, rate: float, device,
                   row0: int = 0, h_total: Optional[int] = None, h0: int = 0) -> torch.Tensor:
    """(B, H, Tq, S) keep-mask of attention dropout at ((row0 + b)·h_total
    + h0 + h, t, s): heads [h0, h0 + H) of a layer of ``h_total`` (H by
    default)."""
    h_total = H if h_total is None else h_total
    bh = ((row0 + torch.arange(B, device=device))[:, None] * h_total + h0
          + torch.arange(H, device=device)[None, :])
    return dropout_keep(
        bh[:, :, None, None], torch.arange(Tq, device=device)[None, None, :, None],
        torch.arange(S, device=device)[None, None, None, :], seed, rate,
    )


def _check_dropout(dropout_rate: float, dropout_seed: Optional[int]) -> None:
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the accumulation dtype: fp32, or fp64 for fp64 inputs
    (``torch.autograd.gradcheck`` of the twins)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _causal_allowed(Tq: int, S: int, window: int, device) -> torch.Tensor:
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    allowed = kpos <= qpos
    if window > 0:
        allowed = allowed & (kpos > qpos - window)
    return allowed


def reference_attention(
    q: torch.Tensor,  # (B, Tq, H, D), pre-scaled
    k: torch.Tensor,  # (B, Tk, H, D)
    v: torch.Tensor,  # (B, Tk, H, D)
    bias: Optional[torch.Tensor] = None,  # (B, 1|H, Tq|1, Tk) additive
    causal: bool = False,
    window: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_row0: int = 0,
    h_total: Optional[int] = None,
    h0: int = 0,
) -> torch.Tensor:
    """softmax(q.kᵀ + bias).v with fp32 logits and softmax; weights are
    cast to q's dtype before the second product, as in the reference.
    ``causal`` REPLACES the logits of keys after the query (and, with
    ``window`` > 0, at or before query − window) by −1e9; query and key
    positions both start at 0. ``dropout_rate`` > 0 zeroes the weights the
    hash drops (seed ``dropout_seed``, batch rows from ``dropout_row0``, q's
    heads the layer's [h0, h0 + H) of ``h_total``) and scales the rest by
    1/(1 − rate)."""
    _check_dropout(dropout_rate, dropout_seed)
    logits = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k))
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        allowed = _causal_allowed(q.shape[1], k.shape[1], window, q.device)
        logits = torch.where(allowed, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        B, Tq, H, _ = q.shape
        keep = attention_keep(B, H, Tq, k.shape[1], dropout_seed, dropout_rate, q.device,
                              dropout_row0, h_total, h0)
        # 1 - rate rounded to the weights' dtype, as JAX's weak typing does.
        denom = torch.tensor(1.0 - dropout_rate, dtype=weights.dtype, device=q.device)
        weights = torch.where(keep, weights, torch.zeros_like(weights)) / denom
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def reference_attention_bwd(
    q: torch.Tensor,  # (B, Tq, H, D), NOT pre-scaled
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, S) additive key bias, f32
    g: torch.Tensor,  # (B, Tq, H, D) gradient of the output
    scale: float,
    causal: bool = False,
    window: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_row0: int = 0,
    h_total: Optional[int] = None,
    h0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain twin of kernel H, in H's formulas (the reference's
    ``_attn_bwd_kernel``): recompute W = softmax(scale·q.kᵀ + bias [causal])
    in fp32, regenerate the dropout mask M, then
      dW = (dO·Vᵀ) ⊙ M/(1−p),   dS = W ⊙ (dW − Σₖ dW W) ⊙ A,
      dQ = scale·dS·K,   dK = scale·dSᵀ·Q,   dV = (W ⊙ M/(1−p))ᵀ·dO,
      dbias = Σ over heads and queries of dS,
    with A the causal/window band (1 everywhere without ``causal``). A is
    the reference's own VJP (``jax.vjp`` of ``reference_attention``, its
    default backward): a logit replaced by −1e9 is a constant. JAX's Pallas
    H leaves A out, which differs only on rows whose whole band is masked,
    where W is uniform over all keys (ROADMAP §3).
    Returns (dq in q's dtype, dk and dv accumulated in fp32 then cast to
    k's and v's dtypes, dbias (B, S) fp32)."""
    _check_dropout(dropout_rate, dropout_seed)
    B, Tq, H, _ = q.shape
    S = k.shape[1]
    qf, kf, vf, gf = (_acc(t) for t in (q, k, v, g))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale + bias.float()[:, None, None, :]
    if causal:
        allowed = _causal_allowed(Tq, S, window, q.device)
        logits = torch.where(allowed, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    dP = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    if dropout_rate > 0.0:
        keep = attention_keep(B, H, Tq, S, dropout_seed, dropout_rate, q.device, dropout_row0,
                              h_total, h0)
        mscale = torch.where(keep, 1.0 / (1.0 - dropout_rate), 0.0)
        dW, wd = dP * mscale, w * mscale
    else:
        dW, wd = dP, w
    dS = w * (dW - (dW * w).sum(-1, keepdim=True))
    if causal:  # a replaced logit is a constant: no gradient reaches q, k or the bias there
        dS = torch.where(allowed, dS, torch.zeros_like(dS))
    dq = torch.einsum("bhqk,bkhd->bqhd", dS, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dS, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", wd, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dS.sum(dim=(1, 2))


def padding_bias(key_padding_mask: Optional[torch.Tensor], B: int, S: int, device) -> torch.Tensor:
    """(B, S) f32 additive key bias of a (B, S) padding mask (True = pad):
    0 on a valid key, −1e9 on a padded one; zeros without a mask. The
    encoder builds it once per forward for all its layers
    (:func:`flash_attention_biased`)."""
    bias = torch.zeros((B, S), dtype=torch.float32, device=device)
    return bias if key_padding_mask is None else bias.masked_fill(key_padding_mask, NEG_INF)


def _check_cuda(name: str, q, k, v) -> None:
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.shape != v.shape:
        raise ValueError("q, k, v must share one dtype, and k, v one shape")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[3]} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 or t.device != q.device for t in (k, v)) or q.stride(-1) != 1:
        raise ValueError("flash_attention: q, k, v must share a device and a dense head dim")
    if not all(_rows_aligned(t) for t in (q, k, v)):
        # the kernels copy each row as 16-byte chunks
        raise ValueError(f"{name}: rows must be 16-byte aligned (data pointer and strides "
                         "multiples of 16 bytes)")


def _rows_aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * t.element_size() % 16 == 0 for i in range(3) if t.shape[i] > 1)


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def _dropout_args(rate: float, seed: Optional[int], row0: int, H: int,
                  h_total: Optional[int] = None, h0: int = 0):
    """rate, seed, the hash's (b, h) row offset and the global heads
    (h_total, h0) as the C entries take them."""
    h_total = H if h_total is None else int(h_total)
    if not 0 <= h0 <= h_total - H:
        raise ValueError(f"flash_attention: heads [{h0}, {h0 + H}) outside the layer's {h_total}")
    if rate <= 0.0:
        return 0.0, 0, 0, h_total, int(h0)
    return float(rate), int(seed) & _M32, (int(row0) * h_total) & _M32, h_total, int(h0)


def _device_context(device):
    """``torch.cuda.device(device)`` where ``device`` is not the current
    card (a launch goes to the current one), else no context."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch(entry: str, q, k, v, bias, scale: float, causal: bool, window: int,
            rate: float, seed: Optional[int], stats: Optional[torch.Tensor],
            row0: int = 0, h_total: Optional[int] = None, h0: int = 0) -> torch.Tensor:
    """Check a CUDA input and launch kernel A or G (``entry``), counting the
    launch on :func:`flash_attention` or :func:`causal_skip_attention`;
    with ``stats`` (2, B·H, Tq) f32, also write each row's softmax max and
    denominator for kernel H. ``row0``: the dropout hash's first batch row;
    ``h_total``, ``h0``: its global heads (:func:`attention_keep`)."""
    B, Tq, H, D = q.shape
    S = k.shape[1]
    _check_cuda(entry, q, k, v)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    with _device_context(q.device):
        rc = getattr(_build.library(), entry)(
            _build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, Tq, S, H, D, *_strides(q, k, v),
            scale, causal, window, *_dropout_args(rate, seed, row0, H, h_total, h0),
            None if stats is None else stats[0].data_ptr(),
            None if stats is None else stats[1].data_ptr(),
            _build.stream_ptr(q.device),
        )
    _build.check(rc, entry)
    counter = causal_skip_attention if entry == _SKIP_ENTRY else flash_attention
    counter.launches += 1
    return out


def flash_attention_bwd(q, k, v, bias, stats, g, scale: float, causal: bool, window: int,
                        dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                        dropout_row0: int = 0, h_total: Optional[int] = None, h0: int = 0):
    """Kernel H: the attention backward on the card from the forward's
    inputs and row statistics (``stats``: max and denominator of each row's
    softmax, written by A or G). Returns (dq in q's dtype, dk, dv cast from
    fp32 to k's dtype, dbias (B, S) f32). The softmax VJP's row term Δᵢ =
    Σₖ Pᵢₖ·dWᵢₖ is the kernel's own, in fp32 (its (B·H, Tq) buffer is
    scratch here)."""
    B, Tq, H, D = q.shape
    S = k.shape[1]
    _check_cuda("flash_attention_bwd", q, k, v)
    if g.shape != q.shape:
        raise ValueError("flash_attention_bwd: dO must have q's shape")
    g = g.to(q.dtype).contiguous()
    delta = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    dbias = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with _device_context(q.device):
        rc = _build.library().mm_flash_attention_bwd(
            _build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), g.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
            B, Tq, S, H, D, *_strides(q, k, v), scale, causal, window,
            *_dropout_args(dropout_rate, dropout_seed, dropout_row0, H, h_total, h0),
            _build.stream_ptr(q.device),
        )
    _build.check(rc, "mm_flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk.to(k.dtype), dv.to(v.dtype), dbias.sum(1)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward: A or G (CUDA) / :func:`reference_attention` (CPU), saving
    q, k, v, the key bias and, on the card, the row statistics. Backward: H
    (CUDA) / :func:`reference_attention_bwd` (CPU). The key bias gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, window, rate, seed, row0, heads, entry):
        ctx.cfg = (scale, causal, window, rate, seed, row0, heads)
        with torch.autocast(q.device.type, enabled=False):
            if q.device.type == "cpu":
                out = reference_attention(q * scale, k, v, bias[:, None, None, :], causal,
                                          window, rate, seed, row0, *heads)
                stats = None
            else:
                stats = None
                if any(ctx.needs_input_grad[:3]):
                    B, Tq, H, _ = q.shape
                    stats = torch.empty((2, B * H, Tq), dtype=torch.float32, device=q.device)
                out = _launch(entry, q, k, v, bias, scale, causal, window, rate, seed, stats,
                              row0, *heads)
        ctx.save_for_backward(q, k, v, bias, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, stats = ctx.saved_tensors
        scale, causal, window, rate, seed, row0, heads = ctx.cfg
        with torch.autocast(q.device.type, enabled=False):
            if q.device.type == "cpu":
                dq, dk, dv, _ = reference_attention_bwd(q, k, v, bias, g, scale, causal, window,
                                                        rate, seed, row0, *heads)
            else:
                dq, dk, dv, _ = flash_attention_bwd(q, k, v, bias, stats, g, scale, causal,
                                                    window, rate, seed, row0, *heads)
        return dq, dk, dv, None, None, None, None, None, None, None, None, None


_SKIP_ENTRY = "mm_flash_attention_causal_skip"


def causal_skip_attention(
    q: torch.Tensor,  # (B, Tq, H, D), Tq <= S
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    scale: Optional[float] = None,
    window: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_row0: int = 0,
    h_total: Optional[int] = None,
    h0: int = 0,
) -> torch.Tensor:
    """Kernel G: causal (and optionally windowed) attention that computes
    only the key tiles meeting each query tile's band — the reference's
    ``_flash_call(..., causal=True, block_k=...)``, which also takes
    Tq <= S (query t sits at position t). Differentiable through H."""
    Tq, S = q.shape[1], k.shape[1]
    if Tq > S:
        raise ValueError(f"causal_skip_attention: Tq={Tq} > S={S}")
    bias = padding_bias(key_padding_mask, q.shape[0], S, q.device)
    return _attend(_SKIP_ENTRY, q, k, v, bias, scale, True, window, dropout_rate, dropout_seed,
                   dropout_row0, h_total, h0)


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
    dropout_seed: Optional[int] = None,
    dropout_row0: int = 0,
    h_total: Optional[int] = None,
    h0: int = 0,
) -> torch.Tensor:
    """(B, Tq, H, D) attention; ``scale`` defaults to D^-1/2. ``causal``
    (+ ``window``) masks in-kernel and needs Tq == Tk, as the reference's
    ``flash_attention``. ``block_k=None`` runs kernel A over every key
    tile; an integer runs kernel G, the reference's opt-in into its
    key-block-skipping kernel. G's key tile on the card is the kernel's
    own (64 keys for D <= 64, 32 for D = 128), so the integer selects the
    kernel and its value is not read. ``dropout_rate`` > 0 drops softmax
    weights by the hash of (b·H + h, t, s) and the uint32 ``dropout_seed``,
    which the caller varies per call; ``dropout_row0`` is the global batch
    row of q's first row (data parallelism); q's heads are the layer's
    [``h0``, h0 + H) of ``h_total`` (tensor parallelism; H by default).
    Differentiable: the backward is kernel H on the card."""
    bias = padding_bias(key_padding_mask, q.shape[0], k.shape[1], q.device)
    return flash_attention_biased(q, k, v, bias, scale, causal, window, dropout_rate, block_k,
                                  dropout_seed, dropout_row0, h_total, h0)


flash_attention.launches = 0


def flash_attention_biased(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, Tk) f32 additive key bias, :func:`padding_bias`
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,
    dropout_rate: float = 0.0,
    block_k: Optional[int] = None,
    dropout_seed: Optional[int] = None,
    dropout_row0: int = 0,
    h_total: Optional[int] = None,
    h0: int = 0,
) -> torch.Tensor:
    """:func:`flash_attention` with the key bias already built, as the
    encoder hands one bias to all its layers."""
    S = k.shape[1]
    if causal and q.shape[1] != S:
        raise ValueError("causal flash attention requires Tq == Tk")
    if window and not causal:
        raise ValueError("window needs causal=True")
    entry = _SKIP_ENTRY if causal and block_k is not None else "mm_flash_attention"
    return _attend(entry, q, k, v, bias, scale, causal, window, dropout_rate, dropout_seed,
                   dropout_row0, h_total, h0)


def _attend(entry, q, k, v, bias, scale, causal, window, rate, seed, row0=0, h_total=None, h0=0):
    _check_dropout(rate, seed)
    scale = q.shape[3] ** -0.5 if scale is None else scale
    heads = (q.shape[2] if h_total is None else int(h_total), int(h0))
    return _FlashAttention.apply(q, k, v, bias, float(scale), causal, window, float(rate),
                                 seed, int(row0), heads, entry)
