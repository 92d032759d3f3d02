"""Selective-attention gated image fusion of the port.

Port of the ``selective_attention`` branch of ``mm_s2ut/models/fusion.py``
(``SelectiveAttention``, ``GatedFusion``, ``FusionBlock``), with or
without the image pre-norm and the sigmoid gate (``image_pre_norm``,
``use_selective_gate``; the flagship sets both), and of
``modality_dropout``: each speech frame attends over the image features,
and the gate mixes the result into the speech stream (without the gate, a
plain residual add). The reference runs it as plain
einsums; so does the port (no kernel). In training mode the image, text
and attention-weight dropouts are Bernoulli (``ops/dropout.py``), as the
reference's ``nn.Dropout``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mm_s2ut_torch.models.layers import fp32_einsum, layer_norm, make_padding_bias
from mm_s2ut_torch.ops.dropout import BernoulliDropout, DropoutRng


class SelectiveAttention(nn.Module):
    """Single-head cross-attention with separate q/k/v input widths
    (the reference's FusionBlock builds it with one head); returns
    (output, attention map before dropout)."""

    def __init__(self, qdim: int, kdim: int, vdim: int, attn_dim: int,
                 intermediate_dim: int, output_dim: int, attn_drop: float = 0.0):
        super().__init__()
        self.q_proj = nn.Linear(qdim, attn_dim)
        self.k_proj = nn.Linear(kdim, attn_dim)
        self.v_proj = nn.Linear(vdim, intermediate_dim)
        self.out_proj = nn.Linear(intermediate_dim, output_dim)
        self.drop = BernoulliDropout(attn_drop)

    def forward(self, query, key, value, key_padding_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        q = self.q_proj(query) * self.q_proj.out_features ** -0.5
        logits = fp32_einsum("bqd,bkd->bqk", q, self.k_proj(key))
        if key_padding_mask is not None:
            logits = logits + make_padding_bias(key_padding_mask, torch.float32)[:, 0]
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bqk,bkd->bqd", self.drop(attn), self.v_proj(value))
        return self.out_proj(out), attn


class GatedFusion(nn.Module):
    """res = (1 - g)·text + g·attn_out, g = σ(W [attn_out; text]); without
    the gate, text + attn_out."""

    def __init__(self, embed_dim: int, use_gate: bool = True):
        super().__init__()
        if use_gate:
            self.gate = nn.Linear(2 * embed_dim, embed_dim)

    def forward(self, text: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "gate"):
            return text + attn_out
        gate = torch.sigmoid(self.gate(torch.cat([attn_out, text], dim=-1)))
        return (1.0 - gate) * text + gate * attn_out


class FusionBlock(nn.Module):
    """One image source → speech fusion: image pre-norm (optional), image
    and text dropout, selective attention, gated merge (of the dropped
    text)."""

    def __init__(self, embed_dim: int, image_dim: int, image_dropout: float = 0.0,
                 text_dropout: float = 0.0, attention_dropout: float = 0.0,
                 use_selective_gate: bool = True, image_pre_norm: bool = True):
        super().__init__()
        if image_pre_norm:
            self.image_pre_norm = layer_norm(image_dim)
        self.image_drop = BernoulliDropout(image_dropout)
        self.text_drop = BernoulliDropout(text_dropout)
        self.selective_attn = SelectiveAttention(
            qdim=embed_dim, kdim=image_dim, vdim=image_dim, attn_dim=embed_dim,
            intermediate_dim=embed_dim, output_dim=embed_dim, attn_drop=attention_dropout,
        )
        self.gated_fusion = GatedFusion(embed_dim, use_selective_gate)

    def forward(self, text: torch.Tensor, image: torch.Tensor,
                image_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if hasattr(self, "image_pre_norm"):
            image = self.image_pre_norm(image)
        image = self.image_drop(image)
        text = self.text_drop(text)
        out, _ = self.selective_attn(text, image, image, key_padding_mask=image_mask)
        return self.gated_fusion(text, out)


def modality_dropout(
    rng: DropoutRng,
    speech: torch.Tensor,
    images: Sequence[torch.Tensor],
    modality_dropout_p: float,
    audio_dropout_p: float,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """AV-HuBERT-style batch-level modality dropout (the reference's
    ``modality_dropout``): with probability ``modality_dropout_p`` one
    modality is zeroed for the whole batch — the audio stream with
    probability ``audio_dropout_p``, else every image stream. The two
    uniforms come from the run's CPU generator; both streams are scaled
    by 0/1 factors, as in the reference."""
    if modality_dropout_p <= 0.0:
        return speech, list(images)
    r1, r2 = torch.rand(2, generator=rng.seeds).tolist()
    drop = r1 < modality_dropout_p
    drop_audio = drop and r2 < audio_dropout_p
    drop_image = drop and not r2 < audio_dropout_p
    speech = speech * (0.0 if drop_audio else 1.0)
    return speech, [im * (0.0 if drop_image else 1.0) for im in images]
