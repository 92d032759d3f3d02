"""Image fusion of the port: the fusion blocks, the cross-modal towers and
the Q-Former.

Port of ``mm_s2ut/models/fusion.py``: ``SelectiveAttention``,
``MultimodalAttention`` (an attention with a learned extra key/value
column, ``add_bias_kv``, whose query is the speech stream or, with
``is_merge_text_img``, [speech; image]), ``GatedFusion`` and
``FusionBlock`` (image pre-norm, image and text dropout, one of the two
attentions, the sigmoid gate or a plain residual add), ``modality_dropout``,
``CrossModalLayer`` (self- and cross-attention in either order, pre- or
post-norm, then the FFN), ``ExternalMultimodalEncoder`` and
``BridgeTowerEncoder`` (towers over the encoder's per-layer states) and
``QFormer`` (learned queries over the speech, then the image stream). The
reference runs all of them as plain einsums through ``MultiHeadAttention``'s
dense path; so does the port (no kernel). In training mode the image,
text, attention-weight and residual dropouts are Bernoulli
(``ops/dropout.py``), as the reference's ``nn.Dropout``.

Two reference behaviours are kept: the towers' FFN takes no dropout inside
(the reference hands ``dropout`` to a ``FeedForward`` that reads only its
activation dropout, 0), and the shared residual LayerNorms of a tower apply
at every level.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mm_s2ut_torch.models.layers import (FeedForward, MultiHeadAttention, compute_dtype,
                                         fp32_einsum, layer_norm, make_padding_bias)
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


def _kpm_bias(key_padding_mask: Optional[torch.Tensor], like: torch.Tensor):
    """(B, Tk) bool (True = pad) → (B, 1, 1, Tk) additive −1e9 bias in the
    compute dtype of ``like``, or None without a mask."""
    if key_padding_mask is None:
        return None
    return make_padding_bias(key_padding_mask, compute_dtype(like))


class MultimodalAttention(nn.Module):
    """Image cross-attention whose keys and values are the image stream
    with a learned key ``bias_k`` and value ``bias_v`` appended as one more
    column (the reference's ``add_bias_kv``, which its fusion block always
    sets; the column is never masked). The query is ``text`` or, with
    ``is_merge_text_img``, [text; image]; returns (output, the query's
    padding mask)."""

    FLAX_LEAVES = ("bias_k", "bias_v")  # convert.from_flax takes them as they are

    def __init__(self, embed_dim: int, kdim: int, num_heads: int = 1, dropout: float = 0.0):
        super().__init__()
        self.attn = MultiHeadAttention(embed_dim, num_heads, dropout, kdim=kdim)
        self.bias_k = nn.Parameter(torch.zeros(1, 1, kdim))
        self.bias_v = nn.Parameter(torch.zeros(1, 1, kdim))

    def forward(self, text: torch.Tensor, text_mask: Optional[torch.Tensor], img: torch.Tensor,
                img_mask: Optional[torch.Tensor] = None, is_merge_text_img: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        B, T2 = img.shape[:2]
        query, query_mask = text, text_mask
        if is_merge_text_img:
            if img.shape[-1] != text.shape[-1]:
                raise ValueError("merge_text_image requires matching dims")
            query = torch.cat([text, img.to(text.dtype)], dim=1)
            if text_mask is not None:
                query_mask = torch.cat([text_mask, text_mask.new_zeros((B, T2))], dim=1)
        key = torch.cat([img, self.bias_k.to(img.dtype).expand(B, 1, -1)], dim=1)
        value = torch.cat([img, self.bias_v.to(img.dtype).expand(B, 1, -1)], dim=1)
        kpm = None if img_mask is None else torch.cat([img_mask, img_mask.new_zeros((B, 1))], 1)
        return self.attn.dense(query, key, _kpm_bias(kpm, query), value), query_mask


class FusionBlock(nn.Module):
    """One image source → speech fusion: image pre-norm (optional), image
    and text dropout, selective or multimodal attention
    (``attention_type``), gated merge of the dropped text (with
    ``is_merge_text_img``, of [text; image]). Returns (fused, its padding
    mask): the text's, or with the merge [text_mask; zeros]."""

    def __init__(self, embed_dim: int, image_dim: int, image_dropout: float = 0.0,
                 text_dropout: float = 0.0, attention_dropout: float = 0.0,
                 use_selective_gate: bool = True, image_pre_norm: bool = True,
                 attention_type: str = "selective_attention", is_merge_text_img: bool = False):
        super().__init__()
        if image_pre_norm:
            self.image_pre_norm = layer_norm(image_dim)
        self.image_drop = BernoulliDropout(image_dropout)
        self.text_drop = BernoulliDropout(text_dropout)
        self.is_merge_text_img = is_merge_text_img
        if attention_type == "selective_attention":
            self.selective_attn = SelectiveAttention(
                qdim=embed_dim, kdim=image_dim, vdim=image_dim, attn_dim=embed_dim,
                intermediate_dim=embed_dim, output_dim=embed_dim, attn_drop=attention_dropout,
            )
        elif attention_type == "multimodal_attention":
            self.multimodal_attn = MultimodalAttention(embed_dim, image_dim,
                                                       dropout=attention_dropout)
        else:
            raise ValueError(f"unknown attention_type {attention_type!r}")
        self.gated_fusion = GatedFusion(embed_dim, use_selective_gate)

    def forward(self, text: torch.Tensor, text_mask: Optional[torch.Tensor], image: torch.Tensor,
                image_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if hasattr(self, "image_pre_norm"):
            image = self.image_pre_norm(image)
        image = self.image_drop(image)
        text = self.text_drop(text)
        if hasattr(self, "selective_attn"):
            out, _ = self.selective_attn(text, image, image, key_padding_mask=image_mask)
            return self.gated_fusion(text, out), text_mask
        out, mask = self.multimodal_attn(text, text_mask, image, image_mask,
                                         self.is_merge_text_img)
        if self.is_merge_text_img:
            text = torch.cat([text, image.to(text.dtype)], dim=1)
        return self.gated_fusion(text, out), mask


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


class CrossModalLayer(nn.Module):
    """Self-attention over m1 and cross-attention from m1 to m2, in either
    order (``self_attention_first``), pre-norm (``norm_first``) or
    post-norm, then the FFN (tanh gelu by default, no dropout inside);
    ``dropout`` is the attention weights' and each branch's output's."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int, dropout: float = 0.0,
                 activation: str = "gelu", norm_first: bool = False,
                 self_attention_first: bool = True):
        super().__init__()
        self.norm_first, self.self_attention_first = norm_first, self_attention_first
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
        self.cross_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
        self.norm1 = layer_norm(embed_dim)
        self.norm2 = layer_norm(embed_dim)
        self.norm3 = layer_norm(embed_dim)
        self.ffn = FeedForward(embed_dim, ffn_dim, 0.0, activation)
        self.drop = BernoulliDropout(dropout)

    def forward(self, m1: torch.Tensor, m2: torch.Tensor,
                m1_key_padding_mask: Optional[torch.Tensor] = None,
                m2_key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        def sa(h):
            return self.drop(self.self_attn.dense(h, h, _kpm_bias(m1_key_padding_mask, h)))

        def ca(h):
            return self.drop(self.cross_attn.dense(h, m2, _kpm_bias(m2_key_padding_mask, h)))

        branches = [(self.norm1, sa), (self.norm2, ca)]
        if not self.self_attention_first:
            branches.reverse()
        branches.append((self.norm3, lambda h: self.drop(self.ffn(h))))
        x = m1
        for norm, fn in branches:
            x = x + fn(norm(x)) if self.norm_first else norm(x + fn(x))
        return x


class ExternalMultimodalEncoder(nn.Module):
    """``num_layers`` cross-modal layers; layer i reads the speech state
    m1[i], from i = 1 on as ``residual_norm(m1[i] + previous output)`` (one
    LayerNorm shared by every level), and attends to m2[i]."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int, num_layers: int = 6,
                 dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        if num_layers > 1:  # the reference calls it, and so builds it, only from layer 1
            self.residual_norm = layer_norm(embed_dim)
        for i in range(num_layers):
            self.add_module(f"layer{i}", CrossModalLayer(embed_dim, num_heads, ffn_dim, dropout))

    def forward(self, m1: Sequence[torch.Tensor], m2: Sequence[torch.Tensor],
                m1_key_padding_mask: Optional[torch.Tensor] = None,
                m2_key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        assert len(m1) == len(m2) == self.num_layers
        out = None
        for i in range(self.num_layers):
            x = m1[i] if out is None else self.residual_norm(m1[i] + out)
            out = getattr(self, f"layer{i}")(x, m2[i], m1_key_padding_mask, m2_key_padding_mask)
        return out


class BridgeTowerEncoder(nn.Module):
    """Bidirectional co-attention: at each level both streams take a
    LayerNormed residual of their previous fused state (``residual_norm1``
    and ``residual_norm2``, shared by every level), then m1 attends to m2
    and m2 to the *updated* m1, masks swapped. Returns (f1, f2)."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int, num_layers: int = 6,
                 dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.residual_norm1 = layer_norm(embed_dim)
        self.residual_norm2 = layer_norm(embed_dim)
        for i in range(num_layers):
            for m in ("m1", "m2"):
                self.add_module(f"layer_{m}_{i}",
                                CrossModalLayer(embed_dim, num_heads, ffn_dim, dropout))

    def forward(self, m1: Sequence[torch.Tensor], m2: Sequence[torch.Tensor],
                m1_key_padding_mask: Optional[torch.Tensor] = None,
                m2_key_padding_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        assert len(m1) == len(m2) == self.num_layers
        f1 = f2 = None
        for i in range(self.num_layers):
            f1 = self.residual_norm1(m1[i] if f1 is None else m1[i] + f1)
            f2 = self.residual_norm2(m2[i] if f2 is None else m2[i] + f2)
            f1 = getattr(self, f"layer_m1_{i}")(f1, f2, m1_key_padding_mask, m2_key_padding_mask)
            f2 = getattr(self, f"layer_m2_{i}")(f2, f1, m2_key_padding_mask, m1_key_padding_mask)
        return f1, f2


class QFormer(nn.Module):
    """Learned-query bottleneck: ``num_queries`` embeddings (N(0, 0.02)
    at initialisation), tiled over the batch, pass ``num_query_layers``
    cross-modal layers over the speech stream m1, then
    ``num_multimodal_layers`` over the image stream m2; the queries'
    self-attention has no mask."""

    FLAX_LEAVES = ("query_embedding",)

    def __init__(self, embed_dim: int, num_heads: int = 12, ffn_dim: int = 3072,
                 num_queries: int = 32, num_query_layers: int = 4, num_multimodal_layers: int = 2,
                 dropout: float = 0.0, self_attention_first: bool = False):
        super().__init__()
        self.num_query_layers, self.num_multimodal_layers = num_query_layers, num_multimodal_layers
        self.query_embedding = nn.Parameter(torch.zeros(1, num_queries, embed_dim))
        layer = dict(dropout=dropout, self_attention_first=self_attention_first)
        for i in range(num_query_layers):
            self.add_module(f"query_layer{i}",
                            CrossModalLayer(embed_dim, num_heads, ffn_dim, **layer))
        for i in range(num_multimodal_layers):
            self.add_module(f"multimodal_layer{i}",
                            CrossModalLayer(embed_dim, num_heads, ffn_dim, **layer))

    def forward(self, m1: torch.Tensor, m2: torch.Tensor,
                m1_key_padding_mask: Optional[torch.Tensor] = None,
                m2_key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.query_embedding.to(m2.dtype).expand(m2.shape[0], -1, -1)
        for i in range(self.num_query_layers):
            out = getattr(self, f"query_layer{i}")(out, m1, None, m1_key_padding_mask)
        for i in range(self.num_multimodal_layers):
            out = getattr(self, f"multimodal_layer{i}")(out, m2, None, m2_key_padding_mask)
        return out
