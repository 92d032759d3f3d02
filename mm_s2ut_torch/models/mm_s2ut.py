"""Flagship model of the port: multimodal speech-to-unit transformer.

Port of ``mm_s2ut/models/mm_s2ut.py`` ``MMS2UTModel``: ``forward`` (the
teacher-forced training pass: encode, then the decoder over
``prev_output_tokens``), ``encode`` (conv-transformer speech encoder,
batch-level modality dropout in training, then top selective-attention
fusion of each image source, summed), ``decode_init``, ``decode_step``
and ``decode_prefill`` (streaming's prefix reuse), for the flagship's
choices (pre-norm, ReLU, tied output embedding, gated fusion with image
pre-norm). Other branches and choices raise at construction, the CTC and
multitask heads among them. The encoder's self-attention runs kernel A,
or kernel G with ``encoder_causal_attention`` (and
``encoder_attention_window``), and kernel H in the backward;
``use_flash_attention`` is read by the JAX package only (its non-flash
path computes the same attention).

The model is built in the config's compute dtype (``cfg.dtype``), which
is what inference wants; move it to a device with ``.to(device)``. The
trainer keeps fp32 master parameters instead (``.float()`` after
construction) and computes in ``cfg.dtype`` under ``torch.autocast``, as
the reference keeps fp32 parameters and a bf16 compute dtype. In training
mode the dropouts need :meth:`MMS2UTModel.set_dropout_rng`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from mm_s2ut_torch.config import ModelConfig
from mm_s2ut_torch.models.decoder import DecoderState, UnitDecoder
from mm_s2ut_torch.models.fusion import FusionBlock, modality_dropout
from mm_s2ut_torch.models.layers import MultiHeadAttention
from mm_s2ut_torch.models.s2t_encoder import SpeechTransformerEncoder
from mm_s2ut_torch.ops.dropout import DropoutRng


def _check_ported(cfg: ModelConfig) -> None:
    mm = cfg.multimodal
    unported = {
        "speech_encoder_type": cfg.speech_encoder_type != "conv_transformer",
        "multimodal_attention_type": mm.multimodal_attention_type not in (None, "selective_attention"),
        "is_fusion_top=False": not mm.is_fusion_top,
        "multimodal_extractor_type": mm.multimodal_extractor_type is not None,
        "load_visual_extractor_type": bool(mm.load_visual_extractor_type),
        "only_img": mm.only_img,
        "speaker_embed_dim": cfg.speaker_embed_dim > 0,
        "ctc_weight": cfg.ctc_weight > 0,
        "multitask": bool(cfg.multitask),
        "n_frames_per_step": cfg.n_frames_per_step > 1,
        "pipeline_stages": cfg.pipeline_stages > 1,
        "activation_fn": cfg.activation_fn != "relu",
        "post-norm": not (cfg.encoder_normalize_before and cfg.decoder_normalize_before),
        "share_decoder_input_output_embed=False": not cfg.share_decoder_input_output_embed,
        "use_selective_gate=False": bool(mm.multimodal_attention_type) and not mm.use_selective_gate,
        "image_pre_norm=False": bool(mm.multimodal_attention_type) and not mm.image_pre_norm,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's initializers (flax's defaults and the model's own
    choices), drawn from ``generator``: xavier-uniform for the attention
    projections, lecun-normal (truncated at 2σ) for every other dense and
    conv kernel, N(0, D^-1/2) for the unit embedding, zero biases, unit
    LayerNorm scales. Training from scratch starts here."""
    attn = {id(m) for mha in model.modules() if isinstance(mha, MultiHeadAttention)
            for m in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj)}
    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5, generator=generator)
        elif isinstance(mod, (nn.Linear, nn.Conv1d)):
            w = mod.weight
            if id(mod) in attn:
                nn.init.xavier_uniform_(w, generator=generator)
            else:
                std = (w[0].numel() ** -0.5) / 0.87962566103423978
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            if mod.bias is not None:
                mod.bias.fill_(0.0)
    return model


class MMS2UTModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        mm = cfg.multimodal
        drops = dict(dropout=cfg.dropout, attention_dropout=cfg.attention_dropout,
                     activation_dropout=cfg.activation_dropout)
        self.encoder = SpeechTransformerEncoder(
            in_dim=cfg.input_feat_per_channel * cfg.input_channels,
            embed_dim=cfg.encoder_embed_dim,
            ffn_dim=cfg.encoder_ffn_embed_dim,
            num_layers=cfg.encoder_layers,
            num_heads=cfg.encoder_attention_heads,
            conv_channels=cfg.conv_channels,
            conv_kernel_sizes=tuple(cfg.conv_kernel_sizes),
            causal_attention=cfg.encoder_causal_attention,
            attention_window=cfg.encoder_attention_window,
            **drops,
        )
        self.n_fusion = len(mm.image_feat_dim) if mm.multimodal_attention_type else 0
        for i in range(self.n_fusion):
            self.add_module(f"fusion{i}", FusionBlock(
                cfg.encoder_embed_dim, mm.image_feat_dim[i], mm.SA_image_dropout,
                mm.SA_text_dropout, mm.SA_attention_dropout))
        self.decoder = UnitDecoder(
            vocab_size=cfg.vocab_size,
            embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim,
            num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads,
            **drops,
        )
        self.rng: Optional[DropoutRng] = None
        self.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)

    def set_dropout_rng(self, rng: Optional[DropoutRng]) -> "MMS2UTModel":
        """Hand every dropout site of the model the run's generators."""
        for module in self.modules():
            if hasattr(module, "rng"):
                module.rng = rng
        return self

    @property
    def device(self) -> torch.device:
        return self.decoder.embed.embed_tokens.weight.device

    def encode(
        self,
        src_features: torch.Tensor,  # (B, T, F) log-mels
        src_lengths: torch.Tensor,  # (B,)
        imgs_list: Sequence[torch.Tensor] = (),  # (B, Ti, Di) per source
        img_masks_list: Sequence[Optional[torch.Tensor]] = (),  # (B, Ti) True = pad
    ) -> Dict[str, Any]:
        out = self.encoder(src_features, src_lengths)
        x, padding_mask = out["encoder_out"], out["encoder_padding_mask"]
        imgs_list = list(imgs_list)
        img_masks_list = list(img_masks_list) or [None] * len(imgs_list)
        if self.n_fusion and imgs_list:
            mm = self.cfg.multimodal
            if self.training and mm.modality_dropout > 0:
                if self.rng is None:
                    raise RuntimeError("training with modality dropout needs set_dropout_rng")
                x, imgs_list = modality_dropout(self.rng, x, imgs_list, mm.modality_dropout,
                                                mm.audio_dropout)
            fused = [
                getattr(self, f"fusion{i}")(x, img.to(x.dtype), mask)
                for i, (img, mask) in enumerate(zip(imgs_list, img_masks_list))
            ]
            x = fused[0]
            for extra in fused[1:]:
                x = x + extra
        return {"encoder_out": x, "encoder_padding_mask": padding_mask}

    def forward(
        self,
        src_features: torch.Tensor,  # (B, T, F) log-mels
        src_lengths: torch.Tensor,  # (B,)
        prev_output_tokens: torch.Tensor,  # (B, Tt)
        imgs_list: Sequence[torch.Tensor] = (),
        img_masks_list: Sequence[Optional[torch.Tensor]] = (),
    ) -> Dict[str, Any]:
        """The teacher-forced pass of training: ``logits`` (B, Tt, V) fp32,
        ``encoder_out`` and ``encoder_padding_mask``."""
        enc = self.encode(src_features, src_lengths, imgs_list, img_masks_list)
        logits = self.decoder(prev_output_tokens, enc["encoder_out"], enc["encoder_padding_mask"])
        return {"logits": logits, **enc}

    def decode_init(self, enc: Dict[str, Any], max_len: int, kv_dtype=None) -> DecoderState:
        return self.decoder.init_state(
            enc["encoder_out"], enc["encoder_padding_mask"], max_len, kv_dtype=kv_dtype
        )

    def decode_step(self, prev_token: torch.Tensor, state: DecoderState):
        return self.decoder.step(prev_token, state)

    def decode_prefill(self, prefix_tokens: torch.Tensor, prefix_len: int, state: DecoderState):
        """Teacher-forced prefill of a beam-tiled state (streaming prefix
        reuse; see ``UnitDecoder.prefill``)."""
        return self.decoder.prefill(prefix_tokens, prefix_len, state)
