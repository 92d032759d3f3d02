"""Flagship model of the port: multimodal speech-to-unit transformer.

Port of ``mm_s2ut/models/mm_s2ut.py`` ``MMS2UTModel``: ``forward`` (the
teacher-forced training pass: encode, then the decoder over
``prev_output_tokens``), ``encode`` (conv-transformer speech encoder,
batch-level modality dropout in training, then top selective-attention
fusion of each image source, summed), ``decode_init``, ``decode_step``
and ``decode_prefill`` (streaming's prefix reuse) and ``serve_step``
(continuous batching), for the conv-transformer encoder or a raw-waveform
wav2vec2/HuBERT encoder (``speech_encoder_type`` ``hubert`` or
``wav2vec2``, or ``wav2vec2_multimodal`` with its in-layer image fusion
instead of top fusion; ``models/wav2vec2.py``, configured by
``w2v_args``; ``speech_proj`` takes its width to the encoder's) with top
selective-attention fusion: any activation of the reference's table but
``glu``, pre- or post-norm, a tied or untied output embedding, stacked
units (training only), target-speaker conditioning (``spk_emb_proj``),
``only_img`` (the first image source stands in for the encoder output,
through ``only_img_proj`` when its width differs), fusion kept off the
top (``is_fusion_top=False``: the encoder's states are returned and no
fusion runs, as in the reference), and the gate and image pre-norm on or
off. With ``multimodal.load_visual_extractor_type`` the model holds the
on-line image encoder (``visual_extractor``: the timm ViT over kernel A
for ``vit_timm``/``vit_huggingface``, the CLIP tower for ``vit_openai``;
``models/vit.py``): a 4-D first image source of (B, S, S, 3) pixels runs
it, and its features replace that source with no padding (inference
only). Other fusion types and heads raise at construction
(:func:`_check_ported`). The encoder's self-attention runs kernel A,
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
from mm_s2ut_torch.models.vit import (CLIPVisionConfig, CLIPVisionTransformer, ViTConfig,
                                      VisionTransformer)
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, Wav2Vec2WithMultiModal
from mm_s2ut_torch.ops.dropout import DropoutRng


SPEECH_ENCODERS = ("conv_transformer", "hubert", "wav2vec2", "wav2vec2_multimodal")


def reads_waveform(cfg: ModelConfig) -> bool:
    """Whether the model reads raw samples (a wav2vec2/HuBERT encoder)
    rather than fbank frames (the conv-transformer)."""
    return cfg.speech_encoder_type != "conv_transformer"


def _check_ported(cfg: ModelConfig) -> None:
    """Refuse the settings whose modules the port does not have yet: the
    other fusion types, the CTC and multitask heads and the pipelined
    encoder (ROADMAP.md §1). Every other setting of ``ModelConfig`` is
    ported."""
    mm = cfg.multimodal
    if cfg.speech_encoder_type not in SPEECH_ENCODERS:
        raise ValueError(f"speech_encoder_type={cfg.speech_encoder_type!r}: expected one of "
                         f"{SPEECH_ENCODERS}")
    unported = {
        "multimodal_attention_type": mm.multimodal_attention_type not in (None, "selective_attention"),
        "multimodal_extractor_type": mm.multimodal_extractor_type is not None,
        "ctc_weight": cfg.ctc_weight > 0,
        "multitask": bool(cfg.multitask),
        "pipeline_stages": cfg.pipeline_stages > 1,
        "activation_fn=glu": cfg.activation_fn == "glu",
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
    LayerNorm and GroupNorm scales, U[0, 1) for wav2vec2's
    ``masked_spec_embed``, zeros for the image encoders' class token and
    N(0, 0.02) for their positions. Training from scratch starts here."""
    attn = {id(m) for mha in model.modules() if isinstance(mha, MultiHeadAttention)
            for m in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj)}
    for mod in model.modules():
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, Wav2Vec2Model):
            mod.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)
        elif isinstance(mod, (VisionTransformer, CLIPVisionTransformer)):
            for name, p in mod.named_parameters(recurse=False):
                if name == "pos_embed":
                    p.normal_(0.0, 0.02, generator=generator)
                else:  # the class token
                    p.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5, generator=generator)
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
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
    def __init__(self, cfg: ModelConfig, w2v_cfg: Optional[Wav2Vec2Config] = None,
                 vit_cfg: Optional[Any] = None):
        """``w2v_cfg``: the wav2vec2/HuBERT encoder's geometry, by default
        ``Wav2Vec2Config.from_args(cfg.w2v_args)``; ``vit_cfg``: the on-line
        image encoder's (a ``ViTConfig``, or a ``CLIPVisionConfig`` for
        ``vit_openai``), by default its type's published one."""
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.w2v_cfg = w2v_cfg or Wav2Vec2Config.from_args(cfg.w2v_args)
        mm = cfg.multimodal
        if mm.load_visual_extractor_type == "vit_openai":
            self.vit_cfg = vit_cfg or CLIPVisionConfig()
            self.visual_extractor = CLIPVisionTransformer(self.vit_cfg)
        elif mm.load_visual_extractor_type:  # vit_timm / vit_huggingface: timm's graph
            self.vit_cfg = vit_cfg or ViTConfig()
            self.visual_extractor = VisionTransformer(self.vit_cfg)
        drops = dict(dropout=cfg.dropout, attention_dropout=cfg.attention_dropout,
                     activation_dropout=cfg.activation_dropout, activation=cfg.activation_fn)
        in_layer = cfg.speech_encoder_type == "wav2vec2_multimodal"
        # The modules the reference's forward calls are the ones its
        # parameter tree holds: with only_img neither the speech encoder nor
        # the fusion, with a wav2vec2 encoder no conv-transformer, and
        # without top fusion (or with the in-layer kind) no fusion blocks.
        if mm.only_img:
            pass  # the first image source stands in for the encoder
        elif in_layer:
            self.speech_encoder = Wav2Vec2WithMultiModal(
                self.w2v_cfg, m2_dim=mm.image_feat_dim[0] if mm.image_feat_dim else 768,
                num_cross_attention_layers=mm.num_cross_attention_layers)
        elif reads_waveform(cfg):
            self.speech_encoder = Wav2Vec2Model(self.w2v_cfg)
        else:
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
                normalize_before=cfg.encoder_normalize_before,
                **drops,
            )
        if hasattr(self, "speech_encoder") and self.w2v_cfg.hidden_size != cfg.encoder_embed_dim:
            self.speech_proj = nn.Linear(self.w2v_cfg.hidden_size, cfg.encoder_embed_dim)
        if mm.only_img and mm.image_feat_dim and mm.image_feat_dim[0] != cfg.encoder_embed_dim:
            self.only_img_proj = nn.Linear(mm.image_feat_dim[0], cfg.encoder_embed_dim)
        if cfg.speaker_embed_dim:
            self.spk_emb_proj = nn.Linear(cfg.encoder_embed_dim + cfg.speaker_embed_dim,
                                          cfg.encoder_embed_dim)
        fused = (mm.multimodal_attention_type and mm.is_fusion_top and not mm.only_img
                 and not in_layer)
        self.n_fusion = len(mm.image_feat_dim) if fused else 0
        for i in range(self.n_fusion):
            self.add_module(f"fusion{i}", FusionBlock(
                cfg.encoder_embed_dim, mm.image_feat_dim[i], mm.SA_image_dropout,
                mm.SA_text_dropout, mm.SA_attention_dropout, mm.use_selective_gate,
                mm.image_pre_norm))
        self.decoder = UnitDecoder(
            vocab_size=cfg.vocab_size,
            embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim,
            num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads,
            normalize_before=cfg.decoder_normalize_before,
            share_input_output_embed=cfg.share_decoder_input_output_embed,
            n_frames_per_step=cfg.n_frames_per_step,
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

    @property
    def reads_waveform(self) -> bool:
        return reads_waveform(self.cfg)

    @property
    def source_downsample_ratio(self) -> int:
        """Input positions per encoder frame before any subsampling: 1 for
        fbank frames, the conv stack's stride product (320 samples) for a
        raw-waveform encoder. Generation budgets count these frames."""
        return self.w2v_cfg.frame_stride if self.reads_waveform else 1

    def _speech_encode(self, wave, lengths, imgs_list, img_masks_list) -> Dict[str, Any]:
        """The wav2vec2 branches: (B, S) waveforms → encoder states (span
        masking only in training, where it is not ported)."""
        if self.cfg.speech_encoder_type == "wav2vec2_multimodal":
            img = (imgs_list[0] if imgs_list else torch.zeros(
                (wave.shape[0], 1, self.cfg.multimodal.image_feat_dim[0]), device=wave.device))
            w2v = self.speech_encoder(wave, lengths, img,
                                      img_masks_list[0] if img_masks_list else None,
                                      apply_mask=self.training)
        else:
            w2v = self.speech_encoder(wave, lengths, apply_mask=self.training)
        x = w2v["last_hidden_state"]
        if hasattr(self, "speech_proj"):
            x = self.speech_proj(x)
        return {"encoder_out": x, "encoder_padding_mask": w2v["padding_mask"],
                "encoder_states": w2v["hidden_states"]}

    def _extract_visual(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) pixels → (B, T, D) features: the CLIP tower's last
        hidden state, or the ViT's features."""
        if self.training:
            raise NotImplementedError("training through the on-line visual extractor is not "
                                      "ported yet (ROADMAP.md §1 item 4)")
        out = self.visual_extractor(pixels.to(self.decoder.embed.embed_tokens.weight.dtype))
        return out[-1] if isinstance(out, list) else out[0]

    def encode(
        self,
        src_features: torch.Tensor,  # (B, T, F) log-mels, or (B, S) waveforms
        src_lengths: torch.Tensor,  # (B,) frames, or samples
        imgs_list: Sequence[torch.Tensor] = (),  # (B, Ti, Di) per source; the first
        # may be (B, S, S, 3) pixels for the visual extractor
        img_masks_list: Sequence[Optional[torch.Tensor]] = (),  # (B, Ti) True = pad
        tgt_speaker: Optional[torch.Tensor] = None,  # (B, speaker_embed_dim)
    ) -> Dict[str, Any]:
        imgs_list = list(imgs_list)
        img_masks_list = list(img_masks_list) or [None] * len(imgs_list)
        if hasattr(self, "visual_extractor") and imgs_list and imgs_list[0].dim() == 4:
            imgs_list[0] = self._extract_visual(imgs_list[0])
            img_masks_list[0] = torch.zeros(imgs_list[0].shape[:2], dtype=torch.bool,
                                            device=imgs_list[0].device)
        if self.cfg.multimodal.only_img:
            # The first image source replaces the encoder output, and the
            # others are never read (the reference's loop breaks there).
            img = imgs_list[0].to(self.decoder.embed.embed_tokens.weight.dtype)
            if hasattr(self, "only_img_proj"):
                img = self.only_img_proj(img)
            mask = img_masks_list[0]
            if mask is None:
                mask = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
            return {"encoder_out": img, "encoder_padding_mask": mask, "encoder_states": []}
        if hasattr(self, "speech_encoder"):
            out = self._speech_encode(src_features, src_lengths, imgs_list, img_masks_list)
        else:
            out = self.encoder(src_features, src_lengths,
                               return_all_states=not self.cfg.multimodal.is_fusion_top)
        x, padding_mask = out["encoder_out"], out["encoder_padding_mask"]
        if hasattr(self, "spk_emb_proj") and tgt_speaker is not None:
            spk = tgt_speaker[:, None, :].to(x.dtype).expand(*x.shape[:2], tgt_speaker.shape[-1])
            x = self.spk_emb_proj(torch.cat([x, spk], dim=-1))
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
        return {"encoder_out": x, "encoder_padding_mask": padding_mask,
                "encoder_states": out["encoder_states"]}

    def forward(
        self,
        src_features: torch.Tensor,  # (B, T, F) log-mels
        src_lengths: torch.Tensor,  # (B,)
        prev_output_tokens: torch.Tensor,  # (B, Tt)
        imgs_list: Sequence[torch.Tensor] = (),
        img_masks_list: Sequence[Optional[torch.Tensor]] = (),
        tgt_speaker: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """The teacher-forced pass of training: ``logits`` (B, Tt, V) fp32
        (B, Tt·n, V) with n_frames_per_step = n), ``encoder_out`` and
        ``encoder_padding_mask``."""
        enc = self.encode(src_features, src_lengths, imgs_list, img_masks_list, tgt_speaker)
        logits = self.decoder(prev_output_tokens, enc["encoder_out"], enc["encoder_padding_mask"])
        return {"logits": logits, "encoder_out": enc["encoder_out"],
                "encoder_padding_mask": enc["encoder_padding_mask"]}

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

    def serve_step(self, prev_token: torch.Tensor, state: DecoderState):
        """Continuous-batching decode step (``infer/serving.py``; see
        ``UnitDecoder.serve_step``)."""
        return self.decoder.serve_step(prev_token, state)
