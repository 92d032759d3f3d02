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
``w2v_args``; ``speech_proj`` takes its width to the encoder's), with
every fusion type of the reference (``multimodal_attention_type``): top
fusion blocks of selective or multimodal attention (the latter with a
learned extra key/value column and, with ``is_merge_text_img``, the
encoder output becoming [speech; image] under the mask [speech mask;
zeros]), or per image source an external or a BridgeTower tower over the
encoder's last per-layer states (before its final LayerNorm) and the
projected image, the towers' outputs summed; and with
``multimodal_extractor_type=q_former`` the Q-Former, whose learned queries
read the speech (through ``q_former_speech_proj`` where the widths differ)
and the first image source and replace that source, unmasked (built and
run even where nothing reads its output, as in the reference). Any
activation of the reference's table but
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
it, and its features replace that source with no padding, in training
too. The auxiliary heads over the encoder output (:func:`add_aux_heads`:
the CTC head with ``ctc_weight`` > 0, a CTC or small transformer head per
``multitask`` task) give their logits in ``forward``. With
``pipeline_stages`` > 1 the conv-transformer's layers run as a GPipe over
a pipe group (``parallel/pipeline.py``; ``pipeline_microbatches``), and
the fusion variants that read the encoder's per-layer states raise there,
as in the reference. ``glu`` raises at construction (:func:`_check_ported`).
With ``checkpoint_activations`` the conv-transformer's layers are
rematerialised in training. The encoder's self-attention runs kernel A,
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
from mm_s2ut_torch.models.decoder import CTCHead, DecoderState, UnitDecoder
from mm_s2ut_torch.models.fusion import (BridgeTowerEncoder, ExternalMultimodalEncoder,
                                         FusionBlock, MultimodalAttention, QFormer,
                                         modality_dropout)
from mm_s2ut_torch.models.layers import MultiHeadAttention
from mm_s2ut_torch.models.s2t_encoder import SpeechTransformerEncoder
from mm_s2ut_torch.models.vit import (CLIPVisionConfig, CLIPVisionTransformer, ViTConfig,
                                      VisionTransformer)
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, Wav2Vec2WithMultiModal
from mm_s2ut_torch.ops.dropout import DropoutRng


SPEECH_ENCODERS = ("conv_transformer", "hubert", "wav2vec2", "wav2vec2_multimodal")
FUSION_BLOCKS = ("selective_attention", "multimodal_attention")  # fusion{i} on top
TOWERS = {"external_multimodal_transformer": ("external", ExternalMultimodalEncoder),
          "bridge_tower": ("bridge", BridgeTowerEncoder)}


def reads_waveform(cfg: ModelConfig) -> bool:
    """Whether the model reads raw samples (a wav2vec2/HuBERT encoder)
    rather than fbank frames (the conv-transformer)."""
    return cfg.speech_encoder_type != "conv_transformer"


def _check_ported(cfg: ModelConfig) -> None:
    """Refuse ``glu``, which the reference cannot run either. Every other
    setting of ``ModelConfig`` is ported."""
    if cfg.speech_encoder_type not in SPEECH_ENCODERS:
        raise ValueError(f"speech_encoder_type={cfg.speech_encoder_type!r}: expected one of "
                         f"{SPEECH_ENCODERS}")
    if cfg.activation_fn == "glu":
        raise NotImplementedError("not ported yet: activation_fn=glu")


def add_aux_heads(model: nn.Module, cfg: ModelConfig, enc_dim: int) -> None:
    """The auxiliary heads over the ``enc_dim``-wide encoder output:
    ``ctc_head`` with ``ctc_weight`` > 0, and per multitask task
    ``mt_{name}``, a :class:`CTCHead` or a small :class:`UnitDecoder` (4x
    FFN, the model's dropouts, activation dropout 0.1 as the reference's
    default) with ``mt_{name}_proj`` to its width where it differs."""
    if cfg.ctc_weight > 0:
        model.ctc_head = CTCHead(enc_dim, cfg.vocab_size)
    for t in cfg.multitask:
        vocab = t.vocab_size or cfg.vocab_size
        if t.decoder_type == "ctc":
            model.add_module(f"mt_{t.task_name}", CTCHead(enc_dim, vocab))
            continue
        model.add_module(f"mt_{t.task_name}", UnitDecoder(
            vocab_size=vocab, embed_dim=t.decoder_embed_dim, ffn_dim=4 * t.decoder_embed_dim,
            num_layers=t.decoder_layers, num_heads=t.decoder_attention_heads,
            dropout=cfg.dropout, attention_dropout=cfg.attention_dropout,
            activation_dropout=0.1))
        if t.decoder_embed_dim != enc_dim:
            model.add_module(f"mt_{t.task_name}_proj", nn.Linear(enc_dim, t.decoder_embed_dim))


def aux_outputs(model: nn.Module, cfg: ModelConfig, mem: torch.Tensor, mask: torch.Tensor,
                multitask_prev_tokens: Optional[Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """``ctc_logits`` and ``multitask_logits`` over the encoder output
    ``mem``; a transformer task whose ``multitask_prev_tokens`` the batch
    lacks is left out."""
    out: Dict[str, Any] = {}
    if cfg.ctc_weight > 0:
        out["ctc_logits"] = model.ctc_head(mem)
    if cfg.multitask:
        mt_out = {}
        for t in cfg.multitask:
            head = getattr(model, f"mt_{t.task_name}")
            if t.decoder_type == "ctc":
                mt_out[t.task_name] = head(mem)
                continue
            prev = (multitask_prev_tokens or {}).get(t.task_name)
            if prev is None:
                continue  # no auxiliary targets in this batch
            proj = getattr(model, f"mt_{t.task_name}_proj", None)
            mt_out[t.task_name] = head(prev, proj(mem) if proj is not None else mem, mask)
        out["multitask_logits"] = mt_out
    return out


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's initializers (flax's defaults and the model's own
    choices), drawn from ``generator``: xavier-uniform for the attention
    projections, lecun-normal (truncated at 2σ) for every other dense and
    conv kernel, N(0, D^-1/2) for the unit embedding, zero biases, unit
    LayerNorm and GroupNorm scales, U[0, 1) for wav2vec2's
    ``masked_spec_embed``, zeros for the image encoders' class token and
    N(0, 0.02) for their positions and the Q-Former's queries, and flax's
    xavier-normal (truncated at 2σ, fans 1 and kdim) for multimodal
    attention's ``bias_k``/``bias_v``. Training from scratch starts here."""
    attn = {id(m) for mha in model.modules() if isinstance(mha, MultiHeadAttention)
            for m in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj)}
    for mod in model.modules():
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, Wav2Vec2Model):
            mod.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)
        elif isinstance(mod, MultimodalAttention):
            for p in mod.parameters(recurse=False):
                std = (2.0 / (p.shape[-2] + p.shape[-1])) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=generator)
        elif isinstance(mod, QFormer):
            mod.query_embedding.normal_(0.0, 0.02, generator=generator)
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
                checkpoint_activations=cfg.checkpoint_activations,
                pipeline_stages=cfg.pipeline_stages,
                pipeline_microbatches=cfg.pipeline_microbatches,
                **drops,
            )
        if hasattr(self, "speech_encoder") and self.w2v_cfg.hidden_size != cfg.encoder_embed_dim:
            self.speech_proj = nn.Linear(self.w2v_cfg.hidden_size, cfg.encoder_embed_dim)
        if mm.only_img and mm.image_feat_dim and mm.image_feat_dim[0] != cfg.encoder_embed_dim:
            self.only_img_proj = nn.Linear(mm.image_feat_dim[0], cfg.encoder_embed_dim)
        if cfg.speaker_embed_dim:
            self.spk_emb_proj = nn.Linear(cfg.encoder_embed_dim + cfg.speaker_embed_dim,
                                          cfg.encoder_embed_dim)
        d, kind = cfg.encoder_embed_dim, mm.multimodal_attention_type
        fused = (kind in FUSION_BLOCKS and mm.is_fusion_top and not mm.only_img
                 and not in_layer)
        self.n_fusion = len(mm.image_feat_dim) if fused else 0
        for i in range(self.n_fusion):
            self.add_module(f"fusion{i}", FusionBlock(
                d, mm.image_feat_dim[i], mm.SA_image_dropout, mm.SA_text_dropout,
                mm.SA_attention_dropout, mm.use_selective_gate, mm.image_pre_norm,
                attention_type=kind, is_merge_text_img=mm.is_merge_text_img))
        # Per image source a tower and the projection of the image to the
        # encoder's width: external_tower{i}/external_img_proj{i} or
        # bridge_tower{i}/bridge_img_proj{i}.
        self.n_towers = len(mm.image_feat_dim) if kind in TOWERS and not mm.only_img else 0
        for i in range(self.n_towers):
            prefix, tower = TOWERS[kind]
            self.add_module(f"{prefix}_tower{i}", tower(
                d, max(d // 64, 1), 4 * d, mm.external_multimodal_transformer_layers,
                mm.SA_attention_dropout))
            self.add_module(f"{prefix}_img_proj{i}", nn.Linear(mm.image_feat_dim[i], d))
        if mm.multimodal_extractor_type == "q_former" and not mm.only_img:
            img_dim = mm.image_feat_dim[0] if mm.image_feat_dim else 768
            self.q_former = QFormer(
                img_dim, max(img_dim // 64, 1), 4 * img_dim, mm.num_queries, mm.num_query_layers,
                mm.num_multimodal_layers, mm.SA_attention_dropout, mm.self_attention_first)
            if img_dim != d:
                self.q_former_speech_proj = nn.Linear(d, img_dim)
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
        add_aux_heads(self, cfg, cfg.encoder_embed_dim)
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
        masking in training)."""
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
        hidden state, or the ViT's features. In training the extractor's
        parameters train with the rest, as in the reference (nothing
        freezes them); the ViT's attention backward is kernel H."""
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
        mm = self.cfg.multimodal
        if hasattr(self, "speech_encoder"):
            out = self._speech_encode(src_features, src_lengths, imgs_list, img_masks_list)
        else:
            # The towers read every layer's state, as does a fusion block kept off the top.
            need_states = bool(self.n_towers) or (
                mm.multimodal_attention_type in FUSION_BLOCKS and bool(mm.image_feat_dim)
                and not mm.is_fusion_top)
            out = self.encoder(src_features, src_lengths, return_all_states=need_states)
        x, padding_mask = out["encoder_out"], out["encoder_padding_mask"]
        if hasattr(self, "spk_emb_proj") and tgt_speaker is not None:
            spk = tgt_speaker[:, None, :].to(x.dtype).expand(*x.shape[:2], tgt_speaker.shape[-1])
            x = self.spk_emb_proj(torch.cat([x, spk], dim=-1))
        if hasattr(self, "q_former") and imgs_list:
            speech = self.q_former_speech_proj(x) if hasattr(self, "q_former_speech_proj") else x
            imgs_list[0] = self.q_former(speech, imgs_list[0].to(x.dtype), padding_mask,
                                         img_masks_list[0])
            img_masks_list[0] = torch.zeros(imgs_list[0].shape[:2], dtype=torch.bool,
                                            device=x.device)
        if self.n_towers and imgs_list:
            x = self._run_towers(x, padding_mask, out["encoder_states"], imgs_list,
                                 img_masks_list)
        if self.n_fusion and imgs_list:
            x, imgs_list = self._modality_dropout(x, imgs_list)
            fused = []
            for i, (img, img_mask) in enumerate(zip(imgs_list, img_masks_list)):
                res, mask = getattr(self, f"fusion{i}")(x, padding_mask, img.to(x.dtype),
                                                        img_mask)
                fused.append(res)
            x = sum(fused[1:], fused[0])
            padding_mask = mask  # the last block's: with the merge, [speech mask; zeros]
        return {"encoder_out": x, "encoder_padding_mask": padding_mask,
                "encoder_states": out["encoder_states"]}

    def _modality_dropout(self, x, imgs_list):
        mm = self.cfg.multimodal
        if not (self.training and mm.modality_dropout > 0):
            return x, imgs_list
        if self.rng is None:
            raise RuntimeError("training with modality dropout needs set_dropout_rng")
        return modality_dropout(self.rng, x, imgs_list, mm.modality_dropout, mm.audio_dropout)

    def _run_towers(self, x, padding_mask, states, imgs_list, img_masks_list) -> torch.Tensor:
        """Per image source, its tower over the encoder's last n per-layer
        states (the last one repeated when there are fewer; ``x`` alone
        without states) and the projected image at every level; the
        towers' speech outputs summed. Modality dropout draws as in top
        fusion, but only the images' factor reaches the output: the towers
        read the states, not ``x`` (as in the reference)."""
        n = self.cfg.multimodal.external_multimodal_transformer_layers
        _, imgs_list = self._modality_dropout(x, imgs_list)
        states = list(states) or [x]
        speech = states[-n:] if len(states) >= n else [states[-1]] * n
        prefix = TOWERS[self.cfg.multimodal.multimodal_attention_type][0]
        fused = []
        for i, (img, img_mask) in enumerate(zip(imgs_list, img_masks_list)):
            img = getattr(self, f"{prefix}_img_proj{i}")(img.to(x.dtype))
            res = getattr(self, f"{prefix}_tower{i}")(speech, [img] * n, padding_mask, img_mask)
            fused.append(res[0] if prefix == "bridge" else res)
        return sum(fused[1:], fused[0])

    def forward(
        self,
        src_features: torch.Tensor,  # (B, T, F) log-mels
        src_lengths: torch.Tensor,  # (B,)
        prev_output_tokens: torch.Tensor,  # (B, Tt)
        imgs_list: Sequence[torch.Tensor] = (),
        img_masks_list: Sequence[Optional[torch.Tensor]] = (),
        tgt_speaker: Optional[torch.Tensor] = None,
        multitask_prev_tokens: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, Any]:
        """The teacher-forced pass of training: ``logits`` (B, Tt, V) fp32
        (B, Tt·n, V) with n_frames_per_step = n), ``encoder_out``,
        ``encoder_padding_mask`` and, when configured, ``ctc_logits`` and
        ``multitask_logits`` (:func:`aux_outputs`)."""
        enc = self.encode(src_features, src_lengths, imgs_list, img_masks_list, tgt_speaker)
        mem, mask = enc["encoder_out"], enc["encoder_padding_mask"]
        return {"logits": self.decoder(prev_output_tokens, mem, mask), "encoder_out": mem,
                "encoder_padding_mask": mask,
                **aux_outputs(self, self.cfg, mem, mask, multitask_prev_tokens)}

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
