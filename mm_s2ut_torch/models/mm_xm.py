"""The enhanced path of the port: ``mm_xm_transformer``.

Port of ``mm_s2ut/models/mm_xm.py``: a wav2vec2 encoder
(``models/wav2vec2.py``; kernel A in every layer) reads the raw
waveform, an optional ``pre_adaptor_proj`` takes its width to the
decoder's, a stride-2 :class:`Conv1dAdaptor` shortens it (3 layers: 8×,
so 10 s of audio is 499 → 63 positions), selective-attention fusion with
a sigmoid gate adds each image source (summed over sources), and the
port's ``UnitDecoder`` decodes over the text vocabulary (kernels B and C,
or D/F and E over a quantized cache). The CTC and multitask heads are the
flagship's (``mm_s2ut.add_aux_heads``). Modality dropout runs in training
mode, as in the flagship. As in the reference, the trainer never passes
``apply_mask``, so this model trains without span masking.

The model is built in the config's compute dtype (``cfg.dtype``); move
it to a device with ``.to(device)``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mm_s2ut_torch.config import ModelConfig
from mm_s2ut_torch.models.decoder import DecoderState, UnitDecoder
from mm_s2ut_torch.models.fusion import FusionBlock, modality_dropout
from mm_s2ut_torch.models.layers import layer_norm, lengths_to_padding_mask
from mm_s2ut_torch.models.mm_s2ut import add_aux_heads, aux_outputs
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from mm_s2ut_torch.ops.dropout import DropoutRng


class Conv1dAdaptor(nn.Module):
    """Stride-2 conv + GLU stack over (B, T, in_dim) (fairseq's
    Conv1dAdaptor): optional LayerNorm (flax's 1e-6) before each conv, GLU
    on the channel axis, and lengths ⌈L / stride⌉ per layer, as the
    reference counts them."""

    def __init__(self, in_dim: int, out_dim: int, n_layers: int = 3, kernel_size: int = 3,
                 stride: int = 2, layernorm: bool = False, proj: bool = False):
        super().__init__()
        self.n_layers, self.stride = n_layers, stride
        self.layernorm, self.proj = layernorm, proj
        if proj:
            self.proj1 = nn.Linear(in_dim, 2 * in_dim)
        for i in range(n_layers):
            c_in = in_dim if i == 0 else out_dim
            if layernorm:
                self.add_module(f"ln{i}", layer_norm(c_in))
            self.add_module(f"conv{i}", nn.Conv1d(c_in, 2 * out_dim, kernel_size, stride=stride,
                                                  padding=kernel_size // 2))
        if proj:
            self.proj2 = nn.Linear(out_dim, 2 * out_dim)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.proj:
            x = F.glu(self.proj1(x), dim=-1)
        for i in range(self.n_layers):
            if self.layernorm:
                x = getattr(self, f"ln{i}")(x)
            x = F.glu(getattr(self, f"conv{i}")(x.transpose(1, 2)), dim=1).transpose(1, 2)
            lengths = (lengths + self.stride - 1) // self.stride
        if self.proj:
            x = F.glu(self.proj2(x), dim=-1)
        return x, lengths


class MMXMTransformerModel(nn.Module):
    """forward(waveform batch) → decoder logits (+ CTC and multitask logits)."""

    reads_waveform = True

    def __init__(self, cfg: ModelConfig, w2v_cfg: Optional[Wav2Vec2Config] = None,
                 adaptor_layers: int = 3, adaptor_kernel: int = 3, adaptor_stride: int = 2):
        super().__init__()
        self.cfg = cfg
        self.w2v_cfg = w2v_cfg = w2v_cfg or Wav2Vec2Config.from_args(cfg.w2v_args)
        self.adaptor_layers, self.adaptor_stride = adaptor_layers, adaptor_stride
        mm, d = cfg.multimodal, cfg.decoder_embed_dim
        self.wav2vec2 = Wav2Vec2Model(w2v_cfg)
        if w2v_cfg.hidden_size != d:
            self.pre_adaptor_proj = nn.Linear(w2v_cfg.hidden_size, d)
        self.adaptor = Conv1dAdaptor(d, d, n_layers=adaptor_layers, kernel_size=adaptor_kernel,
                                     stride=adaptor_stride, layernorm=True)
        # The reference calls its fusion blocks only on top (and builds no
        # parameters for blocks it never calls).
        fused = mm.multimodal_attention_type is not None and mm.is_fusion_top
        self.n_fusion = len(mm.image_feat_dim) if fused else 0
        for i in range(self.n_fusion):
            self.add_module(f"fusion{i}", FusionBlock(
                d, mm.image_feat_dim[i], mm.SA_image_dropout, mm.SA_text_dropout,
                mm.SA_attention_dropout, True, mm.image_pre_norm))
        self.decoder = UnitDecoder(
            vocab_size=cfg.vocab_size, embed_dim=d, ffn_dim=cfg.decoder_ffn_embed_dim,
            num_layers=cfg.decoder_layers, num_heads=cfg.decoder_attention_heads,
            dropout=cfg.dropout, attention_dropout=cfg.attention_dropout,
            activation_dropout=cfg.activation_dropout, activation=cfg.activation_fn,
            normalize_before=cfg.decoder_normalize_before,
            share_input_output_embed=cfg.share_decoder_input_output_embed,
        )
        add_aux_heads(self, cfg, d)
        self.rng: Optional[DropoutRng] = None
        self.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)

    @property
    def source_downsample_ratio(self) -> int:
        """Input samples per encoder position (the wav2vec2 conv stack, then
        the adaptor): generation budgets count encoder positions."""
        return self.w2v_cfg.frame_stride * self.adaptor_stride ** self.adaptor_layers

    @property
    def device(self) -> torch.device:
        return self.decoder.embed.embed_tokens.weight.device

    def set_dropout_rng(self, rng: Optional[DropoutRng]) -> "MMXMTransformerModel":
        for module in self.modules():
            if hasattr(module, "rng"):
                module.rng = rng
        return self

    def encode(
        self,
        waveform: torch.Tensor,  # (B, S) raw samples
        lengths: torch.Tensor,  # (B,) sample counts
        imgs_list: Sequence[torch.Tensor] = (),
        img_masks_list: Sequence[Optional[torch.Tensor]] = (),
        tgt_speaker: Optional[torch.Tensor] = None,  # the flagship's signature (unused)
        apply_mask: bool = False,
    ) -> Dict[str, Any]:
        out = self.wav2vec2(waveform, lengths, apply_mask=apply_mask)
        x = out["last_hidden_state"]
        if hasattr(self, "pre_adaptor_proj"):
            x = self.pre_adaptor_proj(x)
        x, feat_lens = self.adaptor(x, out["lengths"])
        padding_mask = lengths_to_padding_mask(feat_lens, x.shape[1])
        imgs_list = list(imgs_list)
        if self.n_fusion and imgs_list:
            mm = self.cfg.multimodal
            if self.training and mm.modality_dropout > 0:
                if self.rng is None:
                    raise RuntimeError("training with modality dropout needs set_dropout_rng")
                x, imgs_list = modality_dropout(self.rng, x, imgs_list, mm.modality_dropout,
                                                mm.audio_dropout)
            masks = list(img_masks_list) or [None] * len(imgs_list)
            fused = [getattr(self, f"fusion{i}")(x, padding_mask, img.to(x.dtype), mask)[0]
                     for i, (img, mask) in enumerate(zip(imgs_list, masks))]
            x = fused[0]
            for extra in fused[1:]:
                x = x + extra
        return {"encoder_out": x, "encoder_padding_mask": padding_mask,
                "encoder_states": out["hidden_states"]}

    def forward(
        self,
        src_tokens: torch.Tensor,  # (B, S) waveform
        src_lengths: torch.Tensor,
        prev_output_tokens: torch.Tensor,
        imgs_list: Sequence[torch.Tensor] = (),
        img_masks_list: Sequence[Optional[torch.Tensor]] = (),
        tgt_speaker: Optional[torch.Tensor] = None,
        apply_mask: bool = False,
        multitask_prev_tokens: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, Any]:
        """``logits`` (B, Tt, V) fp32, the encoder's output and mask, and,
        when configured, ``ctc_logits`` and ``multitask_logits``."""
        enc = self.encode(src_tokens, src_lengths, imgs_list, img_masks_list,
                          apply_mask=apply_mask)
        mem, mask = enc["encoder_out"], enc["encoder_padding_mask"]
        out = {"logits": self.decoder(prev_output_tokens, mem, mask),
               "encoder_out": mem, "encoder_padding_mask": mask}
        out.update(aux_outputs(self, self.cfg, mem, mask, multitask_prev_tokens))
        return out

    def decode_init(self, enc: Dict[str, Any], max_len: int, kv_dtype=None) -> DecoderState:
        return self.decoder.init_state(
            enc["encoder_out"], enc["encoder_padding_mask"], max_len, kv_dtype=kv_dtype
        )

    def decode_step(self, prev_token: torch.Tensor, state: DecoderState):
        return self.decoder.step(prev_token, state)

    def serve_step(self, prev_token: torch.Tensor, state: DecoderState):
        """Continuous-batching decode step (``infer/serving.py``)."""
        return self.decoder.serve_step(prev_token, state)


def mm_xm_architecture_base(cfg: ModelConfig) -> ModelConfig:
    """The reference's ``mm_xm_transformer`` architecture: a 1024-d,
    12-layer, 16-head decoder with a 4096-d FFN."""
    cfg.decoder_embed_dim = 1024
    cfg.decoder_ffn_embed_dim = 4096
    cfg.decoder_layers = 12
    cfg.decoder_attention_heads = 16
    return cfg
