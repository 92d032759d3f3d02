"""wav2vec 2.0 / HuBERT speech encoders of the port.

Port of ``mm_s2ut/models/wav2vec2.py``: the HF ``Wav2Vec2Model`` graph,
so published checkpoints convert weight for weight (raw 16 kHz waveform →
7 convs (320× fewer frames) → feature projection → grouped positional
conv → post-norm (base) or pre-norm ``do_stable_layer_norm`` (large)
transformer layers → every hidden state), ``Wav2Vec2ForCTC`` (a CTC
vocabulary head, fp32 logits) and ``Wav2Vec2WithMultiModal`` (cross-
attention to image features with a sigmoid gate inside the top layers).
The self-attention of every layer is :meth:`MultiHeadAttention.forward`
over the padding bias, which is kernel A on the card; the in-layer
cross-attention is the plain :meth:`MultiHeadAttention.dense`, as in the
reference. Convs, norms and projections are plain PyTorch.

What differs from the rest of the port, and from PyTorch's defaults:

* every LayerNorm and the GroupNorm take ``layer_norm_eps`` (1e-5), not
  flax's 1e-6 of :func:`layers.layer_norm`;
* the GroupNorm (one group per channel) follows conv0 only, with
  ``feat_extract_norm="group"``; ``"layer"`` puts a LayerNorm after every
  conv;
* the gelu is exact (``approximate=False``), not the tanh form of
  ``get_activation("gelu")``;
* the waveform is cast to the model's dtype before conv0;
* an even positional kernel (128) drops the last frame of the conv;
* padded frames are zeroed before the positional conv.

In training mode (the dropouts drawn from the run's ``DropoutRng``):

* span masking, with ``apply_mask`` and ``mask_time_prob`` > 0: the
  reference's ``span_mask`` over (B, T) uniform scores drawn from the seed
  generator on the host and copied to the device, so the card and the CPU
  mask the same frames (:func:`span_mask_from_scores`),
  ``masked_spec_embed`` put in at the masked frames before the padding is
  zeroed;
* LayerDrop: one uniform per layer per forward for the whole batch, from
  the seed generator (a host number, so a dropped layer, and the in-layer
  fusion after it, is not computed: its input passes through, and its
  parameters get a zero gradient, as the reference's select gives them);
* ``gradient_checkpointing``: each encoder layer rematerialised, its
  dropout drawn again as in the forward (``ops.dropout.checkpoint``).

The conv frontend stays frozen (``no_grad``), as the reference's
``stop_gradient``. :func:`load_hf_checkpoint` reads a local HF directory
(``config.json``, ``pytorch_model.bin`` or ``model.safetensors``) without
``transformers``.
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mm_s2ut_torch.models.layers import MultiHeadAttention, make_padding_bias
from mm_s2ut_torch.ops.attention import padding_bias
from mm_s2ut_torch.ops.dropout import BernoulliDropout, DropoutRng, checkpoint, need_rng


@dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    vocab_size: int = 32  # the CTC head's
    layerdrop: float = 0.0
    gradient_checkpointing: bool = False
    # Read by the JAX package only (its non-flash path computes the same
    # attention); the port always runs kernel A.
    use_flash_attention: bool = True
    # Pad the frame axis to a multiple of this (the padded frames are
    # masked, so only the output length changes).
    pad_to_multiple: int = 1

    @classmethod
    def from_args(cls, args: Optional[Mapping] = None) -> "Wav2Vec2Config":
        """Field overrides from ``ModelConfig.w2v_args`` (yaml lists become
        the tuple conv specs)."""
        args = dict(args or {})
        for k in ("conv_dim", "conv_stride", "conv_kernel"):
            if k in args:
                args[k] = tuple(args[k])
        return cls(**args)

    @classmethod
    def from_hf(cls, hf: Mapping) -> "Wav2Vec2Config":
        """From an HF ``config.json`` (a dict)."""
        keys = ("conv_bias", "feat_extract_norm", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size", "num_conv_pos_embeddings",
                "num_conv_pos_embedding_groups", "do_stable_layer_norm", "layer_norm_eps",
                "mask_time_prob", "layerdrop", "mask_time_length", "vocab_size")
        kw = {k: hf[k] for k in keys if k in hf}
        for k in ("conv_dim", "conv_stride", "conv_kernel"):
            if k in hf:
                kw[k] = tuple(hf[k])
        return cls(**kw)

    @property
    def frame_stride(self) -> int:
        """Samples per frame: the product of the conv strides (320)."""
        r = 1
        for s in self.conv_stride:
            r *= s
        return r

    def feature_lengths(self, sample_lengths):
        """Frames of the conv stack for ``sample_lengths`` (an int or a tensor)."""
        out = sample_lengths
        for k, s in zip(self.conv_kernel, self.conv_stride):
            out = (out - k) // s + 1
        return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact, as jax.nn.gelu(approximate=False)


MIN_MASKS = 2  # the reference's span_mask default, which no caller changes


def span_mask_from_scores(scores: torch.Tensor, mask_prob: float, mask_length: int,
                          lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's ``span_mask`` over given uniform ``scores`` (B, T):
    max(MIN_MASKS, int(p·T/len + 0.5)) spans per row, at most T // len,
    starting at the rows' smallest scores (ties to the lower frame, as
    ``lax.top_k``), never where a span would pass the row's length, each
    ``mask_length`` frames long and cut at that length. (B, T) bool, True
    = masked."""
    B, T = scores.shape
    n_spans = max(MIN_MASKS, int(mask_prob * T / mask_length + 0.5))
    n_spans = min(n_spans, max(T // mask_length, 1))
    t = torch.arange(T, device=scores.device)
    if lengths is not None:
        valid = t[None, :] < (lengths[:, None] - mask_length + 1)
        scores = torch.where(valid, scores, torch.full_like(scores, 2.0))  # never start in padding
    starts = torch.sort(scores, dim=1, stable=True).indices[:, :n_spans, None]
    mask = ((t >= starts) & (t < starts + mask_length)).any(1)
    if lengths is not None:
        mask &= t[None, :] < lengths[:, None]
    return mask


class FeatureEncoder(nn.Module):
    """Raw waveform (B, S) → conv features (B, T, conv_dim[-1])."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        c_in = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            self.add_module(f"conv{i}", nn.Conv1d(c_in, dim, k, stride=s, bias=cfg.conv_bias))
            if cfg.feat_extract_norm == "layer":
                self.add_module(f"layer_norm{i}", nn.LayerNorm(dim, eps=cfg.layer_norm_eps))
            c_in = dim
        if cfg.feat_extract_norm == "group":
            self.group_norm = nn.GroupNorm(cfg.conv_dim[0], cfg.conv_dim[0],
                                           eps=cfg.layer_norm_eps)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        x = waveform[:, None, :]  # (B, 1, S), channels first
        for i in range(len(self.cfg.conv_dim)):
            x = getattr(self, f"conv{i}")(x)
            if self.cfg.feat_extract_norm == "group" and i == 0:
                x = self.group_norm(x)
            elif self.cfg.feat_extract_norm == "layer":
                x = getattr(self, f"layer_norm{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = gelu(x)
        return x.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.even = k % 2 == 0
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            # oneDNN's bf16 grouped conv on the CPU is wrong by O(1) (torch
            # 2.13): sum in fp32 and round once, as cuDNN does on the card.
            w, b = self.conv.weight.float(), self.conv.bias.float()
            h = F.conv1d(x.transpose(1, 2).float(), w, b, padding=self.conv.padding,
                         groups=self.conv.groups).to(x.dtype).transpose(1, 2)
        else:
            h = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.even:
            h = h[:, :-1]
        return gelu(h)


class Wav2Vec2EncoderLayer(nn.Module):
    """Post-norm (base) or pre-norm (``do_stable_layer_norm``, large);
    the self-attention is kernel A over the padding bias."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.attention = MultiHeadAttention(cfg.hidden_size, cfg.num_attention_heads,
                                            cfg.attention_dropout)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.drop = BernoulliDropout(cfg.hidden_dropout)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        h = self.drop(gelu(self.intermediate_dense(x)))
        return self.drop(self.output_dense(h))

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        """``key_bias``: the (B, T) f32 additive bias of the padding."""
        if self.stable:
            x = x + self.drop(self.attention(self.layer_norm(x), key_bias))
            return x + self._ffn(self.final_layer_norm(x))
        x = self.layer_norm(x + self.drop(self.attention(x, key_bias)))
        return self.final_layer_norm(x + self._ffn(x))


class Wav2Vec2Model(nn.Module):
    """HF-graph wav2vec2/HuBERT encoder. ``forward`` returns
    {"last_hidden_state", "hidden_states", "padding_mask", "lengths"}."""

    FLAX_LEAVES = ("masked_spec_embed",)  # convert.from_flax takes it as is

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.feature_projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        # The span-mask embedding of training, kept for the checkpoint's sake.
        self.masked_spec_embed = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.pos_conv = PositionalConvEmbedding(cfg)
        self.encoder_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer{i}", Wav2Vec2EncoderLayer(cfg))
        self.drop = BernoulliDropout(cfg.hidden_dropout)
        self.rng: Optional[DropoutRng] = None  # span scores, LayerDrop, checkpointed layers

    @property
    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.cfg.num_hidden_layers)]

    def _span_scores(self, B: int, T: int, device) -> torch.Tensor:
        """The uniforms span masking starts from, from the seed generator."""
        rng = need_rng(self)
        return rng.uniform((B, T), rng.seeds).to(device)

    def _layerdrop_draw(self) -> float:
        """One layer's LayerDrop uniform, from the seed generator."""
        return float(torch.rand((), generator=need_rng(self).seeds))

    def embed(self, waveform: torch.Tensor, lengths: Optional[torch.Tensor],
              pad_to_multiple: int = 1,
              mask_spans: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Conv features (frozen, as the reference keeps them) → projection →
        span masking (``mask_spans``) → padded frames zeroed → positional
        conv → (post-norm) LayerNorm → dropout: (hidden, padding mask, frame
        lengths)."""
        c = self.cfg
        with torch.no_grad():
            feats = self.feature_extractor(waveform.to(self.feature_projection.weight.dtype))
        t_true = feats.shape[1]
        pad = (-t_true) % pad_to_multiple
        if pad:
            feats = F.pad(feats, (0, 0, 0, pad))
        B, T = feats.shape[:2]
        feat_lens = (c.feature_lengths(lengths.long()) if lengths is not None
                     else torch.full((B,), t_true, dtype=torch.long, device=feats.device))
        padding_mask = torch.arange(T, device=feats.device)[None, :] >= feat_lens[:, None]
        hidden = self.feature_projection(self.feature_projection_norm(feats))
        if mask_spans:
            mask = span_mask_from_scores(self._span_scores(B, T, feats.device), c.mask_time_prob,
                                         c.mask_time_length, feat_lens)
            hidden = torch.where(mask[..., None], self.masked_spec_embed.to(hidden.dtype), hidden)
        hidden = hidden * (~padding_mask)[..., None].to(hidden.dtype)
        hidden = hidden + self.pos_conv(hidden)
        if not c.do_stable_layer_norm:
            hidden = self.encoder_norm(hidden)
        return self.drop(hidden), padding_mask, feat_lens

    def forward(self, waveform: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                apply_mask: bool = False,
                after_layer: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
                pad_to_multiple: Optional[int] = None) -> Dict[str, Any]:
        """``waveform`` (B, S) raw samples, ``lengths`` (B,) sample counts.
        ``after_layer(i, hidden)``, when given, maps layer i's output before
        the next layer reads it (the in-layer fusion of
        :class:`Wav2Vec2WithMultiModal`); ``pad_to_multiple`` defaults to
        the config's. In training: span masking with ``apply_mask``,
        LayerDrop and checkpointing as the config sets them."""
        c = self.cfg
        pad = c.pad_to_multiple if pad_to_multiple is None else pad_to_multiple
        mask_spans = apply_mask and self.training and c.mask_time_prob > 0
        hidden, padding_mask, feat_lens = self.embed(waveform, lengths, pad, mask_spans)
        key_bias = padding_bias(padding_mask, *padding_mask.shape, hidden.device)
        layerdrop = self.training and c.layerdrop > 0
        remat = self.training and c.gradient_checkpointing and torch.is_grad_enabled()
        states = [hidden]
        for i, layer in enumerate(self.layers):
            if layerdrop and self._layerdrop_draw() < c.layerdrop:
                states.append(hidden)  # the layer and its fusion pass their input through
                continue
            if remat:
                hidden = checkpoint(layer, self.rng, hidden, key_bias)
            else:
                hidden = layer(hidden, key_bias)
            if after_layer is not None:
                hidden = after_layer(i, hidden)
            states.append(hidden)
        if c.do_stable_layer_norm:
            hidden = self.encoder_norm(hidden)
            states[-1] = hidden
        return {"last_hidden_state": hidden, "hidden_states": states,
                "padding_mask": padding_mask, "lengths": feat_lens}


class Wav2Vec2ForCTC(nn.Module):
    """Encoder + CTC vocabulary head (fp32 logits)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.wav2vec2 = Wav2Vec2Model(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, waveform: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        out = self.wav2vec2(waveform, lengths)
        out["logits"] = self.lm_head(out["last_hidden_state"]).float()
        return out


class Wav2Vec2WithMultiModal(nn.Module):
    """In-layer image fusion: after each of the top
    ``num_cross_attention_layers`` encoder layers, the LayerNormed hidden
    state attends over the image features (dense, plain PyTorch) and a
    sigmoid gate mixes the result in."""

    def __init__(self, cfg: Wav2Vec2Config, m2_dim: int = 768,
                 num_cross_attention_layers: int = 1, dropout: float = 0.1):
        super().__init__()
        self.cfg = cfg
        self.n_fused = num_cross_attention_layers
        self.wav2vec2 = Wav2Vec2Model(cfg)
        for i in range(num_cross_attention_layers):
            self.add_module(f"cross_attn{i}", MultiHeadAttention(
                cfg.hidden_size, cfg.num_attention_heads, dropout, kdim=m2_dim))
            self.add_module(f"cross_norm{i}", nn.LayerNorm(cfg.hidden_size,
                                                           eps=cfg.layer_norm_eps))
            self.add_module(f"gate{i}", nn.Linear(2 * cfg.hidden_size, cfg.hidden_size))

    def forward(self, waveform: torch.Tensor, lengths: Optional[torch.Tensor],
                image: torch.Tensor, image_mask: Optional[torch.Tensor] = None,
                apply_mask: bool = False) -> Dict[str, Any]:
        """``image`` (B, Ti, m2_dim) features, ``image_mask`` (B, Ti) True = pad."""
        first_fused = self.cfg.num_hidden_layers - self.n_fused

        def fuse(i: int, hidden: torch.Tensor) -> torch.Tensor:
            j = i - first_fused
            if j < 0:
                return hidden
            img_bias = (make_padding_bias(image_mask, hidden.dtype) if image_mask is not None
                        else None)
            attn_out = getattr(self, f"cross_attn{j}").dense(
                getattr(self, f"cross_norm{j}")(hidden), image.to(hidden.dtype), img_bias)
            g = torch.sigmoid(getattr(self, f"gate{j}")(torch.cat([attn_out, hidden], -1)))
            return (1.0 - g) * hidden + g * attn_out

        # The reference's multimodal encoder never pads the frame axis.
        return self.wav2vec2(waveform, lengths, apply_mask, after_layer=fuse, pad_to_multiple=1)


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------


def convert_hf_state_dict(sd: Mapping[str, np.ndarray], cfg: Wav2Vec2Config) -> Dict[str, Any]:
    """HF Wav2Vec2Model/HubertModel state dict (numpy) → the flax parameter
    tree of :class:`Wav2Vec2Model` (``{"params": …}``, what
    ``convert.from_flax`` loads). Keys with or without the ``wav2vec2.`` /
    ``hubert.`` prefix; an ``lm_head`` pair (``Wav2Vec2ForCTC``) comes back
    under ``"lm_head"``."""

    def strip(k: str) -> str:
        for p in ("wav2vec2.", "hubert."):
            if k.startswith(p):
                return k[len(p):]
        return k

    sd = {strip(k): np.asarray(v) for k, v in sd.items()}

    def norm(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    fe: Dict[str, Any] = {}
    for i in range(len(cfg.conv_dim)):
        conv = {"kernel": np.transpose(sd[f"feature_extractor.conv_layers.{i}.conv.weight"],
                                       (2, 1, 0))}
        if cfg.conv_bias:
            conv["bias"] = sd[f"feature_extractor.conv_layers.{i}.conv.bias"]
        fe[f"conv{i}"] = conv
        if cfg.feat_extract_norm == "group" and i == 0:
            fe["group_norm"] = norm("feature_extractor.conv_layers.0.layer_norm")
        elif cfg.feat_extract_norm == "layer":
            fe[f"layer_norm{i}"] = norm(f"feature_extractor.conv_layers.{i}.layer_norm")
    p: Dict[str, Any] = {
        "feature_extractor": fe,
        "feature_projection_norm": norm("feature_projection.layer_norm"),
        "feature_projection": dense("feature_projection.projection"),
        "masked_spec_embed": sd.get("masked_spec_embed",
                                    np.zeros((cfg.hidden_size,), np.float32)),
    }
    # The positional conv: a plain weight, or weight norm's (g, v) folded.
    if "encoder.pos_conv_embed.conv.weight" in sd:
        w = sd["encoder.pos_conv_embed.conv.weight"]
    else:
        for gk in ("encoder.pos_conv_embed.conv.weight_g",
                   "encoder.pos_conv_embed.conv.parametrizations.weight.original0"):
            if gk in sd:
                g = sd[gk]
                v = sd[gk.replace("weight_g", "weight_v").replace("original0", "original1")]
                if g.ndim != v.ndim:
                    g = np.reshape(g, [g.shape[i] if i < g.ndim else 1 for i in range(v.ndim)])
                axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1)
                w = g * v / np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
                break
        else:
            raise KeyError("pos_conv weight not found")
    # torch grouped conv (out, in/groups, k) → flax (k, in/groups, out)
    p["pos_conv"] = {"conv": {"kernel": np.transpose(w, (2, 1, 0)),
                              "bias": sd["encoder.pos_conv_embed.conv.bias"]}}
    p["encoder_norm"] = norm("encoder.layer_norm")
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}"
        p[f"layer{i}"] = {
            "attention": {n: dense(f"{b}.attention.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": norm(f"{b}.layer_norm"),
            "final_layer_norm": norm(f"{b}.final_layer_norm"),
            "intermediate_dense": dense(f"{b}.feed_forward.intermediate_dense"),
            "output_dense": dense(f"{b}.feed_forward.output_dense"),
        }
    out: Dict[str, Any] = {"params": p}
    if "lm_head.weight" in sd:
        out["lm_head"] = dense("lm_head")
    return out


_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
                       "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
                       "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str | Path) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file → {name: numpy array}: an 8-byte little-endian
    header length, the JSON header, then each tensor's raw bytes at its
    ``data_offsets``. BF16 tensors are widened to fp32."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8 : 8 + n])
    data = memoryview(raw)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        buf = data[begin:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, dtype=np.dtype(_SAFETENSORS_DTYPES[info["dtype"]])
                                .newbyteorder("<"))
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def load_hf_checkpoint(model_dir: str | Path) -> Tuple[Wav2Vec2Config, Dict[str, Any]]:
    """A local HF wav2vec2/HuBERT(/ForCTC) directory → (config, the flax
    parameter tree of :class:`Wav2Vec2Model`, or of :class:`Wav2Vec2ForCTC`
    when the checkpoint has an ``lm_head``)."""
    model_dir = Path(model_dir)
    cfg = Wav2Vec2Config.from_hf(json.loads((model_dir / "config.json").read_text()))
    bins = sorted(model_dir.glob("*.bin"))
    safes = sorted(model_dir.glob("*.safetensors"))
    if safes:
        sd = read_safetensors(safes[0])
    elif bins:
        state = torch.load(bins[0], map_location="cpu", weights_only=True)
        sd = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
              for k, v in state.items()}
    else:
        raise FileNotFoundError(f"no checkpoint (*.bin, *.safetensors) in {model_dir}")
    variables = convert_hf_state_dict(sd, cfg)
    if "lm_head" in variables:
        variables = {"params": {"wav2vec2": variables["params"],
                                "lm_head": variables.pop("lm_head")}}
    return cfg, variables
