"""Typed configuration tree of the port.

The dataclasses and yaml keys are those of ``mm_s2ut/config.py``
(``ModelConfig``, ``MultimodalConfig``, ``GenerationConfig``,
``DataConfig``, ``TrainConfig``, ``MeshConfig``), so one ``config.yaml``
drives either package; keys the port does not know are kept as untyped
extras and written back by :func:`save_yaml`.

``yaml`` is imported inside :func:`load_yaml` and :func:`save_yaml` only:
PyYAML is not a dependency of the port's kernels or models.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

VISUAL_EXTRACTOR_TYPE_CHOICES = (None, "", "vit", "detr", "resnet", "resnet+encoder")
MULTIMODAL_ATTENTION_TYPE_CHOICES = (
    None, "selective_attention", "multimodal_attention",
    "external_multimodal_transformer", "bridge_tower",
)


@dataclass
class MultimodalConfig:
    SA_image_dropout: float = 0.1
    SA_text_dropout: float = 0.0
    SA_attention_dropout: float = 0.1
    image_pre_norm: bool = True
    is_fusion_top: bool = True
    image_feat_path: List[str] = field(default_factory=list)
    image_feat_dim: List[int] = field(default_factory=lambda: [768])
    flickr30k_root: str = ""
    visual_extractor_type_choices: List[Any] = field(
        default_factory=lambda: list(VISUAL_EXTRACTOR_TYPE_CHOICES)
    )
    load_visual_extractor_type: Optional[str] = None
    load_visual_extractor: Optional[str] = None
    image_input_size: int = 224
    image_mean: List[float] = field(default_factory=list)
    image_std: List[float] = field(default_factory=list)
    visual_extractor_args: Dict[str, Any] = field(default_factory=dict)
    modality_dropout: float = -0.5
    audio_dropout: float = -0.5
    multimodal_attention_type_choices: List[Any] = field(
        default_factory=lambda: list(MULTIMODAL_ATTENTION_TYPE_CHOICES)
    )
    multimodal_attention_type: Optional[str] = "multimodal_attention"
    use_selective_gate: bool = True
    is_merge_text_img: bool = False
    only_img: bool = False
    multimodal_extractor_type: Optional[str] = None
    num_queries: int = 32
    num_query_layers: int = 4
    num_multimodal_layers: int = 2
    self_attention_first: bool = False
    num_cross_attention_layers: int = 1
    external_multimodal_transformer_layers: int = 6

    def validate(self) -> "MultimodalConfig":
        attn_choices = [
            c for c in self.multimodal_attention_type_choices
            if c in MULTIMODAL_ATTENTION_TYPE_CHOICES
        ] or list(MULTIMODAL_ATTENTION_TYPE_CHOICES)
        vis_choices = [
            c for c in self.visual_extractor_type_choices
            if c in VISUAL_EXTRACTOR_TYPE_CHOICES
        ] or list(VISUAL_EXTRACTOR_TYPE_CHOICES)
        if self.multimodal_attention_type not in attn_choices:
            raise ValueError(
                f"multimodal_attention_type={self.multimodal_attention_type!r} "
                f"not in {attn_choices}"
            )
        if self.load_visual_extractor_type not in vis_choices:
            raise ValueError(
                f"load_visual_extractor_type={self.load_visual_extractor_type!r} "
                f"not in {vis_choices}"
            )
        if self.image_feat_path and len(self.image_feat_path) != len(self.image_feat_dim):
            raise ValueError("image_feat_path and image_feat_dim must align 1:1")
        return self


@dataclass
class MultitaskTaskConfig:
    task_name: str = "aux"
    decoder_type: str = "ctc"
    loss_weight: float = 1.0
    vocab_size: int = 0
    label_smoothing: float = 0.0
    decoder_layers: int = 2
    decoder_embed_dim: int = 256
    decoder_attention_heads: int = 4


@dataclass
class NoiseConfig:
    noise_wav_dir: str = ""
    noise_prob: float = 0.0
    noise_snr_low: float = 5.0
    noise_snr_high: float = 20.0


@dataclass
class DataConfig:
    data_root: str = ""
    audio_root: str = ""
    standardize_audio: bool = False
    use_audio_input: bool = True
    vocab_filename: str = "dict.txt"
    prepend_tgt_lang_tag_as_bos: bool = False
    prepend_bos_and_append_tgt_lang_tag: bool = False
    tgt_lang: str = ""
    eos_token: str = ""
    num_mel_bins: int = 80
    sample_rate: int = 16000
    target_speaker_embed: str = ""
    target_is_code: bool = True
    target_code_size: int = 1000
    n_frames_per_step: int = 1
    pre_tokenizer: Dict[str, Any] = field(default_factory=dict)
    bpe_tokenizer: Dict[str, Any] = field(default_factory=dict)
    max_tokens: int = 8000
    max_source_positions: int = 4000
    max_target_positions: int = 3000
    num_buckets: int = 8
    noise: NoiseConfig = field(default_factory=NoiseConfig)


@dataclass
class ModelConfig:
    arch: str = "mm_s2ut_transformer"
    conv_kernel_sizes: List[int] = field(default_factory=lambda: [5, 5])
    conv_channels: int = 1024
    input_feat_per_channel: int = 80
    input_channels: int = 1
    encoder_embed_dim: int = 512
    encoder_ffn_embed_dim: int = 2048
    encoder_layers: int = 12
    encoder_attention_heads: int = 8
    encoder_normalize_before: bool = True
    decoder_embed_dim: int = 512
    decoder_ffn_embed_dim: int = 2048
    decoder_layers: int = 6
    decoder_attention_heads: int = 8
    decoder_normalize_before: bool = True
    share_decoder_input_output_embed: bool = True
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation_fn: str = "relu"
    # Read by no module of either package: every LayerNorm on the path
    # uses flax's default epsilon 1e-6 (see models/layers.py LN_EPS).
    layernorm_eps: float = 1e-5
    max_source_positions: int = 6000
    max_target_positions: int = 3000
    speech_encoder_type: str = "conv_transformer"
    w2v_args: Dict[str, Any] = field(default_factory=dict)
    speaker_embed_dim: int = 0
    vocab_size: int = 1010
    n_frames_per_step: int = 1
    ctc_weight: float = 0.0
    dtype: str = "bfloat16"
    use_flash_attention: bool = True
    checkpoint_activations: bool = False
    sequence_parallel: bool = False
    encoder_causal_attention: bool = False
    encoder_attention_window: int = 0
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    multitask: List[MultitaskTaskConfig] = field(default_factory=list)
    multimodal: MultimodalConfig = field(default_factory=MultimodalConfig)


@dataclass
class GenerationConfig:
    beam: int = 10
    max_len_a: float = 1.0
    max_len_b: int = 200
    len_penalty: float = 1.0
    unk_penalty: float = 0.0
    max_tokens: int = 8000
    nbest: int = 1
    kv_cache_dtype: str = "bfloat16"


@dataclass
class TrainConfig:
    lr: float = 5e-4
    warmup_updates: int = 10000
    warmup_init_lr: float = 1e-7
    lr_scheduler: str = "inverse_sqrt"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.98
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 10.0
    update_freq: int = 1
    max_update: int = 400000
    label_smoothing: float = 0.2
    rdrop_alpha: float = 0.0
    seed: int = 1
    save_dir: str = "checkpoints"
    save_interval_updates: int = 1000
    keep_last_checkpoints: int = 5
    log_interval: int = 100
    best_checkpoint_metric: str = "loss"
    maximize_best_checkpoint_metric: bool = False
    freezing_updates: int = 0
    eval_inference: bool = False
    eval_vocoder_path: str = ""
    eval_vocoder_cfg: str = ""
    checkpoint_activations: bool = False


@dataclass
class MeshConfig:
    """The reference's device mesh, over torch.distributed processes
    (``parallel/mesh.py``): ``data`` is -1 or the world size over
    ``model`` × ``pipe``; ``model`` ranks split the Megatron projections
    (``parallel/tensor.py``), ``pipe`` ranks the stages of a pipelined
    encoder (``model.pipeline_stages``, ``parallel/pipeline.py``)."""

    data: int = -1  # -1: every process on the data axis
    model: int = 1
    pipe: int = 1


@dataclass
class Config:
    task: str = "multimodal_speech_to_speech"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def from_dict(cls, data: Any):
    """A config dataclass from a (yaml) dict; nested dataclasses recurse."""
    if data is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs, unknown = {}, {}
    for key, value in dict(data).items():
        if key not in fields:
            unknown[key] = value
            continue
        f = fields[key]
        default = (
            f.default_factory() if f.default_factory is not dataclasses.MISSING
            else f.default
        )
        kwargs[key] = (
            from_dict(type(default), value) if dataclasses.is_dataclass(default)
            else value
        )
    obj = cls(**kwargs)
    if unknown:
        # Unknown keys are kept, as the JAX package keeps them.
        object.__setattr__(obj, "_extra", unknown)
    return obj


def load_yaml(path: str | Path) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def to_dict(cfg: Any) -> dict:
    """A config dataclass as a plain dict, its untyped extras included."""
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            value = to_dict(value)
        elif isinstance(value, list):
            value = [to_dict(v) if dataclasses.is_dataclass(v) else v for v in value]
        out[f.name] = value
    out.update(getattr(cfg, "_extra", {}))
    return out


def save_yaml(cfg: Any, path: str | Path) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)


def load_config(path: str | Path) -> Config:
    """Load a full framework config yaml (the file a Trainer saves)."""
    cfg = from_dict(Config, load_yaml(path))
    cfg.model.multitask = [
        t if isinstance(t, MultitaskTaskConfig) else MultitaskTaskConfig(**t)
        for t in cfg.model.multitask
    ]
    want = cfg.model.input_feat_per_channel * cfg.model.input_channels
    if want != cfg.data.num_mel_bins:
        raise ValueError(
            f"model.input_feat_per_channel×input_channels = {want} must equal "
            f"data.num_mel_bins = {cfg.data.num_mel_bins}"
        )
    return cfg
