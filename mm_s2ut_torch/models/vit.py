"""Image encoders of the port: the timm ViT, the CLIP vision tower,
attention rollout, the checkpoint converters and the image preprocessing.

Port of ``mm_s2ut/models/vit.py``. :class:`VisionTransformer` is timm's
``vit_*_patch16_384.forward_features`` (577 × 768 features per 384² image
for ViT-B/16): a patch conv, the cls token and learned positions,
pre-norm blocks, a final LayerNorm (eps 1e-6 throughout, exact gelu).
A block's self-attention runs kernel A: the keys and values are padded
to a multiple of 8 (577 → 584) with a key bias built once per forward,
the queries keep their length (Tq ≠ S). With ``return_attn`` the
attention is the plain softmax, and each block's (B, H, T, T) weights
come back for :func:`attention_rollout`. :class:`CLIPVisionTransformer`
is HF's ``CLIPModel.vision_model`` (bias-free patch conv, class embedding,
pre-LayerNorm, quick-gelu blocks, eps 1e-5); it returns the hidden-state
list with no post-LayerNorm, and its attention stays plain, as in JAX.

Pixels come in NHWC, as the reference takes them; the patch conv is a
``Conv2d`` (``(D, 3, P, P)`` weight, a ``(P, P, 3, D)`` flax kernel) over
the permuted pixels, and patches flatten row-major over (h, w). The
converters (:func:`convert_timm_state_dict`, :func:`convert_clip_state_dict`)
give the JAX package's flax-layout dicts, which ``convert.from_flax``
loads; the loaders read local files with ``torch.load`` and the port's
own safetensors reader (no ``transformers``, no ``safetensors``).
:func:`preprocess_images` is the JAX function on uint8 arrays, with
``data/image_io.resize`` for PIL's resize. The modules hold no dropout;
``MMS2UTModel`` runs them for inference only (training through the
extractor is ROADMAP.md §1 item 4).
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mm_s2ut_torch.data.image_io import resize
from mm_s2ut_torch.models.layers import fp32_einsum
from mm_s2ut_torch.ops.attention import _rows_aligned, flash_attention_biased, padding_bias

IMAGENET_MEAN = (0.5, 0.5, 0.5)  # timm vit default (inception-style)
IMAGENET_STD = (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 384
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layernorm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # +cls → 577 for B/16 @ 384


VIT_VARIANTS = {
    "vit_tiny_patch16_384": ViTConfig(embed_dim=192, depth=12, num_heads=3),
    "vit_small_patch16_384": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vit_base_patch16_384": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16_384": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
}


@dataclass(frozen=True)
class CLIPVisionConfig:
    """HF's ``CLIPVisionConfig`` surface (the ``vit_openai`` extractor)."""

    image_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layernorm_eps: float = 1e-5

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


def _patches(conv: nn.Conv2d, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixels → (B, h·w, D) patch embeddings, row-major over
    (h, w), in the conv's dtype."""
    x = conv(pixels.to(conv.weight.dtype).permute(0, 3, 1, 2))
    return x.flatten(2).transpose(1, 2)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor,
                                                                                 torch.Tensor]:
    """softmax(q·kᵀ) v for pre-scaled (B, T, H, Dh) q: fp32 logits and
    softmax, the weights in q's dtype for the second product. Returns
    (out (B, T, H, Dh), weights (B, H, T, T))."""
    attn = torch.softmax(fp32_einsum("bqhd,bkhd->bhqk", q, k), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v), attn


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D, eps = cfg.embed_dim, cfg.layernorm_eps
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(D, eps=eps)
        self.qkv = nn.Linear(D, 3 * D)
        self.proj = nn.Linear(D, D)
        self.norm2 = nn.LayerNorm(D, eps=eps)
        self.fc1 = nn.Linear(D, int(D * cfg.mlp_ratio))
        self.fc2 = nn.Linear(int(D * cfg.mlp_ratio), D)

    def forward(self, x: torch.Tensor, key_bias: Optional[torch.Tensor] = None,
                return_attn: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``key_bias``: the (B, S) f32 bias of the keys padded to S (a
        multiple of 8), for the fused path."""
        B, T, D = x.shape
        H = self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(B, T, 3, H, D // H)
        q, k, v = qkv.unbind(2)  # timm's order: (B, T, 3, H, Dh)
        scale = (D // H) ** -0.5
        if not return_attn:
            pad = key_bias.shape[1] - T
            if pad:
                k = F.pad(k, (0, 0, 0, 0, 0, pad))
                v = F.pad(v, (0, 0, 0, 0, 0, pad))
            # The bf16 kernel reads 16-byte rows; q, k, v are views of qkv.
            q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
            out, attn = flash_attention_biased(q, k, v, key_bias, scale=scale), None
        else:
            out, attn = plain_attention(q * scale, k, v)
        x = x + self.proj(out.reshape(B, T, D))
        h = F.gelu(self.fc1(self.norm2(x)), approximate="none")
        return x + self.fc2(h), attn if return_attn else None


class VisionTransformer(nn.Module):
    """timm's ViT ``forward_features``: (B, S, S, 3) normalized pixels →
    ((B, T, D) features, [per-block (B, H, T, T) weights] with
    ``return_attn``, else None)."""

    FLAX_LEAVES = ("cls_token", "pos_embed")

    def __init__(self, cfg: ViTConfig = ViTConfig()):
        super().__init__()
        self.cfg = cfg
        D, P = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Conv2d(3, D, P, stride=P)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, D))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", ViTBlock(cfg))
        self.norm = nn.LayerNorm(D, eps=cfg.layernorm_eps)

    def forward(self, pixels: torch.Tensor, return_attn: bool = False
                ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        x = _patches(self.patch_embed, pixels)
        B, _, D = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, D), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        T = x.shape[1]
        key_bias = None
        if not return_attn:
            # One bias for every block: keys padded to a multiple of 8.
            S = T + (-T) % 8
            key_bias = padding_bias(torch.arange(S, device=x.device)[None, :].expand(B, S) >= T,
                                    B, S, x.device)
        attns = [] if return_attn else None
        for i in range(self.cfg.depth):
            x, attn = getattr(self, f"block{i}")(x, key_bias, return_attn)
            if return_attn:
                attns.append(attn)
        return self.norm(x), attns


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        D, eps = cfg.embed_dim, cfg.layernorm_eps
        self.num_heads = cfg.num_heads
        self.layer_norm1 = nn.LayerNorm(D, eps=eps)
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.layer_norm2 = nn.LayerNorm(D, eps=eps)
        self.fc1 = nn.Linear(D, int(D * cfg.mlp_ratio))
        self.fc2 = nn.Linear(int(D * cfg.mlp_ratio), D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        h = self.layer_norm1(x)
        q = (self.q_proj(h) * (D // H) ** -0.5).reshape(B, T, H, D // H)
        k = self.k_proj(h).reshape(B, T, H, D // H)
        v = self.v_proj(h).reshape(B, T, H, D // H)
        out, _ = plain_attention(q, k, v)
        x = x + self.out_proj(out.reshape(B, T, D))
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class CLIPVisionTransformer(nn.Module):
    """HF ``CLIPModel.vision_model``: (B, S, S, 3) pixels → the list of
    hidden states (entry 0 after ``pre_layernorm``, entry i after block i;
    no post-LayerNorm), as the reference reads ``hidden_states``."""

    FLAX_LEAVES = ("class_embedding", "pos_embed")

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        D, P = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Conv2d(3, D, P, stride=P, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, D))
        self.pre_layernorm = nn.LayerNorm(D, eps=cfg.layernorm_eps)
        for i in range(cfg.depth):
            self.add_module(f"block{i}", CLIPBlock(cfg))

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        x = _patches(self.patch_embed, pixels)
        B, _, D = x.shape
        x = torch.cat([self.class_embedding.to(x.dtype).expand(B, 1, D), x], dim=1)
        x = self.pre_layernorm(x + self.pos_embed.to(x.dtype))
        states = [x]
        for i in range(self.cfg.depth):
            x = getattr(self, f"block{i}")(x)
            states.append(x)
        return states


# --------------------------------------------------------------- preprocess

def preprocess_images(
    images: Sequence[np.ndarray],
    image_size: int = 384,
    mean: Optional[Tuple[float, ...]] = None,
    std: Optional[Tuple[float, ...]] = None,
    mode: str = "timm",
) -> np.ndarray:
    """(H, W, 3) uint8 images (``data.image_io.read_image``) → (B, S, S, 3)
    normalized float32, as the JAX function does with PIL images:

    * "timm" / "vit_timm" / "default": squash-resize to S×S, bicubic,
      mean/std 0.5;
    * "vit_openai": shortest edge to S bicubic (``round``), centre crop,
      CLIP's mean/std;
    * "vit_huggingface": resize to S×S bilinear, mean/std 0.5.
    """
    if mode in ("timm", "vit_timm", "default"):
        mean, std = mean or IMAGENET_MEAN, std or IMAGENET_STD

        def prep(img):
            return resize(img, (image_size, image_size), "bicubic")
    elif mode == "vit_openai":
        mean, std = mean or CLIP_MEAN, std or CLIP_STD

        def prep(img):
            h, w = img.shape[:2]
            scale = image_size / min(w, h)
            nw, nh = round(w * scale), round(h * scale)
            img = resize(img, (nw, nh), "bicubic")
            left, top = (nw - image_size) // 2, (nh - image_size) // 2
            return img[top: top + image_size, left: left + image_size]  # PIL's crop, inside
    elif mode == "vit_huggingface":
        mean, std = mean or IMAGENET_MEAN, std or IMAGENET_STD

        def prep(img):
            return resize(img, (image_size, image_size), "bilinear")
    else:
        raise ValueError(f"unknown preprocess mode {mode!r}")

    out = np.zeros((len(images), image_size, image_size, 3), np.float32)
    for i, img in enumerate(images):
        img = np.asarray(img, np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        out[i] = np.asarray(prep(img), np.float32) / 255.0
    return (out - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def attention_rollout(
    attns: List[np.ndarray], discard_ratio: float = 0.9, head_fusion: str = "max"
) -> np.ndarray:
    """Attention-rollout saliency: fuse the heads, drop the lowest weights
    (never those to the cls column), average with the identity, row
    normalise, and chain the products over the blocks. (B, H, T, T) per
    block → (B, T − 1) masks over the patches, each scaled to max 1."""
    result = None
    for attn in attns:
        a = np.asarray(attn)
        if head_fusion == "mean":
            fused = a.mean(axis=1)
        elif head_fusion == "max":
            fused = a.max(axis=1)
        else:
            fused = a.min(axis=1)
        B, T, _ = fused.shape
        flat = fused.reshape(B, -1)
        n_drop = int(flat.shape[1] * discard_ratio)
        if n_drop:
            idx = np.argpartition(flat, n_drop, axis=1)[:, :n_drop]
            for b in range(B):
                rows, cols = np.unravel_index(idx[b], (T, T))
                keep = cols != 0
                fused[b, rows[keep], cols[keep]] = 0.0
        eye = np.eye(T, dtype=fused.dtype)[None]
        a_hat = (fused + eye) / 2.0
        a_hat = a_hat / a_hat.sum(axis=-1, keepdims=True)
        result = a_hat if result is None else a_hat @ result
    mask = result[:, 0, 1:]
    return mask / (mask.max(axis=-1, keepdims=True) + 1e-12)


# --------------------------------------------------------------- converters

def _state_dict_numpy(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.float().numpy() if v.is_floating_point() else v.numpy())
            if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items() if isinstance(v, (torch.Tensor, np.ndarray))}


def convert_timm_state_dict(sd: Dict[str, np.ndarray], cfg: ViTConfig) -> Dict[str, Any]:
    """A timm ViT state dict (numpy) → the flax ``{"params": …}`` tree of
    the JAX package's ``VisionTransformer``."""
    p: Dict[str, Any] = {
        "cls_token": sd["cls_token"][0] if sd["cls_token"].ndim == 3 else sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "patch_embed": {
            # torch conv (D, 3, P, P) → flax (P, P, 3, D)
            "kernel": np.transpose(sd["patch_embed.proj.weight"], (2, 3, 1, 0)),
            "bias": sd["patch_embed.proj.bias"],
        },
        "norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
    }
    if p["cls_token"].ndim == 2:
        p["cls_token"] = p["cls_token"][None]
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        p[f"block{i}"] = {
            "norm1": {"scale": sd[f"{b}.norm1.weight"], "bias": sd[f"{b}.norm1.bias"]},
            "qkv": {"kernel": sd[f"{b}.attn.qkv.weight"].T, "bias": sd[f"{b}.attn.qkv.bias"]},
            "proj": {"kernel": sd[f"{b}.attn.proj.weight"].T, "bias": sd[f"{b}.attn.proj.bias"]},
            "norm2": {"scale": sd[f"{b}.norm2.weight"], "bias": sd[f"{b}.norm2.bias"]},
            "fc1": {"kernel": sd[f"{b}.mlp.fc1.weight"].T, "bias": sd[f"{b}.mlp.fc1.bias"]},
            "fc2": {"kernel": sd[f"{b}.mlp.fc2.weight"].T, "bias": sd[f"{b}.mlp.fc2.bias"]},
        }
    return {"params": p}


def load_timm_checkpoint(path: str, cfg: ViTConfig) -> Dict[str, Any]:
    """A timm ``pytorch_model.bin`` / ``.pth`` (also wrapped as
    ``{"model": …}``) → the flax tree of :func:`convert_timm_state_dict`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return convert_timm_state_dict(_state_dict_numpy(sd), cfg)


def convert_clip_state_dict(sd: Dict[str, np.ndarray], cfg: CLIPVisionConfig) -> Dict[str, Any]:
    """An HF CLIPVisionModel/CLIPModel state dict (numpy; keys with or
    without ``vision_model.``) → the flax tree of the JAX package's
    ``CLIPVisionTransformer``."""

    def strip(k: str) -> str:
        return k[len("vision_model."):] if k.startswith("vision_model.") else k

    sd = {strip(k): v for k, v in sd.items()}
    p: Dict[str, Any] = {
        "class_embedding": sd["embeddings.class_embedding"].reshape(-1),
        "pos_embed": sd["embeddings.position_embedding.weight"][None],
        "patch_embed": {
            "kernel": np.transpose(sd["embeddings.patch_embedding.weight"], (2, 3, 1, 0)),
        },
        "pre_layernorm": {
            "scale": sd["pre_layrnorm.weight"],  # HF's historical spelling
            "bias": sd["pre_layrnorm.bias"],
        },
    }
    for i in range(cfg.depth):
        b = f"encoder.layers.{i}"
        blk = {
            "layer_norm1": {"scale": sd[f"{b}.layer_norm1.weight"],
                            "bias": sd[f"{b}.layer_norm1.bias"]},
            "layer_norm2": {"scale": sd[f"{b}.layer_norm2.weight"],
                            "bias": sd[f"{b}.layer_norm2.bias"]},
            "fc1": {"kernel": sd[f"{b}.mlp.fc1.weight"].T, "bias": sd[f"{b}.mlp.fc1.bias"]},
            "fc2": {"kernel": sd[f"{b}.mlp.fc2.weight"].T, "bias": sd[f"{b}.mlp.fc2.bias"]},
        }
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            blk[proj] = {"kernel": sd[f"{b}.self_attn.{proj}.weight"].T,
                         "bias": sd[f"{b}.self_attn.{proj}.bias"]}
        p[f"block{i}"] = blk
    return {"params": p}


def load_clip_checkpoint(model_dir: str) -> Tuple[CLIPVisionConfig, Dict[str, Any]]:
    """A local HF CLIP checkpoint dir (``config.json`` and a ``*.bin`` or
    ``*.safetensors``, a ``.bin`` first) → (config, flax tree)."""
    from mm_s2ut_torch.models.wav2vec2 import read_safetensors

    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    vc = raw.get("vision_config", raw)
    cfg = CLIPVisionConfig(
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 16),
        embed_dim=vc.get("hidden_size", 768),
        depth=vc.get("num_hidden_layers", 12),
        num_heads=vc.get("num_attention_heads", 12),
        mlp_ratio=vc.get("intermediate_size", 3072) / vc.get("hidden_size", 768),
        layernorm_eps=vc.get("layer_norm_eps", 1e-5),
    )
    candidates = (sorted(glob.glob(os.path.join(model_dir, "*.bin")))
                  + sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))))
    if not candidates:
        raise FileNotFoundError(f"no checkpoint in {model_dir}")
    path = candidates[0]
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = _state_dict_numpy(torch.load(path, map_location="cpu", weights_only=True))
    return cfg, convert_clip_state_dict(sd, cfg)
