"""ResNet-18 / 3-D conv visual frontend (an AV-HuBERT-style video encoder).

Port of ``mm_s2ut/models/resnet_encoder.py``, which no shipped config
reaches (the reference's module is vestigial): a Conv3d temporal stem,
BatchNorm, ReLU and a 3-D max-pool, then a ResNet-18 trunk per frame and
a global average pool, giving (B, T, 512) frame features; ``SubModel``
projects them to the fusion width, optionally through pre-norm
transformer layers (kernel A). Inference only: BatchNorm uses its
running statistics, which :func:`from_flax_variables` takes from flax's
``batch_stats`` collection (epsilon 1e-5, flax's default). Videos come in
as (B, T, H, W, C), the reference's layout.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mm_s2ut_torch.convert import flatten, from_flax
from mm_s2ut_torch.models.layers import TransformerEncoderLayer
from mm_s2ut_torch.ops.attention import padding_bias

BN_EPS = 1e-5  # flax nn.BatchNorm default


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels, eps=BN_EPS)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels, eps=BN_EPS)
        if stride != 1 or in_channels != channels:
            self.downsample = nn.Conv2d(in_channels, channels, 1, stride, bias=False)
            self.bn_down = nn.BatchNorm2d(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = self.bn_down(self.downsample(x)) if hasattr(self, "downsample") else x
        return F.relu(h + residual)


class ResNet18Trunk(nn.Module):
    """Layers 2-5 of ResNet-18 (the stem is the 3-D conv frontend), then a
    global average pool: (N, C, H, W) → (N, 512)."""

    def __init__(self, in_channels: int = 64):
        super().__init__()
        for stage, (ch, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            for block in range(2):
                self.add_module(f"layer{stage + 1}_{block}",
                                BasicBlock(in_channels, ch, stride if block == 0 else 1))
                in_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for module in self.children():
            x = module(x)
        return x.mean(dim=(2, 3))


class ResEncoder(nn.Module):
    """(B, T, H, W, C) video → (B, T, 512) frame features."""

    def __init__(self, in_channels: int = 1, frontend_channels: int = 64):
        super().__init__()
        self.frontend3d = nn.Conv3d(in_channels, frontend_channels, (5, 7, 7), stride=(1, 2, 2),
                                    padding=(2, 3, 3), bias=False)
        self.bn0 = nn.BatchNorm3d(frontend_channels, eps=BN_EPS)
        self.trunk = ResNet18Trunk(frontend_channels)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("ResEncoder: training (batch statistics) is not ported")
        B, T = video.shape[:2]
        x = self.frontend3d(video.to(self.frontend3d.weight.dtype).permute(0, 4, 1, 2, 3))
        x = F.max_pool3d(F.relu(self.bn0(x)), (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        x = x.transpose(1, 2).reshape(B * T, *x.shape[1:2], *x.shape[3:])  # fold time into batch
        return self.trunk(x).reshape(B, T, -1)


class SubModel(nn.Module):
    """ResEncoder (or given frame features) → a projection to ``out_dim``
    → ``num_layers`` pre-norm transformer layers."""

    def __init__(self, out_dim: int = 768, num_layers: int = 0, num_heads: int = 8,
                 in_channels: int = 1):
        super().__init__()
        self.resnet = ResEncoder(in_channels)
        self.proj = nn.Linear(512, out_dim)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(out_dim, out_dim * 4, num_heads))

    def forward(self, video: Optional[torch.Tensor] = None,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (video is None) == (features is None):
            raise ValueError("pass exactly one of video/features")
        x = self.resnet(video) if video is not None else features.to(self.proj.weight.dtype)
        x = self.proj(x)
        if self.num_layers:
            bias = padding_bias(None, x.shape[0], x.shape[1], x.device)
            for i in range(self.num_layers):
                x = getattr(self, f"layer{i}")(x, bias)
        return x


def from_flax_variables(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax ``{"params": …, "batch_stats": …}`` → a complete state dict for
    ``model``: the parameters through ``convert.from_flax``, each
    BatchNorm's ``mean``/``var`` as its running statistics."""
    sd = from_flax(variables["params"], model)
    stats = flatten(variables.get("batch_stats", {}))
    used = set()
    for name, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            prefix = name.replace(".", "/")
            for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
                key = f"{prefix}/{leaf}"
                if key not in stats:
                    raise KeyError(f"from_flax_variables: no batch_stats leaf {key!r}")
                used.add(key)
                sd[f"{name}.{buf}"] = torch.tensor(stats[key], dtype=torch.float32)
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    unused = sorted(set(stats) - used)
    if unused:
        raise KeyError(f"from_flax_variables: batch_stats with no BatchNorm: {unused}")
    return sd
