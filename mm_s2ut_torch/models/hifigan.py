"""Unit HiFi-GAN vocoder with duration prediction (unit ids → wav).

Port of ``mm_s2ut/models/hifigan.py``: ``CodeHiFiGAN``,
``DurationPredictor``, ``length_regulate`` and ``HiFiGANGenerator`` as
plain ``nn.Conv1d`` / ``nn.ConvTranspose1d`` (the reference's folded and
grouped MRF repackings are TPU matrix-unit layouts of the same convs and
are not carried over), with the speaker embedding (``spkr``) of a
multi-speaker vocoder appended to every frame, and ``vocode_bucketed``
(the generator at the smallest of a few frame budgets that covers the
batch). ``load_fairseq_checkpoint``
maps a fairseq ``code_hifigan`` state dict onto this module. Submodule names mirror the
flax parameter tree (``generator.ups_0``, ``resblocks_3.convs1_2`` …).
"""
from __future__ import annotations

import argparse
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mm_s2ut_torch.models.layers import layer_norm

LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class HiFiGANConfig:
    """The fairseq/config.json surface of code_hifigan."""

    num_embeddings: int = 1000
    embedding_dim: int = 128
    model_in_dim: int = 128
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 8, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    dur_prediction: bool = True
    var_pred_hidden_dim: int = 128
    var_pred_kernel_size: int = 3
    var_pred_dropout: float = 0.5
    num_speakers: int = 0
    speaker_embedding_dim: int = 0

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h

    @classmethod
    def from_json(cls, path: str | Path) -> "HiFiGANConfig":
        raw = json.loads(Path(path).read_text())

        def tup(x):
            return tuple(tuple(i) if isinstance(i, (list, tuple)) else i for i in x)

        return cls(
            num_embeddings=raw.get("num_embeddings", 1000),
            embedding_dim=raw.get("embedding_dim", 128),
            model_in_dim=raw.get("model_in_dim", raw.get("embedding_dim", 128)),
            upsample_initial_channel=raw.get("upsample_initial_channel", 512),
            upsample_rates=tuple(raw.get("upsample_rates", (5, 4, 4, 2, 2))),
            upsample_kernel_sizes=tuple(raw.get("upsample_kernel_sizes", (11, 8, 8, 4, 4))),
            resblock_kernel_sizes=tuple(raw.get("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilation_sizes=tup(raw.get("resblock_dilation_sizes", ((1, 3, 5),) * 3)),
            dur_prediction=bool(raw.get("dur_prediction_weight", raw.get("dur_prediction", True))),
            var_pred_hidden_dim=raw.get("var_pred_hidden_dim", 128),
            var_pred_kernel_size=raw.get("var_pred_kernel_size", 3),
            var_pred_dropout=raw.get("var_pred_dropout", 0.5),
            num_speakers=raw.get("num_speakers", 0),
            speaker_embedding_dim=raw.get("speaker_embedding_dim", 0),
        )


class ResBlock(nn.Module):
    """MRF residual block: pairs of dilated/plain convs with leaky ReLU."""

    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}", nn.Conv1d(
                channels, channels, kernel_size, dilation=d, padding=(kernel_size - 1) * d // 2))
            self.add_module(f"convs2_{i}", nn.Conv1d(
                channels, channels, kernel_size, padding=(kernel_size - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T)
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            h = getattr(self, f"convs2_{i}")(F.leaky_relu(h, LRELU_SLOPE))
            x = x + h
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        c = cfg
        self.n_up = len(c.upsample_rates)
        self.n_res = len(c.resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(c.model_in_dim, c.upsample_initial_channel, 7, padding=3)
        ch = c.upsample_initial_channel
        for i, (rate, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch_in, ch = ch, c.upsample_initial_channel // (2 ** (i + 1))
            # Output length T·rate, as the reference's VALID convT trimmed
            # by (k - rate)//2 on each side.
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(ch_in, ch, k, rate, padding=(k - rate) // 2))
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * self.n_res + j}", ResBlock(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, model_in_dim) frames → (B, T·hop) waveform in [-1, 1]."""
        x = self.conv_pre(x.transpose(1, 2))
        for i in range(self.n_up):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(self.n_res):
                h = getattr(self, f"resblocks_{i * self.n_res + j}")(x)
                acc = h if acc is None else acc + h
            x = acc / self.n_res
        x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x)[:, 0]


class DurationPredictor(nn.Module):
    """fairseq VariancePredictor: conv→ReLU→LN ×2 → linear → log-duration."""

    def __init__(self, in_dim: int, hidden: int = 128, kernel_size: int = 3):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv1 = nn.Conv1d(in_dim, hidden, kernel_size, padding=pad)
        self.ln1 = layer_norm(hidden)
        self.conv2 = nn.Conv1d(hidden, hidden, kernel_size, padding=pad)
        self.ln2 = layer_norm(hidden)
        self.proj = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        for conv, ln in ((self.conv1, self.ln1), (self.conv2, self.ln2)):
            if valid is not None:
                # Zero padded units before every conv: a padded batch then
                # computes what per-utterance inputs would.
                x = x * valid[..., None].to(x.dtype)
            x = ln(F.relu(conv(x.transpose(1, 2)).transpose(1, 2)))
        return self.proj(x)[..., 0]


def length_regulate(
    embeddings: torch.Tensor,  # (B, L, D)
    durations: torch.Tensor,  # (B, L) int, 0 for padding units
    max_frames: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape repeat_interleave: frame t takes the unit whose
    cumulative duration first exceeds t. Returns ((B, max_frames, D),
    (B,) valid frame counts clamped to the budget)."""
    csum = torch.cumsum(durations, dim=1)
    t = torch.arange(max_frames, device=embeddings.device, dtype=csum.dtype)
    idx = torch.searchsorted(csum.contiguous(), t.expand(csum.shape[0], -1).contiguous(), right=True)
    idx = idx.clamp_max(embeddings.shape[1] - 1)
    frames = torch.gather(embeddings, 1, idx[..., None].expand(-1, -1, embeddings.shape[2]))
    total = csum[:, -1].clamp_max(max_frames)
    mask = (t[None, :] < total[:, None]).to(embeddings.dtype)
    return frames * mask[..., None], total


class CodeHiFiGAN(nn.Module):
    """Unit-sequence → waveform, with optional duration prediction."""

    def __init__(self, cfg: HiFiGANConfig, max_frames: int = 2048):
        super().__init__()
        self.cfg = cfg
        self.max_frames = max_frames
        self.dict = nn.Embedding(cfg.num_embeddings, cfg.embedding_dim)
        if cfg.dur_prediction:
            self.dur_predictor = DurationPredictor(
                cfg.embedding_dim, cfg.var_pred_hidden_dim, cfg.var_pred_kernel_size
            )
        if cfg.num_speakers:
            # Speaker-conditioned vocoding: each frame's unit embedding gets
            # the speaker's embedding appended (model_in_dim counts both).
            self.spkr = nn.Embedding(cfg.num_speakers, cfg.speaker_embedding_dim)
        self.generator = HiFiGANGenerator(cfg)

    def _with_speaker(self, frames: torch.Tensor, speaker: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, D) frames ‖ the (B,) speakers' embeddings, when the
        vocoder has speakers and ``speaker`` is given."""
        if not self.cfg.num_speakers or speaker is None:
            return frames
        spk = self.spkr(speaker)[:, None, :].expand(*frames.shape[:2], -1)
        return torch.cat([frames, spk.to(frames.dtype)], dim=-1)

    @torch.no_grad()
    def unit_durations(
        self,
        units: torch.Tensor,  # (B, L) unit ids
        unit_lengths: Optional[torch.Tensor] = None,  # (B,)
        dur_prediction: bool = True,
    ) -> torch.Tensor:
        """(B, L) per-unit frame durations (predicted, or 1 per unit),
        zeroed past ``unit_lengths``."""
        B, L = units.shape
        if unit_lengths is None:
            unit_lengths = torch.full((B,), L, dtype=torch.long, device=units.device)
        valid = torch.arange(L, device=units.device)[None, :] < unit_lengths[:, None]
        if self.cfg.dur_prediction and dur_prediction:
            log_dur = self.dur_predictor(self.dict(units), valid=valid)
            dur = torch.clamp(torch.round(torch.exp(log_dur) - 1.0), min=1.0).long()
        else:
            dur = torch.ones((B, L), dtype=torch.long, device=units.device)
        return dur * valid.long()

    @torch.no_grad()
    def vocode_frames(self, frame_units: torch.Tensor,
                      speaker: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T) length-regulated unit ids, one per frame → (B, T·hop)
        waveform: the half of :meth:`forward` after length regulation
        (``infer/streaming_vocoder.py`` feeds it halo windows); ``speaker``
        (B,) speaker ids."""
        return self.generator(self._with_speaker(self.dict(frame_units), speaker))

    @torch.no_grad()
    def forward(
        self,
        units: torch.Tensor,  # (B, L) unit ids
        unit_lengths: Optional[torch.Tensor] = None,  # (B,)
        dur_prediction: bool = True,
        speaker: Optional[torch.Tensor] = None,  # (B,) speaker ids
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """((B, max_frames·hop) waveform, (B,) valid sample counts)."""
        dur = self.unit_durations(units, unit_lengths, dur_prediction)
        return self.vocode_durations(units, dur, self.max_frames, speaker)

    @torch.no_grad()
    def vocode_durations(self, units: torch.Tensor, durations: torch.Tensor, max_frames: int,
                         speaker: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Units (B, L) held for ``durations`` (B, L) frames each, length-
        regulated into a ``max_frames`` budget and vocoded: ((B, max_frames·
        hop) waveform, (B,) valid sample counts)."""
        frames, n_frames = length_regulate(self.dict(units), durations, max_frames)
        return self.generator(self._with_speaker(frames, speaker)), n_frames * self.cfg.hop_length


@torch.no_grad()
def vocode_bucketed(
    model: CodeHiFiGAN,
    units: torch.Tensor,  # (B, L) unit ids
    unit_lengths: Optional[torch.Tensor] = None,  # (B,)
    buckets: Sequence[int] = (256, 512, 1024),
    dur_prediction: bool = True,
    speaker: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-bucketed vocoding (``mm_s2ut/models/hifigan.py:476``): the
    durations are predicted once, and the generator runs at the smallest
    budget in ``buckets`` that covers the batch's frames (one ``.item()``
    picks it on the host), since its convs cost in proportion to the
    frames. The waveforms come back padded to ``buckets[-1]·hop``; a batch
    that needs more frames than the largest bucket is cut there, and its
    lengths capped, as a fixed budget cuts it. A batch whose frames end
    within the generator's receptive field of its bucket's end gets other
    last samples than a larger budget gives (the convs' zero padding meets
    them), so the CLIs keep the reference's fixed budget."""
    buckets = sorted(buckets)
    dur = model.unit_durations(units, unit_lengths, dur_prediction)
    need = int(dur.sum(1).max())
    budget = next((b for b in buckets if b >= need), buckets[-1])
    wav, n = model.vocode_durations(units, dur, budget, speaker)
    return F.pad(wav, (0, (buckets[-1] - budget) * model.cfg.hop_length)), n


def _fold_weight_norm(sd: Dict[str, torch.Tensor], prefix: str) -> torch.Tensor:
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    g, v = sd[f"{prefix}.weight_g"].float(), sd[f"{prefix}.weight_v"].float()
    norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.dim())), keepdim=True))
    return g * v / norm


def load_fairseq_checkpoint(path: str | Path, cfg: HiFiGANConfig) -> Dict[str, torch.Tensor]:
    """A fairseq CodeHiFiGANVocoder checkpoint (.pt) → a state dict for
    :class:`CodeHiFiGAN` (weight norm folded)."""
    # torch.load's default weights_only=True refuses any pickled class it
    # does not know, and fairseq checkpoints pickle an argparse.Namespace
    # beside the tensors; allow exactly that class, so the loader still
    # runs no other code from the file.
    with torch.serialization.safe_globals([argparse.Namespace]):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if "generator" in sd:
        sd = sd["generator"]
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    if cfg.dur_prediction and "dur_predictor.conv1.0.weight" not in sd:
        raise ValueError(
            f"{path}: config requests dur_prediction but the checkpoint has no "
            "dur_predictor weights; set \"dur_prediction\": false in the vocoder config"
        )
    out: Dict[str, torch.Tensor] = {"dict.weight": sd["dict.weight"]}
    convs = {"conv_pre", "conv_post"}
    convs |= {f"ups.{i}" for i in range(len(cfg.upsample_rates))}
    convs |= {
        m.group(1) for k in sd
        if (m := re.match(r"(resblocks\.\d+\.convs[12]\.\d+)\.(weight|weight_v)$", k))
    }
    for name in convs:
        ours = re.sub(r"^ups\.(\d+)$", r"ups_\1", name)
        ours = re.sub(r"^resblocks\.(\d+)\.(convs[12])\.(\d+)$", r"resblocks_\1.\2_\3", ours)
        out[f"generator.{ours}.weight"] = _fold_weight_norm(sd, name)
        out[f"generator.{ours}.bias"] = sd[f"{name}.bias"]
    if cfg.dur_prediction:
        for i in (1, 2):
            out[f"dur_predictor.conv{i}.weight"] = sd[f"dur_predictor.conv{i}.0.weight"]
            out[f"dur_predictor.conv{i}.bias"] = sd[f"dur_predictor.conv{i}.0.bias"]
            out[f"dur_predictor.ln{i}.weight"] = sd[f"dur_predictor.ln{i}.weight"]
            out[f"dur_predictor.ln{i}.bias"] = sd[f"dur_predictor.ln{i}.bias"]
        out["dur_predictor.proj.weight"] = sd["dur_predictor.proj.weight"]
        out["dur_predictor.proj.bias"] = sd["dur_predictor.proj.bias"]
    if cfg.num_speakers:
        out["spkr.weight"] = sd["spkr.weight"]
    return {k: v.float() for k, v in out.items()}
