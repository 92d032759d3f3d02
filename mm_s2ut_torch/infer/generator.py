"""High-level generator: encode → tiled decode state → beam search.

Port of ``UnitGenerator.generate`` and ``format_generation_output`` from
``mm_s2ut/infer/generator.py``, with its logit ensemble (several models of
one architecture, fairseq's ``--path a.pt:b.pt``). JAX's ahead-of-time
executables are not ported (ROADMAP.md §1 item 9).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from mm_s2ut_torch.config import GenerationConfig
from mm_s2ut_torch.infer.beam_search import beam_search, tile_state_for_beams, trim_hypothesis


def _tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


class UnitGenerator:
    """Beam-search generator over an ``MMS2UTModel`` or an
    ``MMXMTransformerModel`` (on the model's device). ``eos_id``/``bos_id``
    override the dictionary's EOS: the XM path starts from and stops on
    its target language tag.

    ``model`` may be a sequence of models of one architecture on one
    device: a logit ensemble. Each member encodes the batch and keeps its
    own tiled decode state, and a step's scores are log(mean_i
    softmax(logits_i)) in fp32. One model, alone or in a list of one,
    decodes through its own ``decode_step``."""

    def __init__(
        self,
        model,
        gen_cfg: GenerationConfig = GenerationConfig(),
        eos_id: int = 2,
        bos_id: int = 2,
        pad_id: int = 1,
        unk_id: int = 3,
        max_target_positions: int = 3000,
    ):
        self.models = tuple(model) if isinstance(model, (list, tuple)) else (model,)
        self.model = self.models[0]
        self.cfg = gen_cfg
        self.eos_id, self.bos_id, self.pad_id, self.unk_id = eos_id, bos_id, pad_id, unk_id
        self.max_target_positions = max_target_positions
        self.vocab_size = self.model.cfg.vocab_size

    def _max_len(self, src_frames: int) -> int:
        """The search's budget a·src + b, where src counts the model's
        input positions per ``source_downsample_ratio`` (fbank frames; for
        raw-waveform encoders, their frames: 320 samples, or 2560 through
        the XM adaptor), rounded up."""
        ratio = getattr(self.model, "source_downsample_ratio", 1)
        src_positions = -(-src_frames // ratio)
        return int(min(
            self.cfg.max_len_a * src_positions + self.cfg.max_len_b,
            self.max_target_positions - 1,
        ))

    @torch.no_grad()
    def generate(
        self,
        src_features,  # (B, T, F) fbank frames, or (B, S) waveforms
        src_lengths,  # (B,) frames, or samples
        imgs_list: Sequence[Any] = (),
        img_masks_list: Sequence[Any] = (),
    ) -> List[List[Dict[str, Any]]]:
        """Per example, ``beam`` hypotheses sorted by score:
        {"tokens": List[int], "score": float}."""
        dev = self.model.device
        feats = _tensor(src_features, dev, torch.float32)
        lens = _tensor(src_lengths, dev, torch.long)
        B = feats.shape[0]
        K = self.cfg.beam
        for img in imgs_list:
            if img.shape[0] != B:
                raise ValueError(f"image batch {img.shape[0]} != audio batch {B}")
        imgs = [_tensor(x, dev, torch.float32) for x in imgs_list]
        masks = [_tensor(x, dev, torch.bool) for x in img_masks_list]
        max_len = self._max_len(int(feats.shape[1]))
        states = tuple(
            tile_state_for_beams(m.decode_init(m.encode(feats, lens, imgs, masks), max_len + 1,
                                               kv_dtype=self.cfg.kv_cache_dtype), K)
            for m in self.models)
        if len(self.models) == 1:
            step, state = self.model.decode_step, states[0]
        else:
            step, state = self._ensemble_step, states
        seqs, scores = beam_search(
            step, state, B,
            beam_size=K, max_len=max_len, eos_id=self.eos_id, bos_id=self.bos_id,
            pad_id=self.pad_id, vocab_size=self.vocab_size,
            len_penalty=self.cfg.len_penalty, unk_penalty=self.cfg.unk_penalty,
            unk_id=self.unk_id,
        )
        seqs = seqs.cpu().numpy()
        scores = scores.cpu().numpy()
        return [
            [
                {"tokens": trim_hypothesis(seqs[b, k], self.eos_id, self.pad_id),
                 "score": float(scores[b, k])}
                for k in range(K)
            ]
            for b in range(B)
        ]


    def _ensemble_step(self, tokens: torch.Tensor, states):
        """Every member's decode step; log of the mean of their fp32
        probabilities (normalised, so the search's own log_softmax leaves
        it as it is)."""
        outs = [m.decode_step(tokens, st) for m, st in zip(self.models, states)]
        logps = torch.stack([torch.log_softmax(logits.float(), dim=-1) for logits, _ in outs])
        avg = torch.logsumexp(logps, dim=0) - math.log(len(outs))
        return avg, tuple(st for _, st in outs)


def format_generation_output(
    sample_ids: Sequence[int],
    hypos: Sequence[Sequence[Dict[str, Any]]],
    dictionary,
    targets: Optional[Sequence[Sequence[int]]] = None,
    nbest: int = 1,
    strip_ids: Sequence[int] = (),
) -> List[str]:
    """fairseq-generate-format T-/H-/D- lines."""
    strip = set(int(s) for s in strip_ids)

    def to_str(tokens) -> str:
        if strip:
            tokens = [t for t in tokens if int(t) not in strip]
        return dictionary.string(tokens)

    lines: List[str] = []
    for i, sid in enumerate(sample_ids):
        if targets is not None:
            lines.append(f"T-{sid}\t{to_str(targets[i])}")
        for hyp in hypos[i][:nbest]:
            text = to_str(hyp["tokens"])
            lines.append(f"H-{sid}\t{hyp['score']:.4f}\t{text}")
            lines.append(f"D-{sid}\t{hyp['score']:.4f}\t{text}")
    return lines
