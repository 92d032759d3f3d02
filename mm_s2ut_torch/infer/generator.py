"""High-level generator: encode → tiled decode state → beam search.

Port of ``UnitGenerator.generate`` and ``format_generation_output`` from
``mm_s2ut/infer/generator.py`` for one model (the logit ensemble,
ROADMAP.md §1 item 8, and the ahead-of-time executables are not ported).
"""
from __future__ import annotations

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
    its target language tag."""

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
        self.model = model
        self.cfg = gen_cfg
        self.eos_id, self.bos_id, self.pad_id, self.unk_id = eos_id, bos_id, pad_id, unk_id
        self.max_target_positions = max_target_positions
        self.vocab_size = model.cfg.vocab_size

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
        enc = self.model.encode(feats, lens, imgs, masks)
        max_len = self._max_len(int(feats.shape[1]))
        state = tile_state_for_beams(
            self.model.decode_init(enc, max_len + 1, kv_dtype=self.cfg.kv_cache_dtype), K
        )
        seqs, scores = beam_search(
            self.model.decode_step, state, B,
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
