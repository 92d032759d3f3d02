"""Multimodal speech-to-text dataset of the port (the enhanced path).

A copy of ``mm_s2ut/data/s2t_dataset.py`` (numpy only): the S2S dataset's
manifest, images and collation, with text targets: the transcript through
the configured pre-tokenizer and SentencePiece model
(``data/sentencepiece.py``) into vocabulary ids, EOS appended, and with
``prepend_bos_and_append_tgt_lang_tag`` the unit-mBART framing
``<s> tokens </s> <lang:xx>``, whose lang tag the collater moves to the
front of the decoder input. :class:`ResampledConcat` resamples several
splits by temperature.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from mm_s2ut_torch.data.dataset import SpeechToSpeechDataset
from mm_s2ut_torch.data.manifest import ManifestRow
from mm_s2ut_torch.data.sentencepiece import apply_pre_tokenizer, build_bpe_tokenizer


class MultiModalSpeechToTextDataset(SpeechToSpeechDataset):
    """Text targets: raw transcript → (optional) pre-tokenizer →
    (optional) SentencePiece → vocabulary ids. Without ``bpe_tokenizer``
    the transcripts must be tokenized already."""

    def tokenize(self, text: str) -> str:
        text = apply_pre_tokenizer(self.cfg.pre_tokenizer or None, text)
        if not hasattr(self, "_bpe"):
            self._bpe = build_bpe_tokenizer(self.cfg.bpe_tokenizer or None)
        if self._bpe is not None:
            text = " ".join(self._bpe.encode(text))
        return text

    def _encode_target(self, row: ManifestRow):
        target = self.tgt_dict.encode_line(self.tokenize(row.tgt_text),
                                           append_eos=True).astype(np.int64)
        tgt_lang_tag = None
        if self.cfg.prepend_tgt_lang_tag_as_bos and row.tgt_lang:
            tgt_lang_tag = self.lang_tag_index(row.tgt_lang)
        if self.cfg.prepend_bos_and_append_tgt_lang_tag and row.tgt_lang:
            # <bos> tokens <eos> <lang:tgt>: the decoder input then starts
            # with the lang tag, which generation starts from (eos_token).
            tag = self.lang_tag_index(row.tgt_lang)
            target = np.concatenate([[self.tgt_dict.bos()], target, [tag]]).astype(np.int64)
            tgt_lang_tag = tag
        return target, tgt_lang_tag


class ResampledConcat:
    """Temperature-resampled concatenation of datasets: split i's size
    ratio is smoothed_i · N / n_i with smoothed ∝ (n_i / N)^(1/T), so small
    splits are upsampled and large ones downsampled; ratio 1 at T = 1."""

    def __init__(self, datasets: Sequence, temperature: float = 1.0, seed: int = 1):
        self.datasets = list(datasets)
        self.seed = seed
        sizes = np.asarray([len(d) for d in self.datasets], np.float64)
        if temperature == 1.0 or len(self.datasets) == 1:
            self.ratios = np.ones(len(self.datasets))
        else:
            probs = sizes / sizes.sum()
            smoothed = probs ** (1.0 / temperature)
            smoothed /= smoothed.sum()
            self.ratios = smoothed * sizes.sum() / sizes
        self.target_sizes = np.maximum(np.round(sizes * self.ratios).astype(int), 1)

    def __len__(self) -> int:
        return int(self.target_sizes.sum())

    def epoch_indices(self, epoch: int) -> List[tuple]:
        """[(dataset_idx, sample_idx), ...] for one resampled epoch:
        upsampled splits draw with replacement; the order is shuffled by a
        generator seeded per epoch."""
        rng = np.random.RandomState(self.seed + epoch)
        out: List[tuple] = []
        for di, (ds, n) in enumerate(zip(self.datasets, self.target_sizes)):
            if n == len(ds):
                idx = np.arange(len(ds))
            else:
                idx = rng.choice(len(ds), size=n, replace=n > len(ds))
            out.extend((di, int(i)) for i in idx)
        rng.shuffle(out)
        return out

    def get(self, dataset_idx: int, sample_idx: int):
        return self.datasets[dataset_idx][sample_idx]
