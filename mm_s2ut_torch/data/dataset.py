"""Speech-to-unit dataset and collation (numpy only).

A copy of ``mm_s2ut/data/dataset.py`` trimmed to what the port's task
runs: ``SpeechToSpeechDataset.from_tsv`` (manifest, unit targets, image
features by ``int(stem(audio)) - 1``, or, with
``multimodal.load_visual_extractor_type``, the preprocessed pixels of the
raw images in the flickr30k layout, ``RawImageStore``, for every split,
the training one included: the model's extractor trains on them),
``__getitem__`` and ``collate``
(bucket-padded numpy batches sorted by source length, descending;
``prev_output_tokens`` = EOS or the target lang tag, then the target
shifted right; with n_frames_per_step = n > 1 the decoder input packs n
units per id, :func:`pack_units`, while the loss target stays unpacked),
and the target speaker embeddings of ``data.target_speaker_embed``
(``tgt_speaker``), and, in training, noise mixing at a random SNR
(``data.noise``: the clips of ``noise_wav_dir/*.wav`` in sorted order, each
draw from the dataset's own ``np.random.RandomState(seed)`` in the
reference's order, so the mixed waves equal its bit for bit). Waveforms
stay waveforms: the task's device fbank turns them into log-mels.
``collate_native`` decodes a batch's wavs with the native C++ loader
(``mm_s2ut_torch/native.py``) straight into the padded buffer, where the
reference's does: not with noise mixing on, a non-wav source or a rate
that needs resampling.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mm_s2ut_torch.config import DataConfig, MultimodalConfig, NoiseConfig
from mm_s2ut_torch.data.audio_io import get_waveform
from mm_s2ut_torch.data.dictionary import Dictionary
from mm_s2ut_torch.data.image_store import (ImageFeatureStore, RawImageStore,
                                             audio_stem_to_image_index)
from mm_s2ut_torch.data.manifest import ManifestRow, read_manifest
from mm_s2ut_torch.ops.noise import select_noise, tile_noise_to_length


def pack_units(ids: np.ndarray, n_frames_per_step: int, vocab_size: int, offset: int = 4) -> np.ndarray:
    """Base-V packing of n consecutive unit ids into one id; the input ends
    with EOS, which stays the last element."""
    if n_frames_per_step <= 1:
        return ids
    V = vocab_size - offset
    if V ** n_frames_per_step + offset > 2 ** 31 - 1:
        raise ValueError(f"pack_units: V={V}^n={n_frames_per_step} exceeds the int32 id space")
    body = ids[:-1].reshape(-1, n_frames_per_step) - offset
    scale = np.array([V ** (n_frames_per_step - 1 - i) for i in range(n_frames_per_step)],
                     dtype=np.int64)
    packed = (body * scale).sum(axis=1) + offset
    return np.concatenate([packed, ids[-1:]]).astype(np.int64)


def standardize_waveforms(wavs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-utterance zero mean, unit variance over each row's valid samples
    (float64 statistics, eps 1e-7; padding stays 0): ``standardize_audio``
    for the raw-waveform encoders, as the reference's task computes it."""
    valid = np.arange(wavs.shape[1])[None, :] < lengths[:, None]
    n = np.maximum(lengths.astype(np.float64), 1)[:, None]
    mean = (wavs * valid).sum(1, keepdims=True) / n
    var = (((wavs - mean) * valid) ** 2).sum(1, keepdims=True) / n
    return ((wavs - mean) / np.sqrt(var + 1e-7) * valid).astype(np.float32)


@dataclass
class S2SItem:
    index: int
    id: str
    source: np.ndarray  # (S,) float32 waveform
    target: np.ndarray  # (Lt,) unit ids incl. EOS
    tgt_lang_tag: Optional[int]
    imgs: List[np.ndarray]
    img_masks: List[Optional[np.ndarray]]
    speaker: Optional[np.ndarray] = None


class SpeechToSpeechDataset:
    def __init__(self, split: str, is_train: bool, data_cfg: DataConfig,
                 rows: Sequence[ManifestRow], tgt_dict: Dictionary,
                 image_stores: Sequence[ImageFeatureStore] = (),
                 noise_wavs: Sequence[np.ndarray] = (), noise_cfg: Optional[NoiseConfig] = None,
                 seed: int = 1):
        self.split = split
        self.is_train = is_train
        self.cfg = data_cfg
        self.rows = list(rows)
        self.tgt_dict = tgt_dict
        self.image_stores = list(image_stores)
        self.noise_wavs = list(noise_wavs)
        self.noise_cfg = noise_cfg or NoiseConfig()
        self.rng = np.random.RandomState(seed)
        self.n_frames_per_step = data_cfg.n_frames_per_step
        # Target speaker embeddings (one .npy path per manifest id).
        self.speaker_embeds: Optional[Dict[str, str]] = None
        if data_cfg.target_speaker_embed:
            with open(data_cfg.target_speaker_embed, newline="") as f:
                self.speaker_embeds = {
                    r["id"]: r["speaker_embed"] for r in csv.DictReader(f, delimiter="\t")
                }

    @classmethod
    def from_tsv(cls, root: str | Path, split: str, data_cfg: DataConfig, tgt_dict: Dictionary,
                 mm_cfg: Optional[MultimodalConfig] = None,
                 noise_cfg: Optional[NoiseConfig] = None, is_train: Optional[bool] = None,
                 seed: int = 1) -> "SpeechToSpeechDataset":
        rows = read_manifest(Path(root) / f"{split}.tsv")
        is_train = split.startswith("train") if is_train is None else is_train
        if mm_cfg is not None and mm_cfg.load_visual_extractor_type:
            # The on-line path: preprocessed pixels; the model's extractor
            # turns them into features.
            stores = [RawImageStore.for_split(
                mm_cfg.flickr30k_root, split, mode=mm_cfg.load_visual_extractor_type,
                image_size=mm_cfg.image_input_size, mean=tuple(mm_cfg.image_mean) or None,
                std=tuple(mm_cfg.image_std) or None)]
        else:
            stores = [ImageFeatureStore.for_split(feat_root, split)
                      for feat_root in (mm_cfg.image_feat_path if mm_cfg is not None else ())]
        noise_wavs = []
        if noise_cfg and noise_cfg.noise_wav_dir and noise_cfg.noise_prob > 0:
            noise_wavs = [get_waveform(str(p))[0]
                          for p in sorted(Path(noise_cfg.noise_wav_dir).glob("*.wav"))]
        return cls(split, is_train, data_cfg, rows, tgt_dict, stores, noise_wavs, noise_cfg, seed)

    def __len__(self) -> int:
        return len(self.rows)

    def num_frames(self, index: int) -> int:
        return self.rows[index].src_n_frames

    def num_target_frames(self, index: int) -> int:
        return self.rows[index].tgt_n_frames // self.n_frames_per_step

    def _maybe_add_noise(self, wav: np.ndarray) -> np.ndarray:
        """With probability ``noise_prob``: one clip, tiled and cropped from
        a random start to the wave's length, mixed at an SNR uniform in
        [snr_low, snr_high] dB (noise scaled to factor·mean|wav|/mean|noise|
        with factor = 1/(10^(SNR/20) + 1), the wave by 1 − factor), then
        divided by max(peak, 1)."""
        nc = self.noise_cfg
        if not self.noise_wavs or self.rng.rand() >= nc.noise_prob:
            return wav
        noise = select_noise(self.noise_wavs, 1, self.rng)
        noise = tile_noise_to_length(noise.reshape(-1), len(wav), -1, self.rng)
        snr = self.rng.uniform(nc.noise_snr_low, nc.noise_snr_high)
        factor = 1.0 / (10.0 ** (snr / 20.0) + 1.0)
        clean_amp = np.abs(wav).mean()
        noise_amp = np.abs(noise).mean() + 1e-14
        noisy = wav * (1 - factor) + noise * (factor * clean_amp / noise_amp)
        peak = max(np.abs(noisy).max(), 1.0)
        return (noisy / peak).astype(np.float32)

    def lang_tag_index(self, lang: str) -> int:
        """Vocabulary id of ``<lang:xx>``."""
        tag = lang if lang.startswith("<lang:") else f"<lang:{lang}>"
        return self.tgt_dict.index(tag)

    def _encode_target(self, row: ManifestRow):
        """(target ids with EOS, the lang tag that leads the decoder input
        or None); the S2T dataset overrides it."""
        target = self.tgt_dict.encode_line(row.tgt_text, append_eos=True).astype(np.int64)
        n = self.n_frames_per_step
        if n > 1:  # whole packs only, then EOS
            keep = (len(target) - 1) - (len(target) - 1) % n
            target = np.concatenate([target[:keep], [self.tgt_dict.eos()]])
        tgt_lang_tag = None
        if self.cfg.prepend_tgt_lang_tag_as_bos and row.tgt_lang:
            tgt_lang_tag = self.lang_tag_index(row.tgt_lang)
        return target, tgt_lang_tag

    def _audio_path(self, row: ManifestRow) -> str:
        path = row.src_audio
        if self.cfg.audio_root and not os.path.isabs(path):
            path = os.path.join(self.cfg.audio_root, path)
        return path

    def __getitem__(self, index: int) -> S2SItem:
        row = self.rows[index]
        wav, _ = get_waveform(self._audio_path(row), use_sample_rate=self.cfg.sample_rate)
        if self.is_train:
            wav = self._maybe_add_noise(wav.astype(np.float32))
        item = self._target_item(index, row)
        item.source = wav.astype(np.float32)
        return item

    def _target_item(self, index: int, row: ManifestRow) -> S2SItem:
        """The item without its audio: targets, images, speaker."""
        target, tgt_lang_tag = self._encode_target(row)
        imgs: List[np.ndarray] = []
        masks: List[Optional[np.ndarray]] = []
        if self.image_stores:
            img_idx = audio_stem_to_image_index(row.src_audio)
            for store in self.image_stores:
                *_, feat, mask = store[img_idx]  # RawImageStore items lead with the path
                imgs.append(np.asarray(feat, np.float32))
                masks.append(None if mask is None else np.asarray(mask, bool))
        speaker = None
        if self.speaker_embeds is not None and row.id in self.speaker_embeds:
            speaker = np.load(self.speaker_embeds[row.id]).astype(np.float32).reshape(-1)
        return S2SItem(index, row.id, np.zeros(0, np.float32), target, tgt_lang_tag, imgs, masks,
                       speaker)

    def collate(self, items: Sequence[S2SItem], src_pad: Optional[int] = None,
                tgt_pad: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Pad + sort descending by source length; ``src_pad``/``tgt_pad``
        fix the padded shapes (bucketing), default the batch maximum."""
        order = np.argsort([-len(it.source) for it in items], kind="stable")
        items = [items[i] for i in order]
        B = len(items)
        S = src_pad or max(len(it.source) for it in items)
        src = np.zeros((B, S), np.float32)
        src_lengths = np.zeros((B,), np.int32)
        for i, it in enumerate(items):
            n = min(len(it.source), S)
            src[i, :n] = it.source[:n]
            src_lengths[i] = n
        batch = self._collate_targets(items, tgt_pad)
        batch["src_features"] = src  # waveforms; the task's device fbank converts them
        batch["src_lengths"] = src_lengths
        return batch

    def collate_native(self, indices: Sequence[int], src_pad: int, tgt_pad: Optional[int],
                       n_threads: int = 8) -> Optional[Dict[str, np.ndarray]]:
        """:meth:`collate` of the rows ``indices`` with the wavs decoded by
        the native loader's thread pool straight into the (B, ``src_pad``)
        buffer. None where it does not apply, as in the reference: noise
        mixing on, a source that is not ``.wav``, or a file whose rate is
        not ``data.sample_rate``; the caller then collates items."""
        from mm_s2ut_torch import native

        if self.is_train and self.noise_wavs and self.noise_cfg.noise_prob > 0:
            return None
        rows = [self.rows[int(i)] for i in indices]
        paths = [self._audio_path(row) for row in rows]
        if not all(p.endswith(".wav") for p in paths):
            return None
        src, src_lengths, rates = native.load_batch(paths, src_pad, n_threads)
        if not (rates == self.cfg.sample_rate).all():
            return None  # needs resampling
        order = np.argsort(-src_lengths, kind="stable")
        items = [self._target_item(int(indices[int(i)]), rows[int(i)]) for i in order]
        batch = self._collate_targets(items, tgt_pad)
        batch["src_features"] = src[order]
        batch["src_lengths"] = src_lengths[order].astype(np.int32)
        return batch

    def _collate_targets(self, items: Sequence[S2SItem],
                         tgt_pad: Optional[int]) -> Dict[str, np.ndarray]:
        """Targets, images and speakers of items already in batch order."""
        B = len(items)
        pad_id, eos_id = self.tgt_dict.pad(), self.tgt_dict.eos()
        nfs = self.n_frames_per_step
        packed = [pack_units(it.target, nfs, len(self.tgt_dict)) for it in items]
        L = tgt_pad or max(len(p) for p in packed)
        # Only the decoder input packs; the target stays base-V, n·(L−1)+1
        # long, and target_lengths / ntokens count packed positions.
        Lt = L if nfs <= 1 else nfs * (L - 1) + 1
        target = np.full((B, Lt), pad_id, np.int32)
        prev = np.full((B, L), pad_id, np.int32)
        target_lengths = np.zeros((B,), np.int32)
        for i, (it, p) in enumerate(zip(items, packed)):
            n = min(len(p), L)
            nt = min(len(it.target), Lt)
            target[i, :nt] = it.target[:nt]
            prev[i, 0] = it.tgt_lang_tag if it.tgt_lang_tag is not None else eos_id
            prev[i, 1:n] = p[: n - 1]
            target_lengths[i] = n
        batch: Dict[str, np.ndarray] = {
            "id": np.asarray([it.index for it in items], np.int64),
            "prev_output_tokens": prev,
            "target": target,
            "target_lengths": target_lengths,
            "ntokens": np.asarray(target_lengths.sum(), np.int64),
            "nsentences": np.asarray(B, np.int64),
        }
        if items[0].imgs:
            imgs, masks = [], []
            for k in range(len(items[0].imgs)):  # (B, T, D) features or (B, S, S, 3) pixels
                imgs.append(np.stack([it.imgs[k] for it in items]))
                masks.append(np.stack([it.img_masks[k] for it in items])
                             if items[0].img_masks[k] is not None
                             else np.zeros((B, imgs[k].shape[1]), bool))
            batch["imgs_list"] = tuple(imgs)
            batch["img_masks_list"] = tuple(masks)
        if items[0].speaker is not None:
            batch["tgt_speaker"] = np.stack([it.speaker for it in items])
        return batch
