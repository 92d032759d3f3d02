"""Task ``multimodal_speech_to_speech`` of the port (textless S2UT training).

Port of ``mm_s2ut/tasks/s2s_task.py``: it wires the typed config to the
dictionary, the datasets, the model and the trainer, and owns the device
frontend: host batches (waveforms padded to their bucket) become
standardised log-mels on the device through the port's ``ops/fbank.py``.
The batch order is the reference's (``LengthBucketBatcher`` seeded by
``train.seed``). With ``multimodal.load_visual_extractor_type`` the
batches carry preprocessed pixels and the model's extractor starts from
``multimodal.load_visual_extractor``'s checkpoint when one is named (a
timm ``.bin``/``.pth``, or an HF CLIP dir for ``vit_openai``); the model
raises if it is trained through the extractor (ROADMAP.md §1 item 4).
Not ported, and refused when configured: noise mixing and
``eval_inference``; the native C++ loader, which the reference also
skips when it is absent, is left out.
With a raw-waveform speech encoder (``speech_encoder_type`` ``hubert``,
``wav2vec2`` or ``wav2vec2_multimodal``) the batches keep their
waveforms: no fbank, ``standardize_audio`` per utterance on the host,
and manifest lengths in samples. Training those encoders is not ported
(the model raises in training mode where it would mask spans).
"""
from __future__ import annotations

import logging
import random
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from mm_s2ut_torch.config import Config
from mm_s2ut_torch.convert import flatten, from_flax, to_flax
from mm_s2ut_torch.data.bucketing import LengthBucketBatcher
from mm_s2ut_torch.data.dataset import SpeechToSpeechDataset, standardize_waveforms
from mm_s2ut_torch.data.dictionary import Dictionary, UnitDictionary
from mm_s2ut_torch.data.prefetch import prefetch
from mm_s2ut_torch.models import build_model_from_config
from mm_s2ut_torch.models.mm_s2ut import init_parameters_, reads_waveform
from mm_s2ut_torch.models.mm_xm import mm_xm_architecture_base
from mm_s2ut_torch.models.vit import load_clip_checkpoint, load_timm_checkpoint
from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend
from mm_s2ut_torch.train.trainer import Trainer, to_device

logger = logging.getLogger(__name__)


def _small_arch(cfg) -> None:
    cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim = 256, 1024
    cfg.encoder_layers, cfg.encoder_attention_heads = 6, 4
    cfg.decoder_embed_dim, cfg.decoder_ffn_embed_dim = 256, 1024
    cfg.decoder_layers, cfg.decoder_attention_heads = 3, 4


# The reference's registered architectures (mm_s2ut/models/mm_s2ut.py, mm_xm.py).
ARCHS = {"mm_s2ut_transformer": lambda cfg: None, "mm_s2ut_transformer_small": _small_arch,
         "mm_xm_transformer": mm_xm_architecture_base}


def _check_ported(cfg: Config) -> None:
    unported = {
        "data.noise": cfg.data.noise.noise_prob > 0 and bool(cfg.data.noise.noise_wav_dir),
        "train.eval_inference": cfg.train.eval_inference,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class MultiModalSpeechToSpeechTask:
    def __init__(self, cfg: Config, device="cuda", tgt_dict: Optional[Dictionary] = None):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        random.seed(cfg.train.seed)
        np.random.seed(cfg.train.seed)
        torch.manual_seed(cfg.train.seed)
        self.tgt_dict = tgt_dict or self._build_dictionary()
        cfg.model.vocab_size = len(self.tgt_dict)
        cfg.model.n_frames_per_step = cfg.data.n_frames_per_step
        self.datasets: Dict[str, SpeechToSpeechDataset] = {}
        self.fbank_cfg = FbankConfig(sample_rate=cfg.data.sample_rate,
                                     num_mel_bins=cfg.data.num_mel_bins)

    def _build_dictionary(self) -> Dictionary:
        data = self.cfg.data
        vocab_path = Path(data.data_root) / data.vocab_filename if data.data_root else None
        if vocab_path and vocab_path.exists():
            return Dictionary.load(vocab_path)
        lang_tags = []
        if (data.prepend_bos_and_append_tgt_lang_tag or data.prepend_tgt_lang_tag_as_bos) \
                and data.tgt_lang:
            tag = data.tgt_lang if data.tgt_lang.startswith("<lang:") else f"<lang:{data.tgt_lang}>"
            lang_tags.append(tag)
        return UnitDictionary(data.target_code_size, lang_tags)

    def load_dataset(self, split: str) -> SpeechToSpeechDataset:
        if split not in self.datasets:
            self.datasets[split] = SpeechToSpeechDataset.from_tsv(
                self.cfg.data.data_root, split, self.cfg.data, self.tgt_dict,
                mm_cfg=self.cfg.model.multimodal)
        return self.datasets[split]

    def build_model(self):
        """The configured architecture with the reference's initializers,
        drawn from ``train.seed``, in fp32 (the trainer's master copy), and
        the pretrained visual extractor where one is named."""
        arch = ARCHS.get(self.cfg.model.arch)
        if arch is not None:
            arch(self.cfg.model)
        model = self._initialized(build_model_from_config(self.cfg))
        mm = self.cfg.model.multimodal
        if mm.load_visual_extractor_type and mm.load_visual_extractor:
            self._load_visual_extractor_weights(model)
        return model

    def _load_visual_extractor_weights(self, model) -> None:
        """Fill ``model.visual_extractor`` from ``multimodal.load_visual_
        extractor``; a checkpoint of another geometry raises."""
        mm = self.cfg.model.multimodal
        if mm.load_visual_extractor_type == "vit_openai":
            _, variables = load_clip_checkpoint(mm.load_visual_extractor)
        else:
            variables = load_timm_checkpoint(mm.load_visual_extractor, model.vit_cfg)
        want = {k: v.shape for k, v in to_flax(model.visual_extractor).items()}
        got = {k: v.shape for k, v in flatten(variables["params"]).items()}
        if want != got:
            raise ValueError(
                f"visual extractor checkpoint {mm.load_visual_extractor} does not match the "
                f"configured graph (visual_extractor_args={mm.visual_extractor_args})")
        model.visual_extractor.load_state_dict(from_flax(variables, model.visual_extractor))
        logger.info("loaded visual extractor (%s) from %s", mm.load_visual_extractor_type,
                    mm.load_visual_extractor)

    def _initialized(self, model):
        return init_parameters_(model.float(), torch.Generator().manual_seed(self.cfg.train.seed))

    def batch_iterator(self, split: str, epoch: int = 0,
                       shuffle: Optional[bool] = None) -> Iterator[Dict]:
        """Host collation (waveforms, bucket-padded) in a prefetch thread →
        batches on the task's device, ``src_features`` as log-mels and
        ``src_lengths`` as frame counts (for a raw-waveform encoder, the
        waveforms and their sample counts)."""
        ds = self.load_dataset(split)
        data = self.cfg.data
        shuffle = ds.is_train if shuffle is None else shuffle
        # max_tokens counts fbank frames; manifest lengths count samples.
        shift = self.fbank_cfg.frame_shift
        batcher = LengthBucketBatcher(
            [ds.num_frames(i) for i in range(len(ds))],
            [ds.num_target_frames(i) + 2 for i in range(len(ds))],
            max_tokens=data.max_tokens * shift,
            num_buckets=data.num_buckets,
            quantum=shift * 32,
            seed=self.cfg.train.seed,
        )

        def host_batches():
            for bucket, idx in batcher.epoch(epoch, shuffle=shuffle):
                items = [ds[int(i)] for i in idx]
                yield ds.collate(items, src_pad=bucket.src_len, tgt_pad=bucket.tgt_len)

        raw = reads_waveform(self.cfg.model)
        for batch in prefetch(host_batches(), depth=2):
            if raw:
                if data.standardize_audio:
                    batch["src_features"] = standardize_waveforms(batch["src_features"],
                                                                  batch["src_lengths"])
                yield to_device(batch, self.device)
                continue
            batch = to_device(batch, self.device)
            batch["src_features"], batch["src_lengths"] = waveform_frontend(
                batch["src_features"], batch["src_lengths"], self.fbank_cfg,
                data.standardize_audio)
            yield batch

    def build_trainer(self, criterion: str = "speech_to_unit") -> Trainer:
        model = self.build_model()
        n_params = sum(p.numel() for p in model.parameters())
        logger.info("model %s: %.1fM params", self.cfg.model.arch, n_params / 1e6)
        return Trainer(self.cfg, model, self.device, criterion_name=criterion)
