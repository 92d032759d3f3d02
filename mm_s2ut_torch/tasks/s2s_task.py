"""Task ``multimodal_speech_to_speech`` of the port (textless S2UT training).

Port of ``mm_s2ut/tasks/s2s_task.py``: it wires the typed config to the
dictionary, the datasets, the model and the trainer, and owns the device
frontend: host batches (waveforms padded to their bucket) become
standardised log-mels on the device through the port's ``ops/fbank.py``.
The batch order is the reference's (``LengthBucketBatcher`` seeded by
``train.seed``). With ``multimodal.load_visual_extractor_type`` the
batches of every split carry preprocessed pixels (``RawImageStore``) and
the model's extractor starts from ``multimodal.load_visual_extractor``'s
checkpoint when one is named (a timm ``.bin``/``.pth``, or an HF CLIP dir
for ``vit_openai``); it trains with the rest of the model.
The training split mixes in noise when ``data.noise`` names clips
(``data/dataset.py``). ``train.eval_inference`` adds the MCD metrics to
each validation (:meth:`build_inference_metrics_fn`). A batch of wavs is
decoded by the native C++ loader (``SpeechToSpeechDataset.collate_native``)
where it applies, as in the reference.
With a raw-waveform speech encoder (``speech_encoder_type`` ``hubert``,
``wav2vec2`` or ``wav2vec2_multimodal``) the batches keep their
waveforms: no fbank, ``standardize_audio`` per utterance on the host,
and manifest lengths in samples; in training the encoder masks spans.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import random
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from mm_s2ut_torch.config import Config
from mm_s2ut_torch.convert import flatten, from_flax, to_flax, unflatten
from mm_s2ut_torch.data.bucketing import LengthBucketBatcher
from mm_s2ut_torch.data.dataset import SpeechToSpeechDataset, standardize_waveforms
from mm_s2ut_torch.data.dictionary import Dictionary, UnitDictionary
from mm_s2ut_torch.data.prefetch import prefetch
from mm_s2ut_torch.models import build_model_from_config
from mm_s2ut_torch.models.mm_s2ut import init_parameters_, reads_waveform
from mm_s2ut_torch.models.mm_xm import mm_xm_architecture_base
from mm_s2ut_torch.models.vit import load_clip_checkpoint, load_timm_checkpoint
from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend
from mm_s2ut_torch.parallel.mesh import DataParallel
from mm_s2ut_torch.parallel.pipeline import sequential_params
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


class MultiModalSpeechToSpeechTask:
    def __init__(self, cfg: Config, device="cuda", tgt_dict: Optional[Dictionary] = None):
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
                mm_cfg=self.cfg.model.multimodal, noise_cfg=self.cfg.data.noise,
                seed=self.cfg.train.seed)
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
                # The native loader's batch decode, where it applies.
                batch = ds.collate_native(idx, bucket.src_len, bucket.tgt_len)
                if batch is None:
                    items = [ds[int(i)] for i in idx]
                    batch = ds.collate(items, src_pad=bucket.src_len, tgt_pad=bucket.tgt_len)
                yield batch

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

    def build_trainer(self, criterion: str = "speech_to_unit",
                      parallel: Optional[DataParallel] = None) -> Trainer:
        model = self.build_model()
        n_params = sum(p.numel() for p in model.parameters())
        logger.info("model %s: %.1fM params", self.cfg.model.arch, n_params / 1e6)
        return Trainer(self.cfg, model, self.device, criterion_name=criterion, parallel=parallel)

    def build_inference_metrics_fn(self, trainer: Trainer) -> Callable[[Dict], Dict[str, float]]:
        """MCD metrics at validation (``train.eval_inference``, fairseq's
        ``--eval-inference``): one :class:`UnitGenerator` over the trainer's
        live model and the CodeHiFiGAN of ``train.eval_vocoder_path`` /
        ``eval_vocoder_cfg``, built once. Each call decodes a batch with
        the live weights in the model's compute dtype (``model.dtype``: an
        fp32 model decodes itself in eval mode, put back in train mode
        after; a bf16 model's fp32 master weights are copied into a bf16
        twin first, as flax computes in bf16 from fp32 parameters; under
        tensor or pipeline parallelism the weights are gathered whole into
        such a twin once per step, ``Trainer.full_params``, so kernels B–F
        see every head, a pipelined encoder's layers unstacked into a
        sequential one), vocodes
        the predicted and the target units batch by batch as the reference
        does, and returns the summed statistics of
        ``eval.mcd.batch_mel_cepstral_distortion``. Under data parallelism
        the trainer hands each process its own rows, and the statistics of
        all processes are reduced together (``Trainer.evaluate``)."""
        from mm_s2ut_torch.eval.mcd import batch_mel_cepstral_distortion
        from mm_s2ut_torch.infer.generator import UnitGenerator
        from mm_s2ut_torch.models.hifigan import (CodeHiFiGAN, HiFiGANConfig,
                                                  load_fairseq_checkpoint)

        tcfg = self.cfg.train
        if not (tcfg.eval_vocoder_path and tcfg.eval_vocoder_cfg):
            raise ValueError("train.eval_inference needs eval_vocoder_path + eval_vocoder_cfg")
        raw = json.loads(Path(tcfg.eval_vocoder_cfg).read_text())
        vcfg = HiFiGANConfig.from_json(tcfg.eval_vocoder_cfg)
        vocoder = CodeHiFiGAN(vcfg)
        vocoder.load_state_dict(load_fairseq_checkpoint(tcfg.eval_vocoder_path, vcfg))
        vocoder = vocoder.to(self.device).eval()
        dur = bool(raw.get("dur_prediction", vcfg.dur_prediction))
        sr = raw.get("sampling_rate", 16000)

        def vocode(unit_seqs):
            seqs = [s if len(s) else [0] for s in unit_seqs]
            L = max(len(s) for s in seqs)
            vocoder.max_frames = (8 * L + 16) if dur else (L + 1)
            units = torch.zeros((len(seqs), L), dtype=torch.long)
            for i, s in enumerate(seqs):
                units[i, :len(s)] = torch.tensor(s)
            lens = torch.tensor([len(s) for s in seqs])
            wav, n = vocoder(units.to(self.device), lens.to(self.device), dur_prediction=dur)
            wav, n = wav.float().cpu().numpy(), n.cpu().numpy()
            return [wav[i, :n[i]] for i in range(len(seqs))]

        def to_units(tokens):
            return self.tgt_dict.ids_to_units(tokens).tolist()

        decoding = trainer.model
        gathered = trainer.tp is not None or trainer.pipe is not None
        if self.cfg.model.dtype == "bfloat16" or gathered:
            # A pipelined model's twin is sequential: it decodes on one device.
            cfg = dataclasses.replace(self.cfg, model=dataclasses.replace(self.cfg.model,
                                                                          pipeline_stages=0))
            decoding = build_model_from_config(cfg).to(self.device)
        gen = UnitGenerator(decoding, self.cfg.generation)
        pad = self.tgt_dict.pad()
        loaded_at = [None]  # the step whose gathered weights the twin holds

        def fn(batch):
            if gathered:
                if loaded_at[0] != trainer.step:
                    state = dict(trainer.model.named_buffers())  # buffers stay whole
                    params = sequential_params(unflatten(trainer.full_params()))
                    state.update(from_flax(params, decoding))
                    decoding.load_state_dict(state)
                    loaded_at[0] = trainer.step
            elif decoding is not trainer.model:
                decoding.load_state_dict(trainer.model.state_dict())
            was_training = decoding.training
            decoding.eval()
            try:
                hyps = gen.generate(batch["src_features"], batch["src_lengths"],
                                    batch.get("imgs_list", ()), batch.get("img_masks_list", ()))
            finally:
                decoding.train(was_training)
            pred = [to_units(h[0]["tokens"]) for h in hyps]
            targ = [to_units([t for t in row if t != pad])
                    for row in torch.as_tensor(batch["target"]).tolist()]
            return batch_mel_cepstral_distortion(vocode(targ), vocode(pred), sr)

        return fn
