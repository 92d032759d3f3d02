"""Task ``multimodal_speech_to_text`` of the port (the enhanced path).

Port of ``mm_s2ut/tasks/s2t_task.py``: the S2S task's dictionary and
plumbing, with the text dataset (``data/s2t_dataset.py``), the
``mm_xm_transformer`` model (``models/mm_xm.py``) and raw-waveform
batches (the wav2vec2 encoder reads the samples: no fbank, and, as in
the reference, no ``standardize_audio`` on this path). ``max_tokens``
counts 10 ms frames, 160 samples each.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

from mm_s2ut_torch.data.bucketing import LengthBucketBatcher
from mm_s2ut_torch.data.s2t_dataset import MultiModalSpeechToTextDataset
from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config
from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask
from mm_s2ut_torch.train.trainer import to_device


class MultiModalSpeechToTextTask(MultiModalSpeechToSpeechTask):
    def load_dataset(self, split: str) -> MultiModalSpeechToTextDataset:
        if split not in self.datasets:
            self.datasets[split] = MultiModalSpeechToTextDataset.from_tsv(
                self.cfg.data.data_root, split, self.cfg.data, self.tgt_dict,
                mm_cfg=self.cfg.model.multimodal, noise_cfg=self.cfg.data.noise,
                seed=self.cfg.train.seed)
        return self.datasets[split]

    def build_model(self, w2v_cfg: Optional[Wav2Vec2Config] = None) -> MMXMTransformerModel:
        """The XM model (no architecture preset, as in the reference) with
        the reference's initializers, in fp32."""
        return self._initialized(MMXMTransformerModel(
            self.cfg.model, w2v_cfg=w2v_cfg or Wav2Vec2Config.from_args(self.cfg.model.w2v_args)))

    def batch_iterator(self, split: str, epoch: int = 0,
                       shuffle: Optional[bool] = None) -> Iterator[Dict]:
        """Raw-waveform batches on the task's device (``src_lengths`` in
        samples)."""
        ds = self.load_dataset(split)
        data = self.cfg.data
        shuffle = ds.is_train if shuffle is None else shuffle
        batcher = LengthBucketBatcher(
            [ds.num_frames(i) for i in range(len(ds))],
            [ds.num_target_frames(i) + 2 for i in range(len(ds))],
            max_tokens=data.max_tokens * 160,  # frames → samples
            num_buckets=data.num_buckets,
            quantum=320 * 16,
            seed=self.cfg.train.seed,
        )
        for bucket, idx in batcher.epoch(epoch, shuffle=shuffle):
            items = [ds[int(i)] for i in idx]
            yield to_device(ds.collate(items, src_pad=bucket.src_len, tgt_pad=bucket.tgt_len),
                            self.device)
