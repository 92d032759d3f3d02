"""Noise mixing of the training data (``data.noise``) against the JAX
package, on the same seed and noise clips (``noise_wav_dir/*.wav``: one
shorter than the waves, so it is tiled, and two longer, so a random
start crops them):

* ``tile_noise_to_length`` and ``select_noise`` (the numpy copies) equal
  JAX's, draw for draw from one ``RandomState``;
* the S2S and S2T datasets' training items: the mixed waves equal JAX's
  bit for bit, item after item (each item moves the dataset's
  ``RandomState``), some mixed and some clean at ``noise_prob`` 0.6; the
  validation split is never mixed;
* the S2S task's first noisy batches equal JAX's task's (log-mels within
  ``tests/test_torch_train_cli.py``'s atol 1e-3, the rest exact), and
  the S2T task's raw-waveform batches bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mm_s2ut.config import Config as JConfig
from mm_s2ut.config import DataConfig as JData
from mm_s2ut.config import MeshConfig
from mm_s2ut.config import ModelConfig as JModel
from mm_s2ut.config import MultimodalConfig as JMM
from mm_s2ut.config import NoiseConfig as JNoise
from mm_s2ut.config import save_yaml
from mm_s2ut.data.audio_io import write_wav
from mm_s2ut.data.manifest import ManifestRow, write_manifest
from mm_s2ut.ops import noise as JN
from mm_s2ut_torch.config import load_config
from mm_s2ut_torch.ops import noise as TN

torch.set_num_threads(1)
WORDS = ["the", "cat", "sat", "on", "mat"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise_corpus")
    rng = np.random.RandomState(3)
    rows = []
    for i in range(8):
        n = 4000 + 900 * i
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), 16000)
        text = " ".join(rng.choice(WORDS, 2 + i % 3))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, text, 2 + i % 3, tgt_lang="de"))
    write_manifest(root / "train.tsv", rows)
    write_manifest(root / "valid.tsv", rows[:3])
    noise = root / "noise"
    noise.mkdir()
    for name, n in (("b.wav", 900), ("a.wav", 30000), ("c.wav", 12000)):
        write_wav(noise / name, (0.5 * rng.randn(n)).astype(np.float32), 16000)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS + ["<lang:de>"]))
    (root / "img").mkdir()
    for split in ("train", "valid"):
        np.save(root / "img" / f"{split}.npy", rng.randn(8, 4, 16).astype(np.float32))
    return root


def configs(root, task):
    mm = JMM(image_feat_path=[str(root / "img")], image_feat_dim=[16],
             multimodal_attention_type="selective_attention")
    if task == "s2s":
        data = JData(data_root=str(root), audio_root=str(root), target_code_size=50,
                     max_tokens=300, num_buckets=2)
        units = root / "units"
        units.mkdir(exist_ok=True)
        for split in ("train", "valid"):  # unit targets for the S2S task
            text = (root / f"{split}.tsv").read_text().splitlines()
            out = [text[0]] + ["\t".join(r.split("\t")[:3] + [" ".join(
                str(7 + 3 * j) for j in range(4 + k % 3)), str(4 + k % 3)] + r.split("\t")[5:])
                for k, r in enumerate(text[1:])]
            (units / f"{split}.tsv").write_text("\n".join(out) + "\n")
        data = dataclasses.replace(data, data_root=str(units))
    else:
        data = JData(data_root=str(root), audio_root=str(root), vocab_filename="dict.txt",
                     target_is_code=False, tgt_lang="<lang:de>", eos_token="<lang:de>",
                     prepend_bos_and_append_tgt_lang_tag=True, max_tokens=300, num_buckets=2)
    data.noise = JNoise(noise_wav_dir=str(root / "noise"), noise_prob=0.6, noise_snr_low=3.0,
                        noise_snr_high=15.0)
    cfg = JConfig(task="multimodal_speech_to_speech" if task == "s2s"
                  else "multimodal_speech_to_text",
                  model=JModel(dtype="float32", multimodal=mm), data=data,
                  mesh=MeshConfig(data=1))
    cfg.train.seed = 7
    path = root / f"{task}.yaml"
    save_yaml(cfg, path)
    return cfg, load_config(path)


def test_noise_helpers_match_jax():
    clips = [np.random.RandomState(k).randn(n).astype(np.float32)
             for k, n in ((0, 50), (1, 300), (2, 120))]
    for num in (1, 2, 3):
        r_j, r_t = np.random.RandomState(5), np.random.RandomState(5)
        for _ in range(4):
            a, b = JN.select_noise(clips, num, r_j), TN.select_noise(clips, num, r_t)
            np.testing.assert_array_equal(a, b)
            for length in (40, 200, 1000):
                np.testing.assert_array_equal(JN.tile_noise_to_length(a, length, -1, r_j),
                                              TN.tile_noise_to_length(b, length, -1, r_t))
        assert r_j.randint(1 << 30) == r_t.randint(1 << 30)


@pytest.mark.parametrize("task", ["s2s", "s2t"])
def test_noisy_items_equal_jax_bit_for_bit(corpus, task):
    from mm_s2ut.data.dataset import SpeechToSpeechDataset as JS2S
    from mm_s2ut.data.dictionary import Dictionary as JDict
    from mm_s2ut.data.dictionary import UnitDictionary as JUnitDict
    from mm_s2ut.data.s2t_dataset import MultiModalSpeechToTextDataset as JS2T
    from mm_s2ut_torch.data.dataset import SpeechToSpeechDataset as TS2S
    from mm_s2ut_torch.data.dictionary import Dictionary as TDict
    from mm_s2ut_torch.data.dictionary import UnitDictionary as TUnitDict
    from mm_s2ut_torch.data.s2t_dataset import MultiModalSpeechToTextDataset as TS2T

    jcfg, tcfg = configs(corpus, task)
    if task == "s2s":
        jds_cls, tds_cls, jd, td = JS2S, TS2S, JUnitDict(50), TUnitDict(50)
    else:
        jds_cls, tds_cls = JS2T, TS2T
        jd, td = JDict.load(corpus / "dict.txt"), TDict.load(corpus / "dict.txt")
    root = jcfg.data.data_root
    order = [3, 0, 7, 3, 5, 1, 6, 2, 4, 3, 0, 7]
    for split in ("train", "valid"):
        jds = jds_cls.from_tsv(root, split, jcfg.data, jd, mm_cfg=jcfg.model.multimodal,
                               noise_cfg=jcfg.data.noise, seed=7)
        tds = tds_cls.from_tsv(root, split, tcfg.data, td, mm_cfg=tcfg.model.multimodal,
                               noise_cfg=tcfg.data.noise, seed=7)
        assert len(tds.noise_wavs) == 3
        mixed = 0
        for i in order[: len(tds)] if split == "valid" else order:
            i = i % len(tds)
            want, got = jds[i], tds[i]
            assert got.source.dtype == np.float32
            np.testing.assert_array_equal(got.source, want.source, err_msg=f"{split} {i}")
            np.testing.assert_array_equal(got.target, want.target)
            clean = tds_cls.from_tsv(root, split, tcfg.data, td,
                                     mm_cfg=tcfg.model.multimodal)[i].source
            mixed += not np.array_equal(got.source, clean)
        if split == "train":
            assert 0 < mixed < len(order)
        else:
            assert mixed == 0


def test_noisy_s2s_batches_equal_jax(corpus):
    from mm_s2ut.tasks.s2s_task import MultiModalSpeechToSpeechTask as JTask
    from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask as TTask

    jcfg, tcfg = configs(corpus, "s2s")
    jb = list(JTask(jcfg).batch_iterator("train", epoch=1))
    tb = list(TTask(tcfg, "cpu").batch_iterator("train", epoch=1))
    assert len(jb) == len(tb) > 1
    for want, got in zip(jb, tb):
        for key in ("id", "target", "prev_output_tokens", "src_lengths", "ntokens"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        np.testing.assert_allclose(got["src_features"].numpy(), np.asarray(want["src_features"]),
                                   atol=1e-3)


def test_noisy_s2t_batches_equal_jax(corpus):
    from mm_s2ut.tasks.s2t_task import MultiModalSpeechToTextTask as JTask
    from mm_s2ut_torch.tasks.s2t_task import MultiModalSpeechToTextTask as TTask

    jcfg, tcfg = configs(corpus, "s2t")
    jb = list(JTask(jcfg).batch_iterator("train", epoch=0))
    tb = list(TTask(tcfg, "cpu").batch_iterator("train", epoch=0))
    assert len(jb) == len(tb) > 1
    for want, got in zip(jb, tb):
        for key in ("id", "target", "prev_output_tokens", "src_lengths", "src_features"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
