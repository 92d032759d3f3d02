"""The port's training task and entry point on a synthetic corpus (8
wavs, per-split image features, as ``tests/test_task.py`` builds one):

* the first three batches of the port's task equal the JAX task's: the
  same order, ids, targets, prev tokens and lengths; log-mels within
  ``tests/test_torch_frontend.py``'s atol 1e-3;
* ``python -m mm_s2ut_torch.cli.train --config … --device cpu`` runs 4
  steps and writes ``config.yaml``, ``params.npz``, ``optim.pt`` and the
  metrics csv; ``--resume`` continues from step 4 to 6;
* ``python -m mm_s2ut_torch.inference --device cpu`` decodes a wav with
  that ``save_dir``;
* without a card, ``--device cuda`` (the default) raises.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mm_s2ut.config import Config as JConfig
from mm_s2ut.config import DataConfig as JData
from mm_s2ut.config import MeshConfig
from mm_s2ut.config import ModelConfig as JModel
from mm_s2ut.config import MultimodalConfig as JMM
from mm_s2ut.config import TrainConfig as JTrain
from mm_s2ut.config import save_yaml
from mm_s2ut.data.audio_io import write_wav
from mm_s2ut.data.manifest import ManifestRow, write_manifest
from mm_s2ut.tasks.s2s_task import MultiModalSpeechToSpeechTask as JTask
from mm_s2ut_torch import inference
from mm_s2ut_torch.cli import train as train_cli
from mm_s2ut_torch.config import load_config
from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask as TTask

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_corpus")
    sr = 16000
    rng = np.random.RandomState(0)
    n = 8
    (root / "img_feat").mkdir()
    for split in ("train", "valid"):
        np.save(root / "img_feat" / f"{split}.npy", rng.randn(n, 6, 16).astype(np.float32))
    rows = []
    for i in range(n):
        length = sr // 4 + (i % 3) * sr // 8
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(length)).astype(np.float32), sr)
        units = " ".join(str(u) for u in rng.randint(0, 50, 8 + i % 4))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", length, units, 8 + i % 4))
    write_manifest(root / "train.tsv", rows)
    write_manifest(root / "valid.tsv", rows[:4])
    cfg = JConfig(
        model=JModel(
            encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
            encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
            decoder_layers=1, decoder_attention_heads=2, conv_channels=16, dtype="float32",
            multimodal=JMM(image_feat_path=[str(root / "img_feat")], image_feat_dim=[16],
                           multimodal_attention_type="selective_attention",
                           modality_dropout=0.5, audio_dropout=0.5),
        ),
        data=JData(data_root=str(root), audio_root=str(root), target_code_size=50,
                   max_tokens=400, num_buckets=2),
        train=JTrain(update_freq=1, warmup_updates=5, lr=1e-3, seed=3, max_update=4,
                     save_interval_updates=2, log_interval=1, save_dir=str(root / "ckpt")),
        generation=dataclasses.replace(JConfig().generation, beam=2, max_len_a=0.0, max_len_b=8),
        mesh=MeshConfig(data=1),
    )
    save_yaml(cfg, root / "run.yaml")
    return root, cfg


def test_batches_match_jax_task(corpus):
    root, jcfg = corpus
    jbatches = JTask(jcfg).batch_iterator("train", epoch=1)
    tbatches = TTask(load_config(root / "run.yaml"), "cpu").batch_iterator("train", epoch=1)
    for _, jb, tb in zip(range(3), jbatches, tbatches):
        for key in ("id", "target", "prev_output_tokens", "target_lengths", "src_lengths",
                    "ntokens"):
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]), err_msg=key)
        np.testing.assert_array_equal(tb["imgs_list"][0].numpy(), jb["imgs_list"][0])
        np.testing.assert_allclose(tb["src_features"].numpy(), np.asarray(jb["src_features"]),
                                   atol=1e-3)


def test_train_cli_writes_a_checkpoint_resumes_and_decodes(corpus, tmp_path):
    root, _ = corpus
    save = tmp_path / "ckpt"
    args = ["--config", str(root / "run.yaml"), "--device", "cpu", f"train.save_dir={save}"]
    proc = subprocess.run([sys.executable, "-m", "mm_s2ut_torch.cli.train", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for f in ("config.yaml", "params.npz", "optim.pt", "logs/metrics.csv"):
        assert (save / f).exists(), f
    assert torch.load(save / "optim.pt", weights_only=True)["step"] == 4
    rows = (save / "logs" / "metrics.csv").read_text().splitlines()
    assert rows[0].startswith("step,train/") and len(rows) > 4
    assert load_config(save / "config.yaml").model.vocab_size == 54

    assert train_cli.main([*args, "--resume", "train.max_update=6"]) == 0
    state = torch.load(save / "optim.pt", weights_only=True)
    assert state["step"] == 6 and state["optimizer"]["count"] == 6

    out = tmp_path / "out"
    assert inference.main(["--model_path", str(save), "--audio_path", str(root / "1.wav"),
                           "--image_path", str(root / "img1.npy"), "--output_dir", str(out),
                           "--device", "cpu"]) == 0
    units = (out / "1.unit").read_text().split()
    assert units and all(0 <= int(u) < 50 for u in units)


@pytest.fixture(scope="module", autouse=True)
def single_image(corpus):
    root, _ = corpus
    np.save(root / "img1.npy", np.load(root / "img_feat" / "train.npy")[0])


def test_train_cli_needs_a_card_by_default(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    root, _ = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", str(root / "run.yaml")])
