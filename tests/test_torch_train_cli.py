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
* without a card, ``--device cuda`` (the default) raises;
* the S2T task (``task: multimodal_speech_to_text``, the XM model on a
  SentencePiece text corpus): its trainer from JAX's initial parameters
  against JAX's task and ``Trainer`` over three steps, and ``cli.train``
  then ``cli.generate`` from its save_dir;
* ``--load-pretrained-encoder-from`` against JAX's ``load_component`` on
  the same parameters, errors included.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
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


# ---------------------------------------------------------------------------
# the S2T task (mm_xm_transformer) and --load-pretrained-encoder-from
# ---------------------------------------------------------------------------

PIECES = [("▁the", -1.0), ("▁cat", -2.0), ("at", -3.0), ("▁c", -4.0), ("▁", -5.0),
          ("t", -6.0), ("h", -6.0), ("e", -6.0), ("c", -6.5), ("a", -6.5), ("s", -6.5),
          ("▁s", -5.5), ("th", -4.5), ("▁th", -3.5), ("▁sat", -2.5)]
TEXTS = ["the cat sat", "the cat", "cats sat the cat", "sat", "the sat cat", "cat"]
W2V_ARGS = dict(conv_dim=[32, 32], conv_stride=[5, 2], conv_kernel=[10, 3], hidden_size=48,
                num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                hidden_dropout=0.0, attention_dropout=0.0, layerdrop=0.0)


@pytest.fixture(scope="module")
def s2t_corpus(tmp_path_factory):
    """wavs with transcripts in German, a SentencePiece model, its dict.txt
    with the lang tag, image features per split, and a small XM config
    (every dropout 0) as ``task: multimodal_speech_to_text``."""
    from mm_s2ut_torch.data.sentencepiece import build_model

    root = tmp_path_factory.mktemp("s2t_corpus")
    rng = np.random.RandomState(8)
    rows = []
    for i, text in enumerate(TEXTS):
        n = 3200 + 700 * i
        write_wav(root / f"{i + 1}.wav", (0.2 * rng.randn(n)).astype(np.float32), 16000)
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, text, len(text.split()),
                                tgt_lang="de"))
    write_manifest(root / "train.tsv", rows)
    write_manifest(root / "valid.tsv", rows[:3])
    (root / "spm.model").write_bytes(build_model(PIECES))
    (root / "dict.txt").write_text("".join(f"{s} 1\n" for s in [p for p, _ in PIECES]
                                           + ["<lang:de>"]))
    (root / "img").mkdir()
    for split in ("train", "valid"):
        np.save(root / "img" / f"{split}.npy", rng.randn(len(TEXTS), 6, 16).astype(np.float32))
    cfg = JConfig(
        task="multimodal_speech_to_text",
        model=JModel(arch="mm_xm_transformer", decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                     decoder_layers=2, decoder_attention_heads=2, dropout=0.0,
                     attention_dropout=0.0, activation_dropout=0.0, dtype="float32",
                     w2v_args=W2V_ARGS,
                     multimodal=JMM(image_feat_path=[str(root / "img")], image_feat_dim=[16],
                                    multimodal_attention_type="selective_attention",
                                    modality_dropout=0.0, SA_image_dropout=0.0,
                                    SA_attention_dropout=0.0)),
        data=JData(data_root=str(root), audio_root=str(root), vocab_filename="dict.txt",
                   target_is_code=False, tgt_lang="<lang:de>", eos_token="<lang:de>",
                   prepend_bos_and_append_tgt_lang_tag=True, max_tokens=100, num_buckets=1,
                   bpe_tokenizer={"bpe": "sentencepiece",
                                  "sentencepiece_model": str(root / "spm.model")},
                   pre_tokenizer={"tokenizer": "space"}),
        train=JTrain(update_freq=1, warmup_updates=2, lr=1e-3, seed=5, max_update=3,
                     save_interval_updates=3, log_interval=1, save_dir=str(root / "ckpt")),
        generation=dataclasses.replace(JConfig().generation, beam=2, max_len_a=0.0,
                                       max_len_b=6),
        mesh=MeshConfig(data=1),
    )
    save_yaml(cfg, root / "run.yaml")
    return root, cfg


def test_s2t_task_trains_like_jax_from_the_same_parameters(s2t_corpus):
    """The S2T task's trainer (the XM model over raw-waveform batches) from
    JAX's initial parameters: three steps' losses and gradient norms
    within a relative 1e-5 (1e-4 for the norms) of JAX's task and
    ``Trainer`` on the same batches."""
    from mm_s2ut.tasks.s2t_task import MultiModalSpeechToTextTask as JS2T
    from mm_s2ut_torch.convert import from_flax
    from mm_s2ut_torch.tasks.s2t_task import MultiModalSpeechToTextTask as TS2T

    root, jcfg = s2t_corpus
    jtask = JS2T(jcfg)
    jtrainer = jtask.build_trainer()
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jtrainer.state.params))
    ttask = TS2T(load_config(root / "run.yaml"), "cpu")
    trainer = ttask.build_trainer()
    assert type(trainer.model).__name__ == "MMXMTransformerModel"
    trainer.model.load_state_dict(from_flax(params, trainer.model))
    jb = list(jtask.batch_iterator("train", epoch=0))
    tb = list(ttask.batch_iterator("train", epoch=0))
    assert len(jb) == len(tb) >= 3
    for want_b, got_b in zip(jb[:3], tb[:3]):
        want = jax.device_get(jtrainer.train_batch(want_b))
        got = trainer.train_batch(got_b)
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]), rtol=1e-4)


def test_train_cli_trains_the_s2t_task_and_generates(s2t_corpus, tmp_path):
    """``cli.train`` dispatches on ``task``: the S2T config trains the XM
    model for 3 steps; ``cli.generate`` decodes the test split from that
    save_dir."""
    from mm_s2ut_torch.cli import generate as generate_cli
    from mm_s2ut_torch.convert import load_npz

    root, _ = s2t_corpus
    save = tmp_path / "ckpt"
    assert train_cli.main(["--config", str(root / "run.yaml"), "--device", "cpu",
                           f"train.save_dir={save}"]) == 0
    for f in ("config.yaml", "params.npz", "optim.pt", "logs/metrics.csv"):
        assert (save / f).exists(), f
    assert load_config(save / "config.yaml").task == "multimodal_speech_to_text"
    assert "wav2vec2" in load_npz(save / "params.npz") and torch.load(
        save / "optim.pt", weights_only=True)["step"] == 3
    rows = (save / "logs" / "metrics.csv").read_text().splitlines()
    assert len(rows) >= 4 and "valid/loss" in rows[0]
    (root / "test.tsv").write_text((root / "valid.tsv").read_text())
    np.save(root / "img" / "test.npy", np.load(root / "img" / "valid.npy"))
    out = tmp_path / "gen"
    assert generate_cli.main(["--model_path", str(save), "--gen-subset", "test",
                              "--results-path", str(out), "--device", "cpu"]) == 0
    assert sum(line.startswith("D-") for line in
               (out / "generate-test.txt").read_text().splitlines()) == 3


def test_load_pretrained_encoder_matches_jax_load_component(corpus, tmp_path, monkeypatch):
    """``--load-pretrained-encoder-from DIR`` copies the ``encoder`` subtree
    of DIR's params.npz into the fresh model, the rest left at its
    initialisation: the same tree as JAX's ``load_component`` builds from
    the same parameters; and the same errors for a model without an
    ``encoder`` or with other shapes under it."""
    import mm_s2ut.utils.checkpoint as jckpt
    from mm_s2ut_torch.convert import flatten, load_npz, to_flax
    from mm_s2ut_torch.train.trainer import load_pretrained_encoder

    root, _ = corpus
    first, second = tmp_path / "first", tmp_path / "second"
    base = ["--config", str(root / "run.yaml"), "--device", "cpu"]
    assert train_cli.main([*base, f"train.save_dir={first}", "train.max_update=2"]) == 0
    assert train_cli.main([*base, f"train.save_dir={second}", "train.max_update=0",
                           "train.seed=9", "--load-pretrained-encoder-from", str(first)]) == 0
    fresh = tmp_path / "fresh"
    assert train_cli.main([*base, f"train.save_dir={fresh}", "train.max_update=0",
                           "train.seed=9"]) == 0
    src, got, init = (load_npz(d / "params.npz") for d in (first, second, fresh))
    monkeypatch.setattr(jckpt, "restore_params", lambda ckpt_dir, step=None: {"params": src})
    want = jckpt.load_component({"params": init}, first, "encoder")["params"]
    flat_got, flat_want = flatten(got), flatten(want)
    assert set(flat_got) == set(flat_want)
    for key, value in flat_want.items():
        np.testing.assert_array_equal(flat_got[key], value, err_msg=key)
    assert any(not np.array_equal(flatten(src)[k], flatten(init)[k])
               for k in flat_want if k.startswith("encoder/"))

    # The errors JAX's load_component raises, with its messages.
    from mm_s2ut_torch.config import ModelConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config

    xm = MMXMTransformerModel(ModelConfig(decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                                          decoder_layers=1, decoder_attention_heads=2,
                                          dtype="float32"),
                              w2v_cfg=Wav2Vec2Config(**{**W2V_ARGS, "conv_dim": (32, 32),
                                                        "conv_stride": (5, 2),
                                                        "conv_kernel": (10, 3)}))
    with pytest.raises(KeyError, match="component 'encoder' not in target model"):
        load_pretrained_encoder(xm, first)
    with pytest.raises(KeyError, match="not in target model"):
        jckpt.load_component({"params": flatten_to_tree(xm)}, first, "encoder")
    wide = MMS2UTModel(dataclasses.replace(load_config(root / "run.yaml").model,
                                           encoder_embed_dim=48))
    with pytest.raises(ValueError, match="shape mismatch loading 'encoder'"):
        load_pretrained_encoder(wide, first)
    with pytest.raises(ValueError, match="shape mismatch loading 'encoder'"):
        jckpt.load_component({"params": flatten_to_tree(wide)}, first, "encoder")
    # A checkpoint without an ``encoder`` (an XM model's).
    no_encoder = tmp_path / "no_encoder"
    no_encoder.mkdir()
    np.savez(no_encoder / "params.npz", **to_flax(xm))
    with pytest.raises(KeyError, match="component 'encoder' not in checkpoint"):
        load_pretrained_encoder(wide, no_encoder)
    monkeypatch.setattr(jckpt, "restore_params",
                        lambda ckpt_dir, step=None: {"params": load_npz(no_encoder / "params.npz")})
    with pytest.raises(KeyError, match="component 'encoder' not in checkpoint"):
        jckpt.load_component({"params": flatten_to_tree(wide)}, no_encoder, "encoder")


def flatten_to_tree(model):
    from mm_s2ut_torch.convert import to_flax, unflatten

    return unflatten(to_flax(model))
