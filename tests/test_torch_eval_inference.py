"""``train.eval_inference`` in the port against the JAX package: the port
of ``tests/test_task.py``'s ``test_eval_inference_mcd_metrics`` on its
corpus and config (8 wavs, image features, a fairseq-format CodeHiFiGAN
of 50 units without duration prediction, beam 1, 8 units).

* The port's ``build_inference_metrics_fn`` over its trainer, loaded with
  JAX's initial parameters, and ``Trainer.evaluate(batches, fn)`` report
  the MCD metrics JAX's report (``mcd_loss``, ``pred_ratio``, ``ins_rate``,
  ``del_rate``, each rounded to 3 decimals by the reduce step, equal), and
  the criterion metrics within a relative 1e-5; the decoded units equal
  JAX's; the model is back in train mode after a call.
* ``cli.train`` with ``train.eval_inference`` writes the MCD metrics into
  the validation rows of ``metrics.csv``; without the vocoder keys it
  raises JAX's error.
"""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mm_s2ut.config import Config, DataConfig, MeshConfig, ModelConfig, MultimodalConfig
from mm_s2ut.config import TrainConfig, save_yaml
from mm_s2ut.data.audio_io import write_wav
from mm_s2ut.data.manifest import ManifestRow, write_manifest
from mm_s2ut.tasks.s2s_task import MultiModalSpeechToSpeechTask as JTask
from mm_s2ut_torch.config import load_config
from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask as TTask

sys.path.insert(0, str(Path(__file__).parent))
from test_hifigan import SMALL, _torch_generator  # noqa: E402

torch.set_num_threads(1)
KEYS = ("mcd_loss", "pred_ratio", "ins_rate", "del_rate")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``tests/test_task.py``'s corpus and ``make_cfg``, with the vocoder
    files ``test_eval_inference_mcd_metrics`` writes."""
    root = tmp_path_factory.mktemp("eval_inference")
    sr = 16000
    rng = np.random.RandomState(0)
    n = 8
    (root / "img_feat").mkdir()
    np.save(root / "img_feat" / "train.npy", rng.randn(n, 6, 16).astype(np.float32))
    np.save(root / "img_feat" / "valid.npy", rng.randn(n, 6, 16).astype(np.float32))
    rows = []
    for i in range(n):
        length = sr // 4 + (i % 3) * sr // 8
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(length)).astype(np.float32), sr)
        units = " ".join(str(u) for u in rng.randint(0, 50, 8 + i % 4))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", length, units, 8 + i % 4))
    write_manifest(root / "train.tsv", rows)
    write_manifest(root / "valid.tsv", rows[:4])

    torch.manual_seed(0)
    sd = dict(_torch_generator(SMALL).state_dict())
    sd["dict.weight"] = torch.randn(50, SMALL.embedding_dim)
    torch.save(sd, root / "vocoder.pt")
    vcfg = {k: getattr(SMALL, k) for k in ("embedding_dim", "model_in_dim",
                                           "upsample_initial_channel")}
    vcfg.update(num_embeddings=50, upsample_rates=list(SMALL.upsample_rates),
                upsample_kernel_sizes=list(SMALL.upsample_kernel_sizes),
                resblock_kernel_sizes=list(SMALL.resblock_kernel_sizes),
                resblock_dilation_sizes=[list(d) for d in SMALL.resblock_dilation_sizes],
                dur_prediction=False)
    (root / "vocoder.json").write_text(json.dumps(vcfg))

    cfg = Config(
        model=ModelConfig(
            encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
            encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
            decoder_layers=1, decoder_attention_heads=2, conv_channels=16, dtype="float32",
            multimodal=MultimodalConfig(image_feat_path=[str(root / "img_feat")],
                                        image_feat_dim=[16],
                                        multimodal_attention_type="selective_attention")),
        data=DataConfig(data_root=str(root), audio_root=str(root), target_code_size=50,
                        max_tokens=400, num_buckets=2),
        train=TrainConfig(update_freq=1, warmup_updates=5, lr=1e-3, seed=3, eval_inference=True,
                          eval_vocoder_path=str(root / "vocoder.pt"),
                          eval_vocoder_cfg=str(root / "vocoder.json"), max_update=2,
                          save_interval_updates=2, log_interval=1),
        mesh=MeshConfig(data=1),
    )
    cfg.generation.beam = 1
    cfg.generation.max_len_a = 0
    cfg.generation.max_len_b = 8
    save_yaml(cfg, root / "run.yaml")
    return root, cfg


def test_eval_inference_mcd_metrics_match_jax(corpus):
    root, jcfg = corpus
    jtask = JTask(jcfg)
    jtrainer = jtask.build_trainer()
    jfn = jtask.build_inference_metrics_fn(jtrainer)
    want = jtrainer.evaluate(jtask.batch_iterator("valid", shuffle=False), jfn)

    ttask = TTask(load_config(root / "run.yaml"), "cpu")
    trainer = ttask.build_trainer()
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jtrainer.state.params))
    trainer.model.load_state_dict(from_flax(params, trainer.model))
    fn = ttask.build_inference_metrics_fn(trainer)
    trainer.model.train()
    got = trainer.evaluate(ttask.batch_iterator("valid", shuffle=False), fn)
    for key in KEYS:
        assert key in got and np.isfinite(got[key]), (key, got)
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["mcd_loss"] > 0
    for key in ("loss", "nll_loss", "accuracy", "ntokens"):
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-5, err_msg=key)

    # One batch's summed statistics, and the mode the model is left in.
    jb = next(iter(jtask.batch_iterator("valid", shuffle=False)))
    tb = next(iter(ttask.batch_iterator("valid", shuffle=False)))
    trainer.model.train()
    stats = fn(tb)
    assert trainer.model.training
    want_stats = jfn(jb)
    assert set(stats) == set(want_stats)
    for key in ("targ_frames", "pred_frames", "path_frames", "nins", "ndel", "norm_frames"):
        assert stats[key] == want_stats[key], key
    np.testing.assert_allclose(stats["mcd_loss"], want_stats["mcd_loss"], rtol=1e-4)


def test_train_cli_reports_mcd_at_validation(corpus, tmp_path):
    import csv

    from mm_s2ut_torch.cli import train as train_cli

    root, _ = corpus
    save = tmp_path / "ckpt"
    assert train_cli.main(["--config", str(root / "run.yaml"), "--device", "cpu",
                           f"train.save_dir={save}"]) == 0
    with open(save / "logs" / "metrics.csv", newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get("valid/mcd_loss")]
    assert rows and all(np.isfinite(float(rows[-1][f"valid/{k}"])) for k in KEYS)
    with pytest.raises(ValueError, match="eval_vocoder_path"):
        train_cli.main(["--config", str(root / "run.yaml"), "--device", "cpu",
                        f"train.save_dir={tmp_path / 'x'}", "train.eval_vocoder_path="])
