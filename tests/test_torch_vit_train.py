"""Training through the on-line visual extractor, the port against the
JAX package on the CPU:

* ``MMS2UTModel`` with a tiny ``vit_timm`` (timm's graph: its attention
  through ``flash_attention_biased``, Tq = 5 queries over S = 8 keys, the
  last 3 padded), then ``vit_openai`` (CLIP, plain attention), in train
  mode with every dropout rate 0: the ntokens-normalised label-smoothed
  loss within a relative 1e-6 and the gradient of every parameter, the
  extractor's patch conv included, within a relative 1e-4 of each
  tensor's largest magnitude (floored at 1e-4, as
  ``test_torch_train_model.py``) against ``jax.grad`` of JAX's model;
* H's plain twin at Tq ≠ S with padded keys (Tq = 17, S = 24, the keys
  past 17 padded, a ragged row) against JAX's ``_flash_bwd_call`` (Pallas
  H) in interpret mode, dropout 0 and 0.1: dq, dk, dv, dbias within
  fp32 1e-5, the padded keys' dk and dv exactly 0; and a data-parallel
  shard (rows from 1, ``dropout_row0=1``) equal to those rows of the
  whole batch;
* the task on JPEGs in the flickr30k layout (``tests/test_task.py``'s
  ``test_online_visual_extractor_train_from_jpgs``, dropouts 0): its
  pixel batches equal JAX's, three steps of the port's trainer from JAX's
  initial parameters against JAX's ``Trainer`` (losses within a relative
  1e-5, gradient norms 1e-4), and ``cli.train`` trains three steps on the
  corpus and moves the extractor.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import ModelConfig, MultimodalConfig
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
from mm_s2ut.models.vit import CLIPVisionConfig as JCLIPConfig
from mm_s2ut.models.vit import ViTConfig as JViTConfig
from mm_s2ut.ops.attention import _flash_bwd_call as j_bwd
from mm_s2ut.train.criterion import speech_to_unit_criterion as j_criterion
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import from_flax, to_flax
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TModel
from mm_s2ut_torch.models.vit import CLIPVisionConfig, ViTConfig
from mm_s2ut_torch.ops import attention as TA
from mm_s2ut_torch.train.criterion import speech_to_unit_criterion as t_criterion

torch.set_num_threads(1)
B, T, S, V, TT = 2, 48, 32, 60, 7
VIT_ARGS = {"embed_dim": 32, "depth": 2, "num_heads": 2, "patch_size": 16}
NO_DROP = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
MM_NO_DROP = dict(modality_dropout=0.0, SA_image_dropout=0.0, SA_attention_dropout=0.0)


def _cfg(kind: str) -> ModelConfig:
    return ModelConfig(
        encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
        decoder_layers=2, decoder_attention_heads=2, conv_channels=16, vocab_size=V,
        dtype="float32", **NO_DROP,
        multimodal=MultimodalConfig(
            image_feat_dim=[32], multimodal_attention_type="selective_attention",
            load_visual_extractor_type=kind, image_input_size=S,
            visual_extractor_args=dict(VIT_ARGS), **MM_NO_DROP))


def _batch(seed):
    rng = np.random.RandomState(seed)
    target = rng.randint(4, V, (B, TT)).astype(np.int32)
    target[1, 5:] = 1
    return {"src_features": rng.randn(B, T, 80).astype(np.float32),
            "src_lengths": np.array([T, T - 11], np.int32),
            "prev_output_tokens": rng.randint(4, V, (B, TT)).astype(np.int32),
            "target": target, "imgs_list": (rng.randn(B, S, S, 3).astype(np.float32),),
            "img_masks_list": (np.zeros((B, S), bool),)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("kind", ["vit_timm", "vit_openai"])
def test_loss_and_every_gradient_match_jax_grad(kind):
    jcfg = _cfg(kind)
    vit = (JCLIPConfig if kind == "vit_openai" else JViTConfig)(image_size=S, **VIT_ARGS)
    jmodel = JModel(jcfg, vit_cfg=vit)
    b = _batch(1)
    args = (b["src_features"], b["src_lengths"], b["prev_output_tokens"], b["imgs_list"],
            b["img_masks_list"])
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(2), *args))

    def j_loss(p):
        out = jmodel.apply(p, *args, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0),
                                 "modality": jax.random.PRNGKey(1)})
        loss, m = j_criterion(out, b, label_smoothing=0.2)
        return loss / m["ntokens"]

    want_loss, want = jax.value_and_grad(j_loss)(params)
    want = _flat(want["params"])
    tvit = (CLIPVisionConfig if kind == "vit_openai" else ViTConfig)(image_size=S, **VIT_ARGS)
    tmodel = TModel(tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(jcfg)),
                    vit_cfg=tvit).float()
    tmodel.load_state_dict(from_flax(params, tmodel))
    tmodel.train()
    t = torch.from_numpy
    out = tmodel(t(b["src_features"]), t(b["src_lengths"]).long(),
                 t(b["prev_output_tokens"]).long(), [t(b["imgs_list"][0])],
                 [t(b["img_masks_list"][0])])
    loss, m = t_criterion(out, {"target": t(b["target"]).long()}, label_smoothing=0.2)
    loss = loss / m["ntokens"]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    grads = copy.deepcopy(tmodel)
    for g, p in zip(grads.parameters(), tmodel.parameters()):
        g.data = p.grad
    got = to_flax(grads)
    assert set(got) == set(want)
    extractor = [k for k in want if k.startswith("visual_extractor/")]
    assert any("patch_embed" in k for k in extractor) and len(extractor) > 10
    assert np.abs(want[[k for k in extractor if "patch_embed" in k][0]]).max() > 0
    for key, w in want.items():
        scale = max(np.abs(w).max(), 1e-4)
        np.testing.assert_allclose(got[key], w, atol=1e-4 * scale, rtol=0, err_msg=key)


def _h_inputs(tq, s, seed=0):
    rng = np.random.RandomState(seed)
    Bh, H, D = 2, 2, 16
    q = rng.randn(Bh, tq, H, D).astype(np.float32)
    k, v = (rng.randn(Bh, s, H, D).astype(np.float32) for _ in range(2))
    g = rng.randn(Bh, tq, H, D).astype(np.float32)
    bias = np.zeros((Bh, s), np.float32)
    bias[:, tq:] = TA.NEG_INF  # the keys padded to S, as the ViT pads 577 to 584
    bias[1, tq - 5:] = TA.NEG_INF  # and a ragged row
    return q, k, v, g, bias, D ** -0.5


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_h_twin_at_tq_below_s_matches_pallas_h(rate):
    q, k, v, g, bias, scale = _h_inputs(17, 24)
    seed = 2024 if rate else None
    got = TA.reference_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v, bias, g)), scale,
                                     dropout_rate=rate, dropout_seed=seed)
    want = j_bwd(q, k, v, jnp.asarray(bias)[:, None, None, :], jnp.uint32(seed or 0), g, scale,
                 16, True, False, 0, rate)
    for name, x, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w).reshape(x.shape), atol=1e-5,
                                   err_msg=name)
    for x in got[1:3]:  # the padded keys get nothing
        assert (x[:, 17:] == 0).all() and (x[1, 12:] == 0).all()
    # The autograd path the ViT trains through gives the same gradients.
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = TA.flash_attention_biased(*leaves, torch.from_numpy(bias), scale=scale,
                                    dropout_rate=rate, dropout_seed=seed)
    for x, w in zip(torch.autograd.grad(out, leaves, torch.from_numpy(g)), got):
        np.testing.assert_allclose(x.numpy(), w.numpy(), atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_h_twin_on_a_shard_equals_those_rows_of_the_batch(rate):
    """A data-parallel process holding rows 1.. passes ``dropout_row0=1``
    and gets those rows' forward and gradients of the whole batch."""
    q, k, v, g, bias, scale = _h_inputs(17, 24, seed=3)
    seed = 77 if rate else None
    full = TA.reference_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v, bias, g)), scale,
                                      dropout_rate=rate, dropout_seed=seed)
    part = TA.reference_attention_bwd(*(torch.from_numpy(x[1:]) for x in (q, k, v, bias, g)),
                                      scale, dropout_rate=rate, dropout_seed=seed,
                                      dropout_row0=1)
    for x, w in zip(part, full):
        torch.testing.assert_close(x, w[1:], rtol=0, atol=1e-6)
    fwd = TA.reference_attention(torch.from_numpy(q) * scale, torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(bias)[:, None, None, :],
                                 dropout_rate=rate, dropout_seed=seed)
    fwd1 = TA.reference_attention(torch.from_numpy(q[1:]) * scale, torch.from_numpy(k[1:]),
                                  torch.from_numpy(v[1:]),
                                  torch.from_numpy(bias[1:])[:, None, None, :],
                                  dropout_rate=rate, dropout_seed=seed, dropout_row0=1)
    torch.testing.assert_close(fwd1, fwd[1:], rtol=0, atol=1e-6)
    if rate:  # a shard without the offset draws another mask
        wrong = TA.reference_attention_bwd(
            *(torch.from_numpy(x[1:]) for x in (q, k, v, bias, g)), scale, dropout_rate=rate,
            dropout_seed=seed)
        assert (wrong[0] - full[0][1:]).abs().max() > 1e-3


@pytest.fixture(scope="module")
def jpeg_corpus(tmp_path_factory):
    """JPEGs in the flickr30k layout and a tiny config with ``vit_timm``
    in its graph, as ``tests/test_task.py`` builds them, every dropout 0."""
    from PIL import Image

    from mm_s2ut.config import Config, DataConfig, MeshConfig, TrainConfig, save_yaml
    from mm_s2ut.data.audio_io import write_wav
    from mm_s2ut.data.manifest import ManifestRow, write_manifest

    root = tmp_path_factory.mktemp("jpegs")
    sr = 16000
    rng = np.random.RandomState(0)
    n = 4
    (root / "flickr30k-images").mkdir()
    names = [f"img{i}.jpg" for i in range(n)]
    for name in names:
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
            root / "flickr30k-images" / name)
    (root / "train.txt").write_text("\n".join(names) + "\n")
    rows = []
    for i in range(n):
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(sr // 4)).astype(np.float32), sr)
        units = " ".join(str(u) for u in rng.randint(0, 50, 8))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", sr // 4, units, 8))
    write_manifest(root / "train.tsv", rows)
    cfg = Config(
        model=ModelConfig(
            encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
            encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
            decoder_layers=1, decoder_attention_heads=2, conv_channels=16, dtype="float32",
            **NO_DROP,
            multimodal=MultimodalConfig(
                image_feat_dim=[32], multimodal_attention_type="selective_attention",
                load_visual_extractor_type="vit_timm", flickr30k_root=str(root),
                image_input_size=32, **MM_NO_DROP,
                visual_extractor_args={"embed_dim": 32, "depth": 1, "num_heads": 2,
                                       "patch_size": 16})),
        data=DataConfig(data_root=str(root), audio_root=str(root), target_code_size=50,
                        max_tokens=400, num_buckets=1),
        train=TrainConfig(update_freq=1, warmup_updates=5, lr=1e-3, seed=3, max_update=3,
                          save_interval_updates=3, log_interval=1,
                          save_dir=str(root / "ckpt")),
        mesh=MeshConfig(data=1),
    )
    save_yaml(cfg, root / "run.yaml")
    return root, cfg


def test_trainer_on_jpegs_matches_jax_trainer(jpeg_corpus):
    from mm_s2ut.tasks.s2s_task import MultiModalSpeechToSpeechTask as JTask
    from mm_s2ut_torch.config import load_config
    from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask as TTask

    root, jcfg = jpeg_corpus
    jtask = JTask(jcfg)
    jtrainer = jtask.build_trainer()
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jtrainer.state.params))
    ttask = TTask(load_config(root / "run.yaml"), "cpu")
    trainer = ttask.build_trainer()
    trainer.model.load_state_dict(from_flax(params, trainer.model))
    jb = list(jtask.batch_iterator("train", epoch=0))
    tb = list(ttask.batch_iterator("train", epoch=0))
    assert len(jb) == len(tb) >= 1
    for want_b, got_b in zip(jb, tb):
        px = got_b["imgs_list"][0]
        assert px.ndim == 4 and px.shape[-1] == 3
        np.testing.assert_allclose(px.numpy(), np.asarray(want_b["imgs_list"][0]), atol=1e-6)
    before = trainer.model.visual_extractor.patch_embed.weight.detach().clone()
    for step in range(3):
        want = jax.device_get(jtrainer.train_batch(jb[step % len(jb)]))
        got = trainer.train_batch(tb[step % len(tb)])
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]), rtol=1e-4)
    assert not torch.equal(trainer.model.visual_extractor.patch_embed.weight, before)


def test_train_cli_trains_through_the_extractor_from_jpegs(jpeg_corpus, tmp_path):
    from mm_s2ut_torch.cli import train as train_cli
    from mm_s2ut_torch.convert import load_npz
    from mm_s2ut_torch.config import load_config
    from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask as TTask

    root, _ = jpeg_corpus
    save = tmp_path / "ckpt"
    assert train_cli.main(["--config", str(root / "run.yaml"), "--device", "cpu",
                           f"train.save_dir={save}"]) == 0
    assert torch.load(save / "optim.pt", weights_only=True)["step"] == 3
    init = to_flax(TTask(load_config(root / "run.yaml"), "cpu").build_model())
    trained = load_npz(save / "params.npz")
    moved = trained["visual_extractor"]["patch_embed"]["kernel"]
    assert np.isfinite(moved).all()
    assert not np.array_equal(moved, init["visual_extractor/patch_embed/kernel"])
