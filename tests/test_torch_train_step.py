"""The port's criterion, optimizer and train step against the JAX package.

* ``speech_to_unit`` and ``speech_to_unit_v2`` (R-Drop) on the same
  logits and padded targets as JAX's, label smoothing 0.2: rtol 1e-6
  (fp32 sums of the same terms in other orders).
* ``Optimizer`` against ``build_optimizer``'s optax chain fed IDENTICAL
  numpy gradients (Adam's first steps are ~lr·sign(g), so model-level
  gradient noise near 0 would flip signs), with the clip binding, weight
  decay 0.01, inverse-sqrt warmup, ``update_freq`` 1 and 2 (MultiSteps):
  atol 1e-7 on the parameters after every call.
* a non-finite batch leaves parameters and optimizer state unchanged and
  advances the step, as the reference's skip does.
* the step's forward and backward run with cuDNN held to its
  deterministic algorithms, and the setting is restored after.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mm_s2ut.config import TrainConfig as JTrainConfig
from mm_s2ut.train.criterion import speech_to_unit_criterion as j_s2u
from mm_s2ut.train.criterion import speech_to_unit_rdrop_criterion as j_rdrop
from mm_s2ut.train.optimizer import build_optimizer
from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig, TrainConfig
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel, init_parameters_
from mm_s2ut_torch.train.criterion import speech_to_unit_criterion as t_s2u
from mm_s2ut_torch.train.criterion import speech_to_unit_rdrop_criterion as t_rdrop
from mm_s2ut_torch.train.optimizer import Optimizer
from mm_s2ut_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _logits_batch(seed=0):
    rng = np.random.RandomState(seed)
    la, lb = (3 * rng.randn(3, 7, 54).astype(np.float32) for _ in range(2))
    target = rng.randint(4, 54, (3, 7)).astype(np.int32)
    target[1, 4:] = 1
    target[2, 1:] = 1
    return la, lb, target


@pytest.mark.parametrize("rdrop", [False, True])
def test_criterion_matches_jax(rdrop):
    la, lb, target = _logits_batch()
    tb = {"target": torch.from_numpy(target).long()}
    if rdrop:
        want, wm = j_rdrop({"logits": la}, {"target": target}, 0.2, rdrop_alpha=0.7,
                           outputs_b={"logits": lb})
        got, gm = t_rdrop({"logits": torch.from_numpy(la)}, tb, 0.2, rdrop_alpha=0.7,
                          outputs_b={"logits": torch.from_numpy(lb)})
    else:
        want, wm = j_s2u({"logits": la}, {"target": target}, 0.2)
        got, gm = t_s2u({"logits": torch.from_numpy(la)}, tb, 0.2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("update_freq", [1, 2])
def test_optimizer_matches_optax(update_freq):
    kw = dict(lr=1e-2, warmup_updates=3, warmup_init_lr=1e-4, weight_decay=0.01,
              clip_norm=1.0, update_freq=update_freq)
    rng = np.random.RandomState(4)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    # Weights at an initialised network's scale (0.1): one rounding flip in
    # p − rate·u (the two global norms sum in other orders) is then 7e-9.
    params = {k: 0.1 * rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4 * update_freq)]
    tx = build_optimizer(JTrainConfig(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = Optimizer(tp, TrainConfig(**kw))
    for g in grads:
        assert np.sqrt(sum((x ** 2).sum() for x in g.values())) > kw["clip_norm"]  # clip binds
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g[k]) for k in shapes])
        for k, t in zip(shapes, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)
    assert opt.count == 4
    assert not np.allclose(tp[0].numpy(), params["a"])


def _small_trainer(tmp_path):
    mm = MultimodalConfig(image_feat_dim=[16], multimodal_attention_type="selective_attention",
                          modality_dropout=0.5, audio_dropout=0.5)
    model_cfg = ModelConfig(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
                            encoder_attention_heads=2, decoder_embed_dim=32,
                            decoder_ffn_embed_dim=64, decoder_layers=1, decoder_attention_heads=2,
                            conv_channels=16, vocab_size=54, dtype="float32", multimodal=mm)
    cfg = Config(model=model_cfg, train=TrainConfig(warmup_updates=2, lr=1e-3,
                                                    save_dir=str(tmp_path)))
    model = init_parameters_(MMS2UTModel(model_cfg), torch.Generator().manual_seed(0))
    return Trainer(cfg, model, "cpu")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    target = rng.randint(4, 54, (2, 6)).astype(np.int32)
    target[1, 4:] = 1
    return {
        "src_features": rng.randn(2, 40, 80).astype(np.float32),
        "src_lengths": np.array([40, 31], np.int32),
        "prev_output_tokens": rng.randint(4, 54, (2, 6)).astype(np.int32),
        "target": target,
        "imgs_list": (rng.randn(2, 5, 16).astype(np.float32),),
        "img_masks_list": (np.zeros((2, 5), bool),),
    }


def test_nonfinite_batch_is_skipped(tmp_path):
    trainer = _small_trainer(tmp_path)
    m = trainer.train_batch(_batch())
    assert np.isfinite(m["loss"]) and m["skipped"] == 0.0 and trainer.step == 1
    before = [p.detach().clone() for p in trainer.params]
    opt_before = copy.deepcopy(trainer.optimizer.state_dict())
    bad = _batch(1)
    bad["src_features"][0, 3, 5] = np.nan
    m = trainer.train_batch(bad)
    assert m["skipped"] == 1.0 and not np.isfinite(m["grad_norm"]) and trainer.step == 2
    for p, q in zip(trainer.params, before):
        assert torch.equal(p.detach(), q)
    after = trainer.optimizer.state_dict()
    assert after["count"] == opt_before["count"] == 1
    for key in ("mu", "nu"):
        for a, b in zip(after[key], opt_before[key]):
            assert torch.equal(a, b)
    m = trainer.train_batch(_batch(2))
    assert m["skipped"] == 0.0 and trainer.optimizer.count == 2 and trainer.step == 3


def test_train_step_runs_deterministic_convs(tmp_path):
    trainer = _small_trainer(tmp_path)
    conv = trainer.model.encoder.subsampler.conv0
    seen = []
    conv.register_forward_pre_hook(
        lambda *_: seen.append(("forward", torch.backends.cudnn.deterministic)))
    conv.weight.register_hook(
        lambda g: seen.append(("backward", torch.backends.cudnn.deterministic)))
    before = torch.backends.cudnn.deterministic
    m = trainer.train_batch(_batch())
    assert np.isfinite(m["loss"]) and m["skipped"] == 0.0
    assert {kind for kind, _ in seen} == {"forward", "backward"}
    assert all(flag for _, flag in seen), seen
    assert torch.backends.cudnn.deterministic == before
