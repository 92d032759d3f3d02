"""The CTC and multitask heads, their losses and a train step of the port
against the JAX package's, for the flagship (``MMS2UTModel``, the
conv-transformer encoder) and the enhanced path (``MMXMTransformerModel``)
on the same flax parameters (``convert.from_flax``), at a small size
(2 + 2 layers, widths 16-48), with ``ctc_weight`` 0.3, a CTC task
(``asr``, its own vocabulary) and a transformer task (``st``, 16-d, so
``mt_st_proj`` takes the encoder's width to it):

* the logits, ``ctc_logits`` and ``multitask_logits`` in eval mode: atol
  1e-4 (fp32);
* the criterion's terms on the same logits (``ctc_loss``, ``asr_loss``,
  ``st_loss``, ``loss``) and the targets the caller builds
  (``multitask_target(s)``; the reference's data pipeline makes none):
  relative 1e-5;
* one step's loss and every parameter's gradient against ``jax.grad``:
  loss relative 1e-5, gradients 1e-4 of each tensor's largest magnitude,
  that magnitude floored at 1e-3: the k-projection biases' gradients are
  0 in exact arithmetic (softmax ignores a shift shared by a row), and
  both sides leave ~1e-8 of rounding there. Both packages fix the
  transformer head's activation dropout at 0.1, so the step runs with
  dropout off (``deterministic``);
* ``Trainer.train_batch`` of the port against JAX's ``Trainer`` on a
  CTC-only config (every dropout 0): the loss and the CTC terms.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mm_s2ut.config import Config as JConfig
from mm_s2ut.config import MeshConfig as JMesh
from mm_s2ut.config import ModelConfig as JModelCfg
from mm_s2ut.config import MultimodalConfig as JMMCfg
from mm_s2ut.config import MultitaskTaskConfig as JTaskCfg
from mm_s2ut.config import TrainConfig as JTrainCfg
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JS2UT
from mm_s2ut.models.mm_xm import MMXMTransformerModel as JXM
from mm_s2ut.models.wav2vec2 import Wav2Vec2Config as JW2V
from mm_s2ut.train.criterion import speech_to_unit_criterion as j_criterion
from mm_s2ut.train.trainer import Trainer as JTrainer
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import from_flax, to_flax
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TS2UT
from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel as TXM
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config as TW2V
from mm_s2ut_torch.train.criterion import speech_to_unit_criterion as t_criterion
from mm_s2ut_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)
B, T, S, TT, TI, V = 2, 40, 2400, 5, 6, 40
W2V = dict(conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=48,
           num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
           hidden_dropout=0.0, attention_dropout=0.0, mask_time_prob=0.0)
DEC = dict(decoder_embed_dim=32, decoder_ffn_embed_dim=64, decoder_layers=2,
           decoder_attention_heads=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
           encoder_layers=2, encoder_attention_heads=2, conv_channels=16, vocab_size=V,
           dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
MM = dict(image_feat_dim=[16], multimodal_attention_type="selective_attention",
          modality_dropout=0.0, SA_image_dropout=0.0, SA_attention_dropout=0.0)
TASKS = [JTaskCfg(task_name="asr", decoder_type="ctc", vocab_size=30, loss_weight=0.5),
         JTaskCfg(task_name="st", decoder_type="transformer", decoder_layers=1,
                  decoder_embed_dim=16, decoder_attention_heads=2, label_smoothing=0.1,
                  loss_weight=2.0)]
KINDS = ("s2ut", "xm")


def jcfg(kind, tasks=TASKS):
    return JModelCfg(**DEC, dtype="float32", multimodal=JMMCfg(**MM), ctc_weight=0.3,
                     multitask=list(tasks))


def tcfg(cfg):
    out = tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(cfg))
    out.multitask = [tconfig.MultitaskTaskConfig(**t) for t in out.multitask]
    return out


def j_model(kind, cfg):
    return JXM(cfg, w2v_cfg=JW2V(**W2V)) if kind == "xm" else JS2UT(cfg)


def t_model(kind, cfg, params):
    model = TXM(tcfg(cfg), w2v_cfg=TW2V(**W2V)) if kind == "xm" else TS2UT(tcfg(cfg))
    model.load_state_dict(from_flax(params, model))
    return model


def make_batch(kind, seed=1):
    """Model inputs, the unit targets and the caller-built auxiliary
    targets (CTC labels avoid the blank 0 and the pad 1)."""
    rng = np.random.RandomState(seed)
    if kind == "xm":
        src = (0.3 * rng.randn(B, S)).astype(np.float32)
        lens = np.array([S, S - 730], np.int32)
        src[1, lens[1]:] = 0.0
    else:
        src = rng.randn(B, T, 80).astype(np.float32)
        lens = np.array([T, T - 11], np.int32)
    target = rng.randint(4, V, (B, TT)).astype(np.int32)
    target[1, 3:] = 1
    ctc_target = rng.randint(2, V, (B, 4)).astype(np.int32)
    ctc_target[1, 2:] = 1
    asr = rng.randint(2, 30, (B, 3)).astype(np.int32)
    asr[0, 2:] = 1
    st = rng.randint(4, V, (B, 4)).astype(np.int32)
    st[1, 3:] = 1
    masks = np.zeros((B, TI), bool)
    masks[1, TI - 2:] = True
    return {"src_features": src, "src_lengths": lens,
            "prev_output_tokens": rng.randint(4, V, (B, TT)).astype(np.int32),
            "target": target, "imgs_list": (rng.randn(B, TI, 16).astype(np.float32),),
            "img_masks_list": (masks,), "multitask_target": ctc_target,
            "multitask_targets": {"asr": asr, "st": st},
            "multitask_prev_tokens": {"st": rng.randint(4, V, (B, 4)).astype(np.int32)}}


def j_args(b):
    return (b["src_features"], b["src_lengths"], b["prev_output_tokens"], b["imgs_list"],
            b["img_masks_list"])


def t_tensor(x):
    if isinstance(x, dict):
        return {k: t_tensor(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [t_tensor(v) for v in x]
    t = torch.from_numpy(np.array(x))
    return t.long() if t.dtype == torch.int32 else t


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    kind = request.param
    cfg = jcfg(kind)
    b = make_batch(kind)
    params = jax.tree_util.tree_map(np.asarray, j_model(kind, cfg).init(
        jax.random.PRNGKey(3), *j_args(b), multitask_prev_tokens=b["multitask_prev_tokens"]))
    return kind, cfg, params


def test_heads_and_logits_match_jax(pair):
    kind, cfg, params = pair
    b = make_batch(kind, seed=2)
    want = j_model(kind, cfg).apply(params, *j_args(b),
                                    multitask_prev_tokens=b["multitask_prev_tokens"])
    model = t_model(kind, cfg, params).eval()
    assert set(to_flax(model)) == {"/".join(k) for k in _paths(params["params"])}
    assert {"ctc_head/ctc_proj/kernel", "mt_asr/ctc_proj/kernel",
            "mt_st_proj/kernel"} <= set(to_flax(model))
    tb = t_tensor(b)
    with torch.no_grad():
        got = model(*[tb[k] for k in ("src_features", "src_lengths", "prev_output_tokens",
                                      "imgs_list", "img_masks_list")],
                    multitask_prev_tokens=tb["multitask_prev_tokens"])
        no_prev = model(*[tb[k] for k in ("src_features", "src_lengths", "prev_output_tokens",
                                          "imgs_list", "img_masks_list")])
    for key in ("logits", "ctc_logits"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)
    assert set(got["multitask_logits"]) == {"asr", "st"}
    assert got["multitask_logits"]["asr"].shape[-1] == 30
    for name in ("asr", "st"):
        np.testing.assert_allclose(got["multitask_logits"][name].numpy(),
                                   np.asarray(want["multitask_logits"][name]), atol=1e-4,
                                   err_msg=name)
    # A transformer task without its prev tokens is left out, as in JAX.
    assert set(no_prev["multitask_logits"]) == {"asr"}


def test_criterion_terms_match_jax(pair):
    kind, cfg, params = pair
    b = make_batch(kind, seed=3)
    out = j_model(kind, cfg).apply(params, *j_args(b),
                                   multitask_prev_tokens=b["multitask_prev_tokens"])
    out = jax.tree_util.tree_map(np.asarray, out)
    want_loss, want = j_criterion(out, b, label_smoothing=0.2, ctc_weight=0.3,
                                  multitask=tuple(cfg.multitask))
    got_loss, got = t_criterion(t_tensor(out), t_tensor(b), label_smoothing=0.2,
                                ctc_weight=0.3, multitask=tuple(tcfg(cfg).multitask))
    assert set(got) == set(want) >= {"ctc_loss", "asr_loss", "st_loss", "loss"}
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    plain, _ = t_criterion(t_tensor(out), t_tensor(b), label_smoothing=0.2)
    assert float(got_loss) > float(plain)


def test_train_step_loss_and_gradients_match_jax_grad(pair):
    kind, cfg, params = pair
    b = make_batch(kind, seed=4)
    mt = tuple(cfg.multitask)

    def j_loss(p):
        out = j_model(kind, cfg).apply(p, *j_args(b), deterministic=True,
                                       multitask_prev_tokens=b["multitask_prev_tokens"])
        loss, m = j_criterion(out, b, label_smoothing=0.2, ctc_weight=0.3, multitask=mt)
        return loss / m["ntokens"]

    want_loss, want = jax.jit(jax.value_and_grad(j_loss))(params)
    model = t_model(kind, cfg, params).eval()  # dropout off; autograd on
    tb = t_tensor(b)
    out = model(*[tb[k] for k in ("src_features", "src_lengths", "prev_output_tokens",
                                  "imgs_list", "img_masks_list")],
                multitask_prev_tokens=tb["multitask_prev_tokens"])
    loss, m = t_criterion(out, tb, label_smoothing=0.2, ctc_weight=0.3,
                          multitask=tuple(tcfg(cfg).multitask))
    (loss / m["ntokens"]).backward()
    np.testing.assert_allclose(float((loss / m["ntokens"]).detach()), float(want_loss),
                               rtol=1e-5)
    assert_grads_close(model, want["params"])


def test_trainer_step_matches_jax_trainer():
    """One ``Trainer.train_batch`` of each package from the same
    parameters on a CTC-only config: the loss and the CTC terms."""
    cfg = jcfg("s2ut", tasks=TASKS[:1])
    b = make_batch("s2ut", seed=5)
    del b["multitask_prev_tokens"]
    b["multitask_targets"] = {"asr": b["multitask_targets"]["asr"]}
    params = jax.tree_util.tree_map(np.asarray, JS2UT(cfg).init(jax.random.PRNGKey(4),
                                                                *j_args(b)))
    jconf = JConfig(model=cfg, train=JTrainCfg(lr=1e-3, warmup_updates=2), mesh=JMesh(data=1))
    want = jax.device_get(JTrainer(jconf, JS2UT(cfg), params).train_batch(b))
    tconf = tconfig.from_dict(tconfig.Config, dataclasses.asdict(jconf))
    tconf.model = tcfg(cfg)
    trainer = TTrainer(tconf, t_model("s2ut", cfg, params), "cpu")
    got = trainer.train_batch(copy.deepcopy(b))
    for key in ("loss", "nll_loss", "ctc_loss", "asr_loss", "ntokens"):
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]), rtol=1e-4)
    valid = trainer.evaluate(iter([b]))
    assert np.isfinite(valid["loss"]) and valid["ntokens"] == float(want["ntokens"])


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def assert_grads_close(model, want_params):
    """Each parameter's gradient (flax layout; none = zero) within 1e-4 of
    the tensor's largest |JAX gradient| (floored at 1e-3)."""
    grads = copy.deepcopy(model)
    for g, p in zip(grads.parameters(), model.parameters()):
        g.data = p.grad if p.grad is not None else torch.zeros_like(p)
    got = to_flax(grads)
    want = {"/".join(k): np.asarray(_get(want_params, k)) for k in _paths(want_params)}
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(got[key], w, atol=1e-4 * scale, rtol=0, err_msg=key)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
