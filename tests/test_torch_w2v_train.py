"""Training of the speech encoders and the enhanced path: the port against
the JAX package, at a small size (wav2vec2 of 3 layers, 48-d; decoders
of 2 layers, 32-d), fp32, on the same flax parameters:

* ``span_mask_from_scores`` against ``span_mask`` on JAX's own uniforms
  (``jax.random.uniform(key, (B, T))``), with and without lengths, and on
  scores with ties: the bits equal;
* LayerDrop given the same draws (JAX's ``jax.random.uniform`` of each
  layer's scalar and the port's ``_layerdrop_draw`` fed one list), for
  ``Wav2Vec2Model`` and ``Wav2Vec2WithMultiModal`` (where a dropped layer
  skips its fusion too): hidden states atol 1e-4;
* gradients equal with ``gradient_checkpointing`` (wav2vec2) and
  ``checkpoint_activations`` (the conv-transformer) on and off with every
  dropout at 0.1, to 1e-6, the run's seed stream left where it would be;
  ``torch.utils.checkpoint`` alone (no generator restore) gives other
  gradients;
* the settings the port refused in training before, each now run against
  ``jax.grad`` (a train step's loss relative 1e-5, every gradient 1e-4 of
  its tensor's largest magnitude, floored at 1e-3 for the k-projection
  biases' rounding): ``ctc_weight`` and ``multitask`` on the flagship,
  ``mask_time_prob``, ``layerdrop`` and ``gradient_checkpointing`` on the
  ``hubert`` flagship (span scores and LayerDrop draws fed to both);
* an XM train step (LayerDrop, no masking: the trainer never asks XM to
  mask) against ``jax.grad``;
* ``freezing_updates`` 2 against JAX's ``Trainer`` over three steps with
  weight decay 0.1: the ``speech_encoder`` parameters bit-unchanged by
  steps 1 and 2 in both and moved by step 3, the XM model's ``wav2vec2``
  never frozen; Adam's moments against optax's.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import Config as JConfig
from mm_s2ut.config import MeshConfig as JMesh
from mm_s2ut.config import ModelConfig as JModelCfg
from mm_s2ut.config import MultimodalConfig as JMMCfg
from mm_s2ut.config import MultitaskTaskConfig as JTaskCfg
from mm_s2ut.config import TrainConfig as JTrainCfg
from mm_s2ut.models import wav2vec2 as JW
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JS2UT
from mm_s2ut.models.mm_xm import MMXMTransformerModel as JXM
from mm_s2ut.train.criterion import speech_to_unit_criterion as j_criterion
from mm_s2ut.train.trainer import Trainer as JTrainer
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import from_flax, to_flax
from mm_s2ut_torch.models import wav2vec2 as TW
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TS2UT
from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel as TXM
from mm_s2ut_torch.ops.dropout import DropoutRng
from mm_s2ut_torch.train.criterion import speech_to_unit_criterion as t_criterion
from mm_s2ut_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)
B, S, T, TT, TI, V = 2, 2400, 40, 5, 6, 40
W2V = dict(conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=48,
           num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
           hidden_dropout=0.0, attention_dropout=0.0, mask_time_prob=0.0)
DEC = dict(decoder_embed_dim=32, decoder_ffn_embed_dim=64, decoder_layers=2,
           decoder_attention_heads=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
           encoder_layers=2, encoder_attention_heads=2, conv_channels=16, vocab_size=V,
           dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
MM = dict(image_feat_dim=[16], multimodal_attention_type="selective_attention",
          modality_dropout=0.0, SA_image_dropout=0.0, SA_attention_dropout=0.0)
N_FRAMES = 239  # 2400 samples through the (10, 5) and (3, 2) convs


def wave_batch(seed=1):
    rng = np.random.RandomState(seed)
    wav = (0.3 * rng.randn(B, S)).astype(np.float32)
    lens = np.array([S, S - 730], np.int32)
    wav[1, lens[1]:] = 0.0
    masks = np.zeros((B, TI), bool)
    masks[1, TI - 2:] = True
    target = rng.randint(4, V, (B, TT)).astype(np.int32)
    target[1, 3:] = 1
    return {"src_features": wav, "src_lengths": lens,
            "prev_output_tokens": rng.randint(4, V, (B, TT)).astype(np.int32),
            "target": target, "imgs_list": (rng.randn(B, TI, 16).astype(np.float32),),
            "img_masks_list": (masks,)}


def j_args(b):
    return (b["src_features"], b["src_lengths"], b["prev_output_tokens"], b["imgs_list"],
            b["img_masks_list"])


def t_args(b):
    conv = (lambda x: torch.from_numpy(np.array(x)).long() if np.asarray(x).dtype == np.int32
            else torch.from_numpy(np.array(x)))
    return (conv(b["src_features"]), conv(b["src_lengths"]), conv(b["prev_output_tokens"]),
            [conv(x) for x in b["imgs_list"]], [conv(x) for x in b["img_masks_list"]])


def t_batch(b):
    out = {}
    for k, v in b.items():
        if isinstance(v, dict):
            out[k] = {n: torch.from_numpy(np.array(x)).long() for n, x in v.items()}
        elif not isinstance(v, tuple):
            x = torch.from_numpy(np.array(v))
            out[k] = x.long() if x.dtype == torch.int32 else x
    return out


class Draws:
    """The same random numbers for both packages: ``scores`` (B, T) span
    uniforms and ``layer`` LayerDrop uniforms in call order. JAX reads
    them through ``jax.random.uniform`` (patched), the port through its
    ``Wav2Vec2Model._span_scores`` and ``_layerdrop_draw``."""

    def __init__(self, monkeypatch, scores=None, layer=()):
        self.scores, self.j_layer, self.t_layer = scores, list(layer), list(layer)
        real = jax.random.uniform

        def j_uniform(key, shape=(), *a, **k):
            if tuple(shape) == () and self.j_layer:
                return jnp.float32(self.j_layer.pop(0))
            if self.scores is not None and tuple(shape) == self.scores.shape:
                return jnp.asarray(self.scores)
            return real(key, shape, *a, **k)

        monkeypatch.setattr(jax.random, "uniform", j_uniform)
        monkeypatch.setattr(TW.Wav2Vec2Model, "_span_scores",
                            lambda mod, b, t, dev: torch.from_numpy(self.scores).to(dev))
        monkeypatch.setattr(TW.Wav2Vec2Model, "_layerdrop_draw",
                            lambda mod: self.t_layer.pop(0))

    def used_up(self):
        return not self.j_layer and not self.t_layer


RNGS = {"dropout": jax.random.PRNGKey(0), "modality": jax.random.PRNGKey(1),
        "mask": jax.random.PRNGKey(2)}

# ---------------------------------------------------------------------------
# span masking and LayerDrop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T_,p,length,lengths", [
    (239, 0.05, 10, None), (239, 0.05, 10, (239, 170)), (239, 0.3, 10, (239, 12)),
    (50, 0.65, 4, (50, 31)), (7, 0.05, 10, None)])
def test_span_mask_bits_match_jax(T_, p, length, lengths):
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        lens = None if lengths is None else jnp.asarray(lengths)
        want = np.asarray(JW.span_mask(key, (B, T_), p, length, lens))
        scores = np.asarray(jax.random.uniform(key, (B, T_)))
        got = TW.span_mask_from_scores(torch.from_numpy(scores), p, length,
                                       None if lengths is None else torch.tensor(lengths))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any()


def test_span_mask_ties_break_like_top_k(monkeypatch):
    scores = np.round(np.random.RandomState(0).rand(B, 60), 1).astype(np.float32)
    Draws(monkeypatch, scores=scores)
    want = np.asarray(JW.span_mask(jax.random.PRNGKey(0), (B, 60), 0.5, 3,
                                   jnp.asarray([60, 41])))
    got = TW.span_mask_from_scores(torch.from_numpy(scores), 0.5, 3, torch.tensor([60, 41]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("multimodal", [False, True])
def test_layerdrop_matches_jax_given_the_draws(monkeypatch, multimodal):
    cfg = dict(W2V, layerdrop=0.5)
    b = wave_batch(3)
    wav, lens, img = b["src_features"], b["src_lengths"], b["imgs_list"][0]
    if multimodal:
        jmod = JW.Wav2Vec2WithMultiModal(JW.Wav2Vec2Config(**cfg), m2_dim=16,
                                         num_cross_attention_layers=2, dropout=0.0)
        args = (wav, lens, img)
    else:
        jmod, args = JW.Wav2Vec2Model(JW.Wav2Vec2Config(**cfg)), (wav, lens)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), *args))
    if multimodal:
        tmod = TW.Wav2Vec2WithMultiModal(TW.Wav2Vec2Config(**cfg), m2_dim=16,
                                         num_cross_attention_layers=2, dropout=0.0)
    else:
        tmod = TW.Wav2Vec2Model(TW.Wav2Vec2Config(**cfg))
    tmod.load_state_dict(from_flax(params, tmod))
    tmod.train()
    for draws in ([0.9, 0.2, 0.7], [0.1, 0.6, 0.3], [0.3, 0.4, 0.1]):
        d = Draws(monkeypatch, layer=draws)
        want = jmod.apply(params, *args, deterministic=False, rngs=RNGS)
        with torch.no_grad():
            got = tmod(*[torch.from_numpy(x) if x.dtype != np.int32 else
                         torch.from_numpy(x).long() for x in args])
        assert d.used_up()
        assert len(got["hidden_states"]) == len(want["hidden_states"]) == 4
        for i, (g, w) in enumerate(zip(got["hidden_states"], want["hidden_states"])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=str(i))


# ---------------------------------------------------------------------------
# checkpointing with dropout on
# ---------------------------------------------------------------------------


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _train_grads(model, b, seed, naive=False):
    """Loss and gradients of one training forward with the run's
    generators from ``seed``; the seed stream's next draw after it."""
    rng = DropoutRng(seed, "cpu")
    model.set_dropout_rng(rng)
    model.train().zero_grad()
    if naive:  # the trap: checkpoint without restoring the run's generators
        import mm_s2ut_torch.models.s2t_encoder as enc_mod
        import mm_s2ut_torch.models.wav2vec2 as w2v_mod

        plain = (lambda fn, rng, *a: torch.utils.checkpoint.checkpoint(fn, *a,
                                                                        use_reentrant=False))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(enc_mod, "checkpoint", plain)
            mp.setattr(w2v_mod, "checkpoint", plain)
            out = model(*t_args(b))
            loss, m = t_criterion(out, t_batch(b), label_smoothing=0.2)
            (loss / m["ntokens"]).backward()
    else:
        out = model(*t_args(b))
        loss, m = t_criterion(out, t_batch(b), label_smoothing=0.2)
        (loss / m["ntokens"]).backward()
    return float(loss.detach()), _grads(model), rng.next_seed()


@pytest.mark.parametrize("kind", ["conv_transformer", "hubert"])
def test_checkpointing_keeps_gradients_with_dropout(kind):
    drops = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)
    w2v = dict(W2V, hidden_dropout=0.1, attention_dropout=0.1, mask_time_prob=0.05,
               layerdrop=0.1)
    cfgs = {}
    for on in (False, True):
        if kind == "hubert":
            cfgs[on] = (tconfig.ModelConfig(**{**DEC, **drops}, speech_encoder_type="hubert",
                                            dtype="float32", multimodal=tconfig.MultimodalConfig(
                                                **MM)), TW.Wav2Vec2Config(
                                                    **w2v, gradient_checkpointing=on))
        else:
            cfgs[on] = (tconfig.ModelConfig(**{**DEC, **drops}, checkpoint_activations=on,
                                            dtype="float32",
                                            multimodal=tconfig.MultimodalConfig(**MM)), None)
    b = wave_batch(5)
    if kind == "conv_transformer":
        b["src_features"] = np.random.RandomState(5).randn(B, T, 80).astype(np.float32)
        b["src_lengths"] = np.array([T, T - 9], np.int32)
    torch.manual_seed(0)
    state = {k: v.clone() for k, v in TS2UT(*cfgs[False]).state_dict().items()}
    runs = {}
    for on in (False, True):
        model = TS2UT(*cfgs[on])
        model.load_state_dict(state)
        runs[on] = _train_grads(model, b, seed=11)
    (loss_a, ga, next_a), (loss_b, gb, next_b) = runs[False], runs[True]
    assert loss_a == loss_b and next_a == next_b
    assert set(ga) == set(gb)
    layers = {n.split(".")[1] for n in ga if ".layer" in n and "encoder" in n.split(".")[0]}
    assert len(layers) >= 2, layers  # LayerDrop kept layers to checkpoint
    for name in ga:
        np.testing.assert_allclose(gb[name].numpy(), ga[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    model = TS2UT(*cfgs[True])
    model.load_state_dict(state)
    _, naive, _ = _train_grads(model, b, seed=11, naive=True)
    assert max(float((naive[n] - ga[n]).abs().max()) for n in ga) > 1e-5


# ---------------------------------------------------------------------------
# the formerly refused settings, against jax.grad
# ---------------------------------------------------------------------------


SETTINGS = {  # setting → (model kind, ModelConfig fields, wav2vec2 fields)
    "ctc_weight": ("conv_transformer", dict(ctc_weight=0.3), {}),
    "multitask": ("conv_transformer", dict(multitask=[
        JTaskCfg(task_name="asr", decoder_type="ctc", vocab_size=30, loss_weight=0.5)]), {}),
    "mask_time_prob": ("hubert", {}, dict(mask_time_prob=0.05)),
    "layerdrop": ("hubert", {}, dict(layerdrop=0.5)),
    "gradient_checkpointing": ("hubert", {}, dict(gradient_checkpointing=True,
                                                 mask_time_prob=0.05)),
}


def _aux_targets(b, seed):
    rng = np.random.RandomState(seed)
    ctc = rng.randint(2, V, (B, 4)).astype(np.int32)
    ctc[1, 2:] = 1
    asr = rng.randint(2, 30, (B, 3)).astype(np.int32)
    asr[0, 2:] = 1
    b["multitask_target"] = ctc
    b["multitask_targets"] = {"asr": asr}
    return b


def _j_and_t(kind, fields, w2v_fields, b, xm=False):
    w2v = dict(W2V, **w2v_fields)
    jkw = dict(DEC, **fields)
    if not xm and kind == "hubert":
        jkw["speech_encoder_type"] = "hubert"
    jcfg = JModelCfg(**jkw, dtype="float32", multimodal=JMMCfg(**MM))
    jmodel = (JXM if xm else JS2UT)(jcfg, w2v_cfg=JW.Wav2Vec2Config(**w2v))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(7), *j_args(b)))
    tcfg = tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(jcfg))
    tcfg.multitask = [tconfig.MultitaskTaskConfig(**t) for t in tcfg.multitask]
    tmodel = (TXM if xm else TS2UT)(tcfg, w2v_cfg=TW.Wav2Vec2Config(**w2v))
    tmodel.load_state_dict(from_flax(params, tmodel))
    return jcfg, jmodel, params, tcfg, tmodel


def _step_against_jax_grad(jcfg, jmodel, params, tcfg, tmodel, b):
    kw = dict(label_smoothing=0.2, ctc_weight=jcfg.ctc_weight, multitask=tuple(jcfg.multitask))

    def j_loss(p):
        out = jmodel.apply(p, *j_args(b), deterministic=False, rngs=RNGS)
        loss, m = j_criterion(out, b, **kw)
        return loss / m["ntokens"], m

    (want_loss, want_m), want = jax.value_and_grad(j_loss, has_aux=True)(params)
    tmodel.set_dropout_rng(DropoutRng(0, "cpu"))
    tmodel.train().zero_grad()
    out = tmodel(*t_args(b))
    loss, m = t_criterion(out, t_batch(b), **dict(kw, multitask=tuple(tcfg.multitask)))
    (loss / m["ntokens"]).backward()
    np.testing.assert_allclose(float((loss / m["ntokens"]).detach()), float(want_loss),
                               rtol=1e-5)
    for key in want_m:
        np.testing.assert_allclose(float(m[key].detach()), float(want_m[key]), rtol=1e-5, err_msg=key)
    assert_grads_close(tmodel, want["params"])
    return out


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_formerly_refused_settings_train_like_jax(monkeypatch, setting):
    kind, fields, w2v_fields = SETTINGS[setting]
    b = wave_batch(6)
    if kind == "conv_transformer":
        b["src_features"] = np.random.RandomState(6).randn(B, T, 80).astype(np.float32)
        b["src_lengths"] = np.array([T, T - 9], np.int32)
        b = _aux_targets(b, 6)
    scores = np.random.RandomState(9).rand(B, N_FRAMES).astype(np.float32)
    d = Draws(monkeypatch, scores=scores, layer=[0.2, 0.9, 0.7])
    args = _j_and_t(kind, fields, w2v_fields, b)
    out = _step_against_jax_grad(*args, b)
    if setting == "layerdrop":  # layer 0 dropped (0.2 < 0.5), in both packages
        assert d.used_up()
        assert all(g is None for g in (p.grad for p in args[4].speech_encoder.layer0.parameters()))
    if setting in ("ctc_weight", "multitask"):
        assert ("ctc_logits" in out) == (setting == "ctc_weight")


def test_xm_train_step_matches_jax_grad(monkeypatch):
    b = wave_batch(8)
    d = Draws(monkeypatch, layer=[0.6, 0.05, 0.8])  # layer 1 dropped
    args = _j_and_t("xm", {}, dict(layerdrop=0.1, mask_time_prob=0.05), b, xm=True)
    _step_against_jax_grad(*args, b)
    assert d.used_up()  # the JAX pass reads its three draws, the port its three
    assert args[4].wav2vec2.masked_spec_embed.grad is None  # XM never masks


# ---------------------------------------------------------------------------
# freezing_updates against JAX's Trainer
# ---------------------------------------------------------------------------


def _adam_moments(opt_state):
    """optax's ScaleByAdamState (mu, nu) in the chain."""
    for node in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return node.mu, node.nu
    raise AssertionError("no Adam state")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("kind", ["hubert", "xm"])
def test_freezing_updates_match_jax_trainer(kind):
    """Steps 1 and 2 leave every ``speech_encoder`` parameter bit-unchanged
    (weight decay 0.1 included) and step 3 moves them, in both packages;
    the XM model's ``wav2vec2`` is never frozen. Adam's moments of the
    frozen parameters are 0 through step 2 and within 1e-6 of optax's
    after step 3; every moment within 1e-6 of optax's after step 1."""
    b = wave_batch(10)
    xm = kind == "xm"
    jcfg, jmodel, params, tcfg, tmodel = _j_and_t(kind, {}, {}, b, xm=xm)
    jconf = JConfig(model=jcfg, train=JTrainCfg(lr=1e-3, warmup_updates=2, weight_decay=0.1,
                                                freezing_updates=2), mesh=JMesh(data=1))
    jtrainer = JTrainer(jconf, jmodel, params)
    tconf = tconfig.from_dict(tconfig.Config, dataclasses.asdict(jconf))
    tconf.model = tcfg
    trainer = TTrainer(tconf, tmodel, "cpu")
    prefix = "wav2vec2" if xm else "speech_encoder"
    start = _flat(params["params"])
    enc_keys = [k for k in start if k.startswith(prefix + "/")]
    assert enc_keys
    for step in range(3):
        want_m = jax.device_get(jtrainer.train_batch(b))
        got_m = trainer.train_batch(copy.deepcopy(b))
        np.testing.assert_allclose(got_m["loss"], float(want_m["loss"]), rtol=1e-5)
        j_params = _flat(jax.device_get(jtrainer.state.params)["params"])
        t_params = to_flax(trainer.model)
        mu_j, nu_j = (_flat(x["params"]) for x in
                      jax.device_get(_adam_moments(jtrainer.state.opt_state)))
        names = [n for n, _ in trainer.model.named_parameters()]
        mods = dict(trainer.model.named_modules())
        mu_t = _moments_flax(trainer.optimizer.mu, names, mods)
        nu_t = _moments_flax(trainer.optimizer.nu, names, mods)
        moved = [k for k in enc_keys if not np.array_equal(j_params[k], start[k])]
        moved_t = [k for k in enc_keys if not np.array_equal(t_params[k], start[k])]
        frozen = not xm and step < 2
        if frozen:
            assert moved == moved_t == []
            for k in enc_keys:
                assert not mu_j[k].any() and not mu_t[k].any()
                assert not nu_j[k].any() and not nu_t[k].any()
        else:
            # Every trained leaf moves, and weight decay moves the frozen
            # conv frontend's nonzero leaves too.
            assert sorted(moved) == sorted(moved_t)
            assert {k for k in enc_keys if "feature_extractor" not in k} <= set(moved)
            assert any("feature_extractor" in k for k in moved)
        keys = enc_keys if (step == 2 and not xm) else (list(mu_j) if step == 0 else [])
        for k in keys:
            np.testing.assert_allclose(mu_t[k], mu_j[k], atol=1e-6, rtol=0, err_msg=f"mu {k}")
            np.testing.assert_allclose(nu_t[k], nu_j[k], atol=1e-6, rtol=0, err_msg=f"nu {k}")


def _moments_flax(moments, names, mods):
    """The optimizer's per-parameter moments in flax's layout (through a
    copy of the model whose parameters hold them)."""
    holder = copy.deepcopy(mods[""])
    for (n, p), m in zip(holder.named_parameters(), moments):
        p.data = m.clone()
    return to_flax(holder)


def assert_grads_close(model, want_params):
    """Each parameter's gradient (flax layout; none = zero) within 1e-4 of
    the tensor's largest |JAX gradient| (floored at 1e-3)."""
    grads = copy.deepcopy(model)
    for g, p in zip(grads.parameters(), model.parameters()):
        g.data = p.grad if p.grad is not None else torch.zeros_like(p)
    got = to_flax(grads)
    want = _flat(want_params)
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(got[key], w, atol=1e-4 * scale, rtol=0, err_msg=key)
