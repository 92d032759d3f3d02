"""The port's other fusion types against the JAX package's, with the same
flax parameters (``convert.from_flax``) and numpy-seeded inputs.

1. Each module alone: ``MultimodalAttention`` (its learned extra key/value
   column, ``add_bias_kv``) with and without the text+image merge and a
   mask; ``CrossModalLayer`` in its
   four norm/order settings; the external and BridgeTower towers; the
   Q-Former. fp32 atol 1e-5, bf16 5e-2.
2. Six small models (64-d, 2 + 2 layers, 6 image tokens): multimodal
   attention over two image sources, multimodal attention with the merge,
   the external tower over two sources, the BridgeTower with more levels
   than encoder layers (the last state repeated), and the Q-Former over
   selective attention on the conv-transformer and on a HuBERT encoder.
   For each: ``encode`` and the teacher-forced logits (fp32 atol 1e-4;
   bf16 5e-2 times the largest magnitude, floored at 1, as
   ``tests/test_torch_config_branches.py`` holds bf16 states), beam-search tokens on the float and the int8 cache (equal, scores
   atol 1e-4), the loss and every gradient at dropout 0 against
   ``jax.grad`` (``tests/test_torch_train_model.py``'s rule), and a
   ``from_flax``/``to_flax`` round trip.
3. The towers' modality dropout at probability 1 drops the images and never
   the speech, as the reference's.
4. ``init_parameters_``'s ``bias_k``/``bias_v`` and ``query_embedding``
   statistics against flax's initializers.
5. ``ContinuousServer`` on the merged type against JAX's offline search
   (the cross caches sized T + Ti by the server's probe encode)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import ModelConfig, MultimodalConfig
from mm_s2ut.models import fusion as jf
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
from mm_s2ut.models.wav2vec2 import Wav2Vec2Config as JW2V
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import flatten, from_flax, to_flax
from mm_s2ut_torch.infer.serving import ContinuousServer, Request
from mm_s2ut_torch.models import fusion as tf
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TModel
from mm_s2ut_torch.models.mm_s2ut import init_parameters_
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config as TW2V
from mm_s2ut_torch.ops.dropout import DropoutRng
from tests.test_torch_serving import COMMON, MAX_LEN, Pair, _check_against_offline
from tests.test_torch_serving import V as SERVE_V

torch.set_num_threads(1)
MOD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, T, S, TT, TI, V, EOS = 2, 40, 2400, 5, 6, 40, 2
BASE = dict(encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=2,
            encoder_attention_heads=4, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
            decoder_layers=2, decoder_attention_heads=4, conv_channels=16, vocab_size=V,
            dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
NO_DROP = dict(modality_dropout=0.0, SA_image_dropout=0.0, SA_attention_dropout=0.0)
W2V = dict(conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=48,
           num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
           hidden_dropout=0.0, attention_dropout=0.0, mask_time_prob=0.0)
Q_FORMER = dict(multimodal_attention_type="selective_attention",
                multimodal_extractor_type="q_former", num_queries=4, num_query_layers=2,
                num_multimodal_layers=1)
# setting → (ModelConfig fields, MultimodalConfig fields, image widths, flax leaves it holds)
SETTINGS = {
    "multimodal_attention": (
        {}, {"multimodal_attention_type": "multimodal_attention"}, (48, 32),
        ("fusion0/multimodal_attn/bias_k", "fusion1/multimodal_attn/bias_v",
         "fusion1/multimodal_attn/attn/k_proj/kernel", "fusion0/gated_fusion/gate/kernel")),
    "multimodal_attention_merge": (
        {}, {"multimodal_attention_type": "multimodal_attention", "is_merge_text_img": True},
        (64,), ("fusion0/multimodal_attn/bias_k", "fusion0/image_pre_norm/scale")),
    "external_multimodal_transformer": (
        {}, {"multimodal_attention_type": "external_multimodal_transformer",
             "external_multimodal_transformer_layers": 2}, (48, 32),
        ("external_tower1/residual_norm/scale", "external_tower0/layer1/ffn/fc2/kernel",
         "external_img_proj1/kernel")),
    "bridge_tower": (
        {}, {"multimodal_attention_type": "bridge_tower",
             "external_multimodal_transformer_layers": 3}, (48,),
        ("bridge_tower0/residual_norm2/scale", "bridge_tower0/layer_m2_2/norm3/scale",
         "bridge_img_proj0/kernel")),
    "q_former": (
        {}, Q_FORMER, (128,),
        ("q_former/query_embedding", "q_former/query_layer1/cross_attn/v_proj/kernel",
         "q_former/multimodal_layer0/ffn/fc1/kernel", "q_former_speech_proj/kernel",
         "fusion0/selective_attn/q_proj/kernel")),
    "q_former_hubert": (
        {"speech_encoder_type": "hubert"}, Q_FORMER, (128,),
        ("q_former/query_embedding", "speech_encoder/feature_projection/kernel",
         "speech_proj/kernel")),
}


def _cfg(setting: str, dtype: str = "float32") -> ModelConfig:
    kw, mm, widths, _ = SETTINGS[setting]
    return ModelConfig(**BASE, **kw, dtype=dtype, multimodal=MultimodalConfig(
        image_feat_dim=list(widths), **NO_DROP, **mm))


def _hubert(setting: str) -> bool:
    return SETTINGS[setting][0].get("speech_encoder_type") == "hubert"


def _jmodel(cfg: ModelConfig) -> JModel:
    return JModel(cfg, w2v_cfg=JW2V(**W2V)) if cfg.speech_encoder_type == "hubert" else JModel(cfg)


def _tmodel(cfg: ModelConfig, params) -> TModel:
    tcfg = tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(cfg))
    model = TModel(tcfg, w2v_cfg=TW2V(**W2V)) if cfg.speech_encoder_type == "hubert" else TModel(tcfg)
    model.load_state_dict(from_flax(params, model))
    return model.eval()


def _batch(setting: str, seed: int = 1):
    rng = np.random.RandomState(seed)
    if _hubert(setting):
        src, lens = (0.3 * rng.randn(B, S)).astype(np.float32), np.array([S, S - 730], np.int32)
        src[1, lens[1]:] = 0.0
    else:
        src, lens = rng.randn(B, T, 80).astype(np.float32), np.array([T, T - 11], np.int32)
    masks = np.zeros((B, TI), bool)
    masks[1, TI - 2:] = True
    target = rng.randint(4, V, (B, TT)).astype(np.int32)
    target[1, -2:] = 1  # pad
    return {"src_features": src, "src_lengths": lens,
            "prev_output_tokens": rng.randint(4, V, (B, TT)).astype(np.int32),
            "imgs_list": tuple(rng.randn(B, TI, w).astype(np.float32)
                               for w in SETTINGS[setting][2]),
            "img_masks_list": tuple(masks for _ in SETTINGS[setting][2]), "target": target}


def _j_args(b):
    return (b["src_features"], b["src_lengths"], b["prev_output_tokens"], b["imgs_list"],
            b["img_masks_list"])


def _t(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x)


def _t_args(b):
    return (_t(b["src_features"]), _t(b["src_lengths"]), _t(b["prev_output_tokens"]),
            [_t(x) for x in b["imgs_list"]], [_t(x) for x in b["img_masks_list"]])


@functools.lru_cache(maxsize=None)
def _params(setting: str, scale: float = 1.0):
    """The JAX model's parameters (numpy). With ``scale`` != 1, for the
    search tests: the decoder's final LayerNorm scaled by it (sharper
    logits), and EOS's row of the tied embedding zeroed, so that random
    weights do not end every hypothesis at its first step."""
    cfg = _cfg(setting)
    p = _jmodel(cfg).init(jax.random.PRNGKey(3), *_j_args(_batch(setting)))
    p = jax.tree_util.tree_map(np.asarray, p)
    if scale != 1.0:
        norm = p["params"]["decoder"]["final_norm"]
        norm["scale"], norm["bias"] = norm["scale"] * scale, norm["bias"] * scale
        emb = p["params"]["decoder"]["embed"]["embed_tokens"]
        emb["embedding"] = emb["embedding"].copy()
        emb["embedding"][EOS] = 0.0
    return p


def _close(got, want, tol, what="", scaled=False):
    """atol ``tol``, or with ``scaled`` ``tol`` times the largest |want|
    (floored at 1)."""
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, what
    if scaled:
        tol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=0,
                               err_msg=what)


def _init_module(jmod, *args, **kw):
    params = jmod.init(jax.random.PRNGKey(0), *args, **kw)
    return jax.tree_util.tree_map(np.asarray, params)


def _load(tmod, params, dtype):
    tmod.load_state_dict(from_flax(params, tmod))
    return tmod.to(DT[dtype][1]).eval()


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("merge", [False, True])
def test_multimodal_attention_matches_jax(merge, masked, dtype):
    E, kdim = 32, 32 if merge else 24
    rng = np.random.RandomState(11)
    text, img = rng.randn(B, 7, E).astype(np.float32), rng.randn(B, 5, kdim).astype(np.float32)
    tmask, imask = np.zeros((B, 7), bool), np.zeros((B, 5), bool)
    tmask[1, 5:], imask[0, 3:] = True, True
    tmask, imask = (tmask, imask) if masked else (None, None)
    jmod = jf.MultimodalAttention(E, kdim, num_heads=2, dtype=DT[dtype][0])
    params = _init_module(jmod, text, tmask, img, imask, is_merge_text_img=merge)
    assert {"bias_k", "bias_v"} <= set(params["params"])  # add_bias_kv, the default
    want, want_mask = jmod.apply(params, text, tmask, img, imask, is_merge_text_img=merge)
    tmod = _load(tf.MultimodalAttention(E, kdim, num_heads=2), params, dtype)
    tm = (lambda m: None if m is None else torch.from_numpy(m))
    with torch.no_grad():
        got, got_mask = tmod(torch.from_numpy(text).to(DT[dtype][1]), tm(tmask),
                             torch.from_numpy(img).to(DT[dtype][1]), tm(imask),
                             is_merge_text_img=merge)
    assert got.shape == (B, 7 + 5 * merge, E)
    _close(got, want, MOD_TOL[dtype])
    if masked:
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    else:
        assert got_mask is None and want_mask is None


def test_merge_needs_matching_widths():
    with pytest.raises(ValueError, match="matching dims"):
        tf.MultimodalAttention(32, 24)(torch.zeros(1, 3, 32), None, torch.zeros(1, 2, 24),
                                       is_merge_text_img=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("self_attention_first", [True, False])
@pytest.mark.parametrize("norm_first", [False, True])
def test_cross_modal_layer_matches_jax(norm_first, self_attention_first, dtype):
    rng = np.random.RandomState(12)
    m1, m2 = rng.randn(B, 7, 32).astype(np.float32), rng.randn(B, 5, 32).astype(np.float32)
    k1, k2 = np.zeros((B, 7), bool), np.zeros((B, 5), bool)
    k1[1, 4:], k2[0, 2:] = True, True
    flags = dict(norm_first=norm_first, self_attention_first=self_attention_first)
    jmod = jf.CrossModalLayer(32, 2, 64, dropout=0.0, dtype=DT[dtype][0], **flags)
    params = _init_module(jmod, m1, m2, k1, k2)
    want = jmod.apply(params, m1, m2, k1, k2)
    tmod = _load(tf.CrossModalLayer(32, 2, 64, **flags), params, dtype)
    c = (lambda x: torch.from_numpy(x).to(DT[dtype][1]))
    with torch.no_grad():
        got = tmod(c(m1), c(m2), torch.from_numpy(k1), torch.from_numpy(k2))
    _close(got, want, MOD_TOL[dtype])


TOWER_CASES = {  # name → (JAX class, port class, levels)
    "external": (jf.ExternalMultimodalEncoder, tf.ExternalMultimodalEncoder, 3),
    "external_one_level": (jf.ExternalMultimodalEncoder, tf.ExternalMultimodalEncoder, 1),
    "bridge": (jf.BridgeTowerEncoder, tf.BridgeTowerEncoder, 2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(TOWER_CASES))
def test_tower_matches_jax(case, dtype):
    jcls, tcls, n = TOWER_CASES[case]
    rng = np.random.RandomState(13)
    m1 = [rng.randn(B, 7, 32).astype(np.float32) for _ in range(n)]
    m2 = [rng.randn(B, 5, 32).astype(np.float32) for _ in range(n)]
    k1, k2 = np.zeros((B, 7), bool), np.zeros((B, 5), bool)
    k1[1, 4:], k2[0, 2:] = True, True
    jmod = jcls(32, 2, 64, num_layers=n, dropout=0.0, dtype=DT[dtype][0])
    params = _init_module(jmod, m1, m2, k1, k2)
    # one residual_norm shared by every level (and none with one level);
    # residual_norm1/2 likewise
    names = set(params["params"])
    assert {"residual_norm", "residual_norm1", "residual_norm2"} & names == (
        {"residual_norm1", "residual_norm2"} if case == "bridge"
        else {"residual_norm"} if n > 1 else set())
    want = jmod.apply(params, m1, m2, k1, k2)
    tmod = _load(tcls(32, 2, 64, num_layers=n), params, dtype)
    c = (lambda x: torch.from_numpy(x).to(DT[dtype][1]))
    with torch.no_grad():
        got = tmod([c(x) for x in m1], [c(x) for x in m2], torch.from_numpy(k1),
                   torch.from_numpy(k2))
    for g, w in zip(*((got, want) if case == "bridge" else ((got,), (want,)))):
        _close(g, w, MOD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qformer_matches_jax(dtype):
    rng = np.random.RandomState(14)
    m1, m2 = rng.randn(B, 7, 32).astype(np.float32), rng.randn(B, 5, 32).astype(np.float32)
    k1, k2 = np.zeros((B, 7), bool), np.zeros((B, 5), bool)
    k1[1, 4:], k2[0, 2:] = True, True
    geometry = dict(num_heads=2, ffn_dim=64, num_queries=4, num_query_layers=2,
                    num_multimodal_layers=2)
    jmod = jf.QFormer(32, dropout=0.0, dtype=DT[dtype][0], **geometry)
    params = _init_module(jmod, m1, m2, k1, k2)
    want = jmod.apply(params, m1, m2, k1, k2)
    tmod = _load(tf.QFormer(32, **geometry), params, dtype)
    c = (lambda x: torch.from_numpy(x).to(DT[dtype][1]))
    with torch.no_grad():
        got = tmod(c(m1), c(m2), torch.from_numpy(k1), torch.from_numpy(k2))
    assert got.shape == (B, 4, 32)
    _close(got, want, MOD_TOL[dtype])


def test_init_statistics_match_flax():
    """bias_k/bias_v: flax's xavier-normal on (1, 1, kdim), a normal
    truncated at 2σ with the std √(2 / (1 + kdim)) after truncation;
    query_embedding: N(0, 0.02)."""
    kdim, n_q, e = 40000, 400, 64
    jmm = _init_module(jf.MultimodalAttention(8, kdim), np.zeros((1, 2, 8), np.float32), None,
                       np.zeros((1, 3, kdim), np.float32))["params"]
    jq = _init_module(jf.QFormer(e, num_heads=1, ffn_dim=8, num_queries=n_q, num_query_layers=0,
                                 num_multimodal_layers=1),
                      np.zeros((1, 2, e), np.float32), np.zeros((1, 3, e), np.float32))["params"]
    tmm = init_parameters_(tf.MultimodalAttention(8, kdim), torch.Generator().manual_seed(0))
    tq = init_parameters_(tf.QFormer(e, num_heads=1, ffn_dim=8, num_queries=n_q,
                                     num_query_layers=0, num_multimodal_layers=1),
                          torch.Generator().manual_seed(0))
    std = (2.0 / (1 + kdim)) ** 0.5
    for name in ("bias_k", "bias_v"):
        for x in (np.asarray(jmm[name]), getattr(tmm, name).detach().numpy()):
            assert x.shape == (1, 1, kdim)
            assert abs(x.std() / std - 1) < 0.02 and abs(x.mean()) < 0.02 * std
            assert np.abs(x).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6)
    assert not torch.equal(tmm.bias_k, tmm.bias_v)
    for x in (np.asarray(jq["query_embedding"]), tq.query_embedding.detach().numpy()):
        assert x.shape == (1, n_q, e)
        assert abs(x.std() / 0.02 - 1) < 0.02 and abs(x.mean()) < 1e-3
        assert np.abs(x).max() > 3 * 0.02  # not truncated
    # the attention projections stay xavier-uniform, the FFN lecun-normal
    w = tq.multimodal_layer0.self_attn.q_proj.weight
    assert w.abs().max() <= (6 / (2 * e)) ** 0.5


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_encode_and_logits_match_jax(setting, dtype):
    jcfg = _cfg(setting, dtype)
    jmodel, params = _jmodel(jcfg), _params(setting)
    tmodel = _tmodel(jcfg, params)
    b = _batch(setting, seed=2)
    want = jmodel.apply(params, *_j_args(b), deterministic=True)
    enc_args = (*_j_args(b)[:2], *_j_args(b)[3:])
    want_enc = jmodel.apply(params, *enc_args, deterministic=True, method=jmodel.encode)
    with torch.no_grad():
        got = tmodel(*_t_args(b))
        got_enc = tmodel.encode(*_t_args(b)[:2], *_t_args(b)[3:])
    np.testing.assert_array_equal(got_enc["encoder_padding_mask"].numpy(),
                                  np.asarray(want_enc["encoder_padding_mask"]))
    bf16 = dtype == "bfloat16"
    _close(got_enc["encoder_out"], want_enc["encoder_out"], TOL[dtype], "encoder_out", bf16)
    _close(got["logits"], want["logits"], TOL[dtype], "logits", bf16)
    if setting == "multimodal_attention_merge":  # [speech; image], the image unmasked
        n = got_enc["encoder_out"].shape[1] - TI
        assert not got_enc["encoder_padding_mask"][:, n:].any()
        assert got_enc["encoder_padding_mask"][1, :n].any()


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_parameters_round_trip(setting):
    params = _params(setting)
    flat = flatten(params["params"])
    assert set(SETTINGS[setting][3]) <= set(flat)
    back = to_flax(_tmodel(_cfg(setting), params))
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("drop_audio", [True, False])
@pytest.mark.parametrize("setting", ["external_multimodal_transformer", "bridge_tower"])
def test_tower_modality_dropout_drops_images_never_speech(setting, drop_audio):
    """Modality dropout at probability 1 in training: dropping the audio
    leaves the towers' output as it was (they read the encoder's states),
    dropping the images equals zero images; both as JAX's."""
    kw, mm, widths, _ = SETTINGS[setting]
    jcfg = dataclasses.replace(_cfg(setting), multimodal=dataclasses.replace(
        _cfg(setting).multimodal, modality_dropout=1.0, audio_dropout=float(drop_audio)))
    jmodel, params = _jmodel(jcfg), _params(setting)
    tmodel = _tmodel(jcfg, params)
    b = _batch(setting, seed=6)
    enc_args = (*_j_args(b)[:2], *_j_args(b)[3:])
    want = jmodel.apply(params, *enc_args, deterministic=False, method=jmodel.encode,
                        rngs={"dropout": jax.random.PRNGKey(0), "modality": jax.random.PRNGKey(1)})
    tmodel.train().set_dropout_rng(DropoutRng(0, "cpu"))
    with torch.no_grad():
        got = tmodel.encode(*_t_args(b)[:2], *_t_args(b)[3:])
        tmodel.eval()
        imgs = _t_args(b)[3]
        plain = tmodel.encode(*_t_args(b)[:2], imgs if drop_audio else
                              [torch.zeros_like(x) for x in imgs], _t_args(b)[4])
    _close(got["encoder_out"], want["encoder_out"], TOL["float32"])
    torch.testing.assert_close(got["encoder_out"], plain["encoder_out"], rtol=0, atol=0)


def test_server_on_merged_type_matches_jax_offline_search():
    """The merged encoder output [speech; image] through the server: its
    probe encode sizes the cross caches at T + Ti columns."""
    cfg = ModelConfig(
        encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
        decoder_layers=1, decoder_attention_heads=2, conv_channels=16, vocab_size=SERVE_V,
        dtype="float32", multimodal=MultimodalConfig(
            image_feat_dim=[32], multimodal_attention_type="multimodal_attention",
            is_merge_text_img=True))
    jmodel = JModel(cfg)
    rng = np.random.RandomState(0)
    params = jmodel.init(
        jax.random.PRNGKey(7), jnp.asarray(rng.randn(1, 32, 80), jnp.float32),
        jnp.full((1,), 32, jnp.int32), jnp.zeros((1, 3), jnp.int32),
        imgs_list=(jnp.asarray(rng.randn(1, 6, 32), jnp.float32),),
        img_masks_list=(jnp.zeros((1, 6), bool),))
    pair = Pair(jmodel, params)
    reqs = []
    for i in range(3):
        n = 24 + 8 * (i % 2)
        mask = np.zeros(6, bool)
        mask[5 - i:] = True
        reqs.append(Request(i, rng.randn(n, 80).astype(np.float32), n,
                            imgs=(rng.randn(6, 32).astype(np.float32),), img_masks=(mask,)))
    srv = ContinuousServer(pair.tmodel, slots=2, ring=32, chunk=4, max_len_a=0.0,
                           max_len_b=MAX_LEN, img_shapes=((6, 32),), **COMMON)
    state = srv.init_state()
    assert state["cross"][0]["kv"].shape[2] == COMMON["enc_frames"] // 4 + 6
    _check_against_offline(pair, srv, reqs)
