"""The flagship config branches of the port against the JAX package's,
on one small model per branch (2 + 2 layers, 32-d, one 16-d image source)
with the same flax parameters (``convert.from_flax``).

1. Each branch: encoder outputs and teacher-forced logits, fp32 atol
   1e-4 and bf16 5e-2 (``tests/test_torch_model.py``'s tolerances; the
   per-layer encoder states that ``is_fusion_top=False`` keeps, unnormed,
   at those times their largest magnitude), and ``from_flax``/``to_flax``
   round trips of its parameters.
2. ``n_frames_per_step = 2``: the label-smoothed loss and every
   parameter's gradient against ``jax.grad`` (relative 1e-4 of a tensor's
   largest magnitude, ``tests/test_torch_train_model.py``'s rule), and the
   dataset's unit packing against the JAX dataset's; beam decode and
   prefill raise, as in the reference.
3. A model with every decodable branch set, through ``UnitGenerator``:
   top tokens equal, scores atol 1e-4.
4. Speaker-conditioned vocoding against JAX's ``CodeHiFiGAN`` (atol 1e-4),
   from flax parameters and from a fairseq checkpoint.
5. ``ModelConfig()`` itself (multimodal attention at the flagship's
   width) against JAX's model; ``glu`` raises ``NotImplementedError``,
   and a pipelined encoder's forward without a pipe group ``ValueError``
   (the other fusion types: ``tests/test_torch_fusion_types.py``)."""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import DataConfig as JDataCfg
from mm_s2ut.config import GenerationConfig as JGenCfg
from mm_s2ut.config import ModelConfig, MultimodalConfig
from mm_s2ut.data.dataset import S2SItem as JItem
from mm_s2ut.data.dataset import SpeechToSpeechDataset as JDataset
from mm_s2ut.data.dataset import pack_units as j_pack_units
from mm_s2ut.data.dictionary import UnitDictionary as JUnitDict
from mm_s2ut.infer.generator import UnitGenerator as JGenerator
from mm_s2ut.models.hifigan import CodeHiFiGAN as JVocoder
from mm_s2ut.models.hifigan import load_fairseq_checkpoint as j_voc_load
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
from mm_s2ut.train.criterion import speech_to_unit_criterion as j_criterion
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import flatten, from_flax, to_flax
from mm_s2ut_torch.data.dataset import S2SItem as TItem
from mm_s2ut_torch.data.dataset import SpeechToSpeechDataset as TDataset
from mm_s2ut_torch.data.dataset import pack_units as t_pack_units
from mm_s2ut_torch.data.dictionary import UnitDictionary as TUnitDict
from mm_s2ut_torch.infer.generator import UnitGenerator as TGenerator
from mm_s2ut_torch.models.hifigan import CodeHiFiGAN as TVocoder
from mm_s2ut_torch.models.hifigan import load_fairseq_checkpoint as t_voc_load
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TModel
from mm_s2ut_torch.train.criterion import speech_to_unit_criterion as t_criterion
from tests.test_hifigan import SMALL, _torch_generator
from tests.test_torch_train_model import to_flat
from tests.test_torch_vocoder import LENS, UNITS, _tcfg

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, T, TT, TI, V, SPK = 2, 40, 5, 6, 40, 8
BASE = dict(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
            encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
            decoder_layers=2, decoder_attention_heads=2, conv_channels=16, vocab_size=V,
            dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
MM = dict(image_feat_dim=[16], multimodal_attention_type="selective_attention",
          modality_dropout=0.0, SA_image_dropout=0.0, SA_attention_dropout=0.0)
# branch → (ModelConfig fields, MultimodalConfig fields, flax leaves it adds, leaves it drops)
BRANCHES = {
    "gelu": ({"activation_fn": "gelu"}, {}, (), ()),
    "silu": ({"activation_fn": "silu"}, {}, (), ()),
    "swish": ({"activation_fn": "swish"}, {}, (), ()),
    "tanh": ({"activation_fn": "tanh"}, {}, (), ()),
    "post_norm": ({"encoder_normalize_before": False, "decoder_normalize_before": False}, {}, (),
                  ("encoder/final_layer_norm/scale", "decoder/final_norm/scale")),
    "untied_output": ({"share_decoder_input_output_embed": False}, {},
                      ("decoder/output_proj/kernel",), ()),
    "n_frames_per_step": ({"n_frames_per_step": 2}, {},
                          ("decoder/embed/pack_pos/embedding", "decoder/out_proj_n_frames/kernel"),
                          ()),
    "speaker": ({"speaker_embed_dim": SPK}, {}, ("spk_emb_proj/kernel", "spk_emb_proj/bias"), ()),
    "only_img": ({}, {"only_img": True}, ("only_img_proj/kernel",),
                 ("encoder/subsampler/conv0/kernel", "fusion0/gated_fusion/gate/kernel")),
    "fusion_not_top": ({}, {"is_fusion_top": False}, (), ("fusion0/gated_fusion/gate/kernel",)),
    "no_gate": ({}, {"use_selective_gate": False}, (), ("fusion0/gated_fusion/gate/kernel",)),
    "no_image_pre_norm": ({}, {"image_pre_norm": False}, (), ("fusion0/image_pre_norm/scale",)),
}


def _cfg(branch: str, dtype: str = "float32") -> ModelConfig:
    kw, mm, _, _ = BRANCHES[branch]
    return ModelConfig(**BASE, **kw, dtype=dtype, multimodal=MultimodalConfig(**MM, **mm))


def _batch(n_frames: int = 1, seed: int = 1):
    rng = np.random.RandomState(seed)
    masks = np.zeros((B, TI), bool)
    masks[1, TI - 2:] = True
    n_ids = (V - 4) ** n_frames + 4  # packed ids when n_frames > 1
    target = rng.randint(4, V, (B, n_frames * (TT - 1) + 1)).astype(np.int32)
    target[1, -3:] = 1  # pad
    return {
        "src_features": rng.randn(B, T, 80).astype(np.float32),
        "src_lengths": np.array([T, T - 11], np.int32),
        "prev_output_tokens": rng.randint(0, n_ids, (B, TT)).astype(np.int32),
        "imgs_list": (rng.randn(B, TI, 16).astype(np.float32),),
        "img_masks_list": (masks,),
        "tgt_speaker": rng.randn(B, SPK).astype(np.float32),
        "target": target,
    }


def _j_args(b):
    return (b["src_features"], b["src_lengths"], b["prev_output_tokens"], b["imgs_list"],
            b["img_masks_list"], b["tgt_speaker"])


def _t(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x)


def _t_args(b):
    return (_t(b["src_features"]), _t(b["src_lengths"]), _t(b["prev_output_tokens"]),
            [_t(x) for x in b["imgs_list"]], [_t(x) for x in b["img_masks_list"]],
            _t(b["tgt_speaker"]))


@functools.lru_cache(maxsize=None)
def _params(branch: str):
    cfg = _cfg(branch)
    b = _batch(cfg.n_frames_per_step)
    params = JModel(cfg).init(jax.random.PRNGKey(3), *_j_args(b))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(jcfg: ModelConfig, params) -> TModel:
    tmodel = TModel(tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(jcfg)))
    tmodel.load_state_dict(from_flax(params, tmodel))
    return tmodel.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_matches_jax(branch, dtype):
    jcfg = _cfg(branch, dtype)
    jmodel, params = JModel(jcfg), _params(branch)
    tmodel = _port(jcfg, params)
    b = _batch(jcfg.n_frames_per_step, seed=2)
    want = jmodel.apply(params, *_j_args(b), deterministic=True)
    want_enc = jmodel.apply(params, *_j_args(b)[:2], *_j_args(b)[3:], deterministic=True,
                            method=jmodel.encode)
    with torch.no_grad():
        got = tmodel(*_t_args(b))
        got_enc = tmodel.encode(*_t_args(b)[:2], *_t_args(b)[3:])
    np.testing.assert_array_equal(got_enc["encoder_padding_mask"].numpy(),
                                  np.asarray(want_enc["encoder_padding_mask"]))
    for g, w in [(got_enc["encoder_out"], want_enc["encoder_out"]),
                 (got["logits"], want["logits"])]:
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=TOL[dtype])
    # The layer states kept without top fusion are residual streams before
    # any final norm: held to the tolerance times their largest magnitude.
    assert len(got_enc["encoder_states"]) == len(want_enc["encoder_states"])
    if branch == "fusion_not_top":
        assert len(got_enc["encoder_states"]) == BASE["encoder_layers"]
    for g, w in zip(got_enc["encoder_states"], want_enc["encoder_states"]):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, atol=TOL[dtype] * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_parameters_round_trip(branch):
    """from_flax takes every leaf of the branch's tree and to_flax gives
    the same tree back, the branch's own leaves included."""
    params = _params(branch)
    flat = flatten(params["params"])
    _, _, adds, drops = BRANCHES[branch]
    assert set(adds) <= set(flat) and not set(drops) & set(flat)
    back = to_flax(_port(_cfg(branch), params))
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_n_frames_per_step_loss_and_gradients_match_jax_grad():
    jcfg = _cfg("n_frames_per_step")
    jmodel, params = JModel(jcfg), _params("n_frames_per_step")
    tmodel = _port(jcfg, params).float()
    b = _batch(2, seed=4)

    def j_loss(p):
        out = jmodel.apply(p, *_j_args(b), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0),
                                 "modality": jax.random.PRNGKey(1)})
        loss, m = j_criterion(out, b, label_smoothing=0.2)
        return loss / m["ntokens"]

    want_loss, want = jax.value_and_grad(j_loss)(params)
    want = to_flat(want["params"])
    tmodel.train()
    out = tmodel(*_t_args(b))
    assert out["logits"].shape[1] == 2 * TT  # n sub-frame logits per packed position
    loss, m = t_criterion(out, {"target": _t(b["target"])}, label_smoothing=0.2)
    loss = loss / m["ntokens"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = copy.deepcopy(tmodel)
    for g, p in zip(grads.parameters(), tmodel.parameters()):
        g.data = p.grad
    got = to_flax(grads)
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(np.abs(w).max(), 1e-4)
        np.testing.assert_allclose(got[key], w, atol=1e-4 * scale, rtol=0, err_msg=key)


def test_n_frames_per_step_dataset_packing_matches_jax():
    """pack_units, and the collated decoder input (packed), target
    (unpacked, trimmed to whole packs), lengths and speaker embeddings."""
    rng = np.random.RandomState(5)
    ids = np.concatenate([rng.randint(4, 40, 9), [2]])
    np.testing.assert_array_equal(t_pack_units(ids, 3, 40), j_pack_units(ids, 3, 40))
    tdict, jdict = TUnitDict(36), JUnitDict(36)
    assert len(tdict) == len(jdict)
    targets = [np.concatenate([rng.randint(4, 40, n), [2]]).astype(np.int64) for n in (6, 4, 8)]
    spk = [rng.randn(SPK).astype(np.float32) for _ in targets]
    wavs = [rng.randn(160 * (i + 2)).astype(np.float32) for i in range(3)]
    tds = TDataset("train", True, tconfig.DataConfig(n_frames_per_step=2), [], tdict)
    jds = JDataset("train", True, JDataCfg(n_frames_per_step=2), [], jdict)
    got = tds.collate([TItem(i, str(i), wavs[i], t, None, [], [], s)
                       for i, (t, s) in enumerate(zip(targets, spk))])
    want = jds.collate([JItem(i, str(i), wavs[i], t, None, "", [], [], s)
                        for i, (t, s) in enumerate(zip(targets, spk))])
    for key in ("prev_output_tokens", "target", "target_lengths", "ntokens", "tgt_speaker",
                "src_features", "src_lengths"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_n_frames_per_step_decode_raises():
    jcfg = _cfg("n_frames_per_step")
    tmodel = _port(jcfg, _params("n_frames_per_step"))
    b = _batch(2)
    with torch.no_grad():
        enc = tmodel.encode(*_t_args(b)[:2], *_t_args(b)[3:])
        with pytest.raises(NotImplementedError, match="n_frames_per_step"):
            tmodel.decode_init(enc, 8)
        with pytest.raises(NotImplementedError, match="n_frames_per_step"):
            tmodel.decode_prefill(torch.zeros((B, 3), dtype=torch.long), 2, {})


def test_generate_with_every_decodable_branch_matches_jax():
    """gelu, post-norm, an untied output, a speaker projection, no gate and
    no image pre-norm in one model; the output projection scaled ×8 on
    both sides, so the argmaxes are not near-ties."""
    kw = dict(activation_fn="gelu", encoder_normalize_before=False,
              decoder_normalize_before=False, share_decoder_input_output_embed=False,
              speaker_embed_dim=SPK)
    jcfg = ModelConfig(**BASE, **kw, dtype="float32", multimodal=MultimodalConfig(
        **MM, use_selective_gate=False, image_pre_norm=False))
    jmodel = JModel(jcfg)
    b = _batch(seed=6)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(5), *_j_args(b)))
    proj = params["params"]["decoder"]["output_proj"]
    proj["kernel"] = proj["kernel"] * 8.0
    tmodel = _port(jcfg, params)
    gkw = dict(beam=3, max_len_a=0.0, max_len_b=10)
    want = JGenerator(jmodel, params, JGenCfg(**gkw)).generate(
        b["src_features"], b["src_lengths"], b["imgs_list"], b["img_masks_list"])
    got = TGenerator(tmodel, tconfig.GenerationConfig(**gkw)).generate(
        b["src_features"], b["src_lengths"], b["imgs_list"], b["img_masks_list"])
    assert all(got[i][0]["tokens"] for i in range(B))
    for i in range(B):
        assert got[i][0]["tokens"] == want[i][0]["tokens"]
        np.testing.assert_allclose([h["score"] for h in got[i]], [h["score"] for h in want[i]],
                                   atol=1e-4)


SPK_VOC = SMALL.__class__(**{**SMALL.__dict__, "num_speakers": 3, "speaker_embedding_dim": 4,
                             "model_in_dim": SMALL.embedding_dim + 4})
SPEAKERS = np.array([2, 0], np.int32)


def test_speaker_conditioned_vocoder_matches_jax():
    jvoc = JVocoder(SPK_VOC, max_frames=48)
    params = jvoc.init(jax.random.PRNGKey(0), jnp.asarray(UNITS), jnp.asarray(LENS),
                       speaker=jnp.asarray(SPEAKERS))
    params = jax.tree_util.tree_map(np.asarray, params)
    assert "spkr" in params["params"]
    want_wav, want_n = jvoc.apply(params, UNITS, LENS, speaker=SPEAKERS)
    want_frames = jvoc.apply(params, UNITS[:, :4], jnp.asarray(SPEAKERS),
                             method=jvoc.vocode_frames)
    tvoc = TVocoder(_tcfg(SPK_VOC), max_frames=48)
    tvoc.load_state_dict(from_flax(params, tvoc))
    assert set(to_flax(tvoc)) == set(flatten(params["params"]))
    spk = torch.from_numpy(SPEAKERS).long()
    got_wav, got_n = tvoc(_t(UNITS), _t(LENS), speaker=spk)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(want_wav), atol=1e-4)
    np.testing.assert_allclose(tvoc.vocode_frames(_t(UNITS[:, :4]), spk).numpy(),
                               np.asarray(want_frames), atol=1e-4)


def test_speaker_vocoder_fairseq_checkpoint_matches_jax_loader(tmp_path):
    torch.manual_seed(0)
    cfg = SPK_VOC.__class__(**{**SPK_VOC.__dict__, "dur_prediction": False})
    sd = dict(_torch_generator(cfg).state_dict())
    sd["dict.weight"] = torch.randn(cfg.num_embeddings, cfg.embedding_dim)
    sd["spkr.weight"] = torch.randn(cfg.num_speakers, cfg.speaker_embedding_dim)
    torch.save({"generator": sd}, tmp_path / "vocoder.pt")
    jvoc = JVocoder(cfg, max_frames=32)
    want_wav, _ = jvoc.apply(j_voc_load(tmp_path / "vocoder.pt", cfg), UNITS, LENS,
                             speaker=SPEAKERS)
    tvoc = TVocoder(_tcfg(cfg), max_frames=32)
    tvoc.load_state_dict(t_voc_load(tmp_path / "vocoder.pt", _tcfg(cfg)))
    got_wav, _ = tvoc(_t(UNITS), _t(LENS), speaker=torch.from_numpy(SPEAKERS).long())
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(want_wav), atol=1e-4)


def test_default_config_matches_jax():
    """``ModelConfig()`` as it stands: the flagship's width in bf16 with the
    default fusion type, multimodal attention with its learned extra
    key/value column, on one short utterance and 4 image tokens: the
    encoder output and the logits within 5e-2 times their largest
    magnitude (the bf16 rule for states; both came within 0.047 absolute
    of JAX's when this test was written)."""
    jcfg = ModelConfig()
    assert jcfg.multimodal.multimodal_attention_type == "multimodal_attention"
    rng = np.random.RandomState(8)
    args = (rng.randn(1, 40, 80).astype(np.float32), np.array([40], np.int32),
            rng.randint(4, jcfg.vocab_size, (1, 4)).astype(np.int32),
            (rng.randn(1, 4, 768).astype(np.float32),), (np.zeros((1, 4), bool),))
    jmodel = JModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(9), *args))
    assert "bias_k" in params["params"]["fusion0"]["multimodal_attn"]
    tmodel = TModel(tconfig.ModelConfig())
    tmodel.load_state_dict(from_flax(params, tmodel))
    tmodel.eval()
    want = jmodel.apply(params, *args, deterministic=True)
    with torch.no_grad():
        got = tmodel(*(_t(x) for x in args[:3]), [_t(x) for x in args[3]],
                     [_t(x) for x in args[4]])
    for key in ("encoder_out", "logits"):
        w = np.asarray(want[key], np.float32)
        assert tuple(got[key].shape) == w.shape
        np.testing.assert_allclose(got[key].float().numpy(), w, err_msg=key,
                                   atol=TOL["bfloat16"] * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("fields,mm", [
    ({"pipeline_stages": 2}, {}),
    ({"activation_fn": "glu"}, {}),
])
def test_unported_settings_raise(fields, mm):
    """``glu`` raises at construction, as the reference cannot run it; a
    pipelined encoder builds, and its forward raises without a pipe group
    of its stages' ranks, as JAX's does without a mesh with a pipe axis."""
    cfg = tconfig.ModelConfig(**BASE, **fields,
                              multimodal=tconfig.MultimodalConfig(**{**MM, **mm}))
    if cfg.pipeline_stages > 1:
        b = _batch()
        model = TModel(cfg).eval()
        with pytest.raises(ValueError, match="needs a pipe group of 2 ranks"), torch.no_grad():
            model(*(_t(b[k]) for k in ("src_features", "src_lengths", "prev_output_tokens")),
                  [_t(x) for x in b["imgs_list"]], [_t(x) for x in b["img_masks_list"]])
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        TModel(cfg)
