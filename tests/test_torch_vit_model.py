"""The port's MMS2UTModel with the on-line visual extractor against the
JAX package's, on the same flax parameters: a first image source of
(B, S, S, 3) pixels runs the timm ViT (``vit_timm``, kernel A's path;
``vit_huggingface`` builds the same graph) or the CLIP tower
(``vit_openai``), whose features replace it. Encoder output and the
teacher-forced logits within fp32 1e-4, and UnitGenerator's tokens equal
to JAX's (scores within 1e-4) for the float, int8 and int4 caches. The
extractor refuses training mode (ROADMAP.md §1 item 4)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mm_s2ut.config import GenerationConfig as JGenerationConfig
from mm_s2ut.config import ModelConfig, MultimodalConfig
from mm_s2ut.infer.generator import UnitGenerator as JGenerator
from mm_s2ut.models import build_model_from_config as j_build
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
from mm_s2ut.models.vit import CLIPVisionConfig as JCLIPConfig
from mm_s2ut.models.vit import ViTConfig as JViTConfig
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.infer.generator import UnitGenerator
from mm_s2ut_torch.models import build_model_from_config
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TModel
from mm_s2ut_torch.models.vit import CLIPVisionConfig, ViTConfig

torch.set_num_threads(1)
B, T, S, V = 2, 48, 32, 60
VIT_ARGS = {"embed_dim": 32, "depth": 2, "num_heads": 2, "patch_size": 16}


def _cfg(kind: str) -> ModelConfig:
    return ModelConfig(
        encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
        decoder_layers=2, decoder_attention_heads=2, conv_channels=16, vocab_size=V,
        dtype="float32",
        multimodal=MultimodalConfig(
            image_feat_dim=[32], multimodal_attention_type="selective_attention",
            load_visual_extractor_type=kind, image_input_size=S,
            visual_extractor_args=dict(VIT_ARGS)))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 80).astype(np.float32), np.array([T, T - 11], np.int32),
            rng.randn(B, S, S, 3).astype(np.float32))


@pytest.fixture(scope="module", params=["vit_timm", "vit_openai"])
def pair(request):
    kind = request.param
    jcfg = _cfg(kind)
    vit = (JCLIPConfig if kind == "vit_openai" else JViTConfig)(image_size=S, **VIT_ARGS)
    jmodel = JModel(jcfg, vit_cfg=vit)
    feats, lens, px = _inputs()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), feats, lens, np.zeros((B, 3), np.int32), (px,),
        (np.zeros((B, S), bool),)))
    norm = params["params"]["decoder"]["final_norm"]
    norm["scale"] = norm["scale"] * 8.0  # sharper logits: argmaxes off near-ties
    tcfg = tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(jcfg))
    tvit = (CLIPVisionConfig if kind == "vit_openai" else ViTConfig)(image_size=S, **VIT_ARGS)
    tmodel = TModel(tcfg, vit_cfg=tvit)
    tmodel.load_state_dict(from_flax(params, tmodel))
    return kind, jmodel, params, tmodel.eval()


def test_build_model_from_config_builds_the_extractor():
    """The JAX builder's vit_cfg: CLIP for vit_openai, else timm's graph,
    image_size from image_input_size unless visual_extractor_args sets it."""
    from mm_s2ut.config import Config as JConfig

    for kind, cls in (("vit_timm", ViTConfig), ("vit_huggingface", ViTConfig),
                      ("vit_openai", CLIPVisionConfig)):
        jconf = JConfig(model=_cfg(kind))
        tconf = tconfig.from_dict(tconfig.Config, dataclasses.asdict(jconf))
        got = build_model_from_config(tconf)
        want = j_build(jconf)
        assert isinstance(got.vit_cfg, cls) and got.vit_cfg.image_size == S
        assert dataclasses.asdict(got.vit_cfg) == dataclasses.asdict(want.vit_cfg)


def test_encode_and_logits_match_jax(pair):
    kind, jmodel, params, tmodel = pair
    feats, lens, px = _inputs(2)
    prev = np.random.RandomState(3).randint(4, V, (B, 5)).astype(np.int32)
    masks = (np.zeros((B, S), bool),)
    want = jmodel.apply(params, feats, lens, prev, (px,), masks, deterministic=True)
    wenc = jmodel.apply(params, feats, lens, (px,), masks, None, deterministic=True,
                        method=jmodel.encode)
    t = torch.from_numpy
    with torch.no_grad():
        got = tmodel(t(feats), t(lens).long(), t(prev).long(), [t(px)], [t(masks[0])])
        genc = tmodel.encode(t(feats), t(lens).long(), [t(px)], [t(masks[0])])
    np.testing.assert_allclose(genc["encoder_out"].numpy(), np.asarray(wenc["encoder_out"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-4)


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_generate_matches_jax(pair, kv):
    kind, jmodel, params, tmodel = pair
    feats, lens, px = _inputs(4)
    gen = dict(beam=3, max_len_a=0.0, max_len_b=10, kv_cache_dtype=kv)
    masks = (np.zeros((B, S), bool),)
    want = JGenerator(jmodel, params, JGenerationConfig(**gen)).generate(feats, lens, (px,),
                                                                         masks)
    got = UnitGenerator(tmodel, tconfig.GenerationConfig(**gen)).generate(feats, lens, (px,),
                                                                          masks)
    for g, w in zip(got, want):
        assert [h["tokens"] for h in g] == [h["tokens"] for h in w]
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w], atol=1e-4)


def test_training_through_the_extractor_raises(pair):
    _, _, _, tmodel = pair
    feats, lens, px = _inputs()
    t = torch.from_numpy
    with pytest.raises(NotImplementedError, match="§1 item 4"):
        tmodel.train().encode(t(feats), t(lens).long(), [t(px)], [t(np.zeros((B, S), bool))])
    tmodel.eval()
