"""The port's image encoders against the JAX package's (``models/vit.py``,
``models/resnet_encoder.py``), on the same flax parameters carried across
by ``convert.from_flax``, at small sizes (embed 32-64, depth 2, images of
32-48 pixels, patch 16).

JAX's ViT runs with ``use_flash=True``, which on the CPU takes
``attention()``'s reference path: the keys padded to a multiple of 8
under a key-padding mask, as the port's kernel A path pads them; the
port's wrapper takes A's plain version here (a CPU tensor). fp32 is held
to 1e-4, bf16 to 5e-2 × max(1, largest |JAX value|). The converters'
dicts equal JAX's exactly, and the loaders read ``.bin`` and
``.safetensors`` files written here from seeded random weights."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.models import resnet_encoder as JR
from mm_s2ut.models import vit as JV
from mm_s2ut_torch.convert import flatten, from_flax, to_flax
from mm_s2ut_torch.models import resnet_encoder as TR
from mm_s2ut_torch.models import vit as TV

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL[dtype] * max(1.0, float(np.abs(want).max())))


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _pixels(n, size, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _vit_pair(jcfg, dtype, seed=0):
    jmodel = JV.VisionTransformer(jcfg, dtype=JDT[dtype], use_flash=True)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(seed), _pixels(1, jcfg.image_size)))
    tmodel = TV.VisionTransformer(_tcfg(TV.ViTConfig, jcfg))
    tmodel.load_state_dict(from_flax(params, tmodel))
    return jmodel, params, tmodel.to(TDT[dtype]).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("image_size,return_attn", [(48, False), (48, True), (32, False)])
def test_vision_transformer_matches_jax(dtype, image_size, return_attn):
    """48² → 10 tokens, 32² → 5: keys padded by 6 and 3 on the fused path;
    with ``return_attn`` the plain path and its weights."""
    jcfg = JV.ViTConfig(image_size=image_size, patch_size=16, embed_dim=64, depth=2, num_heads=4)
    jmodel, params, tmodel = _vit_pair(jcfg, dtype)
    x = _pixels(2, image_size, seed=1)
    want, wattn = jmodel.apply(params, jnp.asarray(x), return_attn=return_attn)
    with torch.no_grad():
        got, gattn = tmodel(torch.from_numpy(x), return_attn=return_attn)
    _close(got, want, dtype)
    assert got.dtype == TDT[dtype]
    if return_attn:
        assert len(gattn) == len(wattn) == 2 and gattn[0].shape == (2, 4, jcfg.seq_len,
                                                                    jcfg.seq_len)
        for g, w in zip(gattn, wattn):
            _close(g, w, dtype)
    else:
        assert gattn is None and wattn is None


@pytest.mark.parametrize("use_flash", [True, False])
def test_vit_block_without_key_padding_matches_jax(use_flash):
    """T = 16 tokens (T % 8 = 0): the fused path pads nothing. JAX's
    ``use_flash=False`` block is the plain path, which the port's block
    takes with ``return_attn``."""
    jcfg = JV.ViTConfig(embed_dim=64, depth=1, num_heads=4)
    jblock = JV.ViTBlock(jcfg, use_flash=use_flash)
    x = np.random.RandomState(2).randn(2, 16, 64).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jblock.init(jax.random.PRNGKey(3), x))
    want, wattn = jblock.apply(params, jnp.asarray(x), return_attn=not use_flash)
    tblock = TV.ViTBlock(_tcfg(TV.ViTConfig, jcfg))
    tblock.load_state_dict(from_flax(params, tblock))
    bias = torch.zeros(2, 16)
    with torch.no_grad():
        got, attn = tblock(torch.from_numpy(x), bias, return_attn=not use_flash)
    _close(got, want, "float32")
    if use_flash:
        assert attn is None and wattn is None
    else:
        assert attn.shape == (2, 4, 16, 16)
        _close(attn, wattn, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_tower_matches_jax(dtype):
    jcfg = JV.CLIPVisionConfig(image_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
                               mlp_ratio=2.0)
    jmodel = JV.CLIPVisionTransformer(jcfg, dtype=JDT[dtype])
    x = _pixels(2, 32, seed=4)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(5), x))
    tmodel = TV.CLIPVisionTransformer(_tcfg(TV.CLIPVisionConfig, jcfg))
    tmodel.load_state_dict(from_flax(params, tmodel))
    tmodel = tmodel.to(TDT[dtype]).eval()
    want = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("head_fusion", ["mean", "max", "min"])
def test_attention_rollout_matches_jax(head_fusion):
    rng = np.random.RandomState(6)
    attns = [rng.dirichlet(np.ones(10), size=(2, 3, 10)).astype(np.float32) for _ in range(3)]
    want = JV.attention_rollout([a.copy() for a in attns], 0.5, head_fusion)
    got = TV.attention_rollout([a.copy() for a in attns], 0.5, head_fusion)
    assert got.shape == (2, 9)
    np.testing.assert_array_equal(got, want)


def _timm_state_dict(cfg, seed=0, wrap=False):
    g = torch.Generator().manual_seed(seed)
    D, M = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    sd = {"cls_token": t(1, 1, D), "pos_embed": t(1, cfg.seq_len, D),
          "patch_embed.proj.weight": t(D, 3, cfg.patch_size, cfg.patch_size),
          "patch_embed.proj.bias": t(D), "norm.weight": 1 + t(D), "norm.bias": t(D)}
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        sd.update({f"{b}.norm1.weight": 1 + t(D), f"{b}.norm1.bias": t(D),
                   f"{b}.attn.qkv.weight": t(3 * D, D), f"{b}.attn.qkv.bias": t(3 * D),
                   f"{b}.attn.proj.weight": t(D, D), f"{b}.attn.proj.bias": t(D),
                   f"{b}.norm2.weight": 1 + t(D), f"{b}.norm2.bias": t(D),
                   f"{b}.mlp.fc1.weight": t(M, D), f"{b}.mlp.fc1.bias": t(M),
                   f"{b}.mlp.fc2.weight": t(D, M), f"{b}.mlp.fc2.bias": t(D)})
    return {"model": sd} if wrap else sd


def _clip_state_dict(cfg, seed=0, prefix="vision_model."):
    g = torch.Generator().manual_seed(seed)
    D, M = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    sd = {"embeddings.class_embedding": t(D),
          "embeddings.position_embedding.weight": t(cfg.seq_len, D),
          "embeddings.patch_embedding.weight": t(D, 3, cfg.patch_size, cfg.patch_size),
          "pre_layrnorm.weight": 1 + t(D), "pre_layrnorm.bias": t(D),
          "post_layernorm.weight": 1 + t(D), "post_layernorm.bias": t(D)}
    for i in range(cfg.depth):
        b = f"encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            sd.update({f"{b}.{ln}.weight": 1 + t(D), f"{b}.{ln}.bias": t(D)})
        sd.update({f"{b}.mlp.fc1.weight": t(M, D), f"{b}.mlp.fc1.bias": t(M),
                   f"{b}.mlp.fc2.weight": t(D, M), f"{b}.mlp.fc2.bias": t(D)})
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.update({f"{b}.self_attn.{proj}.weight": t(D, D), f"{b}.self_attn.{proj}.bias": t(D)})
    return {prefix + k: v for k, v in sd.items()}


def _flat_equal(got, want):
    got, want = flatten(got), flatten(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_converters_give_jax_dicts():
    vcfg = TV.ViTConfig(image_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2)
    sd = {k: v.numpy() for k, v in _timm_state_dict(vcfg).items()}
    _flat_equal(TV.convert_timm_state_dict(sd, vcfg),
                JV.convert_timm_state_dict(sd, _tcfg(JV.ViTConfig, vcfg)))
    ccfg = TV.CLIPVisionConfig(image_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2)
    for prefix in ("vision_model.", ""):
        sd = {k: v.numpy() for k, v in _clip_state_dict(ccfg, prefix=prefix).items()}
        _flat_equal(TV.convert_clip_state_dict(sd, ccfg),
                    JV.convert_clip_state_dict(sd, _tcfg(JV.CLIPVisionConfig, ccfg)))


@pytest.mark.parametrize("wrap", [False, True])
def test_timm_loader_reads_a_bin(tmp_path, wrap):
    """``torch.save`` of a timm state dict (bare or as ``{"model": …}``)
    → the JAX loader's tree; the ViT loads it and matches timm's graph as
    JAX runs it."""
    vcfg = TV.ViTConfig(image_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2)
    torch.save(_timm_state_dict(vcfg, seed=1, wrap=wrap), tmp_path / "vit.bin")
    got = TV.load_timm_checkpoint(str(tmp_path / "vit.bin"), vcfg)
    want = JV.load_timm_checkpoint(str(tmp_path / "vit.bin"), _tcfg(JV.ViTConfig, vcfg))
    _flat_equal(got, want)
    vit = TV.VisionTransformer(vcfg)
    vit.load_state_dict(from_flax(got, vit))
    x = _pixels(2, 32, seed=7)
    with torch.no_grad():
        feats, _ = vit.eval()(torch.from_numpy(x))
    wfeats, _ = JV.VisionTransformer(_tcfg(JV.ViTConfig, vcfg)).apply(want, jnp.asarray(x))
    _close(feats, wfeats, "float32")


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_clip_loader_reads_an_hf_dir(tmp_path, fmt):
    ccfg = TV.CLIPVisionConfig(image_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                               mlp_ratio=2.0)
    sd = _clip_state_dict(ccfg, seed=2)
    (tmp_path / "config.json").write_text(json.dumps({"vision_config": {
        "image_size": 32, "patch_size": 16, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64, "layer_norm_eps": 1e-5}}))
    if fmt == "bin":
        torch.save(sd, tmp_path / "pytorch_model.bin")
    else:
        from safetensors.torch import save_file

        save_file(sd, str(tmp_path / "model.safetensors"))
    cfg, got = TV.load_clip_checkpoint(str(tmp_path))
    jcfg, want = JV.load_clip_checkpoint(str(tmp_path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg.seq_len == 5
    _flat_equal(got, want)
    tower = TV.CLIPVisionTransformer(cfg)
    tower.load_state_dict(from_flax(got, tower))
    assert set(to_flax(tower)) == set(flatten(want["params"]))


def test_resnet_encoder_matches_jax_in_eval_mode():
    """SubModel over a (1, 2, 32, 32, 1) clip with one transformer layer:
    BatchNorm on its running statistics (made non-trivial), the frame
    features and the projection against JAX's."""
    jmodel = JR.SubModel(out_dim=32, num_layers=1, num_heads=2)
    rng = np.random.RandomState(8)
    video = rng.randn(1, 2, 32, 32, 1).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray,
                                       jmodel.init(jax.random.PRNGKey(9), video=video))
    variables = jax.tree_util.tree_map(lambda a: a.copy(), variables)
    for path, leaf in flatten(variables["batch_stats"]).items():
        bump = rng.rand(*leaf.shape).astype(np.float32)
        leaf += 0.1 * bump if path.endswith("mean") else 0.5 + bump - leaf
    stats = flatten(variables["batch_stats"])
    from mm_s2ut_torch.convert import unflatten

    variables = {"params": variables["params"],
                 "batch_stats": unflatten({k: v for k, v in stats.items()})}
    want = jmodel.apply(variables, video=video)
    tmodel = TR.SubModel(out_dim=32, num_layers=1, num_heads=2)
    tmodel.load_state_dict(TR.from_flax_variables(variables, tmodel))
    with torch.no_grad():
        got = tmodel.eval()(video=torch.from_numpy(video))
    _close(got, want, "float32")
    # Train mode now runs on the batch's statistics (held against flax's
    # in test_torch_resnet_train.py).
    with torch.no_grad():
        frames = tmodel.resnet.train()(torch.from_numpy(video))
    assert frames.shape == (1, 2, 512) and torch.isfinite(frames).all()
