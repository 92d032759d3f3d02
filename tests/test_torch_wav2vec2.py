"""The port's wav2vec2/HuBERT encoders against the JAX package's, module
by module, on the same flax parameters (``convert.from_flax``), inputs
made from a numpy seed at a small size (2 layers, widths 32-64).

1. ``FeatureEncoder`` (group and layer norms), ``PositionalConvEmbedding``
   (even and odd kernels), ``Wav2Vec2EncoderLayer`` (post-norm and the
   pre-norm ``do_stable_layer_norm``; its self-attention over the padding
   through JAX's flash path and the port's kernel-A wrapper, whose plain
   version runs on the CPU), ``Wav2Vec2Model`` with ``pad_to_multiple``,
   ``Wav2Vec2ForCTC`` and ``Wav2Vec2WithMultiModal``: fp32 atol 1e-4,
   bf16 atol 5e-2 (``tests/test_torch_model.py``'s tolerances), in bf16
   times max(1, the largest |value|) of the tensor, as
   ``tests/test_torch_config_branches.py`` holds encoder states: bf16's
   spacing is relative (2^-6 at |x| in [2, 4), where LayerNorm outputs of
   32 channels reach), and the two packages round their products at
   different points (XLA before the bias add, PyTorch's addmm after).
2. ``from_flax``/``to_flax`` round trips of each module's tree.
3. ``convert_hf_state_dict`` of an HF-layout state dict built in memory,
   leaf for leaf against JAX's, and ``load_hf_checkpoint`` from a local
   directory (``pytorch_model.bin`` and ``model.safetensors``) against
   the HF model's own output (skipped only without ``transformers``).
4. ``Wav2Vec2Config``: ``from_args``, ``from_hf``, ``feature_lengths`` on
   ints and tensors against JAX's.

Training mode (span masking, LayerDrop, gradient checkpointing) is held
against JAX in ``tests/test_torch_w2v_train.py``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.models import wav2vec2 as J
from mm_s2ut_torch.convert import flatten, from_flax, to_flax
from mm_s2ut_torch.models import wav2vec2 as W

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 1200
TINY = dict(conv_dim=(32, 48), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=32,
            num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, vocab_size=11)
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def configs(stable: bool = False, **kw):
    """(JAX config, port config) of the same geometry; ``stable`` is the
    large layout (layer norms in the conv stack, conv bias, pre-norm)."""
    fields = dict(TINY, do_stable_layer_norm=stable, conv_bias=stable,
                  feat_extract_norm="layer" if stable else "group", **kw)
    return J.Wav2Vec2Config(**fields), W.Wav2Vec2Config(**fields)


def wav_inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    wav = (0.3 * rng.randn(B, S)).astype(np.float32)
    lens = np.array([S, S - 437], np.int32)
    wav[1, lens[1]:] = 0.0
    return wav, lens


def close(got, want, dtype, what=""):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, what
    tol = TOL[dtype] * (max(1.0, np.abs(want).max()) if dtype == "bfloat16" else 1.0)
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, err_msg=what)


def port(tmodule, params, dtype="float32"):
    tmodule.load_state_dict(from_flax(params, tmodule))
    return tmodule.to(DT[dtype][1]).eval()


def np_params(module, *args, **kw):
    return jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(0), *args, **kw))


def round_trip(params, tmodule):
    flat = flatten(params["params"])
    back = to_flax(tmodule)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_allclose(back[key], value, rtol=0, atol=0, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stable", [False, True], ids=["group", "layer"])
def test_feature_encoder(stable, dtype):
    jcfg, tcfg = configs(stable)
    wav, _ = wav_inputs()
    jmod = J.FeatureEncoder(jcfg, dtype=DT[dtype][0])
    params = np_params(jmod, jnp.asarray(wav))
    assert ("group_norm" in params["params"]) == (not stable)
    want = jmod.apply(params, jnp.asarray(wav).astype(DT[dtype][0]))
    tmod = port(W.FeatureEncoder(tcfg), params, dtype)
    with torch.no_grad():
        close(tmod(torch.from_numpy(wav).to(DT[dtype][1])), want, dtype)
    if dtype == "float32":
        round_trip(params, tmod)


@pytest.mark.parametrize("kernel", [16, 15], ids=["even", "odd"])
def test_positional_conv_embedding(kernel):
    jcfg, tcfg = configs(num_conv_pos_embeddings=kernel)
    x = np.random.RandomState(1).randn(B, 37, 32).astype(np.float32)
    jmod = J.PositionalConvEmbedding(jcfg)
    params = np_params(jmod, jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x))
    tmod = port(W.PositionalConvEmbedding(tcfg), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape[1] == 37
    close(got, want, "float32")
    round_trip(params, tmod)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stable", [False, True], ids=["post_norm", "pre_norm"])
def test_encoder_layer(stable, dtype):
    from mm_s2ut_torch.ops.attention import padding_bias

    jcfg, tcfg = configs(stable)
    rng = np.random.RandomState(2)
    T = 41
    x = rng.randn(B, T, 32).astype(np.float32)
    mask = np.zeros((B, T), bool)
    mask[1, 29:] = True
    jmod = J.Wav2Vec2EncoderLayer(jcfg, dtype=DT[dtype][0])
    params = np_params(jmod, jnp.asarray(x), None, True, jnp.asarray(mask))
    want = jmod.apply(params, jnp.asarray(x).astype(DT[dtype][0]), None, True, jnp.asarray(mask))
    tmod = port(W.Wav2Vec2EncoderLayer(tcfg), params, dtype)
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(DT[dtype][1]), padding_bias(tmask, B, T, "cpu"))
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad_to", [1, 8])
@pytest.mark.parametrize("stable", [False, True], ids=["base", "large"])
def test_wav2vec2_model(stable, pad_to, dtype):
    jcfg, tcfg = configs(stable, pad_to_multiple=pad_to)
    wav, lens = wav_inputs(3)
    jmod = J.Wav2Vec2Model(jcfg, dtype=DT[dtype][0])
    params = np_params(jmod, jnp.asarray(wav), jnp.asarray(lens))
    want = jmod.apply(params, jnp.asarray(wav), jnp.asarray(lens))
    tmod = port(W.Wav2Vec2Model(tcfg), params, dtype)
    with torch.no_grad():
        got = tmod(torch.from_numpy(wav), torch.from_numpy(lens))
    T = (S - 10) // 5 + 1
    T = (T - 3) // 2 + 1
    assert got["last_hidden_state"].shape[1] == T + (-T) % pad_to
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(want["padding_mask"]))
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == 3
    for i, (g, w) in enumerate(zip(got["hidden_states"] + [got["last_hidden_state"]],
                                   want["hidden_states"] + [want["last_hidden_state"]])):
        close(g, w, dtype, f"state {i}")
    if dtype == "float32" and pad_to == 1:
        round_trip(params, tmod)


def test_wav2vec2_model_without_lengths():
    jcfg, tcfg = configs()
    wav, _ = wav_inputs(4)
    jmod = J.Wav2Vec2Model(jcfg)
    params = np_params(jmod, jnp.asarray(wav))
    want = jmod.apply(params, jnp.asarray(wav))
    tmod = port(W.Wav2Vec2Model(tcfg), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(wav))
    close(got["last_hidden_state"], want["last_hidden_state"], "float32")
    assert not got["padding_mask"].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wav2vec2_for_ctc(dtype):
    jcfg, tcfg = configs()
    wav, lens = wav_inputs(5)
    jmod = J.Wav2Vec2ForCTC(jcfg, dtype=DT[dtype][0])
    params = np_params(jmod, jnp.asarray(wav), jnp.asarray(lens))
    want = jmod.apply(params, jnp.asarray(wav), jnp.asarray(lens))
    tmod = port(W.Wav2Vec2ForCTC(tcfg), params, dtype)
    with torch.no_grad():
        got = tmod(torch.from_numpy(wav), torch.from_numpy(lens))
    assert got["logits"].dtype == torch.float32 and got["logits"].shape[-1] == 11
    close(got["logits"], want["logits"], dtype)
    if dtype == "float32":
        round_trip(params, tmod)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_fused", [1, 2])
def test_wav2vec2_with_multimodal(n_fused, dtype):
    jcfg, tcfg = configs()
    wav, lens = wav_inputs(6)
    rng = np.random.RandomState(6)
    img = rng.randn(B, 5, 24).astype(np.float32)
    img_mask = np.zeros((B, 5), bool)
    img_mask[0, 3:] = True
    jmod = J.Wav2Vec2WithMultiModal(jcfg, m2_dim=24, num_cross_attention_layers=n_fused,
                                    dtype=DT[dtype][0])
    args = (jnp.asarray(wav), jnp.asarray(lens), jnp.asarray(img), jnp.asarray(img_mask))
    params = np_params(jmod, *args)
    want = jmod.apply(params, *args)
    tmod = port(W.Wav2Vec2WithMultiModal(tcfg, m2_dim=24, num_cross_attention_layers=n_fused),
                params, dtype)
    with torch.no_grad():
        got = tmod(torch.from_numpy(wav), torch.from_numpy(lens), torch.from_numpy(img),
                   torch.from_numpy(img_mask))
    close(got["last_hidden_state"], want["last_hidden_state"], dtype)
    assert len(got["hidden_states"]) == len(want["hidden_states"])
    if dtype == "float32":
        round_trip(params, tmod)


def test_config_from_args_hf_and_feature_lengths():
    args = {"conv_dim": [32, 32], "conv_stride": [8, 5], "conv_kernel": [10, 4],
            "hidden_size": 64, "num_hidden_layers": 2}
    assert dataclasses.asdict(W.Wav2Vec2Config.from_args(args)) == \
        dataclasses.asdict(J.Wav2Vec2Config.from_args(args))
    assert W.Wav2Vec2Config.from_args(None) == W.Wav2Vec2Config()
    assert dataclasses.asdict(W.Wav2Vec2Config()) == dataclasses.asdict(J.Wav2Vec2Config())
    hf = {"conv_dim": [16, 16], "conv_stride": [5, 2], "conv_kernel": [10, 3],
          "conv_bias": True, "feat_extract_norm": "layer", "hidden_size": 24,
          "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 48,
          "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
          "do_stable_layer_norm": True, "layer_norm_eps": 1e-5, "vocab_size": 7,
          "architectures": ["Wav2Vec2ForCTC"]}
    want = J.Wav2Vec2Config.from_hf(type("HF", (), {k: v for k, v in hf.items()}))
    assert dataclasses.asdict(W.Wav2Vec2Config.from_hf(hf)) == dataclasses.asdict(want)
    lens = [400, 800, 16000, 160000]
    cfg = W.Wav2Vec2Config()
    jl = np.asarray(J.Wav2Vec2Config().feature_lengths(jnp.asarray(lens)))
    assert [cfg.feature_lengths(n) for n in lens] == jl.tolist()
    assert cfg.feature_lengths(torch.tensor(lens)).tolist() == jl.tolist()
    assert cfg.feature_lengths(160000) == 499  # 10 s


def _hf_model(stable: bool, ctc: bool):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.Wav2Vec2Config(
        conv_dim=list(TINY["conv_dim"]), conv_stride=list(TINY["conv_stride"]),
        conv_kernel=list(TINY["conv_kernel"]), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, do_stable_layer_norm=stable, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0, vocab_size=11,
        feat_extract_norm="layer" if stable else "group", conv_bias=stable)
    cls = transformers.Wav2Vec2ForCTC if ctc else transformers.Wav2Vec2Model
    return cls(hf_cfg).eval()


@pytest.mark.parametrize("stable", [False, True], ids=["base", "large"])
def test_convert_hf_state_dict_matches_jax(stable):
    hf = _hf_model(stable, ctc=True)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jcfg, tcfg = configs(stable)
    want = flatten(J.convert_hf_state_dict(sd, jcfg))
    got = flatten(W.convert_hf_state_dict(sd, tcfg))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("stable", [False, True], ids=["base", "large"])
def test_load_hf_checkpoint_dir(stable, fmt, tmp_path):
    hf = _hf_model(stable, ctc=True)
    (tmp_path / "config.json").write_text(json.dumps(hf.config.to_dict()))
    sd = {k: v.detach().contiguous() for k, v in hf.state_dict().items()}
    if fmt == "bin":
        torch.save(sd, tmp_path / "pytorch_model.bin")
    else:
        from safetensors.numpy import save_file

        save_file({k: v.numpy() for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    cfg, variables = W.load_hf_checkpoint(tmp_path)
    assert cfg.do_stable_layer_norm == stable and cfg.vocab_size == 11
    model = port(W.Wav2Vec2ForCTC(cfg), variables)
    wav = torch.from_numpy(0.1 * np.random.RandomState(7).randn(B, 800).astype(np.float32))
    with torch.no_grad():
        want = hf(wav).logits
        got = model(wav)["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=1e-3)


def test_safetensors_reader_widens_bf16(tmp_path):
    from safetensors.torch import save_file

    x = torch.randn(3, 5).to(torch.bfloat16)
    save_file({"x": x, "i": torch.arange(4)}, str(tmp_path / "t.safetensors"))
    got = W.read_safetensors(tmp_path / "t.safetensors")
    np.testing.assert_array_equal(got["x"], x.float().numpy())
    np.testing.assert_array_equal(got["i"], np.arange(4))


