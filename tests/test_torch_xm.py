"""The enhanced path of the port against the JAX package's, on the same
flax parameters (``convert.from_flax``), inputs made from a numpy seed at
a small size (2 wav2vec2 layers, widths 32-64).

1. ``Conv1dAdaptor``'s values and lengths; ``MMXMTransformerModel``'s
   encoder output, logits and CTC/multitask logits; its decode steps over
   a bf16/fp32, int8 and int4 cache on a reordered beam state; fp32 atol
   1e-4, bf16 atol 5e-2 (times the largest |value| of an unnormed
   tensor, as ``tests/test_torch_wav2vec2.py`` holds bf16).
2. ``MMS2UTModel``'s ``hubert``, ``wav2vec2`` and ``wav2vec2_multimodal``
   branches: encoder output and logits, the parameter tree (no
   conv-transformer on these branches) and ``init_parameters_``'s.
3. ``UnitGenerator`` on a tiny XM model and on the ``hubert`` branch with
   each cache: the same tokens, fp32 scores atol 1e-4; the generation
   budgets through ``source_downsample_ratio``.
4. The S2T dataset's items and collate (SentencePiece targets, the
   ``<lang:xx>`` framing), ``ResampledConcat``, the S2T task's batches and
   the raw-waveform S2S task's, against JAX's.
5. ``python -m mm_s2ut_torch.cli.generate`` against JAX's
   ``mm_s2ut.cli.generate`` on the same exported checkpoint: the same
   T-/H-/D- lines (scores atol 1e-4).
6. A raw-waveform ``ContinuousServer`` (``enc_feat_dim=None``) on the XM
   model, per utterance against JAX's offline search, over a ring that
   wraps, for the float and int8 caches; against JAX's server at
   max_len_a 0, and its budgets against JAX's server's at max_len_a > 0
   (a decided difference).
7. The settings that still raise."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import ModelConfig as JModelCfg
from mm_s2ut.config import MultimodalConfig as JMMCfg
from mm_s2ut.config import MultitaskTaskConfig as JTaskCfg
from mm_s2ut.infer.beam_search import _reorder_ancestry as j_reorder
from mm_s2ut.infer.beam_search import beam_search as j_beam_search
from mm_s2ut.infer.beam_search import tile_state_for_beams as j_tile
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JS2UT
from mm_s2ut.models.mm_xm import Conv1dAdaptor as JAdaptor
from mm_s2ut.models.mm_xm import MMXMTransformerModel as JXM
from mm_s2ut.models.wav2vec2 import Wav2Vec2Config as JW2V
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import flatten, from_flax, to_flax
from mm_s2ut_torch.infer.beam_search import _reorder_ancestry as t_reorder
from mm_s2ut_torch.infer.beam_search import tile_state_for_beams as t_tile
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TS2UT
from mm_s2ut_torch.models.mm_s2ut import init_parameters_
from mm_s2ut_torch.models.mm_xm import Conv1dAdaptor as TAdaptor
from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel as TXM
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config as TW2V

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, TT, TI, V = 2, 2400, 5, 6, 40
W2V = dict(conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=48,
           num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
           hidden_dropout=0.0, attention_dropout=0.0)
DEC = dict(decoder_embed_dim=32, decoder_ffn_embed_dim=64, decoder_layers=2,
           decoder_attention_heads=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
           encoder_layers=2, encoder_attention_heads=2, conv_channels=16, vocab_size=V,
           dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
MM = dict(image_feat_dim=[16], multimodal_attention_type="selective_attention",
          modality_dropout=0.0, SA_image_dropout=0.0, SA_attention_dropout=0.0)
HEADS = dict(ctc_weight=0.3, multitask=[
    JTaskCfg(task_name="asr", decoder_type="ctc", vocab_size=30),
    JTaskCfg(task_name="st", decoder_type="transformer", decoder_layers=1,
             decoder_embed_dim=16, decoder_attention_heads=2)])
KINDS = {  # model kind → (JAX model class, port model class, ModelConfig fields)
    "xm": (JXM, TXM, {}),
    "hubert": (JS2UT, TS2UT, {"speech_encoder_type": "hubert"}),
    "wav2vec2": (JS2UT, TS2UT, {"speech_encoder_type": "wav2vec2"}),
    "wav2vec2_multimodal": (JS2UT, TS2UT, {"speech_encoder_type": "wav2vec2_multimodal"}),
}


def jcfg(kind: str, dtype: str = "float32", **kw) -> JModelCfg:
    return JModelCfg(**DEC, **KINDS[kind][2], **kw, dtype=dtype, multimodal=JMMCfg(**MM))


def tcfg(cfg: JModelCfg):
    out = tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(cfg))
    out.multitask = [tconfig.MultitaskTaskConfig(**t) for t in out.multitask]
    return out


def batch(seed: int = 1):
    rng = np.random.RandomState(seed)
    lens = np.array([S, S - 730], np.int32)
    wav = (0.3 * rng.randn(B, S)).astype(np.float32)
    wav[1, lens[1]:] = 0.0
    masks = np.zeros((B, TI), bool)
    masks[1, TI - 2:] = True
    return {"wav": wav, "lens": lens,
            "prev": rng.randint(0, V, (B, TT)).astype(np.int32),
            "imgs": (rng.randn(B, TI, 16).astype(np.float32),), "masks": (masks,),
            "mt_prev": {"st": rng.randint(0, V, (B, 3)).astype(np.int32)}}


def j_model(kind: str, cfg: JModelCfg):
    return KINDS[kind][0](cfg, w2v_cfg=JW2V(**W2V))


@functools.lru_cache(maxsize=None)
def params_of(kind: str, heads: bool = False, scale: float = 1.0):
    """The JAX model's parameters (numpy), its decoder's final LayerNorm
    scaled by ``scale`` (sharper logits for the decode tests)."""
    cfg = jcfg(kind, **(HEADS if heads else {}))
    b = batch()
    kw = {"multitask_prev_tokens": b["mt_prev"]} if heads else {}
    p = jax.tree_util.tree_map(np.asarray, j_model(kind, cfg).init(
        jax.random.PRNGKey(3), b["wav"], b["lens"], b["prev"], b["imgs"], b["masks"], **kw))
    norm = p["params"]["decoder"]["final_norm"]
    norm["scale"], norm["bias"] = norm["scale"] * scale, norm["bias"] * scale
    return p


def t_model(kind: str, cfg: JModelCfg, params):
    model = KINDS[kind][1](tcfg(cfg), w2v_cfg=TW2V(**W2V))
    model.load_state_dict(from_flax(params, model))
    return model.eval()


def t_args(b):
    return (torch.from_numpy(b["wav"]), torch.from_numpy(b["lens"]).long(),
            [torch.from_numpy(x) for x in b["imgs"]], [torch.from_numpy(x) for x in b["masks"]])


def close(got, want, dtype, scaled=False, what=""):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, what
    tol = TOL[dtype] * (max(1.0, np.abs(want).max()) if scaled and dtype == "bfloat16" else 1.0)
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# 1. the adaptor and the XM model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layernorm,proj", [(True, False), (False, True)])
def test_adaptor_values_and_lengths(layernorm, proj, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    rng = np.random.RandomState(4)
    x = rng.randn(B, 63, 24).astype(np.float32)
    lens = np.array([63, 17], np.int32)
    jmod = JAdaptor(out_dim=16, n_layers=3, layernorm=layernorm, proj=proj, dtype=jdt)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), x, lens))
    want, want_lens = jmod.apply(params, jnp.asarray(x).astype(jdt), lens)
    tmod = TAdaptor(24, 16, n_layers=3, layernorm=layernorm, proj=proj)
    tmod.load_state_dict(from_flax(params, tmod))
    tmod = tmod.to(tdt)
    with torch.no_grad():
        got, got_lens = tmod(torch.from_numpy(x).to(tdt), torch.from_numpy(lens).long())
    assert got_lens.tolist() == np.asarray(want_lens).tolist() == [8, 3]
    close(got, want, dtype)
    assert set(to_flax(tmod)) == set(flatten(params["params"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xm_forward_matches_jax(dtype):
    """Logits, the encoder's output and mask, CTC and multitask logits (a
    CTC task and a decoder task whose width needs ``mt_st_proj``)."""
    cfg = jcfg("xm", dtype, **HEADS)
    jmodel, params = j_model("xm", cfg), params_of("xm", heads=True)
    tmodel = t_model("xm", cfg, params)
    b = batch(2)
    want = jmodel.apply(params, b["wav"], b["lens"], b["prev"], b["imgs"], b["masks"],
                        multitask_prev_tokens=b["mt_prev"])
    with torch.no_grad():
        got = tmodel(*t_args(b)[:2], torch.from_numpy(b["prev"]).long(), *t_args(b)[2:],
                     multitask_prev_tokens={"st": torch.from_numpy(b["mt_prev"]["st"]).long()})
    np.testing.assert_array_equal(got["encoder_padding_mask"].numpy(),
                                  np.asarray(want["encoder_padding_mask"]))
    assert got["encoder_out"].shape[1] == 30  # 2400 samples → 239 frames → 120 → 60 → 30
    close(got["encoder_out"], want["encoder_out"], dtype, scaled=True)
    close(got["logits"], want["logits"], dtype)
    close(got["ctc_logits"], want["ctc_logits"], dtype)
    assert set(got["multitask_logits"]) == {"asr", "st"}
    for name in ("asr", "st"):
        close(got["multitask_logits"][name], want["multitask_logits"][name], dtype, what=name)


def test_xm_parameters_round_trip():
    params = params_of("xm", heads=True)
    flat = flatten(params["params"])
    assert {"pre_adaptor_proj/kernel", "ctc_head/ctc_proj/kernel", "mt_asr/ctc_proj/kernel",
            "mt_st_proj/kernel", "fusion0/gated_fusion/gate/kernel"} <= set(flat)
    back = to_flax(t_model("xm", jcfg("xm", **HEADS), params))
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_xm_decode_steps_match_jax(kv):
    cfg = jcfg("xm")
    jmodel, params = j_model("xm", cfg), params_of("xm")
    tmodel = t_model("xm", cfg, params)
    b, K, max_len = batch(3), 3, 6
    rng = np.random.RandomState(5)
    enc = jmodel.apply(params, b["wav"], b["lens"], b["imgs"], b["masks"], method=jmodel.encode)
    jst = j_tile(jmodel.apply(params, enc, max_len, method=jmodel.decode_init, kv_dtype=kv), K)
    with torch.no_grad():
        tst = t_tile(tmodel.decode_init(tmodel.encode(*t_args(b)), max_len, kv_dtype=kv), K)
        for step in range(4):
            tokens = rng.randint(4, V, (B * K, 1)).astype(np.int32)
            want, jst = jmodel.apply(params, jnp.asarray(tokens), jst, method=jmodel.decode_step)
            got, tst = tmodel.decode_step(torch.from_numpy(tokens).long(), tst)
            close(got, want, "float32", what=f"step {step}")
            src_beam = rng.randint(0, K, (B, K))
            jst = j_reorder(jst, jnp.asarray(src_beam, jnp.int32), step)
            t_reorder(tst, torch.from_numpy(src_beam).long(), step)


# ---------------------------------------------------------------------------
# 2. the flagship's wav2vec2 branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["hubert", "wav2vec2", "wav2vec2_multimodal"])
def test_mms2ut_wav2vec2_branch_matches_jax(kind, dtype):
    cfg = jcfg(kind, dtype)
    jmodel, params = j_model(kind, cfg), params_of(kind)
    flat = flatten(params["params"])
    assert not any(k.startswith("encoder/") for k in flat)  # no conv-transformer
    assert "speech_proj/kernel" in flat  # 48 → 32
    assert any(k.startswith("fusion0/") for k in flat) == (kind != "wav2vec2_multimodal")
    tmodel = t_model(kind, cfg, params)
    b = batch(4)
    want = jmodel.apply(params, b["wav"], b["lens"], b["prev"], b["imgs"], b["masks"])
    want_enc = jmodel.apply(params, b["wav"], b["lens"], b["imgs"], b["masks"],
                            method=jmodel.encode)
    with torch.no_grad():
        got = tmodel(*t_args(b)[:2], torch.from_numpy(b["prev"]).long(), *t_args(b)[2:])
        got_enc = tmodel.encode(*t_args(b))
    np.testing.assert_array_equal(got_enc["encoder_padding_mask"].numpy(),
                                  np.asarray(want_enc["encoder_padding_mask"]))
    close(got_enc["encoder_out"], want_enc["encoder_out"], dtype, scaled=True)
    close(got["logits"], want["logits"], dtype)
    assert len(got_enc["encoder_states"]) == len(want_enc["encoder_states"]) == 3
    if dtype == "float32":
        back = to_flax(tmodel)
        assert set(back) == set(flat)
        for key, value in flat.items():
            np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("kind", list(KINDS))
def test_init_parameters_give_the_jax_tree(kind):
    """``init_parameters_`` fills every parameter of the port's model, and
    the tree it gives is JAX's init tree, shape for shape."""
    cfg = jcfg(kind)
    model = KINDS[kind][1](tcfg(cfg), w2v_cfg=TW2V(**W2V))
    init_parameters_(model, torch.Generator().manual_seed(0))
    got = to_flax(model)
    want = flatten(params_of(kind)["params"])
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    spec = got["wav2vec2/masked_spec_embed" if kind == "xm" else
               "speech_encoder/masked_spec_embed" if kind != "wav2vec2_multimodal" else
               "speech_encoder/wav2vec2/masked_spec_embed"]
    assert 0.0 <= spec.min() and spec.max() < 1.0 and spec.std() > 0.1


# ---------------------------------------------------------------------------
# 3. generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("kind", ["xm", "hubert"])
def test_unit_generator_matches_jax(kind, kv):
    from mm_s2ut.config import GenerationConfig as JGen
    from mm_s2ut.infer.generator import UnitGenerator as JGenerator
    from mm_s2ut_torch.infer.generator import UnitGenerator as TGenerator

    cfg = jcfg(kind)
    params = params_of(kind, scale=8.0)
    tmodel = t_model(kind, cfg, params)
    b = batch(5)
    gkw = dict(beam=3, max_len_a=0.0, max_len_b=9, kv_cache_dtype=kv)
    want = JGenerator(j_model(kind, cfg), params, JGen(**gkw)).generate(
        b["wav"], b["lens"], b["imgs"], b["masks"])
    got = TGenerator(tmodel, tconfig.GenerationConfig(**gkw)).generate(
        b["wav"], b["lens"], b["imgs"], b["masks"])
    for i in range(B):
        assert got[i][0]["tokens"] == want[i][0]["tokens"]
        np.testing.assert_allclose([h["score"] for h in got[i]], [h["score"] for h in want[i]],
                                   atol=1e-4)


@pytest.mark.parametrize("kind,ratio", [("xm", 80), ("hubert", 10), ("conv", 1)])
def test_generation_budgets_count_encoder_positions(kind, ratio):
    """source_downsample_ratio (samples per position: the conv stack, and
    through XM's adaptor 8× more; fbank frames 1) and the budget
    a·⌈src / ratio⌉ + b, against JAX's."""
    from mm_s2ut.config import GenerationConfig as JGen
    from mm_s2ut.infer.generator import UnitGenerator as JGenerator
    from mm_s2ut_torch.infer.generator import UnitGenerator as TGenerator

    if kind == "conv":
        cfg = JModelCfg(**DEC, dtype="float32", multimodal=JMMCfg(**MM))
        jmodel, tmodel = JS2UT(cfg), TS2UT(tcfg(cfg))
    else:
        cfg = jcfg(kind)
        jmodel, tmodel = j_model(kind, cfg), KINDS[kind][1](tcfg(cfg), w2v_cfg=TW2V(**W2V))
    assert tmodel.source_downsample_ratio == jmodel.source_downsample_ratio == ratio
    gkw = dict(max_len_a=0.5, max_len_b=7)
    jgen = JGenerator(jmodel, {}, JGen(**gkw), max_target_positions=40)
    tgen = TGenerator(tmodel, tconfig.GenerationConfig(**gkw), max_target_positions=40)
    for src in (1, 79, 80, 81, 2400, 160000):
        assert tgen._max_len(src) == jgen._max_len(src), src


def test_flagship_geometry_ratios():
    """The full-width ratios: 320 samples a wav2vec2 frame, 2560 an XM
    position (10 s: 499 frames → 63 positions)."""
    from mm_s2ut_torch.models.mm_xm import Conv1dAdaptor

    cfg = tconfig.ModelConfig(speech_encoder_type="hubert", dtype="float32",
                              multimodal=tconfig.MultimodalConfig(multimodal_attention_type=None))
    w2v = TW2V()
    assert w2v.feature_lengths(160000) == 499
    lens = torch.tensor([499, 31])
    _, out = Conv1dAdaptor(8, 8)(torch.zeros(2, 499, 8), lens)
    assert out.tolist() == [63, 4]
    assert TW2V.from_args(cfg.w2v_args) == w2v
    assert -(-160000 // 2560) == 63


# ---------------------------------------------------------------------------
# 4. data and tasks
# ---------------------------------------------------------------------------

PIECES = [("▁the", -1.0), ("▁cat", -2.0), ("at", -3.0), ("▁c", -4.0), ("▁", -5.0),
          ("t", -6.0), ("h", -6.0), ("e", -6.0), ("c", -6.5), ("a", -6.5), ("s", -6.5),
          ("▁s", -5.5), ("th", -4.5), ("▁th", -3.5), ("▁sat", -2.5)]
TEXTS = ["the cat sat", "the  cat", "cats sat the cat", "sat"]


def s2t_corpus(root, n_img_dim=16):
    """wavs, a manifest with transcripts and a target language, a
    SentencePiece model (``build_model``), its dict.txt with the lang tag,
    and image features per split."""
    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.data.sentencepiece import build_model

    rng = np.random.RandomState(8)
    rows = []
    for i, text in enumerate(TEXTS):
        n = 1600 + 500 * i
        write_wav(root / f"{i + 1}.wav", (0.2 * rng.randn(n)).astype(np.float32), 16000)
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, text, len(text.split()), tgt_lang="de"))
    write_manifest(root / "test.tsv", rows)
    (root / "spm.model").write_bytes(build_model(PIECES))
    symbols = [p for p, _ in PIECES] + ["<lang:de>"]
    (root / "dict.txt").write_text("".join(f"{s} 1\n" for s in symbols))
    (root / "img").mkdir(exist_ok=True)
    np.save(root / "img" / "test.npy", rng.randn(len(TEXTS), TI, n_img_dim).astype(np.float32))
    return rows


def data_cfgs(root, **kw):
    from mm_s2ut.config import DataConfig as JData

    fields = dict(data_root=str(root), audio_root=str(root), vocab_filename="dict.txt",
                  target_is_code=False, tgt_lang="<lang:de>", eos_token="<lang:de>",
                  prepend_bos_and_append_tgt_lang_tag=True, max_tokens=100, num_buckets=2,
                  bpe_tokenizer={"bpe": "sentencepiece",
                                 "sentencepiece_model": str(root / "spm.model")},
                  pre_tokenizer={"tokenizer": "space"}, **kw)
    return JData(**fields), tconfig.DataConfig(**fields)


def test_sentencepiece_copy_matches_jax(tmp_path):
    from mm_s2ut.data import sentencepiece as J
    from mm_s2ut_torch.data import sentencepiece as T

    for mt in (T.UNIGRAM, T.BPE):
        blob = T.build_model(PIECES, model_type=mt)
        assert blob == J.build_model(PIECES, model_type=mt)
        (tmp_path / f"{mt}.model").write_bytes(blob)
        t = T.SentencePieceProcessor.load(tmp_path / f"{mt}.model")
        j = J.SentencePieceProcessor.load(tmp_path / f"{mt}.model")
        for text in TEXTS + ["the cathat", "x cat"]:
            assert t.encode(text) == j.encode(text)
            assert t.encode_ids(text) == j.encode_ids(text)
            assert t.decode(t.encode(text)) == j.decode(j.encode(text))


def test_s2t_dataset_items_and_collate_match_jax(tmp_path):
    from mm_s2ut.data.dictionary import Dictionary as JDict
    from mm_s2ut.data.s2t_dataset import MultiModalSpeechToTextDataset as JDS
    from mm_s2ut_torch.data.dictionary import Dictionary as TDict
    from mm_s2ut_torch.data.s2t_dataset import MultiModalSpeechToTextDataset as TDS

    s2t_corpus(tmp_path)
    jd, td = data_cfgs(tmp_path)
    jmm, tmm = JMMCfg(**MM, image_feat_path=[str(tmp_path / "img")]), \
        tconfig.MultimodalConfig(**MM, image_feat_path=[str(tmp_path / "img")])
    jds = JDS.from_tsv(tmp_path, "test", jd, JDict.load(tmp_path / "dict.txt"), mm_cfg=jmm)
    tds = TDS.from_tsv(tmp_path, "test", td, TDict.load(tmp_path / "dict.txt"), mm_cfg=tmm)
    tag = tds.tgt_dict.index("<lang:de>")
    for i in range(len(TEXTS)):
        ji, ti = jds[i], tds[i]
        np.testing.assert_array_equal(ti.target, ji.target)
        assert ti.target[0] == tds.tgt_dict.bos() and ti.target[-1] == tag
        assert tds.tgt_dict.unk() not in ti.target.tolist()
        assert ti.tgt_lang_tag == ji.tgt_lang_tag == tag
        np.testing.assert_array_equal(ti.source, ji.source)
        np.testing.assert_array_equal(ti.imgs[0], ji.imgs[0])
    got = tds.collate([tds[i] for i in range(4)], src_pad=4000, tgt_pad=12)
    want = jds.collate([jds[i] for i in range(4)], src_pad=4000, tgt_pad=12)
    assert set(got) == set(want)
    for key in want:
        for g, w in zip(np.atleast_1d(got[key]) if key not in ("imgs_list", "img_masks_list")
                        else got[key], np.atleast_1d(want[key])
                        if key not in ("imgs_list", "img_masks_list") else want[key]):
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert (got["prev_output_tokens"][:, 0] == tag).all()


def test_resampled_concat_matches_jax():
    from mm_s2ut.data.s2t_dataset import ResampledConcat as JRC
    from mm_s2ut_torch.data.s2t_dataset import ResampledConcat as TRC

    datasets = [list(range(n)) for n in (3, 17, 40)]
    for temp in (1.0, 2.0, 5.0):
        t, j = TRC(datasets, temp, seed=4), JRC(datasets, temp, seed=4)
        np.testing.assert_allclose(t.ratios, j.ratios)
        assert len(t) == len(j)
        for epoch in (0, 1):
            assert t.epoch_indices(epoch) == j.epoch_indices(epoch)
        assert t.get(1, 5) == j.get(1, 5) == 5


def _jax_task(cfg):
    import mm_s2ut  # noqa: F401  (registers the tasks)
    from mm_s2ut import registry

    return registry.get_task(cfg.task)(cfg)


def _compare_batches(got_batches, want_batches):
    assert len(got_batches) == len(want_batches) > 0
    for got, want in zip(got_batches, want_batches):
        assert set(got) >= {"src_features", "src_lengths", "prev_output_tokens", "target", "id"}
        for key in ("id", "src_features", "src_lengths", "prev_output_tokens", "target",
                    "target_lengths"):
            np.testing.assert_allclose(got[key].cpu().numpy(), np.asarray(want[key]), rtol=0,
                                       atol=1e-6, err_msg=key)
        for g, w in zip(got.get("imgs_list", ()), want.get("imgs_list", ())):
            np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w))


def test_s2t_task_batches_match_jax(tmp_path):
    from mm_s2ut.config import Config as JConfig
    from mm_s2ut_torch.tasks.s2t_task import MultiModalSpeechToTextTask

    s2t_corpus(tmp_path)
    jd, td = data_cfgs(tmp_path)
    mm = dict(MM, image_feat_path=[str(tmp_path / "img")])
    jc = JConfig(task="multimodal_speech_to_text", data=jd,
                 model=JModelCfg(**DEC, dtype="float32", multimodal=JMMCfg(**mm)))
    tc = tconfig.Config(task="multimodal_speech_to_text", data=td,
                        model=tconfig.ModelConfig(**DEC, dtype="float32",
                                                  multimodal=tconfig.MultimodalConfig(**mm)))
    jtask, ttask = _jax_task(jc), MultiModalSpeechToTextTask(tc, "cpu")
    assert len(ttask.tgt_dict) == len(jtask.tgt_dict) == tc.model.vocab_size == len(PIECES) + 5
    want = list(jtask.batch_iterator("test", shuffle=False))
    got = list(ttask.batch_iterator("test", shuffle=False))
    assert got[0]["src_features"].ndim == 2  # raw waveforms
    _compare_batches(got, want)


@pytest.mark.parametrize("standardize", [False, True])
def test_raw_waveform_s2s_task_batches_match_jax(tmp_path, standardize):
    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import DataConfig as JData
    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask

    rng = np.random.RandomState(9)
    rows = []
    for i in range(5):
        n = 2000 + 700 * i
        write_wav(tmp_path / f"{i + 1}.wav", (0.3 * rng.randn(n) + 0.05).astype(np.float32),
                  16000)
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, " ".join(map(str, rng.randint(
            0, 30, 4 + i))), 4 + i))
    write_manifest(tmp_path / "test.tsv", rows)
    data = dict(data_root=str(tmp_path), audio_root=str(tmp_path), target_code_size=36,
                standardize_audio=standardize, max_tokens=100, num_buckets=2)
    model = dict(DEC, vocab_size=40, dtype="float32", speech_encoder_type="hubert")
    mm = dict(MM, multimodal_attention_type=None)
    jc = JConfig(data=JData(**data), model=JModelCfg(**model, multimodal=JMMCfg(**mm)))
    tc = tconfig.Config(data=tconfig.DataConfig(**data), model=tconfig.ModelConfig(
        **model, multimodal=tconfig.MultimodalConfig(**mm)))
    want = list(_jax_task(jc).batch_iterator("test", shuffle=False))
    got = list(MultiModalSpeechToSpeechTask(tc, "cpu").batch_iterator("test", shuffle=False))
    assert got[0]["src_features"].ndim == 2
    _compare_batches(got, want)
    if standardize:
        b = got[0]
        n = int(b["src_lengths"][0])
        assert abs(float(b["src_features"][0, :n].mean())) < 1e-4


# ---------------------------------------------------------------------------
# 5. the entry point
# ---------------------------------------------------------------------------


def test_cli_generate_matches_jax(tmp_path, monkeypatch):
    """An exported XM checkpoint (config.yaml + params.npz) and an S2T
    corpus; both CLIs decode the split from the same parameters."""
    import mm_s2ut.inference as j_inference
    from mm_s2ut.cli.generate import main as j_main
    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import GenerationConfig as JGen
    from mm_s2ut.config import save_yaml
    from mm_s2ut_torch.cli.generate import main as t_main
    from scripts.export_jax_params import flatten_params

    s2t_corpus(tmp_path)
    jd, _ = data_cfgs(tmp_path)
    mm = dict(MM, image_feat_path=[str(tmp_path / "img")])
    vocab = len(PIECES) + 5
    model_cfg = JModelCfg(**{**DEC, "vocab_size": vocab}, dtype="float32",
                          w2v_args={k: list(v) if isinstance(v, tuple) else v
                                    for k, v in W2V.items()}, multimodal=JMMCfg(**mm))
    cfg = JConfig(task="multimodal_speech_to_text", data=jd, model=model_cfg,
                  generation=JGen(beam=3, max_len_a=0.0, max_len_b=8))
    jmodel = JXM(model_cfg, w2v_cfg=JW2V.from_args(model_cfg.w2v_args))
    b = batch()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(6), b["wav"], b["lens"], np.zeros((B, 3), np.int32), b["imgs"],
        b["masks"]))
    norm = params["params"]["decoder"]["final_norm"]
    norm["scale"], norm["bias"] = norm["scale"] * 8.0, norm["bias"] * 8.0
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    save_yaml(cfg, model_dir / "config.yaml")
    np.savez(model_dir / "params.npz", **flatten_params(params["params"]))
    monkeypatch.setattr(j_inference, "load_checkpoint", lambda path: (
        __import__("mm_s2ut.config", fromlist=["load_config"]).load_config(
            model_dir / "config.yaml"), jmodel, params))

    assert j_main(["--model_path", str(model_dir), "--gen-subset", "test",
                   "--results-path", str(tmp_path / "jax")]) == 0
    assert t_main(["--model_path", str(model_dir), "--gen-subset", "test",
                   "--results-path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want = (tmp_path / "jax" / "generate-test.txt").read_text().splitlines()
    got = (tmp_path / "port" / "generate-test.txt").read_text().splitlines()
    assert len(got) == len(want) == 3 * len(TEXTS)
    assert not any("<lang:" in line for line in got)
    for g, w in zip(got, want):
        g, w = g.split("\t"), w.split("\t")
        assert g[0] == w[0] and g[-1] == w[-1], (g, w)
        if len(g) == 3:  # H-/D- lines: the score
            assert abs(float(g[1]) - float(w[1])) <= 1e-4 + 5e-5, (g, w)
    assert any(line.startswith("D-") and line.split("\t")[-1] for line in got)


def test_inference_cli_reads_the_samples_of_a_hubert_checkpoint(tmp_path):
    """``python -m mm_s2ut_torch.inference`` on a ``hubert`` checkpoint
    feeds the raw samples (standardized with ``data.standardize_audio``):
    the units of JAX's UnitGenerator on the same standardized samples. A
    speech-to-text checkpoint is refused there (``cli.generate`` decodes
    it)."""
    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import DataConfig as JData
    from mm_s2ut.config import GenerationConfig as JGen
    from mm_s2ut.config import save_yaml
    from mm_s2ut.data.dictionary import UnitDictionary
    from mm_s2ut.infer.generator import UnitGenerator as JGenerator
    from mm_s2ut_torch.data.audio_io import get_waveform, write_wav
    from mm_s2ut_torch.data.dataset import standardize_waveforms
    from mm_s2ut_torch.inference import main
    from scripts.export_jax_params import flatten_params

    w2v_args = {k: list(v) if isinstance(v, tuple) else v for k, v in W2V.items()}
    cfg = jcfg("hubert", w2v_args=w2v_args)
    gen = dict(beam=3, max_len_a=0.0, max_len_b=8)
    params = params_of("hubert", scale=8.0)
    for name, task in (("hubert", "multimodal_speech_to_speech"),
                       ("xm", "multimodal_speech_to_text")):
        (tmp_path / name).mkdir()
        save_yaml(JConfig(task=task, model=jcfg(name, w2v_args=w2v_args),
                          data=JData(standardize_audio=True), generation=JGen(**gen)),
                  tmp_path / name / "config.yaml")
        np.savez(tmp_path / name / "params.npz", **flatten_params(params_of(name)["params"]))
    np.savez(tmp_path / "hubert" / "params.npz", **flatten_params(params["params"]))
    write_wav(tmp_path / "a.wav", (0.3 * np.random.RandomState(11).randn(2100) + 0.1)
              .astype(np.float32), 16000)
    assert main(["--model_path", str(tmp_path / "hubert"), "--audio_path", str(tmp_path / "a.wav"),
                 "--output_dir", str(tmp_path / "out"), "--device", "cpu"]) == 0
    wav = get_waveform(str(tmp_path / "a.wav"), use_sample_rate=16000)[0][None]
    wav = standardize_waveforms(wav.astype(np.float32), np.asarray([wav.shape[1]]))
    hyp = JGenerator(j_model("hubert", cfg), params, JGen(**gen)).generate(
        wav, np.asarray([wav.shape[1]], np.int32))[0][0]
    units = UnitDictionary(1000).ids_to_units(np.asarray(hyp["tokens"]))
    assert (tmp_path / "out" / "a.unit").read_text().split() == [str(u) for u in units]
    assert len(units) > 0
    with pytest.raises(ValueError, match="cli.generate"):
        main(["--model_path", str(tmp_path / "xm"), "--audio_path", str(tmp_path / "a.wav"),
              "--output_dir", str(tmp_path / "out2"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# 6. the server's raw-waveform requests
# ---------------------------------------------------------------------------

ENC_SAMPLES, K, MAX_LEN = 3200, 3, 8


class XMPair:
    """The tiny XM model in JAX and in the port, with JAX's offline search
    of one waveform padded to ENC_SAMPLES."""

    def __init__(self):
        self.cfg = jcfg("xm")
        self.jmodel = j_model("xm", self.cfg)
        self.params = params_of("xm", scale=8.0)
        self.tmodel = t_model("xm", self.cfg, self.params)
        self._encode = jax.jit(lambda w, lens, imgs, masks: self.jmodel.apply(
            self.params, w, lens, imgs, masks, method=self.jmodel.encode))
        self._step = lambda t, s: self.jmodel.apply(self.params, t, s,
                                                    method=self.jmodel.decode_step)

    @functools.lru_cache(maxsize=None)
    def _init(self, kv, max_len):
        return jax.jit(lambda enc: j_tile(self.jmodel.apply(
            self.params, enc, max_len + 1, method=self.jmodel.decode_init, kv_dtype=kv), K))

    def offline(self, req, kv, max_len=MAX_LEN):
        w = np.zeros((1, ENC_SAMPLES), np.float32)
        w[0, : req.length] = req.features[: req.length]
        enc = self._encode(jnp.asarray(w), jnp.asarray([req.length], np.int32),
                           tuple(jnp.asarray(x[None]) for x in req.imgs),
                           tuple(jnp.asarray(x[None]) for x in req.img_masks))
        seqs, scores = j_beam_search(self._step, self._init(kv, max_len)(enc), 1, beam_size=K,
                                     max_len=max_len, eos_id=2, bos_id=2, pad_id=1,
                                     vocab_size=V)
        toks = [int(t) for t in np.asarray(seqs)[0, 0]]
        return (toks[: toks.index(2)] if 2 in toks else toks), float(scores[0, 0])


def xm_requests():
    """Five raw-waveform requests of 1500-3200 samples, one image source
    with ragged padding."""
    from mm_s2ut_torch.infer.serving import Request

    rng = np.random.RandomState(10)
    reqs = []
    for i, n in enumerate((3200, 2000, 2750, 1500, 3100)):
        img_mask = np.zeros(TI, bool)
        img_mask[TI - i % 3:] = True
        reqs.append(Request(uid=i, features=(0.3 * rng.randn(n)).astype(np.float32), length=n,
                            imgs=(rng.randn(TI, 16).astype(np.float32),),
                            img_masks=(img_mask,)))
    return reqs


@pytest.mark.parametrize("kv", [None, "int8"])
def test_raw_waveform_server_matches_jax_offline_search(kv):
    from mm_s2ut_torch.infer.serving import ContinuousServer

    pair = XMPair()
    reqs = xm_requests()
    srv = ContinuousServer(pair.tmodel, slots=2, beam_size=K, ring=12, chunk=3,
                           enc_frames=ENC_SAMPLES, enc_feat_dim=None, max_len_a=0.0,
                           max_len_b=MAX_LEN, img_shapes=((TI, 16),),
                           kv_cache_dtype=kv or "bfloat16", admit_width=1)
    results = {r.uid: r for r in srv.run(reqs)}
    assert sorted(results) == list(range(len(reqs)))
    assert srv.stats["steps"] > srv.ring  # the ring wrapped
    for req in reqs:
        want_toks, want_score = pair.offline(req, kv)
        assert results[req.uid].tokens == want_toks, req.uid
        np.testing.assert_allclose(results[req.uid].score, want_score, atol=1e-4)


@pytest.mark.parametrize("max_len_a", [0.0, 0.1])
def test_raw_waveform_server_against_jax_server(max_len_a):
    """The port's raw-waveform server against JAX's ``ContinuousServer`` on
    the XM model (one row per admission wave). At max_len_a 0 both budgets
    are max_len_b and the results are equal. At max_len_a > 0 they differ
    by design (ROADMAP.md §3 item 5): the port's budget counts encoder
    positions, a·⌈samples / source_downsample_ratio⌉ + b, as the offline
    generator does; JAX's server counts samples, a·samples + b; both at
    most ring − 2. There the port's results equal JAX's offline search at
    the port's budgets, and JAX's budgets are read from its admitted
    state."""
    from mm_s2ut.infer.serving import ContinuousServer as JServer
    from mm_s2ut.infer.serving import Request as JRequest
    from mm_s2ut_torch.infer.serving import ContinuousServer

    pair = XMPair()
    reqs = xm_requests()
    ring, max_len_b = 12, 4
    kw = dict(slots=2, beam_size=K, ring=ring, chunk=3, enc_frames=ENC_SAMPLES,
              enc_feat_dim=None, max_len_a=max_len_a, max_len_b=max_len_b,
              img_shapes=((TI, 16),), admit_width=1)
    srv = ContinuousServer(pair.tmodel, **kw)
    results = {r.uid: r for r in srv.run(reqs)}
    lengths = np.asarray([r.length for r in reqs])
    ratio = pair.tmodel.source_downsample_ratio
    assert ratio == 80  # (5 · 2) samples a frame, then the adaptor's 2³
    port_budgets = np.minimum((max_len_a * -(-lengths // ratio) + max_len_b).astype(int),
                              ring - 2)
    np.testing.assert_array_equal(srv._budgets(lengths), port_budgets)
    jsrv = JServer(pair.jmodel, pair.params, vocab_size=V, n_img_sources=1, **kw)
    if max_len_a == 0:
        jres = {r.uid: r for r in jsrv.run(
            [JRequest(r.uid, r.features, r.length, r.imgs, r.img_masks) for r in reqs])}
        assert sorted(jres) == sorted(results) == list(range(len(reqs)))
        for uid, r in results.items():
            assert r.tokens == jres[uid].tokens, uid
            np.testing.assert_allclose(r.score, jres[uid].score, atol=1e-4)
        return
    # JAX's server admits all five at once into a pool of five slots: its
    # budgets, from the raw sample counts.
    jsrv = JServer(pair.jmodel, pair.params, vocab_size=V, n_img_sources=1,
                   **dict(kw, slots=len(reqs), admit_width=None))
    wav = np.zeros((len(reqs), ENC_SAMPLES), np.float32)
    for i, r in enumerate(reqs):
        wav[i, : r.length] = r.features
    imgs = (jnp.asarray(np.stack([r.imgs[0] for r in reqs])),)
    masks = (jnp.asarray(np.stack([r.img_masks[0] for r in reqs])),)
    jlens = jnp.asarray(lengths, np.int32)
    st = jsrv.init_state(pair.params)
    enc_out, enc_mask = jsrv._encode(pair.params, jnp.asarray(wav), jlens, imgs, masks)
    st = jsrv._admit(pair.params, st, jnp.arange(len(reqs), dtype=jnp.int32),
                     jnp.ones((len(reqs),), bool), enc_out, enc_mask, jlens)
    jax_budgets = np.minimum((max_len_a * lengths + max_len_b).astype(int), ring - 2)
    np.testing.assert_array_equal(np.asarray(st["slot_max"]), jax_budgets)
    assert (port_budgets < jax_budgets).all(), (port_budgets, jax_budgets)
    for req, budget in zip(reqs, port_budgets):
        want_toks, want_score = pair.offline(req, None, int(budget))
        assert results[req.uid].tokens == want_toks, req.uid
        np.testing.assert_allclose(results[req.uid].score, want_score, atol=1e-4)


# ---------------------------------------------------------------------------
# 7. what still raises
# ---------------------------------------------------------------------------


def test_settings_that_still_raise(tmp_path):
    from mm_s2ut_torch.cli.generate import main as t_main
    from mm_s2ut_torch.infer.serving import ContinuousServer

    from mm_s2ut_torch.config import Config, save_yaml

    # A logit ensemble whose members differ in a field that changes the
    # decode (not in their parameter shapes) is refused, naming the field.
    xm = t_model("xm", jcfg("xm"), params_of("xm"))
    w2v_args = {k: list(v) if isinstance(v, tuple) else v for k, v in W2V.items()}
    for name, heads in (("a", 2), ("b", 1)):
        (tmp_path / name).mkdir()
        cfg = tcfg(jcfg("xm", w2v_args=w2v_args))
        cfg.decoder_attention_heads = heads
        save_yaml(Config(task="multimodal_speech_to_text", model=cfg), tmp_path / name / "config.yaml")
        np.savez(tmp_path / name / "params.npz", **to_flax(xm))
    with pytest.raises(ValueError, match=r"differing fields \['decoder_attention_heads'\]"):
        t_main(["--model_path", f"{tmp_path}/a:{tmp_path}/b", "--results-path",
                str(tmp_path / "out"), "--device", "cpu"])
    with pytest.raises(ValueError, match="raw waveforms"):
        ContinuousServer(xm, enc_frames=ENC_SAMPLES)  # enc_feat_dim=80 on a waveform model
