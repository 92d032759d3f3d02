"""The port's logit ensemble (``UnitGenerator`` over several models,
``cli.generate --model_path a:b``) against the JAX package's over two
parameter sets of the small flagship config.

Per cache (fp32, bf16, int8, int4) the search runs past step 64, so each
member's cache grows into a second segment (int4: re-packed). Top tokens
are equal and scores within 1e-4 (the members' fp32 log-softmaxes are
combined with a log-sum-exp in both packages, whose summation orders
differ by ~1e-7). A list of one model decodes exactly as the model alone
(no extra softmax); ``cli.generate a:b``'s lines equal JAX's CLI's; and
members whose configs differ are refused with JAX's message."""
import numpy as np
import pytest
import torch

from mm_s2ut.config import GenerationConfig as JGenCfg
from mm_s2ut.infer.generator import UnitGenerator as JGenerator
from mm_s2ut_torch.config import GenerationConfig as TGenCfg
from mm_s2ut_torch.infer.generator import UnitGenerator as TGenerator
from tests.test_torch_model import B, inputs, small_models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def members():
    """Two small fp32 flagships from different seeds, logits scaled ×8 so
    argmaxes are not near-ties: (jax model, [params], [torch models])."""
    jmodel, p1, t1 = small_models("float32", seed=1, logit_scale=8.0)
    _, p2, t2 = small_models("float32", seed=2, logit_scale=8.0)
    return jmodel, [p1, p2], [t1, t2]


def _generate(members, kv, max_len_b=70):
    jmodel, params, tmodels = members
    b = inputs(seed=4)
    kw = dict(beam=3, max_len_a=0.0, max_len_b=max_len_b, kv_cache_dtype=kv)
    want = JGenerator(jmodel, params, JGenCfg(**kw)).generate(
        b["feats"], b["lens"], b["imgs"], b["masks"])
    got = TGenerator(tmodels, TGenCfg(**kw)).generate(
        b["feats"], b["lens"], b["imgs"], b["masks"])
    return got, want


@pytest.mark.parametrize("kv", [None, "bfloat16", "int8", "int4"])
def test_ensemble_generate_matches_jax(members, kv):
    got, want = _generate(members, kv)
    # The search ran past step 64: both members' caches grew.
    assert max(len(got[bi][0]["tokens"]) for bi in range(B)) >= 64
    for bi in range(B):
        assert got[bi][0]["tokens"] == want[bi][0]["tokens"]
        np.testing.assert_allclose([h["score"] for h in got[bi]],
                                   [h["score"] for h in want[bi]], atol=1e-4)


def test_a_list_of_one_model_decodes_as_the_model(members):
    _, _, tmodels = members
    b = inputs(seed=4)
    cfg = TGenCfg(beam=3, max_len_a=0.0, max_len_b=20)
    alone = TGenerator(tmodels[0], cfg).generate(b["feats"], b["lens"], b["imgs"], b["masks"])
    listed = TGenerator([tmodels[0]], cfg).generate(b["feats"], b["lens"], b["imgs"], b["masks"])
    assert listed == alone  # tokens and float scores, bit for bit
    # Two copies of one model: the mean of equal probabilities is that
    # probability, so the ensemble finds the model's own beams.
    twice = TGenerator([tmodels[0]] * 2, cfg).generate(b["feats"], b["lens"], b["imgs"],
                                                       b["masks"])
    for bi in range(B):
        assert [h["tokens"] for h in twice[bi]] == [h["tokens"] for h in alone[bi]]
        np.testing.assert_allclose([h["score"] for h in twice[bi]],
                                   [h["score"] for h in alone[bi]], atol=1e-5)


def _xm_checkpoints(tmp_path, n, heads=None):
    """An S2T corpus and ``n`` exported XM checkpoints from different seeds
    (config.yaml + params.npz); returns (the JAX model, JAX Config, dirs,
    {dir: params})."""
    import jax

    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import GenerationConfig as JGen
    from mm_s2ut.config import save_yaml
    from scripts.export_jax_params import flatten_params
    from tests.test_torch_xm import (DEC, JXM, JW2V, MM, PIECES, W2V, JModelCfg, JMMCfg, batch,
                                     data_cfgs, s2t_corpus)

    s2t_corpus(tmp_path)
    jd, _ = data_cfgs(tmp_path)
    w2v_args = {k: list(v) if isinstance(v, tuple) else v for k, v in W2V.items()}
    dirs, params_of = [], {}
    for i in range(n):
        dec = {**DEC, "vocab_size": len(PIECES) + 5}
        if heads is not None:
            dec["decoder_attention_heads"] = heads[i]
        model_cfg = JModelCfg(**dec, dtype="float32", w2v_args=w2v_args,
                              multimodal=JMMCfg(**MM, image_feat_path=[str(tmp_path / "img")]))
        cfg = JConfig(task="multimodal_speech_to_text", data=jd, model=model_cfg,
                      generation=JGen(beam=3, max_len_a=0.0, max_len_b=8))
        jmodel = JXM(model_cfg, w2v_cfg=JW2V.from_args(model_cfg.w2v_args))
        b = batch()
        params = jax.tree_util.tree_map(np.asarray, jmodel.init(
            jax.random.PRNGKey(6 + i), b["wav"], b["lens"], np.zeros((2, 3), np.int32),
            b["imgs"], b["masks"]))
        norm = params["params"]["decoder"]["final_norm"]
        norm["scale"], norm["bias"] = norm["scale"] * 8.0, norm["bias"] * 8.0
        d = tmp_path / f"model{i}"
        d.mkdir()
        save_yaml(cfg, d / "config.yaml")
        np.savez(d / "params.npz", **flatten_params(params["params"]))
        dirs.append(str(d))
        params_of[str(d)] = params
    return jmodel, dirs, params_of


def _patch_jax_loader(monkeypatch, jmodel, params_of):
    import mm_s2ut.inference as j_inference
    from mm_s2ut.config import load_config

    monkeypatch.setattr(j_inference, "load_checkpoint", lambda path: (
        load_config(f"{path}/config.yaml"), jmodel, params_of[str(path)]))


def test_cli_generate_ensemble_matches_jax(tmp_path, monkeypatch):
    from mm_s2ut.cli.generate import main as j_main
    from mm_s2ut_torch.cli.generate import main as t_main

    jmodel, dirs, params_of = _xm_checkpoints(tmp_path, 2)
    _patch_jax_loader(monkeypatch, jmodel, params_of)
    assert j_main(["--model_path", ":".join(dirs), "--gen-subset", "test",
                   "--results-path", str(tmp_path / "jax")]) == 0
    assert t_main(["--model_path", ":".join(dirs), "--gen-subset", "test",
                   "--results-path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want = (tmp_path / "jax" / "generate-test.txt").read_text().splitlines()
    got = (tmp_path / "port" / "generate-test.txt").read_text().splitlines()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = g.split("\t"), w.split("\t")
        assert g[0] == w[0] and g[-1] == w[-1], (g, w)
        if len(g) == 3:  # H-/D- lines: the score
            assert abs(float(g[1]) - float(w[1])) <= 1e-4 + 5e-5, (g, w)
    assert any(line.startswith("D-") and line.split("\t")[-1] for line in got)
    # The ensemble decodes something else than its first member alone.
    assert t_main(["--model_path", dirs[0], "--gen-subset", "test", "--results-path",
                   str(tmp_path / "one"), "--device", "cpu"]) == 0
    assert (tmp_path / "one" / "generate-test.txt").read_text().splitlines() != got


def test_mismatched_members_raise_naming_the_fields(tmp_path, monkeypatch):
    from mm_s2ut.cli.generate import main as j_main
    from mm_s2ut_torch.cli.generate import main as t_main

    jmodel, dirs, params_of = _xm_checkpoints(tmp_path, 2, heads=[2, 1])
    _patch_jax_loader(monkeypatch, jmodel, params_of)
    args = ["--model_path", ":".join(dirs), "--results-path", str(tmp_path / "out")]
    with pytest.raises(ValueError) as j_err:
        j_main(args)
    with pytest.raises(ValueError) as t_err:
        t_main(args + ["--device", "cpu"])
    assert str(t_err.value) == str(j_err.value)
    assert "differing fields ['decoder_attention_heads']" in str(t_err.value)
