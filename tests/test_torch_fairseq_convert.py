"""The port's fairseq converters (``utils/fairseq_convert.py`` over the
restricted reader ``utils/torch_pickle.py``) and
``cli.convert_checkpoint`` against the JAX package's.

A fairseq-named flagship and a fairseq HuBERT state dict are written by
``torch.save`` as fairseq writes training checkpoints: the weights under
``"model"``, an ``argparse.Namespace``, a class neither machine can
import (here: a class only this test module defines, standing in for an
omegaconf config) and numpy scalars beside them. Both converters read
the file; their trees must be bit-equal, the port's model loaded from the
tree must match JAX's logits (fp32 1e-4), and the strict/unknown-key and
untied-output rules must behave as JAX's. The fairseq names come from
``chip_smoke.py``'s writers (phase 22b uses them at full width)."""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FairseqConfigStandIn, fairseq_flagship_state, fairseq_hubert_state
from mm_s2ut.config import ModelConfig as JModelCfg
from mm_s2ut.config import MultimodalConfig as JMMCfg
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JS2UT
from mm_s2ut.models.wav2vec2 import Wav2Vec2Model as JW2VModel
from mm_s2ut.utils import fairseq_convert as jfc
from mm_s2ut.utils import torch_pickle as jtp
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import flatten, from_flax, to_flax, unflatten
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TS2UT
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from mm_s2ut_torch.utils import fairseq_convert as tfc
from mm_s2ut_torch.utils import torch_pickle as ttp

torch.set_num_threads(1)
D, FFN, HEADS, NL, IMG_D, V, CONV_MID = 32, 48, 2, 2, 24, 40, 16
MODEL = dict(encoder_embed_dim=D, encoder_ffn_embed_dim=FFN, encoder_layers=NL,
             encoder_attention_heads=HEADS, decoder_embed_dim=D, decoder_ffn_embed_dim=FFN,
             decoder_layers=NL, decoder_attention_heads=HEADS, conv_channels=CONV_MID,
             vocab_size=V, dtype="float32", dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0)
MM = dict(image_feat_dim=[IMG_D], multimodal_attention_type="selective_attention",
          use_selective_gate=True, image_pre_norm=True, is_fusion_top=True,
          modality_dropout=0.0, SA_image_dropout=0.0, SA_attention_dropout=0.0)
W2V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=48,
           conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
           hidden_dropout=0.0, attention_dropout=0.0)


def random_(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return module


def port_flagship(seed=0):
    cfg = tconfig.ModelConfig(**MODEL, multimodal=tconfig.MultimodalConfig(**MM))
    return cfg, random_(TS2UT(cfg), seed).eval()


def save_fairseq(path, sd, cfg_blob=None):
    """A fairseq training checkpoint at ``path``: the weights and what
    fairseq pickles beside them, numpy values included; and the same
    checkpoint with those values as Python numbers at ``path``'s
    ``.jax.pt`` sibling, which is what JAX's reader can read (it fails on
    numpy values: ``test_numpy_values_read_by_the_port_only``). Returns
    (path, sibling)."""
    jax_path = path.with_suffix(".jax.pt")
    extras = ({"val_loss": np.float64(1.25), "best": np.array([2.5], np.float32)},
              {"val_loss": 1.25, "best": [2.5]})
    for out, extra_state in zip((path, jax_path), extras):
        torch.save({
            "model": sd,
            "args": argparse.Namespace(arch="mm_s2ut_transformer", encoder_layers=NL),
            "cfg": cfg_blob if cfg_blob is not None else FairseqConfigStandIn(seed=1, lr=[5e-4]),
            "extra_state": extra_state,
            "optimizer_history": [{"criterion_name": "SpeechToUnitCriterion", "num_updates": 10}],
        }, out)
    return path, jax_path


def assert_trees_bit_equal(got, want):
    got, want = flatten(got), flatten(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_numpy_values_read_by_the_port_only(tmp_path):
    """torch.save pickles the bytes of a numpy scalar or array through
    _codecs.encode; JAX's reader stubs that and fails, the port's reads
    the values."""
    path, _ = save_fairseq(tmp_path / "c.pt", {"w": torch.ones(2)})
    with pytest.raises(TypeError):
        jtp.load(path)
    extra = ttp.load(path)["extra_state"]
    assert type(extra["val_loss"]) is np.float64 and extra["val_loss"] == 1.25
    np.testing.assert_array_equal(extra["best"], np.array([2.5], np.float32))


def test_restricted_reader_equals_jax_and_runs_no_code(tmp_path):
    _, model = port_flagship()
    path, jax_path = save_fairseq(tmp_path / "c.pt", fairseq_flagship_state(model))
    got, want = ttp.load(path), jtp.load(jax_path)
    assert isinstance(got["args"], argparse.Namespace) and got["args"].encoder_layers == NL
    assert isinstance(got["cfg"], ttp._Stub) and got["cfg"].seed == 1
    assert ttp.to_plain(got["cfg"]) == jtp.to_plain(want["cfg"]) == {"seed": 1, "lr": [5e-4]}
    assert got["extra_state"]["val_loss"] == want["extra_state"]["val_loss"] == 1.25
    assert list(got["extra_state"]["best"]) == want["extra_state"]["best"] == [2.5]
    assert_trees_bit_equal(got["model"], want["model"])
    assert ttp.load_checkpoint_numpy(path)["optimizer_history"][0]["num_updates"] == 10


def test_legacy_file_goes_through_weights_only_load(tmp_path):
    sd = {"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16)}
    torch.save({"model": sd, "args": argparse.Namespace(a=1)}, tmp_path / "legacy.pt",
               _use_new_zipfile_serialization=False)
    with pytest.raises(ttp.LegacyFormatError):
        ttp.load(tmp_path / "legacy.pt")
    blob = ttp.load_checkpoint_numpy(tmp_path / "legacy.pt")
    np.testing.assert_array_equal(blob["model"]["w"], np.arange(6.0, dtype=np.float32).reshape(2, 3))
    torch.save({"model": sd, "cfg": FairseqConfigStandIn(a=1)}, tmp_path / "legacy2.pt",
               _use_new_zipfile_serialization=False)
    with pytest.raises(Exception, match="(?i)weights.only|unsupported global"):
        ttp.load_checkpoint_numpy(tmp_path / "legacy2.pt")


def write_crafted_pt(path, offset, size, stride, numel=4):
    """A zip-format .pt whose one tensor is the view (offset, size,
    stride) of a float storage of ``numel`` elements, pickled by hand so
    the view need not be one torch would write."""
    import collections
    import io
    import pickle
    import zipfile

    storage = object()

    class View:
        def __reduce__(self):
            return (torch._utils._rebuild_tensor_v2,
                    (storage, offset, size, stride, False, collections.OrderedDict()))

    class Pickler(pickle.Pickler):
        def persistent_id(self, obj):
            if obj is storage:
                return ("storage", torch.FloatStorage, "0", "cpu", numel)
            return None

    buf = io.BytesIO()
    Pickler(buf, protocol=2).dump({"w": View()})
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", buf.getvalue())
        zf.writestr("archive/data/0", np.arange(numel, dtype=np.float32).tobytes())
    return path


@pytest.mark.parametrize("offset,size,stride,want", [
    (1, (3,), (1,), [1.0, 2.0, 3.0]),
    (0, (2, 2), (1, 2), [[0.0, 2.0], [1.0, 3.0]]),
    (3, (), (), 3.0),
    (4, (0,), (1,), []),
    (0, (2,), (4,), None),
    (2, (3,), (1,), None),
    (0, (2, 2), (2, 2), None),
    (0, (2,), (-1,), None),
    (-1, (1,), (1,), None),
    (4, (), (), None),
    (5, (0,), (1,), None),
    (0, (2,), (1, 1), None),
], ids=["offset", "transposed", "scalar", "empty-at-end", "stride-past-end",
        "offset-past-end", "rows-past-end", "negative-stride", "negative-offset",
        "scalar-past-end", "empty-past-end", "rank-mismatch"])
def test_restricted_reader_refuses_views_outside_the_storage(tmp_path, offset, size, stride,
                                                             want):
    """A tensor view that reads past its storage is refused before any
    memory is read; views inside it read as torch would."""
    import pickle

    path = write_crafted_pt(tmp_path / "c.pt", offset, size, stride)
    if want is None:
        with pytest.raises(pickle.UnpicklingError):
            ttp.load(path)
    else:
        got = ttp.load(path)["w"]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32).reshape(size))
        ref = torch.as_strided(torch.arange(4.0), size, stride, offset).numpy()
        np.testing.assert_array_equal(got, ref)


def test_flagship_converter_bit_equal_to_jax_and_logits_match(tmp_path):
    cfg, model = port_flagship()
    path, jax_path = save_fairseq(tmp_path / "checkpoint_best.pt", fairseq_flagship_state(model))
    got = tfc.convert_mm_s2ut_checkpoint(path)
    want = jfc.convert_mm_s2ut_checkpoint(jax_path)
    assert_trees_bit_equal(got, want)
    # The tree is the model's own parameters, leaf for leaf.
    assert_trees_bit_equal(got["params"], unflatten(to_flax(model)))

    loaded = TS2UT(cfg)
    loaded.load_state_dict(from_flax(got, loaded))
    loaded.eval()
    rng = np.random.RandomState(1)
    B, T, Tt = 2, 37, 6
    feats = (0.5 * rng.randn(B, T, 80)).astype(np.float32)
    img = rng.randn(B, 7, IMG_D).astype(np.float32)
    tokens = rng.randint(0, V, (B, Tt)).astype(np.int32)
    jmodel = JS2UT(JModelCfg(**MODEL, multimodal=JMMCfg(**MM)))
    jout = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, want), jnp.asarray(feats),
                        jnp.full((B,), T, jnp.int32), jnp.asarray(tokens),
                        imgs_list=(jnp.asarray(img),), img_masks_list=(jnp.zeros((B, 7), bool),),
                        deterministic=True)
    jlogits = np.asarray(jout["logits"] if isinstance(jout, dict) else jout)
    with torch.no_grad():
        tlogits = loaded(torch.from_numpy(feats), torch.full((B,), T), torch.from_numpy(tokens).long(),
                         [torch.from_numpy(img)], [torch.zeros(B, 7, dtype=torch.bool)])["logits"]
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=1e-4, rtol=0)


def test_flagship_converter_strict_and_untied_rules_match_jax(tmp_path):
    _, model = port_flagship()
    sd = fairseq_flagship_state(model)
    sd["encoder.mystery_module.weight"] = torch.zeros(3, 3)
    files = save_fairseq(tmp_path / "unknown.pt", sd)
    for fc, path in zip((tfc, jfc), files):
        with pytest.raises(ValueError, match=r"unmapped fairseq keys: \['encoder.mystery_module"):
            fc.convert_mm_s2ut_checkpoint(path)
    assert_trees_bit_equal(tfc.convert_mm_s2ut_checkpoint(files[0], strict=False),
                           jfc.convert_mm_s2ut_checkpoint(files[1], strict=False))
    sd = fairseq_flagship_state(model)
    sd["decoder.output_projection.weight"] = torch.randn(V, D)
    files = save_fairseq(tmp_path / "untied.pt", sd)
    for fc, path in zip((tfc, jfc), files):
        with pytest.raises(ValueError, match="not tied"):
            fc.convert_mm_s2ut_checkpoint(path)
    sd = fairseq_flagship_state(model)
    sd["encoder.gate_denses.1.weight"] = torch.zeros(D, 2 * D)
    files = save_fairseq(tmp_path / "gates.pt", sd)
    for fc, path in zip((tfc, jfc), files):
        with pytest.raises(ValueError, match="gate/attention count mismatch"):
            fc.convert_mm_s2ut_checkpoint(path)


def fairseq_hubert_checkpoint(path, seed=0, cfg_blob=None):
    """A random HuBERT written in fairseq's names (``chip_smoke.
    fairseq_hubert_state``), the model cfg as a dict by default."""
    w2v_cfg = Wav2Vec2Config(**W2V)
    model = random_(Wav2Vec2Model(w2v_cfg), seed)
    sd = fairseq_hubert_state(model)
    sd["encoder.pos_conv.0.weight_v"] *= 1.5  # v need not have g's norm
    if cfg_blob is None:
        cfg_blob = {"model": {"encoder_embed_dim": 32, "encoder_attention_heads": 2,
                              "encoder_ffn_embed_dim": 48,
                              "conv_feature_layers": "[(16, 10, 5)] + [(16, 3, 2)] * 1",
                              "extractor_mode": "default", "layer_norm_first": False,
                              "conv_pos": 16, "conv_pos_groups": 4}}
    return w2v_cfg, model, save_fairseq(path, sd, cfg_blob=cfg_blob)


@pytest.mark.parametrize("cfg_kind", ["dict", "namespace", "stub"])
def test_hubert_converter_bit_equal_to_jax_and_states_match(tmp_path, cfg_kind):
    model_cfg = {"encoder_embed_dim": 32, "encoder_attention_heads": 2,
                 "encoder_ffn_embed_dim": 48,
                 "conv_feature_layers": "[(16, 10, 5)] + [(16, 3, 2)] * 1",
                 "extractor_mode": "default", "layer_norm_first": False, "conv_pos": 16,
                 "conv_pos_groups": 4}
    blob = {"dict": {"model": model_cfg},
            "namespace": argparse.Namespace(**model_cfg),
            "stub": FairseqConfigStandIn(model=FairseqConfigStandIn(**model_cfg))}[cfg_kind]
    w2v_cfg, _, (path, jax_path) = fairseq_hubert_checkpoint(tmp_path / "mhubert.pt",
                                                              cfg_blob=blob)
    tcfg, got = tfc.convert_fairseq_hubert(path)
    jcfg, want = jfc.convert_fairseq_hubert(jax_path)
    assert_trees_bit_equal(got, want)
    fields = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
              "conv_dim", "conv_kernel", "conv_stride", "conv_bias", "feat_extract_norm",
              "do_stable_layer_norm", "num_conv_pos_embeddings", "num_conv_pos_embedding_groups")
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(w2v_cfg, f) for f in fields}

    model = Wav2Vec2Model(dataclasses.replace(tcfg, hidden_dropout=0.0, attention_dropout=0.0))
    model.load_state_dict(from_flax(got, model))
    rng = np.random.RandomState(2)
    wav = (0.1 * rng.randn(2, 1600)).astype(np.float32)
    lens = np.array([1600, 1100], np.int32)
    wav[1, 1100:] = 0.0
    with torch.no_grad():
        tout = model.eval()(torch.from_numpy(wav), torch.from_numpy(lens).long())
    jout = JW2VModel(jcfg).apply(jax.tree_util.tree_map(jnp.asarray, want), jnp.asarray(wav),
                                 jnp.asarray(lens), deterministic=True)
    for layer in (0, 1, 2):
        np.testing.assert_allclose(tout["hidden_states"][layer].numpy(),
                                   np.asarray(jout["hidden_states"][layer]), atol=1e-4, rtol=0)


def test_parse_conv_feature_layers_walks_literals_only():
    spec = "[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2"
    assert tfc._parse_conv_feature_layers(spec) == jfc._parse_conv_feature_layers(spec)
    for bad in ("__import__('os').system('true')", "[(1, 2)]", "[(1, 2, 3)] - [(1, 2, 3)]"):
        with pytest.raises(ValueError):
            tfc._parse_conv_feature_layers(bad)


def _save_run_yaml(path, model_kw=None):
    from mm_s2ut_torch.config import Config, save_yaml

    model = tconfig.ModelConfig(**{**MODEL, **(model_kw or {})},
                                multimodal=tconfig.MultimodalConfig(**MM))
    save_yaml(Config(model=model), path)


def test_cli_convert_checkpoint_writes_a_loadable_dir(tmp_path):
    from mm_s2ut_torch.cli.convert_checkpoint import main
    from mm_s2ut_torch.inference import load_model

    cfg, model = port_flagship(seed=3)
    save_fairseq(tmp_path / "c.pt", fairseq_flagship_state(model))
    _save_run_yaml(tmp_path / "run.yaml")
    assert main(["--kind", "mm_s2ut", "--fairseq-ckpt", str(tmp_path / "c.pt"),
                 "--config", str(tmp_path / "run.yaml"), "--out", str(tmp_path / "model")]) == 0
    _, loaded = load_model(str(tmp_path / "model"), torch.device("cpu"))
    want = to_flax(model)
    got = to_flax(loaded)
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    # A yaml of another geometry fails at conversion, not at the first decode.
    _save_run_yaml(tmp_path / "wide.yaml", {"encoder_ffn_embed_dim": 64})
    with pytest.raises(ValueError, match="do not match the architecture"):
        main(["--kind", "mm_s2ut", "--fairseq-ckpt", str(tmp_path / "c.pt"),
              "--config", str(tmp_path / "wide.yaml"), "--out", str(tmp_path / "bad")])
    # Unknown keys: strict raises, --no-strict converts.
    sd = fairseq_flagship_state(model)
    sd["encoder.mystery_module.weight"] = torch.zeros(3, 3)
    save_fairseq(tmp_path / "u.pt", sd)
    args = ["--kind", "mm_s2ut", "--fairseq-ckpt", str(tmp_path / "u.pt"),
            "--config", str(tmp_path / "run.yaml"), "--out", str(tmp_path / "u")]
    with pytest.raises(ValueError, match="unmapped"):
        main(args)
    assert main(args + ["--no-strict"]) == 0


def test_cli_convert_hubert_feeds_the_encoder_loader(tmp_path):
    from mm_s2ut_torch.cli.convert_checkpoint import main
    from mm_s2ut_torch.cli.prep_data import load_encoder

    w2v_cfg, model, _ = fairseq_hubert_checkpoint(tmp_path / "mhubert.pt")
    assert main(["--kind", "hubert", "--fairseq-ckpt", str(tmp_path / "mhubert.pt"),
                 "--out", str(tmp_path / "hub")]) == 0
    with np.load(tmp_path / "hub" / "params.npz") as z:
        assert all(k.startswith("speech_encoder/") for k in z.files)
    assert json.loads((tmp_path / "hub" / "config.json").read_text())["hidden_size"] == 32
    cfg, loaded = load_encoder(tmp_path / "hub")
    assert cfg.conv_stride == w2v_cfg.conv_stride and cfg.num_hidden_layers == 2
    _, want = tfc.convert_fairseq_hubert(tmp_path / "mhubert.pt")
    got = to_flax(loaded)
    want = flatten(want["params"])
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)


def test_average_checkpoints_matches_jax(tmp_path, monkeypatch):
    from mm_s2ut.utils import checkpoint as jckpt
    from mm_s2ut_torch.utils.checkpoint import average_checkpoints

    flats = []
    for i in range(3):
        flat = to_flax(port_flagship(seed=10 + i)[1])
        (tmp_path / f"c{i}").mkdir()
        np.savez(tmp_path / f"c{i}" / "params.npz", **flat)
        flats.append(flat)
    got = average_checkpoints([tmp_path / f"c{i}" for i in range(3)])
    trees = {str(tmp_path / f"c{i}"): unflatten(flats[i]) for i in range(3)}
    monkeypatch.setattr(jckpt, "restore_params", lambda d, s=None: trees[str(d)])
    want = flatten(jax.tree_util.tree_map(np.asarray, jckpt.average_checkpoints(list(trees))))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.savez(tmp_path / "c2" / "params.npz", **{k: v for k, v in flats[2].items()
                                               if not k.startswith("decoder/")})
    with pytest.raises(ValueError, match="does not hold"):
        average_checkpoints([tmp_path / "c0", tmp_path / "c2"])
