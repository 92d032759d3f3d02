"""The port's textless tools against the JAX package's CLIs on the same
files: ``cli.prep_data`` (manifest, quantize through a tiny HF HuBERT
and k-means centroids, prep-s2ut), ``cli.vocode``,
``hifigan.vocode_bucketed`` and ``cli.inference_all`` in both modes.

Tolerances: quantize's units are equal except at near-ties (the two
nearest centroids within 1e-5 relative, on the port's features); vocoded
waveforms within 1e-4 (fp32 convs summed in different orders), read back
from 16-bit PCM; every other file is equal. JAX's checkpoint loader is
monkeypatched to the parameters the port reads from ``params.npz``, as
``tests/test_torch_xm.py`` does for ``cli.generate``; ``MM_PARITY_CANARY``
must lower the BLEU of both packages' chains."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mm_s2ut_torch.data.audio_io import get_waveform, write_wav
from tests.test_torch_kmeans import near_tie_rows

torch.set_num_threads(1)
transformers = pytest.importorskip("transformers")

SR = 16000
HUBERT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=48,
              conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
              do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False,
              hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
              feat_proj_dropout=0.0, layerdrop=0.0)


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    """Six wavs of 0.2-0.7 s in a nested dir, a tiny HF HuBERT dir and 20
    centroids of its width."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.RandomState(0)
    (root / "wavs" / "sub").mkdir(parents=True)
    for i in range(6):
        n = 3200 + 1600 * ((i * 5) % 6)
        where = root / "wavs" / ("sub" if i % 2 else "") / f"{i + 1}.wav"
        write_wav(where, (0.3 * rng.randn(n)).astype(np.float32), SR)
    torch.manual_seed(0)
    transformers.HubertModel(transformers.HubertConfig(**HUBERT)).eval().save_pretrained(
        root / "hubert", safe_serialization=False)
    np.save(root / "km.npy", rng.randn(20, 32).astype(np.float32))
    return root


def _both(argv_jax, argv_port):
    from mm_s2ut.cli.prep_data import main as j_main
    from mm_s2ut_torch.cli.prep_data import main as t_main

    assert j_main(argv_jax) == 0
    assert t_main(argv_port) == 0


def test_manifest_equals_jax(audio, tmp_path):
    _both(["manifest", "--root", str(audio / "wavs"), "--dest", str(tmp_path / "j.tsv")],
          ["manifest", "--root", str(audio / "wavs"), "--dest", str(tmp_path / "t.tsv")])
    got = (tmp_path / "t.tsv").read_text()
    assert got == (tmp_path / "j.tsv").read_text() and len(got.splitlines()) == 7


@pytest.mark.parametrize("dedup", [False, True])
def test_quantize_equals_jax_but_near_ties(audio, tmp_path, dedup):
    from mm_s2ut_torch.cli.prep_data import load_encoder, padded, read_manifest_entries
    from mm_s2ut_torch.cli.prep_data import main as t_main

    t_main(["manifest", "--root", str(audio / "wavs"), "--dest", str(tmp_path / "src.tsv")])
    common = ["quantize", "--manifest", str(tmp_path / "src.tsv"), "--hubert-model",
              str(audio / "hubert"), "--km-path", str(audio / "km.npy"), "--layer", "2",
              "--batch-size", "4", *(["--dedup"] if dedup else [])]
    _both(common + ["--dest", str(tmp_path / "j.txt")],
          common + ["--dest", str(tmp_path / "t.txt"), "--device", "cpu"])
    got = (tmp_path / "t.txt").read_text().splitlines()
    want = (tmp_path / "j.txt").read_text().splitlines()
    assert len(got) == len(want) == 6
    if got == want:
        return
    assert not dedup or len(got) == len(want)
    # Differing units must sit on near-ties of the port's own features.
    cfg, model = load_encoder(audio / "hubert")
    root, entries = read_manifest_entries(tmp_path / "src.tsv")
    c = np.load(audio / "km.npy")
    for start in range(0, 6, 4):
        wavs = [get_waveform(str(root / e[0]))[0] for e in entries[start:start + 4]]
        batch, lens = padded(wavs)
        with torch.no_grad():
            feats = model(torch.from_numpy(batch), torch.from_numpy(lens))["hidden_states"][2]
        for i in range(len(wavs)):
            g = np.array(got[start + i].split(), int)
            w = np.array(want[start + i].split(), int)
            x = feats[i, : cfg.feature_lengths(int(lens[i]))].numpy()
            assert len(g) == len(w) == len(x)
            assert near_tie_rows(x, c)[g != w].all()


def test_prep_s2ut_equals_jax(audio, tmp_path):
    from mm_s2ut_torch.cli.prep_data import main as t_main

    t_main(["manifest", "--root", str(audio / "wavs"), "--dest", str(tmp_path / "src.tsv")])
    rng = np.random.RandomState(1)
    (tmp_path / "units.txt").write_text("".join(
        " ".join(map(str, rng.randint(0, 5, 12))) + "\n" for _ in range(6)))
    for reduce in ([], ["--reduce-unit"]):
        common = ["prep-s2ut", "--src-manifest", str(tmp_path / "src.tsv"), "--tgt-units",
                  str(tmp_path / "units.txt"), "--split", "train", "--src-lang", "en",
                  "--tgt-lang", "de", *reduce]
        _both(common + ["--output-root", str(tmp_path / "j")],
              common + ["--output-root", str(tmp_path / "t")])
        assert (tmp_path / "t" / "train.tsv").read_text() == \
            (tmp_path / "j" / "train.tsv").read_text()
    (tmp_path / "short.txt").write_text("1 2\n")
    with pytest.raises(ValueError, match="6 audios vs 1 unit lines"):
        t_main(["prep-s2ut", "--src-manifest", str(tmp_path / "src.tsv"), "--tgt-units",
                str(tmp_path / "short.txt"), "--split", "x", "--output-root", str(tmp_path)])


# ------------------------------------------------------------------ vocoder

def _vocoder_files(root, num_embeddings=50, seed=0):
    """A random CodeHiFiGAN (tests/test_hifigan.py's SMALL geometry, duration
    prediction on) written as a fairseq checkpoint and config.json; returns
    the port's model."""
    from chip_smoke import fairseq_vocoder_state
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig
    from tests.test_hifigan import SMALL

    cfg = HiFiGANConfig(**{**SMALL.__dict__, "num_embeddings": num_embeddings})
    model = CodeHiFiGAN(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(0.5 * torch.randn(p.shape, generator=g))
        model.dur_predictor.proj.bias.fill_(1.0)  # durations of a few frames
    torch.save({"generator": fairseq_vocoder_state(model)}, root / "vocoder.pt")
    raw = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(cfg).items()}
    raw["resblock_dilation_sizes"] = [list(d) for d in cfg.resblock_dilation_sizes]
    (root / "vocoder.json").write_text(json.dumps(raw))
    return model.eval()


@pytest.mark.parametrize("dur", [True, False])
def test_cli_vocode_matches_jax(tmp_path, dur):
    from mm_s2ut.cli.vocode import main as j_main
    from mm_s2ut_torch.cli.vocode import main as t_main

    _vocoder_files(tmp_path)
    rng = np.random.RandomState(2)
    lines = [" ".join(map(str, rng.randint(0, 50, n))) for n in (7, 3, 12, 0, 5)]
    (tmp_path / "test.unit").write_text("\n".join(lines) + "\n")
    common = ["--in-code-file", str(tmp_path / "test.unit"), "--vocoder",
              str(tmp_path / "vocoder.pt"), "--vocoder-cfg", str(tmp_path / "vocoder.json"),
              "--batch-size", "2", *(["--dur-prediction"] if dur else [])]
    assert j_main(common + ["--results-path", str(tmp_path / "j")]) == 0
    assert t_main(common + ["--results-path", str(tmp_path / "t"), "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "j").glob("*.wav"))
    assert names == sorted(p.name for p in (tmp_path / "t").glob("*.wav")) == \
        [f"{i}_pred.wav" for i in range(5)]
    for name in names:
        got, _ = get_waveform(str(tmp_path / "t" / name))
        want, _ = get_waveform(str(tmp_path / "j" / name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
    assert len(get_waveform(str(tmp_path / "t" / "3_pred.wav"))[0]) == SR // 10  # empty line


def test_vocode_bucketed_matches_jax(tmp_path):
    """A batch for each bucket (the first needs exactly its budget) and one
    past the largest, which is cut there as a fixed budget cuts it."""
    import jax.numpy as jnp

    from mm_s2ut.models.hifigan import HiFiGANConfig as JCfg
    from mm_s2ut.models.hifigan import load_fairseq_checkpoint as j_load
    from mm_s2ut.models.hifigan import vocode_bucketed as j_bucketed
    from mm_s2ut_torch.models.hifigan import vocode_bucketed

    model = _vocoder_files(tmp_path)
    jcfg = JCfg.from_json(tmp_path / "vocoder.json")
    params = j_load(tmp_path / "vocoder.pt", jcfg)
    rng = np.random.RandomState(3)
    batches = []
    for L in (3, 8, 16, 40):
        units = rng.randint(0, 50, (2, L)).astype(np.int32)
        lens = np.array([L, max(1, L - 2)], np.int32)
        need = int(model.unit_durations(torch.from_numpy(units).long(),
                                        torch.from_numpy(lens).long()).sum(1).max())
        batches.append((units, lens, need))
    needs = [n for *_, n in batches]
    assert needs == sorted(needs) and len(set(needs)) == 4, needs
    buckets = (needs[0], needs[1] + 1, needs[2])
    hop = jcfg.hop_length
    for units, lens, need in batches:
        got_w, got_n = vocode_bucketed(model, torch.from_numpy(units).long(),
                                       torch.from_numpy(lens).long(), buckets=buckets)
        want_w, want_n = j_bucketed(jcfg, params, jnp.asarray(units), jnp.asarray(lens),
                                    buckets=buckets)
        assert got_w.shape == (2, buckets[-1] * hop) == np.asarray(want_w).shape
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        assert int(got_n.max()) == min(need, buckets[-1]) * hop
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-4)


# ------------------------------------------------------------- inference_all

@pytest.fixture(scope="module")
def asr_dir(tmp_path_factory):
    """A random HF Wav2Vec2ForCTC with decisive argmaxes (a letter
    vocabulary, <pad> the blank, | the word delimiter)."""
    root = tmp_path_factory.mktemp("asr")
    vocab = ["<pad>", "<s>", "</s>", "<unk>", "|"] + list("etaoinshrdlu")
    cfg = transformers.Wav2Vec2Config(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=48, conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3),
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4, hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(1)
    model = transformers.Wav2Vec2ForCTC(cfg).eval()
    with torch.no_grad():
        model.lm_head.weight.mul_(20.0)
        # The word delimiter wins about a third of the frames of a
        # saturated wave (what the random vocoder gives), so transcripts
        # have several words and an identical corpus scores BLEU 100.
        wave = torch.sign(torch.randn(4, 8000, generator=torch.Generator().manual_seed(2)))
        logits = model(wave).logits.reshape(-1, len(vocab))
        gap = logits.max(-1).values - logits[:, vocab.index("|")]
        model.lm_head.bias[vocab.index("|")] += torch.quantile(gap, 0.35)
    model.save_pretrained(root, safe_serialization=False)
    (root / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    return root


def _s2s_checkpoint(root):
    """A small S2S corpus (4 wavs, 16-d image features, 50 units) and an
    exported fp32 model with sharpened logits; (JAX model, params, dir)."""
    from mm_s2ut.config import Config, DataConfig, GenerationConfig, ModelConfig
    from mm_s2ut.config import MultimodalConfig, save_yaml
    from mm_s2ut.data.manifest import ManifestRow, write_manifest
    from mm_s2ut.models.mm_s2ut import MMS2UTModel
    from scripts.export_jax_params import flatten_params

    rng = np.random.RandomState(5)
    (root / "img_feat").mkdir(parents=True)
    np.save(root / "img_feat" / "test.npy", rng.randn(4, 6, 16).astype(np.float32))
    rows = []
    for i in range(4):
        n = SR // 4 + i * SR // 8
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), SR)
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, "1 2 3", 3))
    write_manifest(root / "test.tsv", rows)
    mcfg = ModelConfig(
        encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
        decoder_layers=1, decoder_attention_heads=2, conv_channels=16, dtype="float32",
        multimodal=MultimodalConfig(image_feat_path=[str(root / "img_feat")], image_feat_dim=[16],
                                    multimodal_attention_type="selective_attention"))
    cfg = Config(model=mcfg, data=DataConfig(data_root=str(root), audio_root=str(root),
                                             target_code_size=50, max_tokens=400, num_buckets=1),
                 generation=GenerationConfig(beam=3, max_len_a=0.0, max_len_b=10))
    mcfg.vocab_size = 54
    jmodel = MMS2UTModel(mcfg)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), rng.randn(1, 40, 80).astype(np.float32), np.array([40]),
        np.zeros((1, 3), np.int32), (np.zeros((1, 6, 16), np.float32),),
        (np.zeros((1, 6), bool),)))
    norm = params["params"]["decoder"]["final_norm"]
    norm["scale"], norm["bias"] = norm["scale"] * 8.0, norm["bias"] * 8.0
    model_dir = root / "model"
    model_dir.mkdir()
    save_yaml(cfg, model_dir / "config.yaml")
    np.savez(model_dir / "params.npz", **flatten_params(params["params"]))
    return jmodel, params, model_dir


def _run_both(monkeypatch, jmodel, params_of, argv, canary=""):
    import mm_s2ut.inference as j_inference
    from mm_s2ut.cli.inference_all import main as j_main
    from mm_s2ut.config import load_config
    from mm_s2ut_torch.cli.inference_all import main as t_main

    monkeypatch.setattr(j_inference, "load_checkpoint", lambda path: (
        load_config(f"{path}/config.yaml"), jmodel, params_of[str(path)]))
    monkeypatch.setenv("MM_PARITY_CANARY", canary)
    tag = canary.replace(":", "_") or "clean"
    assert j_main(_with_root(argv, f"j_{tag}")) == 0
    assert t_main(_with_root(argv, f"t_{tag}") + ["--device", "cpu"]) == 0
    return tag


def _with_root(argv, name):
    base = argv[argv.index("--results-root") + 1]
    out = list(argv)
    out[argv.index("--results-root") + 1] = f"{base}/{name}"
    return out


def _bleu(path):
    """(BLEU, unigram precision) of a bleu.txt line."""
    fields = path.read_text().split()
    return float(fields[2]), float(fields[3].split("/")[0])


def test_inference_all_units_mode_matches_jax(tmp_path, monkeypatch, asr_dir):
    jmodel, params, model_dir = _s2s_checkpoint(tmp_path / "data")
    _vocoder_files(tmp_path)
    refs = tmp_path / "refs"
    refs.mkdir()
    (refs / "test.txt").write_text("placeholder\n" * 4)
    argv = ["--model_path", str(model_dir), "--subsets", "test", "--results-root",
            str(tmp_path / "res"), "--vocoder", str(tmp_path / "vocoder.pt"), "--vocoder-cfg",
            str(tmp_path / "vocoder.json"), "--asr-model", str(asr_dir), "--reference-root",
            str(refs), "--beam", "3"]
    params_of = {str(model_dir): params}
    _run_both(monkeypatch, jmodel, params_of, argv)
    t, j = tmp_path / "res" / "t_clean" / "test", tmp_path / "res" / "j_clean" / "test"
    for name in ("test.unit", "transcript.txt", "bleu.txt"):
        assert (t / name).read_text() == (j / name).read_text(), name
    assert sorted(p.name for p in (t / "tts").glob("*.wav")) == \
        sorted(p.name for p in (j / "tts").glob("*.wav")) == [f"{i}_pred.wav" for i in range(4)]
    for g, w in zip((t / "generate-test.txt").read_text().splitlines(),
                    (j / "generate-test.txt").read_text().splitlines()):
        g, w = g.split("\t"), w.split("\t")
        assert g[0] == w[0] and g[-1] == w[-1]
        if len(g) == 3:
            assert abs(float(g[1]) - float(w[1])) <= 1.5e-4
    # References equal to the transcripts score BLEU 100; the canary's
    # shifted units must collapse it in both packages.
    from mm_s2ut_torch.eval.bleu import score_from_files

    (refs / "test.txt").write_text((t / "transcript.txt").read_text())
    assert score_from_files(t / "transcript.txt", refs / "test.txt").score == pytest.approx(100.0)
    _run_both(monkeypatch, jmodel, params_of, argv, canary="offset1:mod50")
    for side in ("t", "j"):
        fault = _bleu(tmp_path / "res" / f"{side}_offset1_mod50" / "test" / "bleu.txt")
        assert fault[0] < 50.0, (side, fault)
    assert (tmp_path / "res" / "t_offset1_mod50" / "test" / "bleu.txt").read_text() == \
        (tmp_path / "res" / "j_offset1_mod50" / "test" / "bleu.txt").read_text()


def test_inference_all_text_mode_matches_jax(tmp_path, monkeypatch):
    from mm_s2ut_torch.cli.inference_all import main as t_main
    from tests.test_torch_ensemble import _xm_checkpoints
    from tests.test_torch_xm import TEXTS

    jmodel, dirs, params_of = _xm_checkpoints(tmp_path, 1)
    refs = tmp_path / "refs"
    refs.mkdir()
    (refs / "test.txt").write_text("".join(t + "\n" for t in TEXTS))
    argv = ["--mode", "text", "--model_path", dirs[0], "--subsets", "test", "--results-root",
            str(tmp_path / "res"), "--reference-root", str(refs), "--beam", "3"]
    _run_both(monkeypatch, jmodel, params_of, argv)
    t, j = tmp_path / "res" / "t_clean" / "test", tmp_path / "res" / "j_clean" / "test"
    for name in ("hyp.txt", "bleu.txt"):
        assert (t / name).read_text() == (j / name).read_text(), name
    hyps = (t / "hyp.txt").read_text()
    assert len(hyps.splitlines()) == len(TEXTS) and hyps.strip()
    (refs / "test.txt").write_text(hyps)
    _run_both(monkeypatch, jmodel, params_of, argv, canary="droptok")
    for side in ("t", "j"):
        # This model's hypotheses are single words, so BLEU is 0 even
        # against themselves; the unigram precision (100 against
        # themselves) shows the canary's damage.
        fault = _bleu(tmp_path / "res" / f"{side}_droptok" / "test" / "bleu.txt")
        assert fault[1] < 50.0, (side, fault)
    # Misaligned references raise, as JAX's do.
    (refs / "test.txt").write_text("only one line\n")
    with pytest.raises(ValueError, match="misaligned"):
        t_main(argv + ["--device", "cpu"])
