"""The port's ``eval`` package against the JAX package's:

* ``text_cleaner``, ``wer``, ``mfcc``, ``dtw`` and the MCD statistics are
  copies of numpy code: equal to JAX's exactly on seeded inputs;
* the port computes BLEU itself (the card's machine has no sacrebleu):
  equal to ``sacrebleu.corpus_bleu`` within 1e-9 on 50 seeded sentence
  pairs with punctuation, numbers, symbols and case, and on the edge
  cases (no match at an order, an empty hypothesis, a longer system);
  the ASR-BLEU surface (cleaning, id alignment, files) against JAX's;
* ``CTCTranscriber`` on a random HF ``Wav2Vec2ForCTC`` checkpoint: JAX's
  transcripts, and the CLIs' files.
"""
import json

import numpy as np
import pytest
import sacrebleu
import torch

from mm_s2ut.eval import asr as j_asr
from mm_s2ut.eval import bleu as j_bleu
from mm_s2ut.eval import mcd as j_mcd
from mm_s2ut.eval import text_cleaner as j_clean
from mm_s2ut.eval import wer as j_wer
from mm_s2ut_torch.eval import asr as t_asr
from mm_s2ut_torch.eval import bleu as t_bleu
from mm_s2ut_torch.eval import mcd as t_mcd
from mm_s2ut_torch.eval import text_cleaner as t_clean
from mm_s2ut_torch.eval import wer as t_wer

torch.set_num_threads(1)
WORDS = ["the", "cat", "sat", "on", "a", "mat", "Dr.", "Mr.", "St.", "3", "42", "1,000",
         "3.14", "$5", "1999", "co-op", "it's", "e.g.", "(x)", "naïve", "café", "&", "<tag>",
         "hello,", "world.", "yes!", "no?", "15th", "-", "50%", "A", "B", "c", "\"q\"", "x/y"]


def _sentences(n, seed):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(1, 14))) for _ in range(n)]


def test_text_cleaner_equals_jax():
    for s in _sentences(50, 0) + ["Mrs. Smith paid $3.50 for 2nd place in 1984!",
                                  "  Œuvre   —  Straße  ", ""]:
        assert t_clean.english_cleaners(s) == j_clean.english_cleaners(s), s
        assert t_clean.convert_to_ascii(s) == j_clean.convert_to_ascii(s), s


def test_wer_equals_jax():
    refs, hyps = _sentences(30, 1), _sentences(30, 2)
    hyps[3] = ""
    assert t_wer.compute_wer(refs, hyps) == j_wer.compute_wer(refs, hyps)
    for r, h in zip(refs, hyps):
        assert t_wer.edit_ops(r.split(), h.split()) == j_wer.edit_ops(r.split(), h.split())


def _waves(seed):
    rng = np.random.RandomState(seed)
    t = np.arange(rng.randint(2000, 9000)) / 16000
    a = (np.sin(2 * np.pi * 220 * t) + 0.3 * rng.randn(len(t))).astype(np.float32)
    b = (np.sin(2 * np.pi * 330 * t[: rng.randint(500, len(t))])).astype(np.float32)
    return a, b


def test_mfcc_dtw_and_mcd_equal_jax():
    for seed in range(3):
        a, b = _waves(seed)
        np.testing.assert_array_equal(t_mcd.mfcc(a), j_mcd.mfcc(a))
        dist = np.abs(np.random.RandomState(seed).randn(7 + seed, 5 + 2 * seed))
        got, want = t_mcd.dtw(dist), j_mcd.dtw(dist)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert t_mcd.mel_cepstral_distortion(a, b) == j_mcd.mel_cepstral_distortion(a, b)
    pairs = [_waves(s) for s in range(4)]
    logs_t = [t_mcd.batch_mel_cepstral_distortion(*zip(*pairs[:2])),
              t_mcd.batch_mel_cepstral_distortion(*zip(*pairs[2:]))]
    logs_j = [j_mcd.batch_mel_cepstral_distortion(*zip(*pairs[:2])),
              j_mcd.batch_mel_cepstral_distortion(*zip(*pairs[2:]))]
    assert logs_t == logs_j
    assert t_mcd.reduce_inference_metrics(logs_t) == j_mcd.reduce_inference_metrics(logs_j)
    assert t_mcd.mel_cepstral_distortion(pairs[0][0], pairs[0][0])["mcd_loss"] == 0.0


@pytest.mark.parametrize("case", ["seeded", "no_4gram", "empty_hyp", "long_hyp", "no_match"])
def test_bleu_equals_sacrebleu(case):
    refs = _sentences(50, 3)
    hyps = {
        "seeded": [r if i % 4 == 0 else h for i, (r, h) in enumerate(zip(refs, _sentences(50, 4)))],
        "no_4gram": ["the cat sat", "a mat on"],
        "empty_hyp": ["", "the cat"],
        "long_hyp": [r + " extra words here ." for r in refs],
        "no_match": ["zzz yyy", "qqq"],
    }[case]
    refs = refs[:len(hyps)] if case in ("seeded", "long_hyp") else ["the cat sat on", "a mat"]
    got = t_bleu.corpus_bleu(hyps, refs)
    want = sacrebleu.corpus_bleu(hyps, [refs])
    assert abs(got.score - want.score) <= 1e-9, (got.score, want.score)
    assert got.counts == list(want.counts) and got.totals == list(want.totals)
    assert (got.sys_len, got.ref_len) == (want.sys_len, want.ref_len)
    assert abs(got.bp - want.bp) <= 1e-12
    assert str(got) == want.format(), (str(got), want.format())
    for h in hyps:
        assert t_bleu.tokenize_13a(h) == sacrebleu.tokenizers.tokenizer_13a.Tokenizer13a()(h)


def test_asr_bleu_surface_matches_jax(tmp_path):
    from mm_s2ut.data.manifest import ManifestRow, write_manifest

    refs, hyps = _sentences(6, 5), _sentences(6, 6)
    (tmp_path / "ref.txt").write_text("\n".join(refs) + "\n")
    (tmp_path / "hyp.txt").write_text("\n".join(hyps) + "\n")
    order = [3, 1, 6, 2, 5, 4]
    write_manifest(tmp_path / "test.tsv", [ManifestRow(str(i), f"{k}.wav", 100, "x", 1)
                                           for i, k in enumerate(order)])
    for manifest in (None, tmp_path / "test.tsv"):
        got = t_bleu.score_from_files(tmp_path / "hyp.txt", tmp_path / "ref.txt", manifest)
        want = j_bleu.score_from_files(tmp_path / "hyp.txt", tmp_path / "ref.txt", manifest)
        assert abs(got.score - want.score) <= 1e-9
    assert t_bleu.align_refs_by_id(refs, order) == j_bleu.align_refs_by_id(refs, order)
    assert [t_bleu.clean_line(r) for r in refs] == [j_bleu.clean_line(r) for r in refs]


@pytest.fixture(scope="module")
def ctc_dir(tmp_path_factory):
    """A random HF Wav2Vec2ForCTC saved with its vocab.json (a letter
    vocabulary with <pad> as the blank and | as the word delimiter)."""
    transformers = pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("ctc")
    vocab = ["<pad>", "<s>", "</s>", "<unk>", "|"] + list("etaoinshrdlu")
    cfg = transformers.Wav2Vec2Config(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=48, conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3),
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4, do_stable_layer_norm=False,
        feat_extract_norm="group", hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(0)
    model = transformers.Wav2Vec2ForCTC(cfg).eval()
    with torch.no_grad():
        model.lm_head.weight.mul_(20.0)  # decisive argmaxes: transcripts with many letters
    model.save_pretrained(root, safe_serialization=False)
    (root / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    return root


def test_ctc_transcriber_matches_jax(ctc_dir, tmp_path):
    from mm_s2ut.data.audio_io import write_wav

    rng = np.random.RandomState(7)
    lens = [3200, 4100, 2500]
    wavs = np.zeros((3, max(lens)), np.float32)
    for i, n in enumerate(lens):
        wavs[i, :n] = 0.5 * rng.randn(n)
    want = j_asr.CTCTranscriber(str(ctc_dir)).transcribe_batch(wavs, np.array(lens, np.int32))
    got = t_asr.CTCTranscriber(ctc_dir, torch.device("cpu")).transcribe_batch(wavs, lens)
    assert got == want and any(len(t) > 3 for t in got), got
    # The CLI over a directory, sorted by the leading number of the names.
    for i, n in enumerate(lens):
        write_wav(tmp_path / f"{[10, 2, 1][i]}_pred.wav", wavs[i, :n], 16000)
    out = tmp_path / "asr.txt"
    t_asr.main(["--wav_dir", str(tmp_path), "--output", str(out), "--asr_model", str(ctc_dir),
                "--device", "cpu"])
    j_out = tmp_path / "asr_jax.txt"
    j_asr.generate_transcription(tmp_path, j_out, str(ctc_dir))
    assert out.read_text() == j_out.read_text() and len(out.read_text().splitlines()) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_asr.main(["--wav_dir", str(tmp_path), "--output", str(out), "--asr_model",
                        str(ctc_dir)])


def test_eval_clis_write_what_jax_writes(tmp_path, capsys):
    refs, hyps = _sentences(8, 8), _sentences(8, 9)
    (tmp_path / "r.txt").write_text("\n".join(refs) + "\n")
    (tmp_path / "h.txt").write_text("\n".join(hyps) + "\n")
    t_bleu.main(["--transcripts", str(tmp_path / "h.txt"), "--references", str(tmp_path / "r.txt")])
    lines = capsys.readouterr().out.splitlines()
    want = j_bleu.score_from_files(tmp_path / "h.txt", tmp_path / "r.txt")
    assert lines == [f"BLEU Score: {want.score:.1f}", want.format()]
    import sys

    argv = sys.argv
    try:
        sys.argv = ["wer", "--references", str(tmp_path / "r.txt"), "--predictions",
                    str(tmp_path / "h.txt")]
        t_wer.main()
        got = capsys.readouterr().out
        j_wer.main()
        assert got == capsys.readouterr().out
    finally:
        sys.argv = argv
