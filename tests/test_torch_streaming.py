"""The port's streaming S2ST (``infer/streaming.py``, ``UnitDecoder.prefill``,
prefix-mode ``beam_search``) against its own offline path and the JAX
package, mirroring tests/test_streaming.py at its sizes (32-d, 2 layers).

Tolerances. Streamed encoder rows against the port's offline causal
encoder: fp32 atol 1e-5 (the same arithmetic; the streamed attention
spans the K/V cache, the offline one the utterance). Against JAX's
offline encoder: 1e-4 (test_torch_model.py). Prefill logits and float
cache rows against JAX's prefill: 1e-4; int8 cache bytes equal up to ±1
rounding-tie flips in 0.5% of values (test_torch_quant_model.py). Tokens
are compared exactly, on the reference test's own tiny model (seed 0),
whose hypotheses are not empty and whose prefix-reuse stream commits
units before finalize."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import GenerationConfig as JGenCfg
from mm_s2ut.config import ModelConfig as JModelCfg
from mm_s2ut.config import MultimodalConfig as JMMCfg
from mm_s2ut.infer import streaming as JS
from mm_s2ut.infer.beam_search import tile_state_for_beams as j_tile
from mm_s2ut.infer.generator import UnitGenerator as JGenerator
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
from mm_s2ut.models.s2t_encoder import SpeechTransformerEncoder as JEnc
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.config import GenerationConfig as TGenCfg
from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.infer import streaming as TS
from mm_s2ut_torch.infer.beam_search import beam_search as t_beam_search
from mm_s2ut_torch.infer.beam_search import tile_state_for_beams as t_tile
from mm_s2ut_torch.infer.generator import UnitGenerator as TGenerator
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TModel
from mm_s2ut_torch.models.s2t_encoder import SpeechTransformerEncoder as TEnc
from tests.test_torch_quant_model import _close_bytes

torch.set_num_threads(1)
D, FFN, LAYERS, HEADS, CONV = 32, 64, 2, 2, 16
T, CHUNK, MAXLEN, BEAM = 48, 16, 10, 2


@pytest.mark.parametrize("window,kernels", [(0, (5, 5)), (6, (5, 5)), (0, (3, 3))])
def test_streamed_equals_offline_causal(window, kernels):
    B, Tf = 2, 57
    feats = np.random.RandomState(0).randn(B, Tf, 80).astype(np.float32)
    lengths = np.full((B,), Tf, np.int32)
    kw = dict(embed_dim=D, ffn_dim=FFN, num_layers=LAYERS, num_heads=HEADS, conv_channels=CONV,
              causal_attention=True, attention_window=window, conv_kernel_sizes=kernels)
    jenc = JEnc(**kw)
    params = jax.tree_util.tree_map(np.asarray, jenc.init(jax.random.PRNGKey(0), feats, lengths))
    want_jax = np.asarray(jenc.apply(params, feats, lengths)["encoder_out"])
    tenc = TEnc(**kw)
    tenc.load_state_dict(from_flax(params, tenc))
    tenc.eval()
    with torch.no_grad():
        want = tenc(torch.from_numpy(feats), torch.from_numpy(lengths).long())["encoder_out"]
    want = want.numpy()
    np.testing.assert_allclose(want, want_jax, atol=1e-4)

    sess = TS.StreamingEncoderSession(tenc, batch=B, chunk_frames=CHUNK, max_frames=128)
    emitted = 0
    for start in range(0, Tf, CHUNK):  # full chunks, then a short tail feed
        new = sess.feed(feats[:, start : min(start + CHUNK, Tf)]).numpy()
        np.testing.assert_allclose(new, want[:, emitted : emitted + new.shape[1]], atol=1e-5)
        emitted += new.shape[1]
    got, got_len = sess.finalize()
    assert got_len.tolist() == [want.shape[1]] * B
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-4)


def test_halo_and_commit_rules_match_jax():
    for kernels in [(5, 5), (3, 3), (7, 5), (5, 5, 5)]:
        assert TS.conv_input_halo(kernels) == JS.conv_input_halo(kernels)
        for n in range(0, 60):
            assert TS.mature_subsampled(n, kernels) == JS.mature_subsampled(n, kernels)
    cases = [
        ([1, 2, 3], [1, 2, 3, 4], [1, 2]), ([], [1, 2], []), ([9, 2], [1, 2], []),
        ([7, 8, 9, 4], [7, 8, 9, 4], [1, 2, 3]), ([1, 2], [1, 2], [1, 2]),
        ([1, 2, 3, 5], [1, 2, 3, 6], []),
    ]
    for prev, hyp, committed in cases:
        assert TS.retranslation_commit(prev, hyp, committed) == \
            JS.retranslation_commit(prev, hyp, committed)
    assert TS.retranslation_commit([1, 2, 3], [1, 2, 3, 4], [1, 2]) == [3]
    assert TS.retranslation_commit([7, 8, 9, 4], [7, 8, 9, 4], [1, 2, 3]) == []


@pytest.fixture(scope="module")
def tiny():
    """(jax model, flax params, torch model, feats) of tests/test_streaming.py's
    tiny causal flagship (2 decoder layers)."""
    jcfg = JModelCfg(
        encoder_embed_dim=D, encoder_ffn_embed_dim=FFN, encoder_layers=LAYERS,
        encoder_attention_heads=HEADS, decoder_embed_dim=D, decoder_ffn_embed_dim=FFN,
        decoder_layers=2, decoder_attention_heads=HEADS, conv_channels=CONV, vocab_size=40,
        dtype="float32", encoder_causal_attention=True, use_flash_attention=False,
        multimodal=JMMCfg(multimodal_attention_type=None),
    )
    jmodel = JModel(jcfg)
    feats = np.random.RandomState(0).randn(1, T, 80).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), feats, np.full((1,), T, np.int32),
                         np.zeros((1, 3), np.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = TModel(tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(jcfg)))
    tmodel.load_state_dict(from_flax(params, tmodel))
    return jmodel, params, tmodel.eval(), feats


def _offline_tokens(tmodel, feats):
    gen = TGenerator(tmodel, TGenCfg(beam=BEAM, max_len_a=0.0, max_len_b=MAXLEN))
    return gen.generate(feats, np.full((feats.shape[0],), feats.shape[1], np.int32))[0][0]["tokens"]


def _stream(srv, feats):
    commits = [srv.feed(feats[:, s : s + CHUNK]) for s in range(0, feats.shape[1], CHUNK)]
    return commits, srv.finalize()


def _server(tmodel, **kw):
    return TS.StreamingS2ST(tmodel, chunk_frames=CHUNK, max_frames=64, beam=BEAM, max_len=MAXLEN,
                            **kw)


@pytest.mark.parametrize("kw", [{}, {"prefix_reuse": True, "max_new_tokens": 6},
                                {"prefix_reuse": True, "max_new_tokens": 6,
                                 "kv_cache_dtype": "int8"}])
def test_finalize_equals_offline(tiny, kw):
    """finalize() == offline decoding of the fed frames (the port's
    UnitGenerator, and JAX's tokens), and the committed units are a prefix
    of it: full re-decode, prefix reuse, prefix reuse with the int8 cache."""
    jmodel, params, tmodel, feats = tiny
    commits, final = _stream(_server(tmodel, **kw), feats)
    committed = [u for c in commits for u in c]
    assert final and final[: len(committed)] == committed
    kv = kw.get("kv_cache_dtype")
    gen = TGenerator(tmodel, TGenCfg(beam=BEAM, max_len_a=0.0, max_len_b=MAXLEN,
                                     kv_cache_dtype=kv))
    assert final == gen.generate(feats, np.array([T], np.int32))[0][0]["tokens"]
    want = JGenerator(jmodel, params, JGenCfg(beam=BEAM, max_len_a=0.0, max_len_b=MAXLEN,
                                              kv_cache_dtype=kv))
    assert final == want.generate(feats, np.array([T], np.int32))[0][0]["tokens"]


def _encoded(jmodel, params, tmodel, feats):
    lens = np.full((1,), T, np.int32)
    jenc = jmodel.apply(params, feats, lens, np.zeros((1, 3), np.int32), method=jmodel.encode)
    with torch.no_grad():
        tenc = tmodel.encode(torch.from_numpy(feats), torch.from_numpy(lens).long())
    return jenc, tenc


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_matches_stepwise_and_jax(tiny, kv_dtype):
    """decode_prefill + one step == replaying the tokens through
    decode_step (port), and prefill's cache, step, prefix log-prob and the
    next step's logits equal JAX's prefill."""
    jmodel, params, tmodel, feats = tiny
    jenc, tenc = _encoded(jmodel, params, tmodel, feats)
    K, tokens = 2, [2, 7, 9, 5, 11]  # BOS + 4 units
    P = MAXLEN + 1
    ptoks = np.full((1, P), 1, np.int32)
    ptoks[0, : len(tokens)] = tokens

    with torch.no_grad():
        st = t_tile(tmodel.decode_init(tenc, MAXLEN + 1, kv_dtype=kv_dtype), K)
        for t in tokens:
            ref_logits, st = tmodel.decode_step(torch.full((K, 1), t, dtype=torch.long), st)
        st2 = t_tile(tmodel.decode_init(tenc, MAXLEN + 1, kv_dtype=kv_dtype), K)
        st2, plogp = tmodel.decode_prefill(torch.from_numpy(ptoks).long(), len(tokens), st2)
        assert st2["step"] == len(tokens) - 1
        pf_cache = {k: st2[k].clone() for k in ("self_kv", "self_kv_sk") if k in st2}
        pf_logits, _ = tmodel.decode_step(torch.full((K, 1), tokens[-1], dtype=torch.long), st2)
    # int8: stepwise attends to quantized history, the prefill pass to exact
    # history (the rows quantize identically), as in the reference.
    tol = 2e-2 if kv_dtype == "int8" else 2e-4
    np.testing.assert_allclose(pf_logits.numpy(), ref_logits.numpy(), atol=tol, rtol=tol)
    assert np.isfinite(float(plogp[0]))

    jst = j_tile(jmodel.apply(params, jenc, MAXLEN + 1, kv_dtype, method=jmodel.decode_init), K)
    jst, jplogp = jmodel.apply(params, jnp.asarray(ptoks), jnp.asarray(len(tokens), jnp.int32),
                               jst, method=jmodel.decode_prefill)
    assert int(jst["step"]) == len(tokens) - 1
    np.testing.assert_allclose(plogp.numpy(), np.asarray(jplogp), atol=1e-4)
    if kv_dtype == "int8":
        _close_bytes(pf_cache["self_kv"].numpy(), np.asarray(jst["self_kv"]))
        np.testing.assert_allclose(pf_cache["self_kv_sk"].numpy(), np.asarray(jst["self_kv_sk"]),
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(pf_cache["self_kv"].numpy(), np.asarray(jst["self_kv"]),
                                   atol=1e-4)
    j_logits, _ = jmodel.apply(params, jnp.full((K, 1), tokens[-1], jnp.int32), jst,
                               method=jmodel.decode_step)
    np.testing.assert_allclose(pf_logits.numpy(), np.asarray(j_logits), atol=1e-4)


def test_prefix_search_empty_prefix_equals_plain(tiny):
    """A BOS-only prefix reproduces the unconstrained search exactly."""
    _, _, tmodel, feats = tiny
    with torch.no_grad():
        enc = tmodel.encode(torch.from_numpy(feats), torch.tensor([T]))
    kw = dict(beam_size=BEAM, max_len=MAXLEN, vocab_size=40)
    seqs0, sc0 = t_beam_search(tmodel.decode_step,
                               t_tile(tmodel.decode_init(enc, MAXLEN + 1), BEAM), 1, **kw)
    ptoks = torch.ones((1, MAXLEN + 1), dtype=torch.long)
    ptoks[0, 0] = 2
    with torch.no_grad():
        st, plogp = tmodel.decode_prefill(ptoks, 1, t_tile(tmodel.decode_init(enc, MAXLEN + 1),
                                                            BEAM))
    seqs1, sc1 = t_beam_search(tmodel.decode_step, st, 1, prefix_tokens=ptoks, prefix_len=1,
                               prefix_logp=plogp, max_new=MAXLEN, **kw)
    assert torch.equal(seqs0, seqs1)
    np.testing.assert_allclose(sc0.numpy(), sc1.numpy(), atol=1e-5)


def test_prefix_reuse_commits_match_jax(tiny):
    """StreamingS2ST with prefix reuse commits, feed by feed, what the JAX
    package's does, and finalizes to the same hypothesis."""
    jmodel, params, tmodel, feats = tiny
    jsrv = JS.StreamingS2ST(jmodel, params, chunk_frames=CHUNK, max_frames=64, beam=BEAM,
                            max_len=MAXLEN, prefix_reuse=True, max_new_tokens=6)
    want = _stream(jsrv, feats)
    got = _stream(_server(tmodel, prefix_reuse=True, max_new_tokens=6), feats)
    assert got == want


def test_reset_and_decode_every(tiny):
    """reset() between utterances gives a fresh session's results; with
    decode_every=2 the 1st and 3rd feeds commit nothing and finalize is
    unchanged."""
    _, _, tmodel, feats = tiny
    feats2 = np.random.RandomState(7).randn(1, T, 80).astype(np.float32)
    srv = _server(tmodel, prefix_reuse=True, max_new_tokens=6)
    got1 = _stream(srv, feats)
    srv.reset()
    got2 = _stream(srv, feats2)
    srv.reset()
    assert _stream(srv, feats) == got1
    assert got2 == _stream(_server(tmodel, prefix_reuse=True, max_new_tokens=6), feats2)

    commits, final = _stream(_server(tmodel, decode_every=2), feats)
    assert commits[0] == [] and commits[2] == []
    committed = [u for c in commits for u in c]
    assert final[: len(committed)] == committed
    assert final == _offline_tokens(tmodel, feats)
