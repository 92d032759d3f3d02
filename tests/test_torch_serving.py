"""The port's continuous-batching server against the JAX package's.

The small fp32 model of ``tests/test_serving.py`` (unit embedding
sharpened ×3, so the argmaxes are not near-ties), its flax parameters
carried across by ``convert.from_flax``.

1. ``UnitDecoder.serve_step`` on a ring whose live window has wrapped (the
   oldest live step physically after the newest), for a float, an int8
   and an int4 cache: logits atol 1e-4, and the written cache against the
   JAX step's (bytes equal but for ±1 rounding-tie flips, scales rtol 1e-5).
2. ``ContinuousServer.run`` per utterance against JAX's offline
   ``beam_search``: tokens equal, scores atol 1e-4, for admission widths
   None and 1, a slot reused until the ring wraps, int8 and a wrapped int4
   ring, image fusion, and the budget from raw source frames; one case
   also against JAX's ``ContinuousServer`` itself, and the int4 server at
   two slots against JAX's on the card smoke run's "ending on EOS" model.
3. Admission into an int8 cross cache keeps int8 and its scales, writes
   the JAX admission's bytes, and leaves the state's shapes and dtypes as
   they were."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import ModelConfig, MultimodalConfig
from mm_s2ut.infer.beam_search import beam_search as j_beam_search
from mm_s2ut.infer.beam_search import tile_state_for_beams as j_tile
from mm_s2ut.infer.serving import ContinuousServer as JServer
from mm_s2ut.infer.serving import Request as JRequest
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.infer.serving import ContinuousServer, Request
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TModel
from tests.test_serving import BOS, EOS, K, MAX_LEN, PAD, V, _model
from tests.test_torch_quant_model import _close_bytes

torch.set_num_threads(1)
ENC_FRAMES = 64
COMMON = dict(beam_size=K, enc_frames=ENC_FRAMES, eos_id=EOS, bos_id=BOS, pad_id=PAD)


class Pair:
    """A JAX model and its port on the same parameters, with jitted offline
    references (one compile per kv dtype and budget)."""

    def __init__(self, jmodel, params):
        self.jmodel, self.params = jmodel, jax.tree_util.tree_map(np.asarray, params)
        tmodel = TModel(tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(jmodel.cfg)))
        tmodel.load_state_dict(from_flax(self.params, tmodel))
        self.tmodel = tmodel.eval()
        self._encode = jax.jit(lambda f, lens, imgs, masks: jmodel.apply(
            self.params, f, lens, imgs, masks, None, deterministic=True, method=jmodel.encode))
        self._step = lambda t, s: jmodel.apply(self.params, t, s, method=jmodel.decode_step)

    @functools.lru_cache(maxsize=None)
    def _init(self, kv_dtype, max_len):
        return jax.jit(lambda enc: j_tile(self.jmodel.apply(
            self.params, enc, max_len + 1, method=self.jmodel.decode_init, kv_dtype=kv_dtype), K))

    def offline(self, req, kv_dtype=None, max_len=MAX_LEN):
        """JAX's offline search of one request, padded to ENC_FRAMES:
        (tokens cut at EOS, score)."""
        f = np.zeros((1, ENC_FRAMES, 80), np.float32)
        f[0, : req.features.shape[0]] = req.features
        imgs = tuple(jnp.asarray(x[None]) for x in req.imgs)
        masks = tuple(jnp.asarray(x[None]) for x in req.img_masks)
        enc = self._encode(jnp.asarray(f), jnp.asarray([req.length], np.int32), imgs, masks)
        seqs, scores = j_beam_search(
            self._step, self._init(kv_dtype, max_len)(enc), 1, beam_size=K, max_len=max_len,
            eos_id=EOS, bos_id=BOS, pad_id=PAD, vocab_size=V)
        toks = [int(t) for t in np.asarray(seqs)[0, 0]]
        return (toks[: toks.index(EOS)] if EOS in toks else toks), float(scores[0, 0])


@pytest.fixture(scope="module")
def pair():
    return Pair(*_model())


def _requests(seed, n, lengths=(24, 32, 40)):
    rng = np.random.RandomState(seed)
    return [Request(uid=i, features=rng.randn(lengths[i % len(lengths)], 80).astype(np.float32),
                    length=lengths[i % len(lengths)]) for i in range(n)]


def _check_against_offline(pair, srv, reqs, kv_dtype=None, max_lens=None):
    results = {r.uid: r for r in srv.run(reqs)}
    assert sorted(results) == sorted(r.uid for r in reqs)  # each answered exactly once
    for i, req in enumerate(reqs):
        want_toks, want_score = pair.offline(req, kv_dtype, max_lens[i] if max_lens else MAX_LEN)
        got = results[req.uid]
        assert got.tokens == want_toks, (req.uid, got.tokens, want_toks)
        np.testing.assert_allclose(got.score, want_score, atol=1e-4)
    return results


def _jax_state_to_torch(st):
    out = {}
    for key, v in st.items():
        if key == "cross":
            out[key] = [{k: torch.from_numpy(np.array(c[k])) for k in c if k != "index"} for c in v]
        elif key == "g":
            out[key] = int(v)
        elif v is None:
            out[key] = None
        else:
            t = torch.from_numpy(np.array(v))
            out[key] = t.long() if t.dtype == torch.int32 else t
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_serve_step_on_a_wrapped_ring_matches_jax(pair, kv_dtype):
    """Two slots on an 8-step ring at g = 13: slot 0 admitted at ring step
    5 with 6 live steps (steps 5, 6, 7, 0, 1, 2: wrapped), slot 1 at step 6
    with 3; random cache contents and ancestry; three serve_steps."""
    T = 8
    jsrv = JServer(pair.jmodel, pair.params, slots=2, ring=T, chunk=1, max_len_a=0.0,
                   max_len_b=4, kv_cache_dtype=kv_dtype or "bfloat16", **COMMON)
    rng = np.random.RandomState(7)
    st = jsrv.init_state(pair.params)
    enc_out, enc_mask = jsrv._encode(pair.params, jnp.asarray(rng.randn(2, ENC_FRAMES, 80),
                                                                jnp.float32),
                                     jnp.asarray([40, 24], np.int32), (), ())
    st = jsrv._admit(pair.params, st, jnp.asarray([0, 1], np.int32), jnp.asarray([True, True]),
                     enc_out, enc_mask, jnp.asarray([40, 24], np.int32))
    kv = np.asarray(st["self_kv"])
    if kv.dtype == np.int8:
        fill = rng.randint(-127 if kv_dtype == "int8" else -128, 128, kv.shape).astype(np.int8)
        scales = {k: (rng.rand(*st[k].shape) * 0.05 + 1e-3).astype(np.float32)
                  for k in ("self_kv_sk", "self_kv_sv")}
    else:
        fill, scales = rng.randn(*kv.shape).astype(kv.dtype), {}
    st = {**st, "self_kv": jnp.asarray(fill), **{k: jnp.asarray(v) for k, v in scales.items()},
          "g": jnp.asarray(13, jnp.int32), "ring_base": jnp.asarray([5, 6], jnp.int32),
          "local_step": jnp.asarray([6, 3], jnp.int32),
          "ancestry": jnp.asarray(rng.randint(0, K, (2, K, T)), jnp.int32)}
    tst = _jax_state_to_torch(st)
    with torch.no_grad():
        for _ in range(3):
            tokens = rng.randint(4, V, (2 * K, 1)).astype(np.int32)
            want, st = pair.jmodel.apply(pair.params, jnp.asarray(tokens), st,
                                         method=pair.jmodel.serve_step)
            got, tst = pair.tmodel.serve_step(torch.from_numpy(tokens).long(), tst)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tst["g"] == int(st["g"]) == 16
    np.testing.assert_array_equal(tst["local_step"].numpy(), np.asarray(st["local_step"]))
    if kv.dtype == np.int8:
        _close_bytes(tst["self_kv"].numpy(), np.asarray(st["self_kv"]))
        for key in scales:
            np.testing.assert_allclose(tst[key].numpy(), np.asarray(st[key]), rtol=1e-5)
    else:
        np.testing.assert_allclose(tst["self_kv"].numpy(), np.asarray(st["self_kv"]), atol=1e-5)


@pytest.mark.parametrize("admit_width", [None, 1])
def test_server_matches_jax_offline_search(pair, admit_width):
    """Five requests through two slots; admit_width 1 admits one row per
    wave. With admit_width 1 the results also equal JAX's server's."""
    reqs = _requests(3, 5)
    kw = dict(slots=2, ring=32, chunk=5, max_len_a=0.0, max_len_b=MAX_LEN,
              admit_width=admit_width, **COMMON)
    results = _check_against_offline(pair, ContinuousServer(pair.tmodel, **kw), reqs)
    if admit_width == 1:
        jres = {r.uid: r for r in JServer(pair.jmodel, pair.params, vocab_size=V, **kw).run(
            [JRequest(r.uid, r.features, r.length) for r in reqs])}
        for uid, r in results.items():
            assert r.tokens == jres[uid].tokens
            np.testing.assert_allclose(r.score, jres[uid].score, atol=1e-4)


def test_slot_reused_until_the_ring_wraps(pair):
    """One slot, a 16-step ring, seven utterances in turn: the ring wraps
    several times under later utterances."""
    srv = ContinuousServer(pair.tmodel, slots=1, ring=16, chunk=4, max_len_a=0.0,
                           max_len_b=MAX_LEN, **COMMON)
    _check_against_offline(pair, srv, _requests(5, 7, lengths=(24,)))
    assert srv.stats["steps"] > 2 * 16 and srv.stats["waves"] == 7


@pytest.mark.parametrize("kv_dtype,slots", [("int8", 2), ("int4", 1)])
def test_quantized_ring_matches_jax_offline_search(pair, kv_dtype, slots):
    """int8 over two slots and int4 over one, both on a 16-step ring that
    wraps: the int4 writes land in the high nibble half as well, and the
    read-merge-write keeps the other half's live columns."""
    srv = ContinuousServer(pair.tmodel, slots=slots, ring=16, chunk=4, max_len_a=0.0,
                           max_len_b=MAX_LEN, kv_cache_dtype=kv_dtype, **COMMON)
    _check_against_offline(pair, srv, _requests(9, 5, lengths=(24,)), kv_dtype)
    assert srv.stats["steps"] > 16


def test_int4_two_slot_server_matches_jax_server_on_eos_model():
    """The int4 server at two slots against JAX's at two slots, on a CPU
    copy of the card smoke run's "ending on EOS" serving model and its six
    requests (one 50x768 image source, two padded tails): tokens equal and
    scores within 1e-4 of JAX's server and of the port's one-utterance
    search. Before the subsampler's convs ran one row per call, one score
    of a two-row admission wave sat 1.25e-4 off both."""
    import chip_smoke

    from mm_s2ut.config import ModelConfig as JModelConfig
    from mm_s2ut.config import _build as j_build
    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.convert import to_flax, unflatten
    from mm_s2ut_torch.infer.generator import UnitGenerator

    model = chip_smoke.serving_model(3.0)
    jmodel = JModel(j_build(JModelConfig, dataclasses.asdict(model.cfg)))
    params = {"params": unflatten(to_flax(model))}
    reqs = chip_smoke.small_serving_requests()
    kw = dict(chip_smoke.SMALL_SERVE, kv_cache_dtype="int4")
    assert kw["slots"] == 2
    port = {r.uid: r for r in ContinuousServer(model, **kw).run(reqs)}
    jres = {r.uid: r for r in JServer(jmodel, params, vocab_size=model.cfg.vocab_size,
                                      n_img_sources=1, **kw).run(
        [JRequest(r.uid, r.features, r.length, r.imgs, r.img_masks) for r in reqs])}
    gen = UnitGenerator(model, GenerationConfig(beam=kw["beam_size"], max_len_a=0.0,
                                                max_len_b=kw["max_len_b"], kv_cache_dtype="int4"))
    lengths = set()
    for q in reqs:
        feats = np.zeros((1, kw["enc_frames"], 80), np.float32)
        feats[0, : q.length] = q.features
        off = gen.generate(feats, np.asarray([q.length]), [q.imgs[0][None]],
                           [q.img_masks[0][None]])[0][0]
        got, want = port[q.uid], jres[q.uid]
        assert got.tokens == want.tokens == off["tokens"], q.uid
        np.testing.assert_allclose(got.score, want.score, atol=1e-4)
        np.testing.assert_allclose(got.score, off["score"], atol=1e-4)
        lengths.add(len(got.tokens))
    assert min(lengths) < kw["max_len_b"] - 1  # some hypotheses end on EOS


def test_server_with_image_fusion_matches_jax_offline_search():
    cfg = ModelConfig(
        encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
        decoder_layers=1, decoder_attention_heads=2, conv_channels=16, vocab_size=V,
        dtype="float32",
        multimodal=MultimodalConfig(image_feat_dim=[16],
                                    multimodal_attention_type="selective_attention"))
    jmodel = JModel(cfg)
    rng = np.random.RandomState(0)
    params = jmodel.init(
        jax.random.PRNGKey(7), jnp.asarray(rng.randn(1, 32, 80), jnp.float32),
        jnp.full((1,), 32, jnp.int32), jnp.zeros((1, 3), jnp.int32),
        imgs_list=(jnp.asarray(rng.randn(1, 6, 16), jnp.float32),),
        img_masks_list=(jnp.zeros((1, 6), bool),))
    pair = Pair(jmodel, params)
    reqs = []
    for i in range(3):
        T = 24 + 8 * (i % 2)
        mask = np.zeros(6, bool)
        mask[5 - i:] = True  # a padded image tail on two of them
        reqs.append(Request(i, rng.randn(T, 80).astype(np.float32), T,
                            imgs=(rng.randn(6, 16).astype(np.float32),), img_masks=(mask,)))
    srv = ContinuousServer(pair.tmodel, slots=2, ring=32, chunk=4, max_len_a=0.0,
                           max_len_b=MAX_LEN, img_shapes=((6, 16),), **COMMON)
    _check_against_offline(pair, srv, reqs)


def test_admit_preserves_quantized_cross_cache(pair):
    """Admitting one row of a two-row wave into slot 0 of an int8 server:
    the cross slab stays int8 with its scales, slot 0 takes the JAX
    admission's bytes and scales, slot 1 keeps its idle bytes, and every
    state tensor keeps its shape and dtype."""
    kw = dict(slots=2, ring=16, chunk=4, max_len_a=0.0, max_len_b=MAX_LEN,
              kv_cache_dtype="int8", **COMMON)
    srv = ContinuousServer(pair.tmodel, **kw)
    state = srv.init_state()
    before = {k: (tuple(v.shape), v.dtype) for k, v in state.items()
              if isinstance(v, torch.Tensor)}
    idle = [c["kv"][1].clone() for c in state["cross"]]
    feats = np.random.RandomState(11).randn(2, ENC_FRAMES, 80).astype(np.float32)
    lens = np.asarray([40, 24])
    wave = {"feats": torch.from_numpy(feats), "lens": torch.from_numpy(lens), "imgs": [],
            "masks": []}
    srv._admit(state, srv._encode(wave), [0], [0], srv._budgets(lens[:1]))

    jsrv = JServer(pair.jmodel, pair.params, **kw)
    enc_out, enc_mask = jsrv._encode(pair.params, jnp.asarray(feats), jnp.asarray(lens, np.int32),
                                     (), ())
    jst = jsrv._admit(pair.params, jsrv.init_state(pair.params), jnp.asarray([0, 1], np.int32),
                      jnp.asarray([True, False]), enc_out, enc_mask, jnp.asarray(lens, np.int32))
    for got, want, slot1 in zip(state["cross"], jst["cross"], idle):
        assert got["kv"].dtype == torch.int8 and set(got) == {"kv", "sk", "sv"}
        assert torch.equal(got["kv"][1], slot1) and not torch.equal(got["kv"][0], slot1)
        _close_bytes(got["kv"].numpy(), np.asarray(want["kv"]))
        for key in ("sk", "sv"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5)
    assert before == {k: (tuple(v.shape), v.dtype) for k, v in state.items()
                      if isinstance(v, torch.Tensor)}
    assert state["active"].tolist() == [True, False]
    assert state["slot_max"].tolist() == [MAX_LEN, 0]


def test_slot_budget_uses_raw_source_frames():
    """max_len_a = 0.25 of the RAW frames (not the 4× subsampled encoder
    rows): budgets 8 and 12 steps. Unsharpened random weights never pick
    EOS, so each hypothesis runs to its forced EOS; the tokens and scores
    equal JAX's offline search at those budgets."""
    pair = Pair(*_model(sharpen=False))
    reqs = _requests(7, 2, lengths=(32, 48))
    srv = ContinuousServer(pair.tmodel, slots=2, ring=32, chunk=4, max_len_a=0.25, max_len_b=0,
                           **COMMON)
    results = _check_against_offline(pair, srv, reqs, max_lens=[8, 12])
    assert [len(results[i].tokens) for i in (0, 1)] == [8 - 1, 12 - 1]


def test_server_refuses_raw_waveforms_and_a_short_ring(pair):
    """The fbank model takes no raw waveforms (a wav2vec2 or XM model does:
    ``tests/test_torch_xm.py``), nor features of another width."""
    with pytest.raises(ValueError, match="enc_feat_dim None: the model reads 80"):
        ContinuousServer(pair.tmodel, enc_feat_dim=None, **COMMON)
    with pytest.raises(ValueError, match="enc_feat_dim"):
        ContinuousServer(pair.tmodel, enc_feat_dim=40, **COMMON)
    with pytest.raises(ValueError, match="ring"):
        ContinuousServer(pair.tmodel, ring=16, max_len_b=16, **COMMON)
