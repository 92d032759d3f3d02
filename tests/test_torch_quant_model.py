"""The port's int8/int4 decode caches against the JAX package's, with the
same flax parameters carried across by ``convert.from_flax`` (small fp32
model).

1. ``MultiHeadAttention.precompute_kv(kv_dtype="int8")``: the int8 slab and
   its scales.
2. Four ``UnitDecoder.step``s on a beam-tiled int8 / int4 state whose
   ancestry is reordered between steps: logits, and the cache bytes and
   scales against the JAX state.
3. ``UnitGenerator.generate`` end to end with int8 and int4, long enough
   (max_len_b 70) that the search passes step 64 and grows its cache; the
   int4 run re-packs it with ``i4_regrow`` (64 → 72 steps).

Tolerances. The K/V rows come out of fp32 projections that XLA and
PyTorch sum in different orders (and the reference fuses q/k/v into one
matmul), so they differ by ~1e-7 relative; a quantized value can then sit
on the other side of a rounding tie. Cache bytes must be equal except for
such ±1 level flips, at most 0.5% of the values (these inputs hit none);
scales agree to rtol 1e-5. Logits: atol 1e-4 as for a float cache
(tests/test_torch_model.py; measured 1.5e-5 on logits scaled ×8).
Generated top tokens are equal and scores within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import GenerationConfig as JGenCfg
from mm_s2ut.infer.beam_search import _reorder_ancestry as j_reorder
from mm_s2ut.infer.beam_search import tile_state_for_beams as j_tile
from mm_s2ut.infer.generator import UnitGenerator as JGenerator
from mm_s2ut.models.layers import MultiHeadAttention as JMHA
from mm_s2ut_torch.config import GenerationConfig as TGenCfg
from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.infer.beam_search import _reorder_ancestry as t_reorder
from mm_s2ut_torch.infer.beam_search import tile_state_for_beams as t_tile
from mm_s2ut_torch.infer.generator import UnitGenerator as TGenerator
from mm_s2ut_torch.models.layers import MultiHeadAttention as TMHA
from mm_s2ut_torch.ops.decode_attention import i4_unpack
from tests.test_torch_model import B, inputs, small_models, t_encode

torch.set_num_threads(1)
K, MAXL = 3, 7  # int4 rounds the 7 cache steps up to 8


def _close_bytes(got: np.ndarray, want: np.ndarray):
    """Equal except for ±1 rounding-tie flips in at most 0.5% of values."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 5e-3, (diff > 0).mean()


def test_precompute_kv_int8_matches_jax():
    rng = np.random.RandomState(9)
    Bn, S, D, H = 2, 12, 64, 4
    x = rng.randn(Bn, S, D).astype(np.float32)
    jattn = JMHA(embed_dim=D, num_heads=H, dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jattn.init(jax.random.PRNGKey(0), x, x, x))
    want = jattn.apply(params, jnp.asarray(x), method=JMHA.precompute_kv, kv_dtype="int8")
    tattn = TMHA(D, H)
    tattn.load_state_dict(from_flax(params, tattn))
    with torch.no_grad():
        got = tattn.precompute_kv(torch.from_numpy(x), kv_dtype="int8")
    assert got["kv"].dtype == torch.int8 and got["kv"].shape == (Bn, H, S, 2 * D // H)
    _close_bytes(got["kv"].numpy(), np.asarray(want["kv"]))
    for key in ("sk", "sv"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5)


@pytest.fixture(scope="module")
def fp32_models():
    return small_models("float32", seed=1, logit_scale=8.0)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_decode_steps_match_jax(fp32_models, kv_dtype):
    jmodel, params, tmodel = fp32_models
    b = inputs()
    rng = np.random.RandomState(2)
    enc = jmodel.apply(params, b["feats"], b["lens"], b["imgs"], b["masks"], None,
                       deterministic=True, method=jmodel.encode)
    jst = j_tile(jmodel.apply(params, enc, MAXL, method=jmodel.decode_init, kv_dtype=kv_dtype), K)
    with torch.no_grad():
        tst = t_tile(tmodel.decode_init(t_encode(tmodel, b), MAXL, kv_dtype=kv_dtype), K)
        for key in ("self_kv", "self_kv_sk", "self_kv_sv", "ancestry"):
            assert tuple(tst[key].shape) == tuple(jst[key].shape), key
        for step in range(4):
            tokens = rng.randint(4, 1004, (B * K, 1)).astype(np.int32)
            want, jst = jmodel.apply(params, jnp.asarray(tokens), jst, method=jmodel.decode_step)
            got, tst = tmodel.decode_step(torch.from_numpy(tokens).long(), tst)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
            src_beam = rng.randint(0, K, (B, K))
            jst = j_reorder(jst, jnp.asarray(src_beam, jnp.int32), step)
            t_reorder(tst, torch.from_numpy(src_beam).long(), step)
    np.testing.assert_array_equal(tst["ancestry"].numpy(), np.asarray(jst["ancestry"]))
    got_kv, want_kv = tst["self_kv"], np.asarray(jst["self_kv"])
    if kv_dtype == "int4":  # compare logical columns, so a flip is ±1 too
        got_kv, want_kv = i4_unpack(got_kv), i4_unpack(torch.from_numpy(np.array(want_kv)))
        want_kv = want_kv.numpy()
    _close_bytes(got_kv.numpy(), want_kv)
    written = 4 * K  # the columns the steps wrote; the rest are still zero
    assert not np.asarray(jst["self_kv_sk"])[..., written:].any()
    for key in ("self_kv_sk", "self_kv_sv"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_generate_matches_jax(fp32_models, kv_dtype):
    jmodel, params, tmodel = fp32_models
    b = inputs(seed=4)
    kw = dict(beam=3, max_len_a=0.0, max_len_b=70, kv_cache_dtype=kv_dtype)
    want = JGenerator(jmodel, params, JGenCfg(**kw)).generate(
        b["feats"], b["lens"], b["imgs"], b["masks"]
    )
    got = TGenerator(tmodel, TGenCfg(**kw)).generate(
        b["feats"], b["lens"], b["imgs"], b["masks"]
    )
    # The search ran past step 64, so the cache grew (int4: re-packed).
    assert max(len(got[bi][0]["tokens"]) for bi in range(B)) >= 64
    for bi in range(B):
        assert got[bi][0]["tokens"] == want[bi][0]["tokens"]
        np.testing.assert_allclose(
            [h["score"] for h in got[bi]], [h["score"] for h in want[bi]], atol=1e-4
        )
