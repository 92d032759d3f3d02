"""The port's causal/window attention (the plain twin of kernels A and G)
and its causal encoder against the JAX package, on the CPU.

* ``reference_attention(causal, window)`` against JAX's, with a padding
  mask and a ragged Tq < S: fp32 atol 2e-5, rtol 1e-4 (the JAX package's
  own kernel-vs-reference tolerance; only the summation order differs).
* ``flash_attention(causal=True)`` against JAX's Pallas kernel A run in
  interpret mode, and ``causal_skip_attention`` (the route to kernel G)
  against JAX's ``_flash_call(..., block_k=16)`` (Pallas kernel G in
  interpret mode), at the same tolerance. The JAX G kernel, unlike the
  reference, averages a row whose whole band is padding over its visited
  key blocks only; the port's G reproduces the reference there
  (``csrc/flash_attention.cu``), so against JAX's G those rows are left out
  and against JAX's reference every row is compared.
* The causal encoder (windows 0 and 6) against JAX's: fp32 atol 1e-4,
  bf16 5e-2 (``test_torch_model.py``'s reasons). JAX's encoder without the
  flash flag folds the causal mask into an additive bias where the port
  replaces masked logits; the two agree on every unpadded row, which is
  what is compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.ops.attention import _flash_call as j_flash_call
from mm_s2ut.ops.attention import flash_attention as j_flash
from mm_s2ut.ops.attention import reference_attention as j_reference
from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.ops import attention as TA

torch.set_num_threads(1)
B, H, D = 2, 2, 16


def _qkv(tq, s, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, tq, H, D).astype(np.float32)
    k = rng.randn(B, s, H, D).astype(np.float32)
    v = rng.randn(B, s, H, D).astype(np.float32)
    mask = np.zeros((B, s), bool)
    mask[1, s - 9 :] = True
    return q, k, v, mask


def _band_has_key(tq, s, window, mask):
    """(B, tq) True where a row's causal/window band holds an unpadded key."""
    t = np.arange(tq)[:, None]
    j = np.arange(s)[None, :]
    band = (j <= t) & ((j > t - window) if window > 0 else True)
    return (band[None] & ~mask[:, None, :]).any(-1)


@pytest.mark.parametrize("window", [0, 5, 24])
@pytest.mark.parametrize("tq,s", [(48, 48), (40, 64)])
def test_twin_matches_jax_reference(window, tq, s):
    q, k, v, mask = _qkv(tq, s)
    bias = np.where(mask, TA.NEG_INF, 0.0).astype(np.float32)[:, None, None, :]
    want = j_reference(q * D ** -0.5, k, v, bias, causal=True, window=window)
    got = TA.reference_attention(torch.from_numpy(q * D ** -0.5), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(bias), True, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("window", [0, 5])
def test_flash_causal_matches_jax_kernel_a(window):
    """Kernel A's causal branch (JAX: Pallas in interpret mode)."""
    q, k, v, mask = _qkv(48, 48, seed=1)
    want = j_flash(q, k, v, key_padding_mask=mask, interpret=True, block_q=16, causal=True,
                   window=window)
    got = TA.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)), causal=True,
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("window,tq", [(0, 64), (0, 40), (24, 64), (24, 40), (5, 64)])
def test_causal_skip_matches_jax_kernel_g(window, tq):
    """Kernel G's route (JAX: ``_flash_call`` with block_k in interpret
    mode). window 5 with the last 9 keys padded leaves rows 59..63 of
    batch row 1 with an all-padding band."""
    S = 64
    q, k, v, mask = _qkv(tq, S, seed=2)
    bias = np.where(mask, TA.NEG_INF, 0.0).astype(np.float32)[:, None, None, :]
    want_g = np.asarray(j_flash_call(q, k, v, bias, jnp.asarray(0, jnp.uint32), D ** -0.5, 16,
                                     True, causal=True, window=window, block_k=16))
    want_ref = np.asarray(j_reference(q * D ** -0.5, k, v, bias, causal=True,
                                      window=window))[:, :tq]
    got = TA.flash_attention if tq == S else TA.causal_skip_attention
    kw = dict(causal=True, block_k=16) if tq == S else {}
    got = got(*(torch.from_numpy(x) for x in (q, k, v, mask)), window=window, **kw).numpy()
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=1e-4)
    rows = _band_has_key(tq, S, window, mask)  # (B, tq)
    assert rows.all() == (window != 5)
    np.testing.assert_allclose(got[rows], want_g[rows], atol=2e-5, rtol=1e-4)


def test_flash_rejects_what_the_reference_rejects():
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(40, 64))
    with pytest.raises(ValueError, match="Tq == Tk"):
        TA.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        TA.flash_attention(q, q, q, dropout_rate=0.1)


def _encoders(window, dtype):
    from mm_s2ut.models.s2t_encoder import SpeechTransformerEncoder as JEnc
    from mm_s2ut_torch.models.s2t_encoder import SpeechTransformerEncoder as TEnc

    kw = dict(embed_dim=32, ffn_dim=64, num_layers=2, num_heads=2, conv_channels=16)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jenc = JEnc(causal_attention=True, attention_window=window, dtype=jdtype, **kw)
    tenc = TEnc(causal_attention=True, attention_window=window, **kw)
    return jenc, tenc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_causal_encoder_matches_jax(window, dtype):
    rng = np.random.RandomState(3)
    T = 57
    feats = rng.randn(2, T, 80).astype(np.float32)
    lengths = np.array([T, T - 17], np.int32)
    jenc, tenc = _encoders(window, dtype)
    params = jax.tree_util.tree_map(np.asarray, jenc.init(jax.random.PRNGKey(0), feats, lengths))
    want = jenc.apply(params, feats, lengths)
    tenc.load_state_dict(from_flax(params, tenc))
    tenc = tenc.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32).eval()
    with torch.no_grad():
        got = tenc(torch.from_numpy(feats), torch.from_numpy(lengths).long())
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    valid = ~np.asarray(want["encoder_padding_mask"])
    np.testing.assert_allclose(
        got["encoder_out"].float().numpy()[valid],
        np.asarray(want["encoder_out"], np.float32)[valid],
        atol={"float32": 1e-4, "bfloat16": 5e-2}[dtype],
    )
