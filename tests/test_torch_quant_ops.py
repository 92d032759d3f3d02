"""The port's int8/int4 decode-attention plain versions (kernels D, E, F)
and nibble helpers against the JAX package's, on the same numpy inputs.

* ``_quantize_q``, ``i4_pack``, ``i4_unpack`` and ``i4_regrow`` are exact:
  q8, qs and every packed byte equal bit for bit (the self logit, a fp32
  sum in another order, to atol 1e-6).
* ``reference_i8`` / ``reference_i4`` / ``cross_reference_i8`` against the
  Pallas kernels D / F / E run with ``interpret=True``: fp32, atol 1e-5.
  Both sides quantize q and the softmax weights with the same rules
  (round half to even, IEEE division); only sums run in another order, so
  a w8 level flips only at an exact rounding tie, which these inputs do
  not hit.

The caches are quantized with the port's own write path
(``models.decoder.quantize_rows``), so scales and clamps are the real ones."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.ops import decode_attention as jda
from mm_s2ut_torch.models.decoder import quantize_rows
from mm_s2ut_torch.ops import decode_attention as tda

torch.set_num_threads(1)
ATOL = 1e-5


def _inputs(B, H, K, T, L, Dh, step, seed, levels):
    """q, k_new, v_new (B, H, K, Dh), a quantized cache (B, L, H, T·K, 2·Dh)
    with its scales, and the flat_rep of a random ancestry at ``step``."""
    rng = np.random.RandomState(seed)
    q, k_new, v_new = (rng.randn(B, H, K, Dh).astype(np.float32) * 0.3 for _ in range(3))
    kv = torch.from_numpy(rng.randn(B, L, H, T * K, 2 * Dh).astype(np.float32) * 0.3)
    rows, sk, sv = quantize_rows(kv[..., :Dh], kv[..., Dh:], levels)
    ancestry = rng.randint(0, K, (B, K, T))
    t_idx = np.arange(T)[None, None, :]
    flat_rep = np.repeat(np.where(t_idx < step, t_idx * K + ancestry, -1), K, axis=2)
    return q, k_new, v_new, rows.numpy(), sk.numpy(), sv.numpy(), flat_rep.astype(np.int32)


def test_quantize_q_is_bit_exact():
    rng = np.random.RandomState(0)
    q = rng.randn(2, 3, 5, 16).astype(np.float32) * 0.4
    q[0, 0, 0] = 0.0  # an all-zero row: qs = 1e-20, q8 = 0
    k_new = rng.randn(2, 3, 5, 16).astype(np.float32)
    want = [np.asarray(x) for x in jda._quantize_q(jnp.asarray(q), jnp.asarray(k_new))]
    got = [x.numpy() for x in tda._quantize_q(torch.from_numpy(q), torch.from_numpy(k_new))]
    assert got[0].dtype == np.int8
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)


def test_i4_pack_unpack_bit_exact():
    rng = np.random.RandomState(10)
    cols = rng.randint(-8, 8, (3, 12, 16)).astype(np.int8)
    for C in (12, 9):  # full, and a short column count padded with zeros
        want = np.asarray(jda.i4_pack(jnp.asarray(cols[:, :C]), 6))
        got = tda.i4_pack(torch.from_numpy(cols[:, :C]), 6)
        assert got.dtype == torch.int8 and tuple(got.shape) == (3, 6, 16)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tda.i4_unpack(got).numpy(), np.asarray(jda.i4_unpack(want)))
    np.testing.assert_array_equal(tda.i4_unpack(tda.i4_pack(torch.from_numpy(cols), 6)).numpy(),
                                  cols)


@pytest.mark.parametrize("P_old,P_new", [(6, 12), (8, 11), (320, 360), (4, 11), (5, 5)])
def test_i4_regrow_bit_exact(P_old, P_new):
    """Doubling, the final partial growth (P_new < 2·P_old, as in
    test_decode_attention.py), the beam search's 64 → 72 growth at K=10,
    a growth past 2·P_old and none."""
    rng = np.random.RandomState(P_old)
    cols = rng.randint(-8, 8, (2, 2 * P_old, 16)).astype(np.int8)
    packed = np.array(jda.i4_pack(jnp.asarray(cols), P_old))  # writable, for torch
    want = np.asarray(jda.i4_regrow(jnp.asarray(packed), P_new))
    got = tda.i4_regrow(torch.from_numpy(packed), P_new).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tda.i4_unpack(torch.from_numpy(got)).numpy()[:, : 2 * P_old], cols)


@pytest.mark.parametrize("K,step", [(1, 0), (1, 11), (5, 17), (10, 0), (10, 9), (3, 16)])
def test_reference_i8_matches_pallas_d(K, step):
    B, H, T, L, Dh = 2, 2, 16, 2, 16
    args = _inputs(B, H, K, T, L, Dh, step, seed=K + step, levels=127.0)
    for layer in range(L):
        want = np.asarray(jda.ancestry_decode_attention_i8(
            *map(jnp.asarray, args), layer, interpret=True))
        got = tda.ancestry_decode_attention_i8(*map(torch.from_numpy, args), layer).numpy()
        assert tda.ancestry_decode_attention_i8.launches == 0  # CPU: the plain version
        np.testing.assert_allclose(got, want, atol=ATOL)
        if step == 0:  # no column on any path: exactly the fresh value
            np.testing.assert_array_equal(got, args[2])


@pytest.mark.parametrize("K,step", [(1, 7), (5, 17), (10, 0), (10, 12)])
def test_reference_i4_matches_pallas_f(K, step):
    B, H, T, L, Dh = 2, 2, 16, 2, 16
    q, k_new, v_new, cols, sk, sv, flat_rep = _inputs(B, H, K, T, L, Dh, step, seed=K * step + 1,
                                                      levels=7.0)
    packed = tda.i4_pack(torch.from_numpy(cols), T * K // 2).numpy()
    args = (q, k_new, v_new, packed, sk, sv, flat_rep)
    for layer in range(L):
        want = np.asarray(jda.ancestry_decode_attention_i4(
            *map(jnp.asarray, args), layer, interpret=True))
        got = tda.ancestry_decode_attention_i4(*map(torch.from_numpy, args), layer).numpy()
        assert tda.ancestry_decode_attention_i4.launches == 0
        np.testing.assert_allclose(got, want, atol=ATOL)
        if step == 0:
            np.testing.assert_array_equal(got, v_new)


def test_reference_i8_reads_segment_views():
    """The first cap·K columns of one full cache and scale allocation (the
    beam search's segment views) give what arrays of exactly that size give."""
    B, H, K, T, L, Dh = 2, 2, 3, 12, 2, 16
    q, k_new, v_new, kv, sk, sv, flat_rep = map(
        torch.from_numpy, _inputs(B, H, K, T, L, Dh, 5, seed=3, levels=127.0))
    kv_view = torch.cat([kv, torch.ones_like(kv)], dim=3)[:, :, :, : T * K]
    sk_view, sv_view = (torch.cat([s, torch.ones_like(s)], dim=3)[..., : T * K] for s in (sk, sv))
    assert not (kv_view.is_contiguous() or sk_view.is_contiguous())
    got = tda.ancestry_decode_attention_i8(q, k_new, v_new, kv_view, sk_view, sv_view, flat_rep, 1)
    want = tda.ancestry_decode_attention_i8(q, k_new, v_new, kv, sk, sv, flat_rep, 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("K,S,pad", [(1, 24, True), (5, 24, True), (10, 40, False)])
def test_cross_reference_i8_matches_pallas_e(K, S, pad):
    rng = np.random.RandomState(K * S)
    B, H, Dh = 2, 2, 16
    q = rng.randn(B, H, K, Dh).astype(np.float32) * 0.3
    kv = torch.from_numpy(rng.randn(B, H, S, 2 * Dh).astype(np.float32) * 0.3)
    slab, sk, sv = (t.numpy() for t in quantize_rows(kv[..., :Dh], kv[..., Dh:], 127.0))
    mask = (rng.rand(B, S) < 0.3) if pad else np.zeros((B, S), bool)
    mask[:, 0] = False
    bias = np.where(mask, -1e9, 0.0).astype(np.float32)
    args = (q, slab, sk, sv, bias)
    want = np.asarray(jda.cross_decode_attention_i8(*map(jnp.asarray, args), interpret=True))
    got = tda.cross_decode_attention_i8(*map(torch.from_numpy, args)).numpy()
    assert tda.cross_decode_attention_i8.launches == 0
    np.testing.assert_allclose(got, want, atol=ATOL)
