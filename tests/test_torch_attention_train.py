"""The training half of the port's encoder attention against the JAX
package, on the CPU: attention dropout in the plain twin of kernels A
and G, and the plain twin of kernel H (the backward).

* ``reference_attention`` with dropout against JAX's ``reference_attention``
  with the same seed, and ``flash_attention`` with dropout (the route to
  A, and to G with ``block_k``) against JAX's Pallas A and G in interpret
  mode: non-causal, causal and window 4, with key padding and a ragged T.
* ``reference_attention_bwd`` (H's twin) against ``jax.vjp`` of JAX's
  ``reference_attention`` (the reference's default backward) and JAX's
  ``_flash_bwd_call(interpret=True)`` (Pallas H) on dq, dk, dv and dbias,
  with dropout 0 and 0.1. Window 4 with the last 9 keys padded leaves rows
  whose whole band is padding: there Pallas H differs from the VJP (it
  lets gradient through the logits the mask replaced), and the port
  follows the VJP, so against Pallas H that case compares dq on the
  other rows. The port's ``flash_attention`` backward (autograd through
  the twin) gives the same dq, dk, dv.
* ``torch.autograd.gradcheck`` of the twins in float64.

Tolerance fp32 atol 1e-5: the same arithmetic, summed in other orders
(the Pallas kernel also scales the kept weights by 1/(1 - p) where the
reference divides by 1 - p).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.ops.attention import _flash_bwd_call as j_bwd
from mm_s2ut.ops.attention import _flash_call as j_flash_call
from mm_s2ut.ops.attention import reference_attention as j_reference
from mm_s2ut_torch.ops import attention as TA

torch.set_num_threads(1)
B, H, D = 2, 2, 16
SEED = 2024
ATOL = 1e-5


def _inputs(tq, s, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, t, H, D).astype(np.float32) for t in (tq, s, s))
    g = rng.randn(B, tq, H, D).astype(np.float32)
    mask = np.zeros((B, s), bool)
    mask[1, s - 9 :] = True
    bias = np.where(mask, TA.NEG_INF, 0.0).astype(np.float32)
    return q, k, v, g, mask, bias


CASES = [  # (Tq, S, causal, window)
    (45, 45, False, 0), (40, 48, False, 0), (45, 45, True, 0), (45, 45, True, 4),
]


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("tq,s,causal,window", CASES)
def test_twin_dropout_matches_jax_reference(tq, s, causal, window, rate):
    q, k, v, _, _, bias = _inputs(tq, s)
    scale = D ** -0.5
    want = j_reference(q * scale, k, v, bias[:, None, None, :], causal=causal, window=window,
                       dropout_rate=rate, dropout_seed=jnp.uint32(SEED))
    got = TA.reference_attention(torch.from_numpy(q * scale), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(bias)[:, None, None, :],
                                 causal, window, rate, SEED)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("tq,s,causal,window,skip", [
    c + (skip,) for c in CASES if c[0] == c[1] for skip in ((False, True) if c[2] else (False,))
])
def test_flash_dropout_matches_jax_kernels(tq, s, causal, window, skip):
    """The port's flash_attention with dropout 0.1 against JAX's Pallas A
    (and G, ``block_k=16``, where causal) in interpret mode. JAX's G
    averages a row whose whole band is padding over its visited key
    blocks only (the port reproduces the reference there), so those rows
    are left out against it."""
    q, k, v, _, mask, bias = _inputs(tq, s, seed=1)
    want = np.asarray(j_flash_call(q, k, v, bias[:, None, None, :], jnp.uint32(SEED), D ** -0.5,
                                   16, True, causal=causal, window=window, dropout_rate=0.1,
                                   block_k=16 if skip else None))
    got = TA.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)), causal=causal,
                             window=window, dropout_rate=0.1, dropout_seed=SEED,
                             block_k=16 if skip else None).numpy()
    rows = np.ones((B, tq), bool)
    if skip and window:
        t = np.arange(tq)[:, None]
        j = np.arange(s)[None, :]
        band = (j <= t) & (j > t - window)
        rows = (band[None] & ~mask[:, None, :]).any(-1)
        assert not rows.all()
    np.testing.assert_allclose(got[rows], want[rows], atol=ATOL)


def _port_bwd(q, k, v, g, bias, causal, window, rate):
    return TA.reference_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, bias, g)), D ** -0.5, causal, window, rate,
        SEED if rate else None)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("tq,s,causal,window", CASES)
def test_h_twin_matches_pallas_h_and_jax_vjp(tq, s, causal, window, rate):
    q, k, v, g, mask, bias = _inputs(tq, s, seed=2)
    scale = D ** -0.5
    bias4 = bias[:, None, None, :]
    seed = jnp.uint32(SEED)
    dq, dk, dv, dbias = (t.numpy() for t in _port_bwd(q, k, v, g, bias, causal, window, rate))

    want_vjp = jax.vjp(lambda a, b_, c, d: j_reference(a * scale, b_, c, d, causal=causal,
                                                       window=window, dropout_rate=rate,
                                                       dropout_seed=seed),
                       q, k, v, bias4)[1](jnp.asarray(g))
    for got, w in zip((dq, dk, dv, dbias), want_vjp):
        np.testing.assert_allclose(got, np.asarray(w).reshape(got.shape), atol=ATOL)
    if tq == s:  # the Pallas backward keeps the reference's Tq == S self-attention
        pallas = [np.asarray(w) for w in
                  j_bwd(q, k, v, bias4, seed, g, scale, 16, True, causal, window, rate)]
        if window:
            # Pallas H differs from the reference's VJP on rows whose whole
            # band is padding (ROADMAP §3): compare dq on the other rows.
            t = np.arange(tq)[:, None]
            j = np.arange(s)[None, :]
            rows = (((j <= t) & (j > t - window))[None] & ~mask[:, None, :]).any(-1)
            assert not rows.all()
            np.testing.assert_allclose(dq[rows], pallas[0][rows], atol=ATOL)
            assert np.abs(dq[~rows] - pallas[0][~rows]).max() > 0.1
        else:
            for got, w in zip((dq, dk, dv, dbias), pallas):
                np.testing.assert_allclose(got, w.reshape(got.shape), atol=ATOL)

    # The port's flash_attention backward (autograd through the same twin).
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = TA.flash_attention(qt, kt, vt, torch.from_numpy(mask), causal=causal, window=window,
                             dropout_rate=rate, dropout_seed=SEED if rate else None)
    out.backward(torch.from_numpy(g))
    for got, w in zip((qt.grad, kt.grad, vt.grad), (dq, dk, dv)):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("causal,window,rate", [(False, 0, 0.0), (True, 3, 0.3)])
def test_gradcheck_twins_float64(causal, window, rate):
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 7, 2, 4)).requires_grad_(True) for _ in range(3))
    mask = torch.zeros(1, 7, dtype=torch.bool)
    mask[0, 5:] = True

    def fn(q, k, v):
        return TA.flash_attention(q, k, v, mask, scale=0.5, causal=causal, window=window,
                                  dropout_rate=rate, dropout_seed=11 if rate else None)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)


def test_dropout_needs_a_seed():
    q = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        TA.flash_attention(q, q, q, dropout_rate=0.1)
