"""Where the bf16 tensor-core kernels A and H round, emulated in plain
PyTorch on the CPU and held against the JAX package at the card checks'
tolerance.

On the card, bf16 A (``csrc/flash_attention_mma.cu``) and H
(``csrc/flash_attention_bwd_mma.cu``) feed their second products from
fp32 accumulators packed to bf16, so they round where the SIMT kernels
did not:

* A, per 64-key tile of the online softmax: p = exp(logit - running
  max), p·F (the dropout factor) rounded to bf16 before ·V, unnormalised;
  O accumulates in fp32, is rescaled by exp(m_old - m_new) and divided by
  l (the sum of the unrounded p) in fp32 at the end, then stored as bf16.
* H: P·F and dS rounded to bf16 before the dV, dK and dQ products, fp32
  accumulation; dQ stored as bf16, dK, dV and dbias in fp32. Δ = Σ dO·O
  comes from A's bf16 output, as the wrapper computes it.

The emulation below (bf16 values, fp32 arithmetic) is held against JAX's
``reference_attention`` in bf16 (A) and ``jax.vjp`` of it in fp32 (H) at
B=2, T=300, H=2, D=64, dropout 0 and 0.1, non-causal and causal window 64,
to ``chip_smoke.TOL`` (bf16 2e-2) times max(1, largest |want|), the
tolerance of the card checks. A row whose whole window band is padding
(lengths 300 and 200) takes the uniform average in both.

A row with a single valid key has a softmax gradient of exactly 0: there
dS = P (dP F - Δ) cancels two terms of size |Δ|, and Δ's own bf16 error
(from the stored output) is the whole result. The last test pins that:
with an exact Δ the emulated H holds TOL, with the wrapper's Δ it holds
TOL times max(1, |Δ|), which is what ``tests/test_torch_cuda.py`` allows
on such rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from mm_s2ut.ops.attention import reference_attention as j_reference
from mm_s2ut_torch.ops import attention as TA

torch.set_num_threads(1)
BF16 = torch.bfloat16
TILE = 64  # A's keys per staged tile
SEED = 0x5EED
LIM = TOL[BF16]


# ------------------------------------------------------------ the emulation


def _logits(q, k, bias, scale, causal, window):
    """(B, H, T, S) fp32 logits as the kernels form them: one fmaf of the
    bf16 dot product, the key bias, -1e9 in place of a masked logit."""
    x = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale + bias[:, None, None, :]
    if causal:
        allowed = TA._causal_allowed(q.shape[1], k.shape[1], window, "cpu")
        x = torch.where(allowed, x, torch.full_like(x, TA.NEG_INF))
    return x


def _factor(B, H, T, S, rate, seed):
    """keep / (1 - rate) in fp32 (the kernels' inv_keep), or 1."""
    if rate == 0.0:
        return torch.ones(())
    keep = TA.attention_keep(B, H, T, S, seed, rate, "cpu")
    return torch.where(keep, float(np.float32(1.0 / (1.0 - rate))), 0.0)


def emulate_a(q, k, v, bias, scale, causal=False, window=0, rate=0.0, seed=None):
    """Kernel A's rounding points: returns (bf16 out (B, T, H, D), the row
    max m and denominator l (B, H, T) it hands to H)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    x = _logits(q, k, bias, scale, causal, window)
    F = _factor(B, H, T, S, rate, seed).expand(B, H, T, S)
    vf = v.float().transpose(1, 2)
    m = torch.full((B, H, T, 1), -torch.inf)
    l = torch.zeros((B, H, T, 1))
    o = torch.zeros((B, H, T, D))
    for s0 in range(0, S, TILE):
        xt = x[..., s0 : s0 + TILE]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(xt - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pf = (p * F[..., s0 : s0 + TILE]).to(BF16).float()
        o = o * alpha + pf @ vf[:, :, s0 : s0 + TILE]
        m = m_new
    return (o / l).transpose(1, 2).to(BF16), m[..., 0], l[..., 0]


def emulate_h(q, k, v, bias, g, out, m, l, scale, causal=False, window=0, rate=0.0, seed=None,
              delta=None):
    """Kernel H's rounding points from A's statistics: returns (dq bf16, dk,
    dv, dbias (B, S)). ``delta`` (B, H, T) replaces the wrapper's Σ dO·out."""
    B, T, H, D = q.shape
    S = k.shape[1]
    P = torch.exp(_logits(q, k, bias, scale, causal, window) - m[..., None]) * (1.0 / l[..., None])
    F = _factor(B, H, T, S, rate, seed)
    qf, kf, gf = (t.float().transpose(1, 2) for t in (q, k, g))
    dP = gf @ v.float().transpose(1, 2).transpose(-1, -2)
    if delta is None:
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
    dS = P * (dP * F - delta[..., None])
    if causal:
        dS = torch.where(TA._causal_allowed(T, S, window, "cpu"), dS, torch.zeros_like(dS))
    pf, dsb = (P * F).to(BF16).float(), dS.to(BF16).float()
    dv = (pf.transpose(-1, -2) @ gf).transpose(1, 2)
    dk = (dsb.transpose(-1, -2) @ qf).transpose(1, 2) * scale
    dq = ((dsb @ kf).transpose(1, 2) * scale).to(BF16)
    return dq, dk, dv, dS.sum(dim=(1, 2))


# ----------------------------------------------------------------- the tests


def _inputs(B, T, H, D, lengths, seed=0):
    """bf16 q, k, v, dO from a numpy seed, and the (B, T) key bias."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(BF16)
                  for _ in range(4))
    pad = np.arange(T)[None, :] >= np.asarray(lengths)[:, None]
    bias = torch.from_numpy(np.where(pad, TA.NEG_INF, 0.0).astype(np.float32))
    return q, k, v, g, bias


def _jnp(t, dtype=jnp.bfloat16):
    return jnp.asarray(t.float().numpy()).astype(dtype)


def _err(got, want, floor=1.0):
    """max|got - want| over the limit TOL · max(floor, largest |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (LIM * max(floor, np.abs(want).max()))


def _jax_vjp(q, k, v, bias, g, scale, causal, window, rate):
    """dq, dk, dv, dbias of JAX's reference in fp32 (its default backward)."""
    _, vjp = jax.vjp(
        lambda a, b_, c, d: j_reference(a * scale, b_, c, d, causal=causal, window=window,
                                        dropout_rate=rate,
                                        dropout_seed=jnp.uint32(SEED) if rate else None),
        *(_jnp(t, jnp.float32) for t in (q, k, v)), jnp.asarray(bias.numpy())[:, None, None, :])
    return vjp(_jnp(g, jnp.float32))


B, T, H, D = 2, 300, 2, 64
CASES = [(rate, causal, window) for rate in (0.0, 0.1) for causal, window in ((False, 0),
                                                                              (True, 64))]


@pytest.mark.parametrize("rate,causal,window", CASES)
def test_a_bf16_p_holds_the_card_tolerance(rate, causal, window):
    q, k, v, _, bias = _inputs(B, T, H, D, (300, 200))
    scale = D ** -0.5
    out, _, _ = emulate_a(q, k, v, bias, scale, causal, window, rate, SEED if rate else None)
    want = j_reference(_jnp(q) * scale, _jnp(k), _jnp(v), jnp.asarray(bias.numpy())[:, None, None],
                       causal=causal, window=window, dropout_rate=rate,
                       dropout_seed=jnp.uint32(SEED) if rate else None)
    assert _err(out.float(), want.astype(jnp.float32)) <= 1.0


@pytest.mark.parametrize("rate,causal,window", CASES)
def test_h_bf16_p_and_ds_hold_the_card_tolerance(rate, causal, window):
    q, k, v, g, bias = _inputs(B, T, H, D, (300, 200), seed=1)
    scale = D ** -0.5
    seed = SEED if rate else None
    out, m, l = emulate_a(q, k, v, bias, scale, causal, window, rate, seed)
    got = emulate_h(q, k, v, bias, g, out, m, l, scale, causal, window, rate, seed)
    want = _jax_vjp(q, k, v, bias, g, scale, causal, window, rate)
    for x, w in zip(got, want):
        assert _err(x.float().reshape(np.shape(w)), w) <= 1.0


@pytest.mark.parametrize("Tq", [1, 16])
def test_h_error_on_single_key_rows_is_deltas(Tq):
    """Rows of one valid key (lengths Tq and 1), dropout 0.1: exact Δ holds
    TOL; Δ from the bf16 output holds TOL · max(1, largest |Δ|)."""
    q, k, v, g, bias = _inputs(B, Tq, H, 128, (Tq, 1), seed=2)
    scale = 128 ** -0.5
    out, m, l = emulate_a(q, k, v, bias, scale, rate=0.1, seed=SEED)
    want = _jax_vjp(q, k, v, bias, g, scale, False, 0, 0.1)
    P = torch.softmax(_logits(q, k, bias, scale, False, 0), -1)
    dP = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    exact = (P * _factor(B, H, Tq, Tq, 0.1, SEED) * dP).sum(-1)
    for x, w in zip(emulate_h(q, k, v, bias, g, out, m, l, scale, rate=0.1, seed=SEED,
                              delta=exact), want):
        assert _err(x.float().reshape(np.shape(w)), w) <= 1.0
    delta_max = (g.float() * out.float()).sum(-1).abs().max().item()
    for x, w in zip(emulate_h(q, k, v, bias, g, out, m, l, scale, rate=0.1, seed=SEED), want):
        assert _err(x.float().reshape(np.shape(w)), w, max(1.0, delta_max)) <= 1.0
