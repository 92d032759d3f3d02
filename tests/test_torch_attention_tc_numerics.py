"""Where the bf16 tensor-core kernels A, G and H round, emulated in plain
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
* G: A's tile loop over the key tiles of each 64-row query tile's
  causal/window band only, then, when a row of the tile (one (b, h)
  block) ended the band with a running max below −5e8 (its band is all
  padding), over the skipped tiles too.
* H: P·F and dS rounded to bf16 before the dV, dK and dQ products, fp32
  accumulation; dQ stored as bf16, dK, dV and dbias in fp32. Δ = Σₖ P·(dP·F)
  is H-q's own fp32 sum of the products that form dS.

The emulation below (bf16 values, fp32 arithmetic) is held against JAX's
``reference_attention`` in bf16 (A) and ``jax.vjp`` of it in fp32 (H) at
B=2, T=300, H=2, D=64, dropout 0 and 0.1, non-causal and causal window 64,
to ``chip_smoke.TOL`` (bf16 2e-2) times max(1, largest |want|), the
tolerance of the card checks. A row whose whole window band is padding
(lengths 300 and 200) takes the uniform average in both.

A row with a single valid key has a softmax gradient of exactly 0: there
dS = P (dP F - Δ) cancels two terms of size |Δ|, so any error of Δ is the
whole result. With Δ from the same products as dS it cancels exactly; the
Δ = Σ dO·O that the port took from the bf16 output before reached 1.2-4.3
TOL there (``test_h_error_on_single_key_rows_is_deltas`` keeps that
record).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from mm_s2ut.ops.attention import _flash_call as j_flash_call
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


def emulate_h(q, k, v, bias, g, m, l, scale, causal=False, window=0, rate=0.0, seed=None,
              delta=None):
    """Kernel H's rounding points from A's statistics: returns (dq bf16, dk,
    dv, dbias (B, S)). Δ is the kernel's Σₖ P·(dP·F) in fp32 unless
    ``delta`` (B, H, T) replaces it."""
    B, T, H, D = q.shape
    S = k.shape[1]
    P = torch.exp(_logits(q, k, bias, scale, causal, window) - m[..., None]) * (1.0 / l[..., None])
    F = _factor(B, H, T, S, rate, seed)
    qf, kf, gf = (t.float().transpose(1, 2) for t in (q, k, g))
    dW = (gf @ v.float().transpose(1, 2).transpose(-1, -2)) * F
    if delta is None:
        delta = (P * dW).sum(-1)
    dS = P * (dW - delta[..., None])
    if causal:
        dS = torch.where(TA._causal_allowed(T, S, window, "cpu"), dS, torch.zeros_like(dS))
    pf, dsb = (P * F).to(BF16).float(), dS.to(BF16).float()
    dv = (pf.transpose(-1, -2) @ gf).transpose(1, 2)
    dk = (dsb.transpose(-1, -2) @ qf).transpose(1, 2) * scale
    dq = ((dsb @ kf).transpose(1, 2) * scale).to(BF16)
    return dq, dk, dv, dS.sum(dim=(1, 2))


def _tile_update(state, x, F, vf, s0, s1, bf16):
    """One key tile [s0, s1) into the online softmax (m, l, o) of the rows
    of ``x`` (B, H, rows, S): p = exp(x − m), p·F rounded to bf16 (or not)
    before ·V."""
    m, l, o = state
    xt = x[..., s0:s1]
    m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(xt - m_new)
    pf = p * F[..., s0:s1]
    if bf16:
        pf = pf.to(BF16).float()
    return m_new, l * alpha + p.sum(-1, keepdim=True), o * alpha + pf @ vf[:, :, s0:s1]


def emulate_g(q, k, v, bias, scale, window=0, rate=0.0, seed=None, bf16=True, bq=64, bk=64):
    """Kernel G's visit order and rounding points (``bf16``; fp32 without):
    per query tile of ``bq`` rows, the key tiles of ``bk`` keys that meet
    its band, [lo, hi); then, for each (b, h) block in which a row ended
    them with a running max below −5e8, the skipped tiles [0, lo) and
    [hi, n). Returns (out (B, T, H, D), m, l (B, H, T))."""
    B, T, H, D = q.shape
    S = k.shape[1]
    x = _logits(q, k, bias, scale, True, window)
    F = _factor(B, H, T, S, rate, seed).expand(B, H, T, S)
    vf = v.float().transpose(1, 2)
    n_tiles = -(-S // bk)
    outs, ms, ls = [], [], []
    for q0 in range(0, T, bq):
        rows = slice(q0, min(T, q0 + bq))
        hi = min(-(-(q0 + bq) // bk), n_tiles)
        lo = max(q0 - window + 1, 0) // bk if window > 0 else 0
        n = rows.stop - q0
        state = (torch.full((B, H, n, 1), -torch.inf), torch.zeros((B, H, n, 1)),
                 torch.zeros((B, H, n, D)))
        xr, Fr = x[:, :, rows], F[:, :, rows]
        for tile in range(lo, hi):
            state = _tile_update(state, xr, Fr, vf, tile * bk, min(S, tile * bk + bk), bf16)
        fall = (state[0] < -5e8).flatten(2).any(-1)[..., None, None]  # (B, H, 1, 1) per block
        for tile in [*range(lo), *range(hi, n_tiles)]:
            new = _tile_update(state, xr, Fr, vf, tile * bk, min(S, tile * bk + bk), bf16)
            state = tuple(torch.where(fall, a, b) for a, b in zip(new, state))
        m, l, o = state
        outs.append(o / l)
        ms.append(m[..., 0])
        ls.append(l[..., 0])
    out = torch.cat(outs, 2).transpose(1, 2)
    return (out.to(BF16) if bf16 else out), torch.cat(ms, 2), torch.cat(ls, 2)


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
    _, m, l = emulate_a(q, k, v, bias, scale, causal, window, rate, seed)
    got = emulate_h(q, k, v, bias, g, m, l, scale, causal, window, rate, seed)
    want = _jax_vjp(q, k, v, bias, g, scale, causal, window, rate)
    for x, w in zip(got, want):
        assert _err(x.float().reshape(np.shape(w)), w) <= 1.0


@pytest.mark.parametrize("Tq", [1, 16])
def test_h_error_on_single_key_rows_is_deltas(Tq):
    """The record of the Δ the port took from the bf16 output (Σ dO·O) before
    H summed its own: rows of one valid key (lengths Tq and 1), dropout
    0.1. The reference's exact Δ holds TOL; Σ dO·O holds only TOL · max(1,
    largest |Δ|)."""
    q, k, v, g, bias = _inputs(B, Tq, H, 128, (Tq, 1), seed=2)
    scale = 128 ** -0.5
    out, m, l = emulate_a(q, k, v, bias, scale, rate=0.1, seed=SEED)
    want = _jax_vjp(q, k, v, bias, g, scale, False, 0, 0.1)
    P = torch.softmax(_logits(q, k, bias, scale, False, 0), -1)
    dP = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    exact = (P * _factor(B, H, Tq, Tq, 0.1, SEED) * dP).sum(-1)
    for x, w in zip(emulate_h(q, k, v, bias, g, m, l, scale, rate=0.1, seed=SEED,
                              delta=exact), want):
        assert _err(x.float().reshape(np.shape(w)), w) <= 1.0
    from_out = (g.float() * out.float()).sum(-1).transpose(1, 2)
    delta_max = from_out.abs().max().item()
    for x, w in zip(emulate_h(q, k, v, bias, g, m, l, scale, rate=0.1, seed=SEED,
                              delta=from_out), want):
        assert _err(x.float().reshape(np.shape(w)), w, max(1.0, delta_max)) <= 1.0


@pytest.mark.parametrize("Tq", [1, 16])
def test_h_in_kernel_delta_holds_tol_on_single_key_rows(Tq):
    """H's own Δ = Σₖ P·(dP·F), from the products that form dS: on rows of
    one valid key (batch row 1, and both rows at Tq = 1) dS cancels to 0
    exactly, so dq, dk and dbias are exactly 0 there, and every output
    holds TOL · max(1, largest |want|) against ``jax.vjp`` of the JAX
    reference (D = 128, dropout 0.1)."""
    q, k, v, g, bias = _inputs(B, Tq, H, 128, (Tq, 1), seed=2)
    scale = 128 ** -0.5
    _, m, l = emulate_a(q, k, v, bias, scale, rate=0.1, seed=SEED)
    want = _jax_vjp(q, k, v, bias, g, scale, False, 0, 0.1)
    got = emulate_h(q, k, v, bias, g, m, l, scale, rate=0.1, seed=SEED)
    for x, w in zip(got, want):
        assert _err(x.float().reshape(np.shape(w)), w) <= 1.0
    dq, dk, _, dbias = got
    one_key = [0, 1] if Tq == 1 else [1]
    for t in (dq, dk, dbias):
        assert torch.count_nonzero(t[one_key].float()) == 0


S_G = 200  # four 64-key tiles: the band of a 64-row query tile skips some
G_CASES = [(window, tq, rate) for window in (0, 24, 5) for tq in (S_G, 150)
           for rate in (0.0, 0.1)]


def _g_inputs(tq, seed):
    """q (B, tq, H, 16) and k, v (B, S_G, H, 16), bf16, the last 9 keys of
    batch row 1 padded: with window 5 its rows 195..199 have an all-padding
    band."""
    q, k, v, _, bias = _inputs(B, S_G, H, 16, (S_G, S_G - 9), seed=seed)
    return q[:, :tq], k, v, bias


@pytest.mark.parametrize("window,tq,rate", G_CASES)
def test_g_visit_order_matches_jax(window, tq, rate):
    """G's visit order (band tiles, then the skipped ones where a block
    holds an all-padding-band row), in fp32 against JAX's reference on
    every row and JAX's Pallas G (``_flash_call(..., block_k=16)`` in
    interpret mode) on the rows whose band holds a key: 2e-5 abs / 1e-4
    rel, the summation order apart; in bf16, with the kernel's rounding
    points, against JAX's bf16 reference at TOL · max(1, largest |want|)."""
    q, k, v, bias = _g_inputs(tq, seed=5)
    scale = 16 ** -0.5
    seed = SEED if rate else None
    jbias = jnp.asarray(bias.numpy())[:, None, None, :]
    f32 = [_jnp(t, jnp.float32) for t in (q, k, v)]
    got32, _, _ = emulate_g(q, k, v, bias, scale, window, rate, seed, bf16=False)
    want_ref = np.asarray(j_reference(f32[0] * scale, f32[1], f32[2], jbias, causal=True,
                                      window=window, dropout_rate=rate,
                                      dropout_seed=jnp.uint32(SEED) if rate else None))
    np.testing.assert_allclose(got32.numpy(), want_ref, atol=2e-5, rtol=1e-4)
    want_g = np.asarray(j_flash_call(*f32, jbias, jnp.asarray(SEED if rate else 0, jnp.uint32),
                                     scale, 16, True, causal=True, window=window,
                                     dropout_rate=rate, block_k=16))
    t = np.arange(tq)[:, None]
    j = np.arange(S_G)[None, :]
    band = (j <= t) & ((j > t - window) if window > 0 else True)
    rows = (band[None] & (bias.numpy() == 0)[:, None, :]).any(-1)  # (B, tq)
    assert rows.all() == (window != 5 or tq < 195)
    np.testing.assert_allclose(got32.numpy()[rows], want_g[rows], atol=2e-5, rtol=1e-4)
    got16, _, _ = emulate_g(q, k, v, bias, scale, window, rate, seed)
    want16 = j_reference(_jnp(q) * scale, _jnp(k), _jnp(v), jbias, causal=True, window=window,
                         dropout_rate=rate, dropout_seed=jnp.uint32(SEED) if rate else None)
    assert _err(got16.float(), want16.astype(jnp.float32)) <= 1.0


@pytest.mark.parametrize("window", [0, 24, 5])
def test_g_equals_a_causal_on_rows_with_a_key(window):
    """Skipping is exact: on every row whose band holds a real key, bf16 G's
    emulation gives what A-causal's (every tile, in order) gives, the row
    statistics included; skipped tiles add p = 0 with alpha = 1, and tiles
    before the band only raise the −1e9 max that the first real logit
    wipes."""
    q, k, v, bias = _g_inputs(S_G, seed=6)
    scale = 16 ** -0.5
    g_out, g_m, g_l = emulate_g(q, k, v, bias, scale, window, 0.1, SEED)
    a_out, a_m, a_l = emulate_a(q, k, v, bias, scale, True, window, 0.1, SEED)
    t = np.arange(S_G)[:, None]
    j = np.arange(S_G)[None, :]
    band = (j <= t) & ((j > t - window) if window > 0 else True)
    rows = torch.from_numpy((band[None] & (bias.numpy() == 0)[:, None, :]).any(-1))
    torch.testing.assert_close(g_out[rows].float(), a_out[rows].float(), atol=0, rtol=0)
    rows_bh = rows[:, None, :].expand(B, H, S_G)
    torch.testing.assert_close(g_m[rows_bh], a_m[rows_bh], atol=0, rtol=0)
    torch.testing.assert_close(g_l[rows_bh], a_l[rows_bh], atol=0, rtol=0)
