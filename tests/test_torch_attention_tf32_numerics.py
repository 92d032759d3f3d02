"""The arithmetic of the fp32 kernels A, G and H on the tensor cores,
emulated in plain PyTorch on the CPU and held against the JAX package at
the card checks' fp32 tolerance.

fp32 A (``csrc/flash_attention.cu``) and H (``csrc/flash_attention_bwd.cu``)
do every product as 3xTF32 on ``mma.m16n8k8``:

* each operand x is split as hi = tf32(x), lo = tf32(x - hi), tf32 being
  ``cvt.rna``'s rounding (to nearest, ties away from zero, on the 13
  dropped mantissa bits; the kernels' ``tf32_rna``), and a product is
  lo·hi + hi·lo + hi·hi, three mma per 8-wide k-step, each adding its 8
  products to an fp32 accumulator (emulated below as the exact 8-term sum
  rounded once per mma; the tensor cores' own accumulation is coarser,
  which the card checks see and this emulation does not). The softmax
  weights P·F and H's dS are split like any operand, never rounded to a
  narrower type;
* A: the logit is fmaf(q·k, scale, bias) (−1e9 where masked), the online
  softmax runs per key tile of 64 keys (16 at D = 128) with
  p = exp2((x − m)·log2 e), l summing the unmasked p, O rescaled by
  exp2((m_old − m_new)·log2 e) before the tile's k-steps, and out = O·(1/l).
  Within a k-step the kernels read the keys in the order 0, 2, 4, 6, 1, 3,
  5, 7 so that the S accumulators serve as P's fragment; the 8 keys are
  those of one S n-tile, and an exact 8-term sum does not see their order;
* G: A's tile loop over the key tiles of each 64-row query tile's band,
  then, for a (b, h) block in which a row ended the band with a running
  max below −5e8, the skipped tiles;
* H: P = exp2((x − m)·log2 e)·(1/l) from A's statistics, Δ = Σₖ P·(dP·F)
  in fp32 from the products that form dS (so dS is exactly 0 on a row of
  one valid key), dS = P (dP·F − Δ) inside the band, then dV = (P·F)ᵀ·dO,
  dK = dSᵀ·Q·scale and dQ = dS·K·scale in k-steps of 8 queries or keys in
  order.

Held against JAX's ``reference_attention`` in fp32 (A, G: 1e-4 absolute,
``chip_smoke.TOL``) and ``jax.vjp`` of it (H: 1e-4 times max(1, largest
|want|)) at B=2, T=300, H=2, D=64, dropout 0 and 0.1, non-causal and causal
window 64 (lengths 300 and 200: rows whose whole window band is padding),
rows of one valid key for H, and the ViT's shape at small B·H (Tq = 577
over S = 584, 7 padded keys). A single TF32 pass (hi·hi of tf32 operands)
misses the tolerance at the ViT's shape, which is why the kernels take
three: ``test_single_pass_tf32_misses_where_three_hold`` records both.
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
SEED = 0x5EED
LIM = TOL[torch.float32]
LOG2E = float(np.float32(1.4426950408889634))


# ------------------------------------------------------------ the emulation


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as ``cvt.rna.tf32.f32`` (the kernels'
    ``tf32_rna``): + half an ulp of the 10-bit mantissa on the magnitude,
    then the 13 low bits cleared. int32 arithmetic wraps as the kernel's
    uint32 does, and no finite value carries into the sign."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, acc=None, passes: int = 3) -> torch.Tensor:
    """acc + a @ b (fp32, batched) as the kernels take it: k-steps of 8 in
    order, each adding lo·hi, hi·lo and hi·hi to the fp32 accumulator, one
    mma each (``passes`` = 1: the single product tf32(a)·tf32(b))."""
    a, b = a.float(), b.float()
    ah, al = split(a)
    bh, bl = split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            part = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            out = (out.double() + part).float()
    return out


def exp_e(x: torch.Tensor) -> torch.Tensor:
    """The kernels' exp: exp2f(x · log2 e) in fp32."""
    return torch.exp2(x * LOG2E)


def _logits(q, k, bias, scale, causal, window, passes=3):
    """(B, H, T, S) fp32 logits as the kernels form them: the 3xTF32 dot
    product, one fmaf with the scale and the key bias, −1e9 where masked."""
    dot = mm3(q.transpose(1, 2), k.permute(0, 2, 3, 1), passes=passes)
    x = (dot.double() * scale + bias.double()[:, None, None, :]).float()
    if causal:
        allowed = TA._causal_allowed(q.shape[1], k.shape[1], window, "cpu")
        x = torch.where(allowed, x, torch.full_like(x, TA.NEG_INF))
    return x


def _factor(B, H, T, S, rate, seed):
    """keep / (1 - rate) in fp32 (the kernels' inv_keep), or 1."""
    if rate == 0.0:
        return torch.ones((B, H, T, S))
    keep = TA.attention_keep(B, H, T, S, seed, rate, "cpu")
    return torch.where(keep, float(np.float32(1.0 / (1.0 - rate))), 0.0)


def _tile_update(state, x, F, vf, s0, s1, passes):
    """One key tile [s0, s1) into the online softmax (m, l, o) of the rows
    of ``x`` (B, H, rows, S)."""
    m, l, o = state
    xt = x[..., s0:s1]
    m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
    alpha = exp_e(m - m_new)
    p = exp_e(xt - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    o = mm3(p * F[..., s0:s1], vf[:, :, s0:s1], acc=o * alpha, passes=passes)
    return m_new, l, o


def emulate_a(q, k, v, bias, scale, causal=False, window=0, rate=0.0, seed=None, passes=3):
    """Kernel A in fp32: returns (out (B, T, H, D), the row max m and
    denominator l (B, H, T) it hands to H)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    bk = 64 if D <= 64 else 16
    x = _logits(q, k, bias, scale, causal, window, passes)
    F = _factor(B, H, T, S, rate, seed)
    vf = v.float().transpose(1, 2)
    state = (torch.full((B, H, T, 1), -torch.inf), torch.zeros((B, H, T, 1)),
             torch.zeros((B, H, T, D)))
    for s0 in range(0, S, bk):
        state = _tile_update(state, x, F, vf, s0, min(S, s0 + bk), passes)
    m, l, o = state
    return (o * (1.0 / l)).transpose(1, 2), m[..., 0], l[..., 0]


def emulate_g(q, k, v, bias, scale, window=0, rate=0.0, seed=None, bq=64):
    """Kernel G in fp32: per query tile of ``bq`` rows, the key tiles of the
    kernel's width that meet its band, [lo, hi); then, for each (b, h)
    block in which a row ended them with a running max below −5e8, the
    skipped tiles [0, lo) and [hi, n). Returns (out, m, l) as emulate_a."""
    B, T, H, D = q.shape
    S = k.shape[1]
    bk = 64 if D <= 64 else 16
    x = _logits(q, k, bias, scale, True, window)
    F = _factor(B, H, T, S, rate, seed)
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
            state = _tile_update(state, xr, Fr, vf, tile * bk, min(S, tile * bk + bk), 3)
        fall = (state[0] < -5e8).flatten(2).any(-1)[..., None, None]  # (B, H, 1, 1) per block
        for tile in [*range(lo), *range(hi, n_tiles)]:
            new = _tile_update(state, xr, Fr, vf, tile * bk, min(S, tile * bk + bk), 3)
            state = tuple(torch.where(fall, a, b) for a, b in zip(new, state))
        m, l, o = state
        outs.append(o * (1.0 / l))
        ms.append(m[..., 0])
        ls.append(l[..., 0])
    return torch.cat(outs, 2).transpose(1, 2), torch.cat(ms, 2), torch.cat(ls, 2)


def emulate_h(q, k, v, bias, g, m, l, scale, causal=False, window=0, rate=0.0, seed=None):
    """Kernel H in fp32 from A's statistics: returns (dq, dk, dv, dbias
    (B, S)), Δ the kernel's own Σₖ P·(dP·F) in fp32."""
    B, T, H, D = q.shape
    S = k.shape[1]
    P = exp_e(_logits(q, k, bias, scale, causal, window) - m[..., None]) * (1.0 / l[..., None])
    F = _factor(B, H, T, S, rate, seed)
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, g))
    dW = mm3(gf, vf.transpose(-1, -2)) * F
    delta = (P * dW).sum(-1, keepdim=True)
    dS = P * (dW - delta)
    if causal:
        dS = torch.where(TA._causal_allowed(T, S, window, "cpu"), dS, torch.zeros_like(dS))
    dv = mm3((P * F).transpose(-1, -2), gf).transpose(1, 2)
    dk = (mm3(dS.transpose(-1, -2), qf) * scale).transpose(1, 2)
    dq = (mm3(dS, kf) * scale).transpose(1, 2)
    return dq, dk, dv, dS.sum(dim=(1, 2))


# ----------------------------------------------------------------- the tests


def _inputs(B, T, H, D, lengths, seed=0, S=None):
    """fp32 q (B, T, H, D), k, v (B, S, H, D), dO from a numpy seed, and the
    (B, S) key bias of the lengths."""
    S = T if S is None else S
    rng = np.random.RandomState(seed)
    q, g = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)) for _ in range(2))
    pad = np.arange(S)[None, :] >= np.asarray(lengths)[:, None]
    bias = torch.from_numpy(np.where(pad, TA.NEG_INF, 0.0).astype(np.float32))
    return q, k, v, g, bias


def _jnp(t):
    return jnp.asarray(t.numpy())


def _jax_forward(q, k, v, bias, scale, causal=False, window=0, rate=0.0):
    return np.asarray(j_reference(_jnp(q) * scale, _jnp(k), _jnp(v), _jnp(bias)[:, None, None, :],
                                  causal=causal, window=window, dropout_rate=rate,
                                  dropout_seed=jnp.uint32(SEED) if rate else None))


def _jax_vjp(q, k, v, bias, g, scale, causal=False, window=0, rate=0.0):
    """dq, dk, dv, dbias of JAX's reference in fp32 (its default backward)."""
    _, vjp = jax.vjp(
        lambda a, b_, c, d: j_reference(a * scale, b_, c, d, causal=causal, window=window,
                                        dropout_rate=rate,
                                        dropout_seed=jnp.uint32(SEED) if rate else None),
        _jnp(q), _jnp(k), _jnp(v), _jnp(bias)[:, None, None, :])
    return vjp(_jnp(g))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _abs_err(got, want):
    return np.abs(_np(got) - _np(want)).max()


def _scaled_err(got, want):
    """max|got - want| over TOL · max(1, largest |want|)."""
    want = _np(want)
    return _abs_err(_np(got).reshape(want.shape), want) / (LIM * max(1.0, np.abs(want).max()))


B, T, H, D = 2, 300, 2, 64
CASES = [(rate, causal, window) for rate in (0.0, 0.1) for causal, window in ((False, 0),
                                                                              (True, 64))]


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 keeps 10 mantissa bits: below half an ulp (2^-11 relative)
    rounds down, a tie rounds away from zero for either sign, and hi + lo
    carries x to within 2^-22 of |x|."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2 - 2 ** -23, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + 3 * one_ulp / 2, 3.0e-3, -7.25])
    got = tf32(x)
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0 + 2 * one_ulp], dtype=torch.float64)
    assert torch.equal(got[:4].double(), want)
    assert torch.equal(got[5], x[5])  # exactly representable
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32))
    hi, lo = split(r)
    assert ((hi.double() - r.double()).abs() <= r.double().abs() * 2 ** -11).all()
    assert ((hi.double() + lo.double() - r.double()).abs() <= r.double().abs() * 2 ** -22).all()


@pytest.mark.parametrize("rate,causal,window", CASES)
def test_a_3xtf32_holds_fp32_tol(rate, causal, window):
    q, k, v, _, bias = _inputs(B, T, H, D, (300, 200))
    scale = D ** -0.5
    out, _, _ = emulate_a(q, k, v, bias, scale, causal, window, rate, SEED if rate else None)
    want = _jax_forward(q, k, v, bias, scale, causal, window, rate)
    assert _abs_err(out, want) <= LIM


@pytest.mark.parametrize("rate,causal,window", CASES)
def test_h_3xtf32_holds_fp32_tol(rate, causal, window):
    q, k, v, g, bias = _inputs(B, T, H, D, (300, 200), seed=1)
    scale = D ** -0.5
    seed = SEED if rate else None
    _, m, l = emulate_a(q, k, v, bias, scale, causal, window, rate, seed)
    got = emulate_h(q, k, v, bias, g, m, l, scale, causal, window, rate, seed)
    want = _jax_vjp(q, k, v, bias, g, scale, causal, window, rate)
    for x, w in zip(got, want):
        assert _scaled_err(x, w) <= 1.0


@pytest.mark.parametrize("Tq", [1, 16])
def test_h_3xtf32_single_key_rows_are_exactly_zero(Tq):
    """H's own Δ = Σₖ P·(dP·F), from the products that form dS: on rows of
    one valid key (batch row 1, and both rows at Tq = 1) dS cancels to 0
    exactly, so dq, dk and dbias are exactly 0 there, and every output holds
    TOL · max(1, largest |want|) against ``jax.vjp`` of the JAX reference
    (D = 128, dropout 0.1)."""
    q, k, v, g, bias = _inputs(B, Tq, H, 128, (Tq, 1), seed=2)
    scale = 128 ** -0.5
    _, m, l = emulate_a(q, k, v, bias, scale, rate=0.1, seed=SEED)
    want = _jax_vjp(q, k, v, bias, g, scale, rate=0.1)
    got = emulate_h(q, k, v, bias, g, m, l, scale, rate=0.1, seed=SEED)
    for x, w in zip(got, want):
        assert _scaled_err(x, w) <= 1.0
    dq, dk, _, dbias = got
    one_key = [0, 1] if Tq == 1 else [1]
    for t in (dq, dk, dbias):
        assert torch.count_nonzero(t[one_key]) == 0


S_G = 200  # four 64-key tiles: the band of a 64-row query tile skips some
G_CASES = [(window, tq, rate) for window in (0, 24, 5) for tq in (S_G, 150)
           for rate in (0.0, 0.1)]


def _g_inputs(tq, seed, d=16):
    """q (B, tq, H, d) and k, v (B, S_G, H, d), the last 9 keys of batch row
    1 padded: with window 5 its rows 195..199 have an all-padding band."""
    q, k, v, _, bias = _inputs(B, S_G, H, d, (S_G, S_G - 9), seed=seed)
    return q[:, :tq], k, v, bias


@pytest.mark.parametrize("window,tq,rate", G_CASES)
def test_g_3xtf32_visit_order_holds_fp32_tol(window, tq, rate):
    """G's visit order (band tiles, then the skipped ones where a block
    holds an all-padding-band row) against JAX's reference on every row,
    the all-padding-band rows' uniform average included."""
    q, k, v, bias = _g_inputs(tq, seed=5)
    scale = 16 ** -0.5
    got, _, _ = emulate_g(q, k, v, bias, scale, window, rate, SEED if rate else None)
    want = _jax_forward(q, k, v, bias, scale, True, window, rate)
    assert _abs_err(got, want) <= LIM


@pytest.mark.parametrize("window", [0, 24, 5])
def test_g_3xtf32_equals_a_causal_on_rows_with_a_key(window):
    """Skipping is exact: on every row whose band holds a real key, G's
    emulation gives A-causal's bits (every tile, in order), the row
    statistics included; skipped tiles add p = 0 with alpha = 1, and
    tiles before the band only raise the −1e9 max that the first real
    logit wipes."""
    q, k, v, bias = _g_inputs(S_G, seed=6)
    scale = 16 ** -0.5
    g_out, g_m, g_l = emulate_g(q, k, v, bias, scale, window, 0.1, SEED)
    a_out, a_m, a_l = emulate_a(q, k, v, bias, scale, True, window, 0.1, SEED)
    t = np.arange(S_G)[:, None]
    j = np.arange(S_G)[None, :]
    band = (j <= t) & ((j > t - window) if window > 0 else True)
    rows = torch.from_numpy((band[None] & (bias.numpy() == 0)[:, None, :]).any(-1))
    assert torch.equal(g_out[rows], a_out[rows])
    rows_bh = rows[:, None, :].expand(B, H, S_G)
    assert torch.equal(g_m[rows_bh], a_m[rows_bh])
    assert torch.equal(g_l[rows_bh], a_l[rows_bh])


VIT_TQ, VIT_S = 577, 584  # ViT-B/16 at 384²: 577 tokens, keys padded to 584


def _vit_inputs(seed, Bv=1, Hv=2):
    """The ViT's attention at small B·H: Tq = 577 queries over S = 584 keys,
    the last 7 padding, D = 64, N(0, 1) values."""
    return _inputs(Bv, VIT_TQ, Hv, 64, (VIT_TQ,) * Bv, seed=seed, S=VIT_S)


def test_a_3xtf32_at_the_vit_shape():
    q, k, v, _, bias = _vit_inputs(7)
    out, _, _ = emulate_a(q, k, v, bias, 0.125)
    assert _abs_err(out, _jax_forward(q, k, v, bias, 0.125)) <= LIM


def test_h_3xtf32_at_the_vit_shape():
    """H at the ViT's training shape: every output within TOL · max(1,
    largest |want|), and the padded keys' dk and dv exactly 0."""
    q, k, v, g, bias = _vit_inputs(8)
    _, m, l = emulate_a(q, k, v, bias, 0.125)
    got = emulate_h(q, k, v, bias, g, m, l, 0.125)
    for x, w in zip(got, _jax_vjp(q, k, v, bias, g, 0.125)):
        assert _scaled_err(x, w) <= 1.0
    for x in got[1:3]:
        assert torch.count_nonzero(x[:, VIT_TQ:]) == 0


def test_single_pass_tf32_misses_where_three_hold():
    """The record of why the products take three passes: at the ViT's shape
    one TF32 pass (tf32 operands, hi·hi alone) leaves A's output at least
    1e-5 off JAX's fp32 reference, a tenth of the fp32 tolerance, where
    3xTF32 stays below it."""
    q, k, v, _, bias = _vit_inputs(9)
    want = _jax_forward(q, k, v, bias, 0.125)
    errs = {p: _abs_err(emulate_a(q, k, v, bias, 0.125, passes=p)[0], want) for p in (1, 3)}
    print(f"max|err| at the ViT shape: 1 x TF32 {errs[1]:.3e}, 3 x TF32 {errs[3]:.3e}")
    assert errs[3] < 1e-5 <= errs[1]
