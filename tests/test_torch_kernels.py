"""The port's plain versions of kernels A, B and C (mm_s2ut_torch/ops)
against the JAX package's Pallas kernels run in interpret mode, on the
same numpy inputs. fp32, atol 1e-5: both sides compute the same
contraction in fp32 and differ only in summation order.

On the CPU each wrapper takes its plain version; the CUDA kernels
themselves are held against the same plain versions on the card
(chip_smoke.py, tests/test_torch_cuda.py). Kernel B's split-and-merge
algorithm is emulated here step by step (:func:`emulate_b_split`, never
on the main path) and held against the JAX kernel at fp32 1e-5 abs /
1e-4 rel: the splits change only the order of the sums. So are kernel C's
tile walk (:func:`emulate_c_tiles`: warps and splits, all-padding spans,
P rounded to bf16 within chip_smoke.TOL) and kernel D's two split passes
(:func:`emulate_d_split`, at chip_smoke.TOL_REQUANT's fp32 2e-3)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.ops import decode_attention as jda
from mm_s2ut_torch.ops import attention as tattn
from mm_s2ut_torch.ops import decode_attention as tda

torch.set_num_threads(1)
ATOL = 1e-5
# mm_s2ut.ops re-exports the function ``attention``, which shadows the module.
jattn = importlib.import_module("mm_s2ut.ops.attention")


@pytest.mark.parametrize(
    "B,T,H,D,pad",
    [
        (2, 24, 2, 16, False),   # aligned, no padding
        (2, 37, 4, 16, True),    # ragged T, padded keys
        (1, 9, 2, 64, True),     # head dim of the flagship
    ],
)
def test_flash_attention_matches_pallas(B, T, H, D, pad):
    rng = np.random.RandomState(T)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) * 0.5 for _ in range(3))
    lengths = np.maximum(T - 7 * np.arange(B), 3) if pad else np.full(B, T)
    kpm = np.arange(T)[None, :] >= lengths[:, None]
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpm),
        block_q=8, interpret=True,
    ))
    got = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(kpm)
    )
    assert tattn.flash_attention.launches == 0  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _ancestry_inputs(B, H, K, T, L, Dh, step, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, K, Dh).astype(np.float32) * 0.3
    k_new = rng.randn(B, H, K, Dh).astype(np.float32) * 0.3
    v_new = rng.randn(B, H, K, Dh).astype(np.float32) * 0.3
    kv = rng.randn(B, L, H, T * K, 2 * Dh).astype(np.float32) * 0.3
    ancestry = rng.randint(0, K, (B, K, T))
    t_idx = np.arange(T)[None, None, :]
    flat_idx = np.where(t_idx < step, t_idx * K + ancestry, -1)
    flat_rep = np.repeat(flat_idx, K, axis=2).astype(np.int32)
    return q, k_new, v_new, kv, flat_rep


@pytest.mark.parametrize(
    "K,step",
    [(1, 0), (1, 11), (10, 0), (10, 7), (10, 16), (3, 9)],
)
def test_ancestry_decode_matches_pallas(K, step):
    B, H, T, L, Dh = 2, 2, 16, 2, 16
    q, k_new, v_new, kv, flat_rep = _ancestry_inputs(B, H, K, T, L, Dh, step, seed=K + step)
    for layer in range(L):
        want = np.asarray(jda.ancestry_decode_attention(
            *map(jnp.asarray, (q, k_new, v_new, kv, flat_rep)), layer, interpret=True
        ))
        got = tda.ancestry_decode_attention(
            *map(torch.from_numpy, (q, k_new, v_new, kv, flat_rep)), layer
        ).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        if step == 0:  # no column on any path: exactly the fresh value
            np.testing.assert_array_equal(got, v_new)


def test_ancestry_decode_reads_a_segment_view():
    """The first cap·K columns of one full allocation (the beam search's
    segment view) give what a cache of exactly that size gives."""
    B, H, K, T, L, Dh = 2, 2, 3, 12, 2, 16
    q, k_new, v_new, kv, flat_rep = _ancestry_inputs(B, H, K, T, L, Dh, 5, seed=3)
    full = torch.from_numpy(np.concatenate([kv, np.ones_like(kv)], axis=3))
    view = full[:, :, :, : T * K]
    assert not view.is_contiguous()
    args = [torch.from_numpy(a) for a in (q, k_new, v_new)]
    got = tda.ancestry_decode_attention(*args, view, torch.from_numpy(flat_rep), 1)
    want = tda.ancestry_decode_attention(*args, torch.from_numpy(kv), torch.from_numpy(flat_rep), 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def emulate_b_split(q, k_new, v_new, kv, flat_rep, layer, n_split, tile=32):
    """Kernel B's algorithm (``csrc/decode_attention.cu``) in fp32: the T·S
    columns cut into ``n_split`` spans of ceil(T·S / n_split); in each span
    the columns on some beam's path, in order, in tiles of ``tile``, with
    one online softmax per (head, beam) (score −inf off the beam's path);
    then per (b, h) the merge of the spans' (max, denominator, w·V), in
    span order, with the beam's own logit q·k_new and v_new. Returns (out
    (B, H, K, Dh), the number of spans that held no live column)."""
    B, H, K, Dh = q.shape
    TS = kv.shape[3]
    span = -(-TS // n_split)
    slab = kv[:, layer].float()
    on = flat_rep == torch.arange(TS, dtype=torch.int32)  # (B, K, TS)
    out = torch.empty((B, H, K, Dh))
    empty = 0
    for b in range(B):
        parts = []
        for sp in range(n_split):
            cols = torch.arange(sp * span, min(TS, sp * span + span))
            cols = cols[on[b][:, cols].any(0)]
            empty += cols.numel() == 0
            m = torch.full((H, K), -torch.inf)
            l, acc = torch.zeros((H, K)), torch.zeros((H, K, Dh))
            for c0 in range(0, cols.numel(), tile):
                c = cols[c0 : c0 + tile]
                s = torch.einsum("hkd,hcd->hkc", q[b].float(), slab[b][:, c, :Dh])
                s = torch.where(on[b][:, c][None], s, torch.full_like(s, -torch.inf))
                m_new = torch.maximum(m, s.amax(-1))
                seen = m_new > -torch.inf
                alpha = torch.where(seen, torch.exp(m - m_new), torch.ones_like(m))
                p = torch.where(seen[..., None], torch.exp(s - m_new[..., None]),
                                torch.zeros_like(s))
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ slab[b][:, c, Dh:]
                m = m_new
            parts.append((m, l, acc))
        self_logit = (q[b].float() * k_new[b].float()).sum(-1)  # (H, K)
        mx = self_logit
        for m, _, _ in parts:
            mx = torch.maximum(mx, m)
        p_self = torch.exp(self_logit - mx)
        den, num = p_self.clone(), p_self[..., None] * v_new[b].float()
        for m, l, acc in parts:
            sc = torch.where(m > -torch.inf, torch.exp(m - mx), torch.zeros_like(m))
            den = den + sc * l
            num = num + sc[..., None] * acc
        out[b] = num / den[..., None]
    return out.to(q.dtype), empty


@pytest.mark.parametrize(
    "K,step,n_split",
    [
        (1, 0, 1),     # step 0: exactly v_new
        (1, 11, 3),    # T·S = 16, smaller than one tile
        (5, 7, 3),
        (5, 16, 8),
        (10, 0, 8),
        (10, 2, 8),    # spans with no live column
        (10, 16, 1),
        (10, 9, 3),
        (16, 16, 8),
        (16, 5, 3),
    ],
)
def test_ancestry_split_merge_matches_pallas(K, step, n_split):
    """Kernel B's split-and-merge (any split count) against the JAX kernel
    in interpret mode, at fp32 1e-5 abs / 1e-4 rel."""
    B, H, T, L, Dh = 2, 2, 16, 2, 16
    q, k_new, v_new, kv, flat_rep = _ancestry_inputs(B, H, K, T, L, Dh, step, seed=K + step + 7)
    want = np.asarray(jda.ancestry_decode_attention(
        *map(jnp.asarray, (q, k_new, v_new, kv, flat_rep)), 1, interpret=True))
    got, empty = emulate_b_split(*map(torch.from_numpy, (q, k_new, v_new, kv, flat_rep)), 1,
                                 n_split)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    if step == 0:  # no column on any path: exactly the fresh value
        np.testing.assert_array_equal(got.numpy(), v_new)
    if (K, step, n_split) == (10, 2, 8):
        assert empty > 0


@pytest.mark.parametrize("K,S,pad", [(1, 24, True), (10, 13, True), (10, 40, False)])
def test_cross_decode_matches_pallas(K, S, pad):
    rng = np.random.RandomState(K * S)
    B, H, Dh = 2, 2, 16
    q = rng.randn(B, H, K, Dh).astype(np.float32) * 0.3
    kv = rng.randn(B, H, S, 2 * Dh).astype(np.float32) * 0.3
    mask = (rng.rand(B, S) < 0.3) if pad else np.zeros((B, S), bool)
    mask[:, 0] = False
    bias = np.where(mask, -1e9, 0.0).astype(np.float32)
    want = np.asarray(jda.cross_decode_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bias), interpret=True
    ))
    got = tda.cross_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(bias)
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# ------------------------------------------------------------ kernels C and D


def emulate_c_tiles(q, kv, bias, n_split, tile=32, warps=4, bf16=False):
    """Kernel C's tile walk (``csrc/decode_attention.cu``) in fp32: per (b,
    h) the S keys in tiles of ``tile``, the tiles cut into ``n_split``
    spans of ceil(n_tiles / n_split) tiles, warp w of a span taking its
    tiles w, w + warps, ...; each warp an online softmax (logit q·k + bias,
    −inf past S; a warp or split whose max is −inf weighs 0), ``bf16``
    rounding p to bf16 before P·V and the output to bf16; the warps merged,
    then the spans, in order. With warps=1, n_split=1 and A's 64-key tiles
    this is the walk of A's forward, which C's many-row prefill takes."""
    B, H, K, Dh = q.shape
    S = kv.shape[2]
    n_tiles = -(-S // tile)
    tps = -(-n_tiles // n_split)
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (lambda x: x)
    qf, kf, vf = q.float(), kv[..., :Dh].float(), kv[..., Dh:].float()
    out = torch.empty((B, H, K, Dh))
    empty = 0  # (b, h, split)s whose keys are all padding

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        l, acc = torch.zeros(K), torch.zeros((K, Dh))
        for pm, pl, pacc in parts:
            w = torch.where(pm > -torch.inf, torch.exp(pm - m), torch.zeros_like(pm))
            w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
            l, acc = l + w * pl, acc + w[:, None] * pacc
        return m, l, acc

    for b in range(B):
        for h in range(H):
            splits = []
            for sp in range(-(-n_tiles // tps)):
                lanes = []
                for w in range(warps):
                    m, l, acc = torch.full((K,), -torch.inf), torch.zeros(K), torch.zeros((K, Dh))
                    for i in range(sp * tps + w, min(n_tiles, (sp + 1) * tps), warps):
                        s = torch.arange(i * tile, min(S, i * tile + tile))
                        x = qf[b, h] @ kf[b, h, s].T + bias[b, s].float()
                        m_new = torch.maximum(m, x.amax(-1))
                        seen = m_new > -torch.inf
                        alpha = torch.where(seen, torch.exp(m - m_new), torch.ones_like(m))
                        p = torch.where(seen[:, None], torch.exp(x - m_new[:, None]),
                                        torch.zeros_like(x))
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + rnd(p) @ vf[b, h, s]
                        m = m_new
                    lanes.append((m, l, acc))
                splits.append(merge(lanes))
                cols = slice(sp * tps * tile, min(S, (sp + 1) * tps * tile))
                empty += bool((bias[b, cols] < -5e8).all())
            _, l, acc = merge(splits)
            out[b, h] = rnd(acc / l[:, None])
    return out, empty


def _cross_inputs(B, H, K, S, Dh, lengths, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, K, Dh).astype(np.float32) * 0.3
    kv = rng.randn(B, H, S, 2 * Dh).astype(np.float32) * 0.3
    bias = np.where(np.arange(S)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    return q, kv, bias.astype(np.float32)


C_CASES = [  # (K, S, Dh, lengths, n_split, tile, warps)
    (10, 250, 16, (250, 40), 4, 32, 4),   # row 1: padding fills splits 1-3
    (10, 250, 64, (250, 3), 8, 32, 4),    # one tile per split, most of them padding
    (1, 13, 32, (13, 5), 1, 32, 4),       # S under one tile
    (16, 70, 128, (70, 1), 2, 16, 4),     # Dh = 128: 16-key tiles; a row of one key
    (5, 200, 16, (200, 130), 1, 32, 4),   # one split, every warp several tiles (B = 128)
    (37, 100, 16, (100, 30), 1, 64, 1),   # the prefill's rows: A's 64-key walk
]


@pytest.mark.parametrize("K,S,Dh,lengths,n_split,tile,warps", C_CASES)
def test_cross_tile_walk_matches_pallas(K, S, Dh, lengths, n_split, tile, warps):
    """Kernel C's tile walk, warp and split merge against the JAX kernel in
    interpret mode: fp32 without rounding at 1e-5 abs / 1e-4 rel; with P
    rounded to bf16 (bf16 q, slab and output, against the JAX kernel in
    bf16) within chip_smoke.TOL's 2e-2."""
    from chip_smoke import TOL

    q, kv, bias = _cross_inputs(2, 2, K, S, Dh, lengths, seed=K + S + Dh)
    want = np.asarray(jda.cross_decode_attention(jnp.asarray(q), jnp.asarray(kv),
                                                 jnp.asarray(bias), interpret=True))
    got, empty = emulate_c_tiles(*map(torch.from_numpy, (q, kv, bias)), n_split, tile, warps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    if n_split > 1:
        assert empty > 0  # a split wholly padding
    qb, kvb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, kv))
    want_bf16 = np.asarray(jda.cross_decode_attention(
        jnp.asarray(qb.float().numpy(), jnp.bfloat16), jnp.asarray(kvb.float().numpy(), jnp.bfloat16),
        jnp.asarray(bias), interpret=True).astype(jnp.float32))
    got_bf16, _ = emulate_c_tiles(qb, kvb, torch.from_numpy(bias), n_split, tile, warps, bf16=True)
    assert np.abs(got_bf16.numpy() - want_bf16).max() <= TOL[torch.bfloat16]


def _i8_inputs(B, H, K, T, L, Dh, step, seed):
    """q, k_new, v_new (B, H, K, Dh), an int8 cache (B, L, H, T·K, 2·Dh)
    quantized by the decoder's write path with its scales, and the
    flat_rep of a random ancestry at ``step``."""
    from mm_s2ut_torch.models.decoder import quantize_rows

    rng = np.random.RandomState(seed)
    q, k_new, v_new = (rng.randn(B, H, K, Dh).astype(np.float32) * 0.3 for _ in range(3))
    kv = torch.from_numpy(rng.randn(B, L, H, T * K, 2 * Dh).astype(np.float32) * 0.3)
    rows, sk, sv = quantize_rows(kv[..., :Dh], kv[..., Dh:], 127.0)
    ancestry = rng.randint(0, K, (B, K, T))
    t_idx = np.arange(T)[None, None, :]
    flat_rep = np.repeat(np.where(t_idx < step, t_idx * K + ancestry, -1), K, axis=2)
    return q, k_new, v_new, rows.numpy(), sk.numpy(), sv.numpy(), flat_rep.astype(np.int32)


def emulate_d_split(q, k_new, v_new, kv, sk, sv, flat_rep, layer, n_split, w8=None):
    """Kernel D's two passes (``csrc/decode_attention_q.cu``) in fp32: the
    T steps cut into ``n_split`` spans of ceil(T / n_split) steps. Pass 1:
    per span the live columns; exact integer scores s32 = q8·k8, score =
    (s32·qs)·sk stored per (beam, step), then the span's (max, sum of exp)
    per beam from its stored scores. Pass 2: the spans' (max, sum) folded
    with the self logit into m and den, ws from the whole row's stored
    scores, w8 = rint(w_eff / ws) (or the given ``w8``, (B, H, K, T·S)),
    and each span's int32 sum of w8·v8; out = float(Σ spans)·ws +
    (p_self / den)·v_new. Returns (out, the total int sums (B, H, K, Dh),
    w8, the number of spans with no live column)."""
    B, H, K, Dh = q.shape
    TS = kv.shape[3]
    T = TS // K
    spt = -(-T // n_split)
    n_split = -(-T // spt)
    q8, qs, sl = tda._quantize_q(q, k_new)
    slab = kv[:, layer].long()
    skl, svl = sk[:, layer].float(), sv[:, layer].float()
    on = flat_rep == torch.arange(TS, dtype=torch.int32)  # (B, K, TS)
    out = torch.empty((B, H, K, Dh))
    totals = torch.zeros((B, H, K, Dh), dtype=torch.long)
    w8_all = torch.zeros((B, H, K, TS))
    empty = 0
    for b in range(B):
        spans = []
        for sp in range(n_split):
            cols = torch.arange(sp * spt * K, min(TS, (sp + 1) * spt * K))
            cols = cols[on[b][:, cols].any(0)]
            empty += cols.numel() == 0
            spans.append(cols)
        for h in range(H):
            sc = torch.full((K, T), -torch.inf)
            pm, pl = torch.full((n_split, K), -torch.inf), torch.zeros((n_split, K))
            for sp, cols in enumerate(spans):
                s32 = (q8[b, h].long() @ slab[b, h, cols, :Dh].T).float()  # exact
                x = (s32 * qs[b, h][:, None]) * skl[b, h, cols]
                for k, t in zip(*torch.nonzero(on[b][:, cols], as_tuple=True)):
                    sc[k, cols[t] // K] = x[k, t]
                span = sc[:, sp * spt : (sp + 1) * spt]
                M = span.amax(-1)
                seen = M > -torch.inf
                pm[sp] = M
                pl[sp] = torch.where(seen[:, None], torch.exp(span - M[:, None]),
                                     torch.zeros_like(span)).sum(-1)
            m = torch.maximum(sl[b, h], pm.amax(0))
            den = torch.where(pm > -torch.inf, torch.exp(pm - m), torch.zeros_like(pm))
            den = (den * pl).sum(0)
            p_self = torch.exp(sl[b, h] - m)
            den = den + p_self
            t_idx = torch.arange(TS) // K
            x = torch.where(on[b], sc[:, t_idx], torch.full((K, TS), -torch.inf))
            w_eff = (torch.exp(x - m[:, None]) / den[:, None]) * svl[b, h][None]
            ws = w_eff.amax(-1) / 127.0 + 1e-20
            w8_bh = torch.round(w_eff / ws[:, None]) if w8 is None else w8[b, h]
            w8_all[b, h] = w8_bh
            for cols in spans:
                totals[b, h] += w8_bh[:, cols].long() @ slab[b, h, cols, Dh:]
            out[b, h] = totals[b, h].float() * ws[:, None] + (p_self / den)[:, None] * v_new[b, h]
    return out.to(q.dtype), totals, w8_all, empty


D_CASES = [(K, step, n_split) for K, step in ((1, 0), (1, 11), (5, 7), (10, 16), (10, 3), (16, 9))
           for n_split in (1, 3, 8)]


@pytest.mark.parametrize("K,step,n_split", D_CASES)
def test_int8_split_passes_match_pallas(K, step, n_split):
    """Kernel D's two split passes against the JAX kernel in interpret mode
    at fp32 2e-3 (chip_smoke.TOL_REQUANT: a w8 level may flip at a rounding
    tie, the denominator summed in another order); step 0 exactly v_new;
    fed the same w8, the int32 sums equal the one-span sums exactly."""
    from chip_smoke import TOL_REQUANT

    B, H, T, L, Dh = 2, 2, 16, 2, 32
    args = _i8_inputs(B, H, K, T, L, Dh, step, seed=K + step)
    want = np.asarray(jda.ancestry_decode_attention_i8(*map(jnp.asarray, args), 1, interpret=True))
    targs = list(map(torch.from_numpy, args))
    got, totals, w8, empty = emulate_d_split(*targs, 1, n_split)
    assert np.abs(got.numpy() - want).max() <= TOL_REQUANT[torch.float32]
    if step == 0:
        np.testing.assert_array_equal(got.numpy(), args[2])
    if step < T and n_split == 8:
        assert empty > 0  # spans past the step hold no live column
    _, one, _, _ = emulate_d_split(*targs, 1, 1, w8=w8)
    assert torch.equal(totals, one)
