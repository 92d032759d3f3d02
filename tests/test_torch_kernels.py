"""The port's plain versions of kernels A, B and C (mm_s2ut_torch/ops)
against the JAX package's Pallas kernels run in interpret mode, on the
same numpy inputs. fp32, atol 1e-5: both sides compute the same
contraction in fp32 and differ only in summation order.

On the CPU each wrapper takes its plain version; the CUDA kernels
themselves are held against the same plain versions on the card
(chip_smoke.py, tests/test_torch_cuda.py). Kernel B's split-and-merge
algorithm is emulated here step by step (:func:`emulate_b_split`, never
on the main path) and held against the JAX kernel at fp32 1e-5 abs /
1e-4 rel: the splits change only the order of the sums."""
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
