"""The arithmetic of the fp32 kernels B, C and E on the tensor cores,
emulated in plain PyTorch on the CPU and held against the JAX package's
Pallas kernels (interpret mode) at the card checks' fp32 tolerance.

fp32 B and C (``csrc/decode_attention.cu``) do every product as 3xTF32 on
``mma.m16n8k8``, as fp32 A does (``tests/test_torch_attention_tf32_numerics.py``
emulates that product: ``mm3``, each operand split into tf32 halves by
``cvt.rna``'s rounding, lo·hi + hi·lo + hi·hi per 8-wide k-step, each mma
rounded once into the fp32 accumulator). What differs is the walk:

* B: per (b, split of ceil(T·S / n_split) columns) the columns on some
  beam's path, in column order, cut into tiles of 8;
  warp w of 4 takes tiles w, w + 4, ... and keeps its own online softmax
  per beam (logit −inf off the beam's path, p = exp2((x − m)·log2 e), 0
  while the beam's max is −inf); the warps merge in warp order (a warp
  that saw no column weighs 0), then the merge kernel folds the splits in
  split order with the beam's own logit q·k_new (fp32) and v_new, the
  splits' weights by expf. P is kept in fp32 and split like any operand.
* C: the S keys in tiles of 16 (8 at Dh = 128), cut into n_split spans of
  whole tiles; warp w of a span takes its tiles w, w + 4, ...; the logit
  is q·k + bias (−inf past S); the warps merge as B's; one split divides
  by l, several are folded in split order by the merge kernel (expf).
* C's prefill rows (K > 16) take fp32 A with scale 1 over the slab's K and
  V halves: A's 64-key walk (``emulate_a``).
* E (``csrc/decode_attention_q.cu``, the int8 slab): C's walk over 32-key
  tiles (16 at Dh = 128), any number of rows (each group of 16 is a block
  of its own, and rows do not meet in the arithmetic), with two products
  per tile, not three: every int8 value is exact in tf32, so the k8 and v8
  operands have lo = 0 and 3xTF32's hi·lo term is exactly 0 (``mm2``:
  lo(a)·b, then hi(a)·b). The logit is (q·k8)·sk + bias, two fp32
  roundings; the weight p·sv (one rounding) is split, l sums p. The
  kernel reads 4 consecutive head dims of a key per lane, so its k-steps
  over q·k8 take, per 16 dims, 4tq and 4tq + 1, then 4tq + 2 and 4tq + 3
  (``e_dims``).

Shapes: E at the flagship's S = 250 with K = 10, over S = 4000 with
padded keys, at K = 1, 16, 40 and the prefill's 501 rows, Dh 16 to 128,
split counts with spans of all padding. B at the flagship's K = 10, Dh = 64, step 300 of T·S = 5000 at
small B·H (the split count of the flagship's B = 8, H = 8), and at split
counts, beam counts and head dims where splits hold no live column and
step 0 returns exactly v_new; C at S = 250 and S = 4000 with padded keys;
the prefill's 501 rows. ``test_single_pass_tf32_record`` records what one
TF32 pass gives at those shapes: it misses 1e-4 at B's step and the
prefill's rows, and holds it over C's long slab.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from mm_s2ut.ops import decode_attention as jda
from test_torch_attention_tf32_numerics import emulate_a, exp_e, mm3, split, tf32

torch.set_num_threads(1)
LIM = TOL[torch.float32]
B_TILE = 8  # live columns per warp tile of B
C_TILE = {16: 16, 32: 16, 64: 16, 128: 8}  # keys per warp tile of C, by Dh
E_TILE = {16: 32, 32: 32, 64: 32, 128: 16}  # keys per warp tile of E, by Dh
WARPS = 4


# ------------------------------------------------------------ the emulation


def mm2(a: torch.Tensor, b: torch.Tensor, acc=None) -> torch.Tensor:
    """acc + a @ b (fp32, batched) for b exact in tf32 (int8 values), as
    fp32 E takes it: k-steps of 8 in order, each adding lo(a)·b, then
    hi(a)·b, one mma each (``mm3`` less its hi(a)·lo(b) term, 0 here)."""
    a, b = a.float(), b.float()
    assert torch.equal(tf32(b), b)
    ah, al = split(a)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        for x in (al, ah):
            part = x[..., k0:k0 + 8].double() @ b[..., k0:k0 + 8, :].double()
            out = (out.double() + part).float()
    return out


def e_dims(Dh):
    """The head dims in the order of fp32 E's k-steps over q·k8: per 16
    dims, 4tq and 4tq + 1 (tq = 0..3), then 4tq + 2 and 4tq + 3."""
    return torch.tensor([c + 4 * t + j for c in range(0, Dh, 16) for pair in ((0, 1), (2, 3))
                         for t in range(4) for j in pair])


def _warp_walk(tiles, scores_of, v_of, H, K, Dh, passes, pv=None):
    """Warp w of 4 takes ``tiles`` w, w + 4, ...; each keeps an online
    softmax per (head, row) over its tiles: ``scores_of(t)`` (H, K, n)
    logits (−inf masked), ``v_of(t)`` (H, n, Dh), or ``pv(p, t, acc)``
    the product acc + P·V itself. Returns the warps merged in warp order:
    (m, l, acc) per (head, row), m −inf where no warp saw an unmasked
    column."""
    warps = []
    for w in range(WARPS):
        m = torch.full((H, K), -torch.inf)
        l, acc = torch.zeros((H, K)), torch.zeros((H, K, Dh))
        for t in tiles[w::WARPS]:
            x = scores_of(t)
            m_new = torch.maximum(m, x.amax(-1))
            seen = m_new > -torch.inf
            alpha = torch.where(seen, exp_e(m - m_new), torch.ones_like(m))
            p = torch.where(seen[..., None], exp_e(x - m_new[..., None]), torch.zeros_like(x))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            acc = pv(p, t, acc) if pv else mm3(p, v_of(t), acc=acc, passes=passes)
            m = m_new
        warps.append((m, l, acc))
    M = torch.stack([w[0] for w in warps]).amax(0)
    l, acc = torch.zeros((H, K)), torch.zeros((H, K, Dh))
    for m, lw, aw in warps:
        sc = torch.where(m > -torch.inf, exp_e(m - M), torch.zeros_like(m))
        l, acc = l + sc * lw, acc + sc[..., None] * aw
    return M, l, acc


def emulate_b(q, k_new, v_new, kv, flat_rep, layer, n_split, passes=3):
    """Kernel B in fp32: (out (B, H, K, Dh), the number of splits that
    held no live column)."""
    B, H, K, Dh = q.shape
    TS = kv.shape[3]
    tile, span = B_TILE, -(-TS // n_split)
    slab = kv[:, layer].float()
    on = flat_rep == torch.arange(TS, dtype=torch.int32)  # (B, K, TS)
    out, empty = torch.empty((B, H, K, Dh)), 0
    for b in range(B):
        cols_all = torch.arange(TS)
        parts = []
        for sp in range(n_split):
            cols = cols_all[sp * span: min(TS, sp * span + span)]
            cols = cols[on[b][:, cols].any(0)]
            empty += cols.numel() == 0
            tiles = [cols[i: i + tile] for i in range(0, cols.numel(), tile)]

            def scores_of(c, b=b):
                s = mm3(q[b].float(), slab[b][:, c, :Dh].transpose(-1, -2), passes=passes)
                return torch.where(on[b][:, c][None], s, torch.full_like(s, -torch.inf))

            parts.append(_warp_walk(tiles, scores_of, lambda c, b=b: slab[b][:, c, Dh:],
                                    H, K, Dh, passes))
        self_logit = (q[b].float() * k_new[b].float()).sum(-1)  # (H, K)
        mx = self_logit
        for m, _, _ in parts:
            mx = torch.maximum(mx, m)
        p_self = torch.exp(self_logit - mx)
        den, num = p_self.clone(), p_self[..., None] * v_new[b].float()
        for m, l, acc in parts:
            sc = torch.where(m > -torch.inf, torch.exp(m - mx), torch.zeros_like(m))
            den, num = den + sc * l, num + sc[..., None] * acc
        out[b] = num / den[..., None]
    return out, empty


def emulate_c(q, kv, bias, n_split, passes=3):
    """Kernel C's decode step (K <= 16) in fp32: (out (B, H, K, Dh), the
    number of (b, split)s whose keys are all padding)."""
    B, H, K, Dh = q.shape
    S = kv.shape[2]
    tile = C_TILE[Dh]
    n_tiles = -(-S // tile)
    tps = -(-n_tiles // n_split)
    out, empty = torch.empty((B, H, K, Dh)), 0
    for b in range(B):
        kf, vf = kv[b, ..., :Dh].float(), kv[b, ..., Dh:].float()

        def scores_of(i, b=b):
            s = slice(i * tile, min(S, i * tile + tile))
            return mm3(q[b].float(), kf[:, s].transpose(-1, -2), passes=passes) + bias[b, s]

        parts = []
        for sp in range(-(-n_tiles // tps)):
            tiles = list(range(sp * tps, min(n_tiles, (sp + 1) * tps)))
            parts.append(_warp_walk(tiles, scores_of,
                                    lambda i: vf[:, i * tile: min(S, i * tile + tile)],
                                    H, K, Dh, passes))
            empty += bool((bias[b, sp * tps * tile: (sp + 1) * tps * tile] < -5e8).all())
        if len(parts) == 1:
            _, l, acc = parts[0]
        else:
            M = torch.stack([p[0] for p in parts]).amax(0)
            l, acc = torch.zeros((H, K)), torch.zeros((H, K, Dh))
            for m, lp, ap in parts:
                sc = torch.where(m > -torch.inf, torch.exp(m - M), torch.zeros_like(m))
                l, acc = l + sc * lp, acc + sc[..., None] * ap
        out[b] = acc / l[..., None]
    return out, empty


def emulate_e(q, kv, sk, sv, bias, n_split):
    """Kernel E in fp32 (2xTF32) for any number of rows: (out (B, H, K,
    Dh), the number of (b, split)s whose keys are all padding)."""
    B, H, K, Dh = q.shape
    S = kv.shape[2]
    tile, dims = E_TILE[Dh], e_dims(Dh)
    n_tiles = -(-S // tile)
    tps = -(-n_tiles // n_split)
    out, empty = torch.empty((B, H, K, Dh)), 0
    for b in range(B):
        qb, k8, v8 = q[b].float()[..., dims], kv[b, ..., :Dh].float()[..., dims], kv[b, ..., Dh:].float()

        def cols(i):
            return slice(i * tile, min(S, i * tile + tile))

        def scores_of(i, b=b, qb=qb, k8=k8):
            s = cols(i)
            return mm2(qb, k8[:, s].transpose(-1, -2)) * sk[b][:, None, s] + bias[b, s]

        def pv(p, i, acc, b=b, v8=v8):
            s = cols(i)
            return mm2(p * sv[b][:, None, s], v8[:, s], acc)

        parts = []
        for sp in range(-(-n_tiles // tps)):
            tiles = list(range(sp * tps, min(n_tiles, (sp + 1) * tps)))
            parts.append(_warp_walk(tiles, scores_of, None, H, K, Dh, None, pv=pv))
            empty += bool((bias[b, sp * tps * tile: (sp + 1) * tps * tile] < -5e8).all())
        if len(parts) == 1:
            _, l, acc = parts[0]
        else:
            M = torch.stack([p[0] for p in parts]).amax(0)
            l, acc = torch.zeros((H, K)), torch.zeros((H, K, Dh))
            for m, lp, ap in parts:
                sc = torch.where(m > -torch.inf, torch.exp(m - M), torch.zeros_like(m))
                l, acc = l + sc * lp, acc + sc[..., None] * ap
        out[b] = acc / l[..., None]
    return out, empty


def emulate_c_prefill(q, kv, bias, passes=3):
    """C's many rows: fp32 A with scale 1 over the slab's K and V halves."""
    Dh = q.shape[-1]
    k, v = (kv[..., sl].transpose(1, 2) for sl in (slice(None, Dh), slice(Dh, None)))
    out, _, _ = emulate_a(q.transpose(1, 2), k, v, bias, 1.0, passes=passes)
    return out.transpose(1, 2)


# ----------------------------------------------------------------- the tests


def _ancestry_inputs(B, H, K, Dh, L, T, step, seed):
    """q (pre-scaled), k_new, v_new (B, H, K, Dh), a (B, L, H, T·K, 2·Dh) cache
    and the flat_rep of a random ancestry at ``step``, N(0, 1) from numpy."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, K, Dh).astype(np.float32) * np.float32(Dh ** -0.5)
    k_new, v_new = (rng.randn(B, H, K, Dh).astype(np.float32) for _ in range(2))
    kv = rng.randn(B, L, H, T * K, 2 * Dh).astype(np.float32)
    ancestry = rng.randint(0, K, (B, K, T))
    t_idx = np.arange(T)[None, None, :]
    flat_rep = np.repeat(np.where(t_idx < step, t_idx * K + ancestry, -1), K, axis=2)
    return q, k_new, v_new, kv, flat_rep.astype(np.int32)


def _cross_inputs(B, H, K, Dh, S, lengths, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, K, Dh).astype(np.float32) * np.float32(Dh ** -0.5)
    kv = rng.randn(B, H, S, 2 * Dh).astype(np.float32)
    bias = np.where(np.arange(S)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    return q, kv, bias.astype(np.float32)


def _quant_cross_inputs(B, H, K, Dh, S, lengths, seed):
    """q (pre-scaled) and an int8 K‖V slab quantized per (head, column) by
    its absolute max over 127, with those scales, from N(0, 1) states."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, K, Dh).astype(np.float32) * np.float32(Dh ** -0.5)
    halves, scales = [], []
    for _ in range(2):
        x = rng.randn(B, H, S, Dh).astype(np.float32)
        s = (np.abs(x).max(-1) / np.float32(127)).astype(np.float32)
        halves.append(np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8))
        scales.append(s)
    bias = np.where(np.arange(S)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    return q, np.concatenate(halves, -1), scales[0], scales[1], bias.astype(np.float32)


def _jax_b(args, layer):
    return np.asarray(jda.ancestry_decode_attention(*map(jnp.asarray, args), layer,
                                                    interpret=True))


def _jax_c(args):
    return np.asarray(jda.cross_decode_attention(*map(jnp.asarray, args), interpret=True))


def _jax_e(args):
    return np.asarray(jda.cross_decode_attention_i8(*map(jnp.asarray, args), interpret=True))


def _err(got, want):
    return float(np.abs(got.numpy() - want).max())


FLAGSHIP_B = dict(B=2, H=2, K=10, Dh=64, L=2, T=500, step=300)
FLAGSHIP_B_SPLITS = 5  # a split count of the flagship's order (11 at B = 8, H = 8)


def test_b_3xtf32_at_the_flagship_step():
    """B at the flagship's decode step 300 of 500 (K = 10, Dh = 64, ~2000
    live columns in ~240 tiles per batch row) with 5 splits of 1000
    columns, the last two past the step (no live column)."""
    s = FLAGSHIP_B
    args = _ancestry_inputs(s["B"], s["H"], s["K"], s["Dh"], s["L"], s["T"], s["step"], seed=300)
    got, empty = emulate_b(*map(torch.from_numpy, args), 1, FLAGSHIP_B_SPLITS)
    assert empty == 2 * s["B"]
    assert _err(got, _jax_b(args, 1)) <= LIM


B_CASES = [  # (K, Dh, T, step, n_split)
    (1, 16, 16, 0, 1),     # step 0: exactly v_new
    (10, 64, 16, 0, 8),
    (1, 32, 16, 11, 3),
    (10, 64, 24, 2, 8),    # splits with no live column
    (10, 128, 24, 24, 3),  # Dh = 128
    (16, 64, 24, 24, 1),   # every beam a row of the mma
    (16, 16, 40, 33, 64),  # the most splits
    (5, 32, 40, 17, 5),
]


@pytest.mark.parametrize("K,Dh,T,step,n_split", B_CASES)
def test_b_3xtf32_split_counts(K, Dh, T, step, n_split):
    args = _ancestry_inputs(2, 2, K, Dh, 2, T, step, seed=K + Dh + step)
    got, empty = emulate_b(*map(torch.from_numpy, args), 1, n_split)
    assert _err(got, _jax_b(args, 1)) <= LIM
    if step == 0:  # no column on any path: exactly the fresh value
        np.testing.assert_array_equal(got.numpy(), args[2])
    if (K, step, n_split) == (10, 2, 8):
        assert empty > 0


C_CASES = [  # (K, Dh, S, lengths, n_split)
    (10, 64, 250, (250, 200), 4),     # the flagship's decode step (B = 8, H = 8)
    (10, 64, 250, (250, 3), 1),       # the bench point's (B = 128): one split
    (16, 64, 250, (250, 40), 4),      # row 1: padding fills splits 1-3
    (10, 64, 4000, (4000, 1000), 16),  # a long slab, 16 spans; row 1's last 12 all padding
    (16, 128, 70, (70, 1), 2),        # Dh = 128: 8-key tiles; a row of one key
    (1, 16, 13, (13, 5), 1),          # S under one tile
]


@pytest.mark.parametrize("K,Dh,S,lengths,n_split", C_CASES)
def test_c_3xtf32_tile_walk(K, Dh, S, lengths, n_split):
    args = _cross_inputs(2, 2, K, Dh, S, lengths, seed=K + S + Dh)
    got, empty = emulate_c(*map(torch.from_numpy, args), n_split)
    assert _err(got, _jax_c(args)) <= LIM
    if lengths[1] * 4 <= S and n_split > 1:
        assert empty > 0  # a split wholly padding


E_CASES = [  # (K, Dh, S, lengths, n_split)
    (10, 64, 250, (250, 200), 4),      # the flagship's decode step (B = 8, H = 8)
    (10, 64, 250, (250, 3), 1),        # the bench point's (B = 128): one split
    (10, 64, 4000, (4000, 1000), 16),  # a long slab, 16 spans; row 1's last 12 all padding
    (1, 16, 37, (37, 5), 2),           # one beam, Dh = 16 (2-byte V reads)
    (16, 32, 250, (250, 40), 4),       # row 1: padding fills splits 1-3
    (40, 128, 70, (70, 1), 2),         # three row groups, Dh = 128: 16-key tiles
    (501, 64, 250, (250, 200), 1),     # the streaming prefill's rows, 32 groups
]


@pytest.mark.parametrize("K,Dh,S,lengths,n_split", E_CASES)
def test_e_2xtf32_tile_walk(K, Dh, S, lengths, n_split):
    args = _quant_cross_inputs(2, 2, K, Dh, S, lengths, seed=K + S + Dh)
    got, empty = emulate_e(*map(torch.from_numpy, args), n_split)
    want = _jax_e(args)
    assert _err(got, want) <= LIM * max(1.0, float(np.abs(want).max()))
    if lengths[1] * 4 <= S and n_split > 1:
        assert empty > 0  # a split wholly padding


def test_int8_operands_are_exact_in_tf32():
    """Why fp32 E takes two products, not three: every int8 value is its
    own tf32 rounding (lo = 0), so 3xTF32's hi·lo term adds exactly 0, and
    the two products give 3xTF32's bits, over q·k8 and over P·v8."""
    x = torch.arange(-128, 128, dtype=torch.float32)
    hi, lo = split(x)
    assert torch.equal(hi, x) and torch.equal(lo, torch.zeros_like(x))
    rng = np.random.RandomState(8)
    a = torch.from_numpy(rng.randn(3, 16, 64).astype(np.float32))
    b = torch.from_numpy(rng.randint(-128, 128, (3, 64, 32)).astype(np.float32))
    acc = torch.from_numpy(rng.randn(3, 16, 32).astype(np.float32))
    assert torch.equal(mm2(a, b), mm3(a, b))
    assert torch.equal(mm2(a, b, acc.clone()), mm3(a, b, acc=acc.clone()))
    assert not torch.equal(mm3(a, b, passes=1), mm3(a, b))  # one pass is not enough


def test_c_prefill_rows_through_a():
    """The streaming prefill's P = 501 rows over S = 250 (one batch row
    with 50 padded keys): fp32 A's walk with scale 1 over the slab's halves."""
    args = _cross_inputs(2, 2, 501, 64, 250, (250, 200), seed=501)
    got = emulate_c_prefill(*map(torch.from_numpy, args))
    assert _err(got, _jax_c(args)) <= LIM


def test_single_pass_tf32_record():
    """Why the products take three passes here too. One TF32 pass (tf32
    operands, hi·hi alone) misses the fp32 tolerance at B's flagship step
    (~1.4e-4: K·V over ~2000 columns of N(0, 1) rows) and over the
    prefill's 501 rows (~4.2e-4, A's walk), and holds it over C's 4000-key
    slab (~3.4e-5: a softmax that spreads its weight wide); 3xTF32 stays
    under 1e-6 at all three."""
    s = FLAGSHIP_B
    b_args = _ancestry_inputs(1, 1, s["K"], s["Dh"], 1, s["T"], s["step"], seed=301)
    c_args = _cross_inputs(1, 2, 10, 64, 4000, (4000,), seed=4000)
    p_args = _cross_inputs(1, 2, 501, 64, 250, (250,), seed=502)
    want = {"B": _jax_b(b_args, 0), "C": _jax_c(c_args), "prefill": _jax_c(p_args)}
    errs = {}
    for passes in (1, 3):
        errs["B", passes] = _err(emulate_b(*map(torch.from_numpy, b_args), 0, FLAGSHIP_B_SPLITS,
                                           passes=passes)[0], want["B"])
        errs["C", passes] = _err(emulate_c(*map(torch.from_numpy, c_args), 16,
                                           passes=passes)[0], want["C"])
        errs["prefill", passes] = _err(emulate_c_prefill(*map(torch.from_numpy, p_args),
                                                         passes=passes), want["prefill"])
    print({f"{k} {p} x TF32": f"{e:.3e}" for (k, p), e in errs.items()})
    assert all(errs[k, 3] < 1e-6 for k in ("B", "C", "prefill"))
    assert errs["B", 1] > LIM and errs["prefill", 1] > LIM
    assert 1e-5 < errs["C", 1] < LIM
