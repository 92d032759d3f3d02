"""Kernels A–H on the card against their plain PyTorch versions on the
same CUDA tensors. Skipped without a CUDA device. On a GPU machine
(which needs neither JAX nor this directory's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (both sides fp32; summation order differs; fp32
A, G and H take their products on the tensor cores in 3xTF32, two tf32
halves of every operand, ~2^-21 of a product's scale:
``tests/test_torch_attention_tf32_numerics.py`` emulates that arithmetic
against JAX on the CPU), bf16 2e-2 (the plain versions round softmax
weights and products to bf16 between the two contractions; the SIMT
kernels keep fp32 until the store, while bf16 A and H, on the tensor
cores, round the weights times the dropout factor and dS to bf16 before
their second products, with fp32 accumulation:
``tests/test_torch_attention_tc_numerics.py`` holds those rounding
points to the same tolerances on the CPU). fp32 A, G and H are also held
at the tile edges, G to A-causal's bits, two launches to the same bits,
and a view one float off a 16-byte boundary raises, as in bf16.
Kernels D and F (int8 / int4 cache): fp32 2e-3, bf16 2e-2, for a
requantized softmax weight that flips one level at a rounding tie
(``chip_smoke.TOL_REQUANT``); E as C (fp32 E in 2xTF32: its int8
operands are exact in tf32, so the third product of 3xTF32 is 0). A's causal branch and G are held
against the plain version on every row, the padded rows whose whole
window band is padding included (G reproduces the reference's uniform
average there, ``csrc/flash_attention.cu``). A and G with attention
dropout, and H's four gradients, are held to the same tolerances times
the largest magnitude of the twin's output (a dropped-out row of few
keys puts out up to |v|/(1 − p), gradients grow with T); in fp32 that
still catches a single weight dropped on one side only. A at the ViT's
shape (577 queries over 584 keys, 7 of them padding; H = 12 and 16) is
held to its plain version, and a small ViT forward on the card to the
same weights on the CPU. At the wav2vec2 training shapes (B = 8, T = 499
with the key padding of 2-10 s utterances, H = 12 and 16, attention
dropout 0 and 0.1) A and H are held to their plain versions, and a small
XM train step with LayerDrop, ``gradient_checkpointing`` and attention
dropout on the card to the same weights on the CPU
(``chip_smoke.card_vs_cpu``). H at the ViT's training shape (Tq = 577
over S = 584) is held to its twin, and A, G and H with attention dropout
on a data-parallel shard (``dropout_row0``) give that shard's rows of the
whole batch bit for bit. A two-member logit ensemble of the small fp32
config decodes on the card as on the CPU for each cache (tokens equal,
scores within 1e-4), k-means assignment at 1000 x 768 agrees with the
CPU but at near-ties (``chip_smoke.near_ties``), and two runs of three
train steps from the same weights end bit for bit equal."""
import pytest
import torch

from chip_smoke import (
    BENCH,
    DROP_SEED,
    FLAGSHIP,
    TOL,
    TOL_REQUANT,
    VIT,
    XM,
    XM_BENCH,
    ancestry_inputs,
    card_vs_cpu,
    cross_inputs,
    flash_inputs,
    kernel_cases,
    quant_ancestry_inputs,
    quant_cross_inputs,
    xm_bias,
    xm_config,
    xm_lengths,
)
from mm_s2ut_torch.ops import _build
from mm_s2ut_torch.ops import attention as A
from mm_s2ut_torch.ops import decode_attention as D

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, dtype, tol=None):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (TOL[dtype] if tol is None else tol), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H,D", [(2, 37, 4, 16), (3, 130, 2, 32), (1, 9, 2, 128)])
def test_flash_attention(card, dtype, B, T, H, D):
    q, k, v, kpm = flash_inputs(B, T, H, D, dtype, seed=T)
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kpm)
    assert A.flash_attention.launches == before + 1
    _close(got, A.reference_attention(q * D ** -0.5, k, v, bias), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [16, 64])
def test_flash_attention_reads_strided_heads(card, dtype, D):
    """A and H on q, k, v viewed from one fused projection: against the
    twin, and bit-equal to the same kernels on contiguous copies."""
    B, T, H = 2, 50, 4
    qkv = torch.randn(B, T, 3 * H * D, device="cuda").to(dtype)
    q, k, v = (qkv[..., i * H * D : (i + 1) * H * D].view(B, T, H, D) for i in range(3))
    assert not q.is_contiguous()
    got = A.flash_attention(q, k, v)
    _close(got, A.reference_attention(q * D ** -0.5, k, v), dtype)
    g = torch.randn(q.shape, device="cuda").to(dtype)
    grads = []
    for qq, kk, vv in ((q, k, v), (q.contiguous(), k.contiguous(), v.contiguous())):
        leaves = [t.detach().requires_grad_(True) for t in (qq, kk, vv)]
        out = A.flash_attention(*leaves)
        out.backward(g)
        grads.append([out] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*grads))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 5, 64])
@pytest.mark.parametrize("B,T,H,D", [(2, 37, 4, 16), (3, 130, 2, 64), (2, 250, 2, 128)])
def test_flash_attention_causal(card, dtype, window, B, T, H, D):
    """Kernel A's causal/window branch; lengths T, T-17, T-34 leave rows
    whose window band is all padding."""
    q, k, v, kpm = flash_inputs(B, T, H, D, dtype, seed=T + window)
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kpm, causal=True, window=window)
    assert A.flash_attention.launches == before + 1
    _close(got, A.reference_attention(q * D ** -0.5, k, v, bias, True, window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 5, 64])
@pytest.mark.parametrize("B,Tq,S,H,D", [(2, 37, 37, 4, 16), (3, 130, 130, 2, 64),
                                        (2, 40, 64, 2, 32), (1, 250, 250, 8, 64),
                                        (2, 100, 300, 2, 128)])
def test_causal_skip_attention(card, dtype, window, B, Tq, S, H, D):
    """Kernel G, with a ragged Tq < S and padded rows (some with an
    all-padding band), against the plain version on every row; through
    flash_attention(block_k=...) where Tq == S."""
    q, k, v, kpm = flash_inputs(B, S, H, D, dtype, seed=S + window)
    q = q[:, :Tq]
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
    before = (A.causal_skip_attention.launches, A.flash_attention.launches)
    if Tq == S:
        got = A.flash_attention(q, k, v, kpm, causal=True, window=window, block_k=64)
    else:
        got = A.causal_skip_attention(q, k, v, kpm, window=window)
    assert (A.causal_skip_attention.launches, A.flash_attention.launches) == \
        (before[0] + 1, before[1])
    _close(got, A.reference_attention(q * D ** -0.5, k, v, bias, True, window), dtype)


TRAIN_SHAPES = [(2, 37, 4, 16), (3, 130, 2, 64), (2, 250, 2, 128), (2, 70, 2, 32)]
TRAIN_MASKS = [(False, 0, None), (True, 0, None), (True, 5, None), (True, 0, 64), (True, 64, 64)]


def _rel_close(got, want, dtype, floor=1.0):
    """A/G with dropout and H's outputs against their twins: TOL times
    max(``floor``, the largest |want|)."""
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(floor, want.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,block_k", TRAIN_MASKS)
@pytest.mark.parametrize("B,T,H,D", TRAIN_SHAPES)
def test_flash_attention_dropout(card, dtype, causal, window, block_k, B, T, H, D):
    """A (and G with ``block_k``) with attention dropout 0.1 against the
    twin with the same seed: a mask mismatch moves outputs by O(0.1)."""
    q, k, v, kpm = flash_inputs(B, T, H, D, dtype, seed=T + window)
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
    counter = A.causal_skip_attention if block_k else A.flash_attention
    before = counter.launches
    got = A.flash_attention(q, k, v, kpm, causal=causal, window=window, dropout_rate=0.1,
                            dropout_seed=0xDEADBEEF, block_k=block_k)
    assert counter.launches == before + 1
    want = A.reference_attention(q * D ** -0.5, k, v, bias, causal, window, 0.1, 0xDEADBEEF)
    _rel_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal,window,block_k", TRAIN_MASKS)
@pytest.mark.parametrize("B,T,H,D", TRAIN_SHAPES)
def test_flash_attention_bwd(card, dtype, rate, causal, window, block_k, B, T, H, D):
    """Kernel H (dq, dk, dv, dbias) after A or G, against the plain twin
    of H on the same inputs; and the autograd route (flash_attention's
    backward) launches H once and gives the same dq, dk, dv."""
    q, k, v, kpm = flash_inputs(B, T, H, D, dtype, seed=2 * T + window)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(T)).to("cuda", dtype)
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
    seed = 77 if rate else None
    scale = D ** -0.5
    stats = torch.empty((2, B * H, T), device="cuda")
    entry = "mm_flash_attention_causal_skip" if block_k else "mm_flash_attention"
    A._launch(entry, q, k, v, bias, scale, causal, window, rate, seed, stats)
    got = A.flash_attention_bwd(q, k, v, bias, stats, g, scale, causal, window, rate, seed)
    want = A.reference_attention_bwd(q, k, v, bias, g, scale, causal, window, rate, seed)
    for x, y in zip(got, want):
        _rel_close(x, y, dtype)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    before = A.flash_attention_bwd.launches
    A.flash_attention(qg, kg, vg, kpm, causal=causal, window=window, dropout_rate=rate,
                      dropout_seed=seed, block_k=block_k).backward(g)
    assert A.flash_attention_bwd.launches == before + 1
    for x, y in zip((qg.grad, kg.grad, vg.grad), got[:3]):
        torch.cuda.synchronize()
        assert torch.equal(x, y)


def _a_then_h(q, k, v, kpm, g, causal, window, block_k, rate, seed):
    """A (or G with ``block_k``) with row statistics, then H: (out, dq, dk,
    dv, dbias)."""
    B, T, H, D = q.shape
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
    stats = torch.empty((2, B * H, T), device="cuda")
    entry = "mm_flash_attention_causal_skip" if block_k else "mm_flash_attention"
    out = A._launch(entry, q, k, v, bias, D ** -0.5, causal, window, rate, seed, stats)
    return (out,) + A.flash_attention_bwd(q, k, v, bias, stats, g, D ** -0.5, causal, window,
                                          rate, seed)


@pytest.mark.parametrize("causal,window,block_k", TRAIN_MASKS)
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 16, 63, 64, 65, 127, 1000])
def test_bf16_tensor_core_tile_edges(card, T, D, causal, window, block_k):
    """bf16 A (or G with ``block_k``: windows 0 and 64) and H after it, all
    on the tensor cores, at the 64-row query tile and key tile edges (32
    keys at D = 128), dropout 0 and 0.1, against the twins; lengths T and
    T - 17 leave padded rows, some whose whole window band is padding (G's
    fallback tiles). Every output is held to TOL times max(1, the largest |want|),
    the rows with a single valid key included (T = 1, and T = 16's row of
    length 1), where the softmax gradient is exactly 0: H sums its Δ from
    the products that form dS, so dS cancels there."""
    dtype = torch.bfloat16
    q, k, v, kpm = flash_inputs(2, T, 2, D, dtype, seed=T + D + window)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(D)).to("cuda", dtype)
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
    for rate in (0.0, 0.1):
        seed = 99 if rate else None
        got = _a_then_h(q, k, v, kpm, g, causal, window, block_k, rate, seed)
        want = (A.reference_attention(q * D ** -0.5, k, v, bias[:, None, None, :], causal, window,
                                      rate, seed),) + \
            A.reference_attention_bwd(q, k, v, bias, g, D ** -0.5, causal, window, rate, seed)
        for x, y in zip(got, want):  # out dq dk dv dbias
            _rel_close(x, y, dtype)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("window", [0, 5, 64])
def test_bf16_g_equals_a_causal_on_rows_with_a_key(card, D, window):
    """bf16 G (band tiles only, tensor cores) gives A-causal's bits (every
    tile) on each row whose causal/window band holds a real key, with
    dropout and row statistics: skipped tiles add p = 0 with alpha = 1."""
    B, T, H = 3, 300, 2
    q, k, v, kpm = flash_inputs(B, T, H, D, torch.bfloat16, seed=D + window)
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
    runs = []
    for entry in ("mm_flash_attention_causal_skip", "mm_flash_attention"):
        stats = torch.empty((2, B * H, T), device="cuda")
        runs.append((A._launch(entry, q, k, v, bias, D ** -0.5, True, window, 0.1, 3, stats),
                     stats))
    torch.cuda.synchronize()
    t = torch.arange(T, device="cuda")[:, None]
    j = torch.arange(T, device="cuda")[None, :]
    band = (j <= t) & ((j > t - window) if window else True)
    rows = (band[None] & ~kpm[:, None, :]).any(-1)  # (B, T)
    assert torch.equal(runs[0][0][rows], runs[1][0][rows])
    rows_bh = rows[:, None, :].expand(B, H, T).reshape(B * H, T)
    assert torch.equal(runs[0][1][:, rows_bh], runs[1][1][:, rows_bh])


@pytest.mark.parametrize("block_k", [None, 64])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_bf16_tensor_core_deterministic(card, D, block_k):
    """Two launches of bf16 A or G (dropout and statistics on) and H on the
    same inputs give the same bits: no atomics, fixed summation orders."""
    q, k, v, kpm = flash_inputs(3, 200, 4, D, torch.bfloat16, seed=D)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to("cuda", q.dtype)
    runs = [_a_then_h(q, k, v, kpm, g, True, 64, block_k, 0.1, 5) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_bf16_misaligned_rows_raise(card):
    """The tensor-core kernels copy 16-byte row chunks: a bf16 view whose
    row stride or data pointer is not a multiple of 8 elements raises (fp32
    takes it), for A and for H."""
    B, T, H, D = 2, 20, 2, 16
    wide = torch.randn(B, T, H * D + 4, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        x = wide.to(dtype)
        views = {
            "row stride": x[..., : H * D].unflatten(-1, (H, D)),
            "data pointer": x.flatten()[4 : 4 + B * T * H * D].view(B, T, H, D),
        }
        for what, q in views.items():
            k = v = q
            if dtype == torch.float32:
                _close(A.flash_attention(q, k, v), A.reference_attention(q * D ** -0.5, k, v),
                       dtype)
                continue
            with pytest.raises(ValueError, match="16-byte aligned"):
                A.flash_attention(q, k, v)
            bias = torch.zeros((B, T), device="cuda")
            stats = torch.zeros((2, B * H, T), device="cuda")
            with pytest.raises(ValueError, match="16-byte aligned"):
                A.flash_attention_bwd(q, k, v, bias, stats, q, D ** -0.5, False, 0)


@pytest.mark.parametrize("causal,window,block_k", TRAIN_MASKS)
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 15, 17, 63, 65, 577])
def test_fp32_tensor_core_tile_edges(card, T, D, causal, window, block_k):
    """fp32 A (or G with ``block_k``) and H after it, on the tensor cores in
    3xTF32, at the 64-row query tile and key tile edges (16 keys for A and G
    at D = 128, 32-row staged tiles in H), dropout 0 and 0.1, against the
    twins at the fp32 tolerance (TOL times max(1, the largest |want|));
    lengths T and T - 17 leave padded rows, some whose whole window band is
    padding, and rows with a single valid key (T = 1, and the second row at
    T = 15 and 17), where H's dS cancels to 0."""
    dtype = torch.float32
    q, k, v, kpm = flash_inputs(2, T, 2, D, dtype, seed=T + D + window)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(D)).to("cuda", dtype)
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
    for rate in (0.0, 0.1):
        seed = 99 if rate else None
        got = _a_then_h(q, k, v, kpm, g, causal, window, block_k, rate, seed)
        want = (A.reference_attention(q * D ** -0.5, k, v, bias[:, None, None, :], causal, window,
                                      rate, seed),) + \
            A.reference_attention_bwd(q, k, v, bias, g, D ** -0.5, causal, window, rate, seed)
        for x, y in zip(got, want):  # out dq dk dv dbias
            _rel_close(x, y, dtype)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("window", [0, 5, 64])
def test_fp32_g_equals_a_causal_on_rows_with_a_key(card, D, window):
    """fp32 G (band tiles only) gives A-causal's bits (every tile) on each
    row whose causal/window band holds a real key, with dropout and row
    statistics: skipped tiles add p = 0 with alpha = 1."""
    B, T, H = 3, 300, 2
    q, k, v, kpm = flash_inputs(B, T, H, D, torch.float32, seed=D + window)
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
    runs = []
    for entry in ("mm_flash_attention_causal_skip", "mm_flash_attention"):
        stats = torch.empty((2, B * H, T), device="cuda")
        runs.append((A._launch(entry, q, k, v, bias, D ** -0.5, True, window, 0.1, 3, stats),
                     stats))
    torch.cuda.synchronize()
    t = torch.arange(T, device="cuda")[:, None]
    j = torch.arange(T, device="cuda")[None, :]
    band = (j <= t) & ((j > t - window) if window else True)
    rows = (band[None] & ~kpm[:, None, :]).any(-1)  # (B, T)
    assert torch.equal(runs[0][0][rows], runs[1][0][rows])
    rows_bh = rows[:, None, :].expand(B, H, T).reshape(B * H, T)
    assert torch.equal(runs[0][1][:, rows_bh], runs[1][1][:, rows_bh])


@pytest.mark.parametrize("block_k", [None, 64])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_fp32_tensor_core_deterministic(card, D, block_k):
    """Two launches of fp32 A or G (dropout and statistics on) and H on the
    same inputs give the same bits: no atomics, fixed summation orders."""
    q, k, v, kpm = flash_inputs(3, 200, 4, D, torch.float32, seed=D)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to("cuda", q.dtype)
    runs = [_a_then_h(q, k, v, kpm, g, True, 64, block_k, 0.1, 5) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_fp32_misaligned_rows_raise(card):
    """fp32 A and H copy 16-byte row chunks too: an fp32 view whose row
    stride or data pointer is one float off a 16-byte boundary raises, for
    A, G and H; the 16-byte-aligned views of the bf16 test run."""
    B, T, H, D = 2, 20, 2, 16
    wide = torch.randn(B, T, H * D + 1, device="cuda")
    views = {
        "row stride": wide[..., : H * D].unflatten(-1, (H, D)),
        "data pointer": wide.flatten()[1 : 1 + B * T * H * D].view(B, T, H, D),
    }
    bias = torch.zeros((B, T), device="cuda")
    stats = torch.zeros((2, B * H, T), device="cuda")
    for what, q in views.items():
        assert not A._rows_aligned(q), what
        with pytest.raises(ValueError, match="16-byte aligned"):
            A.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="16-byte aligned"):
            A.flash_attention(q, q, q, causal=True, block_k=64)
        with pytest.raises(ValueError, match="16-byte aligned"):
            A.flash_attention_bwd(q, q, q, bias, stats, q, D ** -0.5, False, 0)


@pytest.mark.parametrize("step", [0, 13, 24])
@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("K", [1, 5, 10, 16])
def test_ancestry_decode(card, K, Dh, B, step):
    """Kernel B (split over blocks, then the merge) against the plain
    version in bf16 and fp32, at step 0 (exactly v_new), midway and at the
    last step of the cache (every step on each beam's path), over a
    segment view; a second launch gives the same bits."""
    H, L, T = 2, 2, 24
    for dtype in DTYPES:
        q, k_new, v_new, kv, flat_rep = ancestry_inputs(B, H, K, Dh, L, T, step, dtype,
                                                        seed=K + Dh + B)
        view = torch.cat([kv, torch.ones_like(kv)], dim=3)[:, :, :, : T * K]
        before = D.ancestry_decode_attention.launches
        got = D.ancestry_decode_attention(q, k_new, v_new, view, flat_rep, 1)
        again = D.ancestry_decode_attention(q, k_new, v_new, view, flat_rep, 1)
        assert D.ancestry_decode_attention.launches == before + 2
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if step == 0:
            assert torch.equal(got, v_new)
        _close(got, D.reference(q, k_new, v_new, kv, flat_rep, 1), dtype)


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_ancestry_decode_variants(card, variant):
    """The designs ``tools/kernel_ab.py`` times against kernel B's (all
    heads per block; the SIMT split pass in bf16; one block per (b, h)
    over the whole slab) at the flagship's bf16 shape give the plain
    version's result too."""
    s = FLAGSHIP
    args = ancestry_inputs(s["B"], s["H"], s["K"], s["Dh"], s["L"], s["T_dec"], s["step"],
                           torch.bfloat16)
    got = D._launch_ancestry(*args, 2, variant=variant)
    _close(got, D.reference(*args, 2), torch.bfloat16)


def test_ancestry_decode_takes_the_decoder_views(card):
    """Kernel B reads q, k_new and v_new as the decoder hands them (beam-major
    (N, 1, H, Dh) rows viewed as (B, H, K, Dh)) and returns a view the
    decoder flattens without a copy."""
    B, H, K, Dh, L, T = 3, 4, 5, 32, 2, 16
    q, k_new, v_new, kv, flat_rep = ancestry_inputs(B, H, K, Dh, L, T, 9, torch.bfloat16)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k_new, v_new)]
    assert not views[0].is_contiguous()
    got = D.ancestry_decode_attention(*views, kv, flat_rep, 0)
    assert got.transpose(1, 2).is_contiguous()
    _close(got, D.reference(q, k_new, v_new, kv, flat_rep, 0), torch.bfloat16)


CROSS_SHAPES = [(1, 16, 13), (10, 64, 250), (10, 64, 1500), (16, 128, 70), (16, 32, 250),
                (1, 64, 37), (10, 16, 300), (5, 128, 250), (10, 64, 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [2, 128])
@pytest.mark.parametrize("K,Dh,S", CROSS_SHAPES)
def test_cross_decode(card, dtype, B, K, Dh, S):
    """Kernel C against the plain version, S on and off the key tile (32
    keys, 16 at Dh = 128), K = 1..16, every head dim, split over blocks
    (B = 2) and not (B = 128); a second launch gives the same bits."""
    q, kv, bias = cross_inputs(B, 3, K, Dh, S, dtype, seed=S)
    before = D.cross_decode_attention.launches
    got = D.cross_decode_attention(q, kv, bias)
    again = D.cross_decode_attention(q, kv, bias)
    assert D.cross_decode_attention.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, D.cross_reference(q, kv, bias), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad", [A.NEG_INF, float("-inf")])
@pytest.mark.parametrize("K,Dh", [(10, 64), (16, 128), (1, 16)])
def test_cross_decode_padded_splits(card, dtype, pad, K, Dh):
    """Rows whose padding fills whole splits and warp spans (valid lengths
    250, 40 and 1 of S = 250), padded with -1e9 or -inf: the spans of
    padding weigh 0."""
    B, H, S = 3, 2, 250
    q, kv, _ = cross_inputs(B, H, K, Dh, S, dtype, seed=K + Dh)
    lengths = torch.tensor([S, 40, 1], device="cuda")
    bias = torch.where(torch.arange(S, device="cuda")[None, :] < lengths[:, None], 0.0, pad)
    got = D.cross_decode_attention(q, kv, bias)
    _close(got, D.cross_reference(q, kv, bias), dtype)


def test_cross_decode_takes_the_decoder_views(card):
    """Kernel C reads q as the decoder hands it (a beam-major (B, K, H, Dh)
    buffer viewed as (B, H, K, Dh)) and returns a view the decoder
    flattens without a copy, for a decode step and for a prefill."""
    for K in (10, 40):
        q, kv, bias = cross_inputs(2, 4, K, 64, 120, torch.bfloat16, seed=K)
        view = q.transpose(1, 2).contiguous().transpose(1, 2)
        assert not view.is_contiguous()
        got = D.cross_decode_attention(view, kv, bias)
        assert got.transpose(1, 2).is_contiguous()
        _close(got, D.cross_reference(q, kv, bias), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("K,Dh,step", [(1, 16, 0), (1, 64, 20), (10, 64, 0), (10, 64, 33),
                                       (16, 32, 12), (4, 128, 7), (16, 128, 40), (5, 16, 3),
                                       (16, 64, 1)])
def test_quant_ancestry_decode(card, dtype, int4, K, Dh, step):
    """Kernels D and F read segment views of the cache and both scale
    arrays (the first T·K columns of larger allocations). T = 40 steps over
    6 (b, h): D runs one split per step, so every split past ``step`` is
    wholly off-path; step 0 gives exactly v_new; D's second launch gives
    the same bits."""
    B, H, L, T = 2, 3, 2, 40
    q, k_new, v_new, kv, sk, sv, flat_rep = quant_ancestry_inputs(
        B, H, K, Dh, L, T, step, dtype, int4=int4, seed=K)
    kv_view = torch.cat([kv, torch.ones_like(kv)], dim=3)[:, :, :, : kv.shape[3]]
    sk_view, sv_view = (torch.cat([s, torch.ones_like(s)], dim=3)[..., : T * K] for s in (sk, sv))
    assert not (kv_view.is_contiguous() or sk_view.is_contiguous())
    kern = D.ancestry_decode_attention_i4 if int4 else D.ancestry_decode_attention_i8
    plain = D.reference_i4 if int4 else D.reference_i8
    before = kern.launches
    got = kern(q, k_new, v_new, kv_view, sk_view, sv_view, flat_rep, 1)
    assert kern.launches == before + 1
    if step == 0:  # no column on any path: exactly the fresh value
        torch.cuda.synchronize()
        assert torch.equal(got, v_new)
    if not int4:
        again = kern(q, k_new, v_new, kv_view, sk_view, sv_view, flat_rep, 1)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
    _close(got, plain(q, k_new, v_new, kv, sk, sv, flat_rep, 1), dtype, TOL_REQUANT[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ["flagship", "bench"])
def test_quant_ancestry_variants_give_the_same_bits(card, dtype, shape):
    """D's designs that ``tools/kernel_ab.py`` times (v1 the output product
    on bf16 tensor cores, v2 both products so, v3 two batch rows per block)
    form the same integers from the same w8: all four give v0's bits, at
    the flagship's int8 shape (split over blocks) and the bench's (one
    split), and v0 holds the plain version's tolerance there."""
    s = FLAGSHIP if shape == "flagship" else BENCH
    args = quant_ancestry_inputs(s["B"], s["H"], s["K"], s["Dh"], s["L"], s["T_dec"], s["step"],
                                 dtype)
    runs = [D._launch_i8(*args, s["L"] // 2, variant=v) for v in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    _close(runs[0], D.reference_i8(*args, s["L"] // 2), dtype, TOL_REQUANT[dtype])


def test_quant_ancestry_decode_takes_the_decoder_views(card):
    """Kernel D reads q, k_new and v_new as the decoder hands them and
    returns a view the decoder flattens without a copy."""
    B, H, K, Dh, L, T = 3, 4, 5, 32, 2, 16
    q, k_new, v_new, kv, sk, sv, flat_rep = quant_ancestry_inputs(B, H, K, Dh, L, T, 9,
                                                                  torch.bfloat16)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k_new, v_new)]
    assert not views[0].is_contiguous()
    got = D.ancestry_decode_attention_i8(*views, kv, sk, sv, flat_rep, 0)
    assert got.transpose(1, 2).is_contiguous()
    _close(got, D.reference_i8(q, k_new, v_new, kv, sk, sv, flat_rep, 0), torch.bfloat16,
           TOL_REQUANT[torch.bfloat16])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,Dh,S", [(1, 16, 13), (10, 64, 250), (10, 64, 1500), (16, 128, 70)])
def test_cross_decode_i8(card, dtype, K, Dh, S):
    args = quant_cross_inputs(2, 3, K, Dh, S, dtype, seed=S)
    before = D.cross_decode_attention_i8.launches
    got = D.cross_decode_attention_i8(*args)
    assert D.cross_decode_attention_i8.launches == before + 1
    _close(got, D.cross_reference_i8(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("K,Dh,S", [(17, 64, 250), (501, 64, 250), (40, 128, 70), (33, 16, 13),
                                    (64, 32, 100)])
def test_cross_decode_many_rows(card, dtype, int8, K, Dh, S):
    """Kernels C and E with more rows than a decode step has (the
    prefill's P = max_len + 1): against the plain version. A 16-row
    (decode-step) call on the first 16 rows takes the same code path in E
    (one block per 16 rows) wherever E splits S the same way for 16 rows
    and for K, so there it gives the same bits (E takes fewer splits once
    its row groups fill a wave, in either dtype); C takes A's forward for many rows and its split kernel for 16,
    in either dtype, so there both are held to the plain version."""
    if int8:
        args = quant_cross_inputs(2, 3, K, Dh, S, dtype, seed=S)
        kern, plain, counter = D.cross_decode_attention_i8, D.cross_reference_i8, \
            D.cross_decode_attention_i8
    else:
        args = cross_inputs(2, 3, K, Dh, S, dtype, seed=S)
        kern, plain, counter = D.cross_decode_attention, D.cross_reference, \
            D.cross_decode_attention
    before = counter.launches
    got = kern(*args)
    assert counter.launches == before + 1
    _close(got, plain(*args), dtype)
    head = kern(args[0][:, :, :16].contiguous(), *args[1:])
    torch.cuda.synchronize()
    if int8 and _e_splits(2, 3, K, S, Dh) == _e_splits(2, 3, 16, S, Dh):
        assert torch.equal(got[:, :, :16], head)
    else:
        _close(head, plain(args[0][:, :, :16].contiguous(), *args[1:]), dtype)
    again = kern(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def _e_splits(B, H, K, S, Dh):
    return _build.library().mm_cross_decode_i8_splits(B, H, K, S, Dh)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,Dh,S", [(501, 64, 250), (40, 128, 70), (17, 16, 13)])
def test_cross_decode_i8_many_rows_one_wave(card, dtype, K, Dh, S):
    """Kernel E where B.H alone fills a wave, so that 16 rows and K rows
    take the same split count in both dtypes: the first 16 of K rows give
    a 16-row call's bits, and both match the plain version."""
    B, H = 24, 6
    assert _e_splits(B, H, K, S, Dh) == _e_splits(B, H, 16, S, Dh)
    args = quant_cross_inputs(B, H, K, Dh, S, dtype, seed=K)
    got = D.cross_decode_attention_i8(*args)
    head = D.cross_decode_attention_i8(args[0][:, :, :16].contiguous(), *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(got[:, :, :16], head)
    _close(got, D.cross_reference_i8(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flagship_shapes(card, dtype):
    for name, kern, plain, tol, _, _ in kernel_cases(dtype, FLAGSHIP):
        _close(kern(), plain(), dtype, tol)


def test_unsupported_inputs_raise(card):
    q, k, v, _ = flash_inputs(1, 8, 2, 24, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        A.flash_attention(q, k, v, dropout_rate=0.1)
    q, k, v, _ = flash_inputs(1, 8, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="Tq == Tk"):
        A.flash_attention(q[:, :4], k, v, causal=True)
    with pytest.raises(ValueError, match="Tq=8 > S=4"):
        A.causal_skip_attention(q, k[:, :4], v[:, :4])
    args = ancestry_inputs(1, 1, 17, 16, 1, 4, 2, torch.float32)
    with pytest.raises(ValueError, match="queries per head"):
        D.ancestry_decode_attention(*args, 0)


def test_unsupported_quant_inputs_raise(card):
    q, k_new, v_new, kv, sk, sv, flat_rep = quant_ancestry_inputs(1, 2, 3, 16, 1, 5, 2,
                                                                  torch.float32)  # T·S = 15
    with pytest.raises(ValueError, match="int8 cache"):
        D.ancestry_decode_attention_i8(q, k_new, v_new, kv.float(), sk, sv, flat_rep, 0)
    with pytest.raises(ValueError, match="scales"):
        D.ancestry_decode_attention_i4(q, k_new, v_new, kv, sk, sv, flat_rep, 0)  # not packed
    with pytest.raises(ValueError, match="multiple"):
        D.ancestry_decode_attention_i8(q[:, :, :2], k_new[:, :, :2], v_new[:, :, :2], kv, sk, sv,
                                       flat_rep[:, :2], 0)


def _unpacked(kv):
    """A nibble-packed int4 cache's values as an int8 cache (layer by layer)."""
    out = torch.empty((*kv.shape[:3], 2 * kv.shape[3], kv.shape[4]), dtype=torch.int8,
                      device=kv.device)
    for layer in range(kv.shape[1]):
        out[:, layer] = D.i4_unpack(kv[:, layer])
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ["flagship", "bench", "small"])
def test_i4_equals_i8_on_the_unpacked_cache(card, dtype, shape):
    """Kernel F runs D's passes with the nibble gather: on the card its
    output equals D's on i4_unpack of the same cache bit for bit (flagship:
    split over blocks; bench: T = 201 odd, so P is not a multiple of K; a
    small cache with K = 5 and Dh = 16), and its designs v1-v3 (Dh = 64)
    give the same bits."""
    s = dict(B=3, H=2, Dh=16, K=5, L=2, T_dec=36, step=30) if shape == "small" else \
        (FLAGSHIP if shape == "flagship" else BENCH)
    q, k_new, v_new, kv, sk, sv, flat_rep = quant_ancestry_inputs(
        s["B"], s["H"], s["K"], s["Dh"], s["L"], s["T_dec"], s["step"], dtype, int4=True, seed=7)
    layer = s["L"] // 2
    got = D.ancestry_decode_attention_i4(q, k_new, v_new, kv, sk, sv, flat_rep, layer)
    want = D.ancestry_decode_attention_i8(q, k_new, v_new, _unpacked(kv), sk, sv, flat_rep, layer)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    if s["Dh"] == 64:
        for v in (1, 2, 3):
            other = D._launch_i4(q, k_new, v_new, kv, sk, sv, flat_rep, layer, variant=v)
            torch.cuda.synchronize()
            assert torch.equal(got, other), (v, (got.float() - other.float()).abs().max().item())
    _close(got, D.reference_i4(q, k_new, v_new, kv, sk, sv, flat_rep, layer), dtype,
           TOL_REQUANT[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_i4_beam16_at_the_position_clamp(card, dtype):
    """F at beam 16 over 3000 positions (T.K = 48000 columns, past what
    one block's shared memory holds as scores) against the plain version."""
    q, k_new, v_new, kv, sk, sv, flat_rep = quant_ancestry_inputs(1, 2, 16, 64, 1, 3000, 2999,
                                                                  dtype, int4=True, seed=16)
    got = D.ancestry_decode_attention_i4(q, k_new, v_new, kv, sk, sv, flat_rep, 0)
    _close(got, D.reference_i4(q, k_new, v_new, kv, sk, sv, flat_rep, 0), dtype,
           TOL_REQUANT[dtype])


F32_ROWS = [1, 10, 16]  # a decode step's rows: one beam, the flagship's 10, the most


def _splits_b(B, H, TS):
    return _build.library().mm_ancestry_decode_splits(_build.F32, B, H, TS, 0)


@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("K", F32_ROWS)
def test_fp32_ancestry_tensor_cores(card, K, Dh):
    """fp32 B (3xTF32 on the tensor cores) against its plain version at B =
    8 (split over blocks) and B = 128 (one split per (b, h)), over 40 steps
    of K slots, at step 0 (exactly v_new), step 5 (the splits past column
    5·K hold no live column) and step 37 (most of the cache live, in
    8-column tiles); two launches give the same bits, and all heads per
    block (variant 1) the same result."""
    H, L, T = 2, 2, 40
    for B in (8, 128):
        n_split = _splits_b(B, H, T * K)
        if B == 8 and K > 1:
            assert 5 * K < (n_split - 1) * -(-T * K // n_split), n_split  # a split of no column
        for step in (0, 5, 37):
            args = ancestry_inputs(B, H, K, Dh, L, T, step, torch.float32, seed=K + Dh + step)
            got = D.ancestry_decode_attention(*args, 1)
            again = D.ancestry_decode_attention(*args, 1)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            if step == 0:
                assert torch.equal(got, args[2])
            want = D.reference(*args, 1)
            _close(got, want, torch.float32)
            _close(D._launch_ancestry(*args, 1, variant=1), want, torch.float32)


def test_fp32_ancestry_takes_the_decoder_views(card):
    """fp32 B reads q, k_new and v_new as the decoder hands them and returns
    a view the decoder flattens without a copy, as bf16 B does."""
    B, H, K, Dh, L, T = 3, 4, 10, 64, 2, 16
    q, k_new, v_new, kv, flat_rep = ancestry_inputs(B, H, K, Dh, L, T, 9, torch.float32)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k_new, v_new)]
    got = D.ancestry_decode_attention(*views, kv, flat_rep, 0)
    assert got.transpose(1, 2).is_contiguous()
    _close(got, D.reference(q, k_new, v_new, kv, flat_rep, 0), torch.float32)


@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("K", F32_ROWS)
def test_fp32_cross_tensor_cores(card, K, Dh):
    """fp32 C's split pass (3xTF32) against its plain version at B = 2
    (split over blocks) and B = 128 (one split), S = 37 and 250 (not
    multiples of the 16-key tile, 8 at Dh = 128), batch rows of S, S / 8
    and 1 valid keys, so that at B = 2 whole splits are padding; two
    launches give the same bits."""
    for B in (2, 128):
        for S in (37, 250):
            q, kv, _ = cross_inputs(B, 3, K, Dh, S, torch.float32, seed=K + Dh + S)
            lengths = torch.tensor([S, S // 8, 1] * B, device="cuda")[:B]
            bias = torch.where(torch.arange(S, device="cuda")[None, :] < lengths[:, None],
                               0.0, A.NEG_INF)
            n_split = _build.library().mm_cross_decode_splits(_build.F32, B, 3, K, S, Dh)
            if B == 2 and S == 250:
                assert n_split > 2, n_split  # row 1's later splits hold only padding
            got = D.cross_decode_attention(q, kv, bias)
            again = D.cross_decode_attention(q, kv, bias)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            _close(got, D.cross_reference(q, kv, bias), torch.float32)


def test_fp32_cross_takes_the_decoder_views(card):
    """fp32 C reads q as the decoder hands it and returns a view the decoder
    flattens without a copy, for a decode step and for a prefill."""
    for K in (10, 40):
        q, kv, bias = cross_inputs(2, 4, K, 64, 120, torch.float32, seed=K)
        view = q.transpose(1, 2).contiguous().transpose(1, 2)
        got = D.cross_decode_attention(view, kv, bias)
        assert got.transpose(1, 2).is_contiguous()
        _close(got, D.cross_reference(q, kv, bias), torch.float32)


@pytest.mark.parametrize("B,K,S", [(1, 501, 250), (2, 501, 250), (3, 17, 13)])
def test_fp32_prefill_through_a(card, B, K, S):
    """fp32 C with more than 16 rows (the streaming prefill's P = 501) is
    kernel A's fp32 forward with scale 1 over the slab's K and V halves:
    the same bits as that call, one A launch and one C count, and within
    TOL of the plain version."""
    H, Dh = 8, 64
    q, kv, bias = cross_inputs(B, H, K, Dh, S, torch.float32, seed=K + S)
    before = (D.cross_decode_attention.launches, A.flash_attention.launches)
    got = D.cross_decode_attention(q, kv, bias)
    assert (D.cross_decode_attention.launches, A.flash_attention.launches) == \
        (before[0] + 1, before[1])
    direct = A._launch("mm_flash_attention", q.transpose(1, 2), kv[..., :Dh].transpose(1, 2),
                       kv[..., Dh:].transpose(1, 2), bias, 1.0, False, 0, 0.0, None, None)
    torch.cuda.synchronize()
    assert torch.equal(got.transpose(1, 2), direct)
    _close(got, D.cross_reference(q, kv, bias), torch.float32)


F32_E_ROWS = [1, 10, 16, 40]  # a decode step's rows, and three row groups


@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("K", F32_E_ROWS)
def test_fp32_cross_i8_tensor_cores(card, K, Dh):
    """fp32 E's split pass (2xTF32 on the tensor cores) against its plain
    version at B = 8 (split over blocks) and B = 128 (one split), S = 37,
    250 and 4000 (not multiples of the 32-key tile, 16 at Dh = 128), batch
    rows of S, S / 8 and 1 valid keys, so that at B = 8 whole splits are
    padding; two launches give the same bits."""
    H = 2
    for B in (8, 128):
        for S in (37, 250, 4000):
            q, kv, sk, sv, _ = quant_cross_inputs(B, H, K, Dh, S, torch.float32, seed=K + Dh + S)
            lengths = torch.tensor([S, S // 8, 1] * B, device="cuda")[:B]
            bias = torch.where(torch.arange(S, device="cuda")[None, :] < lengths[:, None],
                               0.0, A.NEG_INF)
            args = (q, kv, sk, sv, bias)
            n_split = _e_splits(B, H, K, S, Dh)
            assert (n_split > 1) == (B == 8), n_split  # B = 128 fills a wave
            got = D.cross_decode_attention_i8(*args)
            again = D.cross_decode_attention_i8(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            want = D.cross_reference_i8(*args)
            tol = TOL[torch.float32] * max(1.0, want.abs().max().item())
            _close(got, want, torch.float32, tol)


def test_fp32_cross_i8_takes_the_decoder_views(card):
    """fp32 E reads q as the decoder hands it and returns a view the decoder
    flattens without a copy, for a decode step and for a prefill's rows."""
    for K in (10, 40):
        q, kv, sk, sv, bias = quant_cross_inputs(2, 4, K, 64, 120, torch.float32, seed=K)
        view = q.transpose(1, 2).contiguous().transpose(1, 2)
        assert not view.is_contiguous()
        got = D.cross_decode_attention_i8(view, kv, sk, sv, bias)
        assert got.transpose(1, 2).is_contiguous()
        _close(got, D.cross_reference_i8(q, kv, sk, sv, bias), torch.float32)


@pytest.mark.parametrize("K", [16, 10, 40])
def test_cross_decode_f32_long_slab(card, K):
    """fp32 C over S = 4000 encoder positions: 16 rows of scores pass a
    block's shared memory, and B.H = 8 is under a wave, so the slab is
    split over S (16 spans of 250 keys for 10, 16 and 40 rows, the last in
    three row groups) and merged in split order. Each against the plain
    version."""
    n_split = _build.library().mm_cross_decode_splits(_build.F32, 2, 4, K, 4000, 64)
    assert n_split == 16, n_split
    q, kv, bias = cross_inputs(2, 4, K, 64, 4000, torch.float32, seed=K)
    before = D.cross_decode_attention.launches
    got = D.cross_decode_attention(q, kv, bias)
    assert D.cross_decode_attention.launches == before + 1
    _close(got, D.cross_reference(q, kv, bias), torch.float32)


def _to(state, device):
    """A server state (tensors, per-layer cross dicts, the host int g) on
    ``device``."""
    out = {}
    for key, v in state.items():
        if key == "cross":
            out[key] = [{k: t.to(device, copy=True) for k, t in c.items()} for c in v]
        else:
            out[key] = v.to(device, copy=True) if isinstance(v, torch.Tensor) else v
    return out


@pytest.mark.parametrize("cache", ["bfloat16", "int8", "int4"])
def test_serve_step_on_a_wrapped_ring(card, cache):
    """``UnitDecoder.serve_step`` (kernels B, D or F over the ring, C or E
    across) at B=4 slots, K=5 beams, on a 12-step ring at g = 29: slots
    admitted at ring steps 3, 7, 11 and 0 with 10, 5, 11 and 2 live steps,
    so three windows wrap (the oldest live step physically after the
    newest); random cache contents and ancestry. A bf16 small model on the
    card against the same state on the CPU (the plain versions), three
    steps: logits within TOL (int8 / int4: TOL_REQUANT) times max(1, the
    largest |logit|)."""
    import copy
    import dataclasses

    from chip_smoke import init_random_, small_config
    from mm_s2ut_torch.infer.serving import ContinuousServer
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel

    cfg = dataclasses.replace(small_config(), dtype="bfloat16")
    cpu_model = init_random_(MMS2UTModel(cfg), torch.Generator().manual_seed(9)).eval()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    B, K, T = 4, 5, 12
    srv = ContinuousServer(cpu_model, slots=B, beam_size=K, ring=T, chunk=1, enc_frames=96,
                           max_len_a=0.0, max_len_b=8, kv_cache_dtype=cache,
                           img_shapes=((20, 768),))
    g = torch.Generator().manual_seed(29)
    state = srv.init_state()
    wave = {"feats": torch.randn(B, 96, 80, generator=g), "lens": torch.tensor([96, 80, 61, 40]),
            "imgs": [torch.randn(B, 20, 768, generator=g)],
            "masks": [torch.zeros(B, 20, dtype=torch.bool)]}
    srv._admit(state, srv._encode(wave), list(range(B)), list(range(B)),
               srv._budgets(wave["lens"].numpy()))
    kv = state["self_kv"]
    if cache == "bfloat16":
        kv.copy_(torch.randn(kv.shape, generator=g).to(kv.dtype))
    else:
        kv.copy_(torch.randint(-127, 128, kv.shape, generator=g, dtype=torch.int8))
        for key in ("self_kv_sk", "self_kv_sv"):
            state[key].copy_(torch.rand(state[key].shape, generator=g) * 0.05 + 1e-3)
    state.update(g=29, ring_base=torch.tensor([3, 7, 11, 0]), local_step=torch.tensor([10, 5, 11, 2]),
                 ancestry=torch.randint(0, K, (B, K, T), generator=g))
    card = _to(state, "cuda")
    counter = {"bfloat16": D.ancestry_decode_attention, "int8": D.ancestry_decode_attention_i8,
               "int4": D.ancestry_decode_attention_i4}[cache]
    tol = (TOL if cache == "bfloat16" else TOL_REQUANT)[torch.bfloat16]
    before = counter.launches
    with torch.no_grad():
        for _ in range(3):
            tokens = torch.randint(4, 1004, (B * K, 1), generator=g)
            want, state = cpu_model.serve_step(tokens, state)
            got, card = gpu_model.serve_step(tokens.cuda(), card)
            _close(got, want.cuda(), torch.bfloat16,
                   tol * max(1.0, want.float().abs().max().item()))
    assert counter.launches == before + 3 * cfg.decoder_layers
    assert card["g"] == state["g"] == 32
    assert torch.equal(card["local_step"].cpu(), state["local_step"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_decode_i8_long_slab(card, dtype):
    """E over S = 4000 encoder positions against the plain version: 250
    key tiles over few (b.h, group) blocks, so both dtypes split the tiles
    over blocks (about two blocks per SM, whole tiles each, at most
    kEMaxSplits) and merge the partial sums, one rule for bf16 and fp32."""
    args = quant_cross_inputs(2, 2, 10, 64, 4000, dtype, seed=40)
    _close(D.cross_decode_attention_i8(*args), D.cross_reference_i8(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 5, 10, 16, 40, 501])
def test_cross_decode_i8_rows(card, dtype, K):
    """E at a decode step's row counts and at the prefill's (groups of 16
    rows), B = 8 (split over blocks) at S = 250, against the plain version;
    two launches give the same bits."""
    args = quant_cross_inputs(8, 2, K, 64, 250, dtype, seed=K)
    got = D.cross_decode_attention_i8(*args)
    again = D.cross_decode_attention_i8(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, D.cross_reference_i8(*args), dtype)


@pytest.mark.parametrize("B", [8, 128])
def test_cross_decode_i8_variants_give_the_same_bits(card, B):
    """E's v1 (two batch rows per block, in turn) gives v0's bits."""
    args = quant_cross_inputs(B, 8, 10, 64, 250, torch.bfloat16, seed=B)
    got = D._launch_cross_i8(*args)
    other = D._launch_cross_i8(*args, variant=1)
    torch.cuda.synchronize()
    assert torch.equal(got, other)


def test_cross_decode_i8_takes_the_decoder_views(card):
    """Kernel E reads q as the decoder hands it and returns a view the
    decoder flattens without a copy."""
    q, kv, sk, sv, bias = quant_cross_inputs(2, 4, 10, 64, 120, torch.bfloat16, seed=3)
    view = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    got = D.cross_decode_attention_i8(view, kv, sk, sv, bias)
    assert got.transpose(1, 2).is_contiguous()
    _close(got, D.cross_reference_i8(q, kv, sk, sv, bias), torch.bfloat16)


@pytest.mark.parametrize("cache,step", [("bfloat16", 10), ("float32", 7), ("int8", 25),
                                        ("int4", 3), ("int4", 20)])
def test_cache_write_kernel_bit_exact(card, cache, step):
    """The cache-write kernel writes the decoder's plain write's bytes (and
    scales), at a step index in the low and the high half of an int4
    cache, from the decoder's permuted row views."""
    B, K, cap, L, H, Dh = 4, 5, 32, 3, 2, 32
    TS = cap * K  # int4: P = 80 packed rows, steps 3 and 20 on either side
    g = torch.Generator(device="cuda").manual_seed(step)
    dt = torch.float32 if cache == "float32" else torch.bfloat16
    rows = torch.randn((B, K, L, H, 2 * Dh), generator=g, device="cuda").to(dt)
    k_rows, v_rows = (rows[..., i * Dh:(i + 1) * Dh].permute(0, 2, 3, 1, 4) for i in range(2))
    quant = cache in ("int8", "int4")
    if quant:
        kv = torch.randint(-128, 128, (B, L, H, TS // 2 if cache == "int4" else TS, 2 * Dh),
                           generator=g, device="cuda", dtype=torch.int8)
        sk, sv = (torch.rand((B, L, H, TS), generator=g, device="cuda") for _ in range(2))
    else:
        kv = torch.randn((B, L, H, TS, 2 * Dh), generator=g, device="cuda").to(dt)
        sk = sv = None
    mine = [t.clone() if t is not None else None for t in (kv, sk, sv)]
    before = D.cache_write.launches
    D.cache_write(mine[0], k_rows, v_rows, step * K, mine[1], mine[2])
    assert D.cache_write.launches == before + 1
    D.write_step(kv, k_rows, v_rows, step * K, sk, sv)
    torch.cuda.synchronize()
    for x, y in zip(mine, (kv, sk, sv)):
        if x is not None:
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("packed", [False, True])
def test_dense_probe(card, packed):
    """The dense probe kernel over an int8 slab and over the same values
    nibble-packed: against its plain version, and the same bits both ways.
    Its outputs are convex mixes of values up to 7, where one bf16 ulp is
    2^-5: the tolerance is bf16's 2e-2 times the largest |output| (as for
    A with dropout)."""
    B, H, K, S = 4, 8, 10, 2010
    g = torch.Generator(device="cuda").manual_seed(S)
    q = (torch.randn((B, H, K, 64), generator=g, device="cuda") * 0.3).to(torch.bfloat16)
    vals = torch.randint(-7, 8, (B, H, S, 128), generator=g, device="cuda", dtype=torch.int8)
    kv = D.i4_pack(vals, S // 2) if packed else vals
    got = D.dense_attention(q, kv, packed)
    want = D.dense_reference(q, kv, packed)
    _close(got, want, torch.bfloat16, TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item()))
    other = D.dense_attention(q, vals if packed else D.i4_pack(vals, S // 2), not packed)
    torch.cuda.synchronize()
    assert torch.equal(got, other)


# The enhanced path's shapes (chip_smoke phase 2's XM cases): wav2vec2
# frames of 2-10 s utterances (T = 499 for 10 s), the XM decoder (H = 16,
# L = 12, K = 10, step 200 of 263) and the adaptor's slab (S = 63 for 10 s,
# 7 for 1 s: shorter than one key tile).


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H", [(8, 12), (8, 16), (128, 12)])
def test_flash_attention_wav2vec2_frames(card, dtype, B, H):
    _, frames, _ = xm_lengths(B)
    T = int(frames.max())
    assert T == 499
    g = torch.Generator().manual_seed(B + H)
    q, k, v = ((torch.randn((B, T, H, 64), generator=g)).to("cuda", dtype) for _ in range(3))
    kpm = (torch.arange(T)[None, :] >= frames[:, None]).cuda()
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kpm)
    assert A.flash_attention.launches == before + 1
    _close(got, A.reference_attention(q * 64 ** -0.5, k, v, bias), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ancestry_decode_xm_decoder(card, dtype):
    x = XM
    args = ancestry_inputs(x["B"], x["H"], x["K"], x["Dh"], x["L"], x["T_dec"], x["step"], dtype)
    for layer in (0, x["L"] - 1):
        _close(D.ancestry_decode_attention(*args, layer), D.reference(*args, layer), dtype)
    qargs = quant_ancestry_inputs(x["B"], x["H"], x["K"], x["Dh"], x["L"], x["T_dec"], x["step"],
                                  dtype, seed=1)
    for layer in (0, x["L"] - 1):
        _close(D.ancestry_decode_attention_i8(*qargs, layer), D.reference_i8(*qargs, layer), dtype,
               TOL_REQUANT[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,seconds", [(63, (2.0, 10.0)), (7, (1.0, 1.0))])
def test_cross_decode_xm_slab(card, dtype, S, seconds):
    x = XM
    _, _, positions = xm_lengths(x["B"], *seconds)
    assert int(positions.max()) == S
    bias = xm_bias(positions, S)
    q, kv, _ = cross_inputs(x["B"], x["H"], x["K"], x["Dh"], S, dtype, seed=S)
    _close(D.cross_decode_attention(q, kv, bias), D.cross_reference(q, kv, bias), dtype)
    q8, kv8, sk, sv, _ = quant_cross_inputs(x["B"], x["H"], x["K"], x["Dh"], S, dtype, seed=S)
    _close(D.cross_decode_attention_i8(q8, kv8, sk, sv, bias),
           D.cross_reference_i8(q8, kv8, sk, sv, bias), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_xm_bench_point_shapes(card, dtype):
    """B, C, D and E at phase 16's bench point: B·H = 2048 (the split
    rules' other route), all 12 layers' cache and scales at step 150 of
    201, and the 63-position slab of 10 s utterances."""
    x = XM_BENCH
    TS = x["T_dec"] * x["K"]
    if dtype == torch.bfloat16:  # one split each here; at XM's B=8 both split over blocks
        lib = _build.library()
        assert lib.mm_ancestry_decode_splits(_build.BF16, x["B"], x["H"], TS, 0) == 1
        assert lib.mm_ancestry_decode_i8_splits(x["B"], x["H"], x["K"], TS) == 1
        ts8 = XM["T_dec"] * XM["K"]
        assert lib.mm_ancestry_decode_splits(_build.BF16, XM["B"], XM["H"], ts8, 0) > 1
        assert lib.mm_ancestry_decode_i8_splits(XM["B"], XM["H"], XM["K"], ts8) > 1
    args = ancestry_inputs(x["B"], x["H"], x["K"], x["Dh"], x["L"], x["T_dec"], x["step"], dtype,
                           seed=30, on_card=True)
    for layer in (0, x["L"] - 1):
        _close(D.ancestry_decode_attention(*args, layer), D.reference(*args, layer), dtype)
    del args
    torch.cuda.empty_cache()
    qargs = quant_ancestry_inputs(x["B"], x["H"], x["K"], x["Dh"], x["L"], x["T_dec"], x["step"],
                                  dtype, seed=31)
    for layer in (0, x["L"] - 1):
        _close(D.ancestry_decode_attention_i8(*qargs, layer), D.reference_i8(*qargs, layer), dtype,
               TOL_REQUANT[dtype])
    del qargs
    torch.cuda.empty_cache()
    _, _, positions = xm_lengths(x["B"], 10.0, 10.0)
    assert int(positions.max()) == int(positions.min()) == x["S"]
    bias = xm_bias(positions, x["S"])
    q, kv, _ = cross_inputs(x["B"], x["H"], x["K"], x["Dh"], x["S"], dtype, seed=32)
    _close(D.cross_decode_attention(q, kv, bias), D.cross_reference(q, kv, bias), dtype)
    q8, kv8, sk, sv, _ = quant_cross_inputs(x["B"], x["H"], x["K"], x["Dh"], x["S"], dtype, seed=33)
    _close(D.cross_decode_attention_i8(q8, kv8, sk, sv, bias),
           D.cross_reference_i8(q8, kv8, sk, sv, bias), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", [12, 16])
def test_flash_attention_at_the_vit_shape(card, dtype, H):
    """A at the image encoders' shape (``chip_smoke.VIT``): 577 queries
    over 584 keys whose last 7 are padding, q a strided view of one
    (B, T, 3, H, Dh) projection and k, v padded copies, as the ViT makes
    them; against the plain version."""
    import torch.nn.functional as F

    B, Tq, S, Dh = VIT["B"], VIT["Tq"], VIT["S"], VIT["Dh"]
    g = torch.Generator().manual_seed(H)
    qkv = (torch.randn(B, Tq, 3, H, Dh, generator=g)).to("cuda", dtype)
    q = qkv[:, :, 0]
    k, v = (F.pad(qkv[:, :, i], (0, 0, 0, 0, 0, S - Tq)) for i in (1, 2))
    assert not q.is_contiguous() and A._rows_aligned(q)
    key_bias = A.padding_bias((torch.arange(S)[None, :] >= Tq).expand(B, S).cuda(), B, S, "cuda")
    before = A.flash_attention.launches
    got = A.flash_attention_biased(q, k, v, key_bias)
    assert A.flash_attention.launches == before + 1 and got.shape == (B, Tq, H, Dh)
    _close(got, A.reference_attention(q * Dh ** -0.5, k, v, key_bias[:, None, None, :]), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", [12, 16])
def test_flash_attention_bwd_at_the_vit_training_shape(card, dtype, H):
    """H after A at the ViT's training shape: 577 queries over 584 keys
    whose last 7 are padding (Tq ≠ S), B = 2; dq, dk, dv, dbias against
    the plain twin, the padded keys' dk and dv exactly 0; and the autograd
    route the ViT trains through gives the same gradients."""
    import torch.nn.functional as F

    B, Tq, S, Dh = 2, VIT["Tq"], VIT["S"], VIT["Dh"]
    g = torch.Generator().manual_seed(H + 1)
    qkv = torch.randn(B, Tq, 3, H, Dh, generator=g).to("cuda", dtype)
    q = qkv[:, :, 0]
    k, v = (F.pad(qkv[:, :, i], (0, 0, 0, 0, 0, S - Tq)) for i in (1, 2))
    dout = torch.randn(B, Tq, H, Dh, generator=g).to("cuda", dtype)
    bias = A.padding_bias((torch.arange(S)[None, :] >= Tq).expand(B, S).cuda(), B, S, "cuda")
    scale = Dh ** -0.5
    stats = torch.empty((2, B * H, Tq), device="cuda")
    A._launch("mm_flash_attention", q, k, v, bias, scale, False, 0, 0.0, None, stats)
    got = A.flash_attention_bwd(q, k, v, bias, stats, dout, scale, False, 0)
    for x, y in zip(got, A.reference_attention_bwd(q, k, v, bias, dout, scale)):
        _rel_close(x, y, dtype)
    assert all((x[:, Tq:] == 0).all() for x in got[1:3])
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    A.flash_attention_biased(*leaves, bias, scale=scale).backward(dout)
    for x, y in zip((t.grad for t in leaves), got[:3]):
        torch.cuda.synchronize()
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,block_k", [(False, 0, None), (True, 8, 64)])
def test_dropout_row_offset_gives_those_rows_of_the_batch(card, dtype, causal, window, block_k):
    """A data-parallel shard: A (or G) and H with attention dropout 0.1 on
    rows 2.. of a batch, given ``dropout_row0`` 2, equal rows 2.. of the
    whole batch's output and gradients bit for bit (the kernels hash the
    global (b·H + h) row); without the offset they draw another mask."""
    B, T, H, D = 4, 70, 2, 64
    q, k, v, kpm = flash_inputs(B, T, H, D, dtype, seed=5)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)).to("cuda", dtype)

    def run(rows, row0):
        leaves = [t[rows].detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = A.flash_attention(*leaves, kpm[rows], causal=causal, window=window,
                                dropout_rate=0.1, dropout_seed=DROP_SEED, block_k=block_k,
                                dropout_row0=row0)
        out.backward(g[rows])
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in leaves]

    full, part = run(slice(0, B), 0), run(slice(2, B), 2)
    for x, y in zip(part, full):
        assert torch.equal(x, y[2:])
    assert not torch.equal(run(slice(2, B), 0)[0], full[0][2:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_small_vit_card_against_cpu(card, dtype):
    """A ViT of two 64-d blocks at 48² (10 tokens, keys padded to 16) on
    the card against the same weights on the CPU (the plain version), with
    A launched once per block; fp32 1e-4, bf16 5e-2, times max(1, the
    largest |CPU feature|)."""
    import copy

    from mm_s2ut_torch.models.vit import ViTConfig, VisionTransformer

    vit = VisionTransformer(ViTConfig(image_size=48, embed_dim=64, depth=2, num_heads=4))
    with torch.no_grad():
        for p in vit.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    vit = vit.to(dtype).eval()
    x = torch.randn(3, 48, 48, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = vit(x)
        before = A.flash_attention.launches
        got, _ = copy.deepcopy(vit).cuda()(x.cuda())
    assert A.flash_attention.launches == before + 2
    tol = (5e-2 if dtype == torch.bfloat16 else 1e-4) * max(1.0, want.float().abs().max().item())
    _close(got.cpu(), want, dtype, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", [12, 16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wav2vec2_train_shapes_forward_and_backward(card, dtype, H, rate):
    """A with attention dropout, then H after it, at B=8, T=499 over the
    key padding of 2-10 s utterances, against their plain versions."""
    _, frames, _ = xm_lengths(8)
    T = int(frames.max())
    g = torch.Generator().manual_seed(300 + H)
    q, k, v, dout = (torch.randn((8, T, H, 64), generator=g).to("cuda", dtype) for _ in range(4))
    kpm = (torch.arange(T)[None, :] >= frames[:, None]).cuda()
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
    seed = DROP_SEED if rate else None
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kpm, dropout_rate=rate, dropout_seed=seed)
    assert A.flash_attention.launches == before + 1
    want = A.reference_attention(q * 64 ** -0.5, k, v, bias[:, None, None, :], False, 0, rate,
                                 seed)
    _rel_close(got, want, dtype)
    stats = torch.empty((2, 8 * H, T), device="cuda")
    A._launch("mm_flash_attention", q, k, v, bias, 64 ** -0.5, False, 0, rate, seed, stats)
    got = A.flash_attention_bwd(q, k, v, bias, stats, dout, 64 ** -0.5, False, 0, rate, seed)
    want = A.reference_attention_bwd(q, k, v, bias, dout, 64 ** -0.5, False, 0, rate, seed)
    for x, y in zip(got, want):
        _rel_close(x, y, dtype)


def test_small_checkpointed_xm_train_step_card_against_cpu(card):
    """Three train steps of a small fp32 XM model (LayerDrop 0.3,
    ``gradient_checkpointing``, attention dropout 0.1 in A and H) on the
    card against the CPU from the same weights: losses, step-1 gradients
    and parameters (``card_vs_cpu``'s tolerances); A launched twice per
    kept layer (the forward and the recompute), H once."""
    import dataclasses

    import numpy as np

    from chip_smoke import init_random_, synthetic_batch
    from mm_s2ut_torch.config import Config, TrainConfig
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel

    cfg = xm_config(dict(hidden_dropout=0.0, attention_dropout=0.1, layerdrop=0.3,
                         gradient_checkpointing=True), dtype="float32", small=True)
    cfg = dataclasses.replace(cfg, dropout=0.0, attention_dropout=0.0, activation_dropout=0.1,
                              multimodal=dataclasses.replace(cfg.multimodal, SA_image_dropout=0.0,
                                                             SA_attention_dropout=0.0))
    model = init_random_(MMXMTransformerModel(cfg), torch.Generator().manual_seed(3))
    wav, lens, imgs = synthetic_batch(2, torch.Generator().manual_seed(4), 1.0, 2.0)
    rng = np.random.RandomState(5)
    batch = {"src_features": wav.numpy(), "src_lengths": lens.numpy().astype(np.int32),
             "prev_output_tokens": rng.randint(4, 1000, (2, 9)).astype(np.int32),
             "target": rng.randint(4, 1000, (2, 9)).astype(np.int32),
             "imgs_list": (imgs[:, :20].numpy(),), "img_masks_list": (np.zeros((2, 20), bool),)}
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    launched = card_vs_cpu("small XM", model, Config(model=cfg, train=TrainConfig(
        lr=1e-3, warmup_updates=1)), batch, counters)
    assert launched["H"] > 0 and launched["A"] == 2 * launched["H"], launched


def test_train_steps_repeat_bit_for_bit(card):
    """Two trainers of the small fp32 config (dropouts 0.1) from the same
    weights take the same three steps on the card: every parameter ends
    bit for bit equal. cuDNN's default weight gradient for the
    subsampler's first conv varies from call to call, and Adam enlarges
    such a difference on a near-zero gradient; the train step holds cuDNN
    to its deterministic algorithms (``trainer.deterministic_convs``)."""
    import copy

    import numpy as np

    from chip_smoke import init_random_, small_config
    from mm_s2ut_torch.config import Config, TrainConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.train.trainer import Trainer

    cfg = small_config()
    cfg.multimodal.image_feat_dim = [64]
    gen = torch.Generator().manual_seed(23)
    rng = np.random.RandomState(23)
    target = rng.randint(4, 1004, (4, 12)).astype(np.int32)
    target[1, 8:] = 1
    batch = {"src_features": torch.randn(4, 300, 80, generator=gen).numpy(),
             "src_lengths": np.array([300, 217, 280, 150], np.int32), "target": target,
             "prev_output_tokens": rng.randint(4, 1004, (4, 12)).astype(np.int32),
             "imgs_list": (torch.randn(4, 10, 64, generator=gen).numpy(),),
             "img_masks_list": (np.zeros((4, 10), bool),)}
    model = init_random_(MMS2UTModel(cfg), torch.Generator().manual_seed(5))
    runs = []
    for _ in range(2):
        trainer = Trainer(Config(model=cfg, train=TrainConfig(lr=1e-3, warmup_updates=1)),
                          copy.deepcopy(model), "cuda")
        losses = [trainer.train_batch(copy.deepcopy(batch))["loss"] for _ in range(3)]
        runs.append((losses, [p.detach().cpu() for p in trainer.params]))
    assert runs[0][0] == runs[1][0]
    differ = [i for i, (a, b) in enumerate(zip(runs[0][1], runs[1][1])) if not torch.equal(a, b)]
    assert not differ, differ


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_small_ensemble_card_against_cpu(card, kv):
    """A two-member logit ensemble of the small fp32 config, decoded on the
    card and on the CPU from the same weights: the same tokens, scores
    within 1e-4; each member's decode steps launch the cache's kernels."""
    from chip_smoke import init_random_, small_config, synthetic_batch
    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

    cpu = [init_random_(MMS2UTModel(small_config()), torch.Generator().manual_seed(s)).eval()
           for s in (40, 41)]
    gpu = [MMS2UTModel(small_config()).eval() for _ in cpu]
    for g, c in zip(gpu, cpu):
        g.load_state_dict(c.state_dict())
        g.cuda()
    wav, lens, imgs = synthetic_batch(2, torch.Generator().manual_seed(42))
    feats, flens = waveform_frontend(wav, lens, FbankConfig())
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool)
    gcfg = GenerationConfig(beam=3, max_len_a=0.0, max_len_b=70, kv_cache_dtype=kv)
    want = UnitGenerator(cpu, gcfg).generate(feats, flens, [imgs], [masks])
    self_k = {None: D.ancestry_decode_attention, "int8": D.ancestry_decode_attention_i8,
              "int4": D.ancestry_decode_attention_i4}[kv]
    cross_k = D.cross_decode_attention if kv is None else D.cross_decode_attention_i8
    self_k.launches = cross_k.launches = 0
    got = UnitGenerator(gpu, gcfg).generate(feats.cuda(), flens.cuda(), [imgs.cuda()],
                                            [masks.cuda()])
    layers = small_config().decoder_layers
    assert self_k.launches > 0 and self_k.launches % (2 * layers) == 0, self_k.launches
    assert cross_k.launches == self_k.launches
    for g, w in zip(got, want):
        assert [h["tokens"] for h in g] == [h["tokens"] for h in w]
        assert max(abs(a["score"] - b["score"]) for a, b in zip(g, w)) <= 1e-4


def test_kmeans_assign_card_against_cpu(card):
    """Assignment of 4096 frames to 1000 centroids of 768 dims on the card
    against the CPU: equal but at near-ties (``chip_smoke.near_ties``)."""
    from chip_smoke import near_ties
    from mm_s2ut_torch.ops.kmeans import KMeansQuantizer

    g = torch.Generator().manual_seed(43)
    centroids = torch.randn(1000, 768, generator=g)
    x = centroids[torch.randint(0, 1000, (4096,), generator=g)] + torch.randn(4096, 768,
                                                                               generator=g)
    quant = KMeansQuantizer(centroids.numpy())
    want = quant(x)
    got = quant(x.cuda())
    assert want.device.type == "cpu" and got.device.type == "cuda"
    got = got.cpu()
    differ = got != want
    assert near_ties(x, centroids)[differ].all(), int(differ.sum())
