"""Kernels A–H on the card against their plain PyTorch versions on the
same CUDA tensors. Skipped without a CUDA device. On a GPU machine
(which needs neither JAX nor this directory's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (both sides fp32; summation order differs), bf16
2e-2 (the plain versions round softmax weights and products to bf16
between the two contractions; the SIMT kernels keep fp32 until the
store, while bf16 A and H, on the tensor cores, round the weights times
the dropout factor and dS to bf16 before their second products, with
fp32 accumulation: ``tests/test_torch_attention_tc_numerics.py`` holds
those rounding points to the same tolerances on the CPU).
Kernels D and F (int8 / int4 cache): fp32 2e-3, bf16 2e-2, for a
requantized softmax weight that flips one level at a rounding tie
(``chip_smoke.TOL_REQUANT``); E as C. A's causal branch and G are held
against the plain version on every row, the padded rows whose whole
window band is padding included (G reproduces the reference's uniform
average there, ``csrc/flash_attention.cu``). A and G with attention
dropout, and H's four gradients, are held to the same tolerances times
the largest magnitude of the twin's output (a dropped-out row of few
keys puts out up to |v|/(1 − p), gradients grow with T); in fp32 that
still catches a single weight dropped on one side only."""
import pytest
import torch

from chip_smoke import (
    BENCH,
    FLAGSHIP,
    TOL,
    TOL_REQUANT,
    ancestry_inputs,
    cross_inputs,
    flash_inputs,
    kernel_cases,
    quant_ancestry_inputs,
    quant_cross_inputs,
)
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


@pytest.mark.parametrize("variant", [1, 2])
def test_ancestry_decode_variants(card, variant):
    """The designs ``tools/kernel_ab.py`` times against kernel B's (all
    heads per block; the SIMT split pass in bf16) at the flagship's bf16
    shape give the plain version's result too."""
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
    (decode-step) call on the first 16 rows takes the same code path in
    fp32 C and in E (one block per 16 rows), so there it gives the same
    bits; bf16 C takes A's tensor-core forward for many rows and its split
    kernel for 16, so there both are held to the plain version."""
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
    if int8 or dtype == torch.float32:
        assert torch.equal(got[:, :, :16], head)
    else:
        _close(head, plain(args[0][:, :, :16].contiguous(), *args[1:]), dtype)
    again = kern(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


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
