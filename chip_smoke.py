#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mm_s2ut_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Every phase fails the run on any error (no exception is caught, and there
is no CPU path):

1. the card (``nvidia-smi`` name and power limit) and the ``nvcc`` build
   of ``mm_s2ut_torch/csrc/*.cu`` (one process per source), with its seconds;
2. kernels A, B and C against their plain PyTorch versions on the card at
   the main path's flagship shapes, and D, E and F at the reference
   bench's shapes (B=128, K=10, T·S=2010 at step 150, S=250), in bf16 and
   fp32, each timed beside its plain version with CUDA events, and A at
   the offline bench point's encoder call (B=128, T=250), B and C at its
   decode shape (B=128, step 150 of 201; C beside SDPA), and D at the
   flagship's (B=8, step 300 of 500); then A's
   causal branch and G at the streaming encoder's shapes (B=1 and B=8 at
   T=250, B=1 at T=1000, window 0 and 64), and C and E with the prefill's
   501 query rows at S=250;
3. the small fp32 config on the card against the same parameters on the
   CPU through ``UnitGenerator.generate`` (TF32 off), with the default,
   int8 and int4 caches and a search long enough to grow the cache:
   tokens equal;
4. the main path at the full flagship width in bf16 with random weights
   from a seeded ``torch.Generator``: 8 synthetic 1-4 s wavs and 8 random
   577x768 image feature arrays → fbank → encode + selective fusion →
   beam 10 (max_len_a 1, max_len_b 200) → units → CodeHiFiGAN at its
   default config → wav, with the launches of A, B and C counted over
   exactly this run; then one decode step of the same search traced by
   ``torch.profiler`` (B's and C's share of the device time, the device's
   busy share);
5. the reference bench's operating point (``bench.py:236-247``): the same
   model, 128 synthetic 10 s wavs and 128 image arrays, beam 10,
   max_len_a 0, max_len_b 200, int8 KV cache, units → wav, with the
   launches of A, D and E counted over exactly this run; then the same
   batch with the bf16 cache, for both rates from one card;
6. the int4 cache at flagship width: 8 utterances, beam 10, max_len_b 200,
   with the launches of F and E counted;
7. streaming on a small fp32 causal config (TF32 off): the streamed
   encoder rows on the card equal the offline causal encoder's (kernel G)
   and the CPU's, and ``StreamingS2ST.finalize()`` equals
   ``UnitGenerator.generate`` on the same frames token for token, with full
   re-decode, prefix reuse, and prefix reuse with the int8 cache, its
   committed units a prefix of the final hypothesis;
8. the reference streaming bench's operating point
   (``benchmarks/bench_streaming.py:56-82``) at full width with random
   weights: the 12-layer causal encoder, speech only, bf16, 320 ms chunks
   (32 frames) of 10 s utterances, beam 10, max_len 500, 48 new tokens per
   search with prefix reuse; one warm-up and three measured utterances
   through ``StreamingS2ST``, per-chunk latency percentiles, finalize ms and
   commit ratio, then one offline encode of the same frames, with the
   launches of G, B and C counted over the measured utterances and that
   encode;
9. the two entry points of the causal model on an exported checkpoint
   (small fp32 config, random weights) and a default-config vocoder:
   ``python -m mm_s2ut_torch.inference`` (its encoder runs G) and
   ``python -m mm_s2ut_torch.cli.stream`` (prefix reuse, streaming
   vocoder) give the same units, and the streamed wav equals an offline
   vocode of them;
10. one train step, card against CPU: the small fp32 config with every
    dropout rate 0, TF32 off, three ``Trainer.train_batch`` steps from the
    same weights on the same batch: losses within a relative 1e-5, the
    first step's gradients within a relative 1e-4, A and H launched once
    per encoder layer per step;
11. the reference's train bench point (``bench.py:125-191``, ``:410-426``)
    at full width: the flagship bf16 with fusion over 577x768 image
    features, every dropout 0.1, modality and audio dropout 0.5, label
    smoothing 0.2, Adam (update_freq 1, warmup 10); B=8, 1000 frames,
    100 targets (3 warm-up + 17 timed steps), then B=2, 4000 frames, 200
    targets (3 + 5): ms per step, peak memory, loss and grad norm per
    step, A and H launches per step, the share of a profiled step in A and
    H; the loss falls over the 20 steps on the fixed B=8 batch;
12. the train entry point on the card: ``mm_s2ut_torch.cli.train.main`` on
    a synthetic corpus (8 wavs, image features, a small bf16 config) on
    the default device for 6 steps, ``--resume`` to 8, then
    ``mm_s2ut_torch.inference`` decodes a wav from that ``save_dir``.

Phase 2 also holds, at the train bench's encoder shapes (B=8, T=250 and
B=2, T=1000, H=8, D=64, ragged key padding), A and G with attention
dropout 0.1 against their twins, and H (dq, dk, dv, dbias) against its
twin, non-causal and causal/window 64, dropout 0 and 0.1, each timed
beside PyTorch's ``scaled_dot_product_attention`` with the same additive
mask (forward for A and G; its backward alone, and forward + backward,
for H), which the port never calls.

The line before the last is the kernels' JSON record (with each
kernel's bound at its recorded shape: the larger of its bytes over
3.35 TB/s and its operations over the peak for its inputs' type); the
last line is ``{"ok": true, "device": {...}}``. Artifacts (.unit files,
generate-smoke.txt, wavs, the training runs) go to ``--out`` (default
``smoke_out/`` beside this file).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# bf16: the plain versions round the softmax weights and every product to
# bf16 between the two contractions. The SIMT kernels (B-G, and A and H in
# fp32) keep fp32 until the final store; bf16 A and H (tensor cores) round
# p times the dropout factor, and H its dS, to bf16 before the second
# products and accumulate in fp32, as the plain versions round the
# weights (tests/test_torch_attention_tc_numerics.py emulates those points
# against the JAX reference on the CPU and holds them to TOL). Outputs are
# convex mixes of O(1) values, so a few bf16
# ulps (2^-8 relative) of them stay well inside 2e-2. Kernel E takes TOL
# too: its plain version dequantizes k and v to bf16 (2^-9 relative per
# element), the kernel folds the f32 scales in after the products.
TOL_REQUANT = {torch.bfloat16: 2e-2, torch.float32: 2e-3}
# Kernels D and F: kernel and plain version quantize q and the softmax
# weights by the same rules in fp32 and sum the integer products exactly,
# but take the softmax denominator in another order. Where w_eff/ws lands
# within an ulp of a rounding tie, one w8 level flips, which moves an
# output by ws·|v8_j| <= (max_j w_eff_j / 127)·levels <= p_max·max|v|/127
# (sv·levels = the column's amax): at the bench inputs below (a softmax
# over ~150 on-path columns of N(0, 1) scores, p_max ~0.05, |v| <= ~3)
# that is ~1.2e-3 for int8 and int4 alike, hence fp32 2e-3; bf16 adds the
# output's rounding.
FLAGSHIP = dict(B=8, H=8, Dh=64, K=10, L=6, T_enc=250, T_dec=500, step=300, S_cross=250)
BENCH = dict(B=128, H=8, Dh=64, K=10, L=6, T_dec=201, step=150, S_cross=250)
# H100 SXM (NVIDIA's data sheet): HBM bytes/s and dense peak op/s by input type.
HBM = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
EB = {torch.bfloat16: 2, torch.float32: 4}
DROP_SEED = 0x5EED


def bound(flops: float, nbytes: float, peak: str) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak for the inputs' type."""
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / PEAK[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_work(B, Tq, S, H, D, dtype, pairs=None):
    """A / G forward: q, k, v, the (B, S) bias and the output; 4·D
    operations per attended (query, key) pair (``pairs``, default all)."""
    pairs = B * H * Tq * S if pairs is None else pairs
    return bound(4 * D * pairs, EB[dtype] * B * D * H * (2 * Tq + 2 * S) + 4 * B * S, "bf16")


def bwd_work(B, T, H, D, dtype):
    """H: q, k, v, dO, O, the row statistics and the bias in; dq, dk, dv
    and dbias out; 10·D operations per (query, key) pair (the recomputed
    scores, dP, dV, dK and dQ)."""
    rows = B * T * H * D * EB[dtype]
    return bound(10 * B * H * T * T * D, 8 * rows + 8 * B * H * T + 8 * B * T, "bf16")


def ancestry_work(q, kv, flat_rep, col_bytes, peak):
    """B, D, F: q, k_new, v_new, flat_rep and the output, plus the cache
    columns on some beam's path in this run's ancestry (``col_bytes`` per
    column and head); 4·Dh operations per on-path column and beam."""
    B, H, K, Dh = q.shape
    cols = sum(int(torch.unique(f[f >= 0]).numel()) for f in flat_rep)
    on_path = int((flat_rep >= 0).sum()) // K  # flat_rep repeats each step's index K times
    nbytes = 4 * q.numel() * q.element_size() + flat_rep.numel() * 4 + cols * H * col_bytes
    return bound(4 * Dh * H * (on_path + B * K), nbytes, peak)


def cross_work(q, S, slab_bytes, peak):
    """C, E: q and the output, the (B, H, S) slab (``slab_bytes`` per
    column and head) and the bias; 4·Dh operations per (row, column)."""
    B, H, K, Dh = q.shape
    nbytes = 2 * q.numel() * q.element_size() + B * H * S * slab_bytes + 4 * B * S
    return bound(4 * B * H * K * S * Dh, nbytes, peak)


def sdpa(q, k, v, mask, scale=None):
    """PyTorch's ``scaled_dot_product_attention`` on (B, T, H, D) tensors
    with an additive mask: the yardstick library call (the port never
    calls it)."""
    import torch.nn.functional as F

    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         attn_mask=mask, scale=scale)
    return out.transpose(1, 2)


def additive_mask(kpm, T, dtype, causal=False, window=0):
    """The (B, 1, 1|T, S) additive mask of kernels A and G for SDPA."""
    from mm_s2ut_torch.ops import attention as A

    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
    if causal:
        allowed = A._causal_allowed(T, kpm.shape[1], window, "cuda")
        bias = torch.where(allowed, bias, torch.full_like(bias, A.NEG_INF))
    return bias.to(dtype)


# ------------------------------------------------------------------ inputs


def init_random_(module, generator):
    """Fill every parameter from a seeded generator (LayerNorm weights 1,
    biases 0, matrices N(0, 1/fan_in)): a model at full width, no checkpoint."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            fan_in = p.shape[1] * (p.shape[2] if p.ndim > 2 else 1)
            p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
    return module


def _randn(shape, gen, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)


def flash_inputs(B, T, H, D, dtype, seed=0):
    """q, k, v (B, T, H, D) and a key-padding mask with ragged lengths."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (_randn((B, T, H, D), g, dtype) for _ in range(3))
    lengths = torch.clamp(T - 17 * torch.arange(B), min=1)
    kpm = (torch.arange(T)[None, :] >= lengths[:, None]).cuda()
    return q, k, v, kpm


def ancestry_inputs(B, H, K, Dh, L, T, step, dtype, seed=0):
    """q, k_new, v_new (B, H, K, Dh), a (B, L, H, T·K, 2·Dh) cache and the
    flat_rep of a random ancestry at ``step``."""
    g = torch.Generator().manual_seed(seed)
    q = _randn((B, H, K, Dh), g, dtype, Dh ** -0.5)
    k_new, v_new = (_randn((B, H, K, Dh), g, dtype) for _ in range(2))
    kv = _randn((B, L, H, T * K, 2 * Dh), g, dtype)
    ancestry = torch.randint(0, K, (B, K, T), generator=g)
    t_idx = torch.arange(T)[None, None, :]
    flat = torch.where(t_idx < step, t_idx * K + ancestry, torch.full_like(ancestry, -1))
    flat_rep = flat.repeat_interleave(K, dim=2).to("cuda", torch.int32)
    return q, k_new, v_new, kv, flat_rep


def cross_inputs(B, H, K, Dh, S, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = _randn((B, H, K, Dh), g, dtype, Dh ** -0.5)
    kv = _randn((B, H, S, 2 * Dh), g, dtype)
    lengths = torch.clamp(S - 23 * torch.arange(B), min=1)
    bias = torch.where(torch.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).cuda()
    return q, kv, bias


def quant_ancestry_inputs(B, H, K, Dh, L, T, step, dtype, int4=False, seed=0):
    """q, k_new, v_new (B, H, K, Dh), a (B, L, H, T·K, 2·Dh) int8 cache
    (int4: nibble-packed, T·K/2 rows) with its (B, L, H, T·K) scales, and
    the flat_rep of a random ancestry at ``step``. The rows are quantized by
    the decoder's own write path (``quantize_rows``, ``i4_pack``), made on
    the card from a seeded generator one layer at a time."""
    from mm_s2ut_torch.models.decoder import quantize_rows
    from mm_s2ut_torch.ops.decode_attention import i4_pack

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q = (randn(B, H, K, Dh) * Dh ** -0.5).to(dtype)
    k_new, v_new = (randn(B, H, K, Dh).to(dtype) for _ in range(2))
    TS = T * K
    kv = torch.empty((B, L, H, TS // 2 if int4 else TS, 2 * Dh), dtype=torch.int8, device="cuda")
    sk, sv = (torch.empty((B, L, H, TS), device="cuda") for _ in range(2))
    for layer in range(L):
        rows = randn(B, H, TS, 2 * Dh).to(dtype)
        cols, sk[:, layer], sv[:, layer] = quantize_rows(
            rows[..., :Dh], rows[..., Dh:], 7.0 if int4 else 127.0)
        kv[:, layer] = i4_pack(cols, TS // 2) if int4 else cols
    ancestry = torch.randint(0, K, (B, K, T), generator=g, device="cuda")
    t_idx = torch.arange(T, device="cuda")[None, None, :]
    flat = torch.where(t_idx < step, t_idx * K + ancestry, torch.full_like(ancestry, -1))
    return q, k_new, v_new, kv, sk, sv, flat.repeat_interleave(K, dim=2).to(torch.int32)


def quant_cross_inputs(B, H, K, Dh, S, dtype, seed=0):
    """q (B, H, K, Dh) and an int8 encoder slab with its scales, made by
    ``MultiHeadAttention.precompute_kv(kv_dtype="int8")`` from random
    encoder states, and a ragged padding bias."""
    from mm_s2ut_torch.models.layers import MultiHeadAttention

    gen = torch.Generator().manual_seed(seed)
    attn = init_random_(MultiHeadAttention(H * Dh, H), gen).to("cuda", dtype)
    with torch.no_grad():
        cache = attn.precompute_kv(_randn((B, S, H * Dh), gen, dtype), kv_dtype="int8")
    q = _randn((B, H, K, Dh), gen, dtype, Dh ** -0.5)
    lengths = torch.clamp(S - 23 * torch.arange(B), min=1)
    bias = torch.where(torch.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).cuda()
    return q, cache["kv"], cache["sk"], cache["sv"], bias


def kernel_cases(dtype, shapes=FLAGSHIP, bench=BENCH):
    """(name, kernel call, plain call, tolerance, library call or None,
    bound): A, B and C at the main path's flagship shapes, D, E and F at
    the reference bench's. B, D and F read an ancestry-indexed or quantized
    cache and E a quantized slab: no single PyTorch call takes them."""
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    s = shapes
    q, k, v, kpm = flash_inputs(s["B"], s["T_enc"], s["H"], s["Dh"], dtype)
    scale = s["Dh"] ** -0.5
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
    b_args = ancestry_inputs(s["B"], s["H"], s["K"], s["Dh"], s["L"], s["T_dec"], s["step"], dtype)
    layer = s["L"] // 2
    c_args = cross_inputs(s["B"], s["H"], s["K"], s["Dh"], s["S_cross"], dtype)
    n = bench
    d_args = quant_ancestry_inputs(n["B"], n["H"], n["K"], n["Dh"], n["L"], n["T_dec"],
                                   n["step"], dtype)
    f_args = quant_ancestry_inputs(n["B"], n["H"], n["K"], n["Dh"], n["L"], n["T_dec"],
                                   n["step"], dtype, int4=True, seed=1)
    e_args = quant_cross_inputs(n["B"], n["H"], n["K"], n["Dh"], n["S_cross"], dtype)
    c_mask = c_args[2][:, None, None, :].to(dtype)
    c_k, c_v = c_args[1][..., : s["Dh"]], c_args[1][..., s["Dh"] :]
    eb = EB[dtype]
    return [
        ("A", lambda: A.flash_attention(q, k, v, kpm),
         lambda: A.reference_attention(q * scale, k, v, bias), TOL[dtype],
         lambda: sdpa(q, k, v, bias.to(dtype)),
         flash_work(s["B"], s["T_enc"], s["T_enc"], s["H"], s["Dh"], dtype)),
        ("B", lambda: D.ancestry_decode_attention(*b_args, layer),
         lambda: D.reference(*b_args, layer), TOL[dtype], None,
         ancestry_work(b_args[0], b_args[3], b_args[4], 2 * s["Dh"] * eb, "bf16")),
        ("C", lambda: D.cross_decode_attention(*c_args),
         lambda: D.cross_reference(*c_args), TOL[dtype],
         lambda: torch.nn.functional.scaled_dot_product_attention(c_args[0], c_k, c_v,
                                                                  attn_mask=c_mask, scale=1.0),
         cross_work(c_args[0], s["S_cross"], 2 * s["Dh"] * eb, "bf16")),
        ("D", lambda: D.ancestry_decode_attention_i8(*d_args, layer),
         lambda: D.reference_i8(*d_args, layer), TOL_REQUANT[dtype], None,
         ancestry_work(d_args[0], d_args[3], d_args[6], 2 * n["Dh"] + 8, "int8")),
        ("E", lambda: D.cross_decode_attention_i8(*e_args),
         lambda: D.cross_reference_i8(*e_args), TOL[dtype], None,
         cross_work(e_args[0], n["S_cross"], 2 * n["Dh"] + 8, "bf16")),
        ("F", lambda: D.ancestry_decode_attention_i4(*f_args, layer),
         lambda: D.reference_i4(*f_args, layer), TOL_REQUANT[dtype], None,
         ancestry_work(f_args[0], f_args[3], f_args[6], n["Dh"] + 8, "int8")),
    ]


# ------------------------------------------------------------------ timing


def time_ms(fn, n=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ------------------------------------------------------------------ phases


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    from mm_s2ut_torch.ops import _build

    fresh = not _build.library_path().exists()
    _, secs = timed(_build.library)
    print(f"phase 1: kernels {'built' if fresh else 'loaded'} from csrc/ in {secs:.2f} s "
          f"({_build.library_path().name})")
    return smi


def phase_kernels():
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    record = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, kern, plain, tol, library, work in kernel_cases(dtype):
            result = check_and_time(name, dtype, kern, plain, tol, library)
            if dtype == torch.bfloat16:
                record[name] = {**result, **work}
        # A at the offline bench point's encoder call (phase 5): 128 x 10 s
        # -> 250 rows after subsampling, rate 0, no statistics.
        q, k, v, kpm = flash_inputs(128, 250, 8, 64, dtype, seed=128)
        bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
        res = check_and_time("A B=128 T=250", dtype, lambda: A.flash_attention(q, k, v, kpm),
                             lambda: A.reference_attention(q * 64 ** -0.5, k, v, bias),
                             TOL[dtype], lambda: sdpa(q, k, v, bias.to(dtype)))
        work = flash_work(128, 250, 250, 8, 64, dtype)
        print(f"phase 2: A B=128 T=250 {str(dtype)[6:]}: bound {work['bound_ms'] * 1e3:.2f} us "
              f"({work['bound_by']}), kernel / SDPA {res['ms'] / res['library_ms']:.3f}")
        del q, k, v, kpm, bias
        # B at the offline bench point's decode shape (phase 5's bf16 half).
        n = BENCH
        b_args = ancestry_inputs(n["B"], n["H"], n["K"], n["Dh"], n["L"], n["T_dec"], n["step"],
                                 dtype, seed=2)
        res = check_and_time("B B=128 step 150", dtype,
                             lambda: D.ancestry_decode_attention(*b_args, n["L"] // 2),
                             lambda: D.reference(*b_args, n["L"] // 2), TOL[dtype])
        work = ancestry_work(b_args[0], b_args[3], b_args[4], 2 * n["Dh"] * EB[dtype], "bf16")
        print(f"phase 2: B B=128 step 150 {str(dtype)[6:]}: bound {work['bound_ms'] * 1e3:.2f} us "
              f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
        del b_args
        # C at the bench point's decode shape (B=128, one split per (b, h))
        # beside SDPA, and D at the flagship's (B=8, split over blocks).
        c_args = cross_inputs(n["B"], n["H"], n["K"], n["Dh"], n["S_cross"], dtype, seed=3)
        c_mask = c_args[2][:, None, None, :].to(dtype)
        c_k, c_v = c_args[1][..., : n["Dh"]], c_args[1][..., n["Dh"] :]
        res = check_and_time("C B=128", dtype, lambda: D.cross_decode_attention(*c_args),
                             lambda: D.cross_reference(*c_args), TOL[dtype],
                             lambda: torch.nn.functional.scaled_dot_product_attention(
                                 c_args[0], c_k, c_v, attn_mask=c_mask, scale=1.0))
        work = cross_work(c_args[0], n["S_cross"], 2 * n["Dh"] * EB[dtype], "bf16")
        print(f"phase 2: C B=128 {str(dtype)[6:]}: bound {work['bound_ms'] * 1e3:.2f} us "
              f"({work['bound_by']}), kernel / SDPA {res['ms'] / res['library_ms']:.3f}, "
              f"kernel / bound {res['ms'] / work['bound_ms']:.2f}")
        del c_args, c_mask, c_k, c_v
        s = FLAGSHIP
        d_args = quant_ancestry_inputs(s["B"], s["H"], s["K"], s["Dh"], s["L"], s["T_dec"],
                                       s["step"], dtype, seed=4)
        res = check_and_time("D flagship step 300", dtype,
                             lambda: D.ancestry_decode_attention_i8(*d_args, s["L"] // 2),
                             lambda: D.reference_i8(*d_args, s["L"] // 2), TOL_REQUANT[dtype])
        work = ancestry_work(d_args[0], d_args[3], d_args[6], 2 * s["Dh"] + 8, "int8")
        print(f"phase 2: D flagship step 300 {str(dtype)[6:]}: bound "
              f"{work['bound_ms'] * 1e3:.2f} us ({work['bound_by']}), kernel / bound "
              f"{res['ms'] / work['bound_ms']:.2f}")
        del d_args
        torch.cuda.empty_cache()
    return record


def check_and_time(label, dtype, kern, plain, tol, library=None, scaled=False):
    """Hold a kernel against its plain version, then time both (plain,
    kernel, kernel, plain) and, when given, the PyTorch call computing the
    same function; prints one phase-2 line. A kernel with several outputs
    (H) is held output by output; ``scaled`` multiplies the tolerance by
    max(1, the largest |plain| of that output)."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = 0.0
    for x, y in pairs:
        assert torch.isfinite(x).all(), f"kernel {label} {dtype}: non-finite output"
        e = (x.float() - y.float()).abs().max().item()
        lim = tol * (max(1.0, y.float().abs().max().item()) if scaled else 1.0)
        assert e <= lim, f"kernel {label} {dtype}: max|err| {e} > {lim}"
        err = max(err, e)
    t = [time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)]
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    library_ms = time_ms(library) if library is not None else None
    lib = f", library {library_ms:.4f} ms" if library is not None else ""
    print(f"phase 2: kernel {label} {str(dtype)[6:]}: max|err| {err:.3e} "
          f"(tol {tol:g}{' x scale' if scaled else ''}), kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms{lib}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}


STREAM_ENCODE = [(1, 250), (8, 250), (1, 1000)]  # (B, T after subsampling): 10 s, 8 x 10 s, 40 s


def phase_causal_kernels():
    """A's causal branch and G at the causal encoder's shapes (H=8, D=64;
    lengths T, T-17, ... so B=8 has padded rows, with window 64 some whose
    whole band is padding), and C and E with the prefill's P = 501 query
    rows over S=250. Returns G's record at B=1, T=250, window 0, bf16."""
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    record = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, T in STREAM_ENCODE:
            q, k, v, kpm = flash_inputs(B, T, 8, 64, dtype, seed=T)
            bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None]
            for window in (0, 64):
                def plain():
                    return A.reference_attention(q * 64 ** -0.5, k, v, bias, True, window)

                a = check_and_time(f"A-causal B={B} T={T} window={window}", dtype,
                                   lambda: A.flash_attention(q, k, v, kpm, causal=True,
                                                             window=window), plain, TOL[dtype])
                mask = additive_mask(kpm, T, dtype, True, window)
                g = check_and_time(f"G B={B} T={T} window={window}", dtype,
                                   lambda: A.causal_skip_attention(q, k, v, kpm, window=window),
                                   plain, TOL[dtype], lambda: sdpa(q, k, v, mask))
                print(f"phase 2: G / A-causal at B={B} T={T} window={window} "
                      f"{str(dtype)[6:]}: {g['ms'] / a['ms']:.3f}")
                if (B, T, window, dtype) == (1, 250, 0, torch.bfloat16):
                    # window 0: query t attends keys 0..t
                    record["G"] = {**g, **flash_work(B, T, T, 8, 64, dtype,
                                                     pairs=B * 8 * T * (T + 1) // 2)}
        c_args = cross_inputs(1, 8, 501, 64, 250, dtype)
        check_and_time("C 501 rows S=250", dtype, lambda: D.cross_decode_attention(*c_args),
                       lambda: D.cross_reference(*c_args), TOL[dtype])
        e_args = quant_cross_inputs(1, 8, 501, 64, 250, dtype)
        check_and_time("E 501 rows S=250", dtype, lambda: D.cross_decode_attention_i8(*e_args),
                       lambda: D.cross_reference_i8(*e_args), TOL[dtype])
        torch.cuda.empty_cache()
    return record


TRAIN_ENCODE = [(8, 250), (2, 1000)]  # encoder rows of the train bench: 8 x 10 s, 2 x 40 s


def sdpa_backward(q, k, v, mask, g):
    """The SDPA backward alone (its graph kept between calls), and its
    forward + backward, on the same inputs as kernel H."""
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = sdpa(qq, kk, vv, mask)

    def fwd_bwd():
        return torch.autograd.grad(sdpa(qq, kk, vv, mask), (qq, kk, vv), g)

    return lambda: torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True), fwd_bwd


def phase_train_kernels():
    """A and G with attention dropout 0.1, and H, against their twins at
    the train bench's encoder shapes (H=8, D=64, lengths T, T-17, ...),
    non-causal and causal/window 64 (G), dropout 0 and 0.1 for H; the
    yardstick is SDPA with the same additive mask at dropout 0 (its
    dropout draws Philox bits, not the hash). Returns H's record at B=8,
    T=250, non-causal, dropout 0.1, bf16 (the flagship encoder's
    training backward).

    Tolerances scale with the largest |plain| output: with dropout a row
    of few keys puts out up to |v|/(1 − p) > 4, where one bf16 ulp is
    2^-5 > 2e-2 (and the bf16 twin divides by 1 − p rounded to bf16,
    0.8984); H's gradients grow with T. The fp32 comparison, 1e-4 times
    that scale, is what holds the dropout mask itself: one weight dropped
    on one side only moves an output by ~w·|v|/(1 − p) ≥ 1e-3 here."""
    from mm_s2ut_torch.ops import attention as A

    record = {}
    scale = 64 ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        for B, T in TRAIN_ENCODE:
            q, k, v, kpm = flash_inputs(B, T, 8, 64, dtype, seed=T + 3)
            g = _randn(q.shape, torch.Generator().manual_seed(T), dtype)
            bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
            for causal, window in ((False, 0), (True, 64)):
                mask = additive_mask(kpm, T, dtype, causal, window)
                block_k = 64 if causal else None
                check_and_time(
                    f"{'G' if causal else 'A'} dropout 0.1 B={B} T={T} window={window}", dtype,
                    lambda: A.flash_attention(q, k, v, kpm, causal=causal, window=window,
                                              dropout_rate=0.1, dropout_seed=DROP_SEED,
                                              block_k=block_k),
                    lambda: A.reference_attention(q * scale, k, v, bias[:, None, None, :], causal,
                                                  window, 0.1, DROP_SEED),
                    TOL[dtype], lambda: sdpa(q, k, v, mask), scaled=True)
                bwd_only, fwd_bwd = sdpa_backward(q, k, v, mask, g)
                for rate in (0.0, 0.1):
                    seed = DROP_SEED if rate else None
                    stats = torch.empty((2, B * 8, T), device="cuda")
                    entry = "mm_flash_attention_causal_skip" if causal else "mm_flash_attention"
                    A._launch(entry, q, k, v, bias, scale, causal, window, rate, seed, stats)
                    res = check_and_time(
                        f"H B={B} T={T} window={window if causal else 'none'} dropout {rate}", dtype,
                        lambda: A.flash_attention_bwd(q, k, v, bias, stats, g, scale, causal, window,
                                                      rate, seed),
                        lambda: A.reference_attention_bwd(q, k, v, bias, g, scale, causal, window,
                                                          rate, seed),
                        TOL[dtype], bwd_only, scaled=True)
                    if (dtype, B, causal, rate) == (torch.bfloat16, 8, False, 0.1):
                        record["H"] = {**res, **bwd_work(B, T, 8, 64, dtype)}
                print(f"phase 2: SDPA forward + backward B={B} T={T} "
                      f"window={window if causal else 'none'} {str(dtype)[6:]}: "
                      f"{time_ms(fwd_bwd):.4f} ms")
            torch.cuda.empty_cache()
    return record


def small_config():
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    return ModelConfig(
        encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=2,
        encoder_attention_heads=4, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
        decoder_layers=2, decoder_attention_heads=4, conv_channels=32, vocab_size=1004,
        dtype="float32", multimodal=mm,
    )


def synthetic_batch(n, gen, min_s=1.0, max_s=4.0, sr=16000):
    """n wavs of min_s..max_s seconds (tones + noise) and n 577x768 image arrays."""
    lens = (torch.rand(n, generator=gen) * (max_s - min_s) * sr + min_s * sr).long()
    wav = torch.zeros(n, int(lens.max()))
    for i, m in enumerate(lens.tolist()):
        t = torch.arange(m) / sr
        f0 = 100 + 300 * torch.rand(1, generator=gen)
        wav[i, :m] = 0.3 * torch.sin(2 * torch.pi * f0 * t) + 0.05 * torch.randn(m, generator=gen)
    imgs = torch.randn(n, 577, 768, generator=gen)
    return wav, lens, imgs


def phase_small_parity():
    import copy

    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    cpu_model = init_random_(MMS2UTModel(small_config()), gen).eval()
    with torch.no_grad():  # sharper logits, so argmaxes are not near-ties
        cpu_model.decoder.final_norm.weight.mul_(8.0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    wav, lens, imgs = synthetic_batch(2, gen)
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool)

    # max_len_b 80 > 64: the search grows its cache (int4: re-packs it).
    for kv in ("bfloat16", "int8", "int4"):
        gcfg = GenerationConfig(beam=10, max_len_a=0.0, max_len_b=80, kv_cache_dtype=kv)

        def generate(model, dev):
            feats, flens = waveform_frontend(wav.to(dev), lens.to(dev), FbankConfig())
            return UnitGenerator(model, gcfg).generate(feats, flens, [imgs.to(dev)], [masks])

        on_cpu, on_card = generate(cpu_model, "cpu"), generate(gpu_model, "cuda")
        for b in range(2):
            card, cpu = on_card[b][0]["tokens"], on_cpu[b][0]["tokens"]
            if card != cpu:
                step = next((i for i, (x, y) in enumerate(zip(card, cpu)) if x != y),
                            min(len(card), len(cpu)))
                gaps = [logit_gap(m, wav[b : b + 1], lens[b : b + 1], imgs[b : b + 1], card, cpu,
                                  step, kv) for m in (gpu_model, cpu_model)]
                print(f"phase 3: {kv} cache, utt {b}: tokens differ from step {step}; logit of "
                      f"the card's token minus the CPU's there: card {gaps[0]:.6g}, CPU "
                      f"{gaps[1]:.6g}")
            assert card == cpu, f"{kv} cache, utt {b}: tokens differ"
        print(f"phase 3: small fp32 config, {kv} cache, card vs CPU through "
              f"UnitGenerator.generate: tokens equal (lengths "
              f"{[len(h[0]['tokens']) for h in on_card]}, scores "
              f"{[round(h[0]['score'], 4) for h in on_card]} vs "
              f"{[round(h[0]['score'], 4) for h in on_cpu]})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the runs below


@torch.no_grad()
def logit_gap(model, wav, lens, imgs, card, cpu, step, kv) -> float:
    """Decode the common prefix of two hypotheses as one beam and return
    logit[card's token] - logit[CPU's token] at the first differing step."""
    from mm_s2ut_torch.infer.beam_search import tile_state_for_beams
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

    dev = model.device
    feats, flens = waveform_frontend(wav.to(dev), lens.to(dev), FbankConfig())
    enc = model.encode(feats, flens, [imgs.to(dev)], [torch.zeros(imgs.shape[:2], dtype=torch.bool,
                                                                   device=dev)])
    state = tile_state_for_beams(model.decode_init(enc, step + 2, kv_dtype=kv), 1)
    for tok in [2] + card[:step]:  # BOS, then the shared prefix
        logits, state = model.decode_step(torch.tensor([[tok]], device=dev), state)
    pick = [card[step] if step < len(card) else 2, cpu[step] if step < len(cpu) else 2]
    return float(logits[0, pick[0]] - logits[0, pick[1]])


def flagship():
    """The flagship model (bf16, on the card) and its vocoder, with random
    weights from one seeded generator, and that generator."""
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel

    gen = torch.Generator().manual_seed(0)
    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    cfg = ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm)  # the flagship
    model = init_random_(MMS2UTModel(cfg), gen).to("cuda").eval()
    vocoder = init_random_(CodeHiFiGAN(HiFiGANConfig()), gen).to("cuda").eval()
    return model, vocoder, gen


def drive(generator, vocoder, wav, lens, imgs, masks):
    """The main path once: wav → fbank → encode + fusion → beam search →
    units → CodeHiFiGAN → wav. Returns (feats, frame lengths, hyps, unit
    lines, wavs, stage seconds)."""
    import numpy as np

    from mm_s2ut_torch.data.dictionary import UnitDictionary
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

    tgt_dict = UnitDictionary(1000)
    stages = {}
    (feats, flens), stages["fbank_s"] = timed(lambda: waveform_frontend(
        wav.cuda(), lens.cuda(), FbankConfig()))
    hyps, stages["encode_and_search_s"] = timed(lambda: generator.generate(
        feats, flens, [imgs.cuda()], [masks.cuda()]))
    unit_lines = [
        " ".join(str(u) for u in tgt_dict.ids_to_units(np.asarray(h[0]["tokens"])))
        for h in hyps
    ]
    vocoder.max_frames = 4 * max((len(l.split()) for l in unit_lines if l), default=1) + 8

    def vocode():
        wavs = []
        for line in unit_lines:
            units = [int(u) for u in line.split()]
            if not units:
                wavs.append(torch.zeros(1600))
                continue
            w, n = vocoder(torch.tensor([units], device="cuda"),
                           torch.tensor([len(units)], device="cuda"))
            wavs.append(w[0, : int(n[0])].float().cpu())
        return wavs

    wavs, stages["vocoder_s"] = timed(vocode)
    return feats, flens, hyps, unit_lines, wavs, stages


def counted(counters, fn):
    """Run ``fn`` with every counter set to 0 just before; (result, seconds,
    launches read just after)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    total = time.perf_counter() - t0
    return out, total, {k: c.launches for k, c in counters.items()}


def check_outputs(hyps, unit_lines, wavs, n, beam):
    """Right by the repo's own means: shapes, finiteness, ranges."""
    import numpy as np

    assert len(hyps) == n and all(len(h) == beam for h in hyps)
    assert all(np.isfinite(h[0]["score"]) for h in hyps)
    assert all(0 <= int(u) < 1000 for line in unit_lines for u in line.split())
    assert all(torch.isfinite(w).all() and w.abs().max() <= 1.0 and w.numel() > 0 for w in wavs)


def phase_main_path(model, vocoder, gen, out_dir: Path):
    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.data.dictionary import UnitDictionary
    from mm_s2ut_torch.infer.generator import UnitGenerator, format_generation_output
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D
    from mm_s2ut_torch.tools.host_cost import profile_decode_step

    n_params = sum(p.numel() for p in model.parameters())
    gcfg = GenerationConfig(beam=10, max_len_a=1.0, max_len_b=200)
    generator = UnitGenerator(model, gcfg, max_target_positions=model.cfg.max_target_positions)
    wav, lens, imgs = synthetic_batch(8, gen)
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool)
    out_dir.mkdir(parents=True, exist_ok=True)

    drive(generator, vocoder, wav[:2, :16000], torch.clamp(lens[:2], max=16000), imgs[:2],
          masks[:2])  # warm-up
    counters = {"A": A.flash_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention}
    (feats, flens, hyps, unit_lines, wavs, stages), total, launches = counted(
        counters, lambda: drive(generator, vocoder, wav, lens, imgs, masks))

    tgt_dict = UnitDictionary(1000)
    for i, (line, w) in enumerate(zip(unit_lines, wavs)):
        (out_dir / f"{i}.unit").write_text(line + "\n")
        write_wav(out_dir / f"{i}_pred.wav", w.numpy(), 16000)
    (out_dir / "generate-smoke.txt").write_text(
        "\n".join(format_generation_output(range(len(hyps)), hyps, tgt_dict)) + "\n")

    assert all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}"
    check_outputs(hyps, unit_lines, wavs, 8, gcfg.beam)
    with torch.no_grad():
        enc, stages["encode_only_s"] = timed(lambda: model.encode(
            feats, flens, [imgs.cuda()], [masks.cuda()]))
    assert torch.isfinite(enc["encoder_out"]).all()
    assert enc["encoder_out"].shape == (8, (feats.shape[1] - 1) // 2 // 2 + 1, 512)

    audio_s = float(lens.sum()) / 16000
    print(f"phase 4: flagship bf16 ({n_params / 1e6:.1f} M params), 8 utts ({audio_s:.2f} s audio), "
          f"unit lengths {[len(l.split()) for l in unit_lines]}")
    print(f"phase 4: launches {launches}; stages {json.dumps({k: round(v, 4) for k, v in stages.items()})}; "
          f"total {total:.3f} s; {8 / total:.3f} utt/s")
    prof = profile_decode_step(generator, feats, flens, [imgs.cuda()], [masks.cuda()], 200)
    print(f"phase 4: profiled decode step 200: {json.dumps(prof)}")
    assert prof["B_ms"] > 0 and prof["C_ms"] > 0, f"the profile names no B or C kernel: {prof}"
    return launches


def phase_bench_point(model, vocoder, gen):
    """bench.py's default operating point with the int8 cache, then the same
    batch with the bf16 cache."""
    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    n = 128
    wav, lens, imgs = synthetic_batch(n, gen, min_s=10.0, max_s=10.0)
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool)
    counters = {"A": A.flash_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention, "D": D.ancestry_decode_attention_i8,
                "E": D.cross_decode_attention_i8}
    launches = {}
    for kv in ("int8", "bfloat16"):
        gcfg = GenerationConfig(beam=10, max_len_a=0.0, max_len_b=200, kv_cache_dtype=kv)
        generator = UnitGenerator(model, gcfg, max_target_positions=model.cfg.max_target_positions)
        drive(generator, vocoder, wav[:2, :16000], torch.clamp(lens[:2], max=16000), imgs[:2],
              masks[:2])  # warm-up
        (_, _, hyps, unit_lines, wavs, stages), total, counts = counted(
            counters, lambda: drive(generator, vocoder, wav, lens, imgs, masks))
        check_outputs(hyps, unit_lines, wavs, n, gcfg.beam)
        need = "ADE" if kv == "int8" else "ABC"
        assert all(counts[k] > 0 for k in need), f"{kv}: a kernel of the path never launched: {counts}"
        if kv == "int8":
            launches = counts
        print(f"phase 5: bench point, {kv} cache, {n} x 10 s utts, beam 10, max_len 200: "
              f"unit lengths min {min(len(l.split()) for l in unit_lines)} max "
              f"{max(len(l.split()) for l in unit_lines)}; launches {counts}; stages "
              f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}; total {total:.3f} s; "
              f"{n / total:.3f} utt/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del hyps, wavs
        torch.cuda.empty_cache()
    return launches


def phase_int4(model, vocoder, gen):
    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.ops import decode_attention as D

    n = 8
    wav, lens, imgs = synthetic_batch(n, gen)
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool)
    gcfg = GenerationConfig(beam=10, max_len_a=0.0, max_len_b=200, kv_cache_dtype="int4")
    generator = UnitGenerator(model, gcfg, max_target_positions=model.cfg.max_target_positions)
    counters = {"E": D.cross_decode_attention_i8, "F": D.ancestry_decode_attention_i4}
    (_, _, hyps, unit_lines, wavs, stages), total, launches = counted(
        counters, lambda: drive(generator, vocoder, wav, lens, imgs, masks))
    check_outputs(hyps, unit_lines, wavs, n, gcfg.beam)
    assert all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}"
    print(f"phase 6: int4 cache, flagship bf16, {n} utts, beam 10, max_len 200: unit lengths "
          f"{[len(l.split()) for l in unit_lines]}; launches {launches}; stages "
          f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}; total {total:.3f} s; "
          f"{n / total:.3f} utt/s")
    return launches


def small_causal_config(window=0):
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig

    return ModelConfig(
        encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=2,
        encoder_attention_heads=4, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
        decoder_layers=2, decoder_attention_heads=4, conv_channels=32, vocab_size=1004,
        dtype="float32", encoder_causal_attention=True, encoder_attention_window=window,
        multimodal=MultimodalConfig(multimodal_attention_type=None),
    )


def stream(srv, feats, chunk):
    """Feed ``feats`` (1, T, F) in chunks; (commits per feed, final hypothesis)."""
    commits = [srv.feed(feats[:, s : s + chunk]) for s in range(0, feats.shape[1], chunk)]
    return commits, srv.finalize()


def phase_stream_parity():
    """Small fp32 causal configs on the card, TF32 off: streamed encoder rows
    against the offline causal encoder (G) and the CPU (windows 0 and 16);
    then finalize() against UnitGenerator.generate (window 0)."""
    import copy

    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.infer.streaming import StreamingEncoderSession, StreamingS2ST
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)
    T, CHUNK, MAXLEN = 300, 32, 60
    feats = torch.randn(1, T, 80, generator=gen)
    lens = torch.tensor([T])
    for window in (0, 16):
        cpu_model = init_random_(MMS2UTModel(small_causal_config(window)), gen).eval()
        with torch.no_grad():  # sharper logits, so argmaxes are not near-ties
            cpu_model.decoder.final_norm.weight.mul_(8.0)
        model = copy.deepcopy(cpu_model).to("cuda")
        before = A.causal_skip_attention.launches
        with torch.no_grad():
            off_cpu = cpu_model.encode(feats, lens)["encoder_out"]
            off = model.encode(feats.cuda(), lens.cuda())["encoder_out"]
        assert A.causal_skip_attention.launches == before + 2, "the offline encoder skipped G"
        sess = StreamingEncoderSession(model.encoder, batch=1, chunk_frames=CHUNK,
                                       max_frames=T + 4)
        _, (streamed, _) = stream(sess, feats.cuda(), CHUNK)
        err_stream = (streamed - off).abs().max().item()
        err_cpu = max((off.cpu() - off_cpu).abs().max().item(),
                      (streamed.cpu() - off_cpu).abs().max().item())
        print(f"phase 7: window {window}: streamed vs offline (G) encoder rows on the card "
              f"max|diff| {err_stream:.3e}, card vs CPU {err_cpu:.3e} (tol 1e-4)")
        assert streamed.shape == off.shape and err_stream <= 1e-4 and err_cpu <= 1e-4
        if window:
            continue
        for mode in ({}, {"prefix_reuse": True}, {"prefix_reuse": True, "kv_cache_dtype": "int8"}):
            gcfg = GenerationConfig(beam=5, max_len_a=0.0, max_len_b=MAXLEN,
                                    kv_cache_dtype=mode.get("kv_cache_dtype"))
            offline = UnitGenerator(model, gcfg).generate(feats, lens)[0][0]["tokens"]
            srv = StreamingS2ST(model, chunk_frames=CHUNK, max_frames=T + 4, beam=5,
                                max_len=MAXLEN, max_new_tokens=16, **mode)
            commits, final = stream(srv, feats.cuda(), CHUNK)
            committed = [u for c in commits for u in c]
            print(f"phase 7: {mode or 'full re-decode'}: final {len(final)} units, "
                  f"{len(committed)} committed before finalize; finalize == generate: "
                  f"{final == offline}")
            assert final == offline, "finalize differs from UnitGenerator.generate"
            assert final[: len(committed)] == committed, "committed units are not a prefix"
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the runs below


STREAM_TOL = 0.125
# Streamed against offline encoder rows, bf16, 12 layers: the streamed
# layers attend in plain PyTorch (bf16 weights before the V product), the
# offline ones through G (fp32 until its store), so each layer's attention
# output can differ by a bf16 rounding, and the difference rides the
# residual stream through 12 layers. bf16 keeps 8 significant bits; after
# the final LayerNorm an output of magnitude up to ~4 has an ulp of 2^-6,
# so 0.125 allows 8 such ulps, and a fault (a wrong mask, position or
# cache row) moves rows by O(1).


def phase_streaming():
    """The reference streaming bench's operating point at full width."""
    import numpy as np

    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig
    from mm_s2ut_torch.infer.streaming import StreamingS2ST
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    gen = torch.Generator().manual_seed(3)
    cfg = ModelConfig(vocab_size=1004, dtype="bfloat16", encoder_causal_attention=True,
                      encoder_attention_window=0,
                      multimodal=MultimodalConfig(multimodal_attention_type=None))
    model = init_random_(MMS2UTModel(cfg), gen).to("cuda").eval()
    n_params = sum(p.numel() for p in model.parameters())
    sr, shift, flen, chunk_ms = 16000, 160, 400, 320
    total = (10 * sr - flen) // shift + 1  # 998 frames of 10 s
    chunk = chunk_ms * sr // 1000 // shift  # 32
    max_len = min(500, cfg.max_target_positions - 1)
    srv = StreamingS2ST(model, chunk_frames=chunk, max_frames=total + 4, beam=10,
                        max_len=max_len, prefix_reuse=True, max_new_tokens=48)
    utts = torch.randn(4, 1, total, 80, generator=gen).cuda()

    def run(feats):
        srv.reset()
        lat = []
        for s in range(0, total, chunk):
            _, secs = timed(lambda: srv.feed(feats[:, s : s + chunk]))
            lat.append(secs * 1e3)
        n_committed = len(srv.committed)
        final, secs = timed(srv.finalize)
        return lat, secs * 1e3, final, n_committed

    run(utts[0])  # warm-up
    counters = {"G": A.causal_skip_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention}

    def measured():
        res = [run(utts[i]) for i in (1, 2, 3)]
        with torch.no_grad():  # one offline encode of the last utterance's frames
            off = model.encode(utts[3], torch.tensor([total], device="cuda"))["encoder_out"]
        return res, off

    (res, off), wall, launches = counted(counters, measured)
    streamed = torch.cat(srv.enc.outputs, dim=1)
    lat = np.asarray([x for r in res for x in r[0]])
    fin = [r[1] for r in res]
    ratios = [r[3] / max(1, len(r[2])) for r in res]
    for _, _, final, _ in res:
        assert final and len(final) <= max_len and all(4 <= u < 1004 for u in final)
    assert all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}"
    assert streamed.shape == off.shape and torch.isfinite(streamed).all()
    diff = (streamed.float() - off.float()).abs()
    print(f"phase 8: streaming, causal flagship bf16 ({n_params / 1e6:.1f} M params), "
          f"{chunk_ms} ms chunks of 10 s utts, beam 10, max_len {max_len}, 48 new tokens per "
          f"search, prefix reuse: {len(lat)} chunks over 3 utts; per-chunk ms p50 "
          f"{np.percentile(lat, 50):.3f} p95 {np.percentile(lat, 95):.3f} p99 "
          f"{np.percentile(lat, 99):.3f} max {lat.max():.3f}; finalize ms "
          f"{[round(f, 3) for f in fin]}; commit ratio {[round(r, 3) for r in ratios]}; final "
          f"lengths {[len(r[2]) for r in res]}; launches {launches}; total {wall:.3f} s")
    print(f"phase 8: streamed vs offline (G) encoder rows: max|diff| {diff.max().item():.4e}, "
          f"mean {diff.mean().item():.4e} (tol {STREAM_TOL})")
    assert diff.max().item() <= STREAM_TOL, "streamed encoder rows differ from offline"
    return launches


def fairseq_vocoder_state(vocoder):
    """The port's CodeHiFiGAN parameters under a fairseq CodeHiFiGANVocoder
    checkpoint's names (weight norm already folded), which
    ``load_fairseq_checkpoint`` maps back."""
    import re

    rules = [(r"^generator\.", ""), (r"^ups_(\d+)", r"ups.\1"),
             (r"^resblocks_(\d+)\.(convs[12])_(\d+)", r"resblocks.\1.\2.\3"),
             (r"^dur_predictor\.(conv[12])\.", r"dur_predictor.\1.0.")]
    out = {}
    for name, value in vocoder.state_dict().items():
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        out[name] = value.detach().cpu()
    return out


def phase_entry_points(out_dir: Path):
    """The slice's two entry points on the card, on an exported checkpoint
    (``config.yaml`` + ``params.npz``, as scripts/export_jax_params.py
    writes them; random weights of the small fp32 causal config) and a
    fairseq-layout vocoder at its default config: ``python -m
    mm_s2ut_torch.inference``, whose encoder runs G, and ``python -m
    mm_s2ut_torch.cli.stream`` (prefix reuse, streaming vocoder), each
    through its ``main``. TF32 off. Their .unit files are equal (finalize
    equals offline decoding), and the streamed wav equals one exact-length
    offline vocode of the final units within PCM16 quantization (2e-4)."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch import inference
    from mm_s2ut_torch.cli import stream as stream_cli
    from mm_s2ut_torch.config import Config, DataConfig, GenerationConfig
    from mm_s2ut_torch.convert import to_flax
    from mm_s2ut_torch.data.audio_io import get_waveform, write_wav
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(12)
    root = out_dir / "entry_points"
    (root / "model").mkdir(parents=True, exist_ok=True)
    model = init_random_(MMS2UTModel(small_causal_config()), gen)
    with torch.no_grad():  # sharper logits, so argmaxes are not near-ties
        model.decoder.final_norm.weight.mul_(8.0)
    cfg = Config(model=model.cfg, data=DataConfig(standardize_audio=False),
                 generation=GenerationConfig(beam=5, max_len_a=0.0, max_len_b=60,
                                             kv_cache_dtype=None))
    (root / "model" / "config.yaml").write_text(json.dumps(dataclasses.asdict(cfg)))  # JSON is YAML
    np.savez(root / "model" / "params.npz", **to_flax(model))
    vocoder = init_random_(CodeHiFiGAN(HiFiGANConfig()), gen).eval()
    torch.save(fairseq_vocoder_state(vocoder), root / "vocoder.pt")
    write_wav(root / "utt.wav", (0.3 * torch.randn(3 * 16000 + 731, generator=gen)).numpy(), 16000)

    args = ["--model_path", str(root / "model"), "--audio_path", str(root / "utt.wav"),
            "--vocoder_path", str(root / "vocoder.pt"), "--device", "cuda"]
    counters = {"G": A.causal_skip_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention}
    rc_off, off_s, off_launches = counted(
        counters, lambda: inference.main(args + ["--output_dir", str(root / "offline")]))
    rc_st, st_s, st_launches = counted(
        counters, lambda: stream_cli.main(args + ["--output_dir", str(root / "stream")]))
    assert rc_off == 0 and rc_st == 0
    assert off_launches["G"] == model.cfg.encoder_layers, f"offline: {off_launches}"
    assert st_launches["G"] == 0 and st_launches["B"] > 0 and st_launches["C"] > 0, st_launches
    units_off = (root / "offline" / "utt.unit").read_text().split()
    units = (root / "stream" / "utt.unit").read_text().split()
    assert units and units == units_off, "the stream CLI's units differ from the offline CLI's"

    vocoder = vocoder.to("cuda")
    u = torch.tensor([[int(x) for x in units]], device="cuda")
    vocoder.max_frames = int(vocoder.unit_durations(u).sum())
    want, n = vocoder(u)
    want = want[0, : int(n[0])].float().cpu().numpy()
    got, sr = get_waveform(str(root / "stream" / "utt_pred.wav"))
    assert sr == 16000 and got.shape == want.shape, (sr, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    print(f"phase 9: inference CLI on a causal checkpoint: {len(units_off)} units, launches "
          f"{off_launches}, {off_s:.3f} s; stream CLI (prefix reuse, streaming vocoder): same "
          f"units, launches {st_launches}, {st_s:.3f} s; streamed wav {got.size} samples, "
          f"max|diff| vs offline vocode {err:.3e} (tol 2e-4)")
    assert err <= 2e-4, "the streamed wav differs from the offline vocode"
    return off_launches


def train_batch(B, T, Tt, vocab=1004, img_tokens=577, seed=0):
    """A fixed training batch as ``bench.py``'s train bench makes one:
    random log-mels of T frames, full lengths, random prev tokens and
    targets, random 577x768 image features."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {
        "src_features": rng.randn(B, T, 80).astype(np.float32),
        "src_lengths": np.full((B,), T, np.int32),
        "prev_output_tokens": rng.randint(4, vocab, (B, Tt)).astype(np.int32),
        "target": rng.randint(4, vocab, (B, Tt)).astype(np.int32),
        "imgs_list": (rng.randn(B, img_tokens, 768).astype(np.float32),),
        "img_masks_list": (np.zeros((B, img_tokens), bool),),
    }


def phase_train_parity(out_dir: Path):
    """Three train steps of the small fp32 config with every dropout rate
    0, TF32 off, on the card and on the CPU from the same weights and
    batch: the losses within a relative 1e-5 at each step, the first
    step's gradients within a relative 1e-4 of each tensor's largest
    (floored at 1e-4, as the CPU test against JAX), and A and H launched
    once per encoder layer per step on the card."""
    import copy
    import dataclasses

    from mm_s2ut_torch.config import Config, TrainConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = small_config()
    mcfg = dataclasses.replace(
        mcfg, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        multimodal=dataclasses.replace(mcfg.multimodal, SA_image_dropout=0.0,
                                       SA_attention_dropout=0.0, modality_dropout=0.0))
    cfg = Config(model=mcfg, train=TrainConfig(lr=1e-3, warmup_updates=2,
                                               save_dir=str(out_dir / "train_parity")))
    model = init_random_(MMS2UTModel(mcfg), torch.Generator().manual_seed(10))
    batch = train_batch(2, 400, 24, img_tokens=50, seed=10)
    trainers = {dev: Trainer(cfg, copy.deepcopy(model), dev) for dev in ("cpu", "cuda")}
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    losses = {"cpu": [], "cuda": []}
    for step in range(3):
        for dev, trainer in trainers.items():
            m, _, counts = counted(counters, lambda: trainer.train_batch(batch))
            losses[dev].append(m["loss"])
            if dev == "cuda":
                assert counts == {"A": mcfg.encoder_layers, "H": mcfg.encoder_layers}, counts
        if step == 0:
            worst = 0.0
            for p_cpu, p_card in zip(trainers["cpu"].params, trainers["cuda"].params):
                if p_cpu.grad is None:  # a parameter the step does not reach
                    assert p_card.grad is None
                    continue
                want, got = p_cpu.grad, p_card.grad.cpu()
                rel = ((got - want).abs().max() / max(want.abs().max().item(), 1e-4)).item()
                worst = max(worst, rel)
            assert worst <= 1e-4, f"step-1 gradients differ: relative {worst}"
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"phase 10: small fp32 config, 3 train steps card vs CPU: losses card "
          f"{[round(x, 6) for x in losses['cuda']]} CPU {[round(x, 6) for x in losses['cpu']]} "
          f"(max relative diff {rel_loss:.2e}, tol 1e-5); step-1 gradients max relative diff "
          f"{worst:.2e} (tol 1e-4); A and H {mcfg.encoder_layers} launches each per step")
    assert rel_loss <= 1e-5, "card and CPU losses differ"
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the runs below


def phase_train_bench():
    """The reference's train bench point at full width (``bench.py:125-191``):
    B=8 x 1000 frames x 100 targets for 3 + 17 steps, then B=2 x 4000 x
    200 for 3 + 5. Returns H's launches over the timed B=8 steps."""
    import numpy as np

    from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig, TrainConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel, init_parameters_
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    mcfg = ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm)  # dropouts 0.1
    cfg = Config(model=mcfg, train=TrainConfig(update_freq=1, warmup_updates=10,
                                               label_smoothing=0.2))
    model = init_parameters_(MMS2UTModel(mcfg), torch.Generator().manual_seed(11))
    trainer = Trainer(cfg, model, "cuda")
    n_params = sum(p.numel() for p in trainer.params)
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    h_launches = 0
    for B, T, Tt, warm, timed_steps in ((8, 1000, 100, 3, 17), (2, 4000, 200, 3, 5)):
        batch = to_device(train_batch(B, T, Tt), torch.device("cuda"))
        torch.cuda.reset_peak_memory_stats()
        metrics = [trainer.train_batch(batch) for _ in range(warm)]
        torch.cuda.synchronize()

        def run():
            return [trainer.train_batch(batch) for _ in range(timed_steps)]

        (timed_m, secs), _, counts = counted(counters, lambda: timed(run))
        metrics += timed_m
        ms = secs * 1e3 / timed_steps
        per_step = {k: v / timed_steps for k, v in counts.items()}
        losses = [m["loss"] / m["ntokens"] for m in metrics]
        norms = [m["grad_norm"] for m in metrics]
        assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
        assert per_step == {"A": 12.0, "H": 12.0}, per_step
        print(f"phase 11: train bench, flagship bf16 ({n_params / 1e6:.1f} M params), B={B} "
              f"T_src={T} Tt={Tt}: {ms:.3f} ms per step over {timed_steps} steps "
              f"(CUDA-synchronised host clock, {warm} warm-up), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per step {per_step}")
        print(f"phase 11: B={B} loss per step {[round(x, 4) for x in losses]}; grad norm "
              f"{[round(x, 3) for x in norms]}; skipped {sum(m['skipped'] for m in metrics)}")
        if B == 8:
            h_launches = counts["H"]
            assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
            profile_step(trainer, batch, ms)
        del batch
        torch.cuda.empty_cache()
    return h_launches


def profile_step(trainer, batch, step_ms):
    """One train step under torch.profiler: device time by kernel (the
    profiler's kernel events only; its CPU ops repeat their kernels' time),
    the shares of A and H, the hash dropout's elementwise int64 passes, and
    the device-busy share of an unprofiled step of ``step_ms``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_batch(batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    aten_calls = sum(e.count for e in events if e.key.startswith("aten::"))

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    total = sum(dev_us(e) for e in kernels)
    if total <= 0:
        print("phase 11: profiled step: the profiler saw no device time (not measured)")
        return
    # A's kernels (flash_fwd_kernel_mma in bf16) and H's (attn_bwd_*_kernel_mma)
    a = sum(dev_us(e) for e in kernels if "flash_fwd_kernel" in e.key)
    h = sum(dev_us(e) for e in kernels if "attn_bwd" in e.key)
    assert a > 0 and h > 0, f"the profile names no A or H kernel: {[e.key for e in kernels]}"
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    print(f"phase 11: profiled B=8 step: {aten_calls} aten calls, {sum(e.count for e in kernels)} "
          f"kernel launches, device time {total / 1e3:.3f} "
          f"ms = {total / 1e3 / step_ms:.1%} of an unprofiled step; A {a / 1e3:.3f} ms "
          f"({a / total:.1%} of device time), H {h / 1e3:.3f} ms ({h / total:.1%}); top kernels "
          f"{[(e.key[:60], e.count, round(dev_us(e) / 1e3, 3)) for e in top]}")


def phase_train_entry(out_dir: Path):
    """``mm_s2ut_torch.cli.train.main`` on the default device (the card):
    a synthetic corpus of 8 wavs (1-2 s) with 10x768 image features per
    utterance, the small config in bf16 with the flagship's dropouts, 6
    steps with a checkpoint, ``--resume`` to step 8, then
    ``mm_s2ut_torch.inference`` decodes one wav from that save_dir."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch import inference
    from mm_s2ut_torch.cli import train as train_cli
    from mm_s2ut_torch.config import (Config, DataConfig, GenerationConfig, TrainConfig,
                                      save_yaml)
    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.ops import attention as A

    root = out_dir / "train_entry"
    (root / "img_feat").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(12)
    rows = []
    for i in range(8):
        n = 16000 + 2000 * i
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), 16000)
        units = " ".join(str(u) for u in rng.randint(0, 1000, 10 + i))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, units, 10 + i))
    write_manifest(root / "train.tsv", rows)
    write_manifest(root / "valid.tsv", rows[:4])
    for split in ("train", "valid"):
        np.save(root / "img_feat" / f"{split}.npy", rng.randn(8, 10, 768).astype(np.float32))
    np.save(root / "img1.npy", np.load(root / "img_feat" / "train.npy")[0])
    mcfg = dataclasses.replace(small_config(), dtype="bfloat16")
    mcfg.multimodal.image_feat_path = [str(root / "img_feat")]
    save = root / "ckpt"
    cfg = Config(model=mcfg,
                 data=DataConfig(data_root=str(root), audio_root=str(root), max_tokens=800,
                                 num_buckets=1),
                 train=TrainConfig(max_update=6, save_interval_updates=3, log_interval=1,
                                   warmup_updates=3, save_dir=str(save)),
                 generation=GenerationConfig(beam=2, max_len_a=0.0, max_len_b=10))
    save_yaml(cfg, root / "run.yaml")  # YAML reads JSON's 1e-07 as a string
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    rc, secs, launches = counted(counters, lambda: train_cli.main(["--config",
                                                                   str(root / "run.yaml")]))
    assert rc == 0 and all(v > 0 for v in launches.values()), launches
    for f in ("config.yaml", "params.npz", "optim.pt", "logs/metrics.csv"):
        assert (save / f).exists(), f
    assert torch.load(save / "optim.pt", weights_only=True)["step"] == 6
    rc, resume_s, _ = counted(counters, lambda: train_cli.main(
        ["--config", str(root / "run.yaml"), "--resume", "train.max_update=8"]))
    assert rc == 0 and torch.load(save / "optim.pt", weights_only=True)["step"] == 8
    assert inference.main(["--model_path", str(save), "--audio_path", str(root / "1.wav"),
                           "--image_path", str(root / "img1.npy"),
                           "--output_dir", str(root / "out")]) == 0
    # 8 steps on random targets may leave EOS the best first token: the
    # hypothesis can be empty, the files must be there.
    units = (root / "out" / "1.unit").read_text().split()
    assert all(0 <= int(u) < 1000 for u in units)
    assert "H-0" in (root / "out" / "generate-test.txt").read_text()
    print(f"phase 12: cli.train on the default device: 6 steps in {secs:.2f} s (launches "
          f"{launches}), --resume to step 8 in {resume_s:.2f} s; save_dir holds config.yaml, "
          f"params.npz, optim.pt, logs/metrics.csv; inference decoded {len(units)} units")


KERNELS = {  # name, source (of the bf16 instance the record times), the TPU kernel it replaces
    "A": ("flash_attention", "mm_s2ut_torch/csrc/flash_attention_mma.cu",
          "mm_s2ut/ops/attention.py:140"),
    "B": ("ancestry_decode_attention", "mm_s2ut_torch/csrc/decode_attention.cu",
          "mm_s2ut/ops/decode_attention.py:50"),
    "C": ("cross_decode_attention", "mm_s2ut_torch/csrc/decode_attention.cu",
          "mm_s2ut/ops/decode_attention.py:477"),
    "D": ("ancestry_decode_attention_i8", "mm_s2ut_torch/csrc/decode_attention_q.cu",
          "mm_s2ut/ops/decode_attention.py:109"),
    "E": ("cross_decode_attention_i8", "mm_s2ut_torch/csrc/decode_attention_q.cu",
          "mm_s2ut/ops/decode_attention.py:533"),
    "F": ("ancestry_decode_attention_i4", "mm_s2ut_torch/csrc/decode_attention_q.cu",
          "mm_s2ut/ops/decode_attention.py:291"),
    "G": ("causal_skip_attention", "mm_s2ut_torch/csrc/flash_attention_mma.cu",
          "mm_s2ut/ops/attention.py:194"),
    "H": ("flash_attention_bwd", "mm_s2ut_torch/csrc/flash_attention_bwd_mma.cu",
          "mm_s2ut/ops/attention.py:377"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(HERE / "smoke_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import mm_s2ut_torch  # fails outside a checkout of the repo

    pkg_root = Path(mm_s2ut_torch.__file__).resolve().parents[1]
    if pkg_root != HERE:
        print(f"chip_smoke: mm_s2ut_torch comes from {pkg_root}, not from {HERE}", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    phase_build()
    record = phase_kernels()
    record.update(phase_causal_kernels())
    record.update(phase_train_kernels())
    phase_small_parity()
    model, vocoder, gen = flagship()
    launches = phase_main_path(model, vocoder, gen, Path(args.out))
    bench = phase_bench_point(model, vocoder, gen)
    launches.update(D=bench["D"], E=bench["E"])
    launches["F"] = phase_int4(model, vocoder, gen)["F"]
    del model, vocoder
    torch.cuda.empty_cache()
    phase_stream_parity()
    launches["G"] = phase_streaming()["G"]
    phase_entry_points(Path(args.out))
    phase_train_parity(Path(args.out))
    launches["H"] = phase_train_bench()
    phase_train_entry(Path(args.out))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], **record[k]}
        for k, (name, src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
