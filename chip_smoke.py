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
   decode shape (B=128, step 150 of 201; C beside SDPA), and D, F and E
   at the flagship's (B=8, step 300 of 500; S=250); then A's
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
13. continuous-batching serving at full width, at
    ``benchmarks/bench_serving.py``'s point: the flagship bf16 with random
    weights (no image sources), ``ContinuousServer`` with 64 slots, beam
    10, a 256-step ring, 16-step chunks, 1024 encoder frames, the int8
    cache, admission waves of 8, budgets 0.2 x the source frames; requests
    of 205-1024 random fbank frames from ``np.random.RandomState(2)``; a
    warm call of 64 requests, then a timed call of 256 (every request
    answered once, each unit list within its budget, finite scores) with
    the launches of A, D and E counted over it: utt/s, decode steps, waves,
    chunks and the host phases; then one chunk of a third call traced by
    ``torch.profiler`` (the device's busy share, D's and E's shares);
14. the server on the small fp32 config of phase 3 (TF32 off), on the card
    and on the CPU, over a 32-step ring that wraps, with the bf16, int8 and
    int4 caches: tokens equal; on the card, tokens and scores (atol 1e-4)
    equal to the port's offline search (``UnitGenerator``) per utterance,
    and the kernels of each cache launched;
15. the flagship config branches: a small fp32 model with every decodable
    branch set (gelu, post-norm, an untied output, a speaker projection,
    no fusion gate, no image pre-norm) through ``UnitGenerator`` on the
    card and the CPU (tokens equal), and one ``n_frames_per_step = 2``
    train step card against CPU (losses within a relative 1e-4, A and H
    launched);
16. the enhanced path at full width: ``mm_xm_transformer`` at
    ``mm_xm_architecture_base`` (decoder 1024-d, FFN 4096, 12 layers, 16
    heads, vocab 1010) over wav2vec2-base (7 convs of 512, 12 x 768, 12
    heads, group norm, post-norm), the 3-layer stride-2 adaptor and
    selective fusion over 577x768 image features, bf16, random weights
    from a seeded ``torch.Generator``: 8 synthetic 2-10 s wavs, beam 10,
    max_len_a 1, max_len_b 200, with the bf16 then the int8 cache, the
    launches of A-E counted over both (the kernels line's ``xm_launches``;
    its ``launches`` stay those of the flagship paths), utt/s; one decode
    step profiled; one forward at wav2vec2-large-lv60's geometry (layer norms, conv bias,
    pre-norm, 24 x 1024, 16 heads) with A launched 24 times; then the
    bench point, 128 x 10 s, beam 10, max_len_b 200, int8 then bf16;
17. small fp32 configs card against CPU (TF32 off): XM and MMS2UTModel
    with the ``hubert`` and ``wav2vec2_multimodal`` encoders through
    ``UnitGenerator`` with the bf16, int8 and int4 caches, tokens equal;
    a raw-waveform ``ContinuousServer`` on the XM model over a 24-step ring
    that wraps: tokens equal to the card's offline search, scores atol 1e-4;
18. ``python -m mm_s2ut_torch.cli.generate`` on a synthetic S2T corpus
    (wavs, a SentencePiece model, the lang-tag dictionary, image features)
    and an exported small XM checkpoint, on the card and with ``--device
    cpu``: the same D- lines;
19. the image path (``phase_image_path``): the committed JPEG fixtures of
    ``tests/torch_images/`` decoded without Pillow (pixels equal to PIL's
    committed ones, and the decoder's images/s); ViT-B/16-384 from random
    timm weights saved with ``torch.save`` and read by
    ``load_timm_checkpoint``, 16 preprocessed images in fp32 and bf16
    (A launched 12 times per forward, images/s, card against CPU with
    TF32 off on two images); ViT-L/16-384, one forward (A 24 times);
    ``return_attn`` and ``attention_rollout``, and the CLIP tower at
    ``CLIPVisionConfig()``, card against CPU; the flagship with
    ``load_visual_extractor_type: vit_timm`` at 384² over 8 wavs and 8
    decoded images, beam 10, max_len_b 200, bf16 cache (utt/s, the
    launches of A, B and C, the ViT's share of the encode), and a small
    fp32 config with the extractor, tokens card = CPU per cache; then
    ``python -m mm_s2ut_torch.inference --image_path <fixture>.jpg
    --vit_checkpoint`` (``vit_tiny``) card = CPU, ``cli.extract_features``
    over JPEG and PNG images card against CPU, and ``cli.vit_rollout``.

Phase 2 also holds A at the image encoders' shape (B=16, 577 queries
over 584 keys, the last 7 padding, H=12 and 16, Dh=64), and the enhanced
path's shapes: A over wav2vec2 frames
(B=8, T=499, H=12 and 16, and B=128, H=12; the key padding of 2-10 s
utterances), B and D in the XM decoder (H=16, L=12, K=10, step 200 of
263), C and E over the adaptor's short slab (B=8, H=16, K=10, S=63 and
S=7), and B, C, D and E at phase 16's bench point (B=128, H=16, K=10,
L=12, step 150 of 201, S=63 of 10 s utterances). It also holds fp32 C over S = 4000 encoder positions (16 rows,
where the slab is split over S and merged, and 10 beams, where it is
not) against its plain version. It also holds, at the train bench's encoder shapes (B=8, T=250 and
B=2, T=1000, H=8, D=64, ragged key padding), A and G with attention
dropout 0.1 against their twins, and H (dq, dk, dv, dbias) against its
twin, non-causal and causal/window 64, dropout 0 and 0.1, each timed
beside PyTorch's ``scaled_dot_product_attention`` with the same additive
mask (forward for A and G; its backward alone, and forward + backward,
for H), which the port never calls.

The line before the last is the kernels' JSON record (with each
kernel's bound at its recorded shape: the larger of its bytes over
3.35 TB/s and its operations over the peak for its inputs' type; A's
``launches`` add phase 19's image path to the flagship paths'); the
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
# element), the kernel folds the f32 scales in after the products (bf16:
# sk into the fp32 scores, sv into each unnormalised weight before it is
# rounded to bf16).
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


def ancestry_work(q, kv, flat_rep, col_bytes, peak, packed=False):
    """B, D, F: q, k_new, v_new, flat_rep and the output, plus the cache
    columns on some beam's path in this run's ancestry (``col_bytes`` per
    column and head); 4·Dh operations per on-path column and beam.
    ``packed`` (F): live column j's K and V halves share every byte of
    packed row j mod P (P = ``kv.shape[3]``) with its partner j ± P, so the
    cache bytes are 2·Dh per distinct packed row touched plus 8 (its sk and
    sv) per live column, per head."""
    B, H, K, Dh = q.shape
    live = [torch.unique(f[f >= 0]) for f in flat_rep]
    cols = sum(int(c.numel()) for c in live)
    on_path = int((flat_rep >= 0).sum()) // K  # flat_rep repeats each step's index K times
    if packed:
        rows = sum(int(torch.unique(c % kv.shape[3]).numel()) for c in live)
        cache_bytes = H * (rows * 2 * Dh + cols * 8)
    else:
        cache_bytes = cols * H * col_bytes
    nbytes = 4 * q.numel() * q.element_size() + flat_rep.numel() * 4 + cache_bytes
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


def ancestry_inputs(B, H, K, Dh, L, T, step, dtype, seed=0, on_card=False):
    """q, k_new, v_new (B, H, K, Dh), a (B, L, H, T·K, 2·Dh) cache and the
    flat_rep of a random ancestry at ``step``. ``on_card``: drawn on the
    card from a seeded CUDA generator, the cache one layer at a time (a
    bench-sized cache is 12.6 GB in bf16)."""
    dev = "cuda" if on_card else "cpu"
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to("cuda", dtype)

    q = draw((B, H, K, Dh), Dh ** -0.5)
    k_new, v_new = (draw((B, H, K, Dh)) for _ in range(2))
    if on_card:
        kv = torch.empty((B, L, H, T * K, 2 * Dh), dtype=dtype, device="cuda")
        for layer in range(L):
            kv[:, layer] = draw((B, H, T * K, 2 * Dh))
    else:
        kv = draw((B, L, H, T * K, 2 * Dh))
    ancestry = torch.randint(0, K, (B, K, T), generator=g, device=dev)
    t_idx = torch.arange(T, device=dev)[None, None, :]
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
         ancestry_work(f_args[0], f_args[3], f_args[6], 0, "int8", packed=True)),
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
        # F at the flagship's int4 shape (B=8, step 300, split over blocks)
        # and E at B=8 (split over blocks), next to D.
        f_args = quant_ancestry_inputs(s["B"], s["H"], s["K"], s["Dh"], s["L"], s["T_dec"],
                                       s["step"], dtype, int4=True, seed=5)
        res = check_and_time("F flagship step 300", dtype,
                             lambda: D.ancestry_decode_attention_i4(*f_args, s["L"] // 2),
                             lambda: D.reference_i4(*f_args, s["L"] // 2), TOL_REQUANT[dtype])
        work = ancestry_work(f_args[0], f_args[3], f_args[6], 0, "int8", packed=True)
        print(f"phase 2: F flagship step 300 {str(dtype)[6:]}: bound "
              f"{work['bound_ms'] * 1e3:.2f} us ({work['bound_by']}), kernel / bound "
              f"{res['ms'] / work['bound_ms']:.2f}")
        del f_args
        e_args = quant_cross_inputs(s["B"], s["H"], s["K"], s["Dh"], s["S_cross"], dtype, seed=6)
        res = check_and_time("E B=8", dtype, lambda: D.cross_decode_attention_i8(*e_args),
                             lambda: D.cross_reference_i8(*e_args), TOL[dtype])
        work = cross_work(e_args[0], s["S_cross"], 2 * s["Dh"] + 8, "bf16")
        print(f"phase 2: E B=8 {str(dtype)[6:]}: bound {work['bound_ms'] * 1e3:.2f} us "
              f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
        del e_args
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


def phase_long_cross():
    """fp32 C over S = 4000 encoder positions (≈ 160 s of speech), B=2, H=8:
    16 rows, whose scores would pass a block's shared memory, and 10 beams;
    B·H = 16 is under a wave, so both split the slab over S (16 spans of
    250 keys) and merge in split order; each against the plain version
    and beside SDPA."""
    from mm_s2ut_torch.ops import _build
    from mm_s2ut_torch.ops import decode_attention as D

    for K in (16, 10):
        args = cross_inputs(2, 8, K, 64, 4000, torch.float32, seed=4000 + K)
        n_split = _build.library().mm_cross_decode_splits(_build.F32, 2, 8, K, 4000, 64)
        mask = args[2][:, None, None, :]
        k, v = args[1][..., :64], args[1][..., 64:]
        check_and_time(f"C fp32 S=4000 K={K} ({n_split} splits)", torch.float32,
                       lambda: D.cross_decode_attention(*args), lambda: D.cross_reference(*args),
                       TOL[torch.float32],
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           args[0], k, v, attn_mask=mask, scale=1.0))
        assert n_split == 16, f"K={K}: {n_split} splits"
        del args, mask, k, v


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


SERVE = dict(slots=64, beam_size=10, ring=256, chunk=16, enc_frames=1024, kv_cache_dtype="int8",
             admit_width=8, max_len_a=0.2, max_len_b=0)  # bench_serving.py's point


def serve_requests(n, seed, enc_frames):
    """``benchmarks/bench_serving.py``'s ``make_requests``: n requests of
    enc_frames/5 .. enc_frames random fbank frames."""
    import numpy as np

    from mm_s2ut_torch.infer.serving import Request

    r = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        src = int(r.randint(enc_frames // 5, enc_frames + 1))
        reqs.append(Request(uid=i, features=r.randn(src, 80).astype(np.float32), length=src))
    return reqs


def check_served(results, reqs, srv):
    """Every request answered exactly once, each unit list within its
    budget (EOS stripped: at most budget − 1 units), finite scores."""
    import math

    import numpy as np

    assert sorted(r.uid for r in results) == sorted(q.uid for q in reqs), "a request lost or doubled"
    budget = {q.uid: int(srv._budgets(np.asarray([min(q.length, srv.enc_frames)]))[0])
              for q in reqs}
    for r in results:
        assert len(r.tokens) <= budget[r.uid] - 1, f"uid {r.uid}: {len(r.tokens)} units, budget {budget[r.uid]}"
        assert all(0 <= t < srv.V and t != srv.eos for t in r.tokens)
        assert math.isfinite(r.score), f"uid {r.uid}: score {r.score}"


def serve_checking_a_wrapped_step(srv, reqs):
    """``srv.run(reqs)``, with the first decode step of the first chunk in
    which a slot's live window has wrapped (ring_base + local_step > ring:
    its oldest live ring step lies physically after its newest) checked:
    each layer's kernel D and E call there is held against its plain
    version on the same inputs (the live cache, its scales and the
    ``flat_rep`` that ``UnitDecoder.serve_step`` built; the admitted int8
    cross slabs), D to TOL_REQUANT and E to TOL, bf16, times max(1, the
    largest |plain|). Returns (results, what was checked)."""
    import mm_s2ut_torch.models.decoder as decoder_mod
    import mm_s2ut_torch.models.layers as layers_mod
    from mm_s2ut_torch.ops import decode_attention as D

    T, S, L = srv.ring, srv.K, srv.model.decoder.num_layers
    seen = {"armed": False, "D": [], "E": [], "slots": []}
    d_kernel, e_kernel = decoder_mod.ancestry_decode_attention_i8, layers_mod.cross_decode_attention_i8

    def held(name, got, want, tol):
        assert torch.isfinite(got).all(), f"kernel {name} on the wrapped ring: non-finite output"
        err = (got.float() - want.float()).abs().max().item()
        lim = tol * max(1.0, want.float().abs().max().item())
        assert err <= lim, f"kernel {name} on the wrapped ring: max|err| {err} > {lim}"
        seen[name].append((err, lim))

    def d_checked(q, k_new, v_new, kv, sk, sv, flat_rep, layer):
        out = d_kernel(q, k_new, v_new, kv, sk, sv, flat_rep, layer)
        if seen["armed"] and len(seen["D"]) < L:
            assert flat_rep.shape[-1] == T * S
            for b in seen["slots"]:  # live columns at both physical ends of the ring
                assert (flat_rep[b, :, :S] >= 0).any() and (flat_rep[b, :, -S:] >= 0).any()
            held("D", out, D.reference_i8(q, k_new, v_new, kv, sk, sv, flat_rep, layer),
                 TOL_REQUANT[torch.bfloat16])
        return out

    def e_checked(q, kv, sk, sv, bias):
        out = e_kernel(q, kv, sk, sv, bias)
        if seen["armed"] and len(seen["E"]) < L:
            held("E", out, D.cross_reference_i8(q, kv, sk, sv, bias), TOL[torch.bfloat16])
        return out

    inner = srv._decode_chunk

    def chunk(state):
        if not seen["D"]:
            wrapped = state["active"] & (state["ring_base"] + state["local_step"] > T)
            seen["slots"] = wrapped.nonzero().flatten().tolist()
            seen["armed"] = bool(seen["slots"])
            if seen["armed"]:
                b = seen["slots"][0]
                seen["at"] = {"g": state["g"], "slot": b, "ring_base": int(state["ring_base"][b]),
                              "local_step": int(state["local_step"][b]),
                              "wrapped_slots": len(seen["slots"])}
        try:
            return inner(state)
        finally:
            seen["armed"] = False

    srv._decode_chunk = chunk
    decoder_mod.ancestry_decode_attention_i8 = d_checked
    layers_mod.cross_decode_attention_i8 = e_checked
    try:
        results = srv.run(reqs)
    finally:
        del srv._decode_chunk
        decoder_mod.ancestry_decode_attention_i8 = d_kernel
        layers_mod.cross_decode_attention_i8 = e_kernel
    assert len(seen["D"]) == len(seen["E"]) == L, f"no wrapped step was checked: {seen}"
    worst = {k: max(seen[k], key=lambda e: e[0] / e[1]) for k in "DE"}
    return results, {"D_err": worst["D"], "E_err": worst["E"], **seen["at"]}


def phase_serving(smi: str):
    """Phase 13: ``ContinuousServer`` at bench_serving.py's point, full width."""
    from mm_s2ut_torch.infer.serving import ContinuousServer
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D
    from mm_s2ut_torch.tools.host_cost import profile_serving_chunk

    model, _, _ = flagship()
    srv = ContinuousServer(model, **SERVE)
    assert srv.device.type == "cuda"
    reqs = serve_requests(256, 2, SERVE["enc_frames"])
    warm, warm_s = timed(lambda: srv.run(reqs[:64]))
    check_served(warm, reqs[:64], srv)
    counters = {"A": A.flash_attention, "D": D.ancestry_decode_attention_i8,
                "E": D.cross_decode_attention_i8, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention}
    torch.cuda.synchronize()
    results, total, launches = counted(counters, lambda: srv.run(reqs))
    check_served(results, reqs, srv)
    assert all(launches[k] > 0 for k in "ADE"), f"a kernel of the path never launched: {launches}"
    assert launches["B"] == launches["C"] == 0, f"a bf16 kernel ran on the int8 path: {launches}"
    stats = dict(srv.stats)
    lengths = [len(r.tokens) for r in results]
    print(f"phase 13: serving, flagship bf16, {smi}: {len(reqs)} requests of "
          f"{min(q.length for q in reqs)}-{max(q.length for q in reqs)} frames, slots 64, beam 10, "
          f"ring 256, chunk 16, int8, admit 8: {len(results) / total:.3f} utt/s ({total:.3f} s; "
          f"warm call of 64: {warm_s:.3f} s); decode steps {stats['steps']}, waves "
          f"{stats['waves']}, chunks {stats['chunks']}; host phases s "
          f"{json.dumps({k: round(stats[k], 4) for k in ('stage_s', 'admit_s', 'decode_s', 'drain_s')})}; "
          f"units min {min(lengths)} mean {sum(lengths) / len(lengths):.1f} max {max(lengths)}; "
          f"launches {launches}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    checked, at = serve_checking_a_wrapped_step(srv, reqs)
    check_served(checked, reqs, srv)
    print(f"phase 13: first step with a wrapped window (g {at['g']}, {at['wrapped_slots']} "
          f"slots wrapped; slot {at['slot']}: ring_base {at['ring_base']}, local_step "
          f"{at['local_step']}), T·S {SERVE['ring'] * SERVE['beam_size']}, every layer against "
          f"the plain versions, the layer nearest its limit: D max|err| {at['D_err'][0]:.3e} "
          f"(limit {TOL_REQUANT[torch.bfloat16]:g} x scale = {at['D_err'][1]:.3e}), E max|err| "
          f"{at['E_err'][0]:.3e} (limit {TOL[torch.bfloat16]:g} x scale = {at['E_err'][1]:.3e})")
    prof = profile_serving_chunk(srv, reqs[:64], 10)
    print(f"phase 13: profiled chunk 10 of 64 requests: {json.dumps(prof)}")
    assert prof["D_ms"] > 0 and prof["E_ms"] > 0, f"the profile names no D or E kernel: {prof}"
    del model, srv
    torch.cuda.empty_cache()
    return launches


SMALL_SERVE = dict(slots=2, beam_size=5, ring=24, chunk=4, enc_frames=256, max_len_a=0.0,
                   max_len_b=20, img_shapes=((50, 768),))
# Phase 14's models (``serving_model``): c of the EOS row, and the caches.
SERVE_MODELS = {
    "running to the budget": (None, ("bfloat16", "int8", "int4")),
    "ending on EOS": (3.0, ("bfloat16", "int8", "int4")),
    "done early": (7.5, ("bfloat16", "int8", "int4")),
}


def serving_model(c):
    """Phase 3's random small model, eval mode, its final norm's gain x8
    (sharper logits, so argmaxes are not near-ties): its hypotheses run to
    the budget. With ``c``, EOS's logit rises over the decode steps.
    Dimension 38 of the sinusoidal positions is cos(0.168 (t + 2)): the EOS
    row (tied to the output, and BOS's input) gets c there and the final
    norm's gain there is negated, so at step 0 (BOS's c dominating the
    normed state) EOS is pushed down, and later it rises as the cosine
    falls through 0 near step 7. At c = 3 the best hypotheses end on EOS at
    14-15 units or run to the budget; at c = 7.5 every slot's beams finish
    by step ~12 and the search's improvability rule ends them before their
    budget."""
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel

    model = init_random_(MMS2UTModel(small_config()), torch.Generator().manual_seed(14)).eval()
    with torch.no_grad():
        model.decoder.final_norm.weight.mul_(8.0)
        if c is not None:
            model.decoder.final_norm.weight[38].neg_()
            model.decoder.embed.embed_tokens.weight[2, 38] = c
    return model


def small_serving_requests():
    """Six requests of 100-256 frames with one 50-token image source, two
    of them with a padded image tail."""
    import numpy as np

    from mm_s2ut_torch.infer.serving import Request

    rng = np.random.RandomState(14)
    img_t = SMALL_SERVE["img_shapes"][0][0]
    reqs = []
    for i in range(6):
        n = int(rng.randint(100, SMALL_SERVE["enc_frames"] + 1))
        mask = np.zeros(img_t, bool)
        mask[img_t - 7 * (i % 2):] = True
        reqs.append(Request(i, rng.randn(n, 80).astype(np.float32), n,
                            imgs=(rng.randn(img_t, 768).astype(np.float32),), img_masks=(mask,)))
    return reqs


def phase_small_serving():
    """Phase 14: the server on phase 3's small fp32 config, card and CPU,
    over a ring that wraps, for each model of SERVE_MODELS and its caches:
    the same tokens and the same schedule (decode steps) on both, and on
    the card the offline search's tokens and scores (atol 1e-4). The first
    model's hypotheses run to the budget; the second's end on EOS before
    it; with the third the improvability rule frees slots early, which are
    refilled. Every model runs every cache: the subsampler's convs take one
    row per call, so a two-row admission wave rounds each row as the
    one-utterance search does."""
    import copy
    import math

    import numpy as np

    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.infer.serving import ContinuousServer
    from mm_s2ut_torch.ops import decode_attention as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reqs = small_serving_requests()
    kw, ml = SMALL_SERVE, SMALL_SERVE["max_len_b"]
    frames = kw["enc_frames"]
    per_slot = math.ceil(len(reqs) / kw["slots"])
    # Decode steps when every request runs to its budget: ml + 1 steps
    # each, rounded up to whole chunks.
    full = per_slot * kw["chunk"] * math.ceil((ml + 1) / kw["chunk"])
    kernels = {"bfloat16": ("B", "C"), "int8": ("D", "E"), "int4": ("F", "E")}
    counters = {"B": D.ancestry_decode_attention, "C": D.cross_decode_attention,
                "D": D.ancestry_decode_attention_i8, "E": D.cross_decode_attention_i8,
                "F": D.ancestry_decode_attention_i4}
    for label, (c, caches) in SERVE_MODELS.items():
        cpu_model = serving_model(c)
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        for kv in caches:
            need = kernels[kv]
            runs, steps = {}, {}
            for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
                srv = ContinuousServer(model, kv_cache_dtype=kv, **kw)
                results, _, counts = counted(counters, lambda: srv.run(reqs))
                runs[dev] = {r.uid: r for r in results}
                steps[dev] = srv.stats["steps"]
            assert all(counts[k] > 0 for k in need), f"{kv}: a kernel of the path never launched: {counts}"
            assert steps["cuda"] == steps["cpu"], f"{label}, {kv}: schedules differ: {steps}"
            assert steps["cuda"] > kw["ring"], f"{label}, {kv}: the ring never wrapped"
            gen = UnitGenerator(gpu_model, GenerationConfig(beam=kw["beam_size"], max_len_a=0.0,
                                                            max_len_b=ml, kv_cache_dtype=kv))
            worst = 0.0
            for q in reqs:
                card, cpu = runs["cuda"][q.uid], runs["cpu"][q.uid]
                assert card.tokens == cpu.tokens, f"{label}, {kv}, uid {q.uid}: card and CPU tokens differ"
                feats = np.zeros((1, frames, 80), np.float32)
                feats[0, : q.length] = q.features
                off = gen.generate(feats, np.asarray([q.length]), [q.imgs[0][None]],
                                   [q.img_masks[0][None]])[0][0]
                assert card.tokens == off["tokens"], f"{label}, {kv}, uid {q.uid}: server and offline differ"
                worst = max(worst, abs(card.score - off["score"]))
            assert worst <= 1e-4, f"{label}, {kv}: server and offline scores differ by {worst}"
            lengths = [len(runs["cuda"][q.uid].tokens) for q in reqs]
            if c is not None:
                assert min(lengths) < ml - 1, f"{label}, {kv}: every hypothesis ran to its budget"
            if label == "done early":
                assert steps["cuda"] < full, f"{kv}: no slot finished before its budget ({full} steps)"
            print(f"phase 14: small fp32 config, {label}, {kv} cache, server over a "
                  f"{kw['ring']}-step ring: {steps['cuda']} steps on card and CPU ({full} if "
                  f"every request ran to its budget), {srv.stats['waves']} waves; card tokens "
                  f"equal the CPU's and the offline search's, scores max|diff| {worst:.2e} "
                  f"(tol 1e-4); unit lengths {lengths}; launches {counts}")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the runs below


def phase_config_branches(out_dir: Path):
    """Phase 15: every decodable config branch through UnitGenerator, and an
    n_frames_per_step = 2 train step, card against CPU."""
    import copy
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.config import Config, GenerationConfig, TrainConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = small_config()
    cfg = dataclasses.replace(
        base, activation_fn="gelu", encoder_normalize_before=False,
        decoder_normalize_before=False, share_decoder_input_output_embed=False,
        speaker_embed_dim=16, multimodal=dataclasses.replace(
            base.multimodal, use_selective_gate=False, image_pre_norm=False))
    cpu_model = init_random_(MMS2UTModel(cfg), torch.Generator().manual_seed(15)).eval()
    with torch.no_grad():  # sharper logits, so argmaxes are not near-ties
        cpu_model.decoder.output_proj.weight.mul_(8.0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    wav_gen = torch.Generator().manual_seed(15)
    feats = torch.randn(2, 300, 80, generator=wav_gen)
    flens = torch.tensor([300, 217])
    imgs = torch.randn(2, 50, 768, generator=wav_gen)
    masks = torch.zeros(2, 50, dtype=torch.bool)
    gcfg = GenerationConfig(beam=5, max_len_a=0.0, max_len_b=30)
    hyps = {dev: UnitGenerator(m, gcfg).generate(feats.to(dev), flens.to(dev), [imgs.to(dev)],
                                                  [masks.to(dev)])
            for dev, m in (("cpu", cpu_model), ("cuda", gpu_model))}
    for b in range(2):
        assert hyps["cuda"][b][0]["tokens"] == hyps["cpu"][b][0]["tokens"], f"utt {b}: tokens differ"
    print(f"phase 15: gelu, post-norm, untied output, speaker projection, no gate, no image "
          f"pre-norm: card tokens equal the CPU's (lengths "
          f"{[len(h[0]['tokens']) for h in hyps['cuda']]}, scores "
          f"{[round(h[0]['score'], 4) for h in hyps['cuda']]} vs "
          f"{[round(h[0]['score'], 4) for h in hyps['cpu']]})")

    mcfg = dataclasses.replace(
        base, n_frames_per_step=2, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        multimodal=dataclasses.replace(base.multimodal, SA_image_dropout=0.0,
                                       SA_attention_dropout=0.0, modality_dropout=0.0))
    tcfg = Config(model=mcfg, train=TrainConfig(lr=1e-3, warmup_updates=2,
                                                save_dir=str(out_dir / "train_n_frames")))
    model = init_random_(MMS2UTModel(mcfg), torch.Generator().manual_seed(16))
    batch = train_batch(2, 400, 12, img_tokens=50, seed=16)
    rng = np.random.RandomState(16)
    batch["prev_output_tokens"] = rng.randint(4, 1000 ** 2 + 4, (2, 12)).astype(np.int32)
    batch["target"] = rng.randint(4, 1004, (2, 2 * 11 + 1)).astype(np.int32)  # unpacked units
    metrics, trainers = {}, {}
    for dev in ("cpu", "cuda"):
        trainers[dev] = trainer = Trainer(tcfg, copy.deepcopy(model), dev)
        metrics[dev], _, counts = counted({"A": A.flash_attention, "H": A.flash_attention_bwd},
                                          lambda: trainer.train_batch(batch))
    assert counts == {"A": mcfg.encoder_layers, "H": mcfg.encoder_layers}, counts
    rel = {k: abs(metrics["cuda"][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
           for k in ("loss", "grad_norm")}
    # Gradients as phase 10 holds them: within 1e-4 of each tensor's
    # largest |g| (floored at 1e-4). The first Adam update is
    # rate * g / (|g| + eps), about rate * sign(g). Outside the band
    # |g| <= 1e-4 (and 1e-4 of the tensor's largest), no sign can flip
    # and |g| >= 1e4 * eps, so a gradient error of 1e-4 of the largest moves
    # an update by at most rate * eps * 1e-4 * largest / |g|^2 (5e-8 at a
    # largest of 1) and the updated parameters agree to 1e-6; inside the
    # band an element can move by up to 2 * rate.
    rate = trainers["cpu"].optimizer.schedule(0)
    g_worst = p_worst = band_worst = 0.0
    n_band = 0
    for p_cpu, p_card in zip(trainers["cpu"].params, trainers["cuda"].params):
        if p_cpu.grad is None:  # a parameter the step does not reach
            assert p_card.grad is None and torch.equal(p_card.detach().cpu(), p_cpu.detach())
            continue
        want, got = p_cpu.grad, p_card.grad.cpu()
        scale = max(want.abs().max().item(), 1e-4)
        g_worst = max(g_worst, ((got - want).abs().max() / scale).item())
        band = want.abs() <= max(1e-4 * scale, 1e-4)
        diff = (p_card.detach().cpu() - p_cpu.detach()).abs()
        p_worst = max(p_worst, diff[~band].max().item() if (~band).any() else 0.0)
        band_worst = max(band_worst, diff[band].max().item() if band.any() else 0.0)
        n_band += int(band.sum())
    print(f"phase 15: n_frames_per_step 2, one train step card vs CPU: loss (summed over "
          f"targets) card {metrics['cuda']['loss']:.6f} CPU {metrics['cpu']['loss']:.6f} "
          f"(relative diff {rel['loss']:.2e}, tol 1e-4), grad norm card "
          f"{metrics['cuda']['grad_norm']:.6f} CPU {metrics['cpu']['grad_norm']:.6f} (relative "
          f"diff {rel['grad_norm']:.2e}, tol 1e-4), gradients max relative diff {g_worst:.2e} "
          f"(tol 1e-4); updated parameters max|diff| {p_worst:.2e} (tol 1e-6), {n_band} elements "
          f"with |g| in the gradients' band max|diff| {band_worst:.2e} (tol 2 x rate "
          f"{2 * rate:.1e}); launches {counts}")
    assert rel["loss"] <= 1e-4, "card and CPU losses differ"
    assert rel["grad_norm"] <= 1e-4, "card and CPU gradient norms differ"
    assert g_worst <= 1e-4, f"card and CPU gradients differ: relative {g_worst}"
    assert p_worst <= 1e-6, f"card and CPU updated parameters differ by {p_worst}"
    assert band_worst <= 2 * rate + 1e-6, f"an update in the band moved by {band_worst}"
    torch.backends.cudnn.allow_tf32 = True


# ------------------------------------------------------------------ the enhanced path

# The XM decoder's geometry (``mm_xm_architecture_base``): 16 heads of 64,
# 12 layers; a 10 s utterance's budget with max_len_a 1 is 63 + 200 steps.
XM = dict(B=8, H=16, Dh=64, K=10, L=12, T_dec=263, step=200)
# Phase 16's bench point in the XM decoder: 128 x 10 s (S = 63), beam 10,
# max_len_a 0, max_len_b 200, held at step 150 of 201.
XM_BENCH = dict(B=128, H=16, Dh=64, K=10, L=12, T_dec=201, step=150, S=63)


def xm_lengths(n, lo_s=2.0, hi_s=10.0):
    """Sample counts of n utterances spread over lo_s..hi_s seconds, their
    wav2vec2 frames (the conv lengths; 499 for 10 s) and their XM encoder
    positions after the 3-layer stride-2 adaptor (63 for 10 s)."""
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config

    samples = torch.linspace(lo_s * 16000, hi_s * 16000, n).long()
    frames = Wav2Vec2Config().feature_lengths(samples)
    positions = frames
    for _ in range(3):
        positions = (positions + 1) // 2
    return samples, frames, positions


def xm_bias(positions, S):
    """The (B, S) f32 cross-attention bias of those encoder lengths."""
    return torch.where(torch.arange(S)[None, :] < positions[:, None], 0.0, -1e9).cuda()


def phase_xm_kernels():
    """Phase 2's cases at the enhanced path's shapes: A over wav2vec2 frames
    (T=499, the key padding of 2-10 s utterances through the conv lengths;
    H=12 base, 16 large; and B=128 at H=12), B and D in the XM decoder
    (H=16, L=12, K=10, step 200 of 263), and C and E over the adaptor's
    short slab (S=63 for 10 s, S=7 for 1 s) at B=8, H=16, K=10."""
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    x = XM
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for B, H in ((8, 12), (8, 16), (128, 12)):
            _, frames, _ = xm_lengths(B)
            T = int(frames.max())
            g = torch.Generator().manual_seed(B + H)
            q, k, v = (_randn((B, T, H, 64), g, dtype) for _ in range(3))
            kpm = (torch.arange(T)[None, :] >= frames[:, None]).cuda()
            bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)[:, None, None, :]
            label = f"A wav2vec2 B={B} T={T} H={H}"
            res = check_and_time(label, dtype, lambda: A.flash_attention(q, k, v, kpm),
                                 lambda: A.reference_attention(q * 64 ** -0.5, k, v, bias),
                                 TOL[dtype], lambda: sdpa(q, k, v, bias.to(dtype)))
            work = flash_work(B, T, T, H, 64, dtype)
            print(f"phase 2: {label} {name}: bound {work['bound_ms'] * 1e3:.2f} us "
                  f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}, "
                  f"kernel / SDPA {res['ms'] / res['library_ms']:.3f}")
            del q, k, v, kpm, bias
        b_args = ancestry_inputs(x["B"], x["H"], x["K"], x["Dh"], x["L"], x["T_dec"], x["step"],
                                 dtype, seed=20)
        res = check_and_time("B XM step 200 of 263", dtype,
                             lambda: D.ancestry_decode_attention(*b_args, x["L"] // 2),
                             lambda: D.reference(*b_args, x["L"] // 2), TOL[dtype])
        work = ancestry_work(b_args[0], b_args[3], b_args[4], 2 * x["Dh"] * EB[dtype], "bf16")
        print(f"phase 2: B XM step 200 {name}: bound {work['bound_ms'] * 1e3:.2f} us "
              f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
        del b_args
        d_args = quant_ancestry_inputs(x["B"], x["H"], x["K"], x["Dh"], x["L"], x["T_dec"],
                                       x["step"], dtype, seed=21)
        res = check_and_time("D XM step 200 of 263", dtype,
                             lambda: D.ancestry_decode_attention_i8(*d_args, x["L"] - 1),
                             lambda: D.reference_i8(*d_args, x["L"] - 1), TOL_REQUANT[dtype])
        work = ancestry_work(d_args[0], d_args[3], d_args[6], 2 * x["Dh"] + 8, "int8")
        print(f"phase 2: D XM step 200 {name}: bound {work['bound_ms'] * 1e3:.2f} us "
              f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
        del d_args
        for S, seconds in ((63, (2.0, 10.0)), (7, (1.0, 1.0))):
            _, _, positions = xm_lengths(x["B"], *seconds)
            assert int(positions.max()) == S
            q, kv, _ = cross_inputs(x["B"], x["H"], x["K"], x["Dh"], S, dtype, seed=22 + S)
            c_args = (q, kv, xm_bias(positions, S))
            c_mask = c_args[2][:, None, None, :].to(dtype)
            res = check_and_time(f"C XM S={S}", dtype, lambda: D.cross_decode_attention(*c_args),
                                 lambda: D.cross_reference(*c_args), TOL[dtype],
                                 lambda: torch.nn.functional.scaled_dot_product_attention(
                                     q, kv[..., : x["Dh"]], kv[..., x["Dh"] :], attn_mask=c_mask,
                                     scale=1.0))
            work = cross_work(q, S, 2 * x["Dh"] * EB[dtype], "bf16")
            print(f"phase 2: C XM S={S} {name}: bound {work['bound_ms'] * 1e3:.2f} us "
                  f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
            e_args = quant_cross_inputs(x["B"], x["H"], x["K"], x["Dh"], S, dtype, seed=23 + S)
            e_args = (*e_args[:4], xm_bias(positions, S))
            res = check_and_time(f"E XM S={S}", dtype, lambda: D.cross_decode_attention_i8(*e_args),
                                 lambda: D.cross_reference_i8(*e_args), TOL[dtype])
            work = cross_work(e_args[0], S, 2 * x["Dh"] + 8, "bf16")
            print(f"phase 2: E XM S={S} {name}: bound {work['bound_ms'] * 1e3:.2f} us "
                  f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
            del q, kv, c_args, e_args
        torch.cuda.empty_cache()
        xm_bench_kernels(dtype)


def xm_bench_kernels(dtype):
    """B, C, D and E at phase 16's bench point (``XM_BENCH``): B·H = 2048,
    where the split rules take another route than at B=8 (D's two passes
    with no merge, B in one split), the last layer of the 12-layer cache
    and scales, and the 63-position slab of 10 s utterances."""
    from mm_s2ut_torch.ops import decode_attention as D

    x, name = XM_BENCH, str(dtype)[6:]
    layer = x["L"] - 1
    b_args = ancestry_inputs(x["B"], x["H"], x["K"], x["Dh"], x["L"], x["T_dec"], x["step"],
                             dtype, seed=30, on_card=True)
    res = check_and_time("B XM bench step 150 of 201", dtype,
                         lambda: D.ancestry_decode_attention(*b_args, layer),
                         lambda: D.reference(*b_args, layer), TOL[dtype])
    work = ancestry_work(b_args[0], b_args[3], b_args[4], 2 * x["Dh"] * EB[dtype], "bf16")
    print(f"phase 2: B XM bench step 150 {name}: bound {work['bound_ms'] * 1e3:.2f} us "
          f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
    del b_args
    torch.cuda.empty_cache()
    d_args = quant_ancestry_inputs(x["B"], x["H"], x["K"], x["Dh"], x["L"], x["T_dec"],
                                   x["step"], dtype, seed=31)
    res = check_and_time("D XM bench step 150 of 201", dtype,
                         lambda: D.ancestry_decode_attention_i8(*d_args, layer),
                         lambda: D.reference_i8(*d_args, layer), TOL_REQUANT[dtype])
    work = ancestry_work(d_args[0], d_args[3], d_args[6], 2 * x["Dh"] + 8, "int8")
    print(f"phase 2: D XM bench step 150 {name}: bound {work['bound_ms'] * 1e3:.2f} us "
          f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
    del d_args
    torch.cuda.empty_cache()
    _, _, positions = xm_lengths(x["B"], 10.0, 10.0)
    S = x["S"]
    assert int(positions.max()) == int(positions.min()) == S
    bias = xm_bias(positions, S)
    q, kv, _ = cross_inputs(x["B"], x["H"], x["K"], x["Dh"], S, dtype, seed=32)
    mask = bias[:, None, None, :].to(dtype)
    res = check_and_time("C XM bench S=63", dtype, lambda: D.cross_decode_attention(q, kv, bias),
                         lambda: D.cross_reference(q, kv, bias), TOL[dtype],
                         lambda: torch.nn.functional.scaled_dot_product_attention(
                             q, kv[..., : x["Dh"]], kv[..., x["Dh"] :], attn_mask=mask,
                             scale=1.0))
    work = cross_work(q, S, 2 * x["Dh"] * EB[dtype], "bf16")
    print(f"phase 2: C XM bench S=63 {name}: bound {work['bound_ms'] * 1e3:.2f} us "
          f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}, "
          f"kernel / SDPA {res['ms'] / res['library_ms']:.3f}")
    e_args = (*quant_cross_inputs(x["B"], x["H"], x["K"], x["Dh"], S, dtype, seed=33)[:4], bias)
    res = check_and_time("E XM bench S=63", dtype, lambda: D.cross_decode_attention_i8(*e_args),
                         lambda: D.cross_reference_i8(*e_args), TOL[dtype])
    work = cross_work(e_args[0], S, 2 * x["Dh"] + 8, "bf16")
    print(f"phase 2: E XM bench S=63 {name}: bound {work['bound_ms'] * 1e3:.2f} us "
          f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
    del q, kv, e_args
    torch.cuda.empty_cache()


def xm_config(w2v_args=None, dtype="bfloat16", small=False):
    """``mm_xm_transformer`` at ``mm_xm_architecture_base`` (1024-d, FFN
    4096, 12 layers, 16 heads; vocab 1010, the ModelConfig default) with
    selective fusion over 768-d image features and the wav2vec2 geometry
    of ``w2v_args`` (default: wav2vec2-base); ``small``: 64-d, 2 + 2 layers."""
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig
    from mm_s2ut_torch.models.mm_xm import mm_xm_architecture_base

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention")
    if small:
        return ModelConfig(decoder_embed_dim=64, decoder_ffn_embed_dim=128, decoder_layers=2,
                           decoder_attention_heads=4, dtype=dtype, multimodal=mm,
                           w2v_args=dict(SMALL_W2V, **(w2v_args or {})))
    return mm_xm_architecture_base(ModelConfig(dtype=dtype, multimodal=mm,
                                               w2v_args=w2v_args or {}))


# HF's wav2vec2-large-lv60 geometry (the conv stack as base's).
LARGE_W2V = dict(feat_extract_norm="layer", conv_bias=True, do_stable_layer_norm=True,
                 hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                 intermediate_size=4096)
# Phase 17's wav2vec2: base's conv strides (320 samples a frame), narrow.
SMALL_W2V = dict(conv_dim=[64] * 7, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128, num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4)


def xm_generate(generator, wav, lens, imgs, masks):
    """The enhanced path once: raw samples → wav2vec2 → adaptor → fusion →
    beam search. Returns the hypotheses."""
    return generator.generate(wav.cuda(), lens.cuda(), [imgs.cuda()], [masks.cuda()])


def check_xm_outputs(hyps, n, beam, vocab):
    import numpy as np

    assert len(hyps) == n and all(len(h) == beam for h in hyps)
    assert all(np.isfinite(x["score"]) for h in hyps for x in h)
    assert all(0 <= t < vocab for h in hyps for t in h[0]["tokens"])


def phase_xm_path(gen):
    """Phase 16: the enhanced path at full width (bf16, random weights),
    8 utterances with the bf16 then the int8 cache, a profiled decode
    step, one forward at wav2vec2-large's geometry, then the bench point."""
    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D
    from mm_s2ut_torch.tools.host_cost import profile_decode_step

    cfg = xm_config()
    model = init_random_(MMXMTransformerModel(cfg), gen).to("cuda").eval()
    n_params = sum(p.numel() for p in model.parameters())
    n_w2v = sum(p.numel() for p in model.wav2vec2.parameters())
    samples, frames, positions = xm_lengths(8)
    wav, _, imgs = synthetic_batch(8, gen, min_s=10.0, max_s=10.0)
    lens = samples
    for i, m in enumerate(lens.tolist()):
        wav[i, m:] = 0.0
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool)
    counters = {"A": A.flash_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention, "D": D.ancestry_decode_attention_i8,
                "E": D.cross_decode_attention_i8}
    gens = {kv: UnitGenerator(model, GenerationConfig(beam=10, max_len_a=1.0, max_len_b=200,
                                                      kv_cache_dtype=kv),
                              max_target_positions=cfg.max_target_positions)
            for kv in ("bfloat16", "int8")}
    for g in gens.values():  # warm-up
        xm_generate(g, wav[:2, :32000], torch.clamp(lens[:2], max=32000), imgs[:2], masks[:2])
    seconds = {}

    def run():
        out = {}
        for kv, g in gens.items():
            out[kv], seconds[kv] = timed(lambda: xm_generate(g, wav, lens, imgs, masks))
        return out

    hyps, total, launches = counted(counters, run)
    for kv in gens:
        check_xm_outputs(hyps[kv], 8, 10, cfg.vocab_size)
    assert launches["A"] == 2 * model.w2v_cfg.num_hidden_layers, launches  # an encode per cache
    assert all(launches[k] > 0 for k in "BCDE"), f"a kernel of the path never launched: {launches}"
    with torch.no_grad():
        enc, enc_s = timed(lambda: model.encode(wav.cuda(), lens.cuda(), [imgs.cuda()],
                                                [masks.cuda()]))
    assert torch.isfinite(enc["encoder_out"]).all()
    assert enc["encoder_out"].shape == (8, 63, cfg.decoder_embed_dim)
    assert (~enc["encoder_padding_mask"]).sum(1).cpu().tolist() == positions.tolist()
    audio_s = float(lens.sum()) / 16000
    print(f"phase 16: mm_xm_transformer bf16 ({n_params / 1e6:.1f} M params, wav2vec2-base "
          f"{n_w2v / 1e6:.1f} M), 8 utts of 2-10 s ({audio_s:.2f} s audio), wav2vec2 frames "
          f"{frames.tolist()}, encoder positions {positions.tolist()}, beam 10, max_len_a 1, "
          f"max_len_b 200: launches over both caches {launches}")
    for kv in gens:
        print(f"phase 16: {kv} cache: unit lengths {[len(h[0]['tokens']) for h in hyps[kv]]}; "
              f"{seconds[kv]:.3f} s; {8 / seconds[kv]:.3f} utt/s; encode alone {enc_s:.4f} s "
              f"({100 * enc_s / seconds[kv]:.1f}% of the run)")
    prof = profile_decode_step(gens["bfloat16"], wav.cuda(), lens.cuda(), [imgs.cuda()],
                               [masks.cuda()], 200)
    print(f"phase 16: profiled decode step 200 (bf16 cache): {json.dumps(prof)}")
    assert prof["B_ms"] > 0 and prof["C_ms"] > 0, f"the profile names no B or C kernel: {prof}"
    del model, gens, hyps, enc
    torch.cuda.empty_cache()

    large = init_random_(MMXMTransformerModel(xm_config(LARGE_W2V)), gen).to("cuda").eval()
    n_large = sum(p.numel() for p in large.wav2vec2.parameters())
    prev = torch.full((8, 6), 2, dtype=torch.long, device="cuda")
    with torch.no_grad():
        (out, large_s), _, counts = counted(
            {"A": A.flash_attention},
            lambda: timed(lambda: large(wav.cuda(), lens.cuda(), prev, [imgs.cuda()],
                                        [masks.cuda()])))
    assert counts["A"] == 24, counts
    assert torch.isfinite(out["logits"]).all() and torch.isfinite(out["encoder_out"]).all()
    assert out["logits"].shape == (8, 6, cfg.vocab_size) and out["encoder_out"].shape[1] == 63
    print(f"phase 16: wav2vec2-large-lv60 geometry ({n_large / 1e6:.1f} M params; layer norms, "
          f"conv bias, pre-norm, 24 x 1024, 16 heads): one forward of 8 utts, {large_s:.4f} s, "
          f"launches {counts}, logits and encoder states finite")
    del large, out
    torch.cuda.empty_cache()

    model = init_random_(MMXMTransformerModel(cfg), gen).to("cuda").eval()
    n = 128
    wav, lens, imgs = synthetic_batch(n, gen, min_s=10.0, max_s=10.0)
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool)
    for kv in ("int8", "bfloat16"):
        gcfg = GenerationConfig(beam=10, max_len_a=0.0, max_len_b=200, kv_cache_dtype=kv)
        g = UnitGenerator(model, gcfg, max_target_positions=cfg.max_target_positions)
        xm_generate(g, wav[:2, :32000], torch.clamp(lens[:2], max=32000), imgs[:2], masks[:2])
        hyps, secs, counts = counted(counters, lambda: timed(
            lambda: xm_generate(g, wav, lens, imgs, masks))[0])
        check_xm_outputs(hyps, n, 10, cfg.vocab_size)
        need = "ADE" if kv == "int8" else "ABC"
        assert all(counts[k] > 0 for k in need), f"{kv}: a kernel of the path never launched"
        print(f"phase 16: bench point, {kv} cache, {n} x 10 s utts, beam 10, max_len 200: unit "
              f"lengths min {min(len(h[0]['tokens']) for h in hyps)} max "
              f"{max(len(h[0]['tokens']) for h in hyps)}; launches {counts}; {secs:.3f} s; "
              f"{n / secs:.3f} utt/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del hyps
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return launches


def sharpened_(model, eos: int = 2):
    """Random weights made decodable: the final norm's gain x8, so argmaxes
    are not near-ties, and the (tied) embedding rows of EOS and the four
    specials x0.1, so their logits stay near 0 while the others spread
    over about ±20: hypotheses of real tokens that run to their budget,
    rather than EOS at step 0 or a run of <pad> (which cuts a hypothesis)."""
    with torch.no_grad():
        model.decoder.final_norm.weight.mul_(8.0)
        rows = model.decoder.embed.embed_tokens.weight
        rows[:4].mul_(0.1)
        rows[eos].mul_(0.1 if eos >= 4 else 1.0)
    return model


def small_xm_models():
    """Phase 17's small fp32 models (random weights, ``sharpened_``): XM,
    and MMS2UTModel with the hubert and the wav2vec2_multimodal encoders."""
    import dataclasses

    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel

    base = small_config()
    out = {"xm": MMXMTransformerModel(xm_config(dtype="float32", small=True))}
    for kind in ("hubert", "wav2vec2_multimodal"):
        cfg = dataclasses.replace(base, speech_encoder_type=kind, w2v_args=dict(SMALL_W2V))
        out[kind] = MMS2UTModel(cfg)
    for i, model in enumerate(out.values()):
        sharpened_(init_random_(model, torch.Generator().manual_seed(17 + i)).eval())
    return out


def phase_xm_small_parity():
    """Phase 17: the small fp32 models on the card against the CPU (TF32
    off) through UnitGenerator with each cache, tokens equal; then a
    raw-waveform ContinuousServer on the XM model over a ring that wraps,
    against the card's offline search per utterance."""
    import copy

    import numpy as np

    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.infer.serving import ContinuousServer, Request
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"A": A.flash_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention, "D": D.ancestry_decode_attention_i8,
                "E": D.cross_decode_attention_i8, "F": D.ancestry_decode_attention_i4}
    need = {"bfloat16": "ABC", "int8": "ADE", "int4": "AFE"}
    gen = torch.Generator().manual_seed(17)
    samples, _, _ = xm_lengths(2, 1.0, 3.0)
    wav = 0.3 * torch.randn(2, int(samples.max()), generator=gen)
    wav[0, int(samples[0]):] = 0.0
    imgs = torch.randn(2, 50, 768, generator=gen)
    masks = torch.zeros(2, 50, dtype=torch.bool)
    masks[1, 40:] = True
    models = small_xm_models()
    for kind, cpu_model in models.items():
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        for kv in ("bfloat16", "int8", "int4"):
            gcfg = GenerationConfig(beam=5, max_len_a=0.0, max_len_b=30, kv_cache_dtype=kv)
            on_cpu = UnitGenerator(cpu_model, gcfg).generate(wav, samples, [imgs], [masks])
            on_card, _, counts = counted(counters, lambda: UnitGenerator(gpu_model, gcfg).generate(
                wav.cuda(), samples.cuda(), [imgs.cuda()], [masks.cuda()]))
            assert all(counts[k] > 0 for k in need[kv]), f"{kind} {kv}: {counts}"
            for b in range(2):
                assert on_card[b][0]["tokens"], f"{kind}, {kv} cache, utt {b}: no tokens"
                assert on_card[b][0]["tokens"] == on_cpu[b][0]["tokens"], \
                    f"{kind}, {kv} cache, utt {b}: card and CPU tokens differ"
            print(f"phase 17: small fp32 {kind}, {kv} cache, card vs CPU through "
                  f"UnitGenerator: tokens equal (lengths "
                  f"{[len(h[0]['tokens']) for h in on_card]}, scores "
                  f"{[round(h[0]['score'], 4) for h in on_card]} vs "
                  f"{[round(h[0]['score'], 4) for h in on_cpu]}); launches {counts}")

    model = copy.deepcopy(models["xm"]).to("cuda")
    enc_samples, ml = 48000, 12
    rng = np.random.RandomState(17)
    reqs = []
    for i in range(6):
        n = int(rng.randint(8000, enc_samples + 1))
        mask = np.zeros(50, bool)
        mask[50 - 7 * (i % 2):] = True
        reqs.append(Request(i, (0.3 * rng.randn(n)).astype(np.float32), n,
                            imgs=(rng.randn(50, 768).astype(np.float32),), img_masks=(mask,)))
    for kv in ("bfloat16", "int8"):
        srv = ContinuousServer(model, slots=2, beam_size=5, ring=24, chunk=4,
                               enc_frames=enc_samples, enc_feat_dim=None, max_len_a=0.0,
                               max_len_b=ml, img_shapes=((50, 768),), kv_cache_dtype=kv)
        results, _, counts = counted(counters, lambda: srv.run(reqs))
        assert srv.stats["steps"] > srv.ring, "the ring never wrapped"
        assert all(counts[k] > 0 for k in need[kv]), counts
        got = {r.uid: r for r in results}
        g = UnitGenerator(model, GenerationConfig(beam=5, max_len_a=0.0, max_len_b=ml,
                                                  kv_cache_dtype=kv))
        worst = 0.0
        for q in reqs:
            w = np.zeros((1, enc_samples), np.float32)
            w[0, : q.length] = q.features
            off = g.generate(w, np.asarray([q.length]), [q.imgs[0][None]],
                             [q.img_masks[0][None]])[0][0]
            assert got[q.uid].tokens == off["tokens"], f"{kv}, uid {q.uid}: server and offline differ"
            worst = max(worst, abs(got[q.uid].score - off["score"]))
        assert worst <= 1e-4, f"{kv}: server and offline scores differ by {worst}"
        print(f"phase 17: raw-waveform ContinuousServer on the small XM, {kv} cache, "
              f"{len(reqs)} requests of {min(q.length for q in reqs)}-"
              f"{max(q.length for q in reqs)} samples over a 24-step ring: {srv.stats['steps']} "
              f"steps; tokens equal the card's offline search, scores max|diff| {worst:.2e} "
              f"(tol 1e-4); launches {counts}")
    torch.backends.cudnn.allow_tf32 = True


def phase_xm_entry(out_dir: Path):
    """Phase 18: ``python -m mm_s2ut_torch.cli.generate`` on a synthetic S2T
    corpus (wavs, a SentencePiece model from ``build_model``, the lang-tag
    dictionary, image .npy features) and an exported small XM checkpoint
    (config.yaml + params.npz), on the card and with ``--device cpu``: the
    same D- lines."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.config import Config, DataConfig, GenerationConfig
    from mm_s2ut_torch.convert import to_flax
    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.data.sentencepiece import build_model
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel

    root = out_dir / "generate"
    (root / "model").mkdir(parents=True, exist_ok=True)
    (root / "img").mkdir(exist_ok=True)
    words = ["the", "a", "cat", "dog", "sat", "ran", "on", "mat", "in", "sun"]
    pieces = [("▁" + w, -1.0 - i / 10) for i, w in enumerate(words)]
    pieces += [(c, -6.0) for c in sorted(set("".join(words)))] + [("▁", -5.0)]
    (root / "spm.model").write_bytes(build_model(pieces))
    symbols = [p for p, _ in pieces] + ["<lang:de>"]
    (root / "dict.txt").write_text("".join(f"{s} 1\n" for s in symbols))
    rng = np.random.RandomState(18)
    rows = []
    for i in range(6):
        n = int(rng.randint(16000, 48000))
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), 16000)
        text = " ".join(rng.choice(words, 5))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, text, 5, tgt_lang="de"))
    write_manifest(root / "test.tsv", rows)
    np.save(root / "img" / "test.npy", rng.randn(len(rows), 50, 768).astype(np.float32))

    mcfg = xm_config(dtype="float32", small=True)
    mcfg.vocab_size = len(symbols) + 4
    mcfg.multimodal.image_feat_path = [str(root / "img")]
    data = DataConfig(data_root=str(root), audio_root=str(root), vocab_filename="dict.txt",
                      target_is_code=False, tgt_lang="<lang:de>", eos_token="<lang:de>",
                      prepend_bos_and_append_tgt_lang_tag=True, max_tokens=600, num_buckets=2,
                      bpe_tokenizer={"bpe": "sentencepiece",
                                     "sentencepiece_model": str(root / "spm.model")})
    cfg = Config(task="multimodal_speech_to_text", model=mcfg, data=data,
                 generation=GenerationConfig(beam=5, max_len_a=0.0, max_len_b=20))
    model = sharpened_(init_random_(MMXMTransformerModel(mcfg), torch.Generator().manual_seed(18)),
                       eos=len(symbols) + 3)  # the lang tag: generation starts and ends there
    (root / "model" / "config.yaml").write_text(json.dumps(dataclasses.asdict(cfg)))  # JSON is YAML
    np.savez(root / "model" / "params.npz", **to_flax(model))
    lines, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "mm_s2ut_torch.cli.generate", "--model_path",
                        str(root / "model"), "--gen-subset", "test", "--results-path",
                        str(root / dev), "--device", dev], cwd=HERE, check=True)
        secs[dev] = time.perf_counter() - t0
        lines[dev] = (root / dev / "generate-test.txt").read_text().splitlines()
    d_lines = {dev: [line for line in ls if line.startswith("D-")] for dev, ls in lines.items()}
    assert len(d_lines["cuda"]) == len(rows), d_lines["cuda"]
    assert all(line.split("\t")[2] for line in d_lines["cuda"]), "an empty hypothesis"
    toks = {dev: [line.split("\t")[2] for line in ls] for dev, ls in d_lines.items()}
    assert toks["cuda"] == toks["cpu"], "cli.generate's D- lines differ between card and CPU"
    assert not any("<lang:" in line for line in lines["cuda"])
    scores = [abs(float(a.split("\t")[1]) - float(b.split("\t")[1]))
              for a, b in zip(d_lines["cuda"], d_lines["cpu"])]
    print(f"phase 18: python -m mm_s2ut_torch.cli.generate on a {len(rows)}-utterance S2T corpus "
          f"(SentencePiece targets, <lang:de> framing, image features), exported small XM: "
          f"D- lines' text equal on the card ({secs['cuda']:.1f} s) and the CPU "
          f"({secs['cpu']:.1f} s), scores max|diff| {max(scores):.1e}; e.g. "
          f"{d_lines['cuda'][0]!r}")


# ------------------------------------------------------------- image path

VIT = dict(B=16, Tq=577, S=584, Dh=64)  # ViT-B/16 at 384²: 577 tokens, keys padded to 584
FIXTURES = HERE / "tests" / "torch_images"


def phase_vit_kernels():
    """Phase 2's cases at the image encoders' shape: kernel A with Tq = 577
    queries over S = 584 keys whose last 7 are padding (the ViT's keys
    padded to a multiple of 8), B=16, Dh=64, H=12 (ViT-B) and 16 (ViT-L),
    bf16 and fp32; q a strided view of one (B, T, 3, H, Dh) projection, as
    in the ViT; the bias built once, as the ViT builds it per forward.
    Each held against its plain version, timed beside SDPA with the same
    additive mask and its bound."""
    import torch.nn.functional as F

    from mm_s2ut_torch.ops import attention as A

    B, Tq, S, Dh = VIT["B"], VIT["Tq"], VIT["S"], VIT["Dh"]
    for dtype in (torch.bfloat16, torch.float32):
        for H in (12, 16):
            g = torch.Generator().manual_seed(H)
            qkv = _randn((B, Tq, 3, H, Dh), g, dtype)
            q = qkv[:, :, 0]
            k, v = (F.pad(qkv[:, :, i], (0, 0, 0, 0, 0, S - Tq)) for i in (1, 2))
            kpm = (torch.arange(S)[None, :] >= Tq).expand(B, S).cuda()
            key_bias = A.padding_bias(kpm, B, S, "cuda")
            bias = key_bias[:, None, None, :]
            label = f"A ViT B={B} Tq={Tq} S={S} H={H}"
            res = check_and_time(label, dtype, lambda: A.flash_attention_biased(q, k, v, key_bias),
                                 lambda: A.reference_attention(q * Dh ** -0.5, k, v, bias),
                                 TOL[dtype], lambda: sdpa(q, k, v, bias.to(dtype)))
            work = flash_work(B, Tq, S, H, Dh, dtype)
            print(f"phase 2: {label} {str(dtype)[6:]}: bound {work['bound_ms'] * 1e3:.2f} us "
                  f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}, "
                  f"kernel / SDPA {res['ms'] / res['library_ms']:.3f}")
            del qkv, q, k, v
        torch.cuda.empty_cache()


def timm_vit_state(cfg, gen):
    """A timm-layout ViT state dict for ``cfg`` (what ``load_timm_checkpoint``
    reads from a ``pytorch_model.bin``): matrices N(0, 1/fan_in), biases
    and the class token and positions N(0, 0.02²), LayerNorm gains 1."""
    import numpy as np

    D, M, P = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio), cfg.patch_size

    def w(*shape):
        return torch.randn(*shape, generator=gen) * int(np.prod(shape[1:])) ** -0.5

    def small(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    sd = {"cls_token": small(1, 1, D), "pos_embed": small(1, cfg.seq_len, D),
          "patch_embed.proj.weight": w(D, 3, P, P), "patch_embed.proj.bias": small(D),
          "norm.weight": torch.ones(D), "norm.bias": torch.zeros(D)}
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        sd.update({f"{b}.norm1.weight": torch.ones(D), f"{b}.norm1.bias": torch.zeros(D),
                   f"{b}.attn.qkv.weight": w(3 * D, D), f"{b}.attn.qkv.bias": small(3 * D),
                   f"{b}.attn.proj.weight": w(D, D), f"{b}.attn.proj.bias": small(D),
                   f"{b}.norm2.weight": torch.ones(D), f"{b}.norm2.bias": torch.zeros(D),
                   f"{b}.mlp.fc1.weight": w(M, D), f"{b}.mlp.fc1.bias": small(M),
                   f"{b}.mlp.fc2.weight": w(D, M), f"{b}.mlp.fc2.bias": small(D)})
    return sd


def fixture_images():
    """The committed JPEG fixtures, decoded on the host without Pillow and
    held to the PIL pixels committed beside them: [(name, pixels)]."""
    import numpy as np

    from mm_s2ut_torch.data.image_io import read_image

    out = []
    for path in sorted(FIXTURES.glob("*.jpg")):
        px = read_image(path)
        want = np.load(path.with_suffix(".npy"))
        assert px.shape == want.shape and (px == want).all(), f"{path.name}: decoded pixels differ"
        out.append((path.name, px))
    assert len(out) == 4, [n for n, _ in out]
    return out


def vit_pixels(images, n, size, mode="timm"):
    from mm_s2ut_torch.models.vit import preprocess_images

    return torch.from_numpy(preprocess_images([images[i % len(images)][1] for i in range(n)],
                                              size, mode=mode))


def loaded_vit(name, gen, path=None):
    """A VIT_VARIANTS model on the CPU in fp32, from random timm-layout
    weights: saved to ``path`` and read back by ``load_timm_checkpoint``,
    or without a path converted in memory."""
    from mm_s2ut_torch.convert import from_flax
    from mm_s2ut_torch.models.vit import (VIT_VARIANTS, VisionTransformer,
                                          convert_timm_state_dict, load_timm_checkpoint)

    cfg = VIT_VARIANTS[name]
    state = timm_vit_state(cfg, gen)
    if path is None:
        variables = convert_timm_state_dict({k: v.numpy() for k, v in state.items()}, cfg)
    else:
        torch.save(state, path)
        variables = load_timm_checkpoint(str(path), cfg)
    vit = VisionTransformer(cfg)
    vit.load_state_dict(from_flax(variables, vit))
    return vit.eval()


def phase_image_path(out_dir: Path):
    """Phase 19: the image encoders and the raw-image path at full width.
    (a) the fixtures decoded on the host (pixels equal to PIL's), with the
    decoder's images/s; (b) ViT-B/16-384 from a saved timm checkpoint over
    16 preprocessed images in bf16 and fp32, A launched 12 times per
    forward, images/s, card against CPU (TF32 off) on two images; (c)
    ViT-L/16-384, one forward, A 24 times; (d) ``return_attn`` and
    ``attention_rollout``, and the CLIP tower at its default width, card
    against CPU; (e) the flagship with ``vit_timm`` in its graph over 8
    wavs and 8 decoded images, beam 10, bf16 cache: utt/s, the launches
    of A, B, C and the ViT's share of the encode, and a small fp32 config
    with the extractor, tokens card = CPU; (f) the entry points on the
    card and the CPU. Returns the launches of (e)'s counted flagship run,
    the image path's own count; the per-forward counts of (b), (c) and
    (f) are asserted and printed only."""
    import copy

    import numpy as np

    from mm_s2ut_torch.config import GenerationConfig, ModelConfig, MultimodalConfig
    from mm_s2ut_torch.data.image_io import read_image
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.models.vit import (CLIPVisionConfig, CLIPVisionTransformer, ViTConfig,
                                          attention_rollout)
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = out_dir / "images"
    root.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(19)

    # (a) decoding on the host
    images, secs = timed(fixture_images)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        fixture_images()
    per = (time.perf_counter() - t0) / (reps * len(images))
    big = [n for n, px in images if px.shape[:2] == (375, 500)]
    t0 = time.perf_counter()
    for _ in range(reps):
        read_image(FIXTURES / big[0])
    big_s = (time.perf_counter() - t0) / reps
    px16, prep_s = timed(lambda: vit_pixels(images, 16, 384))
    print(f"phase 19a: {len(images)} fixture JPEGs decoded without Pillow, pixels equal to PIL's "
          f"({', '.join(f'{n} {px.shape[1]}x{px.shape[0]}' for n, px in images)}); host decode "
          f"{1 / per:.1f} images/s over the fixtures, {1 / big_s:.2f} images/s at 500x375 "
          f"({big[0]}, {(FIXTURES / big[0]).stat().st_size} B); timm preprocess of 16 to 384²: "
          f"{prep_s:.3f} s")

    # (b) ViT-B/16-384
    vit_cpu = loaded_vit("vit_base_patch16_384", gen, root / "vit_base.bin")
    (root / "vit_base.bin").unlink()
    cfg = vit_cpu.cfg
    with torch.no_grad():
        want = vit_cpu(px16[:2])[0]
    scale = max(1.0, want.abs().max().item())
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        vit = copy.deepcopy(vit_cpu).to("cuda", dtype)
        x = px16.cuda()
        with torch.no_grad():
            vit(x)  # warm-up at the timed shape
            A.flash_attention.launches = 0
            (feats, attns), secs = timed(lambda: vit(x))
            n_a = A.flash_attention.launches
            _, secs2 = timed(lambda: vit(x))
        assert attns is None and feats.shape == (16, 577, cfg.embed_dim), feats.shape
        assert n_a == cfg.depth, f"A launched {n_a} times in one ViT-B forward"
        assert torch.isfinite(feats).all()
        err = (feats[:2].float().cpu() - want).abs().max().item()
        assert err <= tol * scale, f"ViT-B {dtype}: card vs CPU max|err| {err} > {tol * scale}"
        print(f"phase 19b: ViT-B/16-384 {str(dtype)[6:]}, 16 images: features {tuple(feats.shape)}, "
              f"A launched {n_a} times, {16 / secs:.1f} / {16 / secs2:.1f} images/s (two calls), "
              f"card vs CPU on 2 images max|err| {err:.3e} (tol {tol:g} x {scale:.3f})")
        del vit, feats
    torch.cuda.empty_cache()

    # (c) ViT-L/16-384
    vit_l = loaded_vit("vit_large_patch16_384", gen).to("cuda", torch.bfloat16)
    with torch.no_grad():
        vit_l(px16.cuda())  # warm-up
        A.flash_attention.launches = 0
        (feats, _), secs = timed(lambda: vit_l(px16.cuda()))
        n_a = A.flash_attention.launches
    assert n_a == 24 and torch.isfinite(feats).all() and feats.shape == (16, 577, 1024)
    print(f"phase 19c: ViT-L/16-384 bf16, 16 images: features {tuple(feats.shape)} finite, A "
          f"launched {n_a} times, {16 / secs:.1f} images/s")
    del vit_l, feats
    torch.cuda.empty_cache()

    # (d) rollout and the CLIP tower
    vit = copy.deepcopy(vit_cpu).to("cuda")
    with torch.no_grad():
        _, att_card = vit(px16[:1].cuda(), return_attn=True)
        _, att_cpu = vit_cpu(px16[:1], return_attn=True)
    att_err = max((a.cpu() - b).abs().max().item() for a, b in zip(att_card, att_cpu))
    m_card = attention_rollout([a.cpu().numpy() for a in att_card])
    m_cpu = attention_rollout([a.numpy() for a in att_cpu])
    m_err = float(np.abs(m_card - m_cpu).max())
    assert att_err <= 1e-4 and m_err <= 1e-3, (att_err, m_err)
    clip_cfg = CLIPVisionConfig()
    clip_cpu = init_random_(CLIPVisionTransformer(clip_cfg), gen).eval()
    clip = copy.deepcopy(clip_cpu).to("cuda")
    px224 = vit_pixels(images, 2, 224, mode="vit_openai")
    with torch.no_grad():
        s_card, s_cpu = clip(px224.cuda()), clip_cpu(px224)
    assert len(s_card) == clip_cfg.depth + 1 and s_card[-1].shape == (2, 197, 768)
    c_err = max((a.cpu() - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(s_card, s_cpu))
    assert c_err <= 1e-4, f"CLIP card vs CPU {c_err}"
    print(f"phase 19d: ViT-B return_attn: 12 maps {tuple(att_card[0].shape)}, card vs CPU "
          f"max|err| {att_err:.3e}; rollout masks {m_card.shape} max|err| {m_err:.3e} (tol 1e-3); "
          f"CLIP tower at CLIPVisionConfig() (224², 768-d, 12 layers): {len(s_card)} states, "
          f"card vs CPU max relative err {c_err:.3e}")
    del vit, clip, att_card, s_card
    torch.cuda.empty_cache()

    # (e) the flagship with the in-graph extractor
    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5,
                          load_visual_extractor_type="vit_timm", image_input_size=384)
    model = init_random_(MMS2UTModel(ModelConfig(vocab_size=1004, dtype="bfloat16",
                                                 multimodal=mm), vit_cfg=ViTConfig()), gen)
    model.visual_extractor.load_state_dict(vit_cpu.state_dict())
    model = model.to("cuda", torch.bfloat16).eval()
    vocoder = init_random_(CodeHiFiGAN(HiFiGANConfig()), gen).to("cuda").eval()
    gcfg = GenerationConfig(beam=10, max_len_a=1.0, max_len_b=200)
    generator = UnitGenerator(model, gcfg, max_target_positions=model.cfg.max_target_positions)
    wav, lens, _ = synthetic_batch(8, gen)
    pixels = vit_pixels(images, 8, 384)
    masks = torch.zeros((8, 384), dtype=torch.bool)
    drive(generator, vocoder, wav[:2, :16000], torch.clamp(lens[:2], max=16000), pixels[:2],
          masks[:2])  # warm-up
    counters = {"A": A.flash_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention}
    (feats, flens, hyps, unit_lines, wavs, stages), total, launches = counted(
        counters, lambda: drive(generator, vocoder, wav, lens, pixels, masks))
    check_outputs(hyps, unit_lines, wavs, 8, gcfg.beam)
    assert launches["A"] == 24, f"A per encode: {launches}"  # 12 speech + 12 ViT
    assert launches["B"] > 0 and launches["C"] > 0, launches
    with torch.no_grad():
        enc, enc_s = timed(lambda: model.encode(feats, flens, [pixels.cuda()], [masks.cuda()]))
        _, vit_s = timed(lambda: model.visual_extractor(pixels.cuda().to(torch.bfloat16)))
    assert torch.isfinite(enc["encoder_out"]).all()
    print(f"phase 19e: flagship bf16 with vit_timm in its graph "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params), 8 utts + 8 "
          f"decoded 384² images, beam 10, max_len_b 200, bf16 cache: launches {launches}; "
          f"stages {json.dumps({k: round(v, 4) for k, v in stages.items()})}; total "
          f"{total:.3f} s; {8 / total:.3f} utt/s; encode {enc_s * 1e3:.1f} ms of which the ViT "
          f"{vit_s * 1e3:.1f} ms ({100 * vit_s / enc_s:.1f}%)")
    del model, vocoder, generator, enc
    torch.cuda.empty_cache()

    small = small_config()
    small.multimodal.image_feat_dim = [64]
    small.multimodal.load_visual_extractor_type = "vit_timm"
    small.multimodal.image_input_size = 48
    small_vit = ViTConfig(image_size=48, patch_size=16, embed_dim=64, depth=2, num_heads=4)
    cpu_model = init_random_(MMS2UTModel(small, vit_cfg=small_vit), gen).eval()
    with torch.no_grad():
        cpu_model.decoder.final_norm.weight.mul_(8.0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    wav, lens, _ = synthetic_batch(4, gen)
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

    feats, flens = waveform_frontend(wav, lens, FbankConfig())
    px48 = vit_pixels(images, 4, 48)
    m48 = torch.zeros((4, 48), dtype=torch.bool)
    toks = {}
    for kv in (None, "int8", "int4"):
        g_cfg = GenerationConfig(beam=5, max_len_a=0.0, max_len_b=30, kv_cache_dtype=kv)
        out = {}
        for dev, m in (("cpu", cpu_model), ("cuda", gpu_model)):
            A.flash_attention.launches = 0
            hyps = UnitGenerator(m, g_cfg).generate(feats, flens, [px48], [m48])
            out[dev] = [h[0]["tokens"] for h in hyps]
        assert A.flash_attention.launches == small.encoder_layers + small_vit.depth, kv
        assert out["cuda"] == out["cpu"], f"small fp32 with vit_timm, {kv}: card and CPU differ"
        toks[kv or "float"] = [len(t) for t in out["cuda"]]
    print(f"phase 19e: small fp32 config with vit_timm (48², 64-d, 2 blocks): tokens equal on "
          f"card and CPU for the float, int8 and int4 caches; unit lengths {toks}")

    # (f) the entry points
    image_entry_points(root, vit_cpu, gen, images)
    return launches


def image_entry_points(root: Path, vit_b, gen, images):
    """``python -m mm_s2ut_torch.inference --image_path <fixture>.jpg
    --vit_checkpoint`` on an exported small checkpoint (``image_feat_dim``
    192 → ``vit_tiny_patch16_384``) on the card and the CPU (units equal);
    ``cli.extract_features`` over a flickr30k layout of the fixture JPEGs
    and ``write_png`` PNGs (card against CPU within 1e-4 × the largest
    |feature|); ``cli.vit_rollout`` (its .npy and .png). Each through its
    ``main``; prints their launches of A."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch import inference
    from mm_s2ut_torch.cli import extract_features, vit_rollout
    from mm_s2ut_torch.config import Config, DataConfig, GenerationConfig
    from mm_s2ut_torch.convert import to_flax
    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.data.image_io import read_image, write_png
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A

    loaded_vit("vit_tiny_patch16_384", gen, root / "vit_tiny.bin")
    cfg = small_config()
    cfg.multimodal.image_feat_dim = [192]
    model = init_random_(MMS2UTModel(cfg), gen)
    with torch.no_grad():
        model.decoder.final_norm.weight.mul_(8.0)
    conf = Config(model=cfg, data=DataConfig(standardize_audio=False),
                  generation=GenerationConfig(beam=5, max_len_a=0.0, max_len_b=40))
    (root / "model").mkdir(exist_ok=True)
    (root / "model" / "config.yaml").write_text(json.dumps(dataclasses.asdict(conf)))
    np.savez(root / "model" / "params.npz", **to_flax(model))
    write_wav(root / "utt.wav", (0.3 * torch.randn(2 * 16000, generator=gen)).numpy(), 16000)
    image = FIXTURES / images[0][0]
    args = ["--model_path", str(root / "model"), "--audio_path", str(root / "utt.wav"),
            "--image_path", str(image), "--vit_checkpoint", str(root / "vit_tiny.bin")]
    A.flash_attention.launches = 0
    units = {}
    for dev in ("cuda", "cpu"):
        assert inference.main(args + ["--output_dir", str(root / dev), "--device", dev]) == 0
        units[dev] = (root / dev / "utt.unit").read_text().split()
    n_a = A.flash_attention.launches
    assert n_a == 12 + cfg.encoder_layers, f"inference with a raw image: A launched {n_a} times"
    assert units["cuda"] and units["cuda"] == units["cpu"], "raw-image units differ card vs CPU"

    flickr = root / "flickr30k"
    (flickr / "flickr30k-images").mkdir(parents=True, exist_ok=True)
    names = []
    for name, px in images:
        (flickr / "flickr30k-images" / name).write_bytes((FIXTURES / name).read_bytes())
        write_png(flickr / "flickr30k-images" / (name[:-4] + ".png"), px)
        names += [name, name[:-4] + ".png"]
    (flickr / "test_2016_flickr.txt").write_text("\n".join(names) + "\n")
    assert (read_image(flickr / "flickr30k-images" / names[1]) == images[0][1]).all()
    feats = {}
    for dev in ("cuda", "cpu"):
        A.flash_attention.launches = 0
        assert extract_features.main([
            "--flickr30k-root", str(flickr), "--splits", "test2016", "--model",
            "vit_tiny_patch16_384", "--checkpoint", str(root / "vit_tiny.bin"), "--batch-size",
            "3", "--output-dir", str(root / f"feats_{dev}"), "--device", dev]) == 0
        n_a += A.flash_attention.launches
        feats[dev] = np.load(root / f"feats_{dev}" / "test2016.npy")
    assert feats["cuda"].shape == (len(names), 577, 192)
    f_err = float(np.abs(feats["cuda"] - feats["cpu"]).max())
    f_tol = 1e-4 * max(1.0, float(np.abs(feats["cpu"]).max()))
    assert f_err <= f_tol, f"extract_features card vs CPU {f_err} > {f_tol}"
    assert vit_rollout.main(["--image", str(image), "--model", "vit_tiny_patch16_384",
                             "--checkpoint", str(root / "vit_tiny.bin"), "--output",
                             str(root / "rollout"), "--device", "cuda"]) == 0
    mask = np.load(root / "rollout.npy")
    overlay = read_image(root / "rollout.png")
    assert mask.shape == (24, 24) and np.isfinite(mask).all() and overlay.shape == images[0][1].shape
    print(f"phase 19f: inference --image_path {image.name} --vit_checkpoint (vit_tiny, "
          f"image_feat_dim 192): {len(units['cuda'])} units, equal on card and CPU; "
          f"extract_features over {len(names)} JPEG/PNG images: {feats['cuda'].shape}, card vs "
          f"CPU max|err| {f_err:.3e} (tol {f_tol:.2e}); vit_rollout: mask {mask.shape}, overlay "
          f"{overlay.shape[1]}x{overlay.shape[0]} PNG; A launched {n_a} times in all")


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
    smi = phase_build()
    record = phase_kernels()
    phase_xm_kernels()
    phase_vit_kernels()
    phase_long_cross()
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
    phase_serving(smi)
    phase_small_serving()
    phase_config_branches(Path(args.out))
    xm_launches = phase_xm_path(torch.Generator().manual_seed(16))
    phase_xm_small_parity()
    phase_xm_entry(Path(args.out))
    image_launches = phase_image_path(Path(args.out))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "xm_launches": xm_launches.get(k, 0),
         "image_launches": image_launches.get(k, 0), **record[k]}
        for k, (name, src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
