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
   fp32 (B and C with their bounds at the flagship shape), each timed
   beside its plain version with CUDA events, and A at
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
   search with prefix reuse; one warm-up and one measured utterance
   through ``StreamingS2ST``, per-chunk latency percentiles, finalize ms and
   commit ratio, then one offline encode of the same frames, with the
   launches of G, B and C counted over the measured utterance and that
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
    committed ones, and the decoder's images/s), and every fixture of
    ``tests/torch_images/formats/`` (progressive, arithmetic, lossless,
    CMYK/YCCK, h1v2 and 4:1:1 JPEG; Adam7, 16-bit and low-depth PNG; BMP,
    GIF, TIFF and WebP, lossless and lossy; BigTIFF, LZMA, ZSTD, CCITT and
    ThunderScan TIFFs, Pillow's F and I modes, 16-bit CMYK, an Orientation,
    JPEG-compressed CMYK and gray + alpha; the raster families; DDS in every
    layout ``data/dds.py`` reads; IM in each mode Pillow writes, MSP, SPIDER,
    BLP palettes, JPEG and DXT, ICNS) the same way, each one's host ms, with a 500x375
    progressive JPEG's and a 500x375 lossy WebP's images/s beside the
    baseline's and the host decode time per container; ViT-B/16-384 from random
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
    over JPEG and PNG images card against CPU, and ``cli.vit_rollout``;
    (g) ``cli.extract_features`` with ViT-B/16-384 under bf16 autocast
    over one BMP, GIF, TIFF and WebP fixture of each kind (a TIFF of each
    compression), one of each raster family, every DDS fixture and one IM,
    MSP, SPIDER, ICNS and two BLP (DXT5, JPEG) fixtures, then
    over their ``.npy`` twins (Pillow's pixels):
    features equal bit for bit, A launched 12 times per forward;
20. training the speech encoders and the enhanced path
    (``phase_train_speech_encoders``): (e) A with attention dropout 0.1
    and 0, and H after it, at B=8, T=499 over the padding of 2-10 s
    utterances, H=12 and 16, bf16 and fp32, against their plain versions,
    timed beside SDPA (its backward for H) with their bounds; (a) the XM
    train step at full width (``mm_xm_architecture_base`` over
    wav2vec2-base, LayerDrop 0.1, every dropout 0.1, bf16, Adam) on phase
    16's 8 waves of 2-10 s with 20-60 text tokens: 3 + 5 steps with
    ``gradient_checkpointing`` off, then on from the same weights (the
    step-1 loss equal), ms per step and its spread, peak memory, A and H
    per step (the layers LayerDrop keeps; A twice with checkpointing), one
    step profiled, then one step at wav2vec2-large-lv60's geometry; (b)
    the flagship with a ``hubert`` encoder at HuBERT-base's geometry, span
    masking, ``freezing_updates`` 2 (the encoder bit-unchanged by steps
    1-2, moved by step 3), B=8 x 10 s; (c) phase 11's point with
    ``ctc_weight`` 0.3 and a ctc and a transformer task on caller-built
    targets, with and without ``checkpoint_activations``, against phase
    11's plain step, and the CTC terms alone timed and profiled; (d)
    small fp32 configs card against CPU over three steps (losses,
    gradients, parameters): masking, LayerDrop, both checkpointings,
    freezing, CTC and multitask, then ``cli.train`` on a tiny S2T corpus
    with noise mixing on the card and with ``--device cpu``, the same
    metrics.csv;
21. training through the on-line visual extractor, data parallelism and
    validation-time inference (``phase_train_through_images``): (a) the
    flagship with ViT-B/16-384 in its graph (154.5 M params) trained at
    phase 11's point with 8 decoded fixture images at 384², bf16
    autocast, dropouts 0.1, Adam, 3 + 5 steps: ms per step and its
    spread, peak memory, A and H 24 times a step (12 speech, 12 ViT), one
    step profiled (busy share, A's and H's shares); then ViT-L/16-384 for
    one step; (b) small fp32 configs with the tiny timm ViT and a CLIP
    tower card against CPU over three steps at lr 1e-3 (``card_vs_cpu``,
    its control included), and the ResEncoder's batch statistics card
    against CPU; (c) ``cli.train`` under ``torch.distributed`` (NCCL,
    world size 1) against the plain run: params.npz equal, and each run's
    TensorBoard events file decoded here (every CRC) equal to its
    metrics.csv; (d)
    ``train.eval_inference`` at full width (a random CodeHiFiGAN in
    fairseq's format, 8 utterances, beam 10, the bf16 then the int8 cache:
    the MCD metrics and the validation's seconds), ``eval.asr`` on the
    vocoded wavs with a random wav2vec2-base CTC model written as an HF
    directory, ``eval.bleu`` on its transcripts, and the MCD metrics
    card against CPU on the small fp32 config;
22. the textless pipeline's tools (``phase_tools``): (a) ``cli.prep_data``
    over 16 utterances of 2-10 s (wav, FLAC and, where the host has
    libvorbis, Ogg): ``manifest``, ``quantize`` through a random
    HuBERT-base written as an HF directory with 1000 centroids fitted on
    the card (k-means++ and Lloyd) at layer 11, on the card (A in fp32)
    and on the CPU, the units equal but at near-ties; ``quantize`` with the
    reference's own k-means format (``tests/torch_kmeans/km100.bin``, a
    ``joblib.dump`` of an sklearn MiniBatchKMeans, read without joblib or
    sklearn) equal to its ``.npy`` twin's units, with the load's ms; the
    same encoder as a fairseq HuBERT through ``convert_checkpoint --kind
    hubert``; then
    ``prep-s2ut``; quantize's seconds of audio per second, A's and
    k-means' shares, ``kmeans_assign`` at 8192 x 1000 x 768; (b)
    ``convert_checkpoint --kind mm_s2ut`` on a full-width flagship saved by
    ``torch.save`` in fairseq's names with fairseq's extras: the loaded
    directory's logits equal the source model's bit for bit; (c) the
    logit ensemble: ``cli.generate --model_path a:b`` on two small XM
    checkpoints, bf16 and int8 caches, card = CPU; two full-width
    flagships over 8 utterances, beam 10, 100 units, bf16 then int8: ms
    per decode step of the pair against one model, launches per step;
    (d) ``cli.vocode --dur-prediction`` and ``vocode_bucketed`` against
    the fixed budget, with their ms; (e) ``cli.inference_all`` in units
    mode (the flagship, the vocoder of (d), a random wav2vec2-base CTC
    ASR) and text mode (a small XM), the references set to the clean
    run's output, then ``MM_PARITY_CANARY``: BLEU must collapse; (f) the
    native audio loader's batch against the Python decoder, bit for bit,
    with the ms of each;
23. the fusion types (``phase_fusion_types``): small configs card against
    CPU, each type at full width, one full-width train step per type;
24. kernels A, G and H on a tensor-parallel rank's heads
    (``phase_tp_kernels``): for model = 2 and 4 each rank's head slice,
    called with (h_total, h0), equals that slice of the whole layer's
    call bit for bit (output, dq, dk, dv) with attention dropout 0.1, and
    its plain version within TOL, at phase 11's train encoder (A, and G
    causal) and the ViT's training shape (A), bf16 and fp32, H after each;
25. pipeline parallelism on the one card (``phase_pipeline``): the
    flagship at phase 11's point with its encoder a GPipe of (S, M) =
    (2, 4) and (4, 8) over the in-process loopback: the pipelined
    forward equals the same layers run over the same microbatches bit
    for bit and the whole batch's within TOL, three steps in fp32 and in
    bf16 equal the plain step's (losses within 1e-5, the parameter change
    within phase 20d's ``UPDATE_TOL``), A and H launch 12·M times a step,
    and ms per step beside the plain step's;
26. the fp32 decode (``phase_fp32_decode``): phase 4's flagship weights
    and 8 wavs with ``model.dtype: float32`` and the default cache, which
    then holds fp32, beam 10, 210 units (``FP32_SEARCH``), CodeHiFiGAN after it, TF32
    off for PyTorch's own matmuls (restored after): unit lengths, stage
    seconds, utt/s, the launches of A, B and C (B and C 6 per decode
    step), one profiled decode step 200; then on 2 utterances the CPU's
    encoder output and the card search's 10 hypotheses, cut to 200 units, fed as
    fixed beam paths through ``UnitDecoder.step`` on the card and on the
    CPU: log-probs within 1e-4 at steps 1, 50, 100, 150 and 200;
    26b. the same model and wavs with ``kv_cache_dtype`` int8, then int4
    (``phase_fp32_quant_decode``): D (F) and E 6 launches per decode step,
    one profiled decode step 200 naming E's tensor-core kernel, and the
    teacher-forced card-vs-CPU check on the same paths, every E call of
    steps 1 and 200 (and, int8, of a 200-row prefill, 6 more E launches)
    held against its plain version at fp32 TOL, log-probs within
    2·L·``TOL_REQUANT`` (L decoder layers).

Phase 2 also holds A at the image encoders' shape (B=16, 577 queries
over 584 keys, the last 7 padding, H=12 and 16, Dh=64), H at the ViT's
training shape (B=8, the same Tq over S, H=12 and 16, bf16 and fp32,
beside SDPA's backward), and the enhanced
path's shapes: A over wav2vec2 frames
(B=8, T=499, H=12 and 16, and B=128, H=12; the key padding of 2-10 s
utterances), B and D in the XM decoder (H=16, L=12, K=10, step 200 of
263), C and E over the adaptor's short slab (B=8, H=16, K=10, S=63 and
S=7), and B, C, D and E at phase 16's bench point (B=128, H=16, K=10,
L=12, step 150 of 201, S=63 of 10 s utterances). It also holds fp32 C over
S = 4000 encoder positions (16 rows and 10 beams, the slab split over S
and merged) against its plain version. It also holds, at the train bench's encoder shapes (B=8, T=250 and
B=2, T=1000, H=8, D=64, ragged key padding), A and G with attention
dropout 0.1 against their twins, and H (dq, dk, dv, dbias) against its
twin, non-causal and causal/window 64, dropout 0 and 0.1, each timed
beside PyTorch's ``scaled_dot_product_attention`` with the same additive
mask (forward for A and G; its backward alone, and forward + backward,
for H), which the port never calls.

The line before the last is the kernels' JSON record (with each
kernel's bound at its recorded shape: the larger of its bytes over
3.35 TB/s and its operations over the peak for its inputs' type; A's
``launches`` add phase 19's image path to the flagship paths'; its
``pipe_launches`` are A's and H's over phase 25's pipelined steps (12·M
each a step), its ``train_launches`` A's and H's in phase 20a's first timed XM step,
its ``vit_train_launches`` those in phase 21a's first timed ViT-B step,
its ``tools_launches`` phase 22's: A in 22a's quantize on the card (fp32)
and 22c's full-width ensemble encodes (bf16), B-E in 22c's ensemble
decodes, both members counted; A's and H's ``fp32_*`` fields time their
fp32 instances, 3xTF32 on the tensor cores, at the ViT's shapes, H=12,
with their bounds at the TF32 peak; B-F's time theirs at phase 2's
record shapes, B and C 3xTF32 (bound at the TF32 peak), D and F D's s8
passes, E 2xTF32 (bound at the TF32 peak); every kernel's
``fp32_launches`` are its launches in phase 26's and 26b's fp32 decodes;
``bytes_ms`` and ``ops_ms`` are the two times whose larger is the bound);
the last line is ``{"ok": true, "device": {...}}``. Artifacts (.unit files,
generate-smoke.txt, wavs, the training runs) go to ``--out`` (default
``smoke_out/`` beside this file).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# fp32: fp32 A, B, C, G and H split every operand into two tf32 halves and
# take three tensor-core products (3xTF32, ~2^-21 of a product's scale
# where one TF32 pass keeps ~2^-11 and misses 1e-4;
# tests/test_torch_attention_tf32_numerics.py and
# tests/test_torch_decode_tf32_numerics.py emulate them against the JAX
# reference on the CPU and hold them to TOL); fp32 E takes the same
# products in two passes, not three (every int8 operand is exact in tf32,
# so hi(q).lo(k8) and hi(P).lo(v8) are 0: 3xTF32's bits, emulated there
# too), and fp32 D and F take D's integer passes.
# bf16: the plain versions round the softmax weights and every product to
# bf16 between the two contractions. bf16 A and H (tensor cores) round
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
PEAK = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}
EB = {torch.bfloat16: 2, torch.float32: 4}
MMA_PEAK = {torch.bfloat16: "bf16", torch.float32: "tf32"}  # A-C, E, G, H: the tensor cores' input type
DROP_SEED = 0x5EED


def bound(flops: float, nbytes: float, peak: str) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak for the inputs' type
    (both kept)."""
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / PEAK[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def flash_work(B, Tq, S, H, D, dtype, pairs=None):
    """A / G forward: q, k, v, the (B, S) bias and the output; 4·D
    operations per attended (query, key) pair (``pairs``, default all), at
    the tensor cores' peak for the kernel's input type (fp32 runs there as
    TF32, each product counted once)."""
    pairs = B * H * Tq * S if pairs is None else pairs
    return bound(4 * D * pairs, EB[dtype] * B * D * H * (2 * Tq + 2 * S) + 4 * B * S,
                 MMA_PEAK[dtype])


def bwd_work(B, Tq, S, H, D, dtype):
    """H: q, dO, O (Tq rows) and k, v (S rows), the row statistics and the
    bias in; dq (Tq rows), dk, dv (S rows) and dbias out; 10·D operations
    per (query, key) pair (the recomputed scores, dP, dV, dK and dQ), at
    ``flash_work``'s peak."""
    row = B * H * D * EB[dtype]
    return bound(10 * B * H * Tq * S * D, 4 * Tq * row + 4 * S * row + 8 * B * H * Tq + 8 * B * S,
                 MMA_PEAK[dtype])


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
    column and head) and the bias; 4·Dh operations per (row, column),
    counted once (fp32 E's two tf32 passes are the kernel's way, not the
    function's work)."""
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
         ancestry_work(b_args[0], b_args[3], b_args[4], 2 * s["Dh"] * eb, MMA_PEAK[dtype])),
        ("C", lambda: D.cross_decode_attention(*c_args),
         lambda: D.cross_reference(*c_args), TOL[dtype],
         lambda: torch.nn.functional.scaled_dot_product_attention(c_args[0], c_k, c_v,
                                                                  attn_mask=c_mask, scale=1.0),
         cross_work(c_args[0], s["S_cross"], 2 * s["Dh"] * eb, MMA_PEAK[dtype])),
        ("D", lambda: D.ancestry_decode_attention_i8(*d_args, layer),
         lambda: D.reference_i8(*d_args, layer), TOL_REQUANT[dtype], None,
         ancestry_work(d_args[0], d_args[3], d_args[6], 2 * n["Dh"] + 8, "int8")),
        ("E", lambda: D.cross_decode_attention_i8(*e_args),
         lambda: D.cross_reference_i8(*e_args), TOL[dtype], None,
         cross_work(e_args[0], n["S_cross"], 2 * n["Dh"] + 8, MMA_PEAK[dtype])),
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


def subphase(parts: dict, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``parts`` under its name."""
    start = time.perf_counter()
    out = fn(*args)
    parts[fn.__name__] = round(time.perf_counter() - start, 1)
    return out


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
            elif name != "A":  # fp32 A's fields are the ViT shape's (phase_vit_kernels)
                record[name].update(fp32_fields(result, work, FP32_SOURCES[name]))
            if name == "E":
                print(f"phase 2: E B=128 {str(dtype)[6:]}: bound {work['bound_ms'] * 1e3:.2f} us "
                      f"({work['bound_by']}; bytes {work['bytes_ms'] * 1e3:.2f}, operations "
                      f"{work['ops_ms'] * 1e3:.2f}), kernel / bound "
                      f"{result['ms'] / work['bound_ms']:.2f}")
            if name in "BC":
                print(f"phase 2: {name} flagship {str(dtype)[6:]}: bound "
                      f"{work['bound_ms'] * 1e3:.2f} us ({work['bound_by']}), kernel / bound "
                      f"{result['ms'] / work['bound_ms']:.2f}"
                      + (f", kernel / SDPA {result['ms'] / result['library_ms']:.3f}"
                         if library is not None else ""))
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
        work = ancestry_work(b_args[0], b_args[3], b_args[4], 2 * n["Dh"] * EB[dtype],
                             MMA_PEAK[dtype])
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
        work = cross_work(c_args[0], n["S_cross"], 2 * n["Dh"] * EB[dtype], MMA_PEAK[dtype])
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
        work = cross_work(e_args[0], s["S_cross"], 2 * s["Dh"] + 8, MMA_PEAK[dtype])
        print(f"phase 2: E B=8 {str(dtype)[6:]}: bound {work['bound_ms'] * 1e3:.2f} us "
              f"({work['bound_by']}; bytes {work['bytes_ms'] * 1e3:.2f}, operations "
              f"{work['ops_ms'] * 1e3:.2f}), kernel / bound {res['ms'] / work['bound_ms']:.2f}")
        del e_args
        torch.cuda.empty_cache()
    return record


def fp32_fields(res, work, src):
    """The kernels line's fp32 fields of a kernel from its check_and_time
    result and its bound."""
    return {"fp32_source": src, "fp32_max_abs_err": res["max_abs_err"], "fp32_ms": res["ms"],
            "fp32_plain_ms": res["plain_ms"], "fp32_library_ms": res["library_ms"],
            "fp32_bound_ms": work["bound_ms"], "fp32_bound_by": work["bound_by"]}


def check_and_time(label, dtype, kern, plain, tol, library=None, scaled=False, phase="phase 2"):
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
    print(f"{phase}: kernel {label} {str(dtype)[6:]}: max|err| {err:.3e} "
          f"(tol {tol:g}{' x scale' if scaled else ''}), kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms{lib}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}


def phase_long_cross():
    """fp32 C over S = 4000 encoder positions (≈ 160 s of speech), B=2, H=8,
    16 rows and 10 beams: B·H = 16 is under a wave, so both split the slab
    over S (16 spans of 16 tiles of 16 keys) and merge in split order;
    each against the plain version and beside SDPA."""
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
                        record["H"] = {**res, **bwd_work(B, T, T, 8, 64, dtype)}
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


def flagship(dtype: str = "bfloat16"):
    """The flagship model (bf16 unless ``dtype``, on the card) and its
    vocoder, with random weights from one seeded generator, and that
    generator (the same weights and state for either dtype)."""
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel

    gen = torch.Generator().manual_seed(0)
    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    cfg = ModelConfig(vocab_size=1004, dtype=dtype, multimodal=mm)  # the flagship
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
    utts = torch.randn(2, 1, total, 80, generator=gen).cuda()

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
        res = [run(utts[1])]
        with torch.no_grad():  # one offline encode of the measured utterance's frames
            off = model.encode(utts[1], torch.tensor([total], device="cuda"))["encoder_out"]
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
          f"search, prefix reuse: {len(lat)} chunks over 1 utt; per-chunk ms p50 "
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
    """A fixed training batch as ``bench.py``'s train bench makes one
    (``tools/pipe_step.train_batch``)."""
    from mm_s2ut_torch.tools.pipe_step import train_batch as batch

    return batch(B, T, Tt, vocab, img_tokens, seed)


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
    200 for 3 + 5. Returns H's launches over the timed B=8 steps and the
    B=8 ms per step."""
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
            h_launches, plain_ms = counts["H"], ms
            assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
            profile_step(trainer, batch, ms)
        del batch
        torch.cuda.empty_cache()
    return h_launches, plain_ms


def profile_step(trainer, batch, step_ms, label="phase 11"):
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
        print(f"{label}: profiled step: the profiler saw no device time (not measured)")
        return
    # A's kernels (flash_fwd_kernel_mma in bf16) and H's (attn_bwd_*_kernel_mma)
    a = sum(dev_us(e) for e in kernels if "flash_fwd_kernel" in e.key)
    h = sum(dev_us(e) for e in kernels if "attn_bwd" in e.key)
    assert a > 0 and h > 0, f"the profile names no A or H kernel: {[e.key for e in kernels]}"
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    print(f"{label}: profiled step: {aten_calls} aten calls, {sum(e.count for e in kernels)} "
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


def s2t_corpus(root: Path, splits, n: int, seed: int):
    """A synthetic S2T corpus in ``root``: n wavs of 1-3 s, a manifest per
    split with 5-word German transcripts, a SentencePiece model
    (``build_model``), the dictionary with ``<lang:de>``, and 50x768 image
    features per split. Returns (rows, the dictionary's symbols)."""
    import numpy as np

    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.data.sentencepiece import build_model

    (root / "img").mkdir(parents=True, exist_ok=True)
    words = ["the", "a", "cat", "dog", "sat", "ran", "on", "mat", "in", "sun"]
    pieces = [("▁" + w, -1.0 - i / 10) for i, w in enumerate(words)]
    pieces += [(c, -6.0) for c in sorted(set("".join(words)))] + [("▁", -5.0)]
    (root / "spm.model").write_bytes(build_model(pieces))
    symbols = [p for p, _ in pieces] + ["<lang:de>"]
    (root / "dict.txt").write_text("".join(f"{s} 1\n" for s in symbols))
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        m = int(rng.randint(16000, 48000))
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(m)).astype(np.float32), 16000)
        text = " ".join(rng.choice(words, 5))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", m, text, 5, tgt_lang="de"))
    for split in splits:
        write_manifest(root / f"{split}.tsv", rows)
        np.save(root / "img" / f"{split}.npy", rng.randn(n, 50, 768).astype(np.float32))
    return rows, symbols


def s2t_data_config(root: Path, **kw):
    from mm_s2ut_torch.config import DataConfig

    return DataConfig(data_root=str(root), audio_root=str(root), vocab_filename="dict.txt",
                      target_is_code=False, tgt_lang="<lang:de>", eos_token="<lang:de>",
                      prepend_bos_and_append_tgt_lang_tag=True, max_tokens=600, num_buckets=2,
                      bpe_tokenizer={"bpe": "sentencepiece",
                                     "sentencepiece_model": str(root / "spm.model")}, **kw)


def phase_xm_entry(out_dir: Path):
    """Phase 18: ``python -m mm_s2ut_torch.cli.generate`` on a synthetic S2T
    corpus (wavs, a SentencePiece model from ``build_model``, the lang-tag
    dictionary, image .npy features) and an exported small XM checkpoint
    (config.yaml + params.npz), on the card and with ``--device cpu``: the
    same D- lines."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.config import Config, GenerationConfig
    from mm_s2ut_torch.convert import to_flax
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel

    root = out_dir / "generate"
    (root / "model").mkdir(parents=True, exist_ok=True)
    rows, symbols = s2t_corpus(root, ("test",), 6, seed=18)
    mcfg = xm_config(dtype="float32", small=True)
    mcfg.vocab_size = len(symbols) + 4
    mcfg.multimodal.image_feat_path = [str(root / "img")]
    data = s2t_data_config(root)
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
VIT_TRAIN_B = 8  # phase 21a's images per step
FIXTURES = HERE / "tests" / "torch_images"


def phase_vit_kernels():
    """Phase 2's cases at the image encoders' shape: kernel A with Tq = 577
    queries over S = 584 keys whose last 7 are padding (the ViT's keys
    padded to a multiple of 8), B=16, Dh=64, H=12 (ViT-B) and 16 (ViT-L),
    bf16 and fp32; q a strided view of one (B, T, 3, H, Dh) projection, as
    in the ViT; the bias built once, as the ViT builds it per forward.
    Each held against its plain version, timed beside SDPA with the same
    additive mask and its bound. Then kernel H at the ViT's training shape
    (phase 21a: B=8, the same Tq over S, H=12 and 16; its first run at
    Tq ≠ S), after A wrote the row statistics, against
    ``reference_attention_bwd`` (times max(1, largest |plain|), as phase 2
    holds H), timed beside SDPA's backward alone, with its bound. Returns
    the fp32 fields of A's and H's records on the kernels line (``fp32_ms``,
    ``fp32_plain_ms``, ``fp32_library_ms``, ``fp32_bound_ms`` ...): A at
    B=16 and H at B=8, both at H=12, the fp32 instances on the tensor cores
    in 3xTF32 (bound at the TF32 peak)."""
    import torch.nn.functional as F

    from mm_s2ut_torch.ops import attention as A

    record = {}
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
                  f"kernel / SDPA {res['ms'] / res['library_ms']:.3f}, kernel / plain "
                  f"{res['ms'] / res['plain_ms']:.3f}")
            if dtype == torch.float32 and H == 12:
                record["A"] = fp32_fields(res, work, "mm_s2ut_torch/csrc/flash_attention.cu")
            del qkv, q, k, v
        torch.cuda.empty_cache()
    scale = Dh ** -0.5
    Bt = VIT_TRAIN_B
    for dtype in (torch.bfloat16, torch.float32):
        for H in (12, 16):
            g = torch.Generator().manual_seed(100 + H)
            qkv = _randn((Bt, Tq, 3, H, Dh), g, dtype)
            q = qkv[:, :, 0]
            k, v = (F.pad(qkv[:, :, i], (0, 0, 0, 0, 0, S - Tq)) for i in (1, 2))
            dout = _randn((Bt, Tq, H, Dh), g, dtype)
            kpm = (torch.arange(S)[None, :] >= Tq).expand(Bt, S).cuda()
            key_bias = A.padding_bias(kpm, Bt, S, "cuda")
            stats = torch.empty((2, Bt * H, Tq), device="cuda")
            A._launch("mm_flash_attention", q, k, v, key_bias, scale, False, 0, 0.0, None, stats)
            bwd_only, _ = sdpa_backward(q, k, v, key_bias[:, None, None, :].to(dtype), dout)
            label = f"H ViT train B={Bt} Tq={Tq} S={S} H={H}"
            res = check_and_time(
                label, dtype,
                lambda: A.flash_attention_bwd(q, k, v, key_bias, stats, dout, scale, False, 0),
                lambda: A.reference_attention_bwd(q, k, v, key_bias, dout, scale),
                TOL[dtype], bwd_only, scaled=True, phase="phase 21")
            got = A.flash_attention_bwd(q, k, v, key_bias, stats, dout, scale, False, 0)
            assert all((x[:, Tq:] == 0).all() for x in got[1:3]), "padded keys got a gradient"
            work = bwd_work(Bt, Tq, S, H, Dh, dtype)
            fwd = flash_work(Bt, Tq, S, H, Dh, dtype)
            print(f"phase 21: {label} {str(dtype)[6:]}: bound {work['bound_ms'] * 1e3:.2f} us "
                  f"({work['bound_by']}; A's forward at this shape {fwd['bound_ms'] * 1e3:.2f} us "
                  f"by {fwd['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}, "
                  f"kernel / SDPA backward {res['ms'] / res['library_ms']:.3f}, kernel / plain "
                  f"{res['ms'] / res['plain_ms']:.3f}; the padded keys' dk and dv exactly 0")
            if dtype == torch.float32 and H == 12:
                record["H"] = fp32_fields(res, work, "mm_s2ut_torch/csrc/flash_attention_bwd.cu")
            del qkv, q, k, v, dout, bwd_only, got
        torch.cuda.empty_cache()
    return record


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


FORMAT_FIXTURES = 208  # tests/torch_images/formats/: 17 JPEG and PNG, 65 BMP, GIF, TIFF, WebP,
# 27 Netpbm, TGA, ICO/CUR/DIB, QOI and SGI, 18 PCX/DCX, Sun, XBM, XPM and PSD, 24 DDS,
# 34 IM, MSP, SPIDER, BLP and ICNS, 23 FITS, FTEX, GBR, IMT, McIdas, PIXAR and XV thumbnails
# the TIFF kinds data/tiff.py took on after the first containers (BigTIFF, LZMA, ZSTD,
# CCITT RLE, Group 3 2D, Group 4, ThunderScan, Pillow's F and I modes, 16-bit CMYK,
# an Orientation that swaps the sides, YCbCr in data units, old-style JPEG, JPEG-compressed
# CMYK and gray with alpha)
NEW_TIFF_FIXTURES = [
    "tiff_bigtiff.tif", "tiff_lzma.tif", "tiff_zstd.tif", "tiff_ccitt_rle.tif",
    "tiff_group3_2d.tif", "tiff_group4.tif", "tiff_thunderscan.tif",
    "tiff_float32_predictor3.tif", "tiff_int16_signed_mm.tif", "tiff_int32_signed.tif",
    "tiff_cmyk16.tif", "tiff_orientation6.tif", "tiff_ycbcr_deflate.tif", "tiff_old_jpeg.tif",
    "tiff_jpeg_cmyk.tif", "tiff_jpeg_la.tif"]
CONTAINERS = {".jpg": "JPEG", ".png": "PNG", ".bmp": "BMP", ".gif": "GIF", ".tif": "TIFF",
              ".webp": "WebP", ".pbm": "Netpbm", ".pgm": "Netpbm", ".ppm": "Netpbm",
              ".pfm": "Netpbm", ".tga": "TGA", ".ico": "ICO/CUR/DIB", ".cur": "ICO/CUR/DIB",
              ".dib": "ICO/CUR/DIB", ".qoi": "QOI", ".sgi": "SGI", ".pcx": "PCX/DCX",
              ".dcx": "PCX/DCX", ".ras": "Sun", ".xbm": "XBM", ".xpm": "XPM", ".psd": "PSD",
              ".dds": "DDS", ".im": "IM", ".msp": "MSP", ".spi": "SPIDER", ".blp": "BLP",
              ".icns": "ICNS", ".fits": "FITS", ".ftc": "FTEX", ".ftu": "FTEX", ".gbr": "GBR",
              ".imt": "IMT", ".area": "McIdas", ".pxr": "PIXAR", ".xvthumb": "XVThumb"}
RASTER_FAMILIES = ["Netpbm", "TGA", "ICO/CUR/DIB", "QOI", "SGI", "PCX/DCX", "Sun", "XBM", "XPM",
                   "PSD", "DDS", "IM", "MSP", "SPIDER", "BLP", "ICNS", "FITS", "FTEX", "GBR",
                   "IMT", "McIdas", "PIXAR", "XVThumb"]  # read by the raster and texture decoders
# every DDS layout data/dds.py reads: Pillow's BCn and uncompressed writes, BC4-BC7, masks
DDS_FIXTURES = [
    "dds_dxt1.dds", "dds_dxt3.dds", "dds_dxt5.dds", "dds_bc2.dds", "dds_bc3.dds", "dds_bc5.dds",
    "dds_l_1x1.dds", "dds_la.dds", "dds_rgb_1x1.dds", "dds_rgba.dds", "dds_bc4_ati1.dds",
    "dds_bc4u.dds", "dds_bc4_dx10.dds", "dds_bc5s.dds", "dds_bc6h.dds", "dds_bc6hs.dds",
    "dds_bc7.dds", "dds_r5g6b5.dds", "dds_a1r5g5b5.dds", "dds_a4r4g4b4.dds", "dds_x8r8g8b8.dds",
    "dds_bgr24.dds", "dds_p8.dds", "dds_dx10_rgba.dds"]


def format_fixtures():
    """Every fixture of ``tests/torch_images/formats/`` (progressive, stopped
    early and smoothed, arithmetic-coded, lossless, CMYK, YCCK, h1v2, 4:1:1
    JPEG; Adam7, 16-bit and 1/2/4-bit PNG; BMP, GIF, TIFF and WebP of every
    kind ``tests/test_torch_image_containers.py`` writes; the raster
    families of ``tests/test_torch_image_rasters.py`` to
    ``tests/test_torch_image_rasters4.py``, the DDS textures of
    ``tests/test_torch_image_dds.py``), decoded on the
    host without Pillow and held to the PIL pixels committed beside it:
    [(name, s)]."""
    import numpy as np

    from mm_s2ut_torch.data.image_io import read_image

    out = []
    for path in sorted(p for p in (FIXTURES / "formats").iterdir() if p.suffix != ".npy"):
        t0 = time.perf_counter()
        px = read_image(path)
        secs = time.perf_counter() - t0
        want = np.load(path.with_suffix(".npy"))
        assert px.shape == want.shape and (px == want).all(), f"{path.name}: decoded pixels differ"
        out.append((path.name, secs))
    assert len(out) == FORMAT_FIXTURES, [n for n, _ in out]
    return out


def per_container(formats):
    """{container: (fixtures, mean host decode ms)} of ``format_fixtures``."""
    out = {}
    for kind in dict.fromkeys(CONTAINERS.values()):
        secs = [s for n, s in formats if CONTAINERS[Path(n).suffix] == kind]
        out[kind] = (len(secs), 1e3 * sum(secs) / len(secs))
    return out


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
    formats = format_fixtures()
    prog = FIXTURES / "formats" / "flickr420_q50_prog.jpg"
    t0 = time.perf_counter()
    for _ in range(reps):
        read_image(prog)
    prog_s = (time.perf_counter() - t0) / reps
    lossy = FIXTURES / "formats" / "webp_lossy_photo.webp"
    t0 = time.perf_counter()
    for _ in range(reps):
        read_image(lossy)
    lossy_s = (time.perf_counter() - t0) / reps
    print(f"phase 19a: {len(formats)} format fixtures decoded without Pillow, pixels equal to "
          f"PIL's ({', '.join(f'{n} {s * 1e3:.1f} ms' for n, s in formats)}); host decode "
          f"{1 / prog_s:.2f} images/s at 500x375 progressive ({prog.name}, "
          f"{prog.stat().st_size} B) and {1 / lossy_s:.2f} images/s at 500x375 lossy WebP "
          f"({lossy.name}, {lossy.stat().st_size} B) beside {1 / big_s:.2f} images/s baseline")
    print("phase 19a: host decode per container, mean over its fixtures (at most 64x48 but the "
          "two 500x375 and ICNS's 128x128 it32): "
          + ", ".join(f"{k} {n} files {ms:.2f} ms ({1e3 / ms:.1f} images/s)"
                      for k, (n, ms) in per_container(formats).items()))
    decode_s = dict(formats)
    assert set(NEW_TIFF_FIXTURES) <= set(decode_s), sorted(set(NEW_TIFF_FIXTURES) - set(decode_s))
    assert sorted(DDS_FIXTURES) == sorted(n for n in decode_s if n.endswith(".dds")), DDS_FIXTURES
    print("phase 19a: the newer TIFF kinds, each equal to its PIL twin, host decode: "
          + ", ".join(f"{n} {decode_s[n] * 1e3:.2f} ms" for n in NEW_TIFF_FIXTURES))
    families = per_container(formats)
    for family in RASTER_FAMILIES:
        names = [n for n, _ in formats if CONTAINERS[Path(n).suffix] == family]
        print(f"phase 19a: {family} ({families[family][0]} fixtures, each equal to its PIL twin), "
              f"host decode mean {families[family][1]:.3f} ms: "
              + ", ".join(f"{n} {decode_s[n] * 1e3:.3f} ms" for n in names))

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
    # (g) the containers through cli.extract_features
    container_features(root, gen)
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


# one fixture of each kind the BMP, GIF, TIFF and WebP readers decode, of each raster family,
# every DDS fixture, one of each of IM, MSP, SPIDER, BLP (DXT and JPEG) and ICNS, and one of
# each of FITS, FTEX, GBR, IMT, McIdas, PIXAR and XV thumbnails
CONTAINER_FEATURE_FIXTURES = [
    "bmp_rle8.bmp", "bmp32_bitfields_v5.bmp", "gif_offset_transparent.gif",
    "gif_interlaced.gif", "tiff_jpeg.tif", "tiff_tiles_lzw.tif", "tiff_planar2.tif",
    "webp_lossless.webp", "webp_lossy_photo.webp", "webp_lossy_alpha.webp",
    "webp_lossy_animated.webp",
    # one of each TIFF compression added later, a BigTIFF and YCbCr in data units
    "tiff_lzma.tif", "tiff_zstd.tif", "tiff_ccitt_rle.tif", "tiff_group3_2d.tif",
    "tiff_group4.tif", "tiff_thunderscan.tif", "tiff_old_jpeg.tif", "tiff_bigtiff.tif",
    "tiff_ycbcr_deflate.tif",
    # one of each raster family: Netpbm, TGA, ICO, QOI, SGI, PCX, DCX, Sun, XBM, XPM, PSD
    "netpbm_p6_16bit.ppm", "tga_palette16_rle.tga", "ico_bmp4_bmp8.ico", "qoi_rgba.qoi",
    "sgi_rgb16_rle.sgi", "pcx_4planes.pcx", "dcx_two_frames.dcx", "sun_rgb_rle.ras",
    "xbm_hotspot.xbm", "xpm_2cpp.xpm", "psd_rgb_packbits.psd", *DDS_FIXTURES,
    "im_ycbcr.im", "msp_v2_rle.msp", "spider_big_endian.spi", "blp2_dxt5.blp", "blp1_jpeg.blp",
    "icns_it32.icns", "fits_gzip_16.fits", "ftex_dxt1.ftc", "gbr_v2_rgba.gbr", "imt_gray.imt",
    "mcidas_32.area", "pixar_rgb.pxr", "xvthumb_comments.xvthumb"]


def container_features(root: Path, gen):
    """Phase 19g: ``cli.extract_features`` on the card with ViT-B/16-384 at
    full width under bf16 autocast, over ``CONTAINER_FEATURE_FIXTURES`` and,
    in a second run, over their ``.npy`` twins (Pillow's pixels, committed
    beside each): the features equal bit for bit, A launched 12 times per
    forward."""
    import math

    import numpy as np

    from mm_s2ut_torch.cli import extract_features
    from mm_s2ut_torch.ops import attention as A

    loaded_vit("vit_base_patch16_384", gen, root / "vit_base_19g.bin")
    batch = 4
    forwards = math.ceil(len(CONTAINER_FEATURE_FIXTURES) / batch)
    feats, secs = {}, {}
    for kind in ("containers", "npy"):
        flickr = root / f"flickr30k_{kind}"
        (flickr / "flickr30k-images").mkdir(parents=True, exist_ok=True)
        names = []
        for name in CONTAINER_FEATURE_FIXTURES:
            src = FIXTURES / "formats" / name
            if kind == "npy":
                src = src.with_suffix(".npy")
            names.append(src.name)
            (flickr / "flickr30k-images" / src.name).write_bytes(src.read_bytes())
        (flickr / "test_2016_flickr.txt").write_text("\n".join(names) + "\n")
        A.flash_attention.launches = 0
        t0 = time.perf_counter()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            assert extract_features.main([
                "--flickr30k-root", str(flickr), "--splits", "test2016", "--model",
                "vit_base_patch16_384", "--checkpoint", str(root / "vit_base_19g.bin"),
                "--batch-size", str(batch), "--output-dir", str(root / f"feats_19g_{kind}"),
                "--device", "cuda"]) == 0
        torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t0
        n_a = A.flash_attention.launches
        assert n_a == 12 * forwards, f"19g {kind}: A launched {n_a} times in {forwards} forwards"
        feats[kind] = np.load(root / f"feats_19g_{kind}" / "test2016.npy")
    (root / "vit_base_19g.bin").unlink()
    got, want = feats["containers"], feats["npy"]
    assert got.shape == (len(CONTAINER_FEATURE_FIXTURES), 577, 768), got.shape
    assert np.isfinite(got).all() and np.array_equal(got, want), (
        "19g: features from the containers differ from their .npy twins' "
        f"(max|diff| {float(np.abs(got - want).max())})")
    print(f"phase 19g: extract_features ViT-B/16-384 bf16 over {len(CONTAINER_FEATURE_FIXTURES)} "
          f"BMP/GIF/TIFF/WebP/Netpbm/TGA/ICO/QOI/SGI/PCX/DCX/Sun/XBM/XPM/PSD/DDS/IM/MSP/SPIDER/"
          f"BLP/ICNS/FITS/FTEX/GBR/IMT/McIdas/PIXAR/XVThumb fixtures "
          f"({', '.join(CONTAINER_FEATURE_FIXTURES)}; TIFF in LZMA, "
          f"ZSTD, CCITT RLE, Group 3, Group 4, ThunderScan, old-style JPEG, BigTIFF, YCbCr "
          f"among them): features "
          f"{got.shape} equal bit for bit to those of their .npy twins; A launched 12 times in "
          f"each of {forwards} forwards per run; {secs['containers']:.2f} s and "
          f"{secs['npy']:.2f} s per run (checkpoint load, decode, preprocess, ViT)")


# ------------------------------------------------- training the speech encoders


def xm_train_batch(n, gen, vocab, min_tok=20, max_tok=60, seed=20):
    """Phase 16's n waves of 2-10 s (zeros past each length), random text
    targets of 20-60 tokens ending in EOS (2) and padded with 1, their
    decoder inputs (EOS, then the target shifted right), and 577x768
    image features: a host batch as the S2T task collates one."""
    import numpy as np

    samples, frames, _ = xm_lengths(n)
    wav, _, imgs = synthetic_batch(n, gen, min_s=10.0, max_s=10.0)
    for i, m in enumerate(samples.tolist()):
        wav[i, m:] = 0.0
    rng = np.random.RandomState(seed)
    lens = rng.randint(min_tok, max_tok + 1, n)
    target = np.ones((n, int(lens.max())), np.int32)
    prev = np.ones_like(target)
    for i, m in enumerate(lens):
        toks = rng.randint(4, vocab, m).astype(np.int32)
        toks[-1] = 2
        target[i, :m] = toks
        prev[i, 0], prev[i, 1:m] = 2, toks[:-1]
    return {"src_features": wav.numpy(), "src_lengths": samples.numpy().astype(np.int32),
            "prev_output_tokens": prev, "target": target, "imgs_list": (imgs.numpy(),),
            "img_masks_list": (np.zeros((n, 577), bool),)}, frames


def timed_steps(trainer, batch, n, counters):
    """n train steps, each timed on the CUDA-synchronised host clock, with
    the launches of ``counters`` per step: (metrics, ms per step, launches
    per step)."""
    metrics, ms, launches = [], [], []
    for _ in range(n):
        (m, secs), _, counts = counted(counters, lambda: timed(lambda: trainer.train_batch(batch)))
        metrics.append(m)
        ms.append(secs * 1e3)
        launches.append(counts)
    return metrics, ms, launches


def spread(ms):
    import numpy as np

    return (f"{np.mean(ms):.3f} ms per step (min {min(ms):.3f}, max {max(ms):.3f}, "
            f"sd {np.std(ms):.3f})")


def activation_peak(trainer, batch) -> float:
    """GiB that one training forward and backward (no optimizer step)
    allocates at its peak above what is held before it."""
    for p in trainer.params:
        p.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.model.train()
    loss, m = trainer._loss(batch)
    (loss / m["ntokens"]).backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    for p in trainer.params:
        p.grad = None
    return peak / 2**30


def pos_conv_ms(pos_conv) -> float:
    """The positional conv's forward and backward alone on phase 16's
    frames, under bf16 autocast as in the train step."""
    x = torch.randn(8, 499, pos_conv.conv.in_channels, device="cuda", requires_grad=True)

    def step():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = pos_conv(x)
        y.float().sum().backward()

    return time_ms(step, n=5)


XM_TIMED_STEPS = 5  # phase 20a's timed steps for each checkpointing setting
VIT_TIMED_STEPS = 5  # phase 21a's timed ViT-B/16-384 steps


def phase_xm_train():
    """Phase 20a: the XM train step at full width. ``mm_xm_architecture_base``
    over wav2vec2-base (LayerDrop 0.1, hidden and attention dropout 0.1),
    selective fusion over 577x768 features, bf16 autocast, Adam; phase
    16's 8 waves of 2-10 s with 20-60 text tokens each. 3 warm-up +
    ``XM_TIMED_STEPS`` timed steps with ``gradient_checkpointing`` off, then on, from the
    same weights and seed (the step-1 loss equal); one step profiled; then
    one step at wav2vec2-large-lv60's geometry with checkpointing.
    Returns A's and H's launches in the first timed step without
    checkpointing."""
    import numpy as np

    from mm_s2ut_torch.config import Config, TrainConfig
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    host, frames = xm_train_batch(8, torch.Generator().manual_seed(20), 1010)
    batch = to_device(host, torch.device("cuda"))
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    tcfg = TrainConfig(warmup_updates=10, label_smoothing=0.2)
    first_loss, train_launches = {}, {}
    for ckpt in (False, True):
        cfg = xm_config(dict(layerdrop=0.1, gradient_checkpointing=ckpt))
        model = init_random_(MMXMTransformerModel(cfg), torch.Generator().manual_seed(21))
        n_params = sum(p.numel() for p in model.parameters())
        trainer = Trainer(Config(model=cfg, train=tcfg), model, "cuda")
        torch.cuda.reset_peak_memory_stats()
        warm, _, _ = timed_steps(trainer, batch, 3, counters)
        metrics, ms, launches = timed_steps(trainer, batch, XM_TIMED_STEPS, counters)
        first_loss[ckpt] = warm[0]["loss"] / warm[0]["ntokens"]
        losses = [m["loss"] / m["ntokens"] for m in warm + metrics]
        assert all(np.isfinite(losses)) and all(np.isfinite(m["grad_norm"]) for m in metrics)
        n_layers = cfg.w2v_args.get("num_hidden_layers", 12)
        for c in launches:  # LayerDrop skips layers: A and H once per layer kept (A twice
            # with checkpointing: the forward and the recompute)
            assert 0 < c["H"] <= n_layers and c["A"] == (2 if ckpt else 1) * c["H"], launches
        if not ckpt:
            train_launches = launches[0]
        print(f"phase 20a: XM train step, bf16, {n_params / 1e6:.1f} M params, wav2vec2-base "
              f"(LayerDrop 0.1), B=8 of 2-10 s (frames {frames.tolist()}), "
              f"{int(host['target'].shape[1])} target columns, gradient_checkpointing {ckpt}: "
              f"{spread(ms)} over {XM_TIMED_STEPS} steps (3 warm-up), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; step-1 loss "
              f"{first_loss[ckpt]:.6f}; launches per step {[(c['A'], c['H']) for c in launches]}")
        print(f"phase 20a: losses {[round(x, 4) for x in losses]}")
        print(f"phase 20a: gradient_checkpointing {ckpt}: one forward + backward without the "
              f"optimizer holds {activation_peak(trainer, batch):.2f} GiB above the weights, "
              f"gradients and Adam state")
        if ckpt:
            profile_step(trainer, batch, float(np.mean(ms)), "phase 20a")
            conv = trainer.model.wav2vec2.pos_conv.conv
            conv_ms = pos_conv_ms(trainer.model.wav2vec2.pos_conv)
            print(f"phase 20a: wav2vec2's positional conv alone ({conv.in_channels} channels, "
                  f"{conv.groups} groups, kernel {conv.kernel_size[0]}, B=8 x 499 frames, bf16 "
                  f"autocast): forward + backward {conv_ms:.3f} ms")
        del trainer, model
        torch.cuda.empty_cache()
    rel = abs(first_loss[True] - first_loss[False]) / abs(first_loss[False])
    assert rel <= 1e-6, f"checkpointing moved the step-1 loss: {first_loss}"
    print(f"phase 20a: step-1 loss with and without checkpointing: {first_loss[False]!r} and "
          f"{first_loss[True]!r} (relative diff {rel:.1e})")

    cfg = xm_config(dict(LARGE_W2V, layerdrop=0.1, gradient_checkpointing=True))
    model = init_random_(MMXMTransformerModel(cfg), torch.Generator().manual_seed(22))
    n_w2v = sum(p.numel() for p in model.wav2vec2.parameters())
    trainer = Trainer(Config(model=cfg, train=tcfg), model, "cuda")
    torch.cuda.reset_peak_memory_stats()
    timed_steps(trainer, batch, 1, counters)
    metrics, ms, launches = timed_steps(trainer, batch, 1, counters)
    c = launches[0]
    assert np.isfinite(metrics[0]["loss"]) and 0 < c["H"] <= 24 and c["A"] == 2 * c["H"], c
    print(f"phase 20a: wav2vec2-large-lv60 geometry ({n_w2v / 1e6:.1f} M params in the "
          f"encoder, 24 x 1024, 16 heads, LayerDrop 0.1), checkpointing: one step "
          f"{ms[0]:.3f} ms after one warm-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {c}")
    del trainer, model, batch
    torch.cuda.empty_cache()
    return train_launches


def phase_hubert_train():
    """Phase 20b: the flagship with ``speech_encoder_type: hubert`` at
    HuBERT-base's geometry (12 x 768, post-norm, group norm), bf16, every
    dropout 0.1, span masking (p 0.05, length 10), ``freezing_updates`` 2;
    B=8 x 10 s, 100 unit targets, 577x768 image features: three steps;
    the ``speech_encoder`` is bit-unchanged by steps 1-2 and moves at 3."""
    import numpy as np

    from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig, TrainConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    mcfg = ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm,
                       speech_encoder_type="hubert",
                       w2v_args=dict(mask_time_prob=0.05, mask_time_length=10))
    cfg = Config(model=mcfg, train=TrainConfig(warmup_updates=10, freezing_updates=2))
    model = init_random_(MMS2UTModel(mcfg), torch.Generator().manual_seed(23))
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(cfg, model, "cuda")
    host = train_batch(8, 100, 100, seed=23)
    wav, _, _ = synthetic_batch(8, torch.Generator().manual_seed(23), 10.0, 10.0)
    host["src_features"] = wav.numpy()
    host["src_lengths"] = np.full((8,), wav.shape[1], np.int32)
    batch = to_device(host, torch.device("cuda"))
    enc = dict(trainer.model.speech_encoder.named_parameters())
    trained = [n for n in enc if not n.startswith("feature_extractor")]
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    before = {n: p.detach().clone() for n, p in enc.items()}
    report = []
    for step in range(3):
        (m, secs), _, counts = counted(counters, lambda: timed(lambda: trainer.train_batch(batch)))
        moved = [n for n in enc if not torch.equal(enc[n].detach(), before[n])]
        assert np.isfinite(m["loss"]) and counts == {"A": 12, "H": 12}, (m, counts)
        if step < 2:
            assert moved == [], f"step {step + 1} moved frozen parameters: {moved[:5]}"
        else:
            assert set(trained) <= set(moved), sorted(set(trained) - set(moved))[:5]
        report.append((round(m["loss"] / m["ntokens"], 4), round(secs * 1e3, 3), len(moved)))
    print(f"phase 20b: flagship with a hubert encoder (HuBERT-base geometry, span masking "
          f"p 0.05 length 10, freezing_updates 2), bf16, {n_params / 1e6:.1f} M params, B=8 x "
          f"10 s: per step (loss, ms, speech_encoder tensors moved of {len(enc)}) {report}; A "
          f"and H 12 launches each per step")
    del trainer, model, batch
    torch.cuda.empty_cache()


def phase_heads_train(plain_ms):
    """Phase 20c: the flagship conv-transformer at phase 11's point (B=8 x
    1000 frames x 100 targets, bf16, dropouts 0.1) with ``ctc_weight`` 0.3,
    a ``ctc`` task and a ``transformer`` task (2 layers, 256-d, 4 heads,
    JAX's defaults) on caller-built targets; then with
    ``checkpoint_activations``. ms per step against phase 11's plain step,
    and the CTC terms alone (their loss and backward) timed and profiled."""
    import numpy as np

    from mm_s2ut_torch.config import (Config, ModelConfig, MultimodalConfig,
                                      MultitaskTaskConfig, TrainConfig)
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel, init_parameters_
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops.ctc import ctc_loss
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    tasks = [MultitaskTaskConfig(task_name="src_ctc", decoder_type="ctc"),
             MultitaskTaskConfig(task_name="tgt_lm", decoder_type="transformer")]
    host = train_batch(8, 1000, 100)
    rng = np.random.RandomState(24)
    host["multitask_target"] = rng.randint(4, 1004, (8, 100)).astype(np.int32)
    host["multitask_targets"] = {"src_ctc": rng.randint(4, 1004, (8, 80)).astype(np.int32),
                                 "tgt_lm": rng.randint(4, 1004, (8, 60)).astype(np.int32)}
    host["multitask_prev_tokens"] = {"tgt_lm": rng.randint(4, 1004, (8, 60)).astype(np.int32)}
    batch = to_device(host, torch.device("cuda"))
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    step_ms = {}
    for ckpt in (False, True):
        mcfg = ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm, ctc_weight=0.3,
                           multitask=tasks, checkpoint_activations=ckpt)
        model = init_parameters_(MMS2UTModel(mcfg), torch.Generator().manual_seed(11))
        trainer = Trainer(Config(model=mcfg, train=TrainConfig(warmup_updates=10)), model,
                          "cuda")
        torch.cuda.reset_peak_memory_stats()
        timed_steps(trainer, batch, 3, counters)
        metrics, ms, launches = timed_steps(trainer, batch, 5, counters)
        m = metrics[-1]
        assert all(k in m for k in ("ctc_loss", "src_ctc_loss", "tgt_lm_loss"))
        assert all(np.isfinite(x["loss"]) for x in metrics)
        want = {"A": 24 if ckpt else 12, "H": 12}
        assert all(c == want for c in launches), launches
        step_ms[ckpt] = float(np.mean(ms))
        print(f"phase 20c: flagship bf16 + CTC (0.3) + ctc and transformer tasks, B=8 T_src=1000 "
              f"Tt=100, checkpoint_activations {ckpt}: {spread(ms)} over 5 (3 warm-up), "
              f"{step_ms[ckpt] / plain_ms:.3f} x phase 11's plain step ({plain_ms:.3f} ms); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last step "
              f"ctc_loss {m['ctc_loss']:.2f} src_ctc_loss {m['src_ctc_loss']:.2f} tgt_lm_loss "
              f"{m['tgt_lm_loss']:.2f}; launches per step {launches[0]}")
        del trainer, model
        torch.cuda.empty_cache()

    # The two CTC terms alone: B=8, 250 frames, V=1004, 100 and 80 labels.
    from torch.profiler import ProfilerActivity, profile

    logits = torch.randn(8, 250, 1004, device="cuda", requires_grad=True)
    frames = torch.full((8,), 250, device="cuda")
    labels = [batch["multitask_target"], batch["multitask_targets"]["src_ctc"]]

    def ctc_terms():
        loss = sum(ctc_loss(logits, frames, y, (y != 1).sum(-1)).sum() for y in labels)
        loss.backward()

    ctc_ms = time_ms(ctc_terms, n=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctc_terms()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                 for e in kernels)
    n_launch = sum(e.count for e in kernels)
    print(f"phase 20c: the two CTC terms alone (loss + backward, 250 frames, 100 and 80 labels): "
          f"{ctc_ms:.3f} ms = {ctc_ms / step_ms[False]:.1%} of the step; {n_launch} kernel "
          f"launches, device busy {dev_us / 1e3:.3f} ms ({dev_us / 1e3 / ctc_ms:.1%} of the "
          f"time; the loop over 250 frames is launch-bound)")
    del batch, logits
    torch.cuda.empty_cache()


UPDATE_TOL = 2e-2  # phase 20d: the card's parameter change against the CPU's


def card_vs_cpu(label, model, cfg, batch, counters, frozen_prefix=None, phase="phase 20d"):
    """Three ``Trainer.train_batch`` steps of one small fp32 model on the
    card and on the CPU from the same weights and batch (TF32 off; at
    ``cfg``'s lr, 1e-3 in phase 20d as in phase 10): losses within a relative 1e-5 at each step, step-1
    gradients within a relative 1e-4 of each tensor's largest (floored at
    1e-4), and the change of the parameters over the three steps, card
    against CPU, within a relative ``UPDATE_TOL`` in the L2 norm over all
    parameters. Adam moves nearly every parameter by about lr a step, so
    one step is about a third of that change; the control, the card's
    parameters with its third update left out, must read above the
    limit. The parameters under ``frozen_prefix`` are unchanged by steps
    1-2 on both. Returns the card's launches over the steps."""
    import copy

    from mm_s2ut_torch.train.trainer import Trainer

    trainers = {dev: Trainer(cfg, copy.deepcopy(model), dev) for dev in ("cpu", "cuda")}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = {"cpu": [], "cuda": []}
    total = {k: 0 for k in counters}
    worst = 0.0
    for step in range(3):
        if step == 2:
            skipped = [p.detach().cpu().clone() for p in trainers["cuda"].params]
        for dev, trainer in trainers.items():
            m, _, counts = counted(counters, lambda: trainer.train_batch(copy.deepcopy(batch)))
            losses[dev].append(m["loss"])
            if dev == "cuda":
                total = {k: total[k] + counts[k] for k in counts}
            if frozen_prefix and step < 2:
                for n, p in trainer.model.named_parameters():
                    if n.startswith(frozen_prefix):
                        assert torch.equal(p.detach().cpu(), start[n]), f"{label}: {n} moved"
        if step == 0:
            for p_cpu, p_card in zip(trainers["cpu"].params, trainers["cuda"].params):
                if p_cpu.grad is None:
                    assert p_card.grad is None
                    continue
                want, got = p_cpu.grad, p_card.grad.cpu()
                worst = max(worst, ((got - want).abs().max()
                                    / max(want.abs().max().item(), 1e-4)).item())
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    begin = [start[n] for n, _ in trainers["cpu"].model.named_parameters()]
    want = [p.detach() - p0 for p, p0 in zip(trainers["cpu"].params, begin)]

    def update_err(card):
        diff = sum(((c - p0) - w).pow(2).sum() for c, p0, w in zip(card, begin, want))
        return (diff / sum(w.pow(2).sum() for w in want)).sqrt().item()

    err = update_err([p.detach().cpu() for p in trainers["cuda"].params])
    control = update_err(skipped)
    print(f"{phase}: {label}: 3 steps card vs CPU, losses {[round(x, 5) for x in losses['cuda']]}"
          f" (max relative diff {rel:.1e}, tol 1e-5), step-1 gradients {worst:.1e} (tol 1e-4), "
          f"parameter change over 3 steps {err:.2e} of the CPU's (tol {UPDATE_TOL:.0e}; control, "
          f"the card's third update left out: {control:.2e}); card launches {total}")
    assert control > UPDATE_TOL, (label, control)
    assert rel <= 1e-5 and worst <= 1e-4 and err <= UPDATE_TOL, (label, rel, worst, err)
    return total


def phase_train_card_vs_cpu(out_dir: Path):
    """Phase 20d: every new training setting on small fp32 configs (64-d,
    2 + 2 layers; wav2vec2 of 2 x 64 with base's conv strides), card
    against CPU (``card_vs_cpu``): a ``hubert`` flagship with span masking,
    LayerDrop, ``gradient_checkpointing``, attention dropout 0.1 and
    ``freezing_updates`` 2 with weight decay 0.1; XM with LayerDrop,
    checkpointing, CTC and a ctc and a transformer task; the
    conv-transformer with ``checkpoint_activations``, activation dropout
    0.1 and the same heads (the Bernoulli dropout sites, whose generator
    differs by device, at 0); then ``cli.train`` on a tiny S2T corpus with
    noise mixing on the card and with ``--device cpu``: the same
    metrics.csv (loss columns within a relative 1e-5, grad_norm 1e-4).
    Every run trains at lr 1e-3, so the later steps' losses depend on the
    earlier updates."""
    import csv
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.cli import train as train_cli
    from mm_s2ut_torch.config import (Config, MultitaskTaskConfig, NoiseConfig, TrainConfig,
                                      save_yaml)
    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel
    from mm_s2ut_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    tasks = [MultitaskTaskConfig(task_name="asr", decoder_type="ctc", vocab_size=60,
                                 loss_weight=0.5),
             MultitaskTaskConfig(task_name="st", decoder_type="transformer", decoder_layers=1,
                                 decoder_embed_dim=32, decoder_attention_heads=2,
                                 label_smoothing=0.1)]
    drops = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.1)
    w2v = dict(hidden_dropout=0.0, attention_dropout=0.1, layerdrop=0.3,
               gradient_checkpointing=True)
    small = small_config()
    mm = dataclasses.replace(small.multimodal, modality_dropout=0.0, SA_image_dropout=0.0,
                             SA_attention_dropout=0.0)
    train = TrainConfig(lr=1e-3, warmup_updates=1, weight_decay=0.1, freezing_updates=2)
    gen = torch.Generator().manual_seed(25)
    wav, lens, imgs = synthetic_batch(2, gen, 1.0, 2.0)
    rng = np.random.RandomState(25)
    target = rng.randint(4, 1004, (2, 12)).astype(np.int32)
    target[1, 8:] = 1
    base = {"src_lengths": lens.numpy().astype(np.int32), "target": target,
            "prev_output_tokens": rng.randint(4, 1004, (2, 12)).astype(np.int32),
            "imgs_list": (imgs[:, :50].numpy(),), "img_masks_list": (np.zeros((2, 50), bool),),
            "multitask_target": rng.randint(4, 1004, (2, 5)).astype(np.int32),
            "multitask_targets": {"asr": rng.randint(2, 60, (2, 4)).astype(np.int32),
                                  "st": rng.randint(4, 1004, (2, 6)).astype(np.int32)},
            "multitask_prev_tokens": {"st": rng.randint(4, 1004, (2, 6)).astype(np.int32)}}
    waves = dict(base, src_features=wav.numpy())
    xm = xm_config(w2v, dtype="float32", small=True)
    fbank = dict(base, src_features=rng.randn(2, 200, 80).astype(np.float32),
                 src_lengths=np.array([200, 151], np.int32))
    runs = {
        "hubert flagship (masking p 0.3, LayerDrop 0.3, checkpointing, freezing 2)": (
            MMS2UTModel, dataclasses.replace(
                small, **drops, multimodal=mm, speech_encoder_type="hubert",
                w2v_args=dict(SMALL_W2V, **w2v, mask_time_prob=0.3)), waves, "speech_encoder."),
        "XM (LayerDrop 0.3, checkpointing, CTC, ctc + transformer tasks)": (
            MMXMTransformerModel, dataclasses.replace(
                xm, **drops, multimodal=dataclasses.replace(
                    xm.multimodal, SA_image_dropout=0.0, SA_attention_dropout=0.0),
                ctc_weight=0.3, multitask=tasks, vocab_size=1004), waves, None),
        "conv-transformer (checkpoint_activations, CTC, ctc + transformer tasks)": (
            MMS2UTModel, dataclasses.replace(small, **drops, multimodal=mm, ctc_weight=0.3,
                                             multitask=tasks, checkpoint_activations=True),
            fbank, None),
    }
    for i, (label, (cls, mcfg, batch, frozen)) in enumerate(runs.items()):
        model = init_random_(cls(mcfg), torch.Generator().manual_seed(26 + i))
        cfg = Config(model=mcfg, train=train if frozen else dataclasses.replace(
            train, freezing_updates=0))
        launched = card_vs_cpu(label, model, cfg, batch, counters, frozen)
        assert launched["A"] > 0 and launched["H"] > 0, launched

    root = out_dir / "train_s2t"
    rows, symbols = s2t_corpus(root, ("train", "valid"), 6, seed=27)
    (root / "noise").mkdir(exist_ok=True)
    for k, n in enumerate((4000, 60000)):
        write_wav(root / "noise" / f"{k}.wav", (0.4 * rng.randn(n)).astype(np.float32), 16000)
    mcfg = dataclasses.replace(xm_config(dict(w2v, mask_time_prob=0.3), dtype="float32",
                                         small=True), **drops, vocab_size=len(symbols) + 4)
    mcfg.multimodal.image_feat_path = [str(root / "img")]
    mcfg.multimodal.modality_dropout = 0.0
    mcfg.multimodal.SA_image_dropout = mcfg.multimodal.SA_attention_dropout = 0.0
    data = s2t_data_config(root, noise=NoiseConfig(noise_wav_dir=str(root / "noise"),
                                                   noise_prob=0.7))
    conf = Config(task="multimodal_speech_to_text", model=mcfg, data=data,
                  train=TrainConfig(lr=1e-3, warmup_updates=1, max_update=4,
                                    save_interval_updates=2, log_interval=1))
    save_yaml(conf, root / "run.yaml")
    tables = {}
    for dev in ("cuda", "cpu"):
        save = root / f"ckpt_{dev}"
        (rc, secs), _, counts = counted(counters, lambda: timed(lambda: train_cli.main(
            ["--config", str(root / "run.yaml"), "--device", dev, f"train.save_dir={save}"])))
        assert rc == 0, dev
        with open(save / "logs" / "metrics.csv", newline="") as f:
            tables[dev] = list(csv.DictReader(f))
        if dev == "cuda":
            assert counts["A"] > 0 and counts["H"] > 0, counts
            card_s, card_counts = secs, counts
    assert len(tables["cuda"]) == len(tables["cpu"]) >= 4
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for a, b in zip(tables["cuda"], tables["cpu"]):
        assert a["step"] == b["step"]
        for key in a:
            if not a[key] or not (key.endswith("loss") or key.endswith("grad_norm")):
                continue
            kind = "grad_norm" if key.endswith("grad_norm") else "loss"
            x, y = float(a[key]), float(b[key])
            worst[kind] = max(worst[kind], abs(x - y) / max(abs(y), 1e-12))
    print(f"phase 20d: cli.train, task multimodal_speech_to_text, small XM (span masking asked "
          f"of the wav2vec2 config and not applied, as the reference's trainer never asks XM "
          f"to mask; LayerDrop, checkpointing) on a {len(rows)}-utterance S2T corpus with noise "
          f"mixing (p 0.7): 4 steps on the card in {card_s:.2f} s (launches {card_counts}) and "
          f"with --device cpu; metrics.csv rows {len(tables['cuda'])}, loss columns max "
          f"relative diff {worst['loss']:.1e} (tol 1e-5), grad_norm {worst['grad_norm']:.1e} "
          f"(tol 1e-4)")
    assert worst["loss"] <= 1e-5 and worst["grad_norm"] <= 1e-4, worst
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the runs below


def phase_w2v_train_kernels():
    """Phase 20e: A (attention dropout 0.1 and 0) and H after it at the
    wav2vec2 training shapes: B=8, T=499 (the key padding of 2-10 s
    utterances), H=12 (base) and 16 (large), D=64, bf16 and fp32, each
    against its plain version, timed beside SDPA (forward for A, its
    backward alone for H) with the bound (``flash_work``/``bwd_work``)."""
    from mm_s2ut_torch.ops import attention as A

    scale = 64 ** -0.5
    _, frames, _ = xm_lengths(8)
    T = int(frames.max())
    kpm = (torch.arange(T)[None, :] >= frames[:, None]).cuda()
    bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for H in (12, 16):
            g = torch.Generator().manual_seed(200 + H)
            q, k, v = (_randn((8, T, H, 64), g, dtype) for _ in range(3))
            dout = _randn(q.shape, g, dtype)
            mask = bias[:, None, None, :].to(dtype)
            bwd_only, _ = sdpa_backward(q, k, v, mask, dout)
            for rate in (0.1, 0.0):
                seed = DROP_SEED if rate else None
                label = f"A wav2vec2 train B=8 T={T} H={H} dropout {rate}"
                res = check_and_time(
                    label, dtype,
                    lambda: A.flash_attention(q, k, v, kpm, dropout_rate=rate, dropout_seed=seed),
                    lambda: A.reference_attention(q * scale, k, v, bias[:, None, None, :], False,
                                                  0, rate, seed),
                    TOL[dtype], lambda: sdpa(q, k, v, mask), scaled=True, phase="phase 20e")
                work = flash_work(8, T, T, H, 64, dtype)
                print(f"phase 20e: {label} {name}: bound {work['bound_ms'] * 1e3:.2f} us "
                      f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}, "
                      f"kernel / SDPA {res['ms'] / res['library_ms']:.3f}")
                stats = torch.empty((2, 8 * H, T), device="cuda")
                A._launch("mm_flash_attention", q, k, v, bias, scale, False, 0, rate, seed, stats)
                label = f"H wav2vec2 train B=8 T={T} H={H} dropout {rate}"
                res = check_and_time(
                    label, dtype,
                    lambda: A.flash_attention_bwd(q, k, v, bias, stats, dout, scale, False, 0,
                                                  rate, seed),
                    lambda: A.reference_attention_bwd(q, k, v, bias, dout, scale, False, 0, rate,
                                                      seed),
                    TOL[dtype], bwd_only, scaled=True, phase="phase 20e")
                work = bwd_work(8, T, T, H, 64, dtype)
                print(f"phase 20e: {label} {name}: bound {work['bound_ms'] * 1e3:.2f} us "
                      f"({work['bound_by']}), kernel / bound {res['ms'] / work['bound_ms']:.2f}, "
                      f"kernel / SDPA backward {res['ms'] / res['library_ms']:.3f}")
            del q, k, v, dout, bwd_only
            torch.cuda.empty_cache()



def phase_train_speech_encoders(out_dir: Path, plain_step_ms: float):
    """Phase 20 (training the speech encoders and the enhanced path):
    20e's kernel cases first, then 20a-d. Returns 20a's ``train_launches``."""
    parts = {}
    subphase(parts, phase_w2v_train_kernels)
    train_launches = subphase(parts, phase_xm_train)
    subphase(parts, phase_hubert_train)
    subphase(parts, phase_heads_train, plain_step_ms)
    subphase(parts, phase_train_card_vs_cpu, out_dir)
    print(f"phase 20: wall seconds of its parts {json.dumps(parts)}")
    return train_launches


# ------------------------------------------------------------------ phase 21


def vit_train_batch(images, n, size, frames=1000, targets=100, seed=21):
    """Phase 11's batch (n x ``frames`` log-mel frames, ``targets`` units)
    with n preprocessed fixture images at ``size``² as the first image
    source, for the model's on-line extractor."""
    batch = train_batch(n, frames, targets, seed=seed, img_tokens=1)
    batch["imgs_list"] = (vit_pixels(images, n, size).numpy(),)
    batch["img_masks_list"] = (torch.zeros((n, size), dtype=torch.bool).numpy(),)
    return batch


def vit_train_config(vit_name: str):
    """The flagship (bf16, dropouts 0.1, fusion over the extractor's
    features) with ``load_visual_extractor_type: vit_timm`` at ``vit_name``'s
    geometry, and that geometry."""
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig
    from mm_s2ut_torch.models.vit import VIT_VARIANTS

    vit = VIT_VARIANTS[vit_name]
    mm = MultimodalConfig(image_feat_dim=[vit.embed_dim],
                          multimodal_attention_type="selective_attention", use_selective_gate=True,
                          modality_dropout=0.5, audio_dropout=0.5,
                          load_visual_extractor_type="vit_timm", image_input_size=vit.image_size)
    return ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm), vit


def phase_vit_train(images):
    """Phase 21a: the flagship with ViT-B/16-384 in its graph trained at full
    width: phase 11's point (B=8 x 10 s, 100 units, dropouts 0.1, bf16
    autocast, Adam) with 8 decoded fixture images at 384² through the
    extractor, 3 warm-up + ``VIT_TIMED_STEPS`` timed steps (ms per step and its spread,
    peak memory, A and H per step: 12 in the speech encoder and 12 in the
    ViT each), one step profiled; then ViT-L/16-384 for one step (A and H
    36 each). Returns A's and H's launches in the first timed ViT-B step."""
    import numpy as np

    from mm_s2ut_torch.config import Config, TrainConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    tcfg = TrainConfig(warmup_updates=10, label_smoothing=0.2)
    launches_b = {}
    for name, warm, steps in (("vit_base_patch16_384", 3, VIT_TIMED_STEPS),
                              ("vit_large_patch16_384", 1, 1)):
        mcfg, vit = vit_train_config(name)
        model = init_random_(MMS2UTModel(mcfg, vit_cfg=vit), torch.Generator().manual_seed(21))
        n_params = sum(p.numel() for p in model.parameters())
        n_vit = sum(p.numel() for p in model.visual_extractor.parameters())
        batch = to_device(vit_train_batch(images, VIT_TRAIN_B, vit.image_size), torch.device("cuda"))
        trainer = Trainer(Config(model=mcfg, train=tcfg), model, "cuda")
        torch.cuda.reset_peak_memory_stats()
        warm_m, _, _ = timed_steps(trainer, batch, warm, counters)
        metrics, ms, launches = timed_steps(trainer, batch, steps, counters)
        losses = [m["loss"] / m["ntokens"] for m in warm_m + metrics]
        assert all(np.isfinite(losses)) and all(np.isfinite(m["grad_norm"]) for m in metrics)
        want = mcfg.encoder_layers + vit.depth
        assert all(c == {"A": want, "H": want} for c in launches), launches
        print(f"phase 21a: flagship bf16 with {name} in its graph ({n_params / 1e6:.1f} M params, "
              f"{n_vit / 1e6:.1f} M in the extractor), B={VIT_TRAIN_B} x 1000 frames x 100 units, "
              f"{VIT_TRAIN_B} fixture images at {vit.image_size}²: {spread(ms)} over {steps} steps "
              f"({warm} warm-up), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches per step {launches[0]}; losses {[round(x, 4) for x in losses]}")
        if name == "vit_base_patch16_384":
            launches_b = launches[0]
            print(f"phase 21a: one forward + backward without the optimizer holds "
                  f"{activation_peak(trainer, batch):.2f} GiB above the weights, gradients and "
                  f"Adam state")
            profile_step(trainer, batch, float(np.mean(ms)), "phase 21a")
        del trainer, model, batch
        torch.cuda.empty_cache()
    return launches_b


def phase_vit_train_card_vs_cpu(images):
    """Phase 21b: small fp32 configs trained through the extractor, card
    against CPU (``card_vs_cpu``, lr 1e-3, 3 steps, with the control that
    leaves the card's third update out): the tiny ViT of
    ``test_online_visual_extractor_train_from_jpgs`` (32², 32-d, 1 block)
    and a CLIP tower of the same size, over 2 decoded fixture images;
    then ``SubModel``'s ResEncoder in train mode (batch statistics) over
    two (2, 3, 64, 64, 1) clips: fp32 outputs and running statistics, and
    float64 gradients, card against CPU."""
    import copy
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.config import Config, TrainConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.models.resnet_encoder import SubModel
    from mm_s2ut_torch.models.vit import CLIPVisionConfig, ViTConfig
    from mm_s2ut_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    drops = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.1)
    small = small_config()
    geometry = dict(image_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2)
    batch = train_batch(2, 200, 12, img_tokens=1, seed=26)
    batch["imgs_list"] = (vit_pixels(images, 2, 32).numpy(),)
    batch["img_masks_list"] = (np.zeros((2, 32), bool),)
    for kind, vit in (("vit_timm", ViTConfig(**geometry)),
                      ("vit_openai", CLIPVisionConfig(**geometry))):
        mm = dataclasses.replace(small.multimodal, image_feat_dim=[32], modality_dropout=0.0,
                                 SA_image_dropout=0.0, SA_attention_dropout=0.0,
                                 load_visual_extractor_type=kind, image_input_size=32)
        mcfg = dataclasses.replace(small, **drops, multimodal=mm)
        model = init_random_(MMS2UTModel(mcfg, vit_cfg=vit), torch.Generator().manual_seed(27))
        launched = card_vs_cpu(f"small fp32 config with {kind} (32², 32-d, 1 block)", model,
                               Config(model=mcfg, train=TrainConfig(lr=1e-3, warmup_updates=1)),
                               batch, counters, phase="phase 21b")
        # A and H run in the speech encoder's layers, and in the timm ViT's block
        want = 3 * (small.encoder_layers + (vit.depth if kind == "vit_timm" else 0))
        assert launched == {"A": want, "H": want}, (kind, launched)

    sub = SubModel(out_dim=32, num_layers=0)
    gen = torch.Generator().manual_seed(28)
    videos = [torch.randn(2, 3, 64, 64, 1, generator=gen) for _ in range(2)]
    worst = {"output": 0.0, "stats": 0.0, "grads": 0.0}
    # Outputs and running statistics in fp32; the gradients in float64: in
    # fp32 a BatchNorm'd conv's weight gradient is a sum the normalisation
    # nearly cancels, and cuDNN's accumulation order (its algorithm varies
    # by run) moves it by up to 1e-2 of itself (tests/test_torch_resnet_train.py
    # holds the port to flax's the same way).
    for dtype in (torch.float32, torch.float64):
        runs = {dev: copy.deepcopy(sub).to(dev, dtype).train() for dev in ("cpu", "cuda")}
        for video in videos:  # two train-mode steps: batch statistics, running ones moved
            outs, grads = {}, {}
            for dev, m in runs.items():
                m.zero_grad()
                out = m(video=video.to(dev, dtype))
                out.square().sum().backward()
                outs[dev] = out.detach().cpu()
                grads[dev] = [p.grad.cpu() for p in m.parameters()]
            if dtype == torch.float32:
                worst["output"] = max(worst["output"], ((outs["cuda"] - outs["cpu"]).abs().max()
                                                        / outs["cpu"].abs().max()).item())
                continue
            diff = sum((a - b).pow(2).sum() for a, b in zip(grads["cuda"], grads["cpu"]))
            worst["grads"] = max(worst["grads"], (diff / sum(
                b.pow(2).sum() for b in grads["cpu"])).sqrt().item())
        if dtype == torch.float32:
            for (name, a), b in zip(runs["cuda"].state_dict().items(),
                                    runs["cpu"].state_dict().values()):
                if "running" in name:
                    worst["stats"] = max(worst["stats"], ((a.cpu() - b).abs().max()
                                                          / b.abs().max()).item())
    print(f"phase 21b: ResEncoder train mode (batch statistics, flax's momentum and biased "
          f"variance), two steps card vs CPU (TF32 off): max relative diff {worst} (tol 1e-4 "
          f"for fp32 outputs and running statistics, 1e-8 in L2 for all float64 gradients)")
    assert worst["output"] <= 1e-4 and worst["stats"] <= 1e-4 and worst["grads"] <= 1e-8, worst
    torch.backends.cudnn.allow_tf32 = True


def small_corpus(root: Path, n: int, seed: int, img_dim: int = 64, img_tokens: int = 10,
                 n_valid: int = 4):
    """n synthetic 1-2.5 s wavs with unit targets, train and valid
    manifests (valid: the first ``n_valid``) and per-split image features."""
    import numpy as np

    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.data.manifest import ManifestRow, write_manifest

    (root / "img_feat").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        m = 16000 + 3000 * (i % 6)
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(m)).astype(np.float32), 16000)
        units = " ".join(str(u) for u in rng.randint(0, 1000, 10 + i % 5))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", m, units, 10 + i % 5))
    write_manifest(root / "train.tsv", rows)
    write_manifest(root / "valid.tsv", rows[:n_valid])
    for split in ("train", "valid"):
        np.save(root / "img_feat" / f"{split}.npy",
                rng.randn(n, img_tokens, img_dim).astype(np.float32))
    return rows


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 & -(c & 1))
    return c ^ 0xFFFFFFFF


def _proto(buf: bytes):
    """(field, wire type, value) of a protobuf message, one level deep."""
    i = 0
    while i < len(buf):
        key, i = _uvarint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _uvarint(buf, i)
        elif wire == 1:
            v, i = buf[i: i + 8], i + 8
        elif wire == 2:
            n, i = _uvarint(buf, i)
            v, i = buf[i: i + n], i + n
        elif wire == 5:
            v, i = buf[i: i + 4], i + 4
        else:
            raise AssertionError(f"protobuf wire type {wire}")
        yield field, wire, v


def _uvarint(buf: bytes, i: int):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return v, i


def check_events_against_csv(logdir: Path, rows) -> int:
    """Phase 21c: the one ``events.out.tfevents.*`` file of ``logdir`` read
    with the few lines above (TFRecords with their masked CRC32Cs, Event
    and Summary protobufs); every (tag, step) scalar equals the float32 of
    ``metrics.csv``'s cell, and every cell has its scalar. Returns the
    number of scalars."""
    import struct

    files = sorted(logdir.glob("events.out.tfevents.*"))
    assert len(files) == 1, files
    data, i, events = files[0].read_bytes(), 0, []

    def masked(b):
        c = _crc32c(b)
        return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    while i < len(data):
        head = data[i: i + 8]
        n = struct.unpack("<Q", head)[0]
        assert struct.unpack_from("<I", data, i + 8)[0] == masked(head), "length CRC"
        rec = data[i + 12: i + 12 + n]
        assert struct.unpack_from("<I", data, i + 12 + n)[0] == masked(rec), "data CRC"
        events.append(rec)
        i += 16 + n
    first = {f: v for f, _, v in _proto(events[0])}
    assert first.get(3) == b"brain.Event:2", first
    got = {}
    for rec in events[1:]:
        ev = {f: v for f, _, v in _proto(rec)}
        step = ev.get(2, 0)
        for _, _, value in _proto(ev[5]):
            val = {f: v for f, _, v in _proto(value)}
            tensor = {f: v for f, _, v in _proto(val[8])}
            plugin = {f: v for f, _, v in _proto({f: v for f, _, v in _proto(val[9])}[1])}
            assert tensor[1] == 1 and plugin[1] == b"scalars", (tensor, plugin)
            got[(val[1].decode(), step)] = struct.unpack("<f", tensor[4])[0]
    want = {(k, int(r["step"])): struct.unpack("<f", struct.pack("<f", float(v)))[0]
            for r in rows for k, v in r.items() if k != "step" and v not in ("", None)}
    assert got.keys() == want.keys(), (sorted(got)[:5], sorted(want)[:5])
    bad = [k for k in got if not (got[k] == want[k] or (got[k] != got[k] and want[k] != want[k]))]
    assert not bad, bad[:5]
    return len(got)


def start_dp_on_card(out_dir: Path) -> dict:
    """Phase 21c's first half: its corpus and config, and the NCCL run in a
    process of its own (torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT`` set), which starts and trains while 21b
    runs. Returns what ``phase_dp_on_card`` reads."""
    import socket

    from mm_s2ut_torch.config import Config, DataConfig, TrainConfig, save_yaml

    root = out_dir / "dp"
    small_corpus(root, 8, seed=29)
    mcfg = small_config()
    mcfg.multimodal.image_feat_dim = [64]
    mcfg.multimodal.image_feat_path = [str(root / "img_feat")]
    cfg = Config(model=mcfg, data=DataConfig(data_root=str(root), audio_root=str(root),
                                             max_tokens=800, num_buckets=1),
                 train=TrainConfig(lr=1e-3, warmup_updates=1, max_update=3,
                                   save_interval_updates=3, log_interval=1))
    save_yaml(cfg, root / "run.yaml")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import sys, time; t0 = time.perf_counter(); import torch; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; from mm_s2ut_torch.cli import train; "
            "rc = train.main(sys.argv[1:]); print(time.perf_counter() - t0); sys.exit(rc)")
    env = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    proc = subprocess.Popen([sys.executable, "-c", code, "--config", str(root / "run.yaml"),
                             f"train.save_dir={root / 'ckpt_dp'}"], cwd=HERE, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"root": root, "proc": proc}


def phase_dp_on_card(dp: dict):
    """Phase 21c: ``cli.train`` under ``torch.distributed`` at world size 1
    with NCCL (``start_dp_on_card``'s process) against the same command
    without torchrun's variables, run in this process, on a small fp32
    config with every dropout 0.1 (TF32 off), 3 steps: ``params.npz``
    equal bit for bit, or within phase 20d's tolerances (losses 1e-5, the
    parameter change 2e-2 in L2); each run's ``logs/`` events file equal
    to its ``metrics.csv``. The machine has one card: world sizes above 1
    run on the CPU (gloo) in ``tests/test_torch_ddp.py``."""
    import csv

    import numpy as np

    from mm_s2ut_torch.cli import train
    from mm_s2ut_torch.convert import flatten, load_npz

    root, proc = dp["root"], dp["proc"]
    unset = {k: os.environ.pop(k) for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                                            "MASTER_PORT") if k in os.environ}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rc, plain_s = timed(lambda: train.main(["--config", str(root / "run.yaml"),
                                                f"train.save_dir={root / 'ckpt'}"]))
        t0 = time.perf_counter()
        out, err = proc.communicate(timeout=300)
        wait_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        os.environ.update(unset)
    assert rc == 0, rc
    assert proc.returncode == 0, err[-3000:]
    runs = {}
    for label, save, secs in (("plain, in process", root / "ckpt", plain_s),
                              ("torch.distributed, NCCL, world 1", root / "ckpt_dp",
                               float(out.split()[-1]))):
        with open(save / "logs" / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        n_events = check_events_against_csv(save / "logs", rows)
        runs[label] = (flatten(load_npz(save / "params.npz")), rows, secs)
    (p0, r0, s0), (p1, r1, s1) = runs.values()
    bitwise = all(np.array_equal(p0[k], p1[k]) for k in p0)
    losses = [(float(a["train/loss"]), float(b["train/loss"])) for a, b in zip(r0, r1)
              if a.get("train/loss")]
    rel = max(abs(a - b) / abs(a) for a, b in losses)
    diff = max(float(np.abs(p0[k] - p1[k]).max()) for k in p0)
    print(f"phase 21c: cli.train, small fp32 config, dropouts 0.1, 3 steps: plain in this "
          f"process {s0:.2f} s; under torch.distributed (NCCL, world size 1) in a process of "
          f"its own, started before 21b, {s1:.2f} s from its imports, {wait_s:.2f} s waited for "
          f"after the plain run; params.npz "
          f"{'bit for bit equal' if bitwise else f'max abs diff {diff:.3e}'}, train losses max "
          f"relative diff {rel:.1e} (tol 1e-5); world sizes above 1 are tested on the CPU with "
          f"gloo (tests/test_torch_ddp.py); logs/ of each run holds a TensorBoard events file, "
          f"every CRC checked, its {n_events} scalars equal to metrics.csv's")
    assert rel <= 1e-5 and (bitwise or diff <= 1e-5), (rel, diff)


def hf_ctc_dir(root: Path, w2v_cfg, gen, vocab):
    """A random ``Wav2Vec2ForCTC`` written as a local HF checkpoint directory
    (``write_hf_dir``) with its ``vocab.json``."""
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2ForCTC

    model = init_random_(Wav2Vec2ForCTC(w2v_cfg), gen)
    write_hf_dir(root, model, w2v_cfg, vocab)
    return model


# Flax-layout names of a Wav2Vec2ForCTC (a bare Wav2Vec2Model's under "wav2vec2/") → HF's.
HF_W2V_NAMES = [
    (r"^wav2vec2/feature_extractor/conv(\d+)/", r"wav2vec2.feature_extractor.conv_layers.\1.conv."),
    (r"^wav2vec2/feature_extractor/group_norm/",
     "wav2vec2.feature_extractor.conv_layers.0.layer_norm."),
    (r"^wav2vec2/feature_extractor/layer_norm(\d+)/",
     r"wav2vec2.feature_extractor.conv_layers.\1.layer_norm."),
    (r"^wav2vec2/feature_projection_norm/", "wav2vec2.feature_projection.layer_norm."),
    (r"^wav2vec2/feature_projection/", "wav2vec2.feature_projection.projection."),
    (r"^wav2vec2/pos_conv/conv/", "wav2vec2.encoder.pos_conv_embed.conv."),
    (r"^wav2vec2/encoder_norm/", "wav2vec2.encoder.layer_norm."),
    (r"^wav2vec2/layer(\d+)/attention/", r"wav2vec2.encoder.layers.\1.attention."),
    (r"^wav2vec2/layer(\d+)/(intermediate_dense|output_dense)/",
     r"wav2vec2.encoder.layers.\1.feed_forward.\2."),
    (r"^wav2vec2/layer(\d+)/", r"wav2vec2.encoder.layers.\1."),
    (r"^wav2vec2/masked_spec_embed$", "wav2vec2.masked_spec_embed"),
    (r"^lm_head/", "lm_head."), (r"/", ".")]


def torch_names(flat, rules):
    """Flax leaves {"a/b/leaf": array} → torch state-dict entries under the
    renames ``rules``: Dense/Conv kernels transposed to (out, in[, k]),
    LayerNorm ``scale`` → ``weight``."""
    import re

    sd = {}
    for key, value in flat.items():
        name = key
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        if name.endswith(".kernel"):
            value = value.transpose(2, 1, 0) if value.ndim == 3 else value.T
            name = name[: -len("kernel")] + "weight"
        elif name.endswith(".scale"):
            name = name[: -len("scale")] + "weight"
        sd[name] = torch.from_numpy(value.copy())
    return sd


def write_hf_dir(root: Path, model, w2v_cfg, vocab=None):
    """``model`` (a ``Wav2Vec2ForCTC`` or a bare ``Wav2Vec2Model``) written as
    a local HF checkpoint directory (``config.json``, ``pytorch_model.bin``
    under HF's names, ``vocab.json`` when ``vocab`` is given), from the
    flax-layout parameters ``convert.to_flax`` gives; ``load_hf_checkpoint``
    reads it back leaf for leaf (checked here). No ``transformers``."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.convert import flatten, to_flax
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2ForCTC, load_hf_checkpoint

    want = to_flax(model)
    flat = want if isinstance(model, Wav2Vec2ForCTC) else {f"wav2vec2/{k}": v
                                                            for k, v in want.items()}
    root.mkdir(parents=True, exist_ok=True)
    torch.save(torch_names(flat, HF_W2V_NAMES), root / "pytorch_model.bin")
    hf = {k: v for k, v in dataclasses.asdict(w2v_cfg).items()
          if k not in ("gradient_checkpointing", "use_flash_attention", "pad_to_multiple")}
    (root / "config.json").write_text(json.dumps(hf))
    if vocab is not None:
        (root / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    cfg, variables = load_hf_checkpoint(root)  # the directory reads back as written
    back = flatten(variables["params"])
    assert cfg == w2v_cfg and set(back) == set(want), sorted(set(back) ^ set(want))
    assert all(np.array_equal(back[k], want[k]) for k in want)


def eval_inference_run(root: Path, mcfg, kv, device, beam, max_len_b):
    """One validation of ``cli.train``'s trainer with ``train.eval_inference``
    over ``root``'s valid split on ``device``, from the task's seeded
    initial weights: (metrics, seconds, the task, the trainer)."""
    from mm_s2ut_torch.config import Config, DataConfig, GenerationConfig, TrainConfig
    from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask

    cfg = Config(model=mcfg, data=DataConfig(data_root=str(root), audio_root=str(root),
                                             max_tokens=4000, num_buckets=1),
                 train=TrainConfig(eval_inference=True,
                                   eval_vocoder_path=str(root / "vocoder.pt"),
                                   eval_vocoder_cfg=str(root / "vocoder.json")),
                 generation=GenerationConfig(beam=beam, max_len_a=0.0, max_len_b=max_len_b,
                                             kv_cache_dtype=kv))
    task = MultiModalSpeechToSpeechTask(cfg, device)
    trainer = task.build_trainer()
    fn = task.build_inference_metrics_fn(trainer)
    t0 = time.perf_counter()
    metrics = trainer.evaluate(task.batch_iterator("valid", shuffle=False), fn)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return metrics, time.perf_counter() - t0, task, trainer


def phase_eval_inference(out_dir: Path):
    """Phase 21d: ``train.eval_inference`` at full width. A random
    CodeHiFiGAN at its default config (duration prediction) written in
    fairseq's format with its JSON config; the flagship bf16 with fusion
    over 577x768 features validates 8 utterances of 1-2.5 s (decode with
    the live model, beam 10, 200 units, bf16 then int8 cache, vocode the
    predicted and target units, MCD): the four metrics finite, the
    validation's wall seconds. Card against CPU on the small fp32 config
    (TF32 off, beam 5, 30 units) with the same vocoder: the MCD metrics
    equal. Then the flagship's units of the 8 utterances vocoded into wavs,
    ``python -m mm_s2ut_torch.eval.asr`` on them with a random
    wav2vec2-base CTC model written as an HF directory, and
    ``python -m mm_s2ut_torch.eval.bleu`` on its transcripts."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.config import GenerationConfig, ModelConfig, MultimodalConfig
    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.eval import asr as eval_asr
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.eval import bleu as eval_bleu
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    root = out_dir / "eval_inference"
    small_corpus(root, 8, seed=30, img_dim=768, img_tokens=577, n_valid=8)
    gen = torch.Generator().manual_seed(31)
    vcfg = HiFiGANConfig()
    vocoder = init_random_(CodeHiFiGAN(vcfg), gen)
    torch.save(fairseq_vocoder_state(vocoder), root / "vocoder.pt")
    (root / "vocoder.json").write_text(json.dumps(dict(
        dataclasses.asdict(vcfg), sampling_rate=16000)))
    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, image_feat_path=[str(root / "img_feat")])
    flagship_cfg = ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm)
    counters = {"A": A.flash_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention, "D": D.ancestry_decode_attention_i8,
                "E": D.cross_decode_attention_i8}
    keys = ("mcd_loss", "pred_ratio", "ins_rate", "del_rate")
    for kv in (None, "int8"):
        (metrics, secs, task, trainer), _, launches = counted(
            counters, lambda: eval_inference_run(root, flagship_cfg, kv, "cuda", 10, 200))
        assert all(np.isfinite(metrics[k]) for k in keys), metrics
        want = ("B", "C") if kv is None else ("D", "E")
        assert all(launches[k] > 0 for k in ("A", *want)), launches
        print(f"phase 21d: flagship bf16, train.eval_inference over 8 utterances, beam 10, "
              f"200 units, {kv or 'bf16'} cache: validation {secs:.2f} s; "
              f"{json.dumps({k: metrics[k] for k in keys + ('loss',)})}; launches {launches}")

    # The flagship's units of the 8 utterances, vocoded, through eval.asr and eval.bleu.
    wavs_dir = root / "tts"
    wavs_dir.mkdir(exist_ok=True)
    model = trainer.model.to(torch.bfloat16).eval()
    generator = UnitGenerator(model, GenerationConfig(beam=10, max_len_a=0.0, max_len_b=200))
    voc = vocoder.to("cuda").eval()
    n_wavs = 0
    for batch in task.batch_iterator("valid", shuffle=False):
        hyps = generator.generate(batch["src_features"], batch["src_lengths"],
                                  batch["imgs_list"], batch["img_masks_list"])
        for sid, h in zip(batch["id"].tolist(), hyps):
            units = task.tgt_dict.ids_to_units(np.asarray(h[0]["tokens"])).tolist() or [0]
            voc.max_frames = 8 * len(units) + 16
            w, m = voc(torch.tensor([units], device="cuda"),
                       torch.tensor([len(units)], device="cuda"))
            write_wav(wavs_dir / f"{int(sid) + 1}_pred.wav",
                      w[0, :int(m[0])].float().cpu().numpy(), 16000)
            n_wavs += 1
    del generator, model, trainer, task, voc
    torch.cuda.empty_cache()
    letters = ["<pad>", "<s>", "</s>", "<unk>", "|"] + list("etaoinshrdlcumwfgypbvk")
    hf_ctc_dir(root / "asr_model", Wav2Vec2Config(vocab_size=len(letters)),
               torch.Generator().manual_seed(32), letters)  # wav2vec2-base's geometry
    _, asr_s, asr_launches = counted({"A": A.flash_attention}, lambda: eval_asr.main(
        ["--wav_dir", str(wavs_dir), "--output", str(root / "transcripts.txt"),
         "--asr_model", str(root / "asr_model")]))
    transcripts = (root / "transcripts.txt").read_text().splitlines()
    assert len(transcripts) == n_wavs == 8 and asr_launches["A"] > 0, (n_wavs, asr_launches)
    refs = ["the cat sat on the mat", "a dog ran in the park", "it is 3.5 degrees",
            "hello, world", "we paid $20 for 2 books", "no", "the end.", "Dr. Smith is in"]
    (root / "refs.txt").write_text("\n".join(refs) + "\n")
    bleu = eval_bleu.score_from_files(root / "transcripts.txt", root / "refs.txt")
    assert 0.0 <= bleu.score <= 100.0
    print(f"phase 21d: eval.asr (a random wav2vec2-base CTC model, {len(letters)} letters, "
          f"written as an HF directory) over the {n_wavs} vocoded wavs on the card in "
          f"{asr_s:.2f} s (A launched {asr_launches['A']} times); first transcript "
          f"{transcripts[0][:40]!r}; eval.bleu on the transcripts: {bleu}")

    # Card against CPU on the small fp32 config, with the same vocoder.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = small_config()
    small.multimodal.image_feat_path = [str(root / "img_feat")]
    got = {dev: eval_inference_run(root, small, None, dev, 5, 30)[0] for dev in ("cpu", "cuda")}
    rel = max(abs(got["cuda"][k] - got["cpu"][k]) / max(abs(got["cpu"][k]), 1e-3) for k in keys)
    print(f"phase 21d: small fp32 config, beam 5, 30 units, eval_inference card vs CPU (TF32 "
          f"off): card {json.dumps({k: got['cuda'][k] for k in keys})}, CPU "
          f"{json.dumps({k: got['cpu'][k] for k in keys})}; max relative diff {rel:.1e} "
          f"(tol 1e-2: each metric is rounded to 3 decimals)")
    assert rel <= 1e-2, got
    torch.backends.cudnn.allow_tf32 = True


def phase_train_through_images(out_dir: Path):
    """Phase 21: 21a's full-width train step with the extractor in the
    graph, 21b card against CPU, 21c data parallelism on the card (its
    NCCL process started before 21b), 21d ``train.eval_inference`` with
    eval.asr and eval.bleu. Returns 21a's launches per ViT-B step."""
    images = fixture_images()
    parts = {}
    launches = subphase(parts, phase_vit_train, images)
    dp = subphase(parts, start_dp_on_card, out_dir)
    try:  # 21c's NCCL process trains while 21b runs
        subphase(parts, phase_vit_train_card_vs_cpu, images)
        subphase(parts, phase_dp_on_card, dp)
    finally:
        if dp["proc"].poll() is None:
            dp["proc"].kill()
            dp["proc"].wait()
    subphase(parts, phase_eval_inference, out_dir)
    print(f"phase 21: wall seconds of its parts {json.dumps(parts)}")
    return launches


# ------------------------------------------------------- phase 22: the tools

class FairseqConfigStandIn:
    """Pickled beside the weights as fairseq's omegaconf/dataclass configs
    are: a reader must keep its state without running its code."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __setstate__(self, state):
        raise AssertionError("a checkpoint reader ran this class's code")


# The port's flax-layout names → fairseq's: the inverse of
# utils/fairseq_convert.convert_mm_s2ut_checkpoint.
FAIRSEQ_FLAGSHIP_NAMES = [
    (r"^encoder/subsampler/conv(\d+)/", r"encoder.subsample.conv_layers.\1."),
    (r"^encoder/layer(\d+)/ffn/", r"encoder.transformer_layers.\1."),
    (r"^encoder/layer(\d+)/", r"encoder.transformer_layers.\1."),
    (r"^encoder/final_layer_norm/", "encoder.layer_norm."),
    (r"^fusion(\d+)/selective_attn/out_proj/", r"encoder.selective_attns.\1.proj."),
    (r"^fusion(\d+)/selective_attn/", r"encoder.selective_attns.\1."),
    (r"^fusion(\d+)/gated_fusion/gate/", r"encoder.gate_denses.\1."),
    (r"^fusion\d+/image_pre_norm/", "encoder.image_pre_norm_module."),
    (r"^decoder/embed/embed_tokens/embedding$", "decoder.embed_tokens.weight"),
    (r"^decoder/layer(\d+)/cross_attn/", r"decoder.layers.\1.encoder_attn."),
    (r"^decoder/layer(\d+)/cross_attn_layer_norm/", r"decoder.layers.\1.encoder_attn_layer_norm."),
    (r"^decoder/layer(\d+)/ffn/", r"decoder.layers.\1."),
    (r"^decoder/layer(\d+)/", r"decoder.layers.\1."),
    (r"^decoder/final_norm/", "decoder.layer_norm."),
    (r"/", "."),
]
# A bare Wav2Vec2Model's flax-layout names → fairseq HuBERT's.
FAIRSEQ_HUBERT_NAMES = [
    (r"^feature_extractor/conv(\d+)/", r"feature_extractor.conv_layers.\1.0."),
    (r"^feature_extractor/group_norm/", "feature_extractor.conv_layers.0.2."),
    (r"^feature_projection_norm/", "layer_norm."),
    (r"^feature_projection/", "post_extract_proj."),
    (r"^masked_spec_embed$", "mask_emb"),
    (r"^pos_conv/conv/", "encoder.pos_conv.0."),
    (r"^encoder_norm/", "encoder.layer_norm."),
    (r"^layer(\d+)/attention/", r"encoder.layers.\1.self_attn."),
    (r"^layer(\d+)/layer_norm/", r"encoder.layers.\1.self_attn_layer_norm."),
    (r"^layer(\d+)/intermediate_dense/", r"encoder.layers.\1.fc1."),
    (r"^layer(\d+)/output_dense/", r"encoder.layers.\1.fc2."),
    (r"^layer(\d+)/", r"encoder.layers.\1."),
    (r"/", "."),
]


def fairseq_flagship_state(model):
    """``model``'s parameters under a fairseq ``mm_s2ut_transformer``
    checkpoint's names, with the tied output projection and the buffers
    fairseq keeps beside them."""
    from mm_s2ut_torch.convert import to_flax

    sd = torch_names(to_flax(model), FAIRSEQ_FLAGSHIP_NAMES)
    sd["decoder.output_projection.weight"] = sd["decoder.embed_tokens.weight"].clone()
    sd["encoder.version"] = torch.tensor([3.0])
    sd["decoder.embed_positions._float_tensor"] = torch.zeros(1)
    return sd


def fairseq_hubert_state(model):
    """A ``Wav2Vec2Model``'s parameters under fairseq HuBERT's names, the
    positional conv as weight norm's (g, v) over dim 2, with HuBERT's label
    embeddings and final projection beside them."""
    from mm_s2ut_torch.convert import to_flax

    sd = torch_names(to_flax(model), FAIRSEQ_HUBERT_NAMES)
    w = sd.pop("encoder.pos_conv.0.weight")
    g = torch.sqrt((w ** 2).sum(dim=(0, 1), keepdim=True))
    sd["encoder.pos_conv.0.weight_g"], sd["encoder.pos_conv.0.weight_v"] = g, w / g
    sd["label_embs_concat"] = torch.zeros(504, 256)
    sd["final_proj.weight"], sd["final_proj.bias"] = torch.zeros(256, 768), torch.zeros(256)
    return sd


def save_fairseq(path: Path, sd, cfg_blob=None):
    """A fairseq training checkpoint: the weights under ``model`` and what
    fairseq pickles beside them (an ``argparse.Namespace``, a config class
    no reader can import, numpy scalars)."""
    import argparse

    import numpy as np

    torch.save({"model": sd, "args": argparse.Namespace(arch="mm_s2ut_transformer"),
                "cfg": cfg_blob if cfg_blob is not None else FairseqConfigStandIn(seed=1),
                "extra_state": {"val_loss": np.float64(3.25), "epoch": np.int64(20)},
                "optimizer_history": [{"num_updates": 40000}]}, path)


def tools_audio(root: Path, n: int, seed: int):
    """n 2-10 s utterances at 16 kHz in ``root``: every fourth (from the
    second) FLAC, every fourth (from the fourth) Ogg/Vorbis where the host
    has libvorbis, the rest wav. Returns (has_ogg, extensions used)."""
    import numpy as np

    from mm_s2ut_torch.data import flac, ogg
    from mm_s2ut_torch.data.audio_io import write_wav

    try:
        ogg._load_enc()
        has_ogg = ogg.available()
    except OSError:
        has_ogg = False
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    exts = set()
    for i in range(n):
        m = int(rng.uniform(2.0, 10.0) * 16000)
        t = np.arange(m) / 16000
        x = (0.3 * np.sin(2 * np.pi * (100 + 300 * rng.rand()) * t)
             + 0.05 * rng.randn(m)).astype(np.float32)
        if i % 4 == 1:
            ext = "flac"
            (root / f"{i + 1}.flac").write_bytes(
                flac.encode_flac((np.clip(x, -1, 1) * 32767).astype(np.int16), 16000))
        elif i % 4 == 3 and has_ogg:
            ext = "ogg"
            (root / f"{i + 1}.ogg").write_bytes(ogg.encode_ogg_bytes(x, 16000))
        else:
            ext = "wav"
            write_wav(root / f"{i + 1}.wav", x, 16000)
        exts.add(ext)
    return has_ogg, sorted(exts)


def near_ties(x: torch.Tensor, centroids: torch.Tensor, rel: float = 1e-5) -> torch.Tensor:
    """Rows of x whose two nearest centroids (float64 distances) differ by
    less than ``rel`` of the nearest."""
    d = torch.cdist(x.double(), centroids.double()) ** 2
    two = d.topk(2, dim=-1, largest=False).values
    return (two[:, 1] - two[:, 0]) < rel * two[:, 0].clamp_min(1e-12)


def device_share(fn, match) -> tuple:
    """Run ``fn`` under torch.profiler: (device ms of the kernels whose name
    contains one of ``match``, the device ms of all kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    total = sum(dev_us(e) for e in kernels)
    part = sum(dev_us(e) for e in kernels if any(m in e.key for m in match))
    return part / 1e3, total / 1e3


def flagship_model(seed: int):
    """A full-width flagship (bf16, on the card) with random weights from
    ``seed``, made decodable (``sharpened_``: hypotheses that run to their
    budget)."""
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    model = init_random_(MMS2UTModel(ModelConfig(vocab_size=1004, dtype="bfloat16",
                                                 multimodal=mm)),
                         torch.Generator().manual_seed(seed))
    return sharpened_(model).to("cuda").eval()


# ``tests/test_torch_joblib.py`` writes it: the reference's k-means format at HuBERT's width
KMEANS_FIXTURE = HERE / "tests" / "torch_kmeans" / "km100.bin"
# 22a's CPU quantize: the card's first batch of 8 utterances, padded alike: the GroupNorm
# after conv0 normalizes over the padded frames too
CPU_QUANTIZE_UTTS = 8


def phase_prep_data(root: Path):
    """Phase 22a: ``cli.prep_data`` at full width. 16 utterances of 2-10 s
    (wav, FLAC and, where the host has libvorbis, Ogg); ``manifest`` per
    extension, merged; a random HuBERT-base (12 x 768, 12 heads) written as
    an HF directory; 1000 centroids from ``kmeans_plusplus_init`` + 5 Lloyd
    steps on the card over its layer-11 features; ``quantize`` on the card
    and, over the first ``CPU_QUANTIZE_UTTS`` utterances, on the CPU (units
    equal but at near-ties, each checked); with the
    committed joblib k-means (``KMEANS_FIXTURE``) and its ``.npy`` twin
    (units equal); the same
    encoder as a fairseq HuBERT through ``convert_checkpoint --kind hubert``
    and ``quantize`` again (the same units); then ``prep-s2ut``. Timed in
    process: seconds of audio per second, A's and k-means' shares,
    ``kmeans_assign`` at 8192 x 1000 x 768. Returns A's launches in the
    card's quantize."""
    import numpy as np

    from mm_s2ut_torch.cli import convert_checkpoint, prep_data
    from mm_s2ut_torch.data.audio_io import get_waveform
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import kmeans

    # fp32 without TF32 on the card while its units are held to the CPU's.
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    has_ogg, exts = tools_audio(root / "audio", 16, seed=22)
    print(f"phase 22a: libvorbisfile/libvorbisenc on this host: {has_ogg}; audio as {exts}")
    rows = []
    for ext in exts:
        prep_data.main(["manifest", "--root", str(root / "audio"), "--ext", ext,
                        "--dest", str(root / f"src_{ext}.tsv")])
        rows += (root / f"src_{ext}.tsv").read_text().splitlines()[1:]
    rows.sort(key=lambda r: int(r.split(".")[0]))
    (root / "src.tsv").write_text("\n".join([str(root / "audio")] + rows) + "\n")
    assert len(rows) == 16, rows

    w2v_cfg = Wav2Vec2Config()  # HuBERT-base's geometry
    encoder = init_random_(Wav2Vec2Model(w2v_cfg), torch.Generator().manual_seed(22))
    write_hf_dir(root / "hubert", encoder, w2v_cfg)
    cfg, model = prep_data.load_encoder(root / "hubert")
    model = model.cuda()
    audio_root, entries = prep_data.read_manifest_entries(root / "src.tsv")
    wavs = [get_waveform(str(audio_root / e[0]), use_sample_rate=16000)[0] for e in entries]
    assert [len(w) for w in wavs] == [int(e[1]) for e in entries]
    batches = [wavs[i : i + 8] for i in range(0, 16, 8)]
    with torch.no_grad():
        feats = []
        for b in batches:
            batch, lens = prep_data.padded(b)
            h = model(torch.from_numpy(batch).cuda(), torch.from_numpy(lens).cuda())[
                "hidden_states"][11]
            feats += [h[i, : cfg.feature_lengths(int(n))] for i, n in enumerate(lens)]
        pool = torch.cat(feats)
        init = kmeans.kmeans_plusplus_init(pool, 1000, torch.Generator().manual_seed(23))
        centroids, inertia = kmeans.kmeans_fit(pool, init, 5)
    inertia = inertia.tolist()
    assert inertia[-1] <= inertia[0] and torch.isfinite(centroids).all(), inertia
    np.save(root / "km1000.npy", centroids.cpu().numpy())
    print(f"phase 22a: {pool.shape[0]} layer-11 frames; k-means++ init and 5 Lloyd steps on the "
          f"card, inertia {inertia[0]:.4g} -> {inertia[-1]:.4g}")

    quantize = ["quantize", "--manifest", str(root / "src.tsv"), "--km-path",
                str(root / "km1000.npy"), "--layer", "11", "--batch-size", "8"]
    _, card_s, launches = counted({"A": A.flash_attention}, lambda: prep_data.main(
        quantize + ["--hubert-model", str(root / "hubert"), "--dest", str(root / "units_card.txt")]))
    assert launches["A"] == 2 * 12, launches  # 12 layers, two batches
    head = (root / "src.tsv").read_text().splitlines()[: 1 + CPU_QUANTIZE_UTTS]
    (root / "src_head.tsv").write_text("\n".join(head) + "\n")
    _, cpu_s = timed(lambda: prep_data.main(
        quantize[:2] + [str(root / "src_head.tsv")] + quantize[3:]
        + ["--hubert-model", str(root / "hubert"), "--dest", str(root / "units_cpu.txt"),
           "--device", "cpu"]))
    card = (root / "units_card.txt").read_text().splitlines()
    cpu = (root / "units_cpu.txt").read_text().splitlines()
    assert len(card) == 16 and len(cpu) == CPU_QUANTIZE_UTTS
    differ = ties = frames = 0
    for i, (a, b) in enumerate(zip(card, cpu)):
        a, b = np.array(a.split(), int), np.array(b.split(), int)
        assert len(a) == len(b) == feats[i].shape[0], (i, len(a), len(b))
        frames += len(a)
        rows_differ = torch.from_numpy(a != b).cuda()
        differ += int(rows_differ.sum())
        ties += int((near_ties(feats[i], centroids) & rows_differ).sum())
    print(f"phase 22a: prep_data quantize (HF dir) on the card {card_s:.2f} s (16 utterances) "
          f"and the CPU {cpu_s:.2f} s (the first {CPU_QUANTIZE_UTTS}): {frames} frames held, "
          f"{differ} differ, {ties} of them near-ties "
          f"(the two nearest centroids within 1e-5 relative); A launched {launches['A']} times")
    assert differ == ties, (differ, ties)

    # The reference's own k-means format: an sklearn MiniBatchKMeans saved by
    # joblib.dump (zlib), read by utils/joblib_pickle.py without joblib or sklearn.
    km_bin = KMEANS_FIXTURE
    km_npy = km_bin.with_suffix(".npy")
    q_bin, bin_s = timed(lambda: kmeans.KMeansQuantizer.load(km_bin))
    q_npy, npy_s = timed(lambda: kmeans.KMeansQuantizer.load(km_npy))
    assert q_bin.n_units == 100 and torch.equal(q_bin.centroids, q_npy.centroids)
    _, bin_run_s = timed(lambda: prep_data.main(quantize[:4] + [
        str(km_bin)] + quantize[5:] + ["--hubert-model", str(root / "hubert"), "--dest",
                                       str(root / "units_km100.txt")]))
    units_bin = (root / "units_km100.txt").read_text().splitlines()
    # the .npy route in process, through the model already on the card
    units_npy = [" ".join(map(str, u)) for b in batches
                 for u in prep_data.quantize_batch(model, cfg, q_npy, b, 11)]
    assert len(units_bin) == 16 and units_bin == units_npy
    print(f"phase 22a: prep_data quantize --km-path {km_bin.name} (joblib.dump of an sklearn "
          f"MiniBatchKMeans, 100 x 768, zlib, read without joblib or sklearn) on the card "
          f"{bin_run_s:.2f} s: units equal to {km_npy.name}'s on all {len(units_bin)} lines; "
          f"KMeansQuantizer.load {bin_s * 1e3:.2f} ms ({km_bin.stat().st_size} B) against "
          f"{npy_s * 1e3:.2f} ms for the .npy")

    # The same encoder as a fairseq HuBERT checkpoint → convert → quantize.
    save_fairseq(root / "mhubert.pt", fairseq_hubert_state(encoder), cfg_blob={"model": {
        "encoder_embed_dim": 768, "encoder_attention_heads": 12, "encoder_ffn_embed_dim": 3072,
        "conv_feature_layers": "[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2",
        "extractor_mode": "default", "layer_norm_first": False, "conv_pos": 128,
        "conv_pos_groups": 16}})
    convert_checkpoint.main(["--kind", "hubert", "--fairseq-ckpt", str(root / "mhubert.pt"),
                             "--out", str(root / "mhubert")])
    prep_data.main(quantize + ["--hubert-model", str(root / "mhubert"),
                               "--dest", str(root / "units_fairseq.txt")])
    via_fairseq = (root / "units_fairseq.txt").read_text().splitlines()
    same = sum(x == y for x, y in zip(via_fairseq, card))
    print(f"phase 22a: the same encoder as a fairseq HuBERT .pt, convert_checkpoint --kind hubert, "
          f"quantize: {same}/16 lines equal the HF directory's")
    # weight norm's g·v/‖v‖ folds back to the weight within an ulp or so,
    # so a frame may move only where it is a near-tie.
    for x, y, f in zip(via_fairseq, card, feats):
        x, y = np.array(x.split(), int), np.array(y.split(), int)
        assert (near_ties(f, centroids)[torch.from_numpy(x != y).cuda()]).all()

    units = [list(map(int, l.split())) for l in card]
    prep_data.main(["prep-s2ut", "--src-manifest", str(root / "src.tsv"), "--tgt-units",
                    str(root / "units_card.txt"), "--split", "train", "--output-root",
                    str(root / "s2ut"), "--reduce-unit"])
    tsv = (root / "s2ut" / "train.tsv").read_text().splitlines()
    assert len(tsv) == 17 and int(tsv[1].split("\t")[4]) == len(kmeans.dedup_units(units[0]))

    # Timed in process on the decoded waves (no file decoding, no model
    # load), with the run's TF32 settings back.
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    quant = kmeans.KMeansQuantizer(centroids.cpu().numpy())
    prep_data.quantize_batch(model, cfg, quant, batches[0], 11)  # warm-up
    _, total_s = timed(lambda: [prep_data.quantize_batch(model, cfg, quant, b, 11)
                                for b in batches])
    km_s = 0.0
    for b in batches:
        batch, lens = prep_data.padded(b)
        with torch.no_grad():
            h = model(torch.from_numpy(batch).cuda(), torch.from_numpy(lens).cuda())[
                "hidden_states"][11]
        units, secs = timed(lambda: quant(h))
        assert units.device == h.device, units.device  # the quantizer follows its features
        km_s += secs
    a_ms, dev_ms = device_share(lambda: [prep_data.quantize_batch(model, cfg, quant, b, 11)
                                         for b in batches], ("flash_fwd_kernel",))
    audio_s = sum(len(w) for w in wavs) / 16000
    x = torch.randn(8192, 768, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    assign_ms = time_ms(lambda: kmeans.kmeans_assign(x, centroids))
    print(f"phase 22a: quantize of {audio_s:.2f} s of audio (2 batches of 8, fp32): "
          f"{total_s * 1e3:.2f} ms, {audio_s / total_s:.1f} s of audio per s; k-means "
          f"{km_s * 1e3:.3f} ms ({km_s / total_s:.1%} of the wall); profiled: A (fp32) "
          f"{a_ms:.3f} of {dev_ms:.3f} device ms ({a_ms / dev_ms:.1%}); kmeans_assign "
          f"8192 x 1000 x 768 {assign_ms:.4f} ms")
    return launches["A"]


def phase_convert_flagship(root: Path):
    """Phase 22b: ``convert_checkpoint --kind mm_s2ut`` on a full-width
    flagship (12 + 6 layers, 512-d, vocab 1004, fusion over 768-d
    features) written by ``torch.save`` in fairseq's names with fairseq's
    extras; the converted directory loaded by ``inference.load_model``
    gives the logits of the model it came from, bit for bit."""
    from mm_s2ut_torch.cli import convert_checkpoint
    from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig, save_yaml
    from mm_s2ut_torch.inference import load_model
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, image_pre_norm=True)
    cfg = ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm)
    model = init_random_(MMS2UTModel(cfg), torch.Generator().manual_seed(221))
    root.mkdir(parents=True, exist_ok=True)
    save_fairseq(root / "checkpoint_best.pt", fairseq_flagship_state(model))
    save_yaml(Config(model=cfg), root / "run.yaml")
    _, secs = timed(lambda: convert_checkpoint.main([
        "--kind", "mm_s2ut", "--fairseq-ckpt", str(root / "checkpoint_best.pt"),
        "--config", str(root / "run.yaml"), "--out", str(root / "model")]))
    _, loaded = load_model(str(root / "model"), torch.device("cuda"))
    model = model.to("cuda").eval()
    g = torch.Generator().manual_seed(222)
    feats = torch.randn(2, 400, 80, generator=g).cuda()
    lens = torch.tensor([400, 300]).cuda()
    prev = torch.randint(4, 1004, (2, 30), generator=g).cuda()
    imgs = [torch.randn(2, 577, 768, generator=g).cuda()]
    masks = [torch.zeros(2, 577, dtype=torch.bool).cuda()]
    with torch.no_grad():
        want = model(feats, lens, prev, imgs, masks)["logits"]
        got = loaded(feats, lens, prev, imgs, masks)["logits"]
    assert torch.isfinite(got).all() and torch.equal(got, want)
    n = sum(p.numel() for p in model.parameters())
    print(f"phase 22b: convert_checkpoint --kind mm_s2ut on a fairseq flagship .pt "
          f"({n / 1e6:.1f} M params, bf16, Namespace + config stub + numpy scalars beside the "
          f"weights) in {secs:.2f} s; the loaded directory's logits equal the source model's "
          f"bit for bit ({tuple(got.shape)})")
    del model, loaded
    torch.cuda.empty_cache()


def xm_checkpoints(root: Path, seeds, heads=None):
    """Small fp32 XM checkpoints (config.yaml + params.npz), one per seed,
    over phase 18's S2T corpus in ``root``. Returns (rows, dirs)."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.config import Config, GenerationConfig
    from mm_s2ut_torch.convert import to_flax
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel

    rows, symbols = s2t_corpus(root, ("test",), 6, seed=18)
    dirs = []
    for seed in seeds:
        mcfg = xm_config(dtype="float32", small=True)
        mcfg.vocab_size = len(symbols) + 4
        mcfg.multimodal.image_feat_path = [str(root / "img")]
        cfg = Config(task="multimodal_speech_to_text", model=mcfg, data=s2t_data_config(root),
                     generation=GenerationConfig(beam=5, max_len_a=0.0, max_len_b=20))
        model = sharpened_(init_random_(MMXMTransformerModel(mcfg),
                                        torch.Generator().manual_seed(seed)),
                           eos=len(symbols) + 3)
        d = root / f"model{seed}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "config.yaml").write_text(json.dumps(dataclasses.asdict(cfg)))
        np.savez(d / "params.npz", **to_flax(model))
        dirs.append(str(d))
    return rows, dirs


ENSEMBLE_UNITS = 100  # phase 22c's search budget at full width (200 before PR 26)


def phase_ensemble(root: Path):
    """Phase 22c: the logit ensemble. ``cli.generate --model_path a:b`` on
    phase 18's corpus with two small fp32 XM checkpoints, the bf16 and the
    int8 cache, on the card and with ``--device cpu`` (TF32 off): the same
    D- lines. Then two full-width flagships (bf16) over 8 utterances, beam
    10, ``ENSEMBLE_UNITS`` units, bf16 then int8 cache: ms per decode step
    of the pair against the first alone (runs alternated, each member count
    warmed up once per cache), and B, C / D, E launches per step. Returns
    the pair's launches over both caches."""
    from mm_s2ut_torch.cli import generate
    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

    rows, dirs = xm_checkpoints(root / "small", (181, 182))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kv in ("bfloat16", "int8"):
        lines = {}
        for dev in ("cuda", "cpu"):
            out = root / "small" / f"{kv}_{dev}"
            generate.main(["--model_path", ":".join(dirs), "--gen-subset", "test",
                           "--results-path", str(out), "--kv-cache-dtype", kv, "--device", dev])
            lines[dev] = [l for l in (out / "generate-test.txt").read_text().splitlines()
                          if l.startswith("D-")]
        assert len(lines["cuda"]) == len(rows) and all(l.split("\t")[2] for l in lines["cuda"])
        assert [l.split("\t")[2] for l in lines["cuda"]] == \
            [l.split("\t")[2] for l in lines["cpu"]], f"{kv}: the card's D- lines differ"
        worst = max(abs(float(a.split("\t")[1]) - float(b.split("\t")[1]))
                    for a, b in zip(lines["cuda"], lines["cpu"]))
        print(f"phase 22c: cli.generate --model_path a:b (two small XM), {kv} cache: D- lines "
              f"equal on the card and the CPU, scores max|diff| {worst:.1e}; e.g. "
              f"{lines['cuda'][0]!r}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    members = [flagship_model(222), flagship_model(223)]
    wav, lens, imgs = synthetic_batch(8, torch.Generator().manual_seed(224))
    feats, flens = waveform_frontend(wav.cuda(), lens.cuda(), FbankConfig())
    imgs, masks = [imgs.cuda()], [torch.zeros(imgs.shape[:2], dtype=torch.bool).cuda()]
    counters = {"A": A.flash_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention, "D": D.ancestry_decode_attention_i8,
                "E": D.cross_decode_attention_i8}
    L = members[0].cfg.decoder_layers
    totals = {k: 0 for k in counters}
    for kv in (None, "int8"):
        gcfg = GenerationConfig(beam=10, max_len_a=0.0, max_len_b=ENSEMBLE_UNITS,
                                kv_cache_dtype=kv)
        cross = "C" if kv is None else "E"
        result = {}
        for n in (1, 2, 2, 1):  # alternated
            gen = UnitGenerator(members[:n], gcfg)
            if n not in result:  # warm-up
                gen.generate(feats[:2, :200], flens[:2].clamp(max=200), [i[:2] for i in imgs],
                             [m[:2] for m in masks])
            with torch.no_grad():
                _, enc_s = timed(lambda: [m.encode(feats, flens, imgs, masks) for m in members[:n]])
            hyps, secs, launches = counted(counters, lambda: timed(
                lambda: gen.generate(feats, flens, imgs, masks))[0])
            torch.cuda.synchronize()
            check_xm_outputs(hyps, 8, 10, 1004)
            steps = launches[cross] // (L * n)
            assert launches[cross] == steps * L * n and steps > 0, launches
            self_k = "B" if kv is None else "D"
            assert launches[self_k] == launches[cross], launches
            result.setdefault(n, []).append((secs - enc_s) * 1e3 / steps)
            if n == 2:
                per = {k: launches[k] / steps for k in (self_k, cross)}
                for k in counters:
                    totals[k] += launches[k]
        print(f"phase 22c: flagship bf16 x 8 utts, beam 10, {ENSEMBLE_UNITS} units, "
              f"{kv or 'bf16'} cache: "
              f"{steps} steps; ms per step (search alone, encode subtracted) one model "
              f"{result[1]}, the pair {result[2]}; the pair's launches per step {per} "
              f"({L} layers x 2 members)")
    del members
    torch.cuda.empty_cache()
    return totals


def phase_vocode(root: Path):
    """Phase 22d: ``cli.vocode --dur-prediction`` (a random CodeHiFiGAN at its
    default config, in fairseq's format) on 16 unit lines of 50-150 units
    at the reference's fixed budget, 8·(longest)+16 frames, and
    ``vocode_bucketed`` (256/512/1024) on the same batch: the same sample
    counts, and the waves within 2e-2 (the batch shapes differ, so cuDNN
    may pick other algorithms: TF32 and another summation order) away from
    the bucket's last 32 frames, where the generator's convs see the
    bucket's edge instead of more padding; ms of each."""
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.cli import vocode
    from mm_s2ut_torch.data.audio_io import get_waveform
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig, vocode_bucketed

    root.mkdir(parents=True, exist_ok=True)
    vcfg = HiFiGANConfig()
    vocoder = init_random_(CodeHiFiGAN(vcfg), torch.Generator().manual_seed(225))
    torch.save(fairseq_vocoder_state(vocoder), root / "vocoder.pt")
    (root / "vocoder.json").write_text(json.dumps(dataclasses.asdict(vcfg)))
    rng = np.random.RandomState(226)
    seqs = [rng.randint(0, 1000, int(rng.randint(50, 151))).tolist() for _ in range(16)]
    (root / "test.unit").write_text("".join(" ".join(map(str, s)) + "\n" for s in seqs))
    _, cli_s = timed(lambda: vocode.main([
        "--in-code-file", str(root / "test.unit"), "--vocoder", str(root / "vocoder.pt"),
        "--vocoder-cfg", str(root / "vocoder.json"), "--results-path", str(root / "tts"),
        "--dur-prediction"]))
    L = max(len(s) for s in seqs)
    units = torch.zeros(16, L, dtype=torch.long)
    for i, s in enumerate(seqs):
        units[i, : len(s)] = torch.tensor(s)
    units, lens = units.cuda(), torch.tensor([len(s) for s in seqs]).cuda()
    vocoder = vocoder.cuda().eval()
    vocoder.max_frames = 8 * L + 16
    fixed = lambda: vocoder(units, lens)  # noqa: E731
    bucketed = lambda: vocode_bucketed(vocoder, units, lens)  # noqa: E731
    (want, want_n), (got, got_n) = fixed(), bucketed()
    fixed_ms, bucket_ms = time_ms(fixed, 5), time_ms(bucketed, 5)
    need = int(vocoder.unit_durations(units, lens).sum(1).max())
    bucket = next((b for b in (256, 512, 1024) if b >= need), 1024)
    hop = vcfg.hop_length
    assert torch.equal(got_n, want_n) and got.shape[1] == 1024 * hop
    worst_file = worst = 0.0
    for i in range(16):
        n = int(got_n[i])
        m = min(n, (bucket - 32) * hop)
        worst = max(worst, (got[i, :m] - want[i, :m]).abs().max().item())
        written, _ = get_waveform(str(root / "tts" / f"{i}_pred.wav"))
        assert len(written) == n
        worst_file = max(worst_file, float(np.abs(written[:m] - got[i, :m].cpu().numpy()).max()))
    print(f"phase 22d: cli.vocode --dur-prediction, 16 lines of 50-150 units, {cli_s:.2f} s; "
          f"batch of 16 at the fixed budget ({8 * L + 16} frames) {fixed_ms:.3f} ms, "
          f"vocode_bucketed ({need} frames needed -> the {bucket} bucket) {bucket_ms:.3f} ms; "
          f"max|diff| {worst:.2e} in memory, {worst_file:.2e} against the CLI's 16-bit files "
          f"(tol 2e-2)")
    assert worst <= 2e-2 and worst_file <= 2e-2 + 2 / 32768, (worst, worst_file)
    return root / "vocoder.pt", root / "vocoder.json"


def phase_inference_all(root: Path, vocoder_pt: Path, vocoder_json: Path):
    """Phase 22e: ``cli.inference_all``. Units mode over one subset: the
    full-width flagship (bf16, exported as config.yaml + params.npz) on 8
    utterances of 1-4 s with 577x768 image features, beam 10, 50 units,
    phase 22d's vocoder, a random wav2vec2-base CTC model as the ASR; then
    the references set to the transcripts (BLEU 100 by construction) and
    the chain rerun with ``MM_PARITY_CANARY=offset1:mod1000``: at most half
    the reference words may stay matched. Text mode on phase 22c's small XM
    checkpoint, the references set to its hypotheses, then the canary
    ``droptok``: each hypothesis loses its first word and BLEU falls. Wall
    seconds per subset."""
    import dataclasses
    import os

    import numpy as np

    from mm_s2ut_torch.cli import inference_all
    from mm_s2ut_torch.config import Config, DataConfig, GenerationConfig
    from mm_s2ut_torch.convert import to_flax
    from mm_s2ut_torch.eval.bleu import corpus_asr_bleu, score_from_files
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig, load_fairseq_checkpoint
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC

    small_corpus(root, 8, seed=227, img_dim=768, img_tokens=577, n_valid=8)
    model = flagship_model(227)
    cfg = Config(model=model.cfg, data=DataConfig(data_root=str(root), audio_root=str(root),
                                                  max_tokens=4000, num_buckets=1),
                 generation=GenerationConfig(beam=10, max_len_a=0.0, max_len_b=50))
    cfg.model.multimodal.image_feat_path = [str(root / "img_feat")]
    (root / "model").mkdir(parents=True, exist_ok=True)
    (root / "model" / "config.yaml").write_text(json.dumps(dataclasses.asdict(cfg)))
    np.savez(root / "model" / "params.npz", **to_flax(model))
    del model
    torch.cuda.empty_cache()
    letters = ["<pad>", "<s>", "</s>", "<unk>", "|"] + list("etaoinshrdlcumwfgypbvk")
    w2v = Wav2Vec2Config(vocab_size=len(letters))  # wav2vec2-base's geometry
    asr = init_random_(Wav2Vec2ForCTC(w2v), torch.Generator().manual_seed(228)).eval()
    # Random weights would mostly emit the CTC blank: rule it out, and
    # raise the word delimiter's bias by the 35% quantile of its gap to the
    # best letter on this vocoder's waves as eval.asr feeds them
    # (standardized per utterance). On the H100 each transcript still came
    # out as one letter, so BLEU is 0 even against itself: the canary check
    # below counts matched reference words instead of reading the score.
    vcfg = HiFiGANConfig.from_json(vocoder_json)
    vocoder = CodeHiFiGAN(vcfg, max_frames=400)
    vocoder.load_state_dict(load_fairseq_checkpoint(vocoder_pt, vcfg))
    with torch.no_grad():
        units = torch.randint(0, 1000, (4, 50), generator=torch.Generator().manual_seed(229))
        wave, n = vocoder.to("cuda").eval()(units.to("cuda"))
        valid = (torch.arange(wave.shape[1], device=wave.device)[None] < n[:, None]).float()
        mean = (wave * valid).sum(1, keepdim=True) / n[:, None]
        var = (((wave - mean) * valid) ** 2).sum(1, keepdim=True) / n[:, None]
        wave = (wave - mean) * torch.rsqrt(var + 1e-7) * valid
        out = asr.to("cuda")(wave, n)["logits"]
        logits = torch.cat([o[:f] for o, f in zip(out, w2v.feature_lengths(n).tolist())])
        asr.lm_head.bias[0] -= 1e4
        gap = logits[:, 5:].max(-1).values - logits[:, 4]
        asr.lm_head.bias[4] += torch.quantile(gap.float(), 0.35)
    write_hf_dir(root / "asr", asr.cpu(), w2v, letters)
    del vocoder
    refs = root / "refs"
    refs.mkdir(exist_ok=True)
    (refs / "valid.txt").write_text("placeholder\n" * 8)
    units = ["--model_path", str(root / "model"), "--subsets", "valid", "--vocoder",
             str(vocoder_pt), "--vocoder-cfg", str(vocoder_json), "--asr-model", str(root / "asr"),
             "--reference-root", str(refs), "--beam", "10"]
    _, secs = timed(lambda: inference_all.main(units + ["--results-root", str(root / "clean")]))
    out = root / "clean" / "valid"
    for name in ("generate-valid.txt", "valid.unit", "transcript.txt", "bleu.txt"):
        assert (out / name).exists(), name
    assert len(list((out / "tts").glob("*_pred.wav"))) == 8
    (refs / "valid.txt").write_text((out / "transcript.txt").read_text())
    clean = score_from_files(out / "transcript.txt", refs / "valid.txt")
    os.environ["MM_PARITY_CANARY"] = "offset1:mod1000"
    try:
        _, canary_s = timed(lambda: inference_all.main(units + ["--results-root",
                                                                str(root / "canary")]))
    finally:
        del os.environ["MM_PARITY_CANARY"]
    fault = score_from_files(root / "canary" / "valid" / "transcript.txt", refs / "valid.txt")
    assert str(fault) == (root / "canary" / "valid" / "bleu.txt").read_text().strip()
    print(f"phase 22e: inference_all --mode units over 'valid' (8 utterances, flagship bf16, "
          f"beam 10, 50 units; vocode; wav2vec2-base CTC ASR) {secs:.2f} s; transcript[0] "
          f"{(out / 'transcript.txt').read_text().splitlines()[0][:40]!r}; references := the "
          f"transcripts: {clean}; with MM_PARITY_CANARY=offset1:mod1000 ({canary_s:.2f} s): "
          f"{fault}")
    # The references are the clean run's transcripts, so every reference
    # word is matched there; the canary's shifted units must leave at most
    # half of them matched (BLEU's clipped unigram counts over the
    # reference length), and its BLEU no higher.
    assert clean.counts[0] == clean.ref_len > 0, clean
    assert fault.counts[0] <= clean.ref_len / 2 and fault.score <= clean.score, (clean, fault)

    small = root.parent / "ensemble" / "small"
    (refs / "test.txt").write_text("placeholder\n" * 6)
    text = ["--mode", "text", "--model_path", str(small / "model181"), "--subsets", "test",
            "--reference-root", str(refs), "--beam", "5"]
    _, text_s = timed(lambda: inference_all.main(text + ["--results-root", str(root / "text")]))
    hyps = (root / "text" / "test" / "hyp.txt").read_text().splitlines()
    (refs / "test.txt").write_text("".join(h + "\n" for h in hyps))
    os.environ["MM_PARITY_CANARY"] = "droptok"
    try:
        inference_all.main(text + ["--results-root", str(root / "text_canary")])
    finally:
        del os.environ["MM_PARITY_CANARY"]
    clean_t = corpus_asr_bleu(hyps, hyps, clean=False)
    dropped = (root / "text_canary" / "test" / "hyp.txt").read_text().splitlines()
    fault_t = corpus_asr_bleu(dropped, hyps, clean=False)
    assert str(fault_t) == (root / "text_canary" / "test" / "bleu.txt").read_text().strip()
    print(f"phase 22e: inference_all --mode text over 'test' (small XM, 6 utterances) "
          f"{text_s:.2f} s; hyp[0] {hyps[0]!r}; references := the hypotheses: {clean_t}; with "
          f"MM_PARITY_CANARY=droptok: {fault_t}")
    # Every hypothesis lost exactly its first word, and BLEU fell.
    assert [d.split() for d in dropped] == [h.split()[1:] for h in hyps]
    assert fault_t.score < clean_t.score, (clean_t, fault_t)


def phase_native_loader(root: Path):
    """Phase 22f: the native loader (``csrc/audioio.cpp``, built with the
    host compiler at first use) on 16 wavs of 2-10 s against the Python
    decoder: bit-equal, with each one's ms."""
    import numpy as np

    from mm_s2ut_torch import native
    from mm_s2ut_torch.data.audio_io import get_waveform, write_wav

    rng = np.random.RandomState(230)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(16):
        m = int(rng.uniform(2.0, 10.0) * 16000)
        paths.append(str(root / f"{i + 1}.wav"))
        write_wav(paths[-1], (0.3 * rng.randn(m)).astype(np.float32).clip(-1, 1), 16000)
    fresh = not native.library_path().exists()
    _, build_s = timed(native.library)
    S = 160000
    native.load_batch(paths, S)
    t0 = time.perf_counter()
    got, lens, rates = native.load_batch(paths, S)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = np.zeros((16, S), np.float32)
    for i, p in enumerate(paths):
        w = get_waveform(p)[0]
        want[i, : len(w)] = w
    python_ms = (time.perf_counter() - t0) * 1e3
    assert (rates == 16000).all() and np.array_equal(got, want)
    print(f"phase 22f: native loader {'built' if fresh else 'loaded'} in {build_s:.2f} s; "
          f"load_batch of 16 wavs ({lens.sum() / 16000:.1f} s of audio) {native_ms:.2f} ms "
          f"against the Python decoder's {python_ms:.2f} ms, bit for bit equal")


def phase_tools(out_dir: Path):
    """Phase 22: the textless pipeline's tools (22a-22f). Returns the
    launches of A (quantize's fp32 and the ensemble's bf16 encodes) and of
    B-E (the full-width ensemble's decodes)."""
    root = out_dir / "tools"
    t0 = time.perf_counter()
    parts = {}
    a_quantize = subphase(parts, phase_prep_data, root / "prep")
    subphase(parts, phase_convert_flagship, root / "convert")
    launches = subphase(parts, phase_ensemble, root / "ensemble")
    launches["A"] += a_quantize
    vocoder_files = subphase(parts, phase_vocode, root / "vocode")
    subphase(parts, phase_inference_all, root / "eval", *vocoder_files)
    subphase(parts, phase_native_loader, root / "native")
    print(f"phase 22: {time.perf_counter() - t0:.1f} s (its parts {json.dumps(parts)}); "
          f"launches {launches}")
    return launches


# ------------------------------------------------------------------ the fusion types

# Phase 23's settings: MultimodalConfig fields over selective_attention's
# flagship fusion. The merge needs the image width to equal the encoder's
# (512 at full width, 64 in the small configs).
FUSION_TYPES = {
    "multimodal_attention": {"multimodal_attention_type": "multimodal_attention"},
    "multimodal_attention merged": {"multimodal_attention_type": "multimodal_attention",
                                    "is_merge_text_img": True},
    "external_multimodal_transformer": {
        "multimodal_attention_type": "external_multimodal_transformer"},
    "bridge_tower": {"multimodal_attention_type": "bridge_tower"},
    "q_former": {"multimodal_attention_type": "selective_attention",
                 "multimodal_extractor_type": "q_former"},
}
FUSION_FULL = dict(B=4, seconds=10.0, img_tokens=577, beam=10, max_len_b=100, slab_B=8,
                   train_B=8, train_T=1000, train_Tt=100, warm_steps=2, timed_steps=5,
                   profile_step=50)


def fusion_small_configs():
    """Phase 23a's small fp32 configs (``small_config``'s 64-d, 2 + 2
    layers, modality dropout 0.5 drawn from the host's generator; the
    Bernoulli rates at 0, hash activation dropout 0.1): each fusion type
    (towers of 2 levels; the Q-Former of 8 queries, 2 + 1 layers, at an
    image width of 128) and the Q-Former over a small HuBERT encoder."""
    import dataclasses

    base = small_config()
    base = dataclasses.replace(base, dropout=0.0, attention_dropout=0.0,
                               activation_dropout=0.1)
    mm = dataclasses.replace(base.multimodal, SA_image_dropout=0.0, SA_attention_dropout=0.0,
                             external_multimodal_transformer_layers=2, num_queries=8,
                             num_query_layers=2, num_multimodal_layers=1)
    widths = {"multimodal_attention merged": 64, "q_former": 128}
    out = {}
    for name, fields in FUSION_TYPES.items():
        out[name] = dataclasses.replace(base, multimodal=dataclasses.replace(
            mm, image_feat_dim=[widths.get(name, 768)], **fields))
    out["q_former over hubert"] = dataclasses.replace(  # span masking p 0.05, attention
        # dropout 0.1 (both drawn on the host); its Bernoulli hidden dropout at 0
        out["q_former"], speech_encoder_type="hubert", w2v_args=dict(SMALL_W2V,
                                                                     hidden_dropout=0.0))
    return out


def fusion_full_config(name: str):
    """The flagship (512-d, 12 + 6 layers, 8 heads, vocab 1004, bf16) with
    one fusion type: towers of 6 levels, 8 heads, FFN 2048; the Q-Former
    of 32 queries, 4 + 2 layers at 768 (12 heads); image width 768, or
    512 for the merge."""
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig

    mm = MultimodalConfig(image_feat_dim=[512 if "merged" in name else 768],
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5,
                          **FUSION_TYPES[name])
    return ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm)


def phase_fusion_small(out_dir: Path):
    """Phase 23a: each small config on the card against the CPU from the
    same weights (TF32 off): ``UnitGenerator.generate`` on the bf16 and
    the int8 cache (beam 5, 30 units; ``sharpened_`` weights), tokens
    equal; then three ``Trainer`` steps (``card_vs_cpu``: losses within a
    relative 1e-5 and step-1 gradients within 1e-4, phase 10's
    tolerances, and the parameters' change over the steps)."""
    import copy
    import dataclasses

    import numpy as np

    from mm_s2ut_torch.config import Config, GenerationConfig, TrainConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(23)
    wav, wav_lens, _ = synthetic_batch(2, gen, 1.0, 2.0)
    feats = torch.randn(2, 300, 80, generator=gen)
    flens = torch.tensor([300, 217])
    masks = torch.zeros(2, 50, dtype=torch.bool)
    masks[1, 41:] = True
    rng = np.random.RandomState(23)
    target = rng.randint(4, 1004, (2, 12)).astype(np.int32)
    target[1, 8:] = 1
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    for i, (name, mcfg) in enumerate(fusion_small_configs().items()):
        hubert = mcfg.speech_encoder_type == "hubert"
        src, lens = (wav, wav_lens) if hubert else (feats, flens)
        imgs = torch.randn(2, 50, mcfg.multimodal.image_feat_dim[0], generator=gen)
        model = init_random_(MMS2UTModel(mcfg), torch.Generator().manual_seed(230 + i))
        cpu_model = sharpened_(copy.deepcopy(model).eval())
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        for kv in ("bfloat16", "int8"):
            gcfg = GenerationConfig(beam=5, max_len_a=0.0, max_len_b=30, kv_cache_dtype=kv)
            hyps = {dev: UnitGenerator(m, gcfg).generate(src.to(dev), lens.to(dev),
                                                         [imgs.to(dev)], [masks.to(dev)])
                    for dev, m in (("cpu", cpu_model), ("cuda", gpu_model))}
            for b in range(2):
                assert hyps["cuda"][b][0]["tokens"] == hyps["cpu"][b][0]["tokens"], (
                    f"{name}, {kv} cache, utt {b}: tokens differ")
            print(f"phase 23a: {name}, {kv} cache: card tokens equal the CPU's (lengths "
                  f"{[len(h[0]['tokens']) for h in hyps['cuda']]}, scores "
                  f"{[round(h[0]['score'], 4) for h in hyps['cuda']]} vs "
                  f"{[round(h[0]['score'], 4) for h in hyps['cpu']]})")
        batch = {"src_features": src.numpy(), "src_lengths": lens.numpy().astype(np.int32),
                 "target": target, "prev_output_tokens": rng.randint(4, 1004, (2, 12)).astype(
                     np.int32), "imgs_list": (imgs.numpy(),), "img_masks_list": (masks.numpy(),)}
        cfg = Config(model=mcfg, train=TrainConfig(lr=1e-3, warmup_updates=1,
                                                   save_dir=str(out_dir / "fusion_train")))
        launched = card_vs_cpu(name, model, cfg, batch, counters, phase="phase 23a")
        layers = mcfg.w2v_args["num_hidden_layers"] if hubert else mcfg.encoder_layers
        assert launched == {"A": 3 * layers, "H": 3 * layers}, (name, launched)
        del model, cpu_model, gpu_model
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the runs below


def checking_cross_kernels(S, L: int, dtype=torch.bfloat16):
    """A context in which the decoder's first L calls of kernel C and of E
    over a slab of S columns (one decode step's layers; any slab for S
    None) are held against their plain versions on the same inputs, TOL
    of ``dtype`` times max(1, the largest |plain|); yields the list of
    (kernel, max|err|, limit)."""
    import mm_s2ut_torch.models.layers as layers_mod
    from mm_s2ut_torch.ops import decode_attention as D

    seen = []
    c_kernel, e_kernel = layers_mod.cross_decode_attention, layers_mod.cross_decode_attention_i8

    def held(name, got, want):
        assert torch.isfinite(got).all(), f"kernel {name} at S={S}: non-finite output"
        err = (got.float() - want.float()).abs().max().item()
        lim = TOL[dtype] * max(1.0, want.float().abs().max().item())
        assert err <= lim, f"kernel {name} at S={S}: max|err| {err} > {lim}"
        seen.append((name, err, lim))

    def c_checked(q, kv, bias):
        out = c_kernel(q, kv, bias)
        if S in (None, kv.shape[2]) and sum(n == "C" for n, _, _ in seen) < L:
            held("C", out, D.cross_reference(q, kv, bias))
        return out

    def e_checked(q, kv, sk, sv, bias):
        out = e_kernel(q, kv, sk, sv, bias)
        if S in (None, kv.shape[2]) and sum(n == "E" for n, _, _ in seen) < L:
            held("E", out, D.cross_reference_i8(q, kv, sk, sv, bias))
        return out

    @contextlib.contextmanager
    def ctx():
        layers_mod.cross_decode_attention, layers_mod.cross_decode_attention_i8 = (
            c_checked, e_checked)
        try:
            yield seen
        finally:
            layers_mod.cross_decode_attention = c_kernel
            layers_mod.cross_decode_attention_i8 = e_kernel

    return ctx()


def phase_fusion_full():
    """Phase 23b: each fusion type at the flagship's width (random weights),
    4 x 10 s utterances with 577 image tokens, beam 10, max_len_b 100, the
    int8 then the bf16 cache: ms per utterance (encode and search), the
    launches of A-E over exactly that run, one decode step profiled (busy
    share, launches); for the merged type (S = 250 + 577 = 827) C and E held
    against their plain versions on the first decode step's slab, and both
    timed at that shape (B = ``slab_B`` = 8) beside SDPA. The profiled step
    runs in a search whose budget ends 3 steps after it (the slabs it reads
    are those of the full search's step). Returns the launches summed over
    the timed runs, and C's and E's records at S = 827."""
    import dataclasses

    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend
    from mm_s2ut_torch.tools.host_cost import profile_decode_step

    f = FUSION_FULL
    gen = torch.Generator().manual_seed(231)
    wav, lens, imgs768 = synthetic_batch(f["B"], gen, f["seconds"], f["seconds"])
    imgs768 = imgs768[:, : f["img_tokens"]]
    feats, flens = waveform_frontend(wav.cuda(), lens.cuda(), FbankConfig())
    masks = torch.zeros(imgs768.shape[:2], dtype=torch.bool, device="cuda")
    counters = {"A": A.flash_attention, "B": D.ancestry_decode_attention,
                "C": D.cross_decode_attention, "D": D.ancestry_decode_attention_i8,
                "E": D.cross_decode_attention_i8}
    total = {k: 0 for k in counters}
    for name in FUSION_TYPES:
        cfg = fusion_full_config(name)
        model = init_random_(MMS2UTModel(cfg), gen).to("cuda").eval()
        n_params = sum(p.numel() for p in model.parameters())
        imgs = [imgs768[..., : cfg.multimodal.image_feat_dim[0]].cuda()]
        with torch.no_grad():
            enc = model.encode(feats, flens, imgs, [masks])
        S = enc["encoder_out"].shape[1]
        T_enc = (feats.shape[1] - 1) // 2 // 2 + 1
        assert S == T_enc + (f["img_tokens"] if "merged" in name else 0), (name, S)
        assert torch.isfinite(enc["encoder_out"]).all(), name
        del enc
        for kv in ("int8", "bfloat16"):
            gcfg = GenerationConfig(beam=f["beam"], max_len_a=0.0, max_len_b=f["max_len_b"],
                                    kv_cache_dtype=kv)
            generator = UnitGenerator(model, gcfg)
            if "merged" in name:  # the first decode step's slab, held; doubles as the warm-up
                short = UnitGenerator(model, GenerationConfig(
                    beam=f["beam"], max_len_a=0.0, max_len_b=2, kv_cache_dtype=kv))
                with checking_cross_kernels(S, cfg.decoder_layers) as seen:
                    short.generate(feats, flens, imgs, [masks])
                want = "E" if kv == "int8" else "C"
                assert [n for n, _, _ in seen] == [want] * cfg.decoder_layers, seen
                print(f"phase 23b: {name}, {kv} cache: kernel {want} on the first decode step's "
                      f"slab (B={f['B']}, K={f['beam']}, S={S}) held against its plain version "
                      f"in each of {cfg.decoder_layers} layers, worst max|err| "
                      f"{max(e for _, e, _ in seen):.3e} (limit {min(l for _, _, l in seen):.3g})")
            else:
                generator.generate(feats[:2, :100], flens[:2].clamp(max=100), [imgs[0][:2]],
                                   [masks[:2]])  # warm-up
            (hyps, secs), _, counts = counted(counters, lambda: timed(lambda: generator.generate(
                feats, flens, imgs, [masks])))
            assert len(hyps) == f["B"] and all(len(h) == f["beam"] for h in hyps)
            assert all(torch.isfinite(torch.tensor(h[0]["score"])) for h in hyps)
            assert all(0 <= t < 1004 for h in hyps for t in h[0]["tokens"])
            need = "ADE" if kv == "int8" else "ABC"
            assert all(counts[k] > 0 for k in need), f"{name}, {kv}: a kernel never launched: {counts}"
            assert counts["A"] == cfg.encoder_layers, (name, counts)
            total = {k: total[k] + counts[k] for k in counts}
            # the search runs at least as many steps as its longest hypothesis
            at_step = min(f["profile_step"], max(len(h[0]["tokens"]) for h in hyps) - 3)
            if at_step >= 2:  # a search whose budget ends just after the traced step
                short = UnitGenerator(model, dataclasses.replace(gcfg, max_len_b=at_step + 3))
                prof = profile_decode_step(short, feats, flens, imgs, [masks], at_step)
                shares = {k: prof[f"{k}_share"] for k in ("B", "C", "D", "E")
                          if prof.get(f"{k}_share")}
                profiled = (f"decode step {at_step} profiled: {prof['step_ms']:.3f} ms, device "
                            f"{prof['device_ms']:.3f} ms, busy {prof['busy']}, "
                            f"{prof['launches']} launches, {prof['aten_calls']} aten calls, "
                            f"kernel shares {shares}")
            else:
                profiled = "no decode step profiled (the hypotheses end too early)"
            print(f"phase 23b: {name} ({n_params / 1e6:.1f} M params), {kv} cache, "
                  f"{f['B']} x {f['seconds']:.0f} s, S={S}: {secs * 1e3 / f['B']:.2f} ms per "
                  f"utterance (encode and search, {secs:.3f} s), unit lengths "
                  f"{[len(h[0]['tokens']) for h in hyps]}; launches {counts}; {profiled}")
        del model
        torch.cuda.empty_cache()
    # C and E alone at the merged slab's shape, beside SDPA (C) and the bound
    s, S = FLAGSHIP, 250 + 577
    record = {}
    c_args = cross_inputs(f["slab_B"], s["H"], f["beam"], s["Dh"], S, torch.bfloat16, seed=827)
    c_mask = c_args[2][:, None, None, :].to(torch.bfloat16)
    c_k, c_v = c_args[1][..., : s["Dh"]], c_args[1][..., s["Dh"]:]
    record["C"] = {**check_and_time(
        f"C B={f['slab_B']} K={f['beam']} S={S}", torch.bfloat16,
        lambda: D.cross_decode_attention(*c_args), lambda: D.cross_reference(*c_args),
        TOL[torch.bfloat16], lambda: torch.nn.functional.scaled_dot_product_attention(
            c_args[0], c_k, c_v, attn_mask=c_mask, scale=1.0), phase="phase 23b"),
        **cross_work(c_args[0], S, 2 * s["Dh"] * 2, "bf16")}
    e_args = quant_cross_inputs(f["slab_B"], s["H"], f["beam"], s["Dh"], S, torch.bfloat16,
                                seed=828)
    record["E"] = {**check_and_time(
        f"E B={f['slab_B']} K={f['beam']} S={S}", torch.bfloat16,
        lambda: D.cross_decode_attention_i8(*e_args), lambda: D.cross_reference_i8(*e_args),
        TOL[torch.bfloat16], phase="phase 23b"),
        **cross_work(e_args[0], S, 2 * s["Dh"] + 8, "bf16")}
    for k, r in record.items():
        lib = f", kernel / SDPA {r['ms'] / r['library_ms']:.3f}" if r["library_ms"] else ""
        print(f"phase 23b: {k} at S={S}: bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
              f"kernel / bound {r['ms'] / r['bound_ms']:.2f}{lib}")
    del c_args, e_args
    torch.cuda.empty_cache()
    return total, record


def phase_fusion_train():
    """Phase 23c: one full-width train step per fusion type at phase 11's
    point (B=8 x 1000 frames x 100 targets, 577 image tokens, bf16
    autocast, dropouts 0.1, Adam from ``init_parameters_``): 2 warm-up and
    5 timed steps, ms per step, A and H once per encoder layer per step.
    Returns H's launches over the timed steps."""
    import numpy as np

    from mm_s2ut_torch.config import Config, TrainConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel, init_parameters_
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    f = FUSION_FULL
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    h_launches = 0
    for i, name in enumerate(FUSION_TYPES):
        mcfg = fusion_full_config(name)
        cfg = Config(model=mcfg, train=TrainConfig(update_freq=1, warmup_updates=10,
                                                   label_smoothing=0.2))
        trainer = Trainer(cfg, init_parameters_(MMS2UTModel(mcfg),
                                                torch.Generator().manual_seed(232 + i)), "cuda")
        n_params = sum(p.numel() for p in trainer.params)
        batch = train_batch(f["train_B"], f["train_T"], f["train_Tt"],
                            img_tokens=f["img_tokens"], seed=23)
        width = mcfg.multimodal.image_feat_dim[0]
        batch["imgs_list"] = (batch["imgs_list"][0][..., :width],)
        batch = to_device(batch, torch.device("cuda"))
        torch.cuda.reset_peak_memory_stats()
        metrics = [trainer.train_batch(batch) for _ in range(f["warm_steps"])]
        (timed_m, secs), _, counts = counted(counters, lambda: timed(
            lambda: [trainer.train_batch(batch) for _ in range(f["timed_steps"])]))
        metrics += timed_m
        per_step = {k: v / f["timed_steps"] for k, v in counts.items()}
        losses = [m["loss"] / m["ntokens"] for m in metrics]
        assert all(np.isfinite(losses)), (name, losses)
        assert per_step == {"A": mcfg.encoder_layers, "H": mcfg.encoder_layers}, (name, per_step)
        h_launches += counts["H"]
        print(f"phase 23c: {name} ({n_params / 1e6:.1f} M params), B={f['train_B']} "
              f"T_src={f['train_T']} Tt={f['train_Tt']}: {secs * 1e3 / f['timed_steps']:.3f} ms "
              f"per step over {f['timed_steps']} steps ({f['warm_steps']} warm-up), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per step "
              f"{per_step}; loss per step {[round(x, 4) for x in losses]}")
        del trainer, batch
        torch.cuda.empty_cache()
    return h_launches


def phase_fusion_types(out_dir: Path):
    """Phase 23: the fusion types (23a-23c). Returns the launches of A-E in
    23b's timed runs and of H in 23c's timed steps, and C's and E's records
    at the merged slab's S = 827."""
    t0 = time.perf_counter()
    phase_fusion_small(out_dir)
    t1 = time.perf_counter()
    launches, record = phase_fusion_full()
    t2 = time.perf_counter()
    launches["H"] = phase_fusion_train()
    t3 = time.perf_counter()
    print(f"phase 23: {t3 - t0:.1f} s (23a {t1 - t0:.1f}, 23b {t2 - t1:.1f}, 23c {t3 - t2:.1f}); "
          f"launches {launches}")
    return launches, record


def phase_tp_kernels():
    """Phase 24: kernels A, G and H on a tensor-parallel rank's heads. One
    card cannot run two NCCL ranks, so the ranks' calls run one after
    another: for model = 2 and 4, each rank's slice of heads [h0, h0 + H/model),
    called with (h_total, h0) as ``MultiHeadAttention`` calls it under
    tensor parallelism, must give that slice of the whole layer's call
    bit for bit (the output, then H's dq, dk and dv), with
    attention dropout 0.1 from global batch row 3 (a data-parallel shard),
    and stay within TOL of its plain version (``reference_attention(_bwd)``
    with the same pair). Shapes: phase 11's train encoder (B=8, T=250,
    H=8, ragged key padding; A, and G causal with window 64) and the ViT's
    training shape (B=8, 577 queries over 584 keys, H=12; A), bf16 and
    fp32; H after each forward. Prints the whole call's ms and one rank's.
    Launches here are checks, not the main path's."""
    import torch.nn.functional as F

    from mm_s2ut_torch.ops import attention as A

    t0 = time.perf_counter()
    row0, rate, checked = 3, 0.1, 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        cases = []
        q, k, v, kpm = flash_inputs(8, 250, 8, 64, dtype, seed=2400)
        cases += [("A train", q, k, v, kpm, False, 0), ("G train", q, k, v, kpm, True, 64)]
        g = torch.Generator().manual_seed(2401)
        qkv = _randn((8, VIT["Tq"], 3, 12, 64), g, dtype)
        kv = [F.pad(qkv[:, :, i], (0, 0, 0, 0, 0, VIT["S"] - VIT["Tq"])).contiguous()
              for i in (1, 2)]
        vkpm = (torch.arange(VIT["S"])[None, :] >= VIT["Tq"]).expand(8, VIT["S"]).cuda()
        cases.append(("A vit", qkv[:, :, 0].contiguous(), *kv, vkpm, False, 0))
        for label, q, k, v, kpm, causal, window in cases:
            B, Tq, H, D = q.shape
            S = k.shape[1]
            scale = D ** -0.5
            bias = A.padding_bias(kpm, B, S, "cuda")
            dout = _randn(q.shape, torch.Generator().manual_seed(Tq + H), dtype)
            entry = "mm_flash_attention_causal_skip" if causal else "mm_flash_attention"

            def fwd(q, k, v, stats, h_total=None, h0=0):
                return A._launch(entry, q, k, v, bias, scale, causal, window, rate, DROP_SEED,
                                 stats, row0, h_total, h0)

            def bwd(q, k, v, stats, h_total=None, h0=0):
                return A.flash_attention_bwd(q, k, v, bias, stats, dout[:, :, h0:h0 + q.shape[2]]
                                             .contiguous(), scale, causal, window, rate,
                                             DROP_SEED, row0, h_total, h0)

            stats = torch.empty((2, B * H, Tq), dtype=torch.float32, device="cuda")
            whole = fwd(q, k, v, stats)
            whole_grads = bwd(q, k, v, stats)
            whole_ms = time_ms(lambda: fwd(q, k, v, stats), n=10)
            for model in (2, 4):
                Hl, worst = H // model, 0.0
                for m in range(model):
                    h0, sl = m * Hl, slice(m * Hl, (m + 1) * Hl)
                    qs, ks, vs = (t[:, :, sl].contiguous() for t in (q, k, v))
                    st = torch.empty((2, B * Hl, Tq), dtype=torch.float32, device="cuda")
                    out = fwd(qs, ks, vs, st, H, h0)
                    grads = bwd(qs, ks, vs, st, H, h0)
                    torch.cuda.synchronize()
                    assert torch.equal(out, whole[:, :, sl]), \
                        f"phase 24: {label} {name} model={model} rank {m}: output not the slice"
                    for what, x, y in zip(("dq", "dk", "dv"), grads[:3], whole_grads[:3]):
                        assert torch.equal(x, y[:, :, sl]), \
                            f"phase 24: {label} {name} model={model} rank {m}: {what} not the slice"
                    want = A.reference_attention(qs * scale, ks, vs, bias[:, None, None, :],
                                                 causal, window, rate, DROP_SEED, row0, H, h0)
                    want_g = A.reference_attention_bwd(
                        qs, ks, vs, bias, dout[:, :, sl].contiguous(), scale, causal, window,
                        rate, DROP_SEED, row0, H, h0)
                    err = (out.float() - want.float()).abs().max().item()
                    lim = TOL[dtype] * max(1.0, want.float().abs().max().item())
                    assert err <= lim, f"phase 24: {label} {name} model={model} rank {m}: {err}"
                    for what, x, y in zip(("dq", "dk", "dv"), grads[:3], want_g[:3]):
                        e = (x.float() - y.float()).abs().max().item()
                        lim = TOL[dtype] * max(1.0, y.float().abs().max().item())
                        assert e <= lim, \
                            f"phase 24: {label} {name} model={model} rank {m} {what}: {e}"
                        err = max(err, e)
                    worst = max(worst, err)
                    checked += 1
                rank_ms = time_ms(lambda: fwd(qs, ks, vs, st, H, h0), n=10)
                print(f"phase 24: {label} B={B} Tq={Tq} S={S} H={H} {name} dropout {rate} "
                      f"model={model}: every rank's slice equals the whole call's bit for bit "
                      f"(out, dq, dk, dv), max err vs plain {worst:.3g}; forward {whole_ms:.4f} ms "
                      f"whole, {rank_ms:.4f} ms one rank")
            del stats, whole, whole_grads
        torch.cuda.empty_cache()
    print(f"phase 24: {checked} rank slices checked in {time.perf_counter() - t0:.1f} s")


PIPE_CONFIGS = ((2, 4), (4, 8))  # phase 25: (stages, microbatches)


def phase_pipeline():
    """Phase 25: pipeline parallelism at full width on one card, the
    stages on the in-process loopback (``parallel.pipeline.Loopback``):
    the flagship (12 + 6 layers, 512-d, every dropout 0.1, Adam;
    ``tools/pipe_step.flagship``) at phase 11's point (B=8 x 1000 frames x
    100 targets), its encoder a GPipe of (S, M) = (2, 4) and (4, 8), each
    against the plain trainer from the same weights and seed.

    In fp32 (TF32 off) and in bf16 autocast (phase 11's), three
    ``Trainer.train_batch`` steps hold phase 20d's rule against the plain
    step: the losses within a relative 1e-5 and the parameters' change
    within ``UPDATE_TOL``, with phase 20d's control (the pipelined run's
    third update left out reads above it). In bf16, first, the pipelined
    encoder's output in training mode equals the same layers run over the
    same microbatches (seeds replayed, rows global) bit for bit and the
    whole batch's within TOL; after the steps, five steps each timed
    beside the plain step's five. A and H launch 12·M times in every
    pipelined step. The loopback runs the stages one after another, so the
    schedule's bubble, (S − 1)/(M + S − 1) of a stage's time on S cards,
    does not show here. Returns A's and H's launches over every pipelined
    step."""
    import copy
    import dataclasses

    from mm_s2ut_torch.config import Config
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops.dropout import DropoutRng
    from mm_s2ut_torch.parallel.pipeline import Loopback, pipe_model_
    from mm_s2ut_torch.tools.pipe_step import flagship, pipelined_state, update_error
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    t0 = time.perf_counter()
    base, tcfg, plain_model = flagship(seed=25)
    state = plain_model.state_dict()
    batch = to_device(train_batch(8, 1000, 100, seed=25), torch.device("cuda"))
    counters = {"A": A.flash_attention, "H": A.flash_attention_bwd}
    n_timed = 5
    total = {"A": 0, "H": 0}

    def trainer_for(dtype, S=0, M=0):
        mcfg = dataclasses.replace(base, dtype=dtype, pipeline_stages=S, pipeline_microbatches=M)
        model = MMS2UTModel(mcfg)
        model.load_state_dict(pipelined_state(state) if S else state)
        if S:
            pipe_model_(model, Loopback(S))
        return Trainer(Config(model=mcfg, train=tcfg), model, "cuda")

    def steps(trainer, n, M=0):
        nonlocal total
        out = []
        for _ in range(n):
            m, _, counts = counted(counters, lambda: trainer.train_batch(batch))
            if M:
                assert counts == {"A": 12 * M, "H": 12 * M}, f"phase 25: M={M}: {counts}"
                total = {k: total[k] + counts[k] for k in total}
            out.append(m["loss"])
        return out

    start = [p.detach().float().cuda() for p in plain_model.float().parameters()]

    def change(trainer):
        return {i: p.detach() - p0 for i, (p, p0) in enumerate(zip(trainer.params, start))}

    def three_steps(trainer, M=0):
        """The losses and the parameters' change after steps 2 and 3."""
        losses = steps(trainer, 2, M)
        after2 = change(trainer)
        losses += steps(trainer, 1, M)
        return losses, after2, change(trainer)

    def check(label, trainer, M, want, want_change):
        losses, after2, end = three_steps(trainer, M)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        upd, control = update_error(end, want_change), update_error(after2, want_change)
        print(f"phase 25: {label}: 3 steps, losses {[round(x, 5) for x in losses]} against the "
              f"plain {[round(x, 5) for x in want]} (max relative diff {rel:.2e}, tol 1e-5), "
              f"parameter change {upd:.2e} of the plain run's (tol {UPDATE_TOL:.0e}; control, "
              f"the third update left out: {control:.2e}); A and H {12 * M} launches each per "
              f"step")
        assert rel <= 1e-5 and upd <= UPDATE_TOL < control, (label, rel, upd, control)

    def with_rng(modules, seed):
        rng = DropoutRng(seed, "cuda")
        for mod in modules:
            if hasattr(mod, "rng"):
                mod.rng = rng
        return rng

    def forward_checks(piped, S, M):
        """The pipelined encoder's bf16 output in training mode: the
        microbatch run's bit for bit, the whole batch's within TOL."""
        enc = piped.model.encoder.train()
        captured = {}

        def capture(mod, args):
            captured.update(x=args[0], bias=args[1], seeds=mod.rng.seeds.get_state())

        hook = enc.pipe_stack.register_forward_pre_hook(capture)
        feats, lens = batch["src_features"], batch["src_lengths"]
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            with_rng(enc.modules(), 250)
            got = enc(feats, lens)["encoder_out"]
            hook.remove()
            rng = with_rng(enc.modules(), 250)
            parts = []
            for rows in torch.arange(feats.shape[0]).tensor_split(M):
                r0, r1 = int(rows[0]), int(rows[-1]) + 1
                rng.seeds.set_state(captured["seeds"])
                rng.row0 = r0
                h = captured["x"][r0:r1]
                for i in range(base.encoder_layers):
                    h = enc.pipe_stack.layers[str(i)](h, captured["bias"][r0:r1])
                parts.append(h)
            by_micro = enc.final_layer_norm(torch.cat(parts))
            with_rng(whole_encoder.modules(), 250)
            whole = whole_encoder(feats, lens)["encoder_out"]
        piped.model.set_dropout_rng(piped.rng)
        assert torch.equal(got, by_micro), f"phase 25: ({S}, {M}): not the microbatch run"
        err = (got.float() - whole.float()).abs().max().item()
        lim = TOL[torch.bfloat16] * max(1.0, whole.float().abs().max().item())
        print(f"phase 25: bf16 ({S}, {M}): the encoder's output in training equals the sequential "
              f"run over the same {M} microbatches bit for bit, the whole batch's within {err:.3g} "
              f"(tol {lim:.3g})")
        assert err <= lim, f"phase 25: ({S}, {M}) against the whole batch: {err}"

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    whole_encoder = copy.deepcopy(plain_model.encoder).cuda().train()
    for dtype in ("float32", "bfloat16"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = dtype != "float32"  # off in fp32, as phase 20d
        plain = trainer_for(dtype)
        want, _, want_change = three_steps(plain)
        if dtype == "bfloat16":
            _, plain_s = timed(lambda: steps(plain, n_timed))
            plain_ms = plain_s * 1e3 / n_timed
        del plain
        torch.cuda.empty_cache()
        for S, M in PIPE_CONFIGS:
            piped = trainer_for(dtype, S, M)
            if dtype == "bfloat16":
                forward_checks(piped, S, M)
            check(f"{dtype} GPipe (S, M) = ({S}, {M}) on the loopback, flagship B=8 T_src=1000 "
                  f"Tt=100, dropouts 0.1", piped, M, want, want_change)
            if dtype == "bfloat16":
                _, secs = timed(lambda: steps(piped, n_timed, M))
                ms = secs * 1e3 / n_timed
                print(f"phase 25: ({S}, {M}): {ms:.3f} ms per step against the plain step's "
                      f"{plain_ms:.3f} ms ({ms / plain_ms:.3f} x; {n_timed} steps each, "
                      f"CUDA-synchronised host clock, one call); the bubble on {S} cards would be "
                      f"(S-1)/(M+S-1) = {(S - 1) / (M + S - 1):.3f}; peak memory so far "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del piped
            torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 25: pipeline parallelism checked in {time.perf_counter() - t0:.1f} s")
    return total


FP32_CHECK_STEPS = (1, 50, 100, 150, 200)
# phases 26 and 26b's search budget, a flat 210 units (random weights reach no EOS):
# the profiled decode step 200 needs 203 steps, the log-prob checks none of them
FP32_SEARCH = {"max_len_a": 0.0, "max_len_b": 210}


def phase_fp32_decode():
    """Phase 26: the flagship's decode with ``model.dtype: float32`` and the
    default cache (which then holds fp32), at full width on phase 4's
    weights and 8 wavs (beam 10, ``FP32_SEARCH``'s 210 steps, CodeHiFiGAN after it), TF32
    off for PyTorch's own fp32 matmuls and convolutions (restored after):
    fp32 B and C, 3xTF32 on the tensor cores, 6 launches each per decode
    step. Then one profiled decode step 200, and the card held against the
    CPU on 2 utterances: the CPU's encoder output, the card search's 10
    hypotheses cut to 200 units as the beams' fixed paths (each beam on its
    own cache slot), fed through ``UnitDecoder.step`` on the card (kernels)
    and on the CPU (plain versions): every beam's log-probs within 1e-4 at
    steps 1, 50, 100, 150 and 200. Then phase 26b on the same model, wavs
    and paths (``phase_fp32_quant_decode``). Returns the launches of A-F
    (D, E and F: 26b's)."""
    import copy

    from mm_s2ut_torch.config import GenerationConfig
    from mm_s2ut_torch.infer.beam_search import tile_state_for_beams
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend
    from mm_s2ut_torch.tools.host_cost import profile_decode_step

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model, vocoder, gen = flagship("float32")
    n_params = sum(p.numel() for p in model.parameters())
    wav, lens, imgs = synthetic_batch(8, gen)  # phase 4's
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool)
    gcfg = GenerationConfig(beam=10, **FP32_SEARCH)
    generator = UnitGenerator(model, gcfg, max_target_positions=model.cfg.max_target_positions)
    drive(generator, vocoder, wav[:2, :16000], torch.clamp(lens[:2], max=16000), imgs[:2],
          masks[:2])  # warm-up
    steps = [0]
    inner = model.decode_step

    def step(tok, state):
        steps[0] += 1
        return inner(tok, state)

    model.decode_step = step
    try:
        (feats, flens, hyps, unit_lines, wavs, stages), total, launches = counted(
            {"A": A.flash_attention, "B": D.ancestry_decode_attention,
             "C": D.cross_decode_attention},
            lambda: drive(generator, vocoder, wav, lens, imgs, masks))
    finally:
        del model.decode_step
    check_outputs(hyps, unit_lines, wavs, 8, gcfg.beam)
    assert launches["A"] > 0, launches
    assert launches["B"] == launches["C"] == 6 * steps[0], (launches, steps)
    print(f"phase 26: flagship fp32 ({n_params / 1e6:.1f} M params), fp32 cache, 8 utts "
          f"({float(lens.sum()) / 16000:.2f} s audio), unit lengths "
          f"{[len(l.split()) for l in unit_lines]}")
    print(f"phase 26: launches {launches} over {steps[0]} decode steps (B and C 6 per step); "
          f"stages {json.dumps({k: round(v, 4) for k, v in stages.items()})}; total "
          f"{total:.3f} s; {8 / total:.3f} utt/s")
    prof = profile_decode_step(generator, feats, flens, [imgs.cuda()], [masks.cuda()], 200)
    print(f"phase 26: profiled decode step 200: {json.dumps(prof)}")
    assert prof["B_ms"] > 0 and prof["C_ms"] > 0, f"the profile names no B or C kernel: {prof}"

    # Card against CPU, teacher-forced on the card search's hypotheses of the
    # first n utterances (any fixed paths will do: both sides are fed the same).
    t_check = time.perf_counter()
    cpu_model = copy.deepcopy(model).to("cpu")
    n, K, T, L = 2, gcfg.beam, FP32_CHECK_STEPS[-1], model.cfg.decoder_layers
    with torch.no_grad():
        cfeats, cflens = waveform_frontend(wav[:n], lens[:n], FbankConfig())
        enc = cpu_model.encode(cfeats, cflens, [imgs[:n]], [masks[:n]])
    assert all(len(h[0]["tokens"]) >= T for h in hyps[:n]), [len(h[0]["tokens"]) for h in hyps]
    paths = torch.tensor([[(h[k] if len(h[k]["tokens"]) >= T else h[0])["tokens"][:T]
                           for k in range(K)] for h in hyps[:n]])  # (n, K, T)
    prev = torch.cat([torch.full((n, K, 1), 2), paths[:, :, :-1]], dim=2).reshape(n * K, T)

    def init(m, dev, kv=None):
        e = {"encoder_out": enc["encoder_out"].to(dev),
             "encoder_padding_mask": None if enc["encoder_padding_mask"] is None
             else enc["encoder_padding_mask"].to(dev)}
        return tile_state_for_beams(m.decode_init(e, T, kv_dtype=kv), K)

    @torch.no_grad()
    def forced(m, dev, kv=None, check_e=()):
        """Log-probs at FP32_CHECK_STEPS of the paths fed on cache ``kv``
        (the model's dtype for None), and the E checks of the steps in
        ``check_e``, each step's L calls against the plain version."""
        state = init(m, dev, kv)
        state["ancestry"][:] = torch.arange(K, device=dev)[None, :, None]  # beam k on slot k
        out, seen = {}, []
        for t in range(T):
            checking = (checking_cross_kernels(None, L, torch.float32) if t + 1 in check_e
                        else contextlib.nullcontext([]))
            with checking as s:
                logits, state = m.decode_step(prev[:, t:t + 1].to(dev), state)
            seen += s
            if t + 1 in FP32_CHECK_STEPS:
                out[t + 1] = torch.log_softmax(logits.float(), dim=-1).cpu()
        return out, seen

    before = (D.ancestry_decode_attention.launches, D.cross_decode_attention.launches)
    (card, _), (cpu, _) = forced(model, "cuda"), forced(cpu_model, "cpu")
    assert (D.ancestry_decode_attention.launches - before[0],
            D.cross_decode_attention.launches - before[1]) == (6 * T, 6 * T)
    errs = {t: (card[t] - cpu[t]).abs().max().item() for t in FP32_CHECK_STEPS}
    print(f"phase 26: card vs CPU, {n} utts x {K} beams teacher-forced on the card search's "
          f"hypotheses cut to {T} units: max|log-prob diff| by step {json.dumps(errs)} (tol "
          f"1e-4); {time.perf_counter() - t_check:.1f} s with the CPU's encode")
    assert all(torch.isfinite(card[t]).all() for t in FP32_CHECK_STEPS)
    assert max(errs.values()) <= 1e-4, errs
    print(f"phase 26: {time.perf_counter() - t0:.1f} s")
    launches.update(phase_fp32_quant_decode(
        generator_for=lambda kv: UnitGenerator(
            model, GenerationConfig(beam=K, kv_cache_dtype=kv, **FP32_SEARCH),
            max_target_positions=model.cfg.max_target_positions),
        run=lambda g: drive(g, vocoder, wav, lens, imgs, masks), imgs=imgs, masks=masks,
        models=(model, cpu_model), init=init, forced=forced, paths=paths))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del model, vocoder, cpu_model
    torch.cuda.empty_cache()
    return launches


def phase_fp32_quant_decode(generator_for, run, imgs, masks, models, init, forced, paths):
    """Phase 26b: phase 26's fp32 flagship and wavs with the int8 cache,
    then the int4 one (whose cross slab is int8 too): fp32 E (2xTF32 on
    the tensor cores) and D, or F, 6 launches each per decode step, outputs
    checked, one profiled decode step 200 that must name E's tensor-core
    kernel; then phase 26's teacher-forced run on the same paths, card
    against CPU, on that cache, every E call of steps 1 and 200 held against
    its plain version at fp32 TOL times max(1, |plain|); with int8 also a
    prefill of each utterance's best path (200 rows through E: 6 launches,
    each held so) and the step after it. The log-probs cannot be held to
    1e-4: D and F quantize q and the weights per row, and where the card's
    and the CPU's fp32 GEMMs put a value within an ulp of a rounding tie,
    one q8 or w8 level flips, moving that head's output by up to
    TOL_REQUANT[fp32] = 2e-3 (its comment), as a flipped level of the int8
    or int4 rows the step writes moves a column's value; the layers after it
    map a change at no gain (weights N(0, 1/fan_in), LayerNorm), a log-prob
    moves by at most twice its logit's change, and each of the L layers of
    a step may flip one: log-probs within 2·L·TOL_REQUANT[fp32] (2.4e-2 for
    L = 6), the max difference printed by step. Returns the launches of D,
    E (both caches) and F in the search runs."""
    from mm_s2ut_torch.ops import decode_attention as D
    from mm_s2ut_torch.tools.host_cost import profile_decode_step

    model, cpu_model = models
    L = model.cfg.decoder_layers
    lim = 2 * L * TOL_REQUANT[torch.float32]
    launches = {"D": 0, "E": 0, "F": 0}
    for kv, self_kernel in (("int8", "D"), ("int4", "F")):
        t0 = time.perf_counter()
        generator = generator_for(kv)
        steps = [0]
        inner = model.decode_step

        def step(tok, state):
            steps[0] += 1
            return inner(tok, state)

        model.decode_step = step
        counters = {self_kernel: {"D": D.ancestry_decode_attention_i8,
                                  "F": D.ancestry_decode_attention_i4}[self_kernel],
                    "E": D.cross_decode_attention_i8}
        try:
            (feats, flens, hyps, unit_lines, wavs, stages), total, counts = counted(
                counters, lambda: run(generator))
        finally:
            del model.decode_step
        check_outputs(hyps, unit_lines, wavs, len(hyps), generator.cfg.beam)
        assert counts[self_kernel] == counts["E"] == 6 * steps[0], (kv, counts, steps)
        for k, c in counts.items():
            launches[k] += c
        print(f"phase 26b: flagship fp32, {kv} cache, {len(hyps)} utts: unit lengths "
              f"{[len(l.split()) for l in unit_lines]}; launches {counts} over {steps[0]} decode "
              f"steps ({self_kernel} and E 6 per step); stages "
              f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}; total {total:.3f} s")
        prof = profile_decode_step(generator, feats, flens, [imgs.cuda()], [masks.cuda()], 200)
        print(f"phase 26b: {kv}: profiled decode step 200: {json.dumps(prof)}")
        assert prof[f"{self_kernel}_ms"] > 0 and prof["E_ms"] > 0, prof
        assert any(k.startswith("cross_i8_split_kernel_tf32") for k in prof["E_kernels"]), \
            f"the profile names no fp32 E tensor-core kernel: {prof['E_kernels']}"

        before = (counters[self_kernel].launches, D.cross_decode_attention_i8.launches)
        (card, seen), (cpu, _) = forced(model, "cuda", kv, E_CHECK_STEPS), forced(cpu_model, "cpu", kv)
        T = FP32_CHECK_STEPS[-1]
        assert (counters[self_kernel].launches - before[0],
                D.cross_decode_attention_i8.launches - before[1]) == (L * T, L * T)
        assert len(seen) == L * len(E_CHECK_STEPS), seen
        errs = {t: (card[t] - cpu[t]).abs().max().item() for t in FP32_CHECK_STEPS}
        assert all(torch.isfinite(card[t]).all() for t in FP32_CHECK_STEPS)
        print(f"phase 26b: {kv}: E at steps {E_CHECK_STEPS} against its plain version, max|err| "
              f"{max(e for _, e, _ in seen):.3e} (tol {TOL[torch.float32]:g} x max(1, |plain|)); "
              f"card vs CPU teacher-forced, max|log-prob diff| by step {json.dumps(errs)} "
              f"(tol {lim:g})")
        assert max(errs.values()) <= lim, (kv, errs)
        if kv == "int8":
            check_prefill(models, init, paths, lim)
        print(f"phase 26b: {kv}: {time.perf_counter() - t0:.1f} s")
    return launches


E_CHECK_STEPS = (1, 200)  # phase 26b: the decode steps whose E calls are held to the plain version


@torch.no_grad()
def check_prefill(models, init, paths, lim):
    """Phase 26b's int8 prefill: each utterance's best path, BOS and its
    first P - 1 = 199 units, through ``decode_prefill`` into a fresh
    beam-tiled int8 state (E over P rows per layer, each call held against
    its plain version at fp32 TOL), then one decode step of the last unit
    on all beams; that step's log-probs card against CPU within ``lim``,
    and the prefill's summed prefix log-probs printed."""
    from mm_s2ut_torch.ops import decode_attention as D

    model, cpu_model = models
    n, K, P = paths.shape[0], paths.shape[1], FP32_CHECK_STEPS[-1]
    L = model.cfg.decoder_layers
    prefix = torch.cat([torch.full((n, 1), 2), paths[:, 0, :P - 1]], dim=1)  # (n, P)
    last = prefix[:, -1:].repeat_interleave(K, dim=0)  # (n.K, 1): the search re-feeds it
    out = {}
    for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
        state = init(m, dev, "int8")
        before = D.cross_decode_attention_i8.launches
        checking = (checking_cross_kernels(None, L, torch.float32) if dev == "cuda"
                    else contextlib.nullcontext([]))
        with checking as seen:
            state, prefix_logp = m.decode_prefill(prefix.to(dev), P, state)
        if dev == "cuda":
            assert D.cross_decode_attention_i8.launches - before == L, "6 E launches per prefill"
            assert len(seen) == L, seen
            err = max(e for _, e, _ in seen)
        logits, _ = m.decode_step(last.to(dev), state)
        out[dev] = (prefix_logp.float().cpu(), torch.log_softmax(logits.float(), dim=-1).cpu())
    diff = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    print(f"phase 26b: int8 prefill of {P} rows x {n} utts: E's {L} calls against the plain "
          f"version max|err| {err:.3e} (tol {TOL[torch.float32]:g} x max(1, |plain|)); the step "
          f"after it card vs CPU max|log-prob diff| {diff:.3e} (tol {lim:g}); prefix log-probs "
          f"card {out['cuda'][0].tolist()} CPU {out['cpu'][0].tolist()}")
    assert torch.isfinite(out["cuda"][1]).all() and diff <= lim, diff


KERNELS = {  # name, source (of the bf16 instance the record times; the fp32_* fields time
    # the fp32 source: A's and H's, and FP32_SOURCES'), the TPU kernel it replaces
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
FP32_SOURCES = {  # B-F's fp32 instances (phase 2's fp32 fields; D and F are D's s8 passes)
    "B": "mm_s2ut_torch/csrc/decode_attention.cu", "C": "mm_s2ut_torch/csrc/decode_attention.cu",
    "D": "mm_s2ut_torch/csrc/decode_attention_q.cu", "E": "mm_s2ut_torch/csrc/decode_attention_q.cu",
    "F": "mm_s2ut_torch/csrc/decode_attention_q.cu",
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
    seconds = {}

    def run(phase, *args):
        """``phase(*args)``, its wall seconds kept under its name."""
        start = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - start, 1)
        return out

    smi = run(phase_build)
    record = run(phase_kernels)
    run(phase_xm_kernels)
    vit_fp32 = run(phase_vit_kernels)
    run(phase_long_cross)
    record.update(run(phase_causal_kernels))
    record.update(run(phase_train_kernels))
    for name, fields in vit_fp32.items():
        record[name].update(fields)
    run(phase_small_parity)
    model, vocoder, gen = flagship()
    launches = run(phase_main_path, model, vocoder, gen, Path(args.out))
    bench = run(phase_bench_point, model, vocoder, gen)
    launches.update(D=bench["D"], E=bench["E"])
    launches["F"] = run(phase_int4, model, vocoder, gen)["F"]
    del model, vocoder
    torch.cuda.empty_cache()
    run(phase_stream_parity)
    launches["G"] = run(phase_streaming)["G"]
    run(phase_entry_points, Path(args.out))
    run(phase_train_parity, Path(args.out))
    launches["H"], plain_step_ms = run(phase_train_bench)
    run(phase_train_entry, Path(args.out))
    run(phase_serving, smi)
    run(phase_small_serving)
    run(phase_config_branches, Path(args.out))
    xm_launches = run(phase_xm_path, torch.Generator().manual_seed(16))
    run(phase_xm_small_parity)
    run(phase_xm_entry, Path(args.out))
    image_launches = run(phase_image_path, Path(args.out))
    train_launches = run(phase_train_speech_encoders, Path(args.out), plain_step_ms)
    vit_train_launches = run(phase_train_through_images, Path(args.out))
    tools_launches = run(phase_tools, Path(args.out))
    fusion_launches, fusion_record = run(phase_fusion_types, Path(args.out))
    for name, fields in fusion_record.items():
        record[name].update({f"s827_{k}": v for k, v in fields.items()})
    run(phase_tp_kernels)
    pipe_launches = run(phase_pipeline)
    fp32_launches = run(phase_fp32_decode)
    print(f"chip_smoke: wall seconds per phase {json.dumps(seconds)}")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "xm_launches": xm_launches.get(k, 0),
         "image_launches": image_launches.get(k, 0),
         "train_launches": train_launches.get(k, 0),
         "vit_train_launches": vit_train_launches.get(k, 0),
         "tools_launches": tools_launches.get(k, 0),
         "fusion_launches": fusion_launches.get(k, 0),
         "pipe_launches": pipe_launches.get(k, 0), "fp32_launches": fp32_launches.get(k, 0),
         **record[k]}
        for k, (name, src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
