"""Host cost around the kernels, timed on the card.

    PYTHONPATH=TREE python mm_s2ut_torch/tools/host_cost.py wrappers [--reps 200]
    PYTHONPATH=TREE python mm_s2ut_torch/tools/host_cost.py decode-step [--at-step 200] \
        [--kv bfloat16|int8|int4]
    PYTHONPATH=TREE python mm_s2ut_torch/tools/host_cost.py subsampler

``TREE`` is the directory holding the ``mm_s2ut_torch`` package to
measure: ``.`` for this checkout, or another tree unpacked into a
gitignored directory (``git archive HEAD mm_s2ut_torch | tar -x -C
tmp/parent``), so that one call can measure both with this file. Each run
prints the card and the package it measured, then one JSON line.

``wrappers``: kernels A, G and H at B = 1, T = 250 (H = 8, D = 64, bf16;
the streaming encoder's offline call) and B = 8, through their Python
wrappers (H through autograd, as training reaches it) and as raw ctypes
launches of the same C entries, CUDA events over ``reps`` back-to-back
calls each. Wrapper ms − raw ms is the host work per call that the
kernel's time does not hide. Where the package has it, the encoder's own
call (``flash_attention_biased``, the key bias built once per forward) is
timed as well. So is kernel B's wrapper at the flagship's decode shape,
fed the decoder's beam-major views (its C entry differs between trees, so
its raw time is ``tools/kernel_ab.py``'s).

``decode-step``: phase 4 of ``chip_smoke.py`` (the flagship in bf16 with
random weights, 8 synthetic 1–4 s utterances with 577×768 image features,
beam 10, max_len_a 1, max_len_b 200; ``--kv`` the cache, bf16 by default,
or int8 or int4) with one decode step, the interval between the starts of
two consecutive ``decode_step`` calls, traced by ``torch.profiler``
(:func:`profile_decode_step`): kernel time on the device, the shares of
kernels B-F (:func:`kernel_of`), and the device's busy share of the mean
wall time of the 50 unprofiled steps before it.

``subsampler``: the speech encoder's conv subsampler
(``models.layers.Conv1dSubsampler``). First, whether the card's batched
``Conv1d`` rounds a row by the batch's size: the flagship's two convs
(80 → 1024 and 512 → 1024 channels, kernel 5, stride 2) and the small
config's (80 → 32 and 16 → 128), bf16 and fp32 with TF32 on and off,
B ∈ {2, 8, 64, 128} rows of T ∈ {256, 1000} frames, each row of the
batched call against the same row alone (:func:`conv_batch_rounding`;
it calls the convs itself, so it reads the same in any tree). Then the
tree's own subsampler alone at those paths' shapes
(:func:`subsampler_alone`), then the three flagship paths that run it
(:func:`subsampler_paths`, CUDA-synchronised host clock): the encode of
128 × 1000 frames (phase 5's bench point, bf16, no grad; median of 5),
the server at bench_serving.py's point (phase 13's: 256 requests after a
warm call of 64) and the train step at B=8 × 1000 frames × 100 targets
(phase 11's: 10 steps after 3 warm-up). To compare two trees, run both
in one call, in the order parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import torch


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _time(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _flash_inputs(B, T, H=8, D=64):
    g = torch.Generator().manual_seed(T)
    q, k, v, dout = (torch.randn(B, T, H, D, generator=g).to("cuda", torch.bfloat16)
                     for _ in range(4))
    lengths = torch.clamp(T - 17 * torch.arange(B), min=1)
    kpm = (torch.arange(T)[None, :] >= lengths[:, None]).cuda()
    return q, k, v, dout, kpm


def wrapper_costs(reps: int) -> list:
    """(kernel, shape, wrapper ms, raw ms) rows for A, G, H and B."""
    from mm_s2ut_torch.ops import _build
    from mm_s2ut_torch.ops import attention as A
    from mm_s2ut_torch.ops import decode_attention as D

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for B, T in ((1, 250), (8, 250)):
        H, Dh = 8, 64
        q, k, v, dout, kpm = _flash_inputs(B, T)
        bias = torch.zeros(kpm.shape, device="cuda").masked_fill(kpm, A.NEG_INF)
        strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
        common = [B, T, T, H, Dh, *strides, Dh ** -0.5]
        out = torch.empty_like(q)
        stats = torch.empty((2, B * H, T), device="cuda")
        for name, entry, causal in (("A", "mm_flash_attention", 0),
                                    ("G", "mm_flash_attention_causal_skip", 1)):
            fwd = getattr(lib, entry)
            args = [_build.BF16, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), *common, causal, 0, 0.0, 0, None, None, stream]
            wrapped = (lambda: A.flash_attention(q, k, v, kpm)) if name == "A" else \
                (lambda: A.causal_skip_attention(q, k, v, kpm))
            raw_ms = _time(lambda: _build.check(fwd(*args), entry), reps)
            rows.append({"kernel": name, "B": B, "T": T, "wrapper_ms": _time(wrapped, reps),
                         "raw_ms": raw_ms})
            if hasattr(A, "flash_attention_biased"):  # the encoder's call: its bias built once
                rows.append({"kernel": name + " (bias built once)", "B": B, "T": T,
                             "raw_ms": raw_ms, "wrapper_ms": _time(
                                 lambda: A.flash_attention_biased(
                                     q, k, v, bias, causal=bool(causal),
                                     block_k=64 if causal else None), reps)})
        # H: the autograd backward of the forward with statistics, and the raw entry.
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        y = A.flash_attention(*leaves, kpm)
        _build.check(lib.mm_flash_attention(
            _build.BF16, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), *common, 0, 0, 0.0, 0, stats[0].data_ptr(), stats[1].data_ptr(),
            stream), "mm_flash_attention")
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.empty_like(q)
        dk, dv = (torch.empty(q.shape, device="cuda") for _ in range(2))
        dbias = torch.empty((B, H, T), device="cuda")
        bwd_args = [_build.BF16, *(t.data_ptr() for t in (q, k, v, bias, dout, stats[0], stats[1],
                                                          delta, dq, dk, dv, dbias)),
                    *common, 0, 0, 0.0, 0, stream]
        rows.append({"kernel": "H", "B": B, "T": T,
                     "wrapper_ms": _time(lambda: torch.autograd.grad(
                         y, leaves, dout, retain_graph=True), reps),
                     "raw_ms": _time(lambda: _build.check(lib.mm_flash_attention_bwd(*bwd_args),
                                                          "mm_flash_attention_bwd"), reps)})
    # B at the flagship's decode shape, as the decoder hands it its views.
    B, H, K, Dh, L, T, step = 8, 8, 10, 64, 6, 500, 300
    g = torch.Generator().manual_seed(0)
    rows_in = torch.randn((B * K, 1, 3, H, Dh), generator=g).to("cuda", torch.bfloat16)
    q, k_new, v_new = (rows_in[:, 0, i].reshape(B, K, H, Dh).transpose(1, 2) for i in range(3))
    kv = torch.randn((B, L, H, T * K, 2 * Dh), generator=g).to("cuda", torch.bfloat16)
    anc = torch.randint(0, K, (B, K, T), generator=g)
    t_idx = torch.arange(T)[None, None, :]
    flat = torch.where(t_idx < step, t_idx * K + anc, torch.full_like(anc, -1))
    flat_rep = flat.repeat_interleave(K, dim=2).to("cuda", torch.int32)
    rows.append({"kernel": "B", "B": B, "T_dec": T, "step": step, "raw_ms": None,
                 "wrapper_ms": _time(lambda: D.ancestry_decode_attention(
                     q, k_new, v_new, kv, flat_rep, L // 2), reps)})
    for r in rows:
        if r["raw_ms"] is not None:
            r["host_ms"] = r["wrapper_ms"] - r["raw_ms"]
    return rows


def kernel_of(name: str):
    """Which of the decode kernels B-F a CUDA kernel's name belongs to, in
    this tree or an older one (None for any other kernel). D and F share
    the ``ancestry_q_*`` passes, told apart by their load template argument
    (0 D's int8 rows): the fourth of the score and output passes' five
    (T, DH, SC8 or OUT8, LOAD, PROBE), the last of the merge's three;
    the stats kernel, which has none, runs for F's packed-row walk only."""
    if "ancestry_q_" in name:
        m = re.search(r"<([^<>]*)>", name)
        args = [x.strip() for x in m.group(1).split(",")] if m else []
        load = args[3] if len(args) == 5 else (args[-1] if args else None)
        return "D" if load == "0" else "F"
    if "ancestry_i8_" in name:
        return "D"
    if "ancestry_decode_q_kernel" in name:
        return "F"
    if "ancestry_" in name:
        return "B"
    if "cross_i8_" in name or "cross_decode_i8" in name:
        return "E"
    if "cross_decode_" in name:
        return "C"
    return None


def profile_decode_step(generator, feats, flens, imgs, masks, at_step: int) -> dict:
    """Run ``generator.generate`` once with decode step ``at_step`` (the
    interval from the start of that ``decode_step`` call to the start of
    the next: the model's step and the search's bookkeeping) traced by
    ``torch.profiler``. Returns the device time by kernel there, the time
    and share of each of kernels B-F, and the busy share against the mean
    wall time of the 50 unprofiled steps before it (the search reads a flag
    back every step, so each step ends synchronised)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    model = generator.model
    inner = model.decode_step
    stamps = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=at_step, warmup=1, active=1, repeat=1)) as prof:
        def step(tok, state):
            stamps.append(time.perf_counter())
            prof.step()
            return inner(tok, state)

        model.decode_step = step
        try:
            generator.generate(feats, flens, imgs, masks)
        finally:
            del model.decode_step
    if len(stamps) < at_step + 3:
        raise RuntimeError(f"the search ran {len(stamps)} steps, fewer than {at_step + 3}")
    n = min(50, at_step - 1)  # unprofiled steps just before the traced one
    wall_ms = (stamps[at_step - 1] - stamps[at_step - 1 - n]) * 1e3 / n
    return {"at_step": at_step, "step_ms": wall_ms, **_device_shares(prof, wall_ms)}


def _device_shares(prof, wall_ms: float) -> dict:
    """A trace's kernel time on the device, its busy share of ``wall_ms``,
    launches and aten calls, the time and share of each of kernels B-F,
    and the eight longest kernels."""
    events = prof.key_averages()
    kernels = [e for e in events
               if str(e.device_type).endswith("CUDA") and not e.key.startswith("ProfilerStep")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    total = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    result = {
        "device_ms": total / 1e3,
        "busy": total / 1e3 / wall_ms if total > 0 else None,
        "launches": sum(e.count for e in kernels),
        "aten_calls": sum(e.count for e in events if e.key.startswith("aten::")),
    }
    for k in "BCDEF":
        us = sum(dev_us(e) for e in kernels if kernel_of(e.key) == k)
        result[f"{k}_ms"] = us / 1e3
        result[f"{k}_share"] = us / total if total > 0 else None
    result["top"] = [(e.key[:60], e.count, round(dev_us(e) / 1e3, 4)) for e in top]
    return result


def profile_serving_chunk(server, requests, at_chunk: int) -> dict:
    """Run ``server.run(requests)`` with decode chunk ``at_chunk`` (the
    interval from the start of that chunk's dispatch to the start of the
    next: its ``chunk`` steps, then the host's wait on the previous chunk's
    report and any admission wave) traced by ``torch.profiler``. Returns
    the device time by kernel there, the shares of kernels B-F, and the
    busy share against the mean wall time of the unprofiled chunks before
    it (at most 8; the loop syncs once per chunk)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    inner = server._decode_chunk
    stamps = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=at_chunk, warmup=1, active=1, repeat=1)) as prof:
        def chunk(state):
            stamps.append(time.perf_counter())
            prof.step()
            return inner(state)

        server._decode_chunk = chunk
        try:
            results = server.run(requests)
        finally:
            del server._decode_chunk
    if len(stamps) < at_chunk + 3:
        raise RuntimeError(f"the server ran {len(stamps)} chunks, fewer than {at_chunk + 3}")
    n = min(8, at_chunk - 1)
    wall_ms = (stamps[at_chunk - 1] - stamps[at_chunk - 1 - n]) * 1e3 / n
    return {"at_chunk": at_chunk, "chunk_ms": wall_ms, "steps": server.chunk,
            "answered": len(results), **_device_shares(prof, wall_ms)}


def _init_random_(module, generator):
    """Every parameter from a seeded generator, as ``chip_smoke.init_random_``."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            fan_in = p.shape[1] * (p.shape[2] if p.ndim > 2 else 1)
            p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
    return module


def decode_step(at_step: int, kv: str = "bfloat16") -> dict:
    """Phase 4's search, with the ``kv`` cache, and one profiled step
    (:func:`profile_decode_step`)."""
    from mm_s2ut_torch.config import GenerationConfig, ModelConfig, MultimodalConfig
    from mm_s2ut_torch.infer.generator import UnitGenerator
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

    gen = torch.Generator().manual_seed(0)
    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    model = _init_random_(MMS2UTModel(ModelConfig(vocab_size=1004, dtype="bfloat16",
                                                  multimodal=mm)), gen).to("cuda").eval()
    n, sr = 8, 16000
    lens = (torch.rand(n, generator=gen) * 3 * sr + sr).long()
    wav = torch.randn(n, int(lens.max()), generator=gen) * 0.1 * \
        (torch.arange(int(lens.max()))[None, :] < lens[:, None])
    imgs = torch.randn(n, 577, 768, generator=gen).cuda()
    masks = torch.zeros(imgs.shape[:2], dtype=torch.bool, device="cuda")
    feats, flens = waveform_frontend(wav.cuda(), lens.cuda(), FbankConfig())
    generator = UnitGenerator(model, GenerationConfig(beam=10, max_len_a=1.0, max_len_b=200,
                                                      kv_cache_dtype=kv),
                              max_target_positions=model.cfg.max_target_positions)
    generator.generate(feats[:2, :100], torch.clamp(flens[:2], max=100), [imgs[:2]],
                       [masks[:2]])  # warm-up
    return profile_decode_step(generator, feats, flens, [imgs], [masks], at_step)


def conv_batch_rounding() -> list:
    """For each conv, dtype and (B, T): the rows of a B-row call that
    differ from the same row run alone, and the largest |difference|."""
    from torch import nn

    convs = {"flagship": ((80, 1024), (512, 1024)), "small": ((80, 32), (16, 128))}
    rows = []
    for name, shapes in convs.items():
        for i, (c_in, c_out) in enumerate(shapes):
            g = torch.Generator().manual_seed(i)
            conv = nn.Conv1d(c_in, c_out, 5, stride=2, padding=2)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * (5 * c_in) ** -0.5)
                conv.bias.copy_(torch.randn(c_out, generator=g) * 0.1)
            for dtype, tf32 in ((torch.bfloat16, False), (torch.float32, False),
                                (torch.float32, True)):
                torch.backends.cudnn.allow_tf32 = tf32
                c = conv.to("cuda", dtype)
                for B in (2, 8, 64, 128):
                    for T in (256, 1000):
                        x = torch.randn((B, c_in, T), generator=g).to("cuda", dtype)
                        with torch.no_grad():
                            batched = c(x)
                            alone = torch.cat([c(r) for r in x.split(1)])
                        diff = (batched.float() - alone.float()).abs().amax(dim=(1, 2))
                        rows.append({"conv": f"{name}.conv{i}", "dtype": str(dtype)[6:],
                                     "tf32": tf32, "B": B, "T": T,
                                     "rows_differ": int((diff > 0).sum()),
                                     "max_abs": float(diff.max())})
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    return rows


def _serve_requests(n: int, seed: int, enc_frames: int) -> list:
    """``chip_smoke.serve_requests``: n requests of enc_frames/5 ..
    enc_frames random fbank frames."""
    import numpy as np

    from mm_s2ut_torch.infer.serving import Request

    r = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        src = int(r.randint(enc_frames // 5, enc_frames + 1))
        reqs.append(Request(uid=i, features=r.randn(src, 80).astype(np.float32), length=src))
    return reqs


def _synced(fn, n: int = 1) -> float:
    """Median wall seconds of ``n`` calls, CUDA-synchronised around each."""
    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return sorted(secs)[n // 2]


def subsampler_alone() -> dict:
    """The tree's flagship subsampler by itself, in bf16 autocast as the
    model runs it, at the three paths' shapes: the encode's 128 × 1000
    frames and a serving wave's 8 × 1024 (no grad), the train step's
    8 × 1000 forward and backward. Median ms of 20 after 3 warm-up."""
    from mm_s2ut_torch.models.layers import Conv1dSubsampler

    sub = _init_random_(Conv1dSubsampler(80, 1024, 512), torch.Generator().manual_seed(0)).cuda()
    g = torch.Generator().manual_seed(1)
    out = {}
    for label, B, T, grad in (("encode_B128_T1000", 128, 1000, False),
                              ("serving_wave_B8_T1024", 8, 1024, False),
                              ("train_fwd_bwd_B8_T1000", 8, 1000, True)):
        x = torch.randn((B, T, 80), generator=g).cuda().requires_grad_(grad)
        lens = torch.full((B,), T, device="cuda")

        def call():
            with torch.autocast("cuda", dtype=torch.bfloat16), torch.set_grad_enabled(grad):
                y, _ = sub(x, lens)
            if grad:
                y.float().sum().backward()

        for _ in range(3):
            call()
        out[label] = {"ms": _synced(call, 20) * 1e3}
    return out


def subsampler_paths() -> dict:
    """The encode, the server and the train step of the flagship (bf16),
    with this tree's subsampler, unpatched: end-to-end wall times."""
    import numpy as np

    from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig, TrainConfig
    from mm_s2ut_torch.infer.serving import ContinuousServer
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    mcfg = ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm)
    rng = np.random.RandomState(0)
    result = {}
    model = _init_random_(MMS2UTModel(mcfg), torch.Generator().manual_seed(0)).to("cuda").eval()
    B, T = 128, 1000
    feats = torch.from_numpy(rng.randn(B, T, 80).astype(np.float32)).cuda()
    lens = torch.full((B,), T, device="cuda")
    imgs = [torch.randn(B, 577, 768, device="cuda")]
    masks = [torch.zeros(B, 577, dtype=torch.bool, device="cuda")]
    with torch.no_grad():
        model.encode(feats, lens, imgs, masks)  # warm-up
        result["encode_B128_T1000"] = {
            "ms": _synced(lambda: model.encode(feats, lens, imgs, masks), 5) * 1e3}

    srv = ContinuousServer(model, slots=64, beam_size=10, ring=256, chunk=16, enc_frames=1024,
                           kv_cache_dtype="int8", admit_width=8, max_len_a=0.2,
                           max_len_b=0)  # bench_serving.py's point
    reqs = _serve_requests(256, 2, 1024)
    srv.run(reqs[:64])
    secs = _synced(lambda: srv.run(reqs))
    result["serving_256"] = {"utt_s": len(reqs) / secs, "s": secs, "waves": srv.stats["waves"]}
    del model, srv
    torch.cuda.empty_cache()

    cfg = Config(model=mcfg, train=TrainConfig(update_freq=1, warmup_updates=10,
                                               label_smoothing=0.2))
    trainer = Trainer(cfg, _init_random_(MMS2UTModel(mcfg), torch.Generator().manual_seed(11)),
                      "cuda")
    B, T, Tt = 8, 1000, 100
    batch = to_device({
        "src_features": rng.randn(B, T, 80).astype(np.float32),
        "src_lengths": np.full((B,), T, np.int32),
        "prev_output_tokens": rng.randint(4, 1004, (B, Tt)).astype(np.int32),
        "target": rng.randint(4, 1004, (B, Tt)).astype(np.int32),
        "imgs_list": (rng.randn(B, 577, 768).astype(np.float32),),
        "img_masks_list": (np.zeros((B, 577), bool),),
    }, torch.device("cuda"))
    for _ in range(3):
        trainer.train_batch(batch)
    secs = _synced(lambda: [trainer.train_batch(batch) for _ in range(10)])
    result["train_step_B8_T1000"] = {"ms": secs * 1e2}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="host_cost.py")
    ap.add_argument("what", choices=["wrappers", "decode-step", "subsampler"])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--at-step", type=int, default=200)
    ap.add_argument("--kv", choices=["bfloat16", "int8", "int4"], default="bfloat16",
                    help="decode-step: the cache's dtype")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_cost: no CUDA device is visible", file=sys.stderr)
        return 1
    import mm_s2ut_torch

    print(_card())
    print(f"package: {mm_s2ut_torch.__file__}")
    if args.what == "wrappers":
        result = {"wrappers": wrapper_costs(args.reps)}
    elif args.what == "decode-step":
        result = {"decode_step": {"kv": args.kv, **decode_step(args.at_step, args.kv)}}
    else:
        result = {"conv_batch_rounding": conv_batch_rounding(),
                  "alone": subsampler_alone(), "paths": subsampler_paths()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
