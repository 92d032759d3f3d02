"""Host cost around the kernels, timed on the card.

    PYTHONPATH=TREE python mm_s2ut_torch/tools/host_cost.py wrappers [--reps 200]
    PYTHONPATH=TREE python mm_s2ut_torch/tools/host_cost.py decode-step [--at-step 200] \
        [--kv bfloat16|int8|int4]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="host_cost.py")
    ap.add_argument("what", choices=["wrappers", "decode-step"])
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
    else:
        result = {"decode_step": {"kv": args.kv, **decode_step(args.at_step, args.kv)}}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
