"""Kernels A, G, H, B, C and D of several source trees, timed in one process on the card.

    python -m mm_s2ut_torch.tools.kernel_ab --other DIR [DIR ...] [--reps 200] [--only NAME ...]

Each ``DIR`` is another ``csrc`` directory (every ``.cu`` in it is
built), for example the parent commit's (``git archive HEAD
mm_s2ut_torch/csrc | tar -x -C tmp/parent``, into a gitignored
directory). Every tree is built with ``ops/_build.py``'s flags. Each case
launches the C entries directly through ctypes, so no wrapper work is
timed, alternating the trees in the order given, twice (CUDA events over
``reps`` back-to-back launches each). A and G run at rate 0 without row
statistics (the inference path's call) and, in trees that have attention
dropout, at rate 0.1 with the statistics (the training forward); H runs
in trees that have it. A tree whose flash entries predate dropout (no
rate, seed and statistics arguments), or whose kernel B predates the
split over blocks, or whose kernel C or D predates this tree's design, is
launched with its own signature. Kernel B runs at
the flagship's decode shape (phase 2 of ``chip_smoke.py``) and the bench
point's (B = 128), and in this tree also as its two alternative designs
(``this/v1``: all heads of a batch row per block, the reference's grid;
``this/v2``: the SIMT split pass, a (beam, column) pair per thread on
the FMA pipes, in place of the tensor cores' beam-rows orientation; the
port of ``scripts_dev/decode_kernel_variants.py``'s v0-v2). Kernel D
(the int8 cache) runs at the same two shapes, and in this tree also as
its alternative designs, which give v0's bits (checked and printed):
``this/v1`` the output product on bf16 tensor cores over converted int8
(the port of ``scripts_dev/int8_mxu_kernel_variants.py``'s B_qk8),
``this/v2`` both products so (``scripts_dev/int8_mxu_probe.py``'s
operand comparison and its A_base), ``this/v3`` two batch rows per block
(``scripts_dev/self_block_probe.py``); D itself is
``decode_kernel_variants.py``'s int8 v3. Kernel C runs at the decode
step's K = 10 rows (B = 8 and 128) and at the prefill's 501 rows, beside
one raw-timed ``scaled_dot_product_attention`` call on the same inputs
(``sdpa``).
``--only`` keeps the cases whose entry name contains one of the given
strings (e.g. ``--only ancestry cross``). ``--per-kernel`` also traces 50
launches of each launcher with ``torch.profiler`` and prints the mean
device time of each CUDA kernel a launch runs (e.g. D's score pass,
output pass and merge). Prints the card, one line per case and a JSON
summary.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from mm_s2ut_torch.ops import _build

SEED = 0x5EED
CASES = [  # (entry, B, T, H, D, causal, window, rate), bf16
    ("mm_flash_attention", 8, 250, 8, 64, 0, 0, 0.0),
    ("mm_flash_attention", 2, 1000, 8, 64, 0, 0, 0.0),
    ("mm_flash_attention", 128, 250, 8, 64, 0, 0, 0.0),  # the offline bench point's encoder
    ("mm_flash_attention", 8, 250, 4, 128, 0, 0, 0.0),
    ("mm_flash_attention", 8, 250, 8, 64, 1, 0, 0.0),
    ("mm_flash_attention_causal_skip", 1, 250, 8, 64, 1, 0, 0.0),
    ("mm_flash_attention_causal_skip", 8, 250, 8, 64, 1, 64, 0.0),
    ("mm_flash_attention_causal_skip", 1, 1000, 8, 64, 1, 64, 0.0),
    ("mm_flash_attention", 8, 250, 8, 64, 0, 0, 0.1),
    ("mm_flash_attention", 2, 1000, 8, 64, 0, 0, 0.1),
    ("mm_flash_attention_bwd", 8, 250, 8, 64, 0, 0, 0.0),
    ("mm_flash_attention_bwd", 8, 250, 8, 64, 0, 0, 0.1),
    ("mm_flash_attention_bwd", 2, 1000, 8, 64, 0, 0, 0.1),
    ("mm_flash_attention_bwd", 8, 250, 8, 64, 1, 64, 0.1),
    ("mm_flash_attention_bwd", 8, 250, 4, 128, 0, 0, 0.1),
]
DECODE_CASES = [  # (entry, B, H, K, Dh, L, T_dec, step or S), bf16
    ("mm_ancestry_decode_attention", 8, 8, 10, 64, 6, 500, 300),  # chip_smoke.FLAGSHIP
    ("mm_ancestry_decode_attention", 128, 8, 10, 64, 6, 201, 150),  # chip_smoke.BENCH
    ("mm_ancestry_decode_attention_i8", 8, 8, 10, 64, 6, 500, 300),  # chip_smoke.FLAGSHIP, int8
    ("mm_ancestry_decode_attention_i8", 128, 8, 10, 64, 6, 201, 150),  # chip_smoke.BENCH
    ("mm_cross_decode_attention", 8, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention", 128, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention", 1, 8, 501, 64, 0, 0, 250),  # the streaming prefill's rows
]
# Signatures of entries older trees have in place of this tree's.
_OLD_CROSS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_OLD_I8 = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
    + [ctypes.c_int64] * 10 + [ctypes.c_void_p]


class Tree:
    """One source tree's library and what its entries take."""

    def __init__(self, label: str, csrc: Path):
        self.label = label
        self.dropout = "unsigned int seed" in (csrc / "flash_attention.cu").read_text()
        self.has_bwd = (csrc / "flash_attention_bwd.cu").exists()
        self.split_b = "mm_ancestry_decode_splits" in (csrc / "decode_attention.cu").read_text()
        self.split_c = "mm_cross_decode_splits" in (csrc / "decode_attention.cu").read_text()
        self.split_d = "mm_ancestry_decode_i8_splits" in (csrc / "decode_attention_q.cu").read_text()
        self.lib = ctypes.CDLL(str(_build.build(csrc)))
        flash = list(_build._FLASH[0])
        if not self.dropout:  # before dropout: no rate, seed, stat_m, stat_l
            flash = flash[:-5] + flash[-1:]
        for name in ("mm_flash_attention", "mm_flash_attention_causal_skip"):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = flash, ctypes.c_int
        names = ["mm_flash_attention_bwd"] if self.has_bwd else []
        if self.split_b:
            names += ["mm_ancestry_decode_attention", "mm_ancestry_decode_splits"]
        if self.split_c:
            names += ["mm_cross_decode_attention", "mm_cross_decode_splits"]
        if self.split_d:
            names += ["mm_ancestry_decode_attention_i8", "mm_ancestry_decode_i8_splits",
                      "mm_ancestry_decode_i8_scratch_bytes"]
        for name in names:
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name]
        if not self.split_c:  # one block per (b.h, 16 rows), contiguous q and out
            fn = self.lib.mm_cross_decode_attention
            fn.argtypes, fn.restype = _OLD_CROSS, ctypes.c_int
        if not self.split_d:  # D and F in one entry, grid (B, H), contiguous q and out
            fn = self.lib.mm_ancestry_decode_attention_q
            fn.argtypes, fn.restype = _OLD_I8, ctypes.c_int
        if not self.split_b:  # one block per (b, h), contiguous q, no scratch
            fn = self.lib.mm_ancestry_decode_attention
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
                + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

    def takes(self, entry: str, rate: float) -> bool:
        if entry == "mm_flash_attention_bwd":
            return self.has_bwd
        return self.dropout or rate == 0.0


def _inputs(B, T, H, D):
    g = torch.Generator().manual_seed(T)
    q, k, v, dout = (torch.randn(B, T, H, D, generator=g).to("cuda", torch.bfloat16)
                     for _ in range(4))
    lengths = torch.clamp(T - 17 * torch.arange(B), min=1)
    bias = torch.where(torch.arange(T)[None, :] < lengths[:, None], 0.0, -1e9).cuda()
    return q, k, v, dout, bias


def _launcher(tree: Tree, entry, B, T, H, D, causal, window, rate):
    q, k, v, dout, bias = _inputs(B, T, H, D)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
    stream = torch.cuda.current_stream().cuda_stream
    common = [B, T, T, H, D, *strides, D ** -0.5, causal, window]
    out = torch.empty_like(q)
    stats = torch.empty((2, B * H, T), device="cuda")
    fwd_entry = "mm_flash_attention_causal_skip" if causal else "mm_flash_attention"
    fwd = getattr(tree.lib, fwd_entry if entry == "mm_flash_attention_bwd" else entry)
    with_stats = rate > 0.0 or entry == "mm_flash_attention_bwd"
    extra = ([rate, SEED if rate else 0] + ([stats[0].data_ptr(), stats[1].data_ptr()]
                                            if with_stats else [None, None])
             if tree.dropout else [])
    fwd_args = [_build.BF16, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), *common, *extra, stream]
    keep = [q, k, v, dout, bias, out, stats]  # the tensors outlive the launcher
    if entry != "mm_flash_attention_bwd":
        def launch():
            _build.check(fwd(*fwd_args), entry)
    else:
        _build.check(fwd(*fwd_args), fwd_entry)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.empty_like(q)
        dk, dv = (torch.empty(q.shape, device="cuda") for _ in range(2))
        dbias = torch.empty((B, H, T), device="cuda")
        keep += [delta, dq, dk, dv, dbias]
        ptrs = [t.data_ptr() for t in (q, k, v, bias, dout, stats[0], stats[1], delta,
                                       dq, dk, dv, dbias)]
        bwd_args = [_build.BF16, *ptrs, *common, rate, SEED if rate else 0, stream]

        def launch():
            _build.check(tree.lib.mm_flash_attention_bwd(*bwd_args), entry)
    launch.keep = keep
    return launch


def _ancestry_inputs(B, H, K, Dh, L, T, step):
    """q, k_new, v_new, a (B, L, H, T·K, 2·Dh) cache and the flat_rep of a
    random ancestry at ``step``, as ``chip_smoke.ancestry_inputs`` makes them."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, H, K, Dh), generator=g) * Dh ** -0.5
    k_new, v_new = (torch.randn((B, H, K, Dh), generator=g) for _ in range(2))
    kv = torch.randn((B, L, H, T * K, 2 * Dh), generator=g)
    ancestry = torch.randint(0, K, (B, K, T), generator=g)
    t_idx = torch.arange(T)[None, None, :]
    flat = torch.where(t_idx < step, t_idx * K + ancestry, torch.full_like(ancestry, -1))
    flat_rep = flat.repeat_interleave(K, dim=2).to("cuda", torch.int32)
    return [t.to("cuda", torch.bfloat16) for t in (q, k_new, v_new, kv)] + [flat_rep]


def _decode_launchers(trees, entry, B, H, K, Dh, L, T, step):
    """{label: launch} for kernel B (each tree, and this tree's variants) or
    C (each tree, and SDPA on the same inputs)."""
    stream = torch.cuda.current_stream().cuda_stream
    fns = {}
    if entry == "mm_cross_decode_attention":
        S = step
        g = torch.Generator().manual_seed(S)
        q = (torch.randn((B, H, K, Dh), generator=g) * Dh ** -0.5).to("cuda", torch.bfloat16)
        kv = torch.randn((B, H, S, 2 * Dh), generator=g).to("cuda", torch.bfloat16)
        lengths = torch.clamp(S - 23 * torch.arange(B), min=1)
        bias = torch.where(torch.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).cuda()
        keep = [q, kv, bias]
        for tree in trees:
            if tree.split_c:
                n_split = tree.lib.mm_cross_decode_splits(_build.BF16, B, H, K, S, Dh)
                scratch = torch.empty(max(1, B * H * n_split * K * (Dh + 2)), device="cuda")
                out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
                args = [_build.BF16, q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), B, H, K, Dh, S, n_split, *q.stride()[:3],
                        *out.stride()[:3], stream]
                keep += [scratch, out]
            else:
                out = torch.empty_like(q)
                args = [_build.BF16, q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                        B, H, K, Dh, S, stream]
                keep.append(out)
            fns[tree.label] = (lambda fn, args: lambda: _build.check(fn(*args), entry))(
                tree.lib.mm_cross_decode_attention, args)
        mask = bias[:, None, None, :].to(torch.bfloat16)
        k2, v2 = kv[..., :Dh], kv[..., Dh:]
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k2, v2, attn_mask=mask, scale=1.0)
        keep.append(mask)
    elif entry == "mm_ancestry_decode_attention_i8":
        keep = _i8_launchers(trees, fns, B, H, K, Dh, L, T, step)
    else:
        q, k_new, v_new, kv, flat_rep = _ancestry_inputs(B, H, K, Dh, L, T, step)
        keep = [q, k_new, v_new, kv, flat_rep]
        TS, layer = T * K, L // 2
        kv_strides = list(kv.stride()[:4])
        for tree in trees:
            for variant in ((0, 1, 2) if tree.split_b and tree.label == "this" else (0,)):
                label = tree.label + (f"/v{variant}" if variant else "")
                fn = tree.lib.mm_ancestry_decode_attention
                if not tree.split_b:
                    out = torch.empty_like(q)
                    args = [_build.BF16, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                            kv.data_ptr(), flat_rep.data_ptr(), out.data_ptr(), B, H, K, Dh, TS,
                            layer, *kv_strides, stream]
                else:
                    n_split = tree.lib.mm_ancestry_decode_splits(_build.BF16, B, H, TS, variant)
                    scratch = torch.empty(B * H * n_split * K * (Dh + 2), device="cuda")
                    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
                    args = [_build.BF16, variant, q.data_ptr(), k_new.data_ptr(),
                            v_new.data_ptr(), kv.data_ptr(), flat_rep.data_ptr(), out.data_ptr(),
                            scratch.data_ptr(), B, H, K, Dh, TS, layer, n_split,
                            *(st for t in (q, k_new, v_new, out) for st in t.stride()[:3]),
                            *kv_strides, stream]
                    keep.append(scratch)
                keep.append(out)
                fns[label] = (lambda fn, args: lambda: _build.check(fn(*args), entry))(fn, args)
    for fn in fns.values():
        fn.keep = keep  # the tensors outlive the launchers
    return fns


def _i8_inputs(B, H, K, Dh, L, T, step):
    """bf16 q, k_new, v_new, a random (B, L, H, T·K, 2·Dh) int8 cache with
    per-column scales, and the flat_rep of a random ancestry at ``step``,
    made on the card from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, H, K, Dh), generator=g, device="cuda") * Dh ** -0.5
    k_new, v_new = (torch.randn((B, H, K, Dh), generator=g, device="cuda") for _ in range(2))
    kv = torch.randint(-127, 128, (B, L, H, T * K, 2 * Dh), generator=g, device="cuda",
                       dtype=torch.int8)
    sk, sv = (torch.rand((B, L, H, T * K), generator=g, device="cuda") * 0.01 + 0.002
              for _ in range(2))
    ancestry = torch.randint(0, K, (B, K, T), generator=g, device="cuda")
    t_idx = torch.arange(T, device="cuda")[None, None, :]
    flat = torch.where(t_idx < step, t_idx * K + ancestry, torch.full_like(ancestry, -1))
    flat_rep = flat.repeat_interleave(K, dim=2).to(torch.int32)
    return [t.to(torch.bfloat16) for t in (q, k_new, v_new)] + [kv, sk, sv, flat_rep]


def _i8_launchers(trees, fns, B, H, K, Dh, L, T, step):
    """Kernel D of each tree into ``fns`` (this tree also as v1-v3, each
    launcher's output as its ``out``); returns the tensors to keep."""
    entry = "mm_ancestry_decode_attention_i8"
    stream = torch.cuda.current_stream().cuda_stream
    q, k_new, v_new, kv, sk, sv, flat_rep = _i8_inputs(B, H, K, Dh, L, T, step)
    keep = [q, k_new, v_new, kv, sk, sv, flat_rep]
    TS, layer = T * K, L // 2
    strides = [*kv.stride()[:4], *sk.stride()[:3], *sv.stride()[:3]]
    ptrs = [t.data_ptr() for t in (q, k_new, v_new, kv, sk, sv, flat_rep)]
    for tree in trees:
        if not tree.split_d:
            out = torch.empty_like(q)
            fn, args = tree.lib.mm_ancestry_decode_attention_q, [
                _build.BF16, 0, *ptrs, out.data_ptr(), B, H, K, Dh, TS, layer, *strides, stream]
            variants = [(tree.label, fn, args, out)]
        else:
            n_split = tree.lib.mm_ancestry_decode_i8_splits(B, H, K, TS)
            variants = []
            for v in (0, 1, 2, 3) if tree.label == "this" else (0,):
                if v == 3 and B % 2:
                    continue
                scratch = torch.empty(tree.lib.mm_ancestry_decode_i8_scratch_bytes(
                    B, H, K, Dh, TS, n_split), dtype=torch.uint8, device="cuda")
                out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
                keep.append(scratch)
                args = [_build.BF16, v, *ptrs, out.data_ptr(), scratch.data_ptr(), B, H, K, Dh,
                        TS, layer, n_split,
                        *(st for t in (q, k_new, v_new, out) for st in t.stride()[:3]),
                        *strides, stream]
                variants.append((tree.label + (f"/v{v}" if v else ""),
                                 tree.lib.mm_ancestry_decode_attention_i8, args, out))
        for label, fn, args, out in variants:
            fns[label] = (lambda fn, args: lambda: _build.check(fn(*args), entry))(fn, args)
            fns[label].out = out
            keep.append(out)
    return keep


def _time(launch, reps: int) -> float:
    launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _per_kernel(launch, reps: int = 50) -> dict:
    """{kernel name: mean device µs per launch} over ``reps`` traced launches."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            name = e.key.replace("void ", "").replace("mm::(anonymous namespace)::", "")
            times[name.split("(")[0]] = round(us / reps, 3)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.tools.kernel_ab")
    ap.add_argument("--other", nargs="+", required=True, help="other csrc directories")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--only", nargs="+", default=None, help="entry name substrings to keep")
    ap.add_argument("--per-kernel", action="store_true",
                    help="also each launch's device time by CUDA kernel (torch.profiler)")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    trees = [Tree("this", _build.CSRC)] + [Tree(d, Path(d)) for d in args.other]
    rows = []
    cases = [(dict(entry=entry, B=B, T=T, H=H, D=D, causal=causal, window=window, rate=rate),
              lambda c=(entry, B, T, H, D, causal, window, rate): {
                  tr.label: _launcher(tr, *c) for tr in trees if tr.takes(c[0], c[-1])})
             for entry, B, T, H, D, causal, window, rate in CASES]
    cases += [(dict(entry=entry, B=B, H=H, K=K, Dh=Dh,
                    **({"S": n} if L == 0 else {"T_dec": T, "step": n})),
               lambda c=(entry, B, H, K, Dh, L, T, n): _decode_launchers(trees, *c))
              for entry, B, H, K, Dh, L, T, n in DECODE_CASES]
    for case, make in cases:
        if args.only and not any(o in case["entry"] for o in args.only):
            continue
        fns = make()
        runs = {label: [] for label in fns}
        for _ in range(2):
            for label, fn in fns.items():
                runs[label].append(_time(fn, args.reps))
        ms = {label: sum(v) / len(v) for label, v in runs.items()}
        torch.cuda.synchronize()
        outs = [fn.out for label, fn in fns.items() if label.startswith("this") and hasattr(fn, "out")]
        if len(outs) > 1:
            case["variants_same_bits"] = all(torch.equal(outs[0], o) for o in outs[1:])
        rows.append({**case, "ms": ms, "runs": runs})
        print(" ".join(f"{k}={v}" for k, v in case.items()) + ": "
              + ", ".join(f"{label} {m:.4f} ms {[round(x, 4) for x in runs[label]]}"
                          for label, m in ms.items()))
        if args.per_kernel:
            rows[-1]["per_kernel_us"] = {label: _per_kernel(fn) for label, fn in fns.items()}
            for label, times in rows[-1]["per_kernel_us"].items():
                print(f"  {label}: " + "; ".join(f"{k} {v} us" for k, v in times.items()))
        del fns
        torch.cuda.empty_cache()
    print(json.dumps({"kernel_ab": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
