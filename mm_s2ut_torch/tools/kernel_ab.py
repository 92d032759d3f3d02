"""Kernels A, G and H of several source trees, timed in one process on the card.

    python -m mm_s2ut_torch.tools.kernel_ab --other DIR [DIR ...] [--reps 200]

Each ``DIR`` is another ``csrc`` directory (every ``.cu`` in it is
built; the entries are ``flash_attention.cu``'s, with
``flash_attention_bwd.cu``'s where it has kernel H), for example the
parent commit's (``git archive HEAD mm_s2ut_torch/csrc | tar -x -C
tmp/parent``, into a gitignored directory). Every tree is built
with ``ops/_build.py``'s flags. Each case launches the C entries directly
through ctypes, so no wrapper work is timed, alternating the trees in the
order given, twice (CUDA events over ``reps`` back-to-back launches
each). A and G run at rate 0 without row statistics (the inference
path's call) and, in trees that have attention dropout, at rate 0.1 with
the statistics (the training forward); H runs in trees that have it. A
tree whose flash entries predate dropout (no rate, seed and statistics
arguments) is launched with its own signature. Prints the card, one line
per case and a JSON summary.
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


class Tree:
    """One source tree's library and what its entries take."""

    def __init__(self, label: str, csrc: Path):
        self.label = label
        self.dropout = "unsigned int seed" in (csrc / "flash_attention.cu").read_text()
        self.has_bwd = (csrc / "flash_attention_bwd.cu").exists()
        self.lib = ctypes.CDLL(str(_build.build(csrc)))
        flash = list(_build._FLASH[0])
        if not self.dropout:  # before dropout: no rate, seed, stat_m, stat_l
            flash = flash[:-5] + flash[-1:]
        for name in ("mm_flash_attention", "mm_flash_attention_causal_skip"):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = flash, ctypes.c_int
        if self.has_bwd:
            fn = self.lib.mm_flash_attention_bwd
            fn.argtypes, fn.restype = _build._SIGNATURES["mm_flash_attention_bwd"]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.tools.kernel_ab")
    ap.add_argument("--other", nargs="+", required=True, help="other csrc directories")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    trees = [Tree("this", _build.CSRC)] + [Tree(d, Path(d)) for d in args.other]
    rows = []
    for entry, B, T, H, D, causal, window, rate in CASES:
        fns = {tr.label: _launcher(tr, entry, B, T, H, D, causal, window, rate)
               for tr in trees if tr.takes(entry, rate)}
        runs = {label: [] for label in fns}
        for _ in range(2):
            for label, fn in fns.items():
                runs[label].append(_time(fn, args.reps))
        ms = {label: sum(v) / len(v) for label, v in runs.items()}
        rows.append({"entry": entry, "B": B, "T": T, "H": H, "D": D, "causal": causal,
                     "window": window, "rate": rate, "ms": ms, "runs": runs})
        print(f"{entry} B={B} T={T} H={H} D={D} causal={causal} window={window} rate={rate}: "
              + ", ".join(f"{label} {m:.4f} ms {[round(x, 4) for x in runs[label]]}"
                          for label, m in ms.items()))
        torch.cuda.empty_cache()
    print(json.dumps({"kernel_ab": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
