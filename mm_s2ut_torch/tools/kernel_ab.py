"""Kernels A-H of several source trees, and the ports of the TPU probes, timed in one process on the card.

    python -m mm_s2ut_torch.tools.kernel_ab --other DIR [DIR ...] [--reps 200] [--only NAME ...]
        [--per-kernel] [--fixed-work]

Each ``DIR`` is another ``csrc`` directory (every ``.cu`` in it is
built), for example the parent commit's (``git archive HEAD
mm_s2ut_torch/csrc | tar -x -C tmp/parent``, into a gitignored
directory). Every tree is built with ``ops/_build.py``'s flags. Each case
launches the C entries directly through ctypes, so no wrapper work is
timed, alternating the trees in the order given, twice (CUDA events over
``reps`` back-to-back launches each). A and G run in bf16 and, in the
``float32`` cases (A at the ViT's Tq = 577 over S = 584, at B = 8, T = 499
and at B = 128, T = 250; G at B = 8, T = 250, window 64; H at the ViT's
training shape and at T = 499; B at the decode shapes below, with this
tree's ``this/v1``; C at B = 8 and 128, the prefill's 501 rows, which take
A, and 16 rows over a 4000-key slab, split 16 ways; E at C's shapes,
beside ``this/C``), in fp32. A and G run
at rate 0 without row statistics (the inference path's call) and, in
trees that have attention dropout, at rate 0.1 with the statistics (the
training forward); H runs in trees that have it. A tree whose flash entries predate dropout (no
rate, seed and statistics arguments), or whose kernel B predates the
split over blocks, or whose kernel C, D, E or F predates this tree's
design, is launched with its own signature. Kernel B runs at
the flagship's decode shape (phase 2 of ``chip_smoke.py``) and the bench
point's (B = 128), and in this tree also as its alternative designs
(``this/v1``: all heads of a batch row per block, the reference's grid;
``this/v2``: the SIMT split pass, a (beam, column) pair per thread on
the FMA pipes, in place of the tensor cores' beam-rows orientation; the
port of ``scripts_dev/decode_kernel_variants.py``'s v0-v2; ``this/v3``:
one block per (b, h) over the whole slab with all its scores in shared
memory, the port of ``scripts_dev/interleave_probe.py``). Kernel D
(the int8 cache) runs at the same two shapes, and in this tree also as
its alternative designs, which give v0's bits (checked and printed):
``this/v1`` the output product on bf16 tensor cores over converted int8
(the port of ``scripts_dev/int8_mxu_kernel_variants.py``'s B_qk8),
``this/v2`` both products so (``scripts_dev/int8_mxu_probe.py``'s
operand comparison and its A_base), ``this/v3`` two batch rows per block
(``scripts_dev/self_block_probe.py``); D itself is
``decode_kernel_variants.py``'s int8 v3. Kernel F (the int4 cache) runs
at the same two shapes, with ``this/D``, kernel D on the unpacked cache,
whose bits F's must equal, and F's designs (the ports of
``scripts_dev/int4_unpack_variants.py`` and ``int4_support_probe.py:36``):
``this/v1`` the unpack through int32 shifts, ``this/v2`` both products on
bf16 tensor cores, ``this/v3`` the gather by packed row. Kernel C runs at
the decode step's K = 10 rows (B = 8 and 128) and at the prefill's 501
rows, beside one raw-timed ``scaled_dot_product_attention`` call on the
same inputs (``sdpa``); kernel E at the same shapes, beside this tree's C
on a bf16 slab of the same values (``this/C``), and as ``this/v1``, two
batch rows per block (``scripts_dev/cross_block_probe.py``). ``dense``:
one dense attention over every column of an int8 slab and of the same
values nibble-packed (``int4_support_probe.py:73``: does half the bytes
take half the time?). ``write``: the decode step's cache write as one
kernel (``scripts_dev/cache_write_fix_probe.py``, ``write_kernel_probe.py``)
against the decoder's plain write, bf16, int8 and both int4 halves, the
written bytes checked equal.
``--only`` keeps the cases whose entry name contains one of the given
strings or whose kind is one of them (``i4``, ``cross_i8``, ``dense``,
``write``, ``float32``; e.g. ``--only ancestry cross``). ``--per-kernel`` also traces 50
launches of each launcher with ``torch.profiler`` and prints the mean
device time of each CUDA kernel a launch runs (e.g. D's score pass,
output pass and merge). ``--fixed-work`` adds D's and F's passes with
parts left out (``this/fixed1`` no tiles, ``/fixed3`` no compaction
either, ``/fixed7`` no ws and w8 table either; their output is not
valid), which, with ``--per-kernel``, splits each pass's time. Prints the
card, one line per case and a JSON summary.
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
FP32_CASES = [  # (entry, B, T, S, H, D, causal, window, rate), fp32 (3xTF32 on the tensor cores)
    ("mm_flash_attention", 16, 577, 584, 12, 64, 0, 0, 0.0),  # the ViT-B forward (chip_smoke.VIT)
    ("mm_flash_attention", 8, 499, 499, 12, 64, 0, 0, 0.0),  # HuBERT-base / wav2vec2-base frames
    ("mm_flash_attention", 128, 250, 250, 8, 64, 0, 0, 0.0),  # the offline bench point's encoder
    ("mm_flash_attention_causal_skip", 8, 250, 250, 8, 64, 1, 64, 0.0),
    ("mm_flash_attention_bwd", 8, 577, 584, 12, 64, 0, 0, 0.0),  # the ViT's training shape
    ("mm_flash_attention_bwd", 8, 499, 499, 12, 64, 0, 0, 0.0),
]
DECODE_CASES = [  # (entry, B, H, K, Dh, L, T_dec, step or S), bf16
    ("mm_ancestry_decode_attention", 8, 8, 10, 64, 6, 500, 300),  # chip_smoke.FLAGSHIP
    ("mm_ancestry_decode_attention", 128, 8, 10, 64, 6, 201, 150),  # chip_smoke.BENCH
    ("mm_ancestry_decode_attention_i8", 8, 8, 10, 64, 6, 500, 300),  # chip_smoke.FLAGSHIP, int8
    ("mm_ancestry_decode_attention_i8", 128, 8, 10, 64, 6, 201, 150),  # chip_smoke.BENCH
    ("mm_cross_decode_attention", 8, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention", 128, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention", 1, 8, 501, 64, 0, 0, 250),  # the streaming prefill's rows
    ("mm_ancestry_decode_attention_i4", 8, 8, 10, 64, 6, 500, 300),  # chip_smoke.FLAGSHIP, int4
    ("mm_ancestry_decode_attention_i4", 128, 8, 10, 64, 6, 201, 150),  # chip_smoke.BENCH
    ("mm_cross_decode_attention_i8", 8, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention_i8", 128, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention_i8", 1, 8, 501, 64, 0, 0, 250),
    ("mm_dense_attention_probe", 128, 8, 10, 64, 0, 0, 2010),  # int4_support_probe.py's shape
]
FP32_DECODE_CASES = [  # DECODE_CASES' fields, fp32 (B and C in 3xTF32 on the tensor cores, E in 2xTF32)
    ("mm_ancestry_decode_attention", 8, 8, 10, 64, 6, 500, 300),
    ("mm_ancestry_decode_attention", 128, 8, 10, 64, 6, 201, 150),
    ("mm_cross_decode_attention", 8, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention", 128, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention", 1, 8, 501, 64, 0, 0, 250),  # the prefill's rows: A in fp32
    ("mm_cross_decode_attention", 2, 8, 16, 64, 0, 0, 4000),  # a long slab, 16 splits
    ("mm_cross_decode_attention_i8", 8, 8, 10, 64, 0, 0, 250),  # E: 2xTF32 on the tensor cores
    ("mm_cross_decode_attention_i8", 128, 8, 10, 64, 0, 0, 250),
    ("mm_cross_decode_attention_i8", 1, 8, 501, 64, 0, 0, 250),
    ("mm_cross_decode_attention_i8", 2, 8, 16, 64, 0, 0, 4000),
]
WRITE_CASES = [  # (cache, B, K, cap, L, H, Dh, step)
    ("bfloat16", 32, 5, 201, 6, 8, 64, 100),  # cache_write_fix_probe.py's shape
    ("int8", 128, 10, 201, 6, 8, 64, 150),  # write_kernel_probe.py's
    ("int4", 128, 10, 201, 6, 8, 64, 20),  # the low half of the packed rows
    ("int4", 128, 10, 201, 6, 8, 64, 150),  # the high half
]
# H100 SXM (NVIDIA's data sheet, as chip_smoke.py's): HBM bytes/s, dense bf16 op/s.
HBM, PEAK_BF16 = 3.35e12, 989e12


def dense_bound_us(B, H, K, Dh, S, packed):
    """Least time of the dense probe: its slab (S columns of 2.Dh int8
    values, half the bytes packed), q and out in bf16 each moved once over
    HBM, or its two bf16 products over the peak, whichever is longer."""
    nbytes = B * H * (S // 2 if packed else S) * 2 * Dh + 2 * B * H * K * Dh * 2
    return max(nbytes / HBM, 4 * B * H * K * S * Dh / PEAK_BF16) * 1e6


def write_bound_us(cache, B, K, L, H, Dh):
    """Least time of the raw cache-write launch: the step's B.L.H.K rows
    read once and written once (2.Dh values each, bf16 or int8), the int4
    cache's packed rows read too (the nibble merge), and the quantized
    caches' sk and sv (fp32) read and written, over HBM."""
    per_row = {"bfloat16": 2 * 2 * Dh * 2, "int8": 2 * 2 * Dh + 16, "int4": 3 * 2 * Dh + 16}
    return B * L * H * K * per_row[cache] / HBM * 1e6


KINDS = {"mm_ancestry_decode_attention_i4": "i4", "mm_cross_decode_attention_i8": "cross_i8",
         "mm_dense_attention_probe": "dense", "mm_cache_write": "write"}
# Signatures of entries older trees have in place of this tree's.
_OLD_CROSS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_OLD_I8 = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
    + [ctypes.c_int64] * 10 + [ctypes.c_void_p]
_OLD_I4 = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 10 \
    + [ctypes.c_void_p]
_OLD_CROSS_I8 = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


class Tree:
    """One source tree's library and what its entries take."""

    def __init__(self, label: str, csrc: Path):
        self.label = label
        flash_src = (csrc / "flash_attention.cu").read_text()
        self.dropout = "unsigned int seed" in flash_src
        self.bh0 = "unsigned int bh0" in flash_src  # the dropout row offset (data parallelism)
        self.heads = "unsigned int h_total" in flash_src  # the hash's global heads (tensor par.)
        self.has_bwd = (csrc / "flash_attention_bwd.cu").exists()
        self.split_b = "mm_ancestry_decode_splits" in (csrc / "decode_attention.cu").read_text()
        self.split_c = "mm_cross_decode_splits" in (csrc / "decode_attention.cu").read_text()
        q_src = (csrc / "decode_attention_q.cu").read_text()
        self.split_d = "mm_ancestry_decode_i8_splits" in q_src
        self.split_f = "mm_ancestry_decode_i4_splits" in q_src
        self.split_e = "mm_cross_decode_i8_splits" in q_src
        # trees before the split rule lost its unused dtype argument
        self.e_split_dtype = "mm_cross_decode_i8_splits(int dtype" in q_src
        self.lib = ctypes.CDLL(str(_build.build(csrc)))
        flash = list(_build._FLASH[0])
        if not self.heads:
            del flash[-5:-3]
        if not self.bh0:
            del flash[-4]
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
        if self.split_f:
            names += ["mm_ancestry_decode_attention_i4", "mm_ancestry_decode_i4_splits",
                      "mm_ancestry_decode_i4_scratch_bytes"]
        if self.split_e:
            names += ["mm_cross_decode_attention_i8", "mm_cross_decode_i8_splits"]
        if "mm_ancestry_decode_fixed_work" in q_src:
            names.append("mm_ancestry_decode_fixed_work")
        for name in names:
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name]
        if self.e_split_dtype:
            self.lib.mm_cross_decode_i8_splits.argtypes = [ctypes.c_int] * 6
        if self.has_bwd and not self.heads:
            fn = self.lib.mm_flash_attention_bwd
            fn.argtypes = fn.argtypes[:-3] + fn.argtypes[-1:]
        if self.has_bwd and not self.bh0:
            fn = self.lib.mm_flash_attention_bwd
            fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]
        if not self.split_c:  # one block per (b.h, 16 rows), contiguous q and out
            fn = self.lib.mm_cross_decode_attention
            fn.argtypes, fn.restype = _OLD_CROSS, ctypes.c_int
        if not self.split_d:  # D and F in one entry, grid (B, H), contiguous q and out
            fn = self.lib.mm_ancestry_decode_attention_q
            fn.argtypes, fn.restype = _OLD_I8, ctypes.c_int
        if not self.split_f:  # one block per (b, h), contiguous q and out
            fn = self.lib.mm_ancestry_decode_attention_i4
            fn.argtypes, fn.restype = _OLD_I4, ctypes.c_int
        if not self.split_e:  # one block per (b.h, 16 rows), contiguous q and out
            fn = self.lib.mm_cross_decode_attention_i8
            fn.argtypes, fn.restype = _OLD_CROSS_I8, ctypes.c_int
        if not self.split_b:  # one block per (b, h), contiguous q, no scratch
            fn = self.lib.mm_ancestry_decode_attention
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
                + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

    def e_splits(self, code, B, H, K, S, Dh) -> int:
        """Kernel E's split count in this tree."""
        args = (code, B, H, K, S, Dh) if self.e_split_dtype else (B, H, K, S, Dh)
        return self.lib.mm_cross_decode_i8_splits(*args)

    def takes(self, entry: str, rate: float) -> bool:
        if entry == "mm_flash_attention_bwd":
            return self.has_bwd
        return self.dropout or rate == 0.0


def _inputs(B, T, S, H, D, dtype):
    """q, dO (B, T, H, D), k, v (B, S, H, D) and the key bias: lengths T, T - 17,
    ... where S == T, else the keys past T padded (the ViT's)."""
    g = torch.Generator().manual_seed(T)
    q, dout = (torch.randn(B, T, H, D, generator=g).to("cuda", dtype) for _ in range(2))
    k, v = (torch.randn(B, S, H, D, generator=g).to("cuda", dtype) for _ in range(2))
    lengths = torch.clamp(T - 17 * torch.arange(B), min=1) if S == T else torch.full((B,), T)
    bias = torch.where(torch.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).cuda()
    return q, k, v, dout, bias


def _launcher(tree: Tree, entry, B, T, H, D, causal, window, rate, S=None, dtype=torch.bfloat16):
    S = T if S is None else S
    q, k, v, dout, bias = _inputs(B, T, S, H, D, dtype)
    code = _build.dtype_code(dtype)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
    stream = torch.cuda.current_stream().cuda_stream
    common = [B, T, S, H, D, *strides, D ** -0.5, causal, window]
    out = torch.empty_like(q)
    stats = torch.empty((2, B * H, T), device="cuda")
    fwd_entry = "mm_flash_attention_causal_skip" if causal else "mm_flash_attention"
    fwd = getattr(tree.lib, fwd_entry if entry == "mm_flash_attention_bwd" else entry)
    with_stats = rate > 0.0 or entry == "mm_flash_attention_bwd"
    bh0 = ([0] if tree.bh0 else []) + ([H, 0] if tree.heads else [])
    extra = ([rate, SEED if rate else 0, *bh0] + ([stats[0].data_ptr(), stats[1].data_ptr()]
                                            if with_stats else [None, None])
             if tree.dropout else [])
    fwd_args = [code, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), *common, *extra, stream]
    keep = [q, k, v, dout, bias, out, stats]  # the tensors outlive the launcher
    if entry != "mm_flash_attention_bwd":
        def launch():
            _build.check(fwd(*fwd_args), entry)
    else:
        _build.check(fwd(*fwd_args), fwd_entry)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.empty_like(q)
        dk, dv = (torch.empty(k.shape, device="cuda") for _ in range(2))
        dbias = torch.empty((B, H, S), device="cuda")
        keep += [delta, dq, dk, dv, dbias]
        ptrs = [t.data_ptr() for t in (q, k, v, bias, dout, stats[0], stats[1], delta,
                                       dq, dk, dv, dbias)]
        bwd_args = [code, *ptrs, *common, rate, SEED if rate else 0, *bh0, stream]

        def launch():
            _build.check(tree.lib.mm_flash_attention_bwd(*bwd_args), entry)
    launch.keep = keep
    return launch


def _ancestry_inputs(B, H, K, Dh, L, T, step, dtype=torch.bfloat16):
    """q, k_new, v_new, a (B, L, H, T·K, 2·Dh) cache and the flat_rep of a
    random ancestry at ``step``, as ``chip_smoke.ancestry_inputs`` makes them
    (drawn on the card from a seeded generator)."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q = randn(B, H, K, Dh) * Dh ** -0.5
    k_new, v_new = randn(B, H, K, Dh), randn(B, H, K, Dh)
    kv = torch.empty((B, L, H, T * K, 2 * Dh), dtype=dtype, device="cuda")
    for layer in range(L):
        kv[:, layer] = randn(B, H, T * K, 2 * Dh)
    ancestry = torch.randint(0, K, (B, K, T), generator=g, device="cuda")
    t_idx = torch.arange(T, device="cuda")[None, None, :]
    flat = torch.where(t_idx < step, t_idx * K + ancestry, torch.full_like(ancestry, -1))
    flat_rep = flat.repeat_interleave(K, dim=2).to(torch.int32)
    return [t.to(dtype) for t in (q, k_new, v_new)] + [kv, flat_rep]


def _decode_launchers(trees, entry, B, H, K, Dh, L, T, step, fixed_work=False,
                      dtype=torch.bfloat16):
    """{label: launch} for kernel B (each tree, and this tree's variants; in
    fp32 v1 only), C (each tree, and SDPA on the same inputs), D, E, F or the
    dense probe. B, C and E run in ``dtype``, the others in bf16."""
    stream = torch.cuda.current_stream().cuda_stream
    code = _build.dtype_code(dtype)
    fns = {}
    if entry == "mm_ancestry_decode_attention_i4":
        keep = _i4_launchers(trees, fns, B, H, K, Dh, L, T, step, fixed_work)
    elif entry == "mm_cross_decode_attention_i8":
        keep = _cross_i8_launchers(trees, fns, B, H, K, Dh, step, dtype)
    elif entry == "mm_dense_attention_probe":
        keep = _dense_launchers(fns, B, H, K, Dh, step)
    elif entry == "mm_cross_decode_attention":
        S = step
        g = torch.Generator().manual_seed(S)
        q = (torch.randn((B, H, K, Dh), generator=g) * Dh ** -0.5).to("cuda", dtype)
        kv = torch.randn((B, H, S, 2 * Dh), generator=g).to("cuda", dtype)
        lengths = torch.clamp(S - 23 * torch.arange(B), min=1)
        bias = torch.where(torch.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).cuda()
        keep = [q, kv, bias]
        for tree in trees:
            if tree.split_c:
                n_split = tree.lib.mm_cross_decode_splits(code, B, H, K, S, Dh)
                scratch = torch.empty(max(1, B * H * n_split * K * (Dh + 2)), device="cuda")
                out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
                args = [code, q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), B, H, K, Dh, S, n_split, *q.stride()[:3],
                        *out.stride()[:3], stream]
                keep += [scratch, out]
            else:
                out = torch.empty_like(q)
                args = [code, q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                        B, H, K, Dh, S, stream]
                keep.append(out)
            fns[tree.label] = (lambda fn, args: lambda: _build.check(fn(*args), entry))(
                tree.lib.mm_cross_decode_attention, args)
        mask = bias[:, None, None, :].to(dtype)
        k2, v2 = kv[..., :Dh], kv[..., Dh:]
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k2, v2, attn_mask=mask, scale=1.0)
        keep.append(mask)
    elif entry == "mm_ancestry_decode_attention_i8":
        keep = _i8_launchers(trees, fns, B, H, K, Dh, L, T, step, fixed_work)
    else:
        q, k_new, v_new, kv, flat_rep = _ancestry_inputs(B, H, K, Dh, L, T, step, dtype)
        keep = [q, k_new, v_new, kv, flat_rep]
        TS, layer = T * K, L // 2
        kv_strides = list(kv.stride()[:4])
        variants = (0, 1, 2, 3) if dtype == torch.bfloat16 else (0, 1)
        for tree in trees:
            for variant in (variants if tree.split_b and tree.label == "this" else (0,)):
                label = tree.label + (f"/v{variant}" if variant else "")
                fn = tree.lib.mm_ancestry_decode_attention
                if not tree.split_b:
                    out = torch.empty_like(q)
                    args = [code, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                            kv.data_ptr(), flat_rep.data_ptr(), out.data_ptr(), B, H, K, Dh, TS,
                            layer, *kv_strides, stream]
                else:
                    n_split = tree.lib.mm_ancestry_decode_splits(code, B, H, TS, variant)
                    scratch = torch.empty(B * H * n_split * K * (Dh + 2), device="cuda")
                    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
                    args = [code, variant, q.data_ptr(), k_new.data_ptr(),
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


def _i8_inputs(B, H, K, Dh, L, T, step, levels=127):
    """bf16 q, k_new, v_new, a random (B, L, H, T·K, 2·Dh) int8 cache (values
    in [-levels, levels]) with per-column scales, and the flat_rep of a
    random ancestry at ``step``, made on the card from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, H, K, Dh), generator=g, device="cuda") * Dh ** -0.5
    k_new, v_new = (torch.randn((B, H, K, Dh), generator=g, device="cuda") for _ in range(2))
    kv = torch.randint(-levels, levels + 1, (B, L, H, T * K, 2 * Dh), generator=g, device="cuda",
                       dtype=torch.int8)
    sk, sv = (torch.rand((B, L, H, T * K), generator=g, device="cuda") * 0.01 + 0.002
              for _ in range(2))
    ancestry = torch.randint(0, K, (B, K, T), generator=g, device="cuda")
    t_idx = torch.arange(T, device="cuda")[None, None, :]
    flat = torch.where(t_idx < step, t_idx * K + ancestry, torch.full_like(ancestry, -1))
    flat_rep = flat.repeat_interleave(K, dim=2).to(torch.int32)
    return [t.to(torch.bfloat16) for t in (q, k_new, v_new)] + [kv, sk, sv, flat_rep]


def _q_args(tree, entry, v, B, H, K, Dh, TS, layer, ptrs, strides, q, k_new, v_new, keep):
    """The argument list of this design of D or F (variant ``v``) and its
    output."""
    stream = torch.cuda.current_stream().cuda_stream
    lib, f = tree.lib, entry.endswith("_i4")
    n_split = (lib.mm_ancestry_decode_i4_splits(B, H, K, TS, v) if f
               else lib.mm_ancestry_decode_i8_splits(B, H, K, TS))
    nbytes = (lib.mm_ancestry_decode_i4_scratch_bytes(B, H, K, Dh, TS, n_split, v) if f
              else lib.mm_ancestry_decode_i8_scratch_bytes(B, H, K, Dh, TS, n_split))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
    keep += [scratch, out]
    return [_build.BF16, v, *ptrs, out.data_ptr(), scratch.data_ptr(), B, H, K, Dh, TS, layer,
            n_split, *(st for t in (q, k_new, v_new, out) for st in t.stride()[:3]), *strides,
            stream], out


def _add(fns, label, fn, args, entry, out=None):
    fns[label] = (lambda fn, args: lambda: _build.check(fn(*args), entry))(fn, args)
    if out is not None:
        fns[label].out = out


def _i8_launchers(trees, fns, B, H, K, Dh, L, T, step, fixed_work=False):
    """Kernel D of each tree into ``fns`` (this tree also as v1-v3, each
    launcher's output as its ``out``, and with ``fixed_work`` its passes with
    parts left out); returns the tensors to keep."""
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
            keep.append(out)
            _add(fns, tree.label, tree.lib.mm_ancestry_decode_attention_q,
                 [_build.BF16, 0, *ptrs, out.data_ptr(), B, H, K, Dh, TS, layer, *strides, stream],
                 entry, out)
            continue
        for v in (0, 1, 2, 3) if tree.label == "this" else (0,):
            if v == 3 and B % 2:
                continue
            args, out = _q_args(tree, entry, v, B, H, K, Dh, TS, layer, ptrs, strides, q, k_new,
                                v_new, keep)
            _add(fns, tree.label + (f"/v{v}" if v else ""), tree.lib.mm_ancestry_decode_attention_i8,
                 args, entry, out)
        if fixed_work and tree.label == "this":
            for probe in (1, 3, 7):
                args, _ = _q_args(tree, entry, 0, B, H, K, Dh, TS, layer, ptrs, strides, q,
                                  k_new, v_new, keep)
                _add(fns, f"this/fixed{probe}", tree.lib.mm_ancestry_decode_fixed_work,
                     [0, probe, *args[2:]], entry)
    return keep


def _i4_launchers(trees, fns, B, H, K, Dh, L, T, step, fixed_work=False):
    """Kernel F of each tree (this tree also as v1-v3 and, with
    ``fixed_work``, its passes with parts left out), and this tree's D on
    the same values unpacked (``this/D``, whose bits F must give)."""
    from mm_s2ut_torch.ops.decode_attention import i4_pack

    entry = "mm_ancestry_decode_attention_i4"
    stream = torch.cuda.current_stream().cuda_stream
    q, k_new, v_new, kv8, sk, sv, flat_rep = _i8_inputs(B, H, K, Dh, L, T, step, levels=7)
    TS, layer = T * K, L // 2
    kv4 = torch.empty((B, L, H, TS // 2, 2 * Dh), dtype=torch.int8, device="cuda")
    for lay in range(L):
        kv4[:, lay] = i4_pack(kv8[:, lay], TS // 2)
    keep = [q, k_new, v_new, kv8, kv4, sk, sv, flat_rep]
    sc_strides = [*sk.stride()[:3], *sv.stride()[:3]]
    ptrs = [t.data_ptr() for t in (q, k_new, v_new, kv4, sk, sv, flat_rep)]
    for tree in trees:
        if not tree.split_f:
            out = torch.empty_like(q)
            keep.append(out)
            _add(fns, tree.label, tree.lib.mm_ancestry_decode_attention_i4,
                 [_build.BF16, *ptrs, out.data_ptr(), B, H, K, Dh, TS, layer, *kv4.stride()[:4],
                  *sc_strides, stream], entry, out)
            continue
        for v in (0, 1, 2, 3) if tree.label == "this" else (0,):
            args, out = _q_args(tree, entry, v, B, H, K, Dh, TS, layer, ptrs,
                                [*kv4.stride()[:4], *sc_strides], q, k_new, v_new, keep)
            _add(fns, tree.label + (f"/v{v}" if v else ""), tree.lib.mm_ancestry_decode_attention_i4,
                 args, entry, out)
        if tree.label == "this":
            d_ptrs = [t.data_ptr() for t in (q, k_new, v_new, kv8, sk, sv, flat_rep)]
            args, out = _q_args(tree, "mm_ancestry_decode_attention_i8", 0, B, H, K, Dh, TS, layer,
                                d_ptrs, [*kv8.stride()[:4], *sc_strides], q, k_new, v_new, keep)
            _add(fns, "this/D", tree.lib.mm_ancestry_decode_attention_i8, args, entry, out)
        if fixed_work and tree.label == "this":
            for probe in (1, 3, 7):
                args, _ = _q_args(tree, entry, 0, B, H, K, Dh, TS, layer, ptrs,
                                  [*kv4.stride()[:4], *sc_strides], q, k_new, v_new, keep)
                _add(fns, f"this/fixed{probe}", tree.lib.mm_ancestry_decode_fixed_work,
                     [1, probe, *args[2:]], entry)
    return keep


def _cross_i8_launchers(trees, fns, B, H, K, Dh, S, dtype=torch.bfloat16):
    """Kernel E of each tree in ``dtype`` (this tree in bf16 also as v1, two
    batch rows per block), and this tree's C on a slab of the same values
    in ``dtype`` (``this/C``)."""
    entry = "mm_cross_decode_attention_i8"
    stream = torch.cuda.current_stream().cuda_stream
    code = _build.dtype_code(dtype)
    g = torch.Generator(device="cuda").manual_seed(S)
    q = (torch.randn((B, H, K, Dh), generator=g, device="cuda") * Dh ** -0.5).to(dtype)
    kv = torch.randint(-127, 128, (B, H, S, 2 * Dh), generator=g, device="cuda", dtype=torch.int8)
    sk, sv = (torch.rand((B, H, S), generator=g, device="cuda") * 0.01 + 0.002 for _ in range(2))
    lengths = torch.clamp(S - 23 * torch.arange(B, device="cuda"), min=1)
    bias = torch.where(torch.arange(S, device="cuda")[None, :] < lengths[:, None], 0.0, -1e9)
    keep = [q, kv, sk, sv, bias]
    ptrs = [t.data_ptr() for t in (q, kv, sk, sv, bias)]
    for tree in trees:
        if not tree.split_e:
            out = torch.empty_like(q)
            keep.append(out)
            _add(fns, tree.label, tree.lib.mm_cross_decode_attention_i8,
                 [code, *ptrs, out.data_ptr(), B, H, K, Dh, S, stream], entry, out)
            continue
        n_split = tree.e_splits(code, B, H, K, S, Dh)
        for v in (0, 1) if tree.label == "this" and B % 2 == 0 and dtype == torch.bfloat16 else (0,):
            scratch = torch.empty(max(1, B * H * -(-K // 16) * n_split * 16 * (Dh + 2)),
                                  device="cuda")
            out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
            keep += [scratch, out]
            _add(fns, tree.label + (f"/v{v}" if v else ""), tree.lib.mm_cross_decode_attention_i8,
                 [code, v, *ptrs, out.data_ptr(), scratch.data_ptr(), B, H, K, Dh, S,
                  n_split, *q.stride()[:3], *out.stride()[:3], stream], entry, out)
        if tree.label == "this":
            kvb = kv.to(dtype)
            c_split = tree.lib.mm_cross_decode_splits(code, B, H, K, S, Dh)
            scratch = torch.empty(max(1, B * H * c_split * K * (Dh + 2)), device="cuda")
            out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
            keep += [kvb, scratch, out]
            _add(fns, "C", tree.lib.mm_cross_decode_attention,
                 [code, q.data_ptr(), kvb.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), B, H, K, Dh, S, c_split, *q.stride()[:3],
                  *out.stride()[:3], stream], "mm_cross_decode_attention")
    return keep


def _dense_launchers(fns, B, H, K, Dh, S):
    """The dense probe of this tree over an int8 slab (``this/int8``) and
    over the same values nibble-packed (``this/int4``): the same bits."""
    from mm_s2ut_torch.ops.decode_attention import i4_pack

    entry = "mm_dense_attention_probe"
    lib, stream = _build.library(), torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(S)
    q = (torch.randn((B, H, K, Dh), generator=g, device="cuda") * 0.3).to(torch.bfloat16)
    kv8 = torch.randint(-7, 8, (B, H, S, 2 * Dh), generator=g, device="cuda", dtype=torch.int8)
    kv4 = i4_pack(kv8, S // 2)
    n_split = lib.mm_cross_decode_i8_splits(B, H, K, S, Dh)
    keep = [q, kv8, kv4]
    for packed, kv in ((0, kv8), (1, kv4)):
        scratch = torch.empty(max(1, B * H * -(-K // 16) * n_split * 16 * (Dh + 2)), device="cuda")
        out = torch.empty((B, K, H, Dh), dtype=q.dtype, device="cuda").transpose(1, 2)
        keep += [scratch, out]
        _add(fns, f"this/{'int4' if packed else 'int8'}", lib.mm_dense_attention_probe,
             [packed, q.data_ptr(), kv.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, K, Dh,
              S, n_split, *q.stride()[:3], *out.stride()[:3], stream], entry, out)
    return keep


def _write_launchers(cache, B, K, cap, L, H, Dh, step):
    """The decode step's cache write at ``step``: ``this/kernel``
    (``cache_write``), ``this/plain`` (the decoder's ``write_step``), each on
    its own copy of the cache, whose written bytes (and scales) are its
    ``out``; ``this/raw``, the kernel's ctypes launch alone on pre-quantized
    rows (no ``out``)."""
    from mm_s2ut_torch.ops import decode_attention as D

    g = torch.Generator(device="cuda").manual_seed(step)
    TS = cap * K
    int4, quant = cache == "int4", cache != "bfloat16"
    k_rows, v_rows = (torch.randn((B, L, H, K, Dh), generator=g, device="cuda").to(torch.bfloat16)
                      for _ in range(2))
    if quant:
        kv = torch.randint(-128, 128, (B, L, H, TS // 2 if int4 else TS, 2 * Dh), generator=g,
                           device="cuda", dtype=torch.int8)
        sk, sv = (torch.rand((B, L, H, TS), generator=g, device="cuda") for _ in range(2))
    else:
        kv = torch.randn((B, L, H, TS, 2 * Dh), generator=g, device="cuda").to(torch.bfloat16)
        sk = sv = None
    copies = [(kv, sk, sv), tuple(t.clone() if t is not None else None for t in (kv, sk, sv))]
    fns = {}
    for label, (kv, sk, sv) in zip(("kernel", "plain"), copies):
        fn = D.cache_write if label == "kernel" else D.write_step
        fns[f"this/{label}"] = (lambda fn, kv, sk, sv: lambda: fn(
            kv, k_rows, v_rows, step * K, sk, sv))(fn, kv, sk, sv)
    for (kv, sk, sv), fn in zip(copies, fns.values()):
        fn.out = (lambda kv, sk, sv: lambda: torch.cat(
            [t.view(torch.uint8).flatten() for t in (kv, sk, sv) if t is not None]))(kv, sk, sv)
    kv, sk, sv = copies[0]
    if quant:
        rows, rsk, rsv = D.quantize_rows(k_rows, v_rows, 7.0 if int4 else 127.0)
        src = [rows[..., :Dh], rows[..., Dh:]]
        P, pos = kv.shape[3], step * K
        high = int(int4 and pos >= P)
        mode, row, scales = (2 if int4 else 1), pos - P * high, [sk, sv, rsk, rsv]
    else:
        src, mode, row, high, scales = [k_rows, v_rows], 0, step * K, 0, [None] * 4
    es = kv.element_size()
    args = [mode, kv.data_ptr(), src[0].data_ptr(), src[1].data_ptr(),
            *(t.data_ptr() if t is not None else None for t in scales), B, L, H, K, Dh * es, row,
            high, step * K, *(st * es for st in kv.stride()[:4]),
            *(st * es for st in src[0].stride()[:4]),
            *(sk.stride()[:3] if quant else (0, 0, 0)), torch.cuda.current_stream().cuda_stream]
    _add(fns, "this/raw", _build.library().mm_cache_write, args, "mm_cache_write")
    for fn in fns.values():
        fn.keep = [k_rows, v_rows, copies, src, scales]
    return fns


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
    ap.add_argument("--fixed-work", action="store_true",
                    help="also D's and F's passes with parts left out (output not valid)")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    trees = [Tree("this", _build.CSRC)] + [Tree(d, Path(d)) for d in args.other]
    rows = []
    cases = [(dict(entry=entry, B=B, T=T, H=H, D=D, causal=causal, window=window, rate=rate),
              lambda c=(entry, B, T, H, D, causal, window, rate): {
                  tr.label: _launcher(tr, *c) for tr in trees if tr.takes(c[0], c[-1])})
             for entry, B, T, H, D, causal, window, rate in CASES]
    cases += [(dict(entry=entry, dtype="float32", B=B, T=T, S=S, H=H, D=D, causal=causal,
                    window=window, rate=rate),
               lambda c=(entry, B, T, H, D, causal, window, rate, S): {
                   tr.label: _launcher(tr, *c, dtype=torch.float32) for tr in trees})
              for entry, B, T, S, H, D, causal, window, rate in FP32_CASES]
    cases += [(dict(entry=entry, B=B, H=H, K=K, Dh=Dh,
                    **({"S": n} if L == 0 else {"T_dec": T, "step": n})),
               lambda c=(entry, B, H, K, Dh, L, T, n): _decode_launchers(
                   trees, *c, fixed_work=args.fixed_work))
              for entry, B, H, K, Dh, L, T, n in DECODE_CASES]
    cases += [(dict(entry=entry, dtype="float32", B=B, H=H, K=K, Dh=Dh,
                    **({"S": n} if L == 0 else {"T_dec": T, "step": n})),
               lambda c=(entry, B, H, K, Dh, L, T, n): _decode_launchers(
                   trees, *c, dtype=torch.float32))
              for entry, B, H, K, Dh, L, T, n in FP32_DECODE_CASES]
    cases += [(dict(entry="mm_cache_write", cache=cache, B=B, K=K, cap=cap, L=L, H=H, Dh=Dh,
                    step=step), lambda c=(cache, B, K, cap, L, H, Dh, step): _write_launchers(*c))
              for cache, B, K, cap, L, H, Dh, step in WRITE_CASES]
    for case, make in cases:
        kind = KINDS.get(case["entry"])
        if args.only and not any(o in case["entry"] or o in (kind, case.get("dtype"))
                                 for o in args.only):
            continue
        fns = make()
        runs = {label: [] for label in fns}
        for _ in range(2):
            for label, fn in fns.items():
                runs[label].append(_time(fn, args.reps))
        ms = {label: sum(v) / len(v) for label, v in runs.items()}
        torch.cuda.synchronize()
        outs = [fn.out for label, fn in fns.items() if label.startswith("this") and hasattr(fn, "out")]
        outs = [o() if callable(o) else o for o in outs]
        if len(outs) > 1:
            case["variants_same_bits"] = all(torch.equal(outs[0], o) for o in outs[1:])
        if kind == "dense":  # does half the bytes take half the time?
            case["int4_over_int8_ms"] = ms["this/int4"] / ms["this/int8"]
            case["int4_over_int8_slab_bytes"] = 0.5
            case["bound_us"] = {p: dense_bound_us(case["B"], case["H"], case["K"], case["Dh"],
                                                  case["S"], p == "int4")
                                for p in ("int8", "int4")}
        if kind == "write":
            case["bound_us"] = write_bound_us(*(case[k] for k in ("cache", "B", "K", "L", "H", "Dh")))
        rows.append({**case, "ms": ms, "runs": runs})
        print(" ".join(f"{k}={v}" for k, v in case.items()) + ": "
              + ", ".join(f"{label} {m:.4f} ms {[round(x, 4) for x in runs[label]]}"
                          for label, m in ms.items()))
        if args.per_kernel:
            rows[-1]["per_kernel_us"] = {label: _per_kernel(fn) for label, fn in fns.items()}
            for label, times in rows[-1]["per_kernel_us"].items():
                print(f"  {label}: " + "; ".join(f"{k} {v} us" for k, v in times.items()))
        del fns, outs
        torch.cuda.empty_cache()
    print(json.dumps({"kernel_ab": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
