"""Beam-decode attention: kernels B–F and their plain PyTorch twins.

Port of ``mm_s2ut/ops/decode_attention.py``. Argument layouts are the
reference's, so the tests compare like with like:

* the self-attention cache is ONE stacked buffer (B, L, H, T·S, 2·Dh)
  with key column j = t·S + s and K‖V interleaved on the last axis;
  ``flat_rep`` (B, K, T·S) int32 holds j where column j is on beam k's
  ancestry path and in the past, else -1;
* the cross-attention slab is (B, H, S, 2·Dh), shared by the K beams;
* an int8 cache stores each column quantized per head with f32 dequant
  scales ``sk``/``sv`` (B, L, H, T·S) (cross: (B, H, S)); q is quantized
  per row (:func:`_quantize_q`) and both contractions are integer
  (kernel D, cross kernel E);
* an int4 cache packs two logical columns per byte in the half-split
  layout (byte p = column p in the low nibble, column p + T·S/2 in the
  high one; :func:`i4_pack`), with scales as int8's (kernel F).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/decode_attention.cu``, ``csrc/decode_attention_q.cu``) or raises.

Also here: the decode step's cache write (:func:`write_step`, which the
decoder calls, and :func:`cache_write`, the same write as one kernel,
``csrc/cache_write.cu``) and :func:`dense_attention`, a dense attention
over an int8 or nibble-packed slab; those two kernels are not on a path of
the system, ``tools/kernel_ab.py`` times them.
"""
from __future__ import annotations

import torch

from mm_s2ut_torch.ops import _build

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)
MAX_BEAMS = 16  # query rows per (b, h) of kernels B, D, F; C and E take any count


def reference(q, k_new, v_new, kv, flat_rep, layer: int) -> torch.Tensor:
    """Plain version of kernel B: (B, H, K, Dh) in q's dtype."""
    Dh = q.shape[-1]
    TS = kv.shape[3]
    k_cache = kv[:, layer, :, :, :Dh]  # (B, H, T·S, Dh)
    v_cache = kv[:, layer, :, :, Dh:]
    scores = torch.einsum("bhkd,bhjd->bhkj", q.float(), k_cache.float())
    col = torch.arange(TS, dtype=torch.int32, device=q.device)
    scores = torch.where(flat_rep[:, None] == col, scores, torch.full_like(scores, NEG_INF))
    self_logit = (q.float() * k_new.float()).sum(-1, keepdim=True)  # (B, H, K, 1)
    m = torch.maximum(scores.amax(-1, keepdim=True), self_logit)
    p = torch.exp(scores - m)
    p_self = torch.exp(self_logit - m)
    denom = p.sum(-1, keepdim=True) + p_self
    w = (p / denom).to(v_cache.dtype)
    out = torch.einsum("bhkj,bhjd->bhkd", w.float(), v_cache.float())
    out = out + (p_self / denom) * v_new.float()
    return out.to(q.dtype)


def cross_reference(q, kv, bias) -> torch.Tensor:
    """Plain version of kernel C: (B, H, K, Dh) in q's dtype."""
    Dh = q.shape[-1]
    k2 = kv[..., :Dh]
    v2 = kv[..., Dh:]
    scores = torch.einsum("bhkd,bhsd->bhks", q.float(), k2.float())
    scores = scores + bias.float()[:, None, None, :]
    w = torch.softmax(scores, dim=-1).to(v2.dtype)
    return torch.einsum("bhks,bhsd->bhkd", w, v2).to(q.dtype)


def _quantize_q(q, k_new):
    """Per-(b, h, k) row int8 quantization of q, and the exact
    (full-precision q) self logit: (q8 int8, qs (B, H, K) f32, sl f32)."""
    qf = q.float()
    qs = qf.abs().amax(-1) / 127.0 + 1e-20
    q8 = torch.round(qf / qs[..., None]).to(torch.int8)
    return q8, qs, (qf * k_new.float()).sum(-1)


def reference_i8(q, k_new, v_new, kv, sk, sv, flat_rep, layer: int) -> torch.Tensor:
    """Plain version of kernel D: B's contraction over an int8 cache with
    the reference's quantization — int8 q, integer scores (exact in f32),
    softmax weights ×sv requantized per row to int8."""
    Dh = q.shape[-1]
    q8, qs, sl = _quantize_q(q, k_new)
    slab = kv[:, layer]  # (B, H, T·S, 2·Dh) int8
    TS = slab.shape[2]
    s_int = torch.einsum("bhkd,bhjd->bhkj", q8.float(), slab[..., :Dh].float())
    scores = s_int * qs[..., None] * sk[:, layer][:, :, None, :]
    col = torch.arange(TS, dtype=torch.int32, device=q.device)
    scores = torch.where(flat_rep[:, None] == col, scores, torch.full_like(scores, NEG_INF))
    self_logit = sl[..., None]
    m = torch.maximum(scores.amax(-1, keepdim=True), self_logit)
    p = torch.exp(scores - m)
    p_self = torch.exp(self_logit - m)
    denom = p.sum(-1, keepdim=True) + p_self
    w_eff = (p / denom) * sv[:, layer][:, :, None, :]
    ws = w_eff.amax(-1, keepdim=True) / 127.0 + 1e-20
    w8 = torch.round(w_eff / ws)
    out = torch.einsum("bhkj,bhjd->bhkd", w8, slab[..., Dh:].float()) * ws
    out = out + (p_self / denom) * v_new.float()
    return out.to(q.dtype)


def cross_reference_i8(q, kv, sk, sv, bias) -> torch.Tensor:
    """Plain version of kernel E: dequantize the int8 slab to q's dtype,
    then :func:`cross_reference`."""
    Dh = q.shape[-1]
    slab = kv.float()
    deq = torch.cat([slab[..., :Dh] * sk[..., None], slab[..., Dh:] * sv[..., None]], dim=-1)
    return cross_reference(q, deq.to(q.dtype), bias)


def i4_pack(cols: torch.Tensor, P: int) -> torch.Tensor:
    """Logical columns (..., C, lanes) int8 with values in [-8, 7] → the
    half-split layout (..., P, lanes); C ≤ 2·P, missing columns are 0."""
    C = cols.shape[-2]
    pad = torch.zeros((*cols.shape[:-2], 2 * P - C, cols.shape[-1]), dtype=torch.int32,
                      device=cols.device)
    cols = torch.cat([cols.to(torch.int32), pad], dim=-2)
    merged = (cols[..., :P, :] & 0xF) | ((cols[..., P:, :] & 0xF) << 4)  # [0, 255]
    return (merged - 256 * (merged >= 128).to(torch.int32)).to(torch.int8)


def i4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`i4_pack`: (..., P, lanes) → (..., 2·P, lanes)
    int8, each nibble sign-extended."""
    wide = packed.to(torch.int32)
    lo = ((wide & 0xF) ^ 8) - 8
    hi = wide >> 4  # arithmetic shift of the sign-extended byte
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def i4_regrow(kv_packed: torch.Tensor, P_new: int) -> torch.Tensor:
    """Grow a half-split packed cache (..., P_old, lanes) to P_new ≥ P_old:
    the half boundary moves with the capacity, so every stored column is
    re-paired. Pure int8 bit operations, the reference's bytes exactly,
    written into the output in place: eager PyTorch would otherwise
    materialize several cache-sized temporaries that XLA fuses away."""
    P_old = kv_packed.shape[-2]
    if P_new < P_old:
        raise ValueError(f"i4_regrow: cannot shrink {P_old} packed rows to {P_new}")
    out = torch.zeros((*kv_packed.shape[:-2], P_new, kv_packed.shape[-1]),
                      dtype=torch.int8, device=kv_packed.device)
    # Columns 0 .. P_old-1 stay in the low nibbles of their bytes.
    out[..., :P_old, :].copy_(kv_packed).bitwise_and_(0xF)
    # Old high column P_old + i lands in the low nibble of byte P_old + i
    # while it is below P_new ...
    n = min(P_new, 2 * P_old) - P_old
    out[..., P_old : P_old + n, :].copy_(kv_packed[..., :n, :]).bitwise_right_shift_(4) \
        .bitwise_and_(0xF)
    # ... and in the high nibble of byte P_old + i - P_new from there on.
    m = 2 * P_old - P_new
    if m > 0:
        out[..., :m, :] |= kv_packed[..., P_old - m :, :] & -16  # -16 = 0xF0
    return out


def quantize_rows(k_rows: torch.Tensor, v_rows: torch.Tensor, levels: float):
    """The cache write's per-row symmetric quantization (127 levels for
    int8, 7 for int4): scale = max(amax/levels, 1e-8) over Dh, values
    rounded half to even and clipped. (…, Dh) rows → (int8 K‖V rows
    (…, 2·Dh), sk (…), sv (…))."""
    kf, vf = k_rows.float(), v_rows.float()
    sk = (kf.abs().amax(-1) / levels).clamp_min(1e-8)
    sv = (vf.abs().amax(-1) / levels).clamp_min(1e-8)
    rows = torch.cat([torch.round(kf / sk[..., None]), torch.round(vf / sv[..., None])], dim=-1)
    return rows.clamp(-levels, levels).to(torch.int8), sk, sv


def write_step(kv, k_rows, v_rows, write_pos: int, sk=None, sv=None) -> None:
    """The decode step's cache write (``UnitDecoder._step_core``), in place:
    this step's K and V rows (B, L, H, S, Dh) of every layer at logical
    column ``write_pos`` of the stacked cache ``kv``; with scale arrays
    ``sk``/``sv`` (B, L, H, T·S) the rows are quantized first
    (:func:`quantize_rows`) and their scales written beside them. An int4
    cache (``sk`` twice as wide as ``kv``) takes the half-split nibble
    write: logical column p sits in the low nibble of byte p, column p + P
    in the high one; T even keeps the S-column write on one side of P, and
    a read-merge-write of the S target bytes keeps the other nibble. The
    plain version of :func:`cache_write`, and what the decoder runs, as the
    JAX package keeps its XLA ``dynamic_update_slice``."""
    S_ = k_rows.shape[3]
    if sk is None:
        kv[:, :, :, write_pos : write_pos + S_] = torch.cat([k_rows, v_rows], dim=-1)
        return
    int4 = sk.shape[3] == 2 * kv.shape[3]
    rows, rsk, rsv = quantize_rows(k_rows, v_rows, 7.0 if int4 else 127.0)
    if int4:
        P = kv.shape[3]
        high = write_pos >= P
        pb = write_pos - P if high else write_pos
        nib = rows.to(torch.int32) & 0xF
        old = kv[:, :, :, pb : pb + S_].to(torch.int32) & 0xFF
        merged = (old & 0x0F) | (nib << 4) if high else (old & 0xF0) | nib
        kv[:, :, :, pb : pb + S_] = (merged - 256 * (merged >= 128).to(torch.int32)).to(torch.int8)
    else:
        kv[:, :, :, write_pos : write_pos + S_] = rows
    sk[:, :, :, write_pos : write_pos + S_] = rsk
    sv[:, :, :, write_pos : write_pos + S_] = rsv


def reference_i4(q, k_new, v_new, kv, sk, sv, flat_rep, layer: int) -> torch.Tensor:
    """Plain version of kernel F: unpack the layer's slab to int8 columns
    and take :func:`reference_i8`."""
    slab = i4_unpack(kv[:, layer])  # (B, H, T·S, 2·Dh)
    return reference_i8(q, k_new, v_new, slab[:, None], sk[:, layer][:, None],
                         sv[:, layer][:, None], flat_rep, 0)


def _check_common(name, q, tensors, K, Dh, max_rows=MAX_BEAMS):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {q.device}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on {q.device}")
    if K < 1 or (max_rows is not None and K > max_rows):
        raise ValueError(f"{name}: {K} queries per head, the kernel takes 1..{max_rows or 'any'}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not in {HEAD_DIMS}")


def ancestry_decode_attention(
    q: torch.Tensor,  # (B, H, K, Dh), already scaled by Dh^-0.5
    k_new: torch.Tensor,  # (B, H, K, Dh) this step's projected key
    v_new: torch.Tensor,  # (B, H, K, Dh)
    kv: torch.Tensor,  # (B, L, H, T·S, 2·Dh) the WHOLE stacked cache
    flat_rep: torch.Tensor,  # (B, K, T·S) int32
    layer: int,
) -> torch.Tensor:
    """(B, H, K, Dh) in q's dtype. The layer's slab is read through the
    cache's strides, never copied; q, k_new and v_new through theirs (the
    decoder's beam-major views), and the result is a (B, H, K, Dh) view of
    a beam-major (B, K, H, Dh) buffer, which the decoder flattens without
    a copy."""
    if q.device.type == "cpu":
        return reference(q, k_new, v_new, kv, flat_rep, layer)
    return _launch_ancestry(q, k_new, v_new, kv, flat_rep, layer)


def _launch_ancestry(q, k_new, v_new, kv, flat_rep, layer: int, variant: int = 0):
    """Check a CUDA input and launch kernel B (the split pass and the merge);
    ``variant`` picks one of the kernel's alternative designs, which only
    ``tools/kernel_ab.py`` times."""
    name = "ancestry_decode_attention"
    B, H, K, Dh = q.shape
    _check_common(name, q, (k_new, v_new, kv, flat_rep), K, Dh)
    if any(t.dtype != q.dtype for t in (k_new, v_new, kv)):
        raise ValueError(f"{name}: q, k_new, v_new, kv must share a dtype")
    if kv.shape[0] != B or kv.shape[2] != H or kv.shape[4] != 2 * Dh or kv.stride(4) != 1:
        raise ValueError(f"{name}: cache shape {tuple(kv.shape)} / strides")
    if kv.data_ptr() % 16 or any(kv.stride(i) * kv.element_size() % 16 for i in range(4)):
        raise ValueError(f"{name}: cache rows must be 16-byte aligned (16-byte row copies)")
    if not 0 <= layer < kv.shape[1]:
        raise ValueError(f"{name}: layer {layer} out of range")
    TS = kv.shape[3]
    if flat_rep.dtype != torch.int32 or tuple(flat_rep.shape) != (B, K, TS):
        raise ValueError(f"{name}: flat_rep must be (B, K, T·S) int32")
    if any(t.shape != q.shape or t.stride(3) != 1 for t in (q, k_new, v_new)):
        raise ValueError(f"{name}: q, k_new, v_new must be (B, H, K, Dh) with a dense head dim")
    flat_rep = flat_rep.contiguous()
    lib = _build.library()
    n_split = lib.mm_ancestry_decode_splits(_build.dtype_code(q.dtype), B, H, TS, variant)
    scratch = torch.empty(B * H * n_split * K * (Dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    rc = lib.mm_ancestry_decode_attention(
        _build.dtype_code(q.dtype), variant, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        kv.data_ptr(), flat_rep.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, H, K, Dh, TS, layer, n_split,
        *(st for t in (q, k_new, v_new, out) for st in t.stride()[:3]),
        *kv.stride()[:4], _build.stream_ptr(q.device),
    )
    _build.check(rc, name)
    ancestry_decode_attention.launches += 1
    return out


ancestry_decode_attention.launches = 0


def cross_decode_attention(
    q: torch.Tensor,  # (B, H, K, Dh), already scaled by Dh^-0.5
    kv: torch.Tensor,  # (B, H, S, 2·Dh) packed encoder K‖V
    bias: torch.Tensor,  # (B, S) f32 additive mask (0 valid / -1e9 pad)
) -> torch.Tensor:
    """(B, H, K, Dh) in q's dtype. K is any number of query rows: the
    beams of a decode step, or the prefix positions of a prefill. q is read
    through its strides (the decoder's beam-major view), and the result is
    a (B, H, K, Dh) view of a beam-major (B, K, H, Dh) buffer. Up to 16
    rows the slab is split over S while B·H is under a wave and merged in
    split order (``mm_cross_decode_splits``); more rows take kernel A's
    forward over the slab's K and V halves."""
    if q.device.type == "cpu":
        return cross_reference(q, kv, bias)
    name = "cross_decode_attention"
    B, H, K, Dh = q.shape
    S = kv.shape[2]
    _check_common(name, q, (kv, bias), K, Dh, max_rows=None)
    if kv.dtype != q.dtype or tuple(kv.shape) != (B, H, S, 2 * Dh):
        raise ValueError(f"{name}: slab {tuple(kv.shape)} {kv.dtype}")
    if tuple(bias.shape) != (B, S):
        raise ValueError(f"{name}: bias must be (B, S)")
    lib = _build.library()
    code = _build.dtype_code(q.dtype)
    kv = kv.contiguous()
    if kv.data_ptr() % 16:
        raise ValueError(f"{name}: the slab must start on a 16-byte boundary (16-byte row copies)")
    if q.stride(3) != 1 or q.data_ptr() % 16 or any(
            q.stride(i) * q.element_size() % 16 for i in range(3)):
        q = q.contiguous()  # rows 16-byte aligned, as A's tensor-core path copies them
    bias = bias.float().contiguous()
    n_split = lib.mm_cross_decode_splits(code, B, H, K, S, Dh)
    split = n_split > 1 and K <= MAX_BEAMS  # the split pass's partials, for its merge
    scratch = torch.empty(B * H * n_split * K * (Dh + 2) if split else 1,
                          dtype=torch.float32, device=q.device)
    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    rc = lib.mm_cross_decode_attention(
        code, q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, H, K, Dh, S, n_split, *q.stride()[:3], *out.stride()[:3], _build.stream_ptr(q.device),
    )
    _build.check(rc, name)
    cross_decode_attention.launches += 1
    return out


cross_decode_attention.launches = 0


def _check_quant(name, packed, q, k_new, v_new, kv, sk, sv, flat_rep, layer) -> int:
    """The checks that kernels D (packed=False) and F (packed=True) share;
    returns T·S. Both take the contract of ``flat_rep`` that
    ``UnitDecoder.step`` builds: T·S = T·K, and a beam has at most one
    on-path column among the K slots of a step."""
    B, H, K, Dh = q.shape
    _check_common(name, q, (k_new, v_new, kv, sk, sv, flat_rep), K, Dh)
    if q.dtype not in (torch.float32, torch.bfloat16) or k_new.dtype != q.dtype \
            or v_new.dtype != q.dtype:
        raise ValueError(f"{name}: q, k_new, v_new must share a float32/bfloat16 dtype")
    if kv.dtype != torch.int8 or kv.dim() != 5 or kv.shape[0] != B or kv.shape[2] != H \
            or kv.shape[4] != 2 * Dh or kv.stride(4) != 1:
        raise ValueError(f"{name}: int8 cache shape {tuple(kv.shape)} / strides")
    if not 0 <= layer < kv.shape[1]:
        raise ValueError(f"{name}: layer {layer} out of range")
    TS = kv.shape[3] * (2 if packed else 1)
    for s in (sk, sv):
        if s.dtype != torch.float32 or tuple(s.shape) != (B, kv.shape[1], H, TS) \
                or s.stride(3) != 1:
            raise ValueError(f"{name}: scales must be (B, L, H, T·S) float32, got "
                             f"{tuple(s.shape)} {s.dtype}")
    if flat_rep.dtype != torch.int32 or tuple(flat_rep.shape) != (B, K, TS):
        raise ValueError(f"{name}: flat_rep must be (B, K, T·S) int32")
    if TS % K:
        raise ValueError(f"{name}: T·S={TS} is not a multiple of the {K} beam slots")
    return TS


def _launch_i8(q, k_new, v_new, kv, sk, sv, flat_rep, layer: int, variant: int = 0):
    """Check a CUDA input and launch kernel D (the score pass, the output
    pass and, with several splits, the merge). The cache and both scale
    arrays are read through their strides (the beam search passes prefix
    views of one allocation), q, k_new and v_new through theirs (the
    decoder's beam-major views); the result is a (B, H, K, Dh) view of a
    beam-major (B, K, H, Dh) buffer. ``variant`` picks one of the kernel's
    alternative designs, which only ``tools/kernel_ab.py`` times; all give
    the same bits."""
    name = "ancestry_decode_attention_i8"
    B, H, K, Dh = q.shape
    TS = _check_quant(name, False, q, k_new, v_new, kv, sk, sv, flat_rep, layer)
    if any(t.shape != q.shape or t.stride(3) != 1 for t in (q, k_new, v_new)):
        raise ValueError(f"{name}: q, k_new, v_new must be (B, H, K, Dh) with a dense head dim")
    if kv.data_ptr() % 16 or any(kv.stride(i) % 16 for i in range(4)):
        raise ValueError(f"{name}: cache rows must be 16-byte aligned (16-byte row copies)")
    flat_rep = flat_rep.contiguous()
    lib = _build.library()
    n_split = lib.mm_ancestry_decode_i8_splits(B, H, K, TS)
    scratch = torch.empty(lib.mm_ancestry_decode_i8_scratch_bytes(B, H, K, Dh, TS, n_split),
                          dtype=torch.uint8, device=q.device)
    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    rc = lib.mm_ancestry_decode_attention_i8(
        _build.dtype_code(q.dtype), variant, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        kv.data_ptr(), sk.data_ptr(), sv.data_ptr(), flat_rep.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), B, H, K, Dh, TS, layer, n_split,
        *(st for t in (q, k_new, v_new, out) for st in t.stride()[:3]),
        *kv.stride()[:4], *sk.stride()[:3], *sv.stride()[:3], _build.stream_ptr(q.device),
    )
    _build.check(rc, name)
    ancestry_decode_attention_i8.launches += 1
    return out


def _launch_i4(q, k_new, v_new, kv, sk, sv, flat_rep, layer: int, variant: int = 0):
    """Check a CUDA input and launch kernel F: D's passes over the
    nibble-packed cache, the views and the result as :func:`_launch_i8`'s.
    ``variant`` picks one of the kernel's alternative designs (Dh = 64),
    which only ``tools/kernel_ab.py`` times; all give the same bits."""
    name = "ancestry_decode_attention_i4"
    B, H, K, Dh = q.shape
    TS = _check_quant(name, True, q, k_new, v_new, kv, sk, sv, flat_rep, layer)
    if any(t.shape != q.shape or t.stride(3) != 1 for t in (q, k_new, v_new)):
        raise ValueError(f"{name}: q, k_new, v_new must be (B, H, K, Dh) with a dense head dim")
    if kv.data_ptr() % 16 or any(kv.stride(i) % 16 for i in range(4)):
        raise ValueError(f"{name}: cache rows must be 16-byte aligned (16-byte row copies)")
    flat_rep = flat_rep.contiguous()
    lib = _build.library()
    n_split = lib.mm_ancestry_decode_i4_splits(B, H, K, TS, variant)
    scratch = torch.empty(lib.mm_ancestry_decode_i4_scratch_bytes(B, H, K, Dh, TS, n_split, variant),
                          dtype=torch.uint8, device=q.device)
    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    rc = lib.mm_ancestry_decode_attention_i4(
        _build.dtype_code(q.dtype), variant, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        kv.data_ptr(), sk.data_ptr(), sv.data_ptr(), flat_rep.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), B, H, K, Dh, TS, layer, n_split,
        *(st for t in (q, k_new, v_new, out) for st in t.stride()[:3]),
        *kv.stride()[:4], *sk.stride()[:3], *sv.stride()[:3], _build.stream_ptr(q.device),
    )
    _build.check(rc, name)
    ancestry_decode_attention_i4.launches += 1
    return out


def ancestry_decode_attention_i8(
    q: torch.Tensor,  # (B, H, K, Dh), already scaled by Dh^-0.5
    k_new: torch.Tensor,  # (B, H, K, Dh)
    v_new: torch.Tensor,  # (B, H, K, Dh)
    kv: torch.Tensor,  # (B, L, H, T·S, 2·Dh) int8, the WHOLE stacked cache
    sk: torch.Tensor,  # (B, L, H, T·S) f32 per-column K dequant scale
    sv: torch.Tensor,  # (B, L, H, T·S) f32 per-column V dequant scale
    flat_rep: torch.Tensor,  # (B, K, T·S) int32
    layer: int,
) -> torch.Tensor:
    """int8-cache variant of :func:`ancestry_decode_attention` (kernel D):
    (B, H, K, Dh) in q's dtype, a view of a beam-major buffer."""
    if q.device.type == "cpu":
        return reference_i8(q, k_new, v_new, kv, sk, sv, flat_rep, layer)
    return _launch_i8(q, k_new, v_new, kv, sk, sv, flat_rep, layer)


ancestry_decode_attention_i8.launches = 0


def ancestry_decode_attention_i4(
    q: torch.Tensor,  # (B, H, K, Dh), already scaled by Dh^-0.5
    k_new: torch.Tensor,  # (B, H, K, Dh)
    v_new: torch.Tensor,  # (B, H, K, Dh)
    kv: torch.Tensor,  # (B, L, H, T·S/2, 2·Dh) int8, nibble-packed (half-split)
    sk: torch.Tensor,  # (B, L, H, T·S) f32, logical column ids
    sv: torch.Tensor,  # (B, L, H, T·S) f32
    flat_rep: torch.Tensor,  # (B, K, T·S) int32, logical column ids
    layer: int,
) -> torch.Tensor:
    """int4-cache variant of :func:`ancestry_decode_attention` (kernel F)."""
    if q.device.type == "cpu":
        return reference_i4(q, k_new, v_new, kv, sk, sv, flat_rep, layer)
    return _launch_i4(q, k_new, v_new, kv, sk, sv, flat_rep, layer)


ancestry_decode_attention_i4.launches = 0


def cross_decode_attention_i8(
    q: torch.Tensor,  # (B, H, K, Dh), already scaled by Dh^-0.5
    kv: torch.Tensor,  # (B, H, S, 2·Dh) int8 packed encoder K‖V
    sk: torch.Tensor,  # (B, H, S) f32 per-column K dequant scale
    sv: torch.Tensor,  # (B, H, S) f32 per-column V dequant scale
    bias: torch.Tensor,  # (B, S) f32 additive mask (0 valid / -1e9 pad)
) -> torch.Tensor:
    """int8-slab variant of :func:`cross_decode_attention` (kernel E),
    for any number of query rows too."""
    if q.device.type == "cpu":
        return cross_reference_i8(q, kv, sk, sv, bias)
    return _launch_cross_i8(q, kv, sk, sv, bias)


def _launch_cross_i8(q, kv, sk, sv, bias, variant: int = 0):
    """Check a CUDA input and launch kernel E (the split pass over groups of
    16 rows and, with several splits, the merge). q is read through its
    strides (the decoder's beam-major view), and the result is a (B, H, K,
    Dh) view of a beam-major (B, K, H, Dh) buffer. ``variant`` 1 (bf16, B
    even: two batch rows per block) is the design ``tools/kernel_ab.py``
    times beside v0."""
    name = "cross_decode_attention_i8"
    B, H, K, Dh = q.shape
    S = kv.shape[2]
    _check_common(name, q, (kv, sk, sv, bias), K, Dh, max_rows=None)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if kv.dtype != torch.int8 or tuple(kv.shape) != (B, H, S, 2 * Dh):
        raise ValueError(f"{name}: slab {tuple(kv.shape)} {kv.dtype}")
    if any(s.dtype != torch.float32 or tuple(s.shape) != (B, H, S) for s in (sk, sv)):
        raise ValueError(f"{name}: scales must be (B, H, S) float32")
    if tuple(bias.shape) != (B, S):
        raise ValueError(f"{name}: bias must be (B, S)")
    if q.stride(3) != 1:
        raise ValueError(f"{name}: q must have a dense head dim")
    kv, sk, sv = (t.contiguous() for t in (kv, sk, sv))
    if kv.data_ptr() % 16:
        raise ValueError(f"{name}: the slab must start on a 16-byte boundary (16-byte row reads)")
    bias = bias.float().contiguous()
    lib = _build.library()
    code = _build.dtype_code(q.dtype)
    n_split = lib.mm_cross_decode_i8_splits(B, H, K, S, Dh)
    groups = -(-K // MAX_BEAMS)
    scratch = torch.empty(B * H * groups * n_split * MAX_BEAMS * (Dh + 2) if n_split > 1 else 1,
                          dtype=torch.float32, device=q.device)
    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    rc = lib.mm_cross_decode_attention_i8(
        code, variant, q.data_ptr(), kv.data_ptr(), sk.data_ptr(), sv.data_ptr(), bias.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, H, K, Dh, S, n_split, *q.stride()[:3],
        *out.stride()[:3], _build.stream_ptr(q.device),
    )
    _build.check(rc, name)
    cross_decode_attention_i8.launches += 1
    return out


cross_decode_attention_i8.launches = 0


def dense_reference(q, kv, packed: bool = False) -> torch.Tensor:
    """Plain version of :func:`dense_attention`: softmax(q·k)·v over every
    column of an int8 slab (B, H, S, 2·Dh), or of the same values
    nibble-packed (B, H, S/2, 2·Dh, :func:`i4_pack`'s layout), the values
    in q's dtype, the weights rounded to it (the probe's ``_attnish``)."""
    slab = i4_unpack(kv) if packed else kv
    Dh = q.shape[-1]
    scores = torch.einsum("bhkd,bhsd->bhks", q.float(), slab[..., :Dh].to(q.dtype).float())
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhks,bhsd->bhkd", w.float(), slab[..., Dh:].to(q.dtype).float()).to(q.dtype)


def dense_attention(q, kv, packed: bool = False) -> torch.Tensor:
    """The dense probe kernel (bf16, Dh = 64; kernel E's split pass with
    another load and no scales or bias): does reading half the slab's bytes
    halve the time? (B, H, K, Dh) in q's dtype."""
    if q.device.type == "cpu":
        return dense_reference(q, kv, packed)
    name = "dense_attention"
    B, H, K, Dh = q.shape
    S = kv.shape[2] * (2 if packed else 1)
    _check_common(name, q, (kv,), K, Dh, max_rows=None)
    if q.dtype != torch.bfloat16 or Dh != 64 or q.stride(3) != 1:
        raise ValueError(f"{name}: bf16 q with a dense head dim of 64")
    if kv.dtype != torch.int8 or tuple(kv.shape) != (B, H, S // (2 if packed else 1), 2 * Dh):
        raise ValueError(f"{name}: slab {tuple(kv.shape)} {kv.dtype}")
    kv = kv.contiguous()
    lib = _build.library()
    n_split = lib.mm_cross_decode_i8_splits(B, H, K, S, Dh)
    scratch = torch.empty(B * H * -(-K // MAX_BEAMS) * n_split * MAX_BEAMS * (Dh + 2)
                          if n_split > 1 else 1, dtype=torch.float32, device=q.device)
    out = torch.empty((B, K, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    rc = lib.mm_dense_attention_probe(
        int(packed), q.data_ptr(), kv.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, H, K, Dh, S, n_split, *q.stride()[:3], *out.stride()[:3], _build.stream_ptr(q.device))
    _build.check(rc, name)
    dense_attention.launches += 1
    return out


dense_attention.launches = 0


def cache_write(kv, k_rows, v_rows, write_pos: int, sk=None, sv=None) -> None:
    """:func:`write_step` with the write itself as one kernel launch
    (``csrc/cache_write.cu``; the quantization stays plain PyTorch, so both
    write the same bytes). Not on the decoder's path: ``tools/kernel_ab.py``
    times it against :func:`write_step`."""
    if kv.device.type == "cpu":
        return write_step(kv, k_rows, v_rows, write_pos, sk, sv)
    name = "cache_write"
    B, L, H, S_, Dh = k_rows.shape
    if kv.device != k_rows.device or v_rows.shape != k_rows.shape or kv.stride(4) != 1:
        raise ValueError(f"{name}: rows {tuple(k_rows.shape)} / cache {tuple(kv.shape)}")
    if sk is None:
        if k_rows.dtype != kv.dtype or v_rows.dtype != kv.dtype:
            raise ValueError(f"{name}: the rows must be in the cache's dtype {kv.dtype}")
        mode, k_src, v_src, row, high = 0, k_rows, v_rows, write_pos, 0
        scales = [None] * 4
    else:
        int4 = sk.shape[3] == 2 * kv.shape[3]
        rows, rsk, rsv = quantize_rows(k_rows, v_rows, 7.0 if int4 else 127.0)
        P = kv.shape[3]
        high = int(int4 and write_pos >= P)
        row = write_pos - P if high else write_pos
        if int4 and row + S_ > P:
            raise ValueError(f"{name}: the {S_} columns at {write_pos} straddle the half {P}")
        if any(s.stride(3) != 1 for s in (sk, sv)) or sk.stride() != sv.stride():
            raise ValueError(f"{name}: sk and sv must share strides with a dense last dim")
        mode, k_src, v_src = (2 if int4 else 1), rows[..., :Dh], rows[..., Dh:]
        scales = [sk, sv, rsk.contiguous(), rsv.contiguous()]
    if any(t.stride(4) != 1 or t.data_ptr() % 16
           or any(t.stride(i) * t.element_size() % 16 for i in range(4)) for t in (k_src, v_src)):
        k_src, v_src = k_src.contiguous(), v_src.contiguous()
    if kv.data_ptr() % 16 or any(kv.stride(i) * kv.element_size() % 16 for i in range(4)):
        raise ValueError(f"{name}: cache rows must be 16-byte aligned")
    if k_src.stride() != v_src.stride():
        raise ValueError(f"{name}: k_rows and v_rows must share strides")
    es = kv.element_size()
    d_strides = scales[0].stride()[:3] if scales[0] is not None else (0, 0, 0)
    rc = _build.library().mm_cache_write(
        mode, kv.data_ptr(), k_src.data_ptr(), v_src.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scales),
        B, L, H, S_, Dh * es, row, high, write_pos,
        *(st * es for st in kv.stride()[:4]), *(st * es for st in k_src.stride()[:4]),
        *d_strides, _build.stream_ptr(kv.device),
    )
    _build.check(rc, name)
    cache_write.launches += 1


cache_write.launches = 0
