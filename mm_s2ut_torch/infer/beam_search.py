"""Batched beam search over a never-reordered, ancestry-indexed KV cache.

Port of ``mm_s2ut/infer/beam_search.py``, with its prefix mode
(streaming's prefix-reuse continuation) and its ensemble form: the
state may be a tuple of per-model states (the logit ensemble of
``infer/generator.py``), and every piece of cache bookkeeping below
applies to each member.
Scoring follows fairseq's SequenceGenerator: candidates from the top 2K,
hypothesis score Σ log p / length^len_penalty, the length budget forcing
EOS, and early exit once no alive beam can beat the worst finished one.

The reference's ``lax.while_loop`` becomes a Python loop that reads one
flag back from the device per step. Top-k uses a stable descending sort,
so ties go to the lower index as ``jax.lax.top_k`` breaks them. The cache
grows in segments (64 → 128 → … → max_len+1 steps) as in the reference,
but as views of one full allocation: the kernel reads only the first
cap·K columns, and nothing is copied when a segment grows. The int8/int4
dequant scales are such views too. An int4 cache is the exception: its
half boundary moves with the capacity, so each growth re-packs it with
``i4_regrow`` (a copy per growth, as in the reference). In prefix mode
the search starts at the prefilled step and uses the full allocation from
the start, as the reference disables growth there.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from mm_s2ut_torch.models.decoder import is_int4
from mm_s2ut_torch.ops.decode_attention import i4_regrow

NEG_INF = -1.0e7  # beam-search mask value (the attention ops use -1e9)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last dim, sorted, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along dim 1 by idx (B, M)."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(shape))


def _reorder_ancestry(state: Any, indices: torch.Tensor, step: int) -> None:
    """Record this step's beam selection in the ancestry table (in place)
    instead of physically reordering the KV cache."""
    anc = state["ancestry"]  # (B, K, cap)
    new_anc = _take(anc, indices)
    new_anc[:, :, step] = indices
    anc.copy_(new_anc)


def _length_norm(length, alpha: float, device=None) -> torch.Tensor:
    """fairseq's length normaliser max(length, 1)^alpha in fp32, for an int
    or a tensor of lengths (the server's per-slot steps)."""
    return torch.as_tensor(length, dtype=torch.float32, device=device).clamp_min(1.0) ** alpha


def select_beams(
    logp: torch.Tensor, alive_logp: torch.Tensor, alive_seq: torch.Tensor,
    fin_seq: torch.Tensor, fin_scores: torch.Tensor, fin_flags: torch.Tensor,
    write_at, norm: torch.Tensor, eos_id: int, live: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One step's selection, shared by the offline search and the server:
    the exact two-stage top-2K of alive_logp + logp (B, K, V) (at most 2K
    of the global top-2K share one beam row, so each row's top-2K holds
    them; ties to the lower beam-major index), the candidates' tokens
    written at ``write_at`` (an int, or (B, 1, 1) per-slot positions), EOS
    candidates scored ÷ ``norm`` and merged into the finished set (their
    flags masked by ``live`` (B, 1) where given), the best K others alive.
    Returns (alive_logp, alive_seq, fin_scores, fin_seq, fin_flags,
    src_beam (B, K): the alive beams' parents)."""
    B, K, V = logp.shape
    cand = alive_logp[:, :, None] + logp
    k1 = min(2 * K, V)
    s1, i1 = _top_k(cand, k1)
    top_scores, pidx = _top_k(s1.reshape(B, k1 * K), 2 * K)
    top_beam = pidx // k1
    top_tok = torch.gather(i1.reshape(B, k1 * K), 1, pidx)
    seq2k = _take(alive_seq, top_beam)
    pos = torch.arange(seq2k.shape[2], device=seq2k.device)
    seq2k = torch.where(pos == write_at, top_tok[..., None], seq2k)
    is_eos = top_tok == eos_id

    cand_fin = torch.where(is_eos, top_scores / norm, torch.full_like(top_scores, NEG_INF))
    all_seq = torch.cat([fin_seq, seq2k], dim=1)
    all_scores = torch.cat([fin_scores, cand_fin], dim=1)
    all_flags = torch.cat([fin_flags, is_eos if live is None else is_eos & live], dim=1)
    fin_scores, fin_top = _top_k(all_scores, K)
    fin_seq = _take(all_seq, fin_top)
    fin_flags = torch.gather(all_flags, 1, fin_top)

    alive_cand = torch.where(is_eos, torch.full_like(top_scores, NEG_INF), top_scores)
    alive_logp, alive_top = _top_k(alive_cand, K)
    alive_seq = _take(seq2k, alive_top)
    src_beam = torch.gather(top_beam, 1, alive_top)
    return alive_logp, alive_seq, fin_scores, fin_seq, fin_flags, src_beam


@torch.no_grad()
def beam_search(
    decode_step: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Any]],
    init_state: Any,
    batch_size: int,
    *,
    beam_size: int = 10,
    max_len: int = 200,
    eos_id: int = 2,
    bos_id: int = 2,
    pad_id: int = 1,
    vocab_size: int = 1004,
    len_penalty: float = 1.0,
    unk_penalty: float = 0.0,
    unk_id: int = 3,
    prefix_tokens: Optional[torch.Tensor] = None,
    prefix_len: Optional[int] = None,
    prefix_logp: Optional[torch.Tensor] = None,
    max_new: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_step(tokens (N, 1), state) -> (logits (N, V), state)`` with
    N = batch_size·beam_size; ``init_state`` is tiled to N
    (:func:`tile_state_for_beams`), or a tuple of such states that
    ``decode_step`` takes and returns as a tuple (an ensemble: each
    member's cache grows, re-packs and records the ancestry alike).
    Returns (sequences (B, K, max_len) padded with pad_id — EOS included —
    and scores (B, K), best first).

    Prefix mode: ``prefix_tokens`` (B, P) with BOS at position 0,
    ``prefix_len`` (tokens incl. BOS) and ``prefix_logp`` (B,) from
    ``UnitDecoder.prefill``, which must have filled the state. The search
    starts at step prefix_len − 1 with the prefix as the only live beam and
    runs at most ``max_new`` steps; the length penalty and the EOS force
    at max_len keep their global step, so a BOS-only prefix reproduces the
    plain search."""
    B, K, V = batch_size, beam_size, vocab_size
    if V < 2:
        raise ValueError(f"vocab_size must be >= 2, got {V}")
    multi = isinstance(init_state, (tuple, list))
    states = list(init_state) if multi else [init_state]
    # Per member: the full allocations that each cache segment views.
    kv_full = [st["self_kv"] for st in states]
    anc_full = [st["ancestry"] for st in states]
    scales_full = [{k: st[k] for k in ("self_kv_sk", "self_kv_sv") if k in st} for st in states]
    int4 = [is_int4(st) for st in states]
    dev = kv_full[0].device
    L1 = max_len + 1

    prefixed = prefix_tokens is not None
    alive_seq = torch.full((B, K, L1), pad_id, dtype=torch.long, device=dev)
    alive_seq[:, :, 0] = bos_id
    alive_logp = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    alive_logp[:, 0] = 0.0  # only beam 0 is live initially
    step = 0
    if prefixed:
        n = min(int(prefix_len), prefix_tokens.shape[1], L1)
        alive_seq[:, :, :n] = prefix_tokens[:, None, :n].to(device=dev, dtype=torch.long)
        if prefix_logp is not None:
            alive_logp[:, 0] = prefix_logp.to(device=dev, dtype=torch.float32).reshape(B)
        step = max(int(prefix_len) - 1, 0)
    stop = max_len if max_new is None else min(max_len, step + max_new)
    fin_seq = torch.full((B, K, L1), pad_id, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    fin_flags = torch.zeros((B, K), dtype=torch.bool, device=dev)
    eos_only = torch.full((V,), NEG_INF, dtype=torch.float32, device=dev)
    eos_only[eos_id] = 0.0
    max_norm = _length_norm(max_len, len_penalty, dev)

    def improvable() -> bool:
        best_alive = alive_logp[:, 0] / max_norm
        worst_fin = torch.where(fin_flags, fin_scores, torch.full_like(fin_scores, NEG_INF)).amin(1)
        return bool(torch.any(~fin_flags.all(1) | (best_alive > worst_fin)))

    T_full = anc_full[0].shape[2]  # logical steps
    caps: List[int] = []
    c = 64
    while c < T_full and not prefixed:  # a prefilled cache is used whole
        caps.append(c)
        c *= 2
    caps.append(T_full)

    for m, st in enumerate(states):
        if int4[m]:  # it lives in re-packed segments: keep the first, drop the full allocation
            st["self_kv"] = kv_full[m][:, :, :, : caps[0] * K // 2].clone()
            kv_full[m] = None
    for i, cap in enumerate(caps):
        for m, st in enumerate(states):
            if int4[m]:
                if i > 0:
                    st["self_kv"] = i4_regrow(st["self_kv"], cap * K // 2)
            else:
                st["self_kv"] = kv_full[m][:, :, :, : cap * K]
            for key, full in scales_full[m].items():
                st[key] = full[:, :, :, : cap * K]
            st["ancestry"] = anc_full[m][:, :, :cap]
        while step < min(cap, stop) and improvable():
            prev_tok = alive_seq.reshape(B * K, L1)[:, step : step + 1]
            logits, new_states = decode_step(prev_tok, tuple(states) if multi else states[0])
            states = list(new_states) if multi else [new_states]
            logp = torch.log_softmax(logits.float(), dim=-1)
            if unk_penalty != 0.0:
                logp[:, unk_id] -= unk_penalty
            logp = logp.reshape(B, K, V)
            if step + 1 >= max_len:  # the length budget forces EOS
                logp = eos_only.expand(B, K, V)

            alive_logp, alive_seq, fin_scores, fin_seq, fin_flags, src_beam = select_beams(
                logp, alive_logp, alive_seq, fin_seq, fin_scores, fin_flags, step + 1,
                _length_norm(step + 1, len_penalty, dev), eos_id)
            for st in states:
                _reorder_ancestry(st, src_beam, step)
            step += 1

    # Fall back to alive beams where nothing finished.
    none_fin = ~fin_flags.any(1)
    alive_norm = alive_logp / _length_norm(step, len_penalty, dev)
    fin_seq = torch.where(none_fin[:, None, None], alive_seq, fin_seq)
    fin_scores = torch.where(none_fin[:, None], alive_norm, fin_scores)
    return fin_seq[:, :, 1:], fin_scores


def tile_state_for_beams(state: Any, beam_size: int) -> Any:
    """Expand the cache's flattened time axis by the beam count,
    (B, L, H, T, 2·Dh) → (B, L, H, T·K, 2·Dh) with column j = t·K + slot,
    and attach a zero (B, K, T) ancestry table. The cache is empty here,
    so this is a fresh zero allocation, not a copy. Cross K/V and the
    cross bias stay at batch size B (the beams share them). The ancestry
    table and the int8/int4 scales are sized by the LOGICAL T, which for
    an int4 cache is twice its physical column count."""
    kv = state["self_kv"]
    B = kv.shape[0]
    T = state["self_kv_sk"].shape[3] if "self_kv_sk" in state else kv.shape[3]
    shape = list(kv.shape)
    shape[3] = kv.shape[3] * beam_size
    out = {
        **state,
        "self_kv": torch.zeros(shape, dtype=kv.dtype, device=kv.device),
        "ancestry": torch.zeros((B, beam_size, T), dtype=torch.long, device=kv.device),
    }
    for key in ("self_kv_sk", "self_kv_sv"):
        if key in state:
            s_shape = list(state[key].shape)
            s_shape[3] = T * beam_size
            out[key] = torch.zeros(s_shape, dtype=state[key].dtype, device=kv.device)
    return out


def trim_hypothesis(tokens, eos_id: int = 2, pad_id: int = 1) -> List[int]:
    """Cut a generated row at its first EOS (exclusive), dropping pads."""
    out = []
    for t in tokens:
        t = int(t)
        if t == eos_id:
            break
        if t != pad_id:
            out.append(t)
    return out
