"""Autoregressive unit decoder with a beam-shared, ancestry-indexed cache.

Port of ``mm_s2ut/models/decoder.py``: the teacher-forced ``forward`` of
training (causal dense self-attention, dense cross-attention, embedding
dropout; plain PyTorch, as the reference's einsums) and the incremental
decoding (``UnitDecoder.init_state`` for a bf16/fp32, int8 or int4 cache,
``step``, ``_step_core``, the ancestry branch of ``_self_attn_step``,
``prefill`` for streaming's prefix reuse, and ``serve_step``, the
continuous-batching step over a ring cache). Pre-norm or post-norm layers
(no final LayerNorm when post-norm), the output tied to the unit embedding
or an untied ``output_proj``. ``n_frames_per_step`` > 1 (the packed
``StackedEmbedding`` and ``out_proj_n_frames``) is for ``forward`` only:
beam decode and prefill raise, as in the reference. The cache layout is the
reference's: ONE stacked buffer (B, L, H, T·S, 2·Dh), key column
j = t·S + s, K‖V interleaved on the last axis. Rows are never reordered:
beam k reads its history through ``flat_rep`` (kernel B; D over an int8
cache, F over an int4 one), and each step writes its rows in place.

Decoder state is a plain dict: ``step`` (int), ``self_kv``, ``cross``
(per-layer packed encoder K‖V, with ``sk``/``sv`` when int8),
``cross_bias``, for a quantized cache ``self_kv_sk``/``self_kv_sv``
(B, L, H, T·S) f32 dequant scales, and, once tiled for beams,
``ancestry`` (B, K, T) int64. :meth:`UnitDecoder.step` updates it in place.
An int4 cache is nibble-packed in the half-split layout
(``ops/decode_attention.i4_pack``): its physical column axis is half the
logical one, which is how the code tells it from int8 (the scales keep
the logical length). :class:`CTCHead` is the auxiliary CTC projection
of the CTC and multitask heads.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from mm_s2ut_torch.models.layers import (
    SinusoidalPositionalEmbedding,
    TransformerDecoderLayer,
    compute_dtype,
    layer_norm,
    make_causal_bias,
    make_padding_bias,
)
from mm_s2ut_torch.ops.decode_attention import (
    ancestry_decode_attention,
    ancestry_decode_attention_i4,
    ancestry_decode_attention_i8,
    quantize_rows,
    write_step,
)
from mm_s2ut_torch.ops.dropout import BernoulliDropout

DecoderState = Dict[str, Any]


def is_int4(state: DecoderState) -> bool:
    """An int4 cache holds two logical columns per physical one."""
    return "self_kv_sk" in state and state["self_kv_sk"].shape[3] == 2 * state["self_kv"].shape[3]


class StackedEmbedding(nn.Module):
    """Unit embedding; with n_frames_per_step = n > 1 a packed id
    p = Σ u_i·V^(n-1-i) + offset is unpacked, each unit embedded with the
    shared table plus a learned position-in-pack embedding (``pack_pos``),
    and the n summed. Special ids (< offset) embed directly."""

    def __init__(self, vocab_size: int, embed_dim: int, n_frames_per_step: int = 1,
                 offset: int = 4):
        super().__init__()
        self.n, self.offset = n_frames_per_step, offset
        self.n_units = vocab_size - offset
        self.embed_tokens = nn.Embedding(vocab_size, embed_dim)
        if self.n > 1:
            self.pack_pos = nn.Embedding(self.n, embed_dim)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.n <= 1:
            return self.embed_tokens(ids)
        V = self.n_units
        packed = (ids - self.offset).clamp_min(0)
        out = torch.zeros((*ids.shape, self.embed_tokens.embedding_dim),
                          dtype=self.embed_tokens.weight.dtype, device=ids.device)
        for i in range(self.n):
            unit = (packed // V ** (self.n - 1 - i)) % V
            out = out + self.embed_tokens(unit + self.offset) + self.pack_pos.weight[i]
        special = self.embed_tokens(ids.clamp_max(self.offset - 1))
        return torch.where((ids < self.offset)[..., None], special, out)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Output projection sharing the input table; fp32 logits from the
        operands rounded to the compute dtype, as the reference's
        preferred_element_type."""
        dt = compute_dtype(x)
        with torch.autocast(x.device.type, enabled=False):
            if hasattr(self.embed_tokens, "attend"):  # cut over the vocabulary
                return self.embed_tokens.attend(x, dt)
            w = self.embed_tokens.weight.to(dt).float()
            return torch.matmul(x.to(dt).float(), w.t())


class UnitDecoder(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 512,
        ffn_dim: int = 2048,
        num_layers: int = 6,
        num_heads: int = 8,
        dropout: float = 0.0,
        attention_dropout: float = 0.0,
        activation_dropout: float = 0.0,
        activation: str = "relu",
        normalize_before: bool = True,
        share_input_output_embed: bool = True,
        n_frames_per_step: int = 1,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.normalize_before = normalize_before
        self.n_frames_per_step = n_frames_per_step
        self.embed = StackedEmbedding(vocab_size, embed_dim, n_frames_per_step)
        self.pos = SinusoidalPositionalEmbedding(embed_dim)
        self.drop = BernoulliDropout(dropout)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerDecoderLayer(
                embed_dim, ffn_dim, num_heads, dropout, attention_dropout, activation_dropout,
                activation, normalize_before))
        if normalize_before:
            self.final_norm = layer_norm(embed_dim)
        if not share_input_output_embed:
            self.output_proj = nn.Linear(embed_dim, vocab_size, bias=False)
        if n_frames_per_step > 1:
            # Each packed position expands to n sub-frame states, each with
            # its own V-way logits (the loss side stays base-V).
            self.out_proj_n_frames = nn.Linear(embed_dim, n_frames_per_step * embed_dim,
                                               bias=False)
        self.embed_scale = math.sqrt(embed_dim)

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm (pre-norm) → sub-frame expansion (n > 1) → fp32
        logits, tied to the unit table or through ``output_proj``."""
        if self.normalize_before:
            x = self.final_norm(x)
        if self.n_frames_per_step > 1:
            B, L, d = x.shape
            x = self.out_proj_n_frames(x).reshape(B, L * self.n_frames_per_step, d)
        if hasattr(self, "output_proj"):
            return self.output_proj(x).float()
        return self.embed.attend(x)

    def _no_packed_decode(self, what: str) -> None:
        if self.n_frames_per_step > 1:
            # The search emits one base-V unit per step; the packed space is
            # not searched (the reference raises the same).
            raise NotImplementedError(f"{what} with n_frames_per_step > 1 is not supported")

    def forward(
        self,
        prev_tokens: torch.Tensor,  # (B, T) teacher-forced inputs
        encoder_out: torch.Tensor,  # (B, S, D)
        encoder_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    ) -> torch.Tensor:
        """Teacher-forced pass (training): (B, T, V) fp32 logits."""
        x = self.drop(self.pos(self.embed(prev_tokens) * self.embed_scale))
        self_bias = make_causal_bias(prev_tokens.shape[1], x.device)
        cross_bias = (make_padding_bias(encoder_padding_mask, torch.float32)
                      if encoder_padding_mask is not None else None)
        for layer in self.layers:
            x = layer(x, encoder_out, self_bias, cross_bias)
        return self._output(x)

    @property
    def layers(self) -> List[TransformerDecoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def init_state(
        self,
        encoder_out: torch.Tensor,
        encoder_padding_mask: Optional[torch.Tensor],
        max_len: int,
        kv_dtype: Optional[str] = None,
    ) -> DecoderState:
        """Pre-project encoder K/V per layer and allocate the stacked
        self-attention cache (B, L, H, max_len, 2·Dh) (S = 1 until
        ``tile_state_for_beams``).

        ``kv_dtype="int8"`` stores the cache as int8 with per-column,
        per-head f32 scales ``self_kv_sk``/``self_kv_sv`` (B, L, H, max_len),
        and the cross slab as int8 with its scales. ``"int4"`` also packs the
        self-attention cache two columns per byte, (B, L, H, max_len/2, 2·Dh),
        with max_len rounded up to even so a step's write never straddles
        the half boundary; its cross slab is int8. Other values keep the
        model's dtype."""
        if kv_dtype not in (None, "bfloat16", "float32", "int8", "int4"):
            raise ValueError(f"kv_cache_dtype={kv_dtype!r}: expected bfloat16, int8 or int4")
        self._no_packed_decode("beam decode")
        B = encoder_out.shape[0]
        H, Dh = self.num_heads, self.embed_dim // self.num_heads
        dev = encoder_out.device
        quant, int4 = kv_dtype in ("int8", "int4"), kv_dtype == "int4"
        if int4:
            max_len += max_len % 2
        state: DecoderState = {
            "step": 0,
            "self_kv": torch.zeros(
                (B, self.num_layers, H, max_len // 2 if int4 else max_len, 2 * Dh),
                dtype=torch.int8 if quant else encoder_out.dtype, device=dev,
            ),
            **self.init_cross(encoder_out, encoder_padding_mask, kv_dtype),
        }
        if quant:
            for key in ("self_kv_sk", "self_kv_sv"):
                state[key] = torch.zeros((B, self.num_layers, H, max_len), device=dev)
        return state

    def init_cross(self, encoder_out: torch.Tensor, encoder_padding_mask: Optional[torch.Tensor],
                   kv_dtype: Optional[str] = None) -> DecoderState:
        """The cross-attention part of :meth:`init_state`: ``cross``, each
        layer's packed encoder K‖V (int8 with its scales for an int8 or
        int4 cache), and ``cross_bias``."""
        quant = kv_dtype in ("int8", "int4")
        return {
            "cross": [
                layer.cross_attn.precompute_kv(encoder_out, kv_dtype="int8" if quant else None)
                for layer in self.layers
            ],
            "cross_bias": (
                make_padding_bias(encoder_padding_mask, encoder_out.dtype)
                if encoder_padding_mask is not None else None
            ),
        }

    @staticmethod
    def _flat_len(state: DecoderState) -> int:
        """Logical length of the cache's flattened (t·S + s) axis."""
        n = state["self_kv"].shape[3]
        return 2 * n if is_int4(state) else n

    def _self_attn_step(
        self, layer: TransformerDecoderLayer, x: torch.Tensor, state: DecoderState,
        layer_idx: int, flat_rep: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Single-token self-attention of every beam over the read-only
        stacked cache plus its own fresh token (kernel B, D or F)."""
        attn = layer.self_attn
        q = attn._split(attn.q_proj(x)) * attn.head_dim ** -0.5  # (N, 1, H, Dh)
        k_new = attn._split(attn.k_proj(x))
        v_new = attn._split(attn.v_proj(x))
        N = x.shape[0]
        kv = state["self_kv"]
        B, H, Dh = kv.shape[0], kv.shape[2], kv.shape[4] // 2
        K = N // B

        def to_bhkd(t):  # (N, 1, H, Dh) → (B, H, K, Dh)
            return t.reshape(B, K, H, Dh).transpose(1, 2)

        args = (to_bhkd(q), to_bhkd(k_new), to_bhkd(v_new), kv)
        if "self_kv_sk" not in state:
            out = ancestry_decode_attention(*args, flat_rep, layer_idx)
        else:
            fn = ancestry_decode_attention_i4 if is_int4(state) else ancestry_decode_attention_i8
            out = fn(*args, state["self_kv_sk"], state["self_kv_sv"], flat_rep, layer_idx)
        out = out.transpose(1, 2).reshape(N, 1, H * Dh)
        return attn.out_proj(out), k_new, v_new

    def prefill(
        self, prefix_tokens: torch.Tensor, prefix_len: int, state: DecoderState,
    ) -> Tuple[DecoderState, torch.Tensor]:
        """Teacher-forced prefill of a beam-tiled cache in one causal pass.

        ``prefix_tokens`` (B, P) holds BOS then the prefix, ``prefix_len``
        counts the real tokens (≤ P ≤ the cache's T). Every layer's K‖V of
        the P positions lands in beam slot 0 of steps 0..P-1, where stepwise
        decoding of the same tokens would put them (all beams share the
        prefix; the ancestry stays 0). Positions ≥ ``prefix_len`` hold pad
        rows that the step counter masks until decoding overwrites them.
        The self-attention over the prefix is plain PyTorch, as the
        reference computes it with einsums; the cross-attention is kernel C
        (E for an int8 slab) with P query rows. An int8 cache stores the
        rows quantized as a step would, while the pass itself attends to
        exact history. Updates ``state`` in place and returns it with
        ``step = prefix_len - 1`` (the search re-feeds the last prefix token)
        and ``prefix_logp`` (B,) = Σ_{t=1}^{len-1} log p(tok_t | tok_<t)."""
        self._no_packed_decode("prefill")
        if "ancestry" not in state:
            raise ValueError("prefill expects a beam-tiled state")
        if is_int4(state):
            raise NotImplementedError(
                "prefill supports float/bf16/int8 caches (int4 packs two columns per byte)"
            )
        kv = state["self_kv"]
        B, P = prefix_tokens.shape
        L, H, Dh = self.num_layers, kv.shape[2], kv.shape[4] // 2
        T_ = state["ancestry"].shape[2]
        S_ = kv.shape[3] // T_
        if P > T_:
            raise ValueError(f"prefill: {P} prefix positions exceed the cache's {T_} steps")
        x = self.embed(prefix_tokens) * self.embed_scale
        x = self.pos(x)
        causal = torch.tril(torch.ones((P, P), dtype=torch.bool, device=x.device))
        self_bias = torch.zeros((P, P), device=x.device).masked_fill(~causal, -1e9).to(x.dtype)
        new_ks, new_vs = [], []

        def causal_attn(layer, h):
            attn = layer.self_attn
            q = attn._split(attn.q_proj(h)) * attn.head_dim ** -0.5
            k_new = attn._split(attn.k_proj(h))  # (B, P, H, Dh)
            v_new = attn._split(attn.v_proj(h))
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_new.float()) + self_bias.float()
            wgt = torch.softmax(logits, dim=-1).to(h.dtype)
            new_ks.append(k_new)
            new_vs.append(v_new)
            out = torch.einsum("bhqk,bkhd->bqhd", wgt, v_new)
            return attn.out_proj(out.reshape(B, P, self.embed_dim))

        for i, layer in enumerate(self.layers):
            x = self._layer_step(layer, i, x, state, lambda h, layer=layer: causal_attn(layer, h))
        logp = torch.log_softmax(self._output(x), dim=-1)  # (B, P, V)
        # Position t predicts token t+1; only real (t+1 < prefix_len) transitions count.
        nxt = torch.cat([prefix_tokens[:, 1:], prefix_tokens[:, :1]], dim=1)
        tok_lp = torch.gather(logp, 2, nxt[..., None].long())[..., 0]
        real = torch.arange(P, device=x.device)[None, :] + 1 < int(prefix_len)
        prefix_logp = torch.where(real, tok_lp, torch.zeros_like(tok_lp)).sum(1)

        # Slot 0 of steps 0..P-1: the (t, s) axis is row-major, so a
        # (B, L, H, T, S, 2·Dh) view is the slot view and one strided write fills it.
        k_rows = torch.stack(new_ks, dim=1).transpose(2, 3)  # (B, L, H, P, Dh)
        v_rows = torch.stack(new_vs, dim=1).transpose(2, 3)
        kv5 = kv.view(B, L, H, T_, S_, 2 * Dh)
        if "self_kv_sk" in state:
            rows, sk, sv = quantize_rows(k_rows, v_rows, 127.0)
            kv5[:, :, :, :P, 0] = rows
            state["self_kv_sk"].view(B, L, H, T_, S_)[..., :P, 0] = sk
            state["self_kv_sv"].view(B, L, H, T_, S_)[..., :P, 0] = sv
        else:
            kv5[:, :, :, :P, 0] = torch.cat([k_rows, v_rows], dim=-1).to(kv.dtype)
        state["step"] = max(int(prefix_len) - 1, 0)
        return state, prefix_logp

    def step(self, prev_token: torch.Tensor, state: DecoderState) -> Tuple[torch.Tensor, DecoderState]:
        """One decode step of a beam-tiled state: (N, 1) tokens →
        ((N, V) fp32 logits, state) with ``state`` updated in place."""
        if "ancestry" not in state:
            raise NotImplementedError("only beam-tiled decoding is ported (tile_state_for_beams)")
        step_idx = state["step"]
        ancestry = state["ancestry"]
        T_ = ancestry.shape[2]
        S_ = self._flat_len(state) // T_  # cache slots per step: the beam count
        # Column j = t·S + s is on beam k's path iff ancestry[b, k, t] == s
        # and t is in the past; kernel B compares flat_rep against j.
        t_idx = torch.arange(T_, device=ancestry.device)[None, None, :]
        flat_idx = torch.where(
            t_idx < step_idx, t_idx * S_ + ancestry, torch.full_like(ancestry, -1)
        ).to(torch.int32)
        flat_rep = flat_idx.repeat_interleave(S_, dim=2)  # (B, K, T·S)
        logits = self._step_core(prev_token, state, step_idx, flat_rep, step_idx * S_)
        state["step"] = step_idx + 1
        return logits, state

    def serve_step(self, prev_token: torch.Tensor, state: DecoderState) -> Tuple[torch.Tensor, DecoderState]:
        """Continuous-batching decode step (``infer/serving.py``): (B·K, 1)
        tokens → ((B·K, V) fp32 logits, state), ``state`` updated in place.

        The cache's flattened (t·S) axis is a RING of T steps indexed by the
        global counter ``g`` (a host int shared by every slot, so the write
        position needs no device sync): every slot writes its rows at ring
        step g mod T, while each slot's logical time is its own
        ``local_step`` (B,). Ring step tp holds a live row of slot b iff
        (tp − ring_base[b]) mod T < local_step[b]; ``ancestry`` (B, K, T)
        holds the beam slot by PHYSICAL ring step. Validity and ancestry
        reach kernels B, D and F only through ``flat_rep``, so a wrapped
        window (the oldest live step physically after the newest) needs
        nothing else. Positions take each slot's own step."""
        ancestry = state["ancestry"]
        T_ = ancestry.shape[2]
        S_ = self._flat_len(state) // T_
        g, local = state["g"], state["local_step"]
        tp = torch.arange(T_, device=ancestry.device)
        valid = (tp[None, :] - state["ring_base"][:, None]) % T_ < local[:, None]  # (B, T)
        flat_idx = torch.where(valid[:, None, :], tp * S_ + ancestry,
                               torch.full_like(ancestry, -1)).to(torch.int32)
        flat_rep = flat_idx.repeat_interleave(S_, dim=2)  # (B, K, T·S)
        logits = self._step_core(prev_token, state, local.repeat_interleave(S_), flat_rep,
                                 (g % T_) * S_)
        state["g"] = g + 1
        state["local_step"] = (local + 1).clamp_max(T_ - 1)
        return logits, state

    def _layer_step(self, layer: TransformerDecoderLayer, i: int, x: torch.Tensor,
                    state: DecoderState, self_attn) -> torch.Tensor:
        """One layer of a decode step or a prefill: ``self_attn`` over the
        normed (pre-norm) or raw (post-norm) input, then the packed
        cross-attention (kernel C, E over an int8 slab) and the FFN."""
        x = layer.self_branch(x, self_attn)
        x = layer.cross_branch(x, lambda h: layer.cross_attn.packed_cross(
            h, state["cross"][i], state["cross_bias"]))
        return layer.ffn_branch(x)

    def _step_core(
        self, prev_token: torch.Tensor, state: DecoderState, pos_offset,
        flat_rep: torch.Tensor, write_pos: int,
    ) -> torch.Tensor:
        """embed → layers → logits, then ONE in-place cache write of this
        step's K‖V rows at flattened (logical) column ``write_pos``,
        quantized for an int8/int4 cache with its scales written beside it.
        ``pos_offset`` is the step (int), or each row's step ((N,) tensor)."""
        kv = state["self_kv"]
        x = self.embed(prev_token) * self.embed_scale
        x = self.pos(x, offset=pos_offset)
        new_ks, new_vs = [], []

        def self_attn(layer, i, h):
            out, k_new, v_new = self._self_attn_step(layer, h, state, i, flat_rep)
            new_ks.append(k_new)
            new_vs.append(v_new)
            return out

        for i, layer in enumerate(self.layers):
            x = self._layer_step(layer, i, x, state,
                                 lambda h, layer=layer, i=i: self_attn(layer, i, h))
        logits = self._output(x)[:, -1]
        B_, H_, Dh_ = kv.shape[0], kv.shape[2], kv.shape[4] // 2
        S_ = prev_token.shape[0] // B_

        def to_rows(per_layer):  # L × (N, 1, H, Dh) → (B, L, H, S, Dh)
            r = torch.stack(per_layer, dim=1).reshape(B_, S_, len(per_layer), H_, Dh_)
            return r.permute(0, 2, 3, 1, 4)

        k_rows, v_rows = to_rows(new_ks), to_rows(new_vs)
        write_step(kv, k_rows, v_rows, write_pos, state.get("self_kv_sk"), state.get("self_kv_sv"))
        return logits


class CTCHead(nn.Module):
    """The auxiliary CTC projection over encoder states (``ctc_head`` and
    the CTC multitask heads; flax name ``ctc_proj``): fp32 logits, whose
    loss is ``ops/ctc.ctc_loss``."""

    def __init__(self, embed_dim: int, vocab_size: int):
        super().__init__()
        self.ctc_proj = nn.Linear(embed_dim, vocab_size)

    def forward(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return self.ctc_proj(encoder_out).float()
