"""Streaming (chunked) speech encoding and re-translation S2ST.

Port of ``mm_s2ut/infer/streaming.py``. Fbank chunks go in; encoder rows
come out incrementally, equal to one offline forward of the causal
encoder (``SpeechTransformerEncoder(causal_attention=True,
attention_window=W)``) over the fed frames, and ``StreamingS2ST`` commits
the agreement prefix of consecutive re-translations.

* The conv subsampler runs on a fixed-width window of the newest frames
  (the chunk plus its receptive-field halo), and only *mature* rows —
  whose receptive field [4u − h, 4u + h] has arrived — are emitted, so
  per-feed cost is O(chunk) and the rows equal offline.
* Each encoder layer keeps a K/V cache on the device, written in place;
  a feed's rows attend to the cache through a block bias (column
  j ≤ position, and j > position − W with a window) in plain PyTorch, as
  the reference computes it outside its kernels. The offline causal
  encoder runs kernel G; this path runs none of it.
* The stack shares the offline encoder's modules (``subsampler``,
  ``pos``, ``layer{i}``, ``final_layer_norm``), so one checkpoint serves
  offline and streaming inference.

The reference's jitted closures (one program per feed shape) become plain
method calls.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from mm_s2ut_torch.infer.beam_search import beam_search, tile_state_for_beams
from mm_s2ut_torch.models.layers import NEG_INF, TransformerEncoderLayer, sublayer, subsampled_length
from mm_s2ut_torch.models.s2t_encoder import SpeechTransformerEncoder


def conv_input_halo(kernel_sizes: Tuple[int, ...] = (5, 5)) -> int:
    """One-sided receptive field of the stride-2 conv stack in input
    frames: output row u depends on inputs [S·u − h, S·u + h] with
    S = 2^n_convs (h = 6 for the default (5, 5) stack)."""
    h = 0
    for k in reversed(kernel_sizes):
        h = 2 * h + k // 2
    return h


def mature_subsampled(n_input_frames: int, kernel_sizes: Tuple[int, ...] = (5, 5)) -> int:
    """Subsampled rows whose receptive field [S·u−h, S·u+h] is complete
    given ``n_input_frames`` received input frames."""
    stride = 2 ** len(kernel_sizes)
    h = conv_input_halo(kernel_sizes)
    return max(0, (n_input_frames - 1 - h) // stride + 1)


def streaming_layer(
    layer: TransformerEncoderLayer, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
) -> torch.Tensor:
    """One encoder layer (pre- or post-norm, as the layer is built) for
    ``x`` (B, Tn, E), the rows at positions index .. index+Tn-1, over its
    K/V cache (B, T_max, H, Dh) each, which this call extends in place."""
    x = sublayer(layer.self_attn_layer_norm, layer.normalize_before, x,
                 lambda h: _cached_attention(layer, h, cache, index))
    return sublayer(layer.final_layer_norm, layer.normalize_before, x, layer.ffn)


def _cached_attention(layer: TransformerEncoderLayer, h: torch.Tensor,
                      cache: Dict[str, torch.Tensor], index: int) -> torch.Tensor:
    """The layer's self-attention of rows ``h`` over its cache: the
    reference's block bias (column j ≤ position, j > position − W) plus its
    unwritten-tail bias (j ≥ index + Tn), both −1e9 and summed in the
    model's dtype."""
    attn = layer.self_attn
    B, Tn, _ = h.shape
    q = attn._split(attn.q_proj(h)) * attn.head_dim ** -0.5
    cache["k"][:, index : index + Tn] = attn._split(attn.k_proj(h))
    cache["v"][:, index : index + Tn] = attn._split(attn.v_proj(h))
    k, v = cache["k"], cache["v"]
    j = torch.arange(k.shape[1], device=h.device)[None, :]
    pos_q = index + torch.arange(Tn, device=h.device)[:, None]
    allowed = j <= pos_q
    if layer.window > 0:
        allowed = allowed & (j > pos_q - layer.window)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    neg = torch.full((), NEG_INF, dtype=h.dtype, device=h.device)
    bias = torch.where(allowed, zero, neg) + torch.where(j < index + Tn, zero, neg)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias.float()
    weights = torch.softmax(logits, dim=-1).to(h.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Tn, attn.embed_dim)
    return attn.out_proj(out)


class StreamingEncoderStack(nn.Module):
    """One feed: a fixed-width window of the newest feature frames →
    subsampler → the new mature rows → incremental layers → final LN.
    Its submodules ARE the offline encoder's (shared, not copied).

    The window starts ``conv_input_halo`` frames before the first new
    row's receptive field, so the rows sliced out at ``local_start`` see
    only real data (the subsampler's zero edge padding corrupts only the
    discarded leading rows)."""

    def __init__(self, encoder: SpeechTransformerEncoder):
        super().__init__()
        if encoder.pipelined:
            raise ValueError("a pipelined encoder streams as the sequential one: load its "
                             "checkpoint with mm_s2ut_torch.inference.load_model")
        self.embed_dim = encoder.embed_dim
        self.num_layers = encoder.num_layers
        self.subsampler = encoder.subsampler
        self.pos = encoder.pos
        for i in range(encoder.num_layers):
            self.add_module(f"layer{i}", getattr(encoder, f"layer{i}"))
        self.final_layer_norm = getattr(encoder, "final_layer_norm", nn.Identity())

    def forward(
        self,
        feat_win: torch.Tensor,  # (B, W_f, F) newest feature frames
        win_valid: torch.Tensor,  # (B,) valid frames in the window
        emitted: int,  # subsampled rows already emitted
        local_start: int,  # first new row, in window coordinates
        n_new: int,  # mature new rows this feed
        caches: List[Dict[str, torch.Tensor]],
    ) -> torch.Tensor:
        dtype = self.subsampler.conv0.weight.dtype
        x_all, _ = self.subsampler(feat_win.to(dtype), win_valid)
        x = x_all[:, local_start : local_start + n_new] * math.sqrt(self.embed_dim)
        x = self.pos(x, offset=emitted)
        for i in range(self.num_layers):
            x = streaming_layer(getattr(self, f"layer{i}"), x, caches[i], emitted)
        return self.final_layer_norm(x)


class StreamingEncoderSession:
    """Accumulate feature chunks, emit encoder rows.

    ``feed(chunk)`` takes (B, T ≤ chunk_frames, F) with every row fully
    valid (synchronized live streams); the last feed of a stream may be
    shorter. ``finalize()`` flushes the immature tail and returns the
    assembled (B, T_sub, D) encoder output and lengths. Everything lives
    on the encoder's device: the frame buffer, the per-layer K/V caches
    and the emitted rows."""

    def __init__(
        self,
        encoder: SpeechTransformerEncoder,
        *,
        batch: int,
        chunk_frames: int,
        max_frames: int,
        feat_dim: int = 80,
    ):
        self.stack = StreamingEncoderStack(encoder)
        layer0 = encoder.layer0.self_attn
        dtype = encoder.subsampler.conv0.weight.dtype
        self.device = device = encoder.subsampler.conv0.weight.device
        self.B, self.F = batch, feat_dim
        self.chunk = chunk_frames
        self.max_frames = max_frames
        self.kernels = tuple(encoder.subsampler.kernel_sizes)
        self.stride = 2 ** len(self.kernels)
        self.halo = conv_input_halo(self.kernels)
        self.hrows = -(-self.halo // self.stride)  # discarded left rows
        self.sub_max = subsampled_length(max_frames, len(self.kernels))
        # Feature window: the incoming chunk + the left receptive-field
        # halo (stride·hrows) + the immature carry-over (< halo + stride).
        self.win = chunk_frames + self.halo + self.stride * (self.hrows + 1)
        shape = (batch, self.sub_max, layer0.num_heads, layer0.head_dim)
        self.caches = [
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(encoder.num_layers)
        ]
        self.feat_buf = torch.zeros((batch, max_frames, feat_dim), device=device)
        self.n_frames = 0
        self.emitted = 0
        self.outputs: List[torch.Tensor] = []

    @torch.no_grad()
    def _emit(self, n_new: int) -> torch.Tensor:
        if n_new <= 0:
            return torch.zeros((self.B, 0, self.stack.embed_dim), device=self.device)
        # Window = frames [s, n_frames): a full conv halo before the first
        # new row's receptive field (or the true stream start), so every
        # sliced row sees only real data.
        s = self.stride * max(0, self.emitted - self.hrows)
        if self.n_frames - s > self.win:  # pragma: no cover - sizing invariant
            raise AssertionError(f"window overflow: {self.n_frames - s} > {self.win}")
        win = torch.zeros((self.B, self.win, self.F), device=self.device)
        win[:, : self.n_frames - s] = self.feat_buf[:, s : self.n_frames]
        valid = torch.full((self.B,), self.n_frames - s, dtype=torch.long, device=self.device)
        out = self.stack(win, valid, self.emitted, self.emitted - s // self.stride, n_new,
                         self.caches)
        self.emitted += n_new
        self.outputs.append(out)
        return out

    def reset(self) -> None:
        """Start a new stream on the same session. The caches are reused
        without zeroing: the block bias only ever admits columns j ≤ the
        query's position, all of which the new stream has re-written."""
        self.n_frames = 0
        self.emitted = 0
        self.outputs = []

    def feed(self, chunk) -> torch.Tensor:
        """Add (B, T ≤ chunk_frames, F) frames (a tensor or an array);
        returns the new mature encoder rows (B, n_new, D) — the offline
        causal encoder's rows [emitted : emitted + n_new]."""
        if (
            chunk.ndim != 3
            or chunk.shape[0] != self.B
            or chunk.shape[2] != self.F
            or not 0 < chunk.shape[1] <= self.chunk
        ):
            raise ValueError(
                f"expected (B={self.B}, 0<T<={self.chunk}, F={self.F}), got {tuple(chunk.shape)}"
            )
        t = chunk.shape[1]
        if self.n_frames + t > self.max_frames:
            raise ValueError("stream exceeds max_frames")
        self.feat_buf[:, self.n_frames : self.n_frames + t] = torch.as_tensor(chunk).to(
            self.device, torch.float32)
        self.n_frames += t
        return self._emit(mature_subsampled(self.n_frames, self.kernels) - self.emitted)

    def finalize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flush the immature tail; returns (encoder_out (B, T_sub, D),
        lengths (B,))."""
        total = subsampled_length(self.n_frames, len(self.kernels))
        self._emit(total - self.emitted)
        out = (torch.cat(self.outputs, dim=1) if self.outputs
               else torch.zeros((self.B, 0, self.stack.embed_dim), device=self.device))
        return out, torch.full((self.B,), total, dtype=torch.long, device=self.device)


def retranslation_commit(prev_hyp: List[int], hyp: List[int], committed: List[int]) -> List[int]:
    """Units to commit this step: the agreement prefix of consecutive
    re-translations — but only when it still EXTENDS what was already
    committed (a hypothesis that flipped away and re-stabilized on another
    string would otherwise splice two hypotheses; finalize() reports the
    true final string)."""
    common = 0
    for a, b in zip(prev_hyp, hyp):
        if a != b:
            break
        common += 1
    stable = hyp[:common]
    if len(stable) > len(committed) and stable[: len(committed)] == committed:
        return stable[len(committed):]
    return []


class StreamingS2ST:
    """Incremental S2ST by re-translation: feed fbank chunks, receive
    COMMITTED unit prefix increments.

    After each chunk (every ``decode_every``-th), a beam search over the
    encoder prefix (padded to the session's full length, so every search
    has one shape) re-translates, and the longest common prefix of
    consecutive hypotheses is committed. With ``prefix_reuse`` the search
    continues from the committed prefix, prefilled in one pass
    (``UnitDecoder.prefill``), for at most ``max_new_tokens`` steps.
    ``finalize()`` returns the full final hypothesis: a full search, equal
    to offline decoding of the fed frames.

    Needs a causal-encoder config (``encoder_causal_attention: true``) on
    the speech-only branch. The model runs on ``device`` (default: where
    it is; otherwise it is moved there)."""

    def __init__(
        self,
        model,
        *,
        chunk_frames: int,
        max_frames: int,
        beam: int = 5,
        max_len: int = 200,
        len_penalty: float = 1.0,
        unk_penalty: float = 0.0,
        kv_cache_dtype: Optional[str] = None,
        eos_id: int = 2,
        bos_id: int = 2,
        pad_id: int = 1,
        unk_id: int = 3,
        decode_every: int = 1,
        prefix_reuse: bool = False,
        max_new_tokens: int = 48,
        device=None,
    ):
        cfg = model.cfg
        if not cfg.encoder_causal_attention:
            raise ValueError(
                "StreamingS2ST needs encoder_causal_attention=True "
                "(offline-masked encoders can't be computed incrementally)"
            )
        if cfg.multimodal.multimodal_attention_type:
            raise ValueError("StreamingS2ST v1 supports the speech-only flagship branch")
        if device is not None:
            model.to(device)
        self.model = model
        self.device = model.device
        self.beam, self.max_len = beam, max_len
        self.search_kw = dict(
            beam_size=beam, max_len=max_len, eos_id=eos_id, bos_id=bos_id, pad_id=pad_id,
            vocab_size=cfg.vocab_size, len_penalty=len_penalty, unk_penalty=unk_penalty,
            unk_id=unk_id,
        )
        self.kv_cache_dtype = kv_cache_dtype
        self.decode_every = decode_every
        self.prefix_reuse = prefix_reuse
        self.max_new_tokens = max_new_tokens
        self.eos, self.pad, self.bos = eos_id, pad_id, bos_id
        self.enc = StreamingEncoderSession(
            model.encoder, batch=1, chunk_frames=chunk_frames, max_frames=max_frames,
            feat_dim=cfg.input_feat_per_channel * cfg.input_channels,
        )
        self.sub_max = self.enc.sub_max
        self.committed: List[int] = []
        self._prev_hyp: List[int] = []
        self._feeds = 0

    def _init_state(self):
        """The decoder state over the encoder prefix, padded to sub_max rows."""
        n = self.enc.emitted
        dtype = self.enc.outputs[0].dtype
        enc_out = torch.zeros((1, self.sub_max, self.model.cfg.encoder_embed_dim), dtype=dtype,
                              device=self.device)
        enc_out[:, :n] = torch.cat(self.enc.outputs, dim=1)
        enc_mask = torch.arange(self.sub_max, device=self.device)[None, :] >= n
        enc = {"encoder_out": enc_out, "encoder_padding_mask": enc_mask}
        state = self.model.decode_init(enc, self.max_len + 1, kv_dtype=self.kv_cache_dtype)
        return tile_state_for_beams(state, self.beam)

    def _hyp(self, seqs: torch.Tensor) -> List[int]:
        toks = seqs[0, 0].tolist()
        if self.eos in toks:
            toks = toks[: toks.index(self.eos)]
        return [t for t in toks if t != self.pad]

    @torch.no_grad()
    def _decode_prefix(self) -> List[int]:
        """Full re-translation of the encoder prefix."""
        if self.enc.emitted == 0:
            return []
        seqs, _ = beam_search(self.model.decode_step, self._init_state(), 1, **self.search_kw)
        return self._hyp(seqs)

    @torch.no_grad()
    def _decode_continuation(self) -> List[int]:
        """Constrained re-decode: continue from the committed prefix's
        prefilled cache for at most ``max_new_tokens`` steps. The
        hypothesis always extends ``committed``."""
        if self.enc.emitted == 0:
            return []
        P = self.max_len + 1
        pfx = self.committed[: self.max_len]
        ptoks = torch.full((1, P), self.pad, dtype=torch.long, device=self.device)
        ptoks[0, 0] = self.bos
        ptoks[0, 1 : 1 + len(pfx)] = torch.tensor(pfx, dtype=torch.long)
        plen = 1 + len(pfx)
        state, plogp = self.model.decode_prefill(ptoks, plen, self._init_state())
        seqs, _ = beam_search(
            self.model.decode_step, state, 1, prefix_tokens=ptoks, prefix_len=plen,
            prefix_logp=plogp, max_new=self.max_new_tokens, **self.search_kw,
        )
        return self._hyp(seqs)

    def reset(self) -> None:
        """Start the next utterance on the same session."""
        self.enc.reset()
        self.committed = []
        self._prev_hyp = []
        self._feeds = 0

    def feed(self, chunk) -> List[int]:
        """(1, T ≤ chunk_frames, F) → newly COMMITTED units (may be empty).
        With ``decode_every`` = N > 1 only every Nth feed searches; the
        others extend the encoder and commit nothing."""
        self.enc.feed(chunk)
        self._feeds += 1
        if self._feeds % max(self.decode_every, 1):
            return []
        hyp = self._decode_continuation() if self.prefix_reuse else self._decode_prefix()
        new = retranslation_commit(self._prev_hyp, hyp, self.committed)
        self.committed += new
        self._prev_hyp = hyp
        return new

    def finalize(self) -> List[int]:
        """Flush the encoder tail; returns the FULL final hypothesis
        (offline decoding of the fed frames)."""
        self.enc.finalize()
        hyp = self._decode_prefix()
        self.committed = hyp
        return hyp
