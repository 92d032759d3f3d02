"""Transformer building blocks of the port.

Port of ``mm_s2ut/models/layers.py``: sinusoidal positions, the
cache-free self-attention (kernel A, or G under a causal mask; kernel H
in its backward), the dense attention of the teacher-forced decoder
(plain einsums, as in the reference), the decode-time packed
cross-attention (kernel C, or E over an int8 slab) and its K/V
precompute, the feed-forward block (relu, gelu in its tanh form as
``jax.nn.gelu``, silu/swish, tanh; ``glu`` raises, as the reference maps
it to no function), pre-norm or post-norm encoder and decoder layers, the
conv subsampler and the mask helpers.

Training mode (``module.train()``) turns on the reference's dropouts:
hash dropout on the residual branches and the activations, attention
dropout inside A/G/H for the encoder, Bernoulli dropout on the dense
attention weights (``ops/dropout.py``). Under ``torch.autocast`` the
logits and the tied output projection stay fp32 from operands rounded to
the compute dtype, as the reference's ``preferred_element_type``.

Under tensor parallelism (``parallel/tensor.py``) a layer whose
projections are cut runs on its rank's slice: the attention on its heads
(kernels A, G and H on H/model heads, the dropout hashing their global
heads), the FFN on its columns of the activations (their dropout hashing
the global column); ``out_proj`` and ``fc2`` sum their partial products
over the group and add their bias once. An encoder layer given a
:class:`~mm_s2ut_torch.parallel.tensor.SeqShard` (sequence parallelism)
holds its rows of T between those sums: its LayerNorms and residual
dropout run on them, the dropout hashing the global row.

Submodule names mirror the flax parameter tree (``self_attn.q_proj``,
``ffn.fc1``, ``subsampler.conv0`` …) so that ``convert.from_flax`` maps
parameters by path. Every LayerNorm uses flax's default epsilon 1e-6,
as the reference's modules do (``ModelConfig.layernorm_eps`` is read by
neither package).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mm_s2ut_torch.ops.attention import flash_attention_biased
from mm_s2ut_torch.ops.decode_attention import cross_decode_attention, cross_decode_attention_i8
from mm_s2ut_torch.ops.dropout import BernoulliDropout, DropoutRng, HashDropout, need_rng
from mm_s2ut_torch.parallel.tensor import RowParallelLinear, SeqShard, enter, heads_of, leave

NEG_INF = -1e9  # additive mask value
# Any integer routes causal self-attention to kernel G (key-tile skipping);
# the kernel's key tile is its own (ops/attention.flash_attention).
CAUSAL_BLOCK_K = 64
LN_EPS = 1e-6  # flax nn.LayerNorm default


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
}


def get_activation(name: str):
    """The reference's activation table (``get_activation``); its ``glu``
    entry is no function, so it raises here too."""
    if name not in ACTIVATIONS:
        raise NotImplementedError(f"activation_fn={name!r} is not supported")
    return ACTIVATIONS[name]


def sublayer(norm: nn.LayerNorm, normalize_before: bool, x: torch.Tensor, fn) -> torch.Tensor:
    """One residual branch: x + fn(LN(x)) pre-norm, LN(x + fn(x)) post-norm."""
    if normalize_before:
        return x + fn(norm(x))
    return norm(x + fn(x))


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype matmuls run in: autocast's when it is on, else ``t``'s."""
    dev = t.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else t.dtype


def fp32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 einsum of the operands as they are (autocast would round the
    product to its dtype)."""
    with torch.autocast(a.device.type, enabled=False):
        return torch.einsum(eq, a.float(), b.float())


def make_causal_bias(t: int, device) -> torch.Tensor:
    """(1, 1, T, T) additive causal bias."""
    allowed = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    return torch.zeros((t, t), device=device).masked_fill(~allowed, NEG_INF)[None, None]


def make_padding_bias(padding_mask: torch.Tensor, dtype) -> torch.Tensor:
    """(B, Tk) bool (True = pad) → (B, 1, 1, Tk) additive bias."""
    bias = torch.zeros(padding_mask.shape, dtype=torch.float32, device=padding_mask.device)
    return bias.masked_fill(padding_mask, NEG_INF).to(dtype)[:, None, None, :]


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) → (B, T) bool mask, True where padded."""
    return torch.arange(max_len, device=lengths.device)[None, :] >= lengths[:, None]


class SinusoidalPositionalEmbedding(nn.Module):
    """Fairseq-convention positions (start at padding_idx + 1 = 2),
    computed on the fly in fp32 and added in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor, offset=0) -> torch.Tensor:
        """x (N, T, D); ``offset`` an int start position (a decode step), or
        an (N,) tensor of per-row start positions (continuous batching,
        where co-scheduled utterances sit at different steps)."""
        t = x.shape[1]
        half = self.dim // 2
        emb = math.log(10000.0) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device) * -emb)
        pos = torch.arange(t, dtype=torch.float32, device=x.device) + 2.0
        if isinstance(offset, torch.Tensor):
            pos = pos[None, :] + offset.to(device=x.device, dtype=torch.float32)[:, None]
        else:
            pos = (pos + float(offset))[None] if offset else pos[None]
        args = pos[..., None] * freqs
        pe = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
        return x + pe.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections with three attention forms: cache-free
    self-attention (encoder, kernel A; attention dropout in-kernel in
    training), dense attention (the teacher-forced decoder; Bernoulli
    dropout on the weights in training) and cross-attention over a
    precomputed packed K‖V slab (decoder, kernel C, or E when the slab is
    int8). The decoder's incremental self-attention lives in
    ``UnitDecoder._self_attn_step`` (kernel B), as in the reference."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must divide num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        kdim = kdim or embed_dim  # the width of what the keys and values are made from
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(kdim, embed_dim)
        self.v_proj = nn.Linear(kdim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.drop = BernoulliDropout(dropout)
        self.rng: Optional[DropoutRng] = None  # seeds of the in-kernel dropout

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, -1, self.head_dim)  # every head, or a rank's under TP

    def forward(
        self, query: torch.Tensor, key_bias: torch.Tensor, causal: bool = False, window: int = 0,
        seq: Optional[SeqShard] = None,
    ) -> torch.Tensor:
        """Self-attention over ``query`` (B, T, E) with the (B, T) f32
        additive key bias of its padding (``ops.attention.padding_bias``,
        built once for all layers); ``causal`` (+ ``window``) masks
        position-causally, through kernel G. In training, attention dropout
        with a fresh seed per call. Under tensor parallelism, on this
        rank's heads; with ``seq``, ``query`` and the result are this
        rank's rows of T."""
        tp = heads_of(self)
        rate = self.dropout if self.training else 0.0
        seed, row0 = None, 0
        if rate > 0.0:
            rng = need_rng(self)
            seed, row0 = rng.next_seed(), rng.row0
        attend = dict(causal=causal, window=window, block_k=CAUSAL_BLOCK_K if causal else None,
                      dropout_rate=rate, dropout_seed=seed, dropout_row0=row0)
        if tp is None:
            q = self._split(self.q_proj(query))
            k = self._split(self.k_proj(query))
            v = self._split(self.v_proj(query))
            out = flash_attention_biased(q, k, v, key_bias, **attend)
            return self.out_proj(out.reshape(*query.shape[:2], self.embed_dim))
        x = enter(query, tp, seq)
        q, k, v = (self._split(p.local(x)) for p in (self.q_proj, self.k_proj, self.v_proj))
        out = flash_attention_biased(q, k, v, key_bias, **attend, h_total=self.num_heads,
                                     h0=tp.rank * q.shape[2])
        part = self.out_proj.partial(out.reshape(*x.shape[:2], -1))
        return leave(part, tp, seq) + self.out_proj.bias

    def dense(self, query: torch.Tensor, key: torch.Tensor,
              bias: Optional[torch.Tensor], value: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reference's dense path: softmax(q.kᵀ/√Dh + bias) over ``key``
        (B, S, kdim) with fp32 logits, weights in the compute dtype (dropped
        in training), then · v, projected from ``value`` (``key`` when it is
        None). Plain PyTorch, as the reference's einsums. Under tensor
        parallelism, on this rank's heads, whose dropout draws every
        head's uniforms and takes its own."""
        value = key if value is None else value
        tp = heads_of(self)
        if tp is None:
            q = self._split(self.q_proj(query)) * self.head_dim ** -0.5
            k = self._split(self.k_proj(key))
            v = self._split(self.v_proj(value))
            proj = self.out_proj
        else:
            xq = enter(query, tp, None)
            xk = xq if key is query else enter(key, tp, None)
            xv = xk if value is key else enter(value, tp, None)
            q = self._split(self.q_proj.local(xq)) * self.head_dim ** -0.5
            k = self._split(self.k_proj.local(xk))
            v = self._split(self.v_proj.local(xv))

            def proj(o):
                return leave(self.out_proj.partial(o), tp, None) + self.out_proj.bias
        logits = fp32_einsum("bqhd,bkhd->bhqk", q, k)
        if bias is not None:
            logits = logits + bias.float()
        at = None if tp is None else ((tp.rank * q.shape[2], 0, 0), (self.num_heads,
                                                                     *logits.shape[2:]))
        weights = self.drop(torch.softmax(logits, dim=-1).to(q.dtype), at)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return proj(out.reshape(*query.shape[:2], -1))

    def precompute_kv(
        self, key: torch.Tensor, kv_dtype: Optional[str] = None
    ) -> Dict[str, torch.Tensor]:
        """Project encoder states once per decode into ONE interleaved
        (B, H, S, 2·Dh) slab in decode storage order.

        ``kv_dtype="int8"`` quantizes the slab per source column and head
        (symmetric, scale = amax/127 over Dh, stored unclamped; the divisor
        is clamped at 1e-20) and returns the f32 dequant scales ``sk``/``sv``
        (B, H, S) beside it."""
        k = self._split(self.k_proj(key)).transpose(1, 2)
        v = self._split(self.v_proj(key)).transpose(1, 2)
        if kv_dtype != "int8":
            return {"kv": torch.cat([k, v], dim=-1).contiguous()}
        kf, vf = k.float(), v.float()
        sk = kf.abs().amax(-1) / 127.0
        sv = vf.abs().amax(-1) / 127.0
        k_q = torch.round(kf / sk.clamp_min(1e-20)[..., None])
        v_q = torch.round(vf / sv.clamp_min(1e-20)[..., None])
        kv_q = torch.cat([k_q, v_q], dim=-1).clamp(-127, 127).to(torch.int8)
        return {"kv": kv_q.contiguous(), "sk": sk.contiguous(), "sv": sv.contiguous()}

    def packed_cross(
        self, query: torch.Tensor, cache: Dict[str, torch.Tensor], bias: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """query (B·K, Tq, E); ``cache`` from :meth:`precompute_kv`; bias
        (B, 1, 1, S) or None. The K beams of a batch row share its slab
        (beam-broadcast read); a slab with scales takes kernel E."""
        q = self._split(self.q_proj(query)) * self.head_dim ** -0.5
        kv = cache["kv"]
        B, H, S, _ = kv.shape
        BK, Tq = q.shape[:2]
        K = BK // B
        qb = q.reshape(B, K * Tq, H, self.head_dim).transpose(1, 2)
        bias_row = (
            torch.zeros((B, S), dtype=torch.float32, device=kv.device) if bias is None
            else bias.float().reshape(B, -1, S)[:, -1]
        )
        if "sk" in cache:
            out = cross_decode_attention_i8(qb, kv, cache["sk"], cache["sv"], bias_row)
        else:
            out = cross_decode_attention(qb, kv, bias_row)
        out = out.transpose(1, 2).reshape(BK, Tq, self.embed_dim)
        return self.out_proj(out)


class FeedForward(nn.Module):
    """fc2(drop(act(fc1(x)))), hash dropout on the activation in training.
    Under tensor parallelism, on this rank's columns of the activation,
    the dropout hashing their global index; with ``seq``, ``x`` and the
    result are this rank's rows of T."""

    def __init__(self, embed_dim: int, ffn_dim: int, activation_dropout: float = 0.0,
                 activation: str = "relu"):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)
        self.drop = HashDropout(activation_dropout)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, seq: Optional[SeqShard] = None) -> torch.Tensor:
        tp = getattr(self.fc1, "tp", None)
        if tp is None or not isinstance(self.fc2, RowParallelLinear):
            return self.fc2(self.drop(self.act(self.fc1(x))))
        x = enter(x, tp, seq)
        h = self.act(self.fc1.local(x))
        h = self.drop(h, ((0, tp.rank * h.shape[2]), (h.shape[1], self.fc1.out_features)))
        return leave(self.fc2.partial(h), tp, seq) + self.fc2.bias


class TransformerEncoderLayer(nn.Module):
    """Pre-norm: x + drop(attn(LN(x))), then x + drop(ffn(LN(x))); post-norm
    (``normalize_before=False``) LN(x + drop(attn(x))), then the same for
    the FFN. ``causal`` (+ ``window``) makes the self-attention
    position-causal."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 causal: bool = False, window: int = 0, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 activation: str = "relu", normalize_before: bool = True):
        super().__init__()
        self.causal, self.window = causal, window
        self.normalize_before = normalize_before
        self.self_attn_layer_norm = layer_norm(embed_dim)
        self.final_layer_norm = layer_norm(embed_dim)
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, attention_dropout)
        self.ffn = FeedForward(embed_dim, ffn_dim, activation_dropout, activation)
        self.drop = HashDropout(dropout)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor,
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        """``key_bias``: the (B, T) f32 additive bias of the padding;
        ``seq``: ``x`` is this rank's rows of T (sequence parallelism)."""
        pre = self.normalize_before
        at = None if seq is None else seq.at(x.shape[2])
        x = sublayer(self.self_attn_layer_norm, pre, x, lambda h: self.drop(
            self.self_attn(h, key_bias, self.causal, self.window, seq), at))
        return sublayer(self.final_layer_norm, pre, x, lambda h: self.drop(self.ffn(h, seq), at))

    def seed_draws(self) -> int:
        """The hash seeds one call in training draws: the attention's, the
        two residual branches' and the FFN activation's, each where its
        rate is above 0 (the pipelined stack replays them per microbatch)."""
        return (int(self.self_attn.dropout > 0) + 2 * int(self.drop.rate > 0)
                + int(self.ffn.drop.rate > 0))


class TransformerDecoderLayer(nn.Module):
    """One decoder layer, pre-norm or post-norm as the encoder's. Its three
    residual branches are :meth:`self_branch`, :meth:`cross_branch` and
    :meth:`ffn_branch`; :meth:`forward` is the teacher-forced pass of
    training, and ``UnitDecoder._step_core`` / ``prefill`` run the same
    branches with the decode-time attention."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 activation: str = "relu", normalize_before: bool = True):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, attention_dropout)
        self.cross_attn = MultiHeadAttention(embed_dim, num_heads, attention_dropout)
        self.self_attn_layer_norm = layer_norm(embed_dim)
        self.cross_attn_layer_norm = layer_norm(embed_dim)
        self.final_layer_norm = layer_norm(embed_dim)
        self.ffn = FeedForward(embed_dim, ffn_dim, activation_dropout, activation)
        self.drop = HashDropout(dropout)

    def self_branch(self, x: torch.Tensor, attn) -> torch.Tensor:
        return sublayer(self.self_attn_layer_norm, self.normalize_before, x,
                        lambda h: self.drop(attn(h)))

    def cross_branch(self, x: torch.Tensor, attn) -> torch.Tensor:
        return sublayer(self.cross_attn_layer_norm, self.normalize_before, x,
                        lambda h: self.drop(attn(h)))

    def ffn_branch(self, x: torch.Tensor) -> torch.Tensor:
        return sublayer(self.final_layer_norm, self.normalize_before, x,
                        lambda h: self.drop(self.ffn(h)))

    def forward(self, x: torch.Tensor, encoder_out: torch.Tensor, self_bias: torch.Tensor,
                cross_bias: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.self_branch(x, lambda h: self.self_attn.dense(h, h, self_bias))
        x = self.cross_branch(x, lambda h: self.cross_attn.dense(h, encoder_out, cross_bias))
        return self.ffn_branch(x)


class Conv1dSubsampler(nn.Module):
    """Stride-2 Conv1d + GLU stages (4× downsampling for two stages)."""

    def __init__(self, in_dim: int, mid_channels: int, out_dim: int,
                 kernel_sizes: Sequence[int] = (5, 5)):
        super().__init__()
        n = len(kernel_sizes)
        self.n = n
        self.kernel_sizes = tuple(kernel_sizes)
        ch_in = in_dim
        for i, k in enumerate(kernel_sizes):
            out_ch = mid_channels if i < n - 1 else out_dim * 2
            self.add_module(f"conv{i}", nn.Conv1d(ch_in, out_ch, k, stride=2, padding=k // 2))
            ch_in = out_ch // 2

    def forward(
        self, x: torch.Tensor, lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, F) features → (B, T', out_dim), updated lengths."""
        x = x.transpose(1, 2)
        for i in range(self.n):
            conv = getattr(self, f"conv{i}")
            # One row per call: a batched conv can round a row by the batch's
            # size (oneDNN does on the CPU, cuDNN in bf16 and TF32 on the
            # card: tools/host_cost.py subsampler), which a 4-bit cache can
            # turn into another hypothesis between a served wave and a
            # one-utterance search.
            x = F.glu(torch.cat([conv(row) for row in x.split(1)]), dim=1)
            lengths = (lengths - 1) // 2 + 1
            # Zero padded frames between convs: the conv bias makes them
            # nonzero and the next conv reads them near the pad boundary.
            valid = torch.arange(x.shape[2], device=x.device)[None, :] < lengths[:, None]
            x = x * valid[:, None, :].to(x.dtype)
        return x.transpose(1, 2), lengths


def subsampled_length(length: int, n_convs: int = 2) -> int:
    """Output rows of the stride-2 conv stack for ``length`` input frames."""
    for _ in range(n_convs):
        length = (length - 1) // 2 + 1
    return length
