"""Speech transformer encoder (conv-subsample branch) of the port.

Port of ``mm_s2ut/models/s2t_encoder.py``: (B, T, 80)
log-mels → Conv1dSubsampler (4×) → scaled sinusoidal positions → hash
dropout (training) → N pre-norm (or post-norm) layers whose self-attention is kernel A, or with
``causal_attention`` kernel G (position i attends to j ≤ i, and j > i − W
with ``attention_window`` W), and kernel H in the backward → a final
LayerNorm when pre-norm. ``return_all_states`` also returns every layer's
output (``encoder_states``), as the reference does for the fusion
variants that read them. The reference pads the frame axis to a multiple of 16 on the
TPU for its kernel; A, G and H take any length, so nothing is padded
here. The causal
mask replaces masked logits (the reference's flash route); its folded-bias
route adds −1e9 instead, which gives the same rows wherever a row's band
holds a real key, i.e. on every unpadded row. With
``checkpoint_activations`` each layer is rematerialised in training (the
reference's ``nn.remat``), its dropout drawn again as in the forward
(``ops.dropout.checkpoint``).

Sequence parallelism (``model.sequence_parallel`` under a model axis > 1,
:meth:`SpeechTransformerEncoder.shard_sequence`; the reference constrains
the layers' outputs to P(data, model, None) at ``s2t_encoder.py:182-185``)
keeps the activations between layers cut on T over the tensor-parallel
group: each rank takes its rows after the input dropout, each layer
gathers T before its column-parallel projections and reduce-scatters
after ``out_proj`` and ``fc2``, and T is gathered again before the final
LayerNorm (and for each state ``return_all_states`` returns). The math is
the unsharded run's.

Pipeline parallelism (``pipeline_stages`` S > 1, the reference's
``s2t_encoder.py:127-163``): the layers are ``pipe_stack``, a
:class:`~mm_s2ut_torch.parallel.pipeline.PipelinedEncoderStack` of
``pipeline_microbatches`` microbatches (0: S) over the pipe group's S
ranks (``parallel/pipeline.py``), each layer kernel A (G when causal)
and H as above on each microbatch. The reference folds a causal mask into
a dense (B, 1, T, T) bias there, its stack taking no ``causal`` flag; the
port's layers take it, so a pipelined causal layer runs kernel G, the
same masked softmax. ``return_all_states`` raises (the states
stay on their stages), sequence parallelism is not applied (the
reference's pipelined branch constrains nothing), and
``checkpoint_activations`` rematerialises each layer of each microbatch.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from mm_s2ut_torch.models.layers import (
    Conv1dSubsampler,
    SinusoidalPositionalEmbedding,
    TransformerEncoderLayer,
    layer_norm,
    lengths_to_padding_mask,
)
from mm_s2ut_torch.ops.attention import padding_bias
from mm_s2ut_torch.ops.dropout import DropoutRng, HashDropout, checkpoint
from mm_s2ut_torch.parallel.pipeline import PipelinedEncoderStack
from mm_s2ut_torch.parallel.tensor import (RowParallelLinear, SeqShard, TensorParallel,
                                           gather_seq_out, heads_of, scatter_seq)


class SpeechTransformerEncoder(nn.Module):
    def __init__(
        self,
        in_dim: int = 80,
        embed_dim: int = 512,
        ffn_dim: int = 2048,
        num_layers: int = 12,
        num_heads: int = 8,
        conv_channels: int = 1024,
        conv_kernel_sizes: Sequence[int] = (5, 5),
        causal_attention: bool = False,
        attention_window: int = 0,
        dropout: float = 0.0,
        attention_dropout: float = 0.0,
        activation_dropout: float = 0.0,
        activation: str = "relu",
        normalize_before: bool = True,
        checkpoint_activations: bool = False,
        pipeline_stages: int = 0,
        pipeline_microbatches: int = 0,
    ):
        super().__init__()
        self.checkpoint_activations = checkpoint_activations
        self.rng: Optional[DropoutRng] = None  # what a checkpointed layer draws from
        self.embed_dim = embed_dim
        self.normalize_before = normalize_before
        self.num_layers = num_layers
        self.subsampler = Conv1dSubsampler(in_dim, conv_channels, embed_dim, conv_kernel_sizes)
        self.pos = SinusoidalPositionalEmbedding(embed_dim)
        self.drop = HashDropout(dropout)
        window = attention_window if causal_attention else 0
        self.pipelined = pipeline_stages > 1

        def layer() -> TransformerEncoderLayer:
            return TransformerEncoderLayer(
                embed_dim, ffn_dim, num_heads, causal=causal_attention, window=window,
                dropout=dropout, attention_dropout=attention_dropout,
                activation_dropout=activation_dropout, activation=activation,
                normalize_before=normalize_before)

        if self.pipelined:
            self.pipe_stack = PipelinedEncoderStack(layer, num_layers, pipeline_stages,
                                                    pipeline_microbatches,
                                                    remat=checkpoint_activations)
        else:
            for i in range(num_layers):
                self.add_module(f"layer{i}", layer())
        if normalize_before:
            self.final_layer_norm = layer_norm(embed_dim)
        self.sequence_tp: Optional[TensorParallel] = None  # set by shard_sequence

    def shard_sequence(self, tp: TensorParallel) -> None:
        """Hold T cut over ``tp`` between the layers (the model already
        sharded by ``parallel.tensor.shard_model_``). The parameters the
        layers apply to their rows alone (LayerNorms, the row-parallel
        biases) get ``sequence_parallel = True``: each rank's gradient of
        them is partial, and the trainer sums it over the group."""
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            if heads_of(layer.self_attn) is None or not isinstance(layer.ffn.fc2,
                                                                   RowParallelLinear):
                raise ValueError(f"sequence_parallel: encoder layer{i}'s attention heads and FFN "
                                 f"must split over mesh.model={tp.size}")
            for p in layer.parameters():
                if not getattr(p, "tp_sharded", False):
                    p.sequence_parallel = True
        self.sequence_tp = tp

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                return_all_states: bool = False) -> Dict[str, Any]:
        dtype = self.subsampler.conv0.weight.dtype
        x, lengths = self.subsampler(features.to(dtype), lengths)
        x = x * math.sqrt(self.embed_dim)
        x = self.drop(self.pos(x))
        padding_mask = lengths_to_padding_mask(lengths, x.shape[1])
        # Zero padded positions so they cannot leak through LN/attention.
        x = x * (~padding_mask)[..., None].to(x.dtype)
        key_bias = padding_bias(padding_mask, *padding_mask.shape, x.device)  # once for all layers
        if self.pipelined:
            if return_all_states:
                raise ValueError(
                    "pipeline_stages > 1 keeps per-layer states resident on their stage; "
                    "in-layer/external fusion variants that need encoder_states cannot run "
                    "pipelined")
            states, x = [], self.pipe_stack(x, key_bias)
            if self.normalize_before:
                x = self.final_layer_norm(x)
            return {"encoder_out": x, "encoder_padding_mask": padding_mask,
                    "encoder_states": states, "lengths": lengths}
        states: List[torch.Tensor] = []
        remat = self.checkpoint_activations and self.training and torch.is_grad_enabled()
        seq = None if self.sequence_tp is None else SeqShard(self.sequence_tp, x.shape[1])
        if seq is not None:
            x = scatter_seq(x, seq)
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            fn = functools.partial(layer, seq=seq)
            x = checkpoint(fn, self.rng, x, key_bias) if remat else fn(x, key_bias)
            if return_all_states:
                states.append(x if seq is None else gather_seq_out(x, seq))
        if seq is not None:
            x = gather_seq_out(x, seq)
        if self.normalize_before:
            x = self.final_layer_norm(x)
        return {"encoder_out": x, "encoder_padding_mask": padding_mask,
                "encoder_states": states, "lengths": lengths}
