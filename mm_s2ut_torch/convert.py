"""Carry the JAX package's flax parameters onto the port's modules.

The port names its submodules after the flax parameter tree, so a torch
module at path ``a.b`` takes its parameters from the flax subtree
``a/b``; only the leaf layouts differ:

* Dense ``kernel`` (in, out) → Linear ``weight`` (out, in)
* Conv ``kernel`` (k, in, out) → Conv1d ``weight`` (out, in, k); a 2-D or
  3-D Conv ``kernel`` (kh, kw, in, out) → Conv2d ``weight`` (out, in, kh,
  kw), and likewise for Conv3d
* ConvTranspose ``kernel`` (k, in, out) → ConvTranspose1d ``weight``
  (in, out, k), flipped in time (the reference's fairseq loader flips the
  other way, ``mm_s2ut/models/hifigan.py:547-550``)
* Embed ``embedding`` → Embedding ``weight``
* LayerNorm, GroupNorm and BatchNorm ``scale``/``bias`` →
  ``weight``/``bias`` (BatchNorm's running statistics are buffers, which
  ``models/resnet_encoder.from_flax_variables`` fills)
* a parameter a module holds itself (flax's ``self.param``) and names in
  its ``FLAX_LEAVES`` (wav2vec2's ``masked_spec_embed``, the image
  encoders' class token and positions) → the leaf of its own name, as is
* a pipelined encoder's layer ``pipe_stack.layers.{i}`` (``parallel/pipeline.py``)
  → row i of the stacked leaves ``pipe_stack/layers/…`` (leading axis L),
  as the reference stores them; a stage holding L/S of the layers takes
  its rows, and :func:`to_flax` gives its rows in layer order
  (``parallel.pipeline.gather_stages`` joins the stages' into the whole)

:func:`from_flax` is strict: a flax leaf no torch parameter takes, or a
torch parameter no flax leaf fills, raises.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from mm_s2ut_torch.parallel.mesh import tp_axis
from mm_s2ut_torch.parallel.pipeline import PipelinedEncoderStack


_LAYOUTS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d, nn.Embedding,
            nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)


def _raw_leaves(mod: nn.Module, own: Mapping, name: str, fn: str):
    """The own parameters of a module outside ``_LAYOUTS``: only those its
    ``FLAX_LEAVES`` names."""
    raw = getattr(mod, "FLAX_LEAVES", ())
    if set(own) - set(raw):
        raise TypeError(f"{fn}: no rule for {type(mod).__name__} at {name!r}")
    return own


_PIPE_LAYER = re.compile(r"^(.*pipe_stack/layers)/(\d+)/(.+)$")  # one layer's leaf


def stack_pipe_layers(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Flat leaves with a pipelined stack's per-layer keys
    ``…/pipe_stack/layers/{i}/leaf`` → the stacked ``…/pipe_stack/layers/leaf``
    (rows in layer order); other keys as they are."""
    out: Dict[str, np.ndarray] = {}
    rows: Dict[str, Dict[int, np.ndarray]] = {}
    for k, v in flat.items():
        m = _PIPE_LAYER.match(k)
        if m is None:
            out[k] = v
        else:
            rows.setdefault(f"{m[1]}/{m[3]}", {})[int(m[2])] = v
    for k, per in rows.items():
        out[k] = np.stack([per[i] for i in sorted(per)])
    return out


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict → {"a/b/leaf": array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_npz(path: str | Path) -> Dict:
    """A ``params.npz`` (keys joined by '/', as scripts/export_jax_params.py
    writes it) → nested dict of numpy arrays."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def from_flax(params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves; a top-level ``{"params": …}``
    wrapper is accepted) → a complete state dict for ``model``."""
    if set(params) == {"params"}:
        params = params["params"]
    flat = flatten(params)
    used = set()
    sd: Dict[str, np.ndarray] = {}
    stacks = {name.replace(".", "/") + "/layers": mod.num_layers
              for name, mod in model.named_modules() if isinstance(mod, PipelinedEncoderStack)}

    def take(prefix: str, leaf: str) -> np.ndarray:
        key = f"{prefix}/{leaf}" if prefix else leaf
        m = _PIPE_LAYER.match(key)
        if key not in flat and m is not None and f"{m[1]}/{m[3]}" in flat:
            stacked = f"{m[1]}/{m[3]}"
            if flat[stacked].shape[0] != stacks[m[1]]:
                raise ValueError(f"from_flax: {stacked} stacks {flat[stacked].shape[0]} layers, "
                                 f"the model {stacks[m[1]]}")
            used.add(stacked)
            return flat[stacked][int(m[2])]
        if key not in flat:
            raise KeyError(f"from_flax: no flax leaf {key!r} for the torch module {prefix!r}")
        used.add(key)
        return flat[key]

    for name, mod in model.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        prefix = name.replace(".", "/")
        if not isinstance(mod, _LAYOUTS):
            for leaf in _raw_leaves(mod, own, name, "from_flax"):
                sd[f"{name}.{leaf}" if name else leaf] = take(prefix, leaf)
            continue
        if isinstance(mod, nn.Linear):
            sd[f"{name}.weight"] = take(prefix, "kernel").T
        elif isinstance(mod, nn.ConvTranspose1d):
            sd[f"{name}.weight"] = take(prefix, "kernel")[::-1].transpose(1, 2, 0)
        elif isinstance(mod, nn.Conv1d):
            sd[f"{name}.weight"] = take(prefix, "kernel").transpose(2, 1, 0)
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            kernel = take(prefix, "kernel")
            nd = kernel.ndim - 2
            sd[f"{name}.weight"] = kernel.transpose(nd + 1, nd, *range(nd))
        elif isinstance(mod, nn.Embedding):
            sd[f"{name}.weight"] = take(prefix, "embedding")
        else:  # LayerNorm, GroupNorm, BatchNorm
            sd[f"{name}.weight"] = take(prefix, "scale")
        if "bias" in own and own["bias"] is not None:
            sd[f"{name}.bias"] = take(prefix, "bias")

    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"from_flax: flax leaves with no torch parameter: {unused}")
    expected = dict(model.named_parameters())
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise KeyError(f"from_flax: torch parameters left unfilled: {missing}")
    out = {}
    for k, v in sd.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"from_flax: {k} is {tuple(v.shape)}, the model wants "
                             f"{tuple(expected[k].shape)}")
        out[k] = torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
    return out


def to_flax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`from_flax`: ``model``'s parameters as flat
    flax leaves {"a/b/leaf": float32 array}, what ``np.savez`` writes into
    a ``params.npz`` that :func:`load_npz` reads back."""
    flat: Dict[str, np.ndarray] = {}
    for name, mod in model.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        prefix = name.replace(".", "/")
        if not isinstance(mod, _LAYOUTS):
            for leaf, p in _raw_leaves(mod, own, name, "to_flax").items():
                flat[f"{prefix}/{leaf}" if prefix else leaf] = p.detach().float().cpu().numpy()
            continue
        w = own["weight"].detach().float().cpu().numpy()
        if isinstance(mod, nn.Linear):
            flat[f"{prefix}/kernel"] = w.T
        elif isinstance(mod, nn.ConvTranspose1d):
            flat[f"{prefix}/kernel"] = w.transpose(2, 0, 1)[::-1]
        elif isinstance(mod, nn.Conv1d):
            flat[f"{prefix}/kernel"] = w.transpose(2, 1, 0)
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            flat[f"{prefix}/kernel"] = w.transpose(*range(2, w.ndim), 1, 0)
        elif isinstance(mod, nn.Embedding):
            flat[f"{prefix}/embedding"] = w
        else:  # LayerNorm, GroupNorm, BatchNorm
            flat[f"{prefix}/scale"] = w
        if own.get("bias") is not None:
            flat[f"{prefix}/bias"] = own["bias"].detach().float().cpu().numpy()
    return {k: np.ascontiguousarray(v) for k, v in stack_pipe_layers(flat).items()}


def shard_state_dict(full: Mapping[str, np.ndarray], m: int, model: int) -> Dict[str, np.ndarray]:
    """Flat flax leaves of a whole model → rank ``m``'s of ``model``
    tensor-parallel ranks: each leaf the reference's ``_TP_RULES`` match
    cut to its ``m``-th 1/model on the matched axis (``parallel/mesh.tp_axis``),
    the others whole; what :func:`from_flax` loads into a model built under
    tensor parallelism (``parallel/tensor.shard_model_``)."""
    out = {}
    for key, v in full.items():
        axis = tp_axis(key)
        if axis is None:
            out[key] = v
            continue
        n = v.shape[axis]
        if n % model:
            raise ValueError(f"{key}: dimension {axis} of {v.shape} ({n}) does not divide by "
                             f"mesh.model={model}")
        out[key] = np.ascontiguousarray(np.take(v, range(m * (n // model), (m + 1) * (n // model)),
                                                axis=axis))
    return out


def gather_state_dict(local: Mapping[str, np.ndarray], tp) -> Dict[str, np.ndarray]:
    """The inverse of :func:`shard_state_dict` over a tensor-parallel group
    ``tp`` (``parallel/tensor.TensorParallel``): every rank of it calls
    with its own leaves and gets the whole model's."""
    import torch.distributed as dist

    out = {}
    for key in sorted(local):
        v = local[key]
        axis = tp_axis(key)
        if axis is None:
            out[key] = v
            continue
        parts = [torch.empty(v.shape, dtype=torch.float32) for _ in range(tp.size)]
        t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
        if dist.get_backend(tp.group) == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
            parts = [q.to(dev) for q in parts]
            t = t.to(dev)
        dist.all_gather(parts, t, group=tp.group)
        out[key] = np.concatenate([q.cpu().numpy() for q in parts], axis=axis)
    return out
