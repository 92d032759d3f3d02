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

:func:`from_flax` is strict: a flax leaf no torch parameter takes, or a
torch parameter no flax leaf fills, raises.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


_LAYOUTS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d, nn.Embedding,
            nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)


def _raw_leaves(mod: nn.Module, own: Mapping, name: str, fn: str):
    """The own parameters of a module outside ``_LAYOUTS``: only those its
    ``FLAX_LEAVES`` names."""
    raw = getattr(mod, "FLAX_LEAVES", ())
    if set(own) - set(raw):
        raise TypeError(f"{fn}: no rule for {type(mod).__name__} at {name!r}")
    return own


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

    def take(prefix: str, leaf: str) -> np.ndarray:
        key = f"{prefix}/{leaf}" if prefix else leaf
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
    return {k: np.ascontiguousarray(v) for k, v in flat.items()}
