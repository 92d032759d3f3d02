"""fairseq checkpoints (``.pt``) → the port's flax-layout parameter trees.

A copy of ``mm_s2ut/utils/fairseq_convert.py``. The published flagship
and mHuBERT checkpoints are fairseq training checkpoints; only their
weights move, renamed to the tree that ``convert.from_flax`` loads into
the port's modules (``config.yaml`` + ``params.npz`` is the port's one
on-disk model format, ``cli/convert_checkpoint.py`` writes it). The files
are read by ``utils/torch_pickle.py``, which runs no code from them.

Layout differences handled:
  * torch ``nn.Linear`` stores (out, in); flax ``Dense`` kernels are
    (in, out) → transpose.
  * torch ``nn.Conv1d`` stores (out_ch, in_ch, k); flax ``Conv`` kernels
    are (k, in_ch, out_ch) → transpose (2, 1, 0).
  * torch ``LayerNorm.weight`` → flax ``scale``.
  * fairseq module names → the port's names.

Converters:
  * :func:`convert_mm_s2ut_checkpoint`: the flagship ``mm_s2ut_transformer``
    (encoder, selective-attention fusion, unit decoder).
  * :func:`convert_fairseq_hubert`: fairseq HuBERT/mHuBERT → the tree of
    ``models.wav2vec2.Wav2Vec2Model`` (HF-graph layout), through
    ``convert_hf_state_dict``.
"""
from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from mm_s2ut_torch.utils import torch_pickle

logger = logging.getLogger(__name__)


def _load_state_dict(ckpt_path: str | Path) -> Dict[str, np.ndarray]:
    """Read a fairseq ``.pt`` → {name: float32 ndarray}. fairseq wraps the
    weights under ``"model"`` (training checkpoints); bare state dicts are
    accepted too."""
    blob = torch_pickle.load_checkpoint_numpy(ckpt_path)
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    return {k: np.asarray(v, np.float32) for k, v in sd.items() if isinstance(v, np.ndarray)}


def _linear(dst: Dict, path: tuple, sd: Dict, prefix: str) -> bool:
    w = sd.get(prefix + ".weight")
    if w is None:
        return False
    node = dst
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = {"kernel": np.ascontiguousarray(w.T)}
    b = sd.get(prefix + ".bias")
    if b is not None:
        node[path[-1]]["bias"] = b
    return True


def _layer_norm(dst: Dict, path: tuple, sd: Dict, prefix: str) -> bool:
    w = sd.get(prefix + ".weight")
    if w is None:
        return False
    node = dst
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = {"scale": w, "bias": sd[prefix + ".bias"]}
    return True


def _conv1d(dst: Dict, path: tuple, sd: Dict, prefix: str) -> bool:
    w = sd.get(prefix + ".weight")
    if w is None:
        return False
    node = dst
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = {"kernel": np.ascontiguousarray(w.transpose(2, 1, 0))}
    b = sd.get(prefix + ".bias")
    if b is not None:
        node[path[-1]]["bias"] = b
    return True


def _attention(dst: Dict, path: tuple, sd: Dict, prefix: str,
               out_name: str = "out_proj") -> bool:
    """Map a fairseq MultiheadAttention (separate q/k/v/out Linears)."""
    any_found = False
    for proj in ("q_proj", "k_proj", "v_proj"):
        any_found |= _linear(dst, path + (proj,), sd, f"{prefix}.{proj}")
    any_found |= _linear(dst, path + ("out_proj",), sd, f"{prefix}.{out_name}")
    return any_found


def convert_mm_s2ut_checkpoint(
    ckpt_path: str | Path,
    encoder_layers: Optional[int] = None,
    decoder_layers: Optional[int] = None,
    strict: bool = True,
) -> Dict[str, Any]:
    """fairseq ``mm_s2ut_transformer`` checkpoint → MMS2UTModel params.

    Returns ``{"params": {...}}`` loadable via
    ``model.apply(converted, ...)``. Layer counts are inferred from the
    state dict when not given. With ``strict`` every *mapped-family* key
    must be consumed; auxiliary fairseq modules the reference always
    instantiates but the shipped configs never use (``proj_768_to_512``,
    ``proj_1024_to_512``, ``proj_1024_to_768``, ``wav2vec2_adaptor``,
    version counters, sinusoidal position buffers) are skipped.
    """
    sd = _load_state_dict(ckpt_path)
    params: Dict[str, Any] = {}
    consumed = set()

    def take(fn, path, prefix, **kw):
        if fn(params, path, sd, prefix, **kw):
            for suffix in (".weight", ".bias"):
                if prefix + suffix in sd:
                    consumed.add(prefix + suffix)
            if fn is _attention:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj",
                             kw.get("out_name", "out_proj")):
                    for suffix in (".weight", ".bias"):
                        k = f"{prefix}.{proj}{suffix}"
                        if k in sd:
                            consumed.add(k)
            return True
        return False

    # --- encoder: conv subsampler + transformer stack -------------------
    i = 0
    while take(_conv1d, ("encoder", "subsampler", f"conv{i}"),
               f"encoder.subsample.conv_layers.{i}"):
        i += 1
    n_enc = encoder_layers
    if n_enc is None:
        n_enc = 1 + max(
            (int(m.group(1)) for k in sd
             if (m := re.match(r"encoder\.transformer_layers\.(\d+)\.", k))),
            default=-1,
        )
    for li in range(n_enc):
        p = f"encoder.transformer_layers.{li}"
        base = ("encoder", f"layer{li}")
        take(_attention, base + ("self_attn",), f"{p}.self_attn")
        take(_layer_norm, base + ("self_attn_layer_norm",), f"{p}.self_attn_layer_norm")
        take(_linear, base + ("ffn", "fc1"), f"{p}.fc1")
        take(_linear, base + ("ffn", "fc2"), f"{p}.fc2")
        take(_layer_norm, base + ("final_layer_norm",), f"{p}.final_layer_norm")
    take(_layer_norm, ("encoder", "final_layer_norm"), "encoder.layer_norm")

    # --- top fusion: selective attention / gate / image pre-norm --------
    j = 0
    while True:
        p = f"encoder.selective_attns.{j}"
        base = (f"fusion{j}", "selective_attn")
        found = take(_attention, base, p, out_name="proj")
        if not found:
            break
        take(_linear, (f"fusion{j}", "gated_fusion", "gate"), f"encoder.gate_denses.{j}")
        # Reference keeps ONE shared image pre-norm; replicate per block.
        _layer_norm(params, (f"fusion{j}", "image_pre_norm"), sd, "encoder.image_pre_norm_module")
        j += 1
    for suffix in (".weight", ".bias"):
        if "encoder.image_pre_norm_module" + suffix in sd:
            consumed.add("encoder.image_pre_norm_module" + suffix)
    # Every gate belongs to a selective-attn block converted above; a
    # leftover gate means a malformed/mismatched checkpoint — report it
    # rather than half-mapping it into a fusion block with no attention.
    if f"encoder.gate_denses.{j}.weight" in sd:
        raise ValueError(
            f"checkpoint has encoder.gate_denses.{j} but only {j} "
            "selective-attention blocks — gate/attention count mismatch"
        )
    # Speaker projection lives on the top-level model (MMS2UTModel), not
    # inside the speech encoder submodule.
    take(_linear, ("spk_emb_proj",), "encoder.spk_emb_proj")

    # --- decoder --------------------------------------------------------
    emb = sd.get("decoder.embed_tokens.weight")
    if emb is not None:
        params.setdefault("decoder", {}).setdefault("embed", {})["embed_tokens"] = {
            "embedding": emb
        }
        consumed.add("decoder.embed_tokens.weight")
    n_dec = decoder_layers
    if n_dec is None:
        n_dec = 1 + max(
            (int(m.group(1)) for k in sd
             if (m := re.match(r"decoder\.layers\.(\d+)\.", k))),
            default=-1,
        )
    for li in range(n_dec):
        p = f"decoder.layers.{li}"
        base = ("decoder", f"layer{li}")
        take(_attention, base + ("self_attn",), f"{p}.self_attn")
        take(_layer_norm, base + ("self_attn_layer_norm",), f"{p}.self_attn_layer_norm")
        take(_attention, base + ("cross_attn",), f"{p}.encoder_attn")
        take(_layer_norm, base + ("cross_attn_layer_norm",), f"{p}.encoder_attn_layer_norm")
        take(_linear, base + ("ffn", "fc1"), f"{p}.fc1")
        take(_linear, base + ("ffn", "fc2"), f"{p}.fc2")
        take(_layer_norm, base + ("final_layer_norm",), f"{p}.final_layer_norm")
    take(_layer_norm, ("decoder", "final_norm"), "decoder.layer_norm")

    # Shared output projection: verify it matches the embedding (fairseq
    # share_decoder_input_output_embed, the flagship default) and drop it.
    out_proj = sd.get("decoder.output_projection.weight")
    if out_proj is not None:
        consumed.add("decoder.output_projection.weight")
        tied = (
            emb is not None
            and out_proj.shape == emb.shape
            and np.allclose(out_proj, emb)
        )
        if not tied:
            raise ValueError(
                "decoder.output_projection is not tied to decoder.embed_tokens "
                f"(projection shape {tuple(out_proj.shape)} vs embedding "
                f"{None if emb is None else tuple(emb.shape)}); untied output "
                "projections are not supported by UnitDecoder "
                "(share_input_output_embed=True)"
            )

    _IGNORE = re.compile(
        r"(^encoder\.(proj_768_to_512|proj_1024_to_512|proj_1024_to_768|"
        r"wav2vec2_adaptor|embed_positions|mhubert|wav2vec2|vit|q_former|"
        r"multimodal_attns|multimodal_transformer|external_|bridge)|"
        r"^decoder\.embed_positions|version$|_float_tensor$)"
    )
    leftover = [k for k in sd if k not in consumed and not _IGNORE.search(k)]
    if leftover:
        msg = f"unmapped fairseq keys: {sorted(leftover)[:10]} (+{max(0, len(leftover)-10)} more)"
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
    return {"params": params}


# --- fairseq HuBERT / mHuBERT → Wav2Vec2Model (HF-graph layout) ----------

_FAIRSEQ_HUBERT_RENAMES = [
    # (fairseq regex, HF replacement)
    (re.compile(r"^feature_extractor\.conv_layers\.(\d+)\.0\."),
     r"feature_extractor.conv_layers.\1.conv."),
    # group-norm mode: Sequential(conv, dropout, GroupNorm, GELU) → idx 2
    (re.compile(r"^feature_extractor\.conv_layers\.(\d+)\.2\.1\."),
     r"feature_extractor.conv_layers.\1.layer_norm."),
    (re.compile(r"^feature_extractor\.conv_layers\.(\d+)\.2\."),
     r"feature_extractor.conv_layers.\1.layer_norm."),
    (re.compile(r"^post_extract_proj\."), "feature_projection.projection."),
    (re.compile(r"^layer_norm\."), "feature_projection.layer_norm."),
    (re.compile(r"^mask_emb$"), "masked_spec_embed"),
    (re.compile(r"^encoder\.pos_conv\.0\."), "encoder.pos_conv_embed.conv."),
    (re.compile(r"^encoder\.layers\.(\d+)\.self_attn\."),
     r"encoder.layers.\1.attention."),
    (re.compile(r"^encoder\.layers\.(\d+)\.self_attn_layer_norm\."),
     r"encoder.layers.\1.layer_norm."),
    (re.compile(r"^encoder\.layers\.(\d+)\.fc1\."),
     r"encoder.layers.\1.feed_forward.intermediate_dense."),
    (re.compile(r"^encoder\.layers\.(\d+)\.fc2\."),
     r"encoder.layers.\1.feed_forward.output_dense."),
    # encoder.layers.{i}.final_layer_norm and encoder.layer_norm match HF.
]

_FAIRSEQ_HUBERT_DROP = re.compile(
    r"(^label_embs_concat$|^final_proj\.|version$|_float_tensor$|"
    r"^w2v_encoder\.|num_updates)"
)


def _parse_conv_feature_layers(spec: str) -> list:
    """Evaluate fairseq's ``conv_feature_layers`` string — e.g.
    ``"[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2"`` — with a
    restricted AST walker (list/tuple/int literals plus ``+``/``*`` only),
    never ``eval`` (checkpoint blobs are untrusted input)."""
    import ast

    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, ast.List):
            return [walk(e) for e in node.elts]
        if isinstance(node, ast.Tuple):
            return tuple(walk(e) for e in node.elts)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mult)):
            lhs, rhs = walk(node.left), walk(node.right)
            return lhs + rhs if isinstance(node.op, ast.Add) else lhs * rhs
        raise ValueError(f"unsupported conv_feature_layers expression: {spec!r}")

    out = walk(ast.parse(spec, mode="eval"))
    if not (isinstance(out, list) and all(
        isinstance(t, tuple) and len(t) == 3 for t in out
    )):
        raise ValueError(f"conv_feature_layers did not parse to [(c,k,s),...]: {spec!r}")
    return out


def fairseq_hubert_config(ckpt_path: str | Path):
    """A :class:`models.wav2vec2.Wav2Vec2Config` from the fairseq
    checkpoint's model cfg (the base model's frontend where fields are
    absent); the cfg blob (a dict, an ``argparse.Namespace`` or an
    omegaconf stub) is normalised through ``torch_pickle.to_plain``."""
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config

    blob = torch_pickle.load_checkpoint_numpy(ckpt_path)
    mcfg = {}
    cfg_blob = blob.get("cfg") or blob.get("args")
    if cfg_blob is not None:
        raw = torch_pickle.to_plain(cfg_blob)
        if not isinstance(raw, dict):
            raw = getattr(raw, "__dict__", {}) or {}
        model_raw = raw.get("model", raw) if isinstance(raw, dict) else raw
        if not isinstance(model_raw, dict):
            model_raw = getattr(model_raw, "__dict__", {}) or {}
        mcfg = dict(model_raw)
    sd = blob.get("model", blob)
    hidden = int(sd["post_extract_proj.weight"].shape[0]) if "post_extract_proj.weight" in sd else int(mcfg.get("encoder_embed_dim", 768))
    n_layers = 1 + max(
        (int(m.group(1)) for k in sd
         if (m := re.match(r"encoder\.layers\.(\d+)\.", k))),
        default=11,
    )
    conv_string = mcfg.get(
        "conv_feature_layers",
        "[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2",
    )
    conv_spec = _parse_conv_feature_layers(conv_string)
    return Wav2Vec2Config(
        hidden_size=hidden,
        num_hidden_layers=n_layers,
        num_attention_heads=int(mcfg.get("encoder_attention_heads", 12 if hidden <= 768 else 16)),
        intermediate_size=int(mcfg.get("encoder_ffn_embed_dim", 4 * hidden)),
        conv_dim=tuple(c[0] for c in conv_spec),
        conv_kernel=tuple(c[1] for c in conv_spec),
        conv_stride=tuple(c[2] for c in conv_spec),
        conv_bias=bool(mcfg.get("conv_bias", False)),
        feat_extract_norm=(
            "layer" if str(mcfg.get("extractor_mode", "default")) in
            ("layer_norm",) else "group"
        ),
        do_stable_layer_norm=bool(mcfg.get("layer_norm_first", False)),
        num_conv_pos_embeddings=int(mcfg.get("conv_pos", 128)),
        num_conv_pos_embedding_groups=int(mcfg.get("conv_pos_groups", 16)),
    )


def convert_fairseq_hubert(ckpt_path: str | Path, cfg=None) -> Dict[str, Any]:
    """fairseq HuBERT/mHuBERT ``.pt`` → :class:`Wav2Vec2Model` variables:
    the fairseq names are renamed to HF's and fed through
    :func:`models.wav2vec2.convert_hf_state_dict`. Returns ``(cfg,
    variables)`` when ``cfg`` is None, else just ``variables``."""
    from mm_s2ut_torch.models.wav2vec2 import convert_hf_state_dict

    return_cfg = cfg is None
    if cfg is None:
        cfg = fairseq_hubert_config(ckpt_path)
    sd = _load_state_dict(ckpt_path)
    hf_sd: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if _FAIRSEQ_HUBERT_DROP.search(k):
            continue
        new = k
        for pat, repl in _FAIRSEQ_HUBERT_RENAMES:
            if pat.search(new):
                new = pat.sub(repl, new)
                break
        hf_sd[new] = v
    variables = convert_hf_state_dict(hf_sd, cfg)
    return (cfg, variables) if return_cfg else variables
