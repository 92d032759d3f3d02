"""``python -m mm_s2ut_torch.cli.convert_checkpoint`` — a fairseq ``.pt`` →
the port's model directory.

The port of ``python -m mm_s2ut.cli.convert_checkpoint``. It writes the
port's one model format, ``params.npz`` (flax leaves joined by '/', what
``convert.load_npz`` reads) beside a config, instead of an orbax
directory:

  # the flagship (the run yaml describes the architecture; it is saved
  # beside the parameters, so inference.load_model reads the directory)
  python -m mm_s2ut_torch.cli.convert_checkpoint --kind mm_s2ut \\
      --fairseq-ckpt checkpoint_best.pt --config run.yaml --out model/

  # fairseq-format mHuBERT: params.npz nested under --component, and a
  # config.json (HF field names) that prep_data quantize --hubert-model reads
  python -m mm_s2ut_torch.cli.convert_checkpoint --kind hubert \\
      --fairseq-ckpt mhubert_base.pt --out mhubert/

The checkpoint is read by ``utils/torch_pickle.py``, which runs no code
from it. ``--kind mm_s2ut`` checks the converted leaves against a fresh
model of the config and raises on any difference. CodeHiFiGAN checkpoints
need no conversion: ``cli.vocode --vocoder`` reads the fairseq ``.pt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger("mm_s2ut_torch.convert_checkpoint")

# The Wav2Vec2Config fields that Wav2Vec2Config.from_hf reads back.
HF_FIELDS = ("conv_dim", "conv_stride", "conv_kernel", "conv_bias", "feat_extract_norm",
             "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
             "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
             "do_stable_layer_norm", "layer_norm_eps")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.cli.convert_checkpoint")
    ap.add_argument("--kind", choices=("mm_s2ut", "hubert"), required=True)
    ap.add_argument("--fairseq-ckpt", required=True, help="torch .pt checkpoint")
    ap.add_argument("--out", required=True, help="output model dir")
    ap.add_argument("--config", help="run yaml (mm_s2ut kind: describes the architecture; "
                    "saved beside the parameters)")
    ap.add_argument("--component", default="speech_encoder",
                    help="hubert kind: the subtree the encoder's parameters are nested under")
    ap.add_argument("--no-strict", action="store_true",
                    help="warn instead of failing on unmapped fairseq keys")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from mm_s2ut_torch.convert import flatten
    from mm_s2ut_torch.utils.fairseq_convert import (convert_fairseq_hubert,
                                                      convert_mm_s2ut_checkpoint)

    out_dir = Path(args.out)
    if args.kind == "mm_s2ut":
        from mm_s2ut_torch.config import load_config, save_yaml
        from mm_s2ut_torch.convert import to_flax
        from mm_s2ut_torch.models import build_model_from_config

        if not args.config:
            ap.error("--kind mm_s2ut requires --config (architecture yaml)")
        cfg = load_config(args.config)
        flat = flatten(convert_mm_s2ut_checkpoint(args.fairseq_ckpt,
                                                  strict=not args.no_strict)["params"])
        # Shape check against a fresh model, so a mismatched yaml fails
        # here and not at the first decode.
        want = {k: v.shape for k, v in to_flax(build_model_from_config(cfg)).items()}
        if want != {k: v.shape for k, v in flat.items()}:
            raise ValueError(f"converted params do not match the architecture in "
                             f"{args.config}; check model dims/layer counts")
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(out_dir / "params.npz", **flat)
        save_yaml(cfg, out_dir / "config.yaml")
    else:
        w2v_cfg, variables = convert_fairseq_hubert(args.fairseq_ckpt)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(out_dir / "params.npz", **flatten({args.component: variables["params"]}))
        hf = {k: v for k, v in dataclasses.asdict(w2v_cfg).items() if k in HF_FIELDS}
        (out_dir / "config.json").write_text(json.dumps(hf, indent=1))
        logger.info("hubert config: hidden=%d layers=%d heads=%d (set these in the run "
                    "yaml's w2v_args)", w2v_cfg.hidden_size, w2v_cfg.num_hidden_layers,
                    w2v_cfg.num_attention_heads)
    logger.info("wrote converted checkpoint to %s", out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
