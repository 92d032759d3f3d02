"""``python -m mm_s2ut_torch.cli.extract_features`` — offline image features.

The port of ``python -m mm_s2ut.cli.extract_features``: the timm ViT's
``forward_features`` (its self-attention on kernel A), or the CLIP
tower's last hidden state, over each split's flickr30k images in caption
order, written to ``{output-dir}/{split}.npy`` ((N, seq_len, D) float32,
memmapped), which ``ImageFeatureStore`` reads:

  python -m mm_s2ut_torch.cli.extract_features --flickr30k-root F30K \\
      --checkpoint vit_base.bin --output-dir feats/ [--device cpu]

Images are decoded by ``data/image_io.py`` (JPEG, PNG, ``.npy``; no
Pillow) and batches are padded to ``--batch-size``. ``--device`` picks
the device (default ``cuda``; with ``cuda`` and no visible card the
command raises).
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.data.image_io import read_image
from mm_s2ut_torch.data.image_store import RawImageStore
from mm_s2ut_torch.inference import resolve_device
from mm_s2ut_torch.models.vit import (VIT_VARIANTS, CLIPVisionTransformer, VisionTransformer,
                                      load_clip_checkpoint, load_timm_checkpoint,
                                      preprocess_images)

logger = logging.getLogger("mm_s2ut_torch.extract_features")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.cli.extract_features")
    ap.add_argument("--flickr30k-root", required=True)
    ap.add_argument("--splits", nargs="+", default=["train", "valid", "test2016"])
    ap.add_argument("--model", default="vit_base_patch16_384",
                    help="variant name (vit_{tiny,small,base,large}_patch16_384)")
    ap.add_argument("--extractor-type", default="vit_timm",
                    choices=("vit_timm", "vit_openai", "vit_huggingface"),
                    help="timm ViT (forward_features) or the HF CLIP vision tower "
                    "(last hidden state, CLIP's preprocessing)")
    ap.add_argument("--checkpoint", required=True,
                    help="timm pytorch_model.bin, or (vit_openai) an HF CLIP checkpoint dir")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.extractor_type == "vit_openai":
        cfg, variables = load_clip_checkpoint(args.checkpoint)
        model = CLIPVisionTransformer(cfg)
        prep_mode = "vit_openai"
    else:
        cfg = VIT_VARIANTS[args.model]
        variables = load_timm_checkpoint(args.checkpoint, cfg)
        model = VisionTransformer(cfg)
        prep_mode = "vit_huggingface" if args.extractor_type == "vit_huggingface" else "timm"
    model.load_state_dict(from_flax(variables, model))
    model = model.to(device).eval()

    def forward(px: torch.Tensor) -> torch.Tensor:
        out = model(px)
        return out[-1] if isinstance(out, list) else out[0]

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for split in args.splits:
        store = RawImageStore.for_split(args.flickr30k_root, split)  # caption order
        paths = [Path(store.img_dir) / name for name in store.img_path_list]
        out = np.lib.format.open_memmap(out_dir / f"{split}.npy", mode="w+", dtype=np.float32,
                                        shape=(len(paths), cfg.seq_len, cfg.embed_dim))
        B = args.batch_size
        for start in range(0, len(paths), B):
            chunk = paths[start: start + B]
            pixels = preprocess_images([read_image(p) for p in chunk], cfg.image_size,
                                       mode=prep_mode)
            if len(chunk) < B:  # one batch shape for every call
                pixels = np.concatenate(
                    [pixels, np.zeros((B - len(chunk), *pixels.shape[1:]), np.float32)])
            with torch.no_grad():
                feats = forward(torch.from_numpy(pixels).to(device))
            out[start: start + len(chunk)] = feats[: len(chunk)].float().cpu().numpy()
            if (start // B) % 50 == 0:
                logger.info("%s: %d/%d", split, start + len(chunk), len(paths))
        out.flush()
        logger.info("wrote %s (%s)", out_dir / f"{split}.npy", out.shape)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
