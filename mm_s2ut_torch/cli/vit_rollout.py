"""``python -m mm_s2ut_torch.cli.vit_rollout`` — attention-rollout saliency.

The port of ``python -m mm_s2ut.cli.vit_rollout``: the timm ViT returns
each block's attention weights (the plain softmax path), rollout chains
the (A + I)/2 products, and the mask is saved as ``.npy`` and blended
over the image as a ``.png`` (the mask resized to the image bicubically,
as PIL's ``Image.resize`` default; the red channel blended at half
weight):

  python -m mm_s2ut_torch.cli.vit_rollout --image img.jpg \\
      --checkpoint vit_base.bin --output out/mask [--device cpu]

``--device`` picks the device (default ``cuda``).
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.data.image_io import read_image, resize, write_png
from mm_s2ut_torch.inference import resolve_device
from mm_s2ut_torch.models.vit import (VIT_VARIANTS, VisionTransformer, attention_rollout,
                                      load_timm_checkpoint, preprocess_images)

logger = logging.getLogger("mm_s2ut_torch.vit_rollout")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.cli.vit_rollout")
    ap.add_argument("--image", required=True)
    ap.add_argument("--model", default="vit_base_patch16_384")
    ap.add_argument("--checkpoint", required=True, help="timm pytorch_model.bin")
    ap.add_argument("--discard-ratio", type=float, default=0.9)
    ap.add_argument("--head-fusion", choices=["mean", "max", "min"], default="max")
    ap.add_argument("--output", required=True, help=".npy mask (+ .png overlay)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = VIT_VARIANTS[args.model]
    vit = VisionTransformer(cfg)
    vit.load_state_dict(from_flax(load_timm_checkpoint(args.checkpoint, cfg), vit))
    vit = vit.to(device).eval()
    img = read_image(args.image)
    pixels = preprocess_images([img], cfg.image_size)
    with torch.no_grad():
        _, attns = vit(torch.from_numpy(pixels).to(device), return_attn=True)
    mask = attention_rollout([a.float().cpu().numpy() for a in attns],
                             discard_ratio=args.discard_ratio, head_fusion=args.head_fusion)[0]
    side = cfg.image_size // cfg.patch_size
    mask2d = mask.reshape(side, side)
    out = Path(args.output)
    np.save(out.with_suffix(".npy"), mask2d)

    heat = resize((mask2d * 255).astype(np.uint8), (img.shape[1], img.shape[0]))
    heat = heat.astype(np.float32)[..., None] / 255.0
    blended = img.astype(np.float32) * (1 - 0.5 * heat) + np.array([255.0, 0, 0]) * 0.5 * heat
    write_png(out.with_suffix(".png"), blended.astype(np.uint8))
    logger.info("saved %s(.npy/.png)", out)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
