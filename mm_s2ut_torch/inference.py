"""``python -m mm_s2ut_torch.inference`` — offline S2ST inference on PyTorch.

The port of ``python -m mm_s2ut.inference``, with its flags and its
artifacts (``<name>.unit``, ``generate-<subset>.txt``, ``<name>_pred.wav``):

  python -m mm_s2ut_torch.inference --model_path MODEL --audio_path a.wav \
      --image_path img.npy --output_dir out/            # single sample
  python -m mm_s2ut_torch.inference --model_path MODEL --audio_path a.wav \
      --image_path img.jpg --vit_checkpoint vit.bin --output_dir out/
  python -m mm_s2ut_torch.inference --model_path MODEL \
      --manifest_file test.tsv --output_dir out/        # batch (8 per batch)

``--model_path`` is a directory holding ``config.yaml`` and ``params.npz``
(``scripts/export_jax_params.py`` writes both from a Trainer checkpoint).
An image is a precomputed ``.npy``/``.npz`` feature array, or a raw
``.jpg``/``.png`` (decoded by ``data/image_io.py``, no Pillow) that the
timm ViT of ``--vit_checkpoint`` turns into features on the model's
device: the variant whose width is the model's ``image_feat_dim``, its
self-attention on kernel A. A model with a
wav2vec2/HuBERT ``speech_encoder_type`` reads the samples (standardized
per utterance with ``data.standardize_audio``) instead of fbank frames; a
speech-to-text checkpoint is decoded by ``python -m
mm_s2ut_torch.cli.generate``. ``--device`` picks the
device (default ``cuda``); with ``cuda`` and no visible card the command
raises rather than running on the CPU.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from mm_s2ut_torch.config import load_config
from mm_s2ut_torch.convert import from_flax, load_npz
from mm_s2ut_torch.data.audio_io import get_waveform, write_wav
from mm_s2ut_torch.data.dataset import standardize_waveforms
from mm_s2ut_torch.data.image_io import read_image
from mm_s2ut_torch.data.dictionary import UnitDictionary
from mm_s2ut_torch.data.manifest import read_manifest
from mm_s2ut_torch.infer.generator import UnitGenerator, format_generation_output
from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig, load_fairseq_checkpoint
from mm_s2ut_torch.models import build_model_from_config
from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

logger = logging.getLogger("mm_s2ut_torch.inference")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is visible (pass --device cpu for "
            "the plain PyTorch path)"
        )
    return device


def load_model(model_path: str, device: torch.device):
    """(config, model on ``device``) from a config.yaml + params.npz dir: an
    ``MMS2UTModel``, or an ``MMXMTransformerModel`` for ``task:
    multimodal_speech_to_text`` (``models.build_model_from_config``)."""
    path = Path(model_path)
    for f in ("config.yaml", "params.npz"):
        if not (path / f).exists():
            raise FileNotFoundError(f"{path / f} not found — pass an exported model dir")
    cfg = load_config(path / "config.yaml")
    model = build_model_from_config(cfg)
    model.load_state_dict(from_flax(load_npz(path / "params.npz"), model))
    return cfg, model.to(device).eval()


def load_image_features(image_path: str, vit_checkpoint: Optional[str] = None,
                        image_feat_dim: int = 768, device: torch.device = torch.device("cpu")
                        ) -> np.ndarray:
    """(1, T_img, D) features from a ``.npy``/``.npz`` array, or from a raw
    image through the timm ViT of ``vit_checkpoint`` on ``device``."""
    if image_path.endswith((".npy", ".npz")):
        feats = np.load(image_path)
        if hasattr(feats, "keys"):
            feats = feats[list(feats.keys())[0]]
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            return feats[None]
        if feats.ndim == 3 and feats.shape[0] == 1:
            return feats
        raise ValueError(f"{image_path} holds {feats.shape[0]} images — single-sample "
                         "inference needs one (T_img, D) feature array; slice the split "
                         "blob first (np.save(out, blob[i]))")
    if vit_checkpoint is None:
        raise ValueError("raw image input requires --vit_checkpoint (timm pytorch_model.bin)")
    from mm_s2ut_torch.models.vit import (VIT_VARIANTS, VisionTransformer, load_timm_checkpoint,
                                          preprocess_images)

    names = [n for n, c in VIT_VARIANTS.items() if c.embed_dim == image_feat_dim]
    if not names:
        raise ValueError(f"no ViT variant of width {image_feat_dim} (image_feat_dim); "
                         f"the variants: {sorted(VIT_VARIANTS)}")
    vit_cfg = VIT_VARIANTS[names[-1]]
    vit = VisionTransformer(vit_cfg)
    vit.load_state_dict(from_flax(load_timm_checkpoint(vit_checkpoint, vit_cfg), vit))
    vit = vit.to(device).eval()
    pixels = preprocess_images([read_image(image_path)], vit_cfg.image_size)
    with torch.no_grad():
        feats, _ = vit(torch.from_numpy(pixels).to(device))
    return feats.cpu().numpy()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mm_s2ut_torch.inference",
        description="Multimodal S2UT inference on PyTorch (speech+image → units → wav)",
    )
    ap.add_argument("--model_path", required=True, help="dir with config.yaml + params.npz")
    ap.add_argument("--audio_path", help="single-sample source wav")
    ap.add_argument("--image_path", help="image (.jpg/.png) or features (.npy/.npz)")
    ap.add_argument("--manifest_file", help="batch mode: TSV manifest")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--vit_checkpoint", help="timm ViT weights for raw images")
    ap.add_argument("--vocoder_path", help="CodeHiFiGAN checkpoint (.pt)")
    ap.add_argument("--vocoder_cfg", help="CodeHiFiGAN config.json")
    ap.add_argument("--gen_subset", default="test", help="batch output naming")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if not args.audio_path and not args.manifest_file:
        ap.error("one of --audio_path / --manifest_file is required")

    device = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg, model = load_model(args.model_path, device)
    if cfg.task == "multimodal_speech_to_text":
        raise ValueError(f"{args.model_path} is a speech-to-text model: decode it with "
                         "python -m mm_s2ut_torch.cli.generate")
    raw = model.reads_waveform
    if args.beam:
        cfg.generation.beam = args.beam
    tgt_dict = UnitDictionary(cfg.data.target_code_size)
    gen = UnitGenerator(model, cfg.generation, max_target_positions=cfg.model.max_target_positions)
    fbank_cfg = FbankConfig(sample_rate=cfg.data.sample_rate, num_mel_bins=cfg.data.num_mel_bins)

    def decode_batch(wavs: List[np.ndarray], imgs: Optional[np.ndarray]):
        S = max(len(w) for w in wavs)
        batch = np.zeros((len(wavs), S), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        lens = torch.tensor([len(w) for w in wavs], dtype=torch.long, device=device)
        if raw:
            if cfg.data.standardize_audio:
                batch = standardize_waveforms(batch, lens.cpu().numpy())
            feats, frame_lens = torch.from_numpy(batch).to(device), lens
        else:
            feats, frame_lens = waveform_frontend(
                torch.from_numpy(batch).to(device), lens, fbank_cfg, cfg.data.standardize_audio,
            )
        imgs_list = (imgs,) if imgs is not None else ()
        masks = (np.zeros(imgs.shape[:2], bool),) if imgs is not None else ()
        return gen.generate(feats, frame_lens, imgs_list, masks)

    if args.audio_path:
        wav, _ = get_waveform(args.audio_path, use_sample_rate=cfg.data.sample_rate)
        dims = cfg.model.multimodal.image_feat_dim
        imgs = (load_image_features(args.image_path, args.vit_checkpoint,
                                    dims[0] if dims else 768, device)
                if args.image_path else None)
        hypos = decode_batch([wav.astype(np.float32)], imgs)
        names, sample_ids, targets = [Path(args.audio_path).stem], [0], None
    else:
        rows = read_manifest(args.manifest_file)
        wavs, names, sample_ids, targets = [], [], [], []
        for i, row in enumerate(rows):
            path = row.src_audio
            if cfg.data.audio_root and not Path(path).is_absolute():
                path = str(Path(cfg.data.audio_root) / path)
            wavs.append(get_waveform(path, use_sample_rate=cfg.data.sample_rate)[0].astype(np.float32))
            names.append(Path(row.src_audio).stem)
            sample_ids.append(i)
            targets.append(tgt_dict.encode_line(row.tgt_text, append_eos=False).tolist())
        hypos = []
        for i in range(0, len(wavs), 8):
            hypos.extend(decode_batch(wavs[i : i + 8], None))

    unit_lines = []
    for name, hyp in zip(names, hypos):
        units = tgt_dict.ids_to_units(np.asarray(hyp[0]["tokens"], np.int64))
        unit_lines.append(" ".join(str(u) for u in units))
        (out_dir / f"{name}.unit").write_text(unit_lines[-1] + "\n")
    gen_txt = out_dir / f"generate-{args.gen_subset}.txt"
    gen_txt.write_text(
        "\n".join(format_generation_output(sample_ids, hypos, tgt_dict, targets)) + "\n"
    )
    logger.info("wrote %d .unit files + %s", len(names), gen_txt)

    if args.vocoder_path:
        vcfg = HiFiGANConfig.from_json(args.vocoder_cfg) if args.vocoder_cfg else HiFiGANConfig()
        max_units = max((len(l.split()) for l in unit_lines if l.strip()), default=1)
        voc = CodeHiFiGAN(vcfg, max_frames=4 * max_units + 8)
        voc.load_state_dict(load_fairseq_checkpoint(args.vocoder_path, vcfg))
        voc = voc.to(device).eval()
        for name, line in zip(names, unit_lines):
            units = [int(u) for u in line.split()]
            if not units:
                # Empty hypothesis → short silence (one wav per line downstream).
                write_wav(out_dir / f"{name}_pred.wav", np.zeros(1600, np.float32), 16000)
                continue
            u = torch.tensor([units], dtype=torch.long, device=device)
            wav, n = voc(u, torch.tensor([len(units)], device=device))
            write_wav(out_dir / f"{name}_pred.wav", wav[0, : int(n[0])].float().cpu().numpy(), 16000)
        logger.info("vocoded %d wavs", len(names))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
