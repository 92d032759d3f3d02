"""``python -m mm_s2ut_torch.cli.prep_data`` — the textless data preparation.

The port of ``python -m mm_s2ut.cli.prep_data`` (the reference's
``2_manifest.sh`` → ``3_cluster.sh`` → ``5_prep_s2ut_data.sh``), three
subcommands:

  manifest   audio dir → tsv of (path, n_samples)
      python -m mm_s2ut_torch.cli.prep_data manifest --root wavs/ --dest src.tsv
  quantize   audio → HuBERT layer features → k-means units, one line each
      python -m mm_s2ut_torch.cli.prep_data quantize --manifest src.tsv \\
          --hubert-model HUBERT --km-path km1000.npy --layer 11 --dest units.txt \\
          [--batch-size 8] [--dedup] [--device cuda]
  prep-s2ut  source manifest + target units → {split}.tsv
      python -m mm_s2ut_torch.cli.prep_data prep-s2ut --src-manifest src.tsv \\
          --tgt-units units.txt --split train --output-root data/ [--reduce-unit]

``quantize`` runs the encoder in fp32 on padded batches with their
lengths (self-attention on kernel A) and assigns each of a row's
``feature_lengths`` frames its nearest centroid on the same device.
``--hubert-model`` is a local HF HuBERT/wav2vec2 directory or what
``cli.convert_checkpoint --kind hubert`` writes from a fairseq mHuBERT.
``--device`` defaults to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger("mm_s2ut_torch.prep_data")


def load_encoder(path: str | Path):
    """(Wav2Vec2Config, fp32 ``Wav2Vec2Model`` in eval mode on the CPU)
    from an HF directory, or from ``config.json`` + ``params.npz`` whose
    leaves sit under one component (``convert_checkpoint --kind hubert``)."""
    from mm_s2ut_torch.convert import from_flax, load_npz
    from mm_s2ut_torch.models.wav2vec2 import (Wav2Vec2Config, Wav2Vec2Model,
                                               load_hf_checkpoint)

    path = Path(path)
    if (path / "params.npz").exists():
        cfg = Wav2Vec2Config.from_hf(json.loads((path / "config.json").read_text()))
        tree = load_npz(path / "params.npz")
        if len(tree) == 1:  # nested under its component
            (tree,) = tree.values()
        variables = {"params": tree}
    else:
        cfg, variables = load_hf_checkpoint(path)
    model = Wav2Vec2Model(cfg)
    model.load_state_dict(from_flax(variables, model))
    return cfg, model.eval()


def padded(wavs: Sequence[np.ndarray]):
    """(B, S) zero-padded float32 batch and (B,) int64 lengths."""
    batch = np.zeros((len(wavs), max(len(w) for w in wavs)), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    return batch, np.asarray([len(w) for w in wavs], np.int64)


def quantize_batch(model, cfg, quant, wavs: Sequence[np.ndarray], layer: int) -> List[List[int]]:
    """The units of each waveform: layer ``layer``'s hidden states of the
    padded batch, assigned on the model's device, cut to each row's frames."""
    import torch

    batch, lens = padded(wavs)
    dev = next(model.parameters()).device
    with torch.no_grad():
        feats = model(torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev))[
            "hidden_states"][layer]
        units = quant(feats).cpu().numpy()
    frames = cfg.feature_lengths(lens)
    return [units[i, : frames[i]].tolist() for i in range(len(wavs))]


def read_manifest_entries(path: str | Path):
    """(root, [(relative path, n_samples), ...]) of a wav2vec-style manifest."""
    lines = Path(path).read_text().splitlines()
    return Path(lines[0]), [l.split("\t") for l in lines[1:] if l.strip()]


def cmd_manifest(args) -> int:
    from mm_s2ut_torch.data.audio_io import get_waveform

    root = Path(args.root)
    paths = sorted(root.rglob(f"*.{args.ext}"))
    lines = [str(root)]
    for p in paths:
        wav, _ = get_waveform(str(p))
        lines.append(f"{p.relative_to(root)}\t{len(wav)}")
    Path(args.dest).parent.mkdir(parents=True, exist_ok=True)
    Path(args.dest).write_text("\n".join(lines) + "\n")
    logger.info("manifest: %d files -> %s", len(paths), args.dest)
    return 0


def cmd_quantize(args) -> int:
    from mm_s2ut_torch.data.audio_io import get_waveform
    from mm_s2ut_torch.inference import resolve_device
    from mm_s2ut_torch.ops.kmeans import KMeansQuantizer, dedup_units

    device = resolve_device(args.device)
    cfg, model = load_encoder(args.hubert_model)
    model = model.to(device)
    quant = KMeansQuantizer.load(args.km_path)
    root, entries = read_manifest_entries(args.manifest)
    out_lines: List[str] = []
    for start in range(0, len(entries), args.batch_size):
        chunk = entries[start : start + args.batch_size]
        wavs = [get_waveform(str(root / e[0]), use_sample_rate=16000)[0] for e in chunk]
        for u in quantize_batch(model, cfg, quant, wavs, args.layer):
            out_lines.append(" ".join(map(str, dedup_units(u) if args.dedup else u)))
    Path(args.dest).write_text("\n".join(out_lines) + "\n")
    logger.info("quantized %d utterances -> %s", len(out_lines), args.dest)
    return 0


def cmd_prep_s2ut(args) -> int:
    """{split}.tsv with the reference's columns (id, src_audio,
    src_n_frames, tgt_text, tgt_n_frames)."""
    from mm_s2ut_torch.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.ops.kmeans import dedup_units

    _, entries = read_manifest_entries(args.src_manifest)
    units = Path(args.tgt_units).read_text().splitlines()
    if len(entries) != len(units):
        raise ValueError(f"{len(entries)} audios vs {len(units)} unit lines")
    rows = []
    for i, ((rel, n_samples), unit_line) in enumerate(zip(entries, units)):
        u = [int(x) for x in unit_line.split()]
        if args.reduce_unit:
            u = dedup_units(u)
        rows.append(ManifestRow(
            id=str(i), src_audio=rel, src_n_frames=int(n_samples),
            tgt_text=" ".join(map(str, u)), tgt_n_frames=len(u),
            src_lang=args.src_lang or "", tgt_lang=args.tgt_lang or ""))
    out = Path(args.output_root) / f"{args.split}.tsv"
    out.parent.mkdir(parents=True, exist_ok=True)
    write_manifest(out, rows)
    logger.info("wrote %s (%d rows)", out, len(rows))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.cli.prep_data")
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("manifest")
    m.add_argument("--root", required=True)
    m.add_argument("--dest", required=True)
    m.add_argument("--ext", default="wav")

    q = sub.add_parser("quantize")
    q.add_argument("--manifest", required=True)
    q.add_argument("--hubert-model", required=True,
                   help="HF HuBERT/wav2vec2 dir, or a convert_checkpoint --kind hubert dir")
    q.add_argument("--km-path", required=True, help=".npy/.npz centroids (or an sklearn joblib)")
    q.add_argument("--layer", type=int, default=11)
    q.add_argument("--dest", required=True)
    q.add_argument("--batch-size", type=int, default=8)
    q.add_argument("--dedup", action="store_true")
    q.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("prep-s2ut")
    p.add_argument("--src-manifest", required=True)
    p.add_argument("--tgt-units", required=True)
    p.add_argument("--split", required=True)
    p.add_argument("--output-root", required=True)
    p.add_argument("--reduce-unit", action="store_true")
    p.add_argument("--src-lang", default="")
    p.add_argument("--tgt-lang", default="")

    args = ap.parse_args(argv)
    return {"manifest": cmd_manifest, "quantize": cmd_quantize,
            "prep-s2ut": cmd_prep_s2ut}[args.cmd](args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
