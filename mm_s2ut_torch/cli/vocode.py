"""``python -m mm_s2ut_torch.cli.vocode`` — a unit file → waveforms.

The port of ``python -m mm_s2ut.cli.vocode`` (fairseq's
``generate_waveform_from_code.py``):

  python -m mm_s2ut_torch.cli.vocode --in-code-file test.unit \\
      --vocoder g.pt --vocoder-cfg g.json --results-path tts/ \\
      [--dur-prediction] [--batch-size 16] [--device cuda]

Each line of the ``.unit`` file (space-separated units, as
``cli.inference_all`` extracts them from ``generate-*.txt``) is vocoded by
the fairseq CodeHiFiGAN checkpoint into ``{i}_pred.wav``, in padded
batches of ``--batch-size`` lines on the device. The frame budget is the
reference's: 8·(longest line) + 16 frames with duration prediction, one
frame per unit (+1) without. An empty line gives 0.1 s of silence.
``--device`` defaults to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger("mm_s2ut_torch.vocode")


def read_unit_file(path: str | Path) -> List[List[int]]:
    return [[int(u) for u in l.split()] for l in Path(path).read_text().splitlines()]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.cli.vocode")
    ap.add_argument("--in-code-file", required=True)
    ap.add_argument("--vocoder", required=True, help="CodeHiFiGAN .pt checkpoint")
    ap.add_argument("--vocoder-cfg", default=None, help="config.json")
    ap.add_argument("--results-path", required=True)
    ap.add_argument("--dur-prediction", action="store_true")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--sample-rate", type=int, default=16000)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from mm_s2ut_torch.data.audio_io import write_wav
    from mm_s2ut_torch.inference import resolve_device
    from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig, load_fairseq_checkpoint

    device = resolve_device(args.device)
    out_dir = Path(args.results_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = HiFiGANConfig.from_json(args.vocoder_cfg) if args.vocoder_cfg else HiFiGANConfig()
    sequences = read_unit_file(args.in_code_file)
    max_units = max((len(s) for s in sequences if s), default=1)
    max_frames = (8 * max_units + 16) if args.dur_prediction else (max_units + 1)
    model = CodeHiFiGAN(cfg, max_frames=max_frames)
    model.load_state_dict(load_fairseq_checkpoint(args.vocoder, cfg))
    model = model.to(device).eval()

    B = args.batch_size
    for start in range(0, len(sequences), B):
        chunk = sequences[start : start + B]
        L = max((len(s) for s in chunk if s), default=1)
        units = torch.zeros((len(chunk), L), dtype=torch.long)
        for i, s in enumerate(chunk):
            units[i, : len(s)] = torch.tensor(s, dtype=torch.long)
        lens = torch.tensor([len(s) for s in chunk])
        wavs, n_samples = model(units.to(device), lens.to(device),
                                dur_prediction=args.dur_prediction)
        wavs, n_samples = wavs.float().cpu().numpy(), n_samples.cpu().numpy()
        for i in range(len(chunk)):
            n = int(n_samples[i])
            wav = wavs[i, :n] if n > 0 else np.zeros(args.sample_rate // 10, np.float32)
            write_wav(out_dir / f"{start + i}_pred.wav", wav, args.sample_rate)
    logger.info("wrote %d wavs to %s", len(sequences), out_dir)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
