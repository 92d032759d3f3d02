"""wav2vec2-CTC ASR transcription for evaluation.

Port of ``mm_s2ut/eval/asr.py``: transcribe the generated wavs of a
directory, sorted by the number that leads each file name, with the
port's ``Wav2Vec2ForCTC`` (``models/wav2vec2.py``, kernel A in every
layer on the card) from a local HF checkpoint directory, greedy CTC
decoding (``ops/ctc.ctc_greedy_decode``), one transcript per line.

    python -m mm_s2ut_torch.eval.asr --wav_dir tts --output transcripts.txt \
        --asr_model wav2vec2-ctc-dir [--device cpu]

The device defaults to ``cuda`` and raises without a card unless given
``--device cpu``. Nothing is downloaded: the directory holds the HF
``config.json``, ``vocab.json``, the weights (``*.bin`` or
``*.safetensors``) and optionally ``preprocessor_config.json``.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.data.audio_io import get_waveform
from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2ForCTC, load_hf_checkpoint
from mm_s2ut_torch.ops.ctc import ctc_greedy_decode


def wav_sort_key(path: Path) -> int:
    """The number that leads the file name (``int(name.split('_')[0])``)."""
    m = re.match(r"(\d+)", path.stem)
    return int(m.group(1)) if m else 0


def load_ctc_vocab(model_dir: str | Path) -> Dict[int, str]:
    vocab = json.loads((Path(model_dir) / "vocab.json").read_text())
    return {int(i): tok for tok, i in vocab.items()}


class CTCTranscriber:
    """Greedy wav2vec2-CTC ASR over batches of waveforms on ``device``."""

    def __init__(self, model_dir: str | Path, device: torch.device):
        self.cfg, variables = load_hf_checkpoint(model_dir)
        self.device = torch.device(device)
        model = Wav2Vec2ForCTC(self.cfg)
        model.load_state_dict(from_flax(variables, model))
        self.model = model.to(self.device).eval()
        self.id2tok = load_ctc_vocab(model_dir)
        self.delim = "|"
        # The reference's Wav2Vec2Processor standardises each waveform
        # (do_normalize, true for wav2vec2-CTC checkpoints) unless the
        # checkpoint's preprocessor_config.json says otherwise.
        self.do_normalize = True
        pp = Path(model_dir) / "preprocessor_config.json"
        if pp.exists():
            self.do_normalize = bool(json.loads(pp.read_text()).get("do_normalize", True))

    @torch.no_grad()
    def transcribe_batch(self, waveforms: np.ndarray, lengths: np.ndarray) -> List[str]:
        wav = torch.as_tensor(np.asarray(waveforms, np.float32), device=self.device)
        lens = torch.as_tensor(np.asarray(lengths), device=self.device).long()
        if self.do_normalize:  # zero mean, unit variance over the valid samples
            valid = (torch.arange(wav.shape[1], device=self.device)[None, :]
                     < lens[:, None]).to(wav.dtype)
            n = lens.to(wav.dtype).clamp_min(1.0)[:, None]
            mean = (wav * valid).sum(1, keepdim=True) / n
            var = (((wav - mean) * valid) ** 2).sum(1, keepdim=True) / n
            wav = (wav - mean) * torch.rsqrt(var + 1e-7) * valid
        logits = self.model(wav, lens)["logits"]
        ids = ctc_greedy_decode(logits, self.cfg.feature_lengths(lens), blank_id=0).cpu().numpy()
        out = []
        for row in ids:
            text = "".join(self.id2tok.get(int(t), "") for t in row if t >= 0)
            out.append(" ".join(text.replace(self.delim, " ").split()))
        return out

    def transcribe_files(self, wav_paths: Sequence[str | Path], batch_size: int = 8) -> List[str]:
        texts: List[str] = []
        paths = list(wav_paths)
        for i in range(0, len(paths), batch_size):
            wavs = [get_waveform(str(p), use_sample_rate=16000)[0] for p in paths[i:i + batch_size]]
            batch = np.zeros((len(wavs), max(len(w) for w in wavs)), np.float32)
            for j, w in enumerate(wavs):
                batch[j, :len(w)] = w
            texts.extend(self.transcribe_batch(batch, np.array([len(w) for w in wavs])))
        return texts


def generate_transcription(wav_dir: str | Path, output_file: str | Path, model_dir: str | Path,
                           device: torch.device, pattern: str = "*.wav",
                           batch_size: int = 8) -> List[str]:
    """Sort the wavs numerically, transcribe them, write one line per wav."""
    paths = sorted(Path(wav_dir).glob(pattern), key=wav_sort_key)
    if not paths:
        raise FileNotFoundError(f"no {pattern} under {wav_dir}")
    texts = CTCTranscriber(model_dir, device).transcribe_files(paths, batch_size)
    Path(output_file).write_text("".join(t + "\n" for t in texts))
    return texts


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from mm_s2ut_torch.inference import resolve_device

    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.eval.asr",
                                 description="wav2vec2-CTC ASR transcription")
    ap.add_argument("--wav_dir", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--asr_model", required=True, help="HF wav2vec2-CTC dir")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    texts = generate_transcription(args.wav_dir, args.output, args.asr_model,
                                   resolve_device(args.device), batch_size=args.batch_size)
    print(f"transcribed {len(texts)} wavs -> {args.output}")


if __name__ == "__main__":
    main()
