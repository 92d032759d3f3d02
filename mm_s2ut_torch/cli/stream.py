"""``python -m mm_s2ut_torch.cli.stream`` — simulated low-latency streaming S2ST.

The port of ``python -m mm_s2ut.cli.stream``, with its flags. A wav is
fed through the incremental pipeline chunk by chunk, as a live
microphone would feed it: waveform chunk → its new mature fbank frames
(framing is per-frame local, so prefix features are exact) → incremental
causal encoder (``infer/streaming.py``) → re-translation beam search →
COMMITTED unit increments, printed as they stabilize. ``finalize()``
flushes the tail; the final hypothesis equals offline decoding of the
same model on the same audio (``python -m mm_s2ut_torch.inference``).

  python -m mm_s2ut_torch.cli.stream --model_path MODEL --audio_path a.wav \
      --output_dir out --chunk-ms 320 [--vocoder_path v.pt --vocoder_cfg v.json]

``--model_path`` is a directory holding ``config.yaml`` and ``params.npz``
of a model trained with ``encoder_causal_attention: true``, speech only.
With ``data.standardize_audio: true`` the frontend needs utterance-level
statistics, so the features are computed offline and only the feeding is
chunked (simulation mode). ``--device`` picks the device (default
``cuda``); with ``cuda`` and no visible card the command raises. Writes
``<name>.unit`` and, with a vocoder, ``<name>_pred.wav``, synthesized
incrementally from the committed units.
"""
from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from mm_s2ut_torch.data.audio_io import get_waveform, write_wav
from mm_s2ut_torch.data.dictionary import UnitDictionary
from mm_s2ut_torch.infer.streaming import StreamingS2ST
from mm_s2ut_torch.infer.streaming_vocoder import StreamingVocoderSession
from mm_s2ut_torch.inference import load_model, resolve_device
from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig, load_fairseq_checkpoint
from mm_s2ut_torch.ops.fbank import FbankConfig, waveform_frontend

logger = logging.getLogger("mm_s2ut_torch.cli.stream")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mm_s2ut_torch.cli.stream",
        description="Streaming S2ST on PyTorch: chunked wav → committed units (live)",
    )
    ap.add_argument("--model_path", required=True, help="dir with config.yaml + params.npz")
    ap.add_argument("--audio_path", required=True, help="source wav")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--chunk-ms", type=int, default=320,
                    help="simulated capture chunk in ms (default 320)")
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--vocoder_path", help="CodeHiFiGAN checkpoint (.pt)")
    ap.add_argument("--vocoder_cfg", help="CodeHiFiGAN config.json")
    ap.add_argument("--decode-every", type=int, default=1,
                    help="run the re-translation search every Nth chunk")
    ap.add_argument("--full-redecode", action="store_true",
                    help="re-decode the whole hypothesis every search. Default is prefix "
                         "reuse: each search continues from the committed prefix's "
                         "prefilled cache, so per-chunk latency stays flat as context grows")
    ap.add_argument("--max-new-tokens", type=int, default=48,
                    help="per-search continuation budget under prefix reuse")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, model = load_model(args.model_path, device)
    if not cfg.model.encoder_causal_attention:
        raise SystemExit(
            "this checkpoint was trained with an offline (bidirectional) encoder; streaming "
            "needs `encoder_causal_attention: true` (optionally `encoder_attention_window`) "
            "at training time"
        )
    if args.beam:
        cfg.generation.beam = args.beam
    fbank_cfg = FbankConfig(sample_rate=cfg.data.sample_rate, num_mel_bins=cfg.data.num_mel_bins)
    sr = cfg.data.sample_rate
    if args.chunk_ms * sr < 1000 * fbank_cfg.frame_length:
        raise SystemExit("--chunk-ms must cover at least one fbank frame (25 ms)")

    wav, _ = get_waveform(args.audio_path, use_sample_rate=sr)
    wav = torch.from_numpy(wav.astype(np.float32)).to(device)
    shift, flen = fbank_cfg.frame_shift, fbank_cfg.frame_length
    chunk_samples = args.chunk_ms * sr // 1000
    total_frames = max(0, (len(wav) - flen) // shift + 1)
    if total_frames == 0:
        raise SystemExit(f"{args.audio_path}: shorter than one fbank frame")

    def frontend(seg: torch.Tensor, standardize: bool) -> torch.Tensor:
        lens = torch.tensor([len(seg)], dtype=torch.long, device=device)
        return waveform_frontend(seg[None], lens, fbank_cfg, standardize)[0][0]

    simulate = bool(cfg.data.standardize_audio)
    feats_full = None
    if simulate:
        logger.warning("standardize_audio needs utterance statistics — computing features "
                       "offline, chunking only the feeding (simulation mode)")
        feats_full = frontend(wav, True)[:total_frames]

    g = cfg.generation
    # UnitGenerator._max_len on the raw frame count, so the final hypothesis
    # equals `python -m mm_s2ut_torch.inference` on the same audio.
    max_len = int(min(g.max_len_a * total_frames + g.max_len_b,
                      cfg.model.max_target_positions - 1))
    srv = StreamingS2ST(
        model, chunk_frames=chunk_samples // shift + 1, max_frames=total_frames + 4,
        beam=g.beam, max_len=max_len, len_penalty=g.len_penalty, unk_penalty=g.unk_penalty,
        kv_cache_dtype=g.kv_cache_dtype, decode_every=args.decode_every,
        prefix_reuse=not args.full_redecode, max_new_tokens=args.max_new_tokens,
    )

    voc = None
    voc_samples: List[np.ndarray] = []
    if args.vocoder_path:
        vcfg = HiFiGANConfig.from_json(args.vocoder_cfg) if args.vocoder_cfg else HiFiGANConfig()
        vocoder = CodeHiFiGAN(vcfg)
        vocoder.load_state_dict(load_fairseq_checkpoint(args.vocoder_path, vcfg))
        vocoder = vocoder.to(device).eval()
        voc = StreamingVocoderSession(vocoder, max_units=max(max_len + 2, 64))

    tgt_dict = UnitDictionary(cfg.data.target_code_size)
    emitted_f = 0
    commit_audio_s: List[float] = []  # audio position when each unit committed
    wall0 = time.monotonic()
    pos = 0
    n_feeds = 0
    while pos < len(wav):
        pos = min(pos + chunk_samples, len(wav))
        mature = max(0, (pos - flen) // shift + 1)
        if mature <= emitted_f:
            continue
        if simulate:
            new = feats_full[emitted_f:mature]
        else:
            new = frontend(wav[emitted_f * shift : pos], False)[: mature - emitted_f]
        new_units = srv.feed(new[None])
        emitted_f = mature
        n_feeds += 1
        audio_s = pos / sr
        commit_audio_s += [audio_s] * len(new_units)
        if new_units:
            units = tgt_dict.ids_to_units(np.asarray(new_units, np.int64))
            print(f"[{audio_s:6.2f}s audio] committed: " + " ".join(str(u) for u in units),
                  flush=True)
            if voc is not None:
                voc_samples.append(voc.feed([int(u) for u in units]))

    final_ids = srv.finalize()
    audio_s = len(wav) / sr
    n_streamed = len(commit_audio_s)
    commit_audio_s += [audio_s] * (len(final_ids) - n_streamed)
    units = tgt_dict.ids_to_units(np.asarray(final_ids, np.int64))
    line = " ".join(str(u) for u in units)
    print(f"[finalize ] {line}", flush=True)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(args.audio_path).stem
    (out_dir / f"{stem}.unit").write_text(line + "\n")
    logger.info(
        "%.2fs audio in %d feeds; %d/%d units committed before finalize (%.0f%%); avg commit "
        "point %.2fs of audio; wall %.2fs%s", audio_s, n_feeds, n_streamed, len(final_ids),
        100 * n_streamed / max(1, len(final_ids)),
        float(np.mean(commit_audio_s)) if commit_audio_s else 0.0,
        time.monotonic() - wall0, " (simulation: offline features)" if simulate else "",
    )

    if voc is not None:
        n_streamed_samples = int(sum(s.size for s in voc_samples))
        final_units = [int(u) for u in units]
        if final_units[: len(voc.units)] == voc.units:
            tail = final_units[len(voc.units):]
            if tail:
                voc_samples.append(voc.feed(tail))
            voc_samples.append(voc.finalize())
        else:
            # Re-translation committed a prefix the final hypothesis
            # abandoned: synthesize the whole wav again so the file
            # matches the written units.
            logger.warning("final hypothesis diverged from the committed prefix — re-vocoding")
            n_streamed_samples = 0
            voc = StreamingVocoderSession(voc.vocoder, max_units=max(max_len + 2, 64))
            voc_samples = [voc.feed(final_units), voc.finalize()]
        wav_out = np.concatenate(voc_samples) if voc_samples else np.zeros((0,), np.float32)
        if wav_out.size == 0:
            wav_out = np.zeros(1600, np.float32)  # empty hypothesis → short silence
        write_wav(out_dir / f"{stem}_pred.wav", wav_out, 16000)
        logger.info("vocoded %s_pred.wav: %d samples, %d (%.0f%%) emitted before finalize",
                    stem, wav_out.size, n_streamed_samples,
                    100.0 * n_streamed_samples / max(1, wav_out.size))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
