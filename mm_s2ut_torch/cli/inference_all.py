"""``python -m mm_s2ut_torch.cli.inference_all`` — the evaluation loop per subset.

The port of ``python -m mm_s2ut.cli.inference_all`` (the reference's
``2_inference_all.sh``), in two modes:

  # units: generate → units → vocode → ASR → ASR-BLEU
  python -m mm_s2ut_torch.cli.inference_all --model_path MODEL \\
      --subsets test --results-root res/ --reference-root refs/ \\
      --vocoder g.pt --vocoder-cfg g.json --asr-model ASR [--device cuda]
  # text: generate → detokenize → text BLEU (the enhanced path)
  python -m mm_s2ut_torch.cli.inference_all --mode text --model_path MODEL \\
      --subsets test --results-root res/ --reference-root refs/

Each subset's directory gets the reference's files: ``generate-{subset}.txt``
(``cli.generate``), ``{subset}.unit``, ``tts/{i}_pred.wav`` (``cli.vocode
--dur-prediction``), ``transcript.txt`` (``eval.asr``) and ``bleu.txt``
(``eval.bleu``); in text mode ``hyp.txt`` and ``bleu.txt``. References are
``{reference-root}/{subset}.txt``. ``--device`` (default ``cuda``, which
raises without a card) goes to every stage. ``MM_PARITY_CANARY`` injects a
known fault (see :func:`canary_mode`), as the JAX package's does.
"""
from __future__ import annotations

import argparse
import logging
import os
import re
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger("mm_s2ut_torch.inference_all")


def canary_mode() -> str:
    """The fault canary of the parity scripts: ``MM_PARITY_CANARY=offset1:modN``
    turns every extracted unit u into (u + 1) mod N before the vocoder, and
    ``MM_PARITY_CANARY=droptok`` drops each text hypothesis's first word;
    either must collapse the BLEU that follows, which shows the chain
    scores its own hypotheses."""
    return os.environ.get("MM_PARITY_CANARY", "")


def _d_lines(gen_file: Path):
    for line in Path(gen_file).read_text().splitlines():
        m = re.match(r"^D-(\d+)\t[^\t]*\t(.*)$", line)
        if m:
            yield int(m.group(1)), m.group(2)


def extract_units_from_generate(gen_file: Path, unit_file: Path) -> int:
    """``grep "^D-" | sort -nk1 | cut -f3`` (the reference's
    3_generate_waveform.sh) as code; returns the lines written."""
    rows = sorted(_d_lines(gen_file))
    canary = canary_mode()
    if canary.startswith("offset1:mod"):
        n = int(canary[len("offset1:mod"):])
        logger.warning("MM_PARITY_CANARY active: units -> (u+1) mod %d", n)
        rows = [(i, " ".join(str((int(u) + 1) % n) for u in units.split())) for i, units in rows]
    Path(unit_file).write_text("\n".join(u for _, u in rows) + "\n")
    return len(rows)


def extract_text_from_generate(gen_file: Path, hyp_file: Path,
                               bpe_cfg: Optional[dict] = None) -> int:
    """D- lines → text, SentencePiece-decoded where the model's data config
    names a ``bpe_tokenizer``; returns the lines written."""
    sp = None
    if bpe_cfg:
        from mm_s2ut_torch.data.sentencepiece import build_bpe_tokenizer

        sp = build_bpe_tokenizer(bpe_cfg)
    rows = sorted((i, sp.decode(text.split()) if sp is not None else text)
                  for i, text in _d_lines(gen_file))
    if canary_mode() == "droptok":
        logger.warning("MM_PARITY_CANARY active: dropping first hyp word")
        rows = [(i, " ".join(t.split()[1:])) for i, t in rows]
    Path(hyp_file).write_text("\n".join(t for _, t in rows) + "\n")
    return len(rows)


def _generate(args, subset: str, out: Path) -> Path:
    from mm_s2ut_torch.cli import generate as gen_cli

    gen_cli.main([
        "--model_path", args.model_path, "--gen-subset", subset, "--results-path", str(out),
        "--beam", str(args.beam), "--device", args.device,
        *(["--kv-cache-dtype", args.kv_cache_dtype] if args.kv_cache_dtype else []),
    ])
    return out / f"generate-{subset}.txt"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.cli.inference_all")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--subsets", nargs="+",
                    default=["valid", "test.2016", "test.2017", "test.coco"])
    ap.add_argument("--results-root", required=True)
    ap.add_argument("--mode", choices=["units", "text"], default="units",
                    help="units: textless chain (vocode→ASR→ASR-BLEU); "
                         "text: enhanced chain (detokenize→text BLEU)")
    ap.add_argument("--vocoder", default=None)
    ap.add_argument("--vocoder-cfg", default=None)
    ap.add_argument("--asr-model", default=None, help="HF wav2vec2-CTC dir")
    ap.add_argument("--reference-root", required=True,
                    help="dir with {subset}.txt reference transcripts")
    ap.add_argument("--beam", type=int, default=10)
    ap.add_argument("--kv-cache-dtype", default=None, choices=["bfloat16", "int8", "int4"],
                    help="decode KV-cache storage (overrides the config)")
    ap.add_argument("--device", default="cuda", help="torch device of every stage (default: cuda)")
    args = ap.parse_args(argv)

    if args.mode == "units" and not (args.vocoder and args.asr_model):
        ap.error("--mode units requires --vocoder and --asr-model")

    from mm_s2ut_torch.inference import resolve_device

    device = resolve_device(args.device)
    results = _text_mode(args) if args.mode == "text" else _units_mode(args, device)
    print({k: round(v, 2) for k, v in results.items()})
    return 0


def _units_mode(args, device) -> dict:
    from mm_s2ut_torch.cli import vocode as vocode_cli
    from mm_s2ut_torch.eval.asr import generate_transcription
    from mm_s2ut_torch.eval.bleu import score_from_files

    results = {}
    for subset in args.subsets:
        out = Path(args.results_root) / subset
        out.mkdir(parents=True, exist_ok=True)
        logger.info("=== %s ===", subset)
        gen_file = _generate(args, subset, out)
        unit_file = out / f"{subset}.unit"
        logger.info("extracted %d unit sequences", extract_units_from_generate(gen_file, unit_file))
        tts_dir = out / "tts"
        vocode_cli.main([
            "--in-code-file", str(unit_file), "--vocoder", args.vocoder,
            *(["--vocoder-cfg", args.vocoder_cfg] if args.vocoder_cfg else []),
            "--results-path", str(tts_dir), "--dur-prediction", "--device", args.device,
        ])
        transcript = out / "transcript.txt"
        generate_transcription(tts_dir, transcript, args.asr_model, device)
        bleu = score_from_files(transcript, Path(args.reference_root) / f"{subset}.txt")
        (out / "bleu.txt").write_text(str(bleu) + "\n")
        logger.info("%s ASR-BLEU %.2f", subset, bleu.score)
        results[subset] = bleu.score
    return results


def _text_mode(args) -> dict:
    """generate → detokenize → corpus BLEU on the text (no ASR cleaning)."""
    from mm_s2ut_torch.config import load_config
    from mm_s2ut_torch.eval.bleu import corpus_asr_bleu

    cfg = load_config(Path(args.model_path) / "config.yaml")
    bpe_cfg = dict(cfg.data.bpe_tokenizer) or None
    results = {}
    for subset in args.subsets:
        out = Path(args.results_root) / subset
        out.mkdir(parents=True, exist_ok=True)
        logger.info("=== %s (text) ===", subset)
        hyp_file = out / "hyp.txt"
        n = extract_text_from_generate(_generate(args, subset, out), hyp_file, bpe_cfg)
        logger.info("extracted %d hypotheses", n)
        refs = (Path(args.reference_root) / f"{subset}.txt").read_text().splitlines()
        hyps = hyp_file.read_text().splitlines()
        if len(refs) != len(hyps):
            # Truncating would score misaligned pairs.
            raise ValueError(f"{subset}: {len(hyps)} hypotheses vs {len(refs)} references — "
                             f"reference file and generation are misaligned")
        bleu = corpus_asr_bleu(hyps, refs, clean=False)
        (out / "bleu.txt").write_text(str(bleu) + "\n")
        logger.info("%s text BLEU %.2f", subset, bleu.score)
        results[subset] = bleu.score
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
