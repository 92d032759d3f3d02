"""``python -m mm_s2ut_torch.cli.generate`` — beam-search generation over a data split.

The port of ``python -m mm_s2ut.cli.generate``:

  python -m mm_s2ut_torch.cli.generate --model_path MODEL --gen-subset test \\
      --results-path out/ [--beam 10] [--max-len-a 1] [--max-len-b 200] \\
      [--kv-cache-dtype int8] [--device cuda]

``--model_path`` is a directory with ``config.yaml`` and ``params.npz``;
its config names the task (``multimodal_speech_to_text`` decodes the XM
model over raw waveforms, ``multimodal_speech_to_speech`` the unit model)
and the data (``data.data_root``: ``{subset}.tsv``, ``dict.txt``, the image
features). The split is read in length buckets and each batch goes
through ``UnitGenerator``; ``generate-{subset}.txt`` gets the reference's
T-/H-/D- lines. ``data.eos_token`` (the XM path's target language tag)
is where generation starts and stops, and ``<lang:…>`` tags are stripped
from every line. ``--device`` defaults to ``cuda`` and raises without a
card. Several colon-separated directories (``a:b``, fairseq's ``--path
a.pt:b.pt``) decode as a logit ensemble; the first's config drives the
task and the search, and every other member's model config must equal it
but for its paths and execution knobs (:func:`arch_view`).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger("mm_s2ut_torch.generate")


# ModelConfig fields that do not change what a member decodes.
EXECUTION_FIELDS = ("checkpoint_activations", "sequence_parallel", "pipeline_stages",
                    "pipeline_microbatches", "use_flash_attention")


def arch_view(cfg) -> dict:
    """The task and the model config as a comparable dict, without the
    execution knobs and the fields naming files (``*_path``, ``*_root``,
    ``*_dir``, ``*_file``): members that agree on the rest decode the
    same function of their parameters."""
    d = dataclasses.asdict(cfg.model)
    for k in EXECUTION_FIELDS:
        d.pop(k, None)

    def strip_paths(node):
        if isinstance(node, dict):
            return {k: strip_paths(v) for k, v in node.items()
                    if not k.endswith(("_path", "_root", "_dir", "_file"))}
        if isinstance(node, list):
            return [strip_paths(v) for v in node]
        return node

    return {"task": cfg.task, "model": strip_paths(d)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.cli.generate")
    ap.add_argument("--model_path", required=True,
                    help="dir with config.yaml + params.npz; N colon-separated dirs run a "
                         "logit ensemble (fairseq --path a.pt:b.pt)")
    ap.add_argument("--gen-subset", default="test")
    ap.add_argument("--results-path", required=True)
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--max-len-a", type=float, default=None)
    ap.add_argument("--max-len-b", type=int, default=None)
    ap.add_argument("--kv-cache-dtype", default=None, choices=["bfloat16", "int8", "int4"],
                    help="decode KV-cache storage (overrides the config)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from mm_s2ut_torch.infer.generator import UnitGenerator, format_generation_output
    from mm_s2ut_torch.inference import load_model, resolve_device
    from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask
    from mm_s2ut_torch.tasks.s2t_task import MultiModalSpeechToTextTask

    device = resolve_device(args.device)
    paths = args.model_path.split(":")
    cfg, model = load_model(paths[0], device)
    models = [model]
    for path in paths[1:]:
        cfg_i, model_i = load_model(path, device)
        want, got = arch_view(cfg), arch_view(cfg_i)
        if got != want:
            diffs = [k for k in want["model"] if got["model"].get(k) != want["model"][k]]
            if cfg_i.task != cfg.task:
                diffs.insert(0, "task")
            raise ValueError(f"ensemble member {path} is incompatible with {paths[0]}: "
                             f"differing fields {diffs}")
        models.append(model_i)
    if args.beam:
        cfg.generation.beam = args.beam
    if args.max_len_a is not None:
        cfg.generation.max_len_a = args.max_len_a
    if args.max_len_b is not None:
        cfg.generation.max_len_b = args.max_len_b
    if args.kv_cache_dtype is not None:
        cfg.generation.kv_cache_dtype = args.kv_cache_dtype

    vocab_size = cfg.model.vocab_size
    s2t = cfg.task == "multimodal_speech_to_text"
    task = (MultiModalSpeechToTextTask if s2t else MultiModalSpeechToSpeechTask)(cfg, device)
    if len(task.tgt_dict) != vocab_size:
        raise ValueError(f"{cfg.data.data_root}: a dictionary of {len(task.tgt_dict)} symbols, "
                         f"the model's vocabulary is {vocab_size}")
    tgt_dict = task.tgt_dict
    eos_id = bos_id = tgt_dict.eos()
    if cfg.data.eos_token:
        eos_id = bos_id = tgt_dict.index(cfg.data.eos_token)
        if eos_id == tgt_dict.unk():
            raise ValueError(f"data.eos_token {cfg.data.eos_token!r} not in the vocabulary")
    strip_ids = [i for i, sym in enumerate(tgt_dict.symbols) if sym.startswith("<lang:")]
    gen = UnitGenerator(models, cfg.generation, eos_id=eos_id, bos_id=bos_id,
                        max_target_positions=cfg.model.max_target_positions)

    out_dir = Path(args.results_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines: List[str] = []
    n = 0
    for batch in task.batch_iterator(args.gen_subset, shuffle=False):
        hypos = gen.generate(batch["src_features"], batch["src_lengths"],
                             batch.get("imgs_list", ()), batch.get("img_masks_list", ()))
        targets = [t[t != tgt_dict.pad()].tolist() for t in batch["target"].cpu()]
        lines.extend(format_generation_output(
            batch["id"].tolist(), hypos, tgt_dict, targets, nbest=cfg.generation.nbest,
            strip_ids=strip_ids))
        n += len(hypos)
    out_file = out_dir / f"generate-{args.gen_subset}.txt"
    out_file.write_text("\n".join(lines) + "\n")
    logger.info("generated %d samples -> %s", n, out_file)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
