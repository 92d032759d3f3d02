"""``python -m mm_s2ut_torch.cli.train`` — the training entry point of the port.

The port of ``python -m mm_s2ut.cli.train``: one yaml config (the JAX
package's keys) plus dotted overrides drives task → data → model →
training on one device, with validation, metrics
(``{save_dir}/logs/metrics.csv``) and checkpoints in ``train.save_dir``
(``config.yaml``, ``params.npz``, ``optim.pt``; ``mm_s2ut_torch.inference
--model_path {save_dir}`` decodes with them):

  python -m mm_s2ut_torch.cli.train --config run.yaml \
      train.max_update=40000 train.save_dir=checkpoints/run1

``task`` picks the task, as in the reference: ``multimodal_speech_to_speech``
(units) or ``multimodal_speech_to_text`` (the enhanced path's text, the
``mm_xm_transformer`` model). ``--device`` picks the device (default
``cuda``; with no visible card it raises unless given ``--device cpu``).
``--load-pretrained-encoder-from DIR`` copies the ``encoder`` subtree of
``DIR/params.npz`` (a save_dir of this trainer, flax names) into the fresh
model, strict on names and shapes; ``--resume`` continues from the
checkpoint in ``save_dir``. The ``mesh`` section is read and ignored: the
port trains on one card.
"""
from __future__ import annotations

import argparse
import logging
from typing import List, Optional

logger = logging.getLogger("mm_s2ut_torch.train")


def apply_overrides(cfg, overrides: List[str]) -> None:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key.path=value")
        path, raw = ov.split("=", 1)
        obj = cfg
        parts = path.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        current = getattr(obj, parts[-1])
        if isinstance(current, bool):
            value = raw.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            value = int(raw)
        elif isinstance(current, float):
            value = float(raw)
        elif isinstance(current, list):
            value = [v for v in raw.split(",") if v]
        else:
            value = raw
        setattr(obj, parts[-1], value)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_s2ut_torch.cli.train")
    ap.add_argument("--config", required=True, help="framework config yaml")
    ap.add_argument("--valid-subset", default="valid")
    ap.add_argument("--train-subset", default="train")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in save_dir")
    ap.add_argument("--load-pretrained-encoder-from", default=None,
                    help="save_dir whose params.npz initializes the encoder")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_intermixed_args(argv)

    from mm_s2ut_torch.config import load_config
    from mm_s2ut_torch.inference import resolve_device
    from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask
    from mm_s2ut_torch.tasks.s2t_task import MultiModalSpeechToTextTask
    from mm_s2ut_torch.train.metrics import MetricsWriter
    from mm_s2ut_torch.train.trainer import load_pretrained_encoder

    tasks = {"multimodal_speech_to_speech": MultiModalSpeechToSpeechTask,
             "multimodal_speech_to_text": MultiModalSpeechToTextTask}
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    apply_overrides(cfg, args.overrides)
    if cfg.task not in tasks:
        raise ValueError(f"task {cfg.task!r}: expected one of {sorted(tasks)}")
    task = tasks[cfg.task](cfg, device)
    trainer = task.build_trainer()
    if args.load_pretrained_encoder_from:
        load_pretrained_encoder(trainer.model, args.load_pretrained_encoder_from)
    if args.resume:
        try:
            logger.info("resumed from step %d", trainer.restore_checkpoint())
        except FileNotFoundError as e:  # a fresh run
            logger.warning("no checkpoint to resume (%s); starting fresh", e)
    writer = MetricsWriter(f"{cfg.train.save_dir}/logs")
    try:
        task.load_dataset(args.valid_subset)
        valid = lambda: task.batch_iterator(args.valid_subset, shuffle=False)  # noqa: E731
    except FileNotFoundError:
        valid = None
        logger.warning("no %s split — skipping validation", args.valid_subset)
    step = trainer.fit(lambda epoch: task.batch_iterator(args.train_subset, epoch), valid,
                       metrics_writer=writer)
    logger.info("done at step %d; checkpoint in %s", step, cfg.train.save_dir)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
