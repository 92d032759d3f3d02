"""``python -m mm_s2ut_torch.cli.train`` — the training entry point of the port.

The port of ``python -m mm_s2ut.cli.train``: one yaml config (the JAX
package's keys) plus dotted overrides drives task → data → model →
training on one device, or data-parallel on several, with validation, metrics
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
checkpoint in ``save_dir``. With ``train.eval_inference`` each validation
also decodes its batches with the live model, vocodes the predicted and
target units with the vocoder of ``train.eval_vocoder_path`` /
``eval_vocoder_cfg`` and reports the MCD metrics.

Under ``torchrun`` the run is data-parallel, one process per card::

  torchrun --nproc_per_node 8 -m mm_s2ut_torch.cli.train --config run.yaml

Each process takes ``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device cpu``)
and its rows of every batch. With ``mesh.model=M`` the run is also
tensor-parallel: M consecutive ranks share rows and split the attention
and FFN projections and the unit table (``parallel/tensor.py``), and
``model.sequence_parallel=true`` keeps the speech encoder's activations
cut on T between layers::

  torchrun --nproc_per_node 8 -m mm_s2ut_torch.cli.train --config run.yaml \
      mesh.model=4 model.sequence_parallel=true

With ``mesh.pipe=P`` and ``model.pipeline_stages=P`` the speech
encoder's layers run as a GPipe of P stages (``parallel/pipeline.py``,
``model.pipeline_microbatches`` microbatches): rank r sits at (d, p, m)
with r = (d·P + p)·M + m, the P ranks of one (d, m) holding L/P layers
each; with ``--device cpu``, over gloo::

  torchrun --nproc_per_node 4 -m mm_s2ut_torch.cli.train --config run.yaml \
      --device cpu mesh.pipe=2 model.pipeline_stages=2

The world must divide by ``mesh.model`` × ``mesh.pipe`` (one process with
``mesh.model=2`` or ``mesh.pipe=2`` raises ``ValueError``, as JAX's
``make_mesh`` does), ``mesh.data`` must be -1 or world / (model × pipe),
and ``model.pipeline_stages`` > 1 needs ``mesh.pipe`` equal to it. Rank 0
writes the checkpoints and metrics, whole (a pipelined run's
``params.npz`` in the reference's stacked layout, which
``mm_s2ut_torch.inference`` and ``cli.generate`` decode on one device).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional

import torch

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
    from mm_s2ut_torch.parallel.mesh import check_mesh, init_distributed
    from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask
    from mm_s2ut_torch.tasks.s2t_task import MultiModalSpeechToTextTask

    tasks = {"multimodal_speech_to_speech": MultiModalSpeechToSpeechTask,
             "multimodal_speech_to_text": MultiModalSpeechToTextTask}
    cfg = load_config(args.config)
    apply_overrides(cfg, args.overrides)
    if cfg.task not in tasks:
        raise ValueError(f"task {cfg.task!r}: expected one of {sorted(tasks)}")
    resolve_device(args.device)
    parallel, device = init_distributed(args.device)
    try:
        model, pipe = check_mesh(cfg.mesh, 1 if parallel is None else parallel.world)
        if parallel is not None:
            parallel = dataclasses.replace(parallel, model=model, pipe=pipe)
        return _train(args, cfg, tasks[cfg.task](cfg, device), parallel)
    finally:
        if parallel is not None:
            torch.distributed.destroy_process_group()


def _train(args, cfg, task, parallel) -> int:
    from mm_s2ut_torch.train.metrics import MetricsWriter
    from mm_s2ut_torch.train.trainer import load_pretrained_encoder

    trainer = task.build_trainer(parallel=parallel)
    if args.load_pretrained_encoder_from:
        load_pretrained_encoder(trainer.model, args.load_pretrained_encoder_from, trainer.tp)
    if args.resume:
        try:
            logger.info("resumed from step %d", trainer.restore_checkpoint())
        except FileNotFoundError as e:  # a fresh run
            logger.warning("no checkpoint to resume (%s); starting fresh", e)
    writer = MetricsWriter(f"{cfg.train.save_dir}/logs") if trainer.is_writer else None
    if cfg.train.eval_inference:
        trainer.inference_metrics_fn = task.build_inference_metrics_fn(trainer)
        logger.info("eval_inference on: reporting MCD metrics at validation")
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
