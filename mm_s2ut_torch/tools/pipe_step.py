"""The pipelined flagship train step on several cards over NCCL.

    python -c "from mm_s2ut_torch.ops import _build; _build.library()"  # build once first
    torchrun --standalone --nproc_per_node 4 -m mm_s2ut_torch.tools.pipe_step \
        [--data 1] [--micro 8] [--steps 5] [--out DIR]

Each of the world's ranks holds one card; the world is ``--data`` ×
``pipe``, and the encoder of the flagship (:func:`flagship`, phase 11's
point of ``chip_smoke.py``: 12 + 6 layers at 512-d, selective fusion over
577×768 image features, every dropout 0.1, Adam; B=8 × 1000 frames × 100
targets) is a GPipe of ``pipe`` stages and ``--micro`` microbatches over
the ranks' ``DistributedTransport`` (``parallel/pipeline.py``). Rank 0
also runs the plain trainer on its card, from the same weights and seed.
With ``--data`` > 1 every rank also runs the data-parallel step without
the pipeline (the pipe ranks replicas): the same half batches, the
reference of the pipelined step's own rounding; its parameter change is
held to the plain run's within ``UPDATE_TOL`` in fp32 and
``BF16_DP_UPDATE_TOL`` in bf16, its losses within 1e-5 and
``BF16_DP_LOSS_TOL``.

In fp32 with TF32 off and in bf16 autocast, three steps each: the losses
within a relative 1e-5 of the reference's (the plain run's, in bf16 with
``--data`` > 1 the data-parallel run's), and the parameters' change,
gathered from every stage, within ``UPDATE_TOL`` of the reference's in L2
(``chip_smoke.py`` phase 20d's rule); every reading against every run is
printed. After fp32's steps the checkpoint is written (the stacked tree,
gathered over NCCL) and restored on every rank; after bf16's, ``--steps``
steps are timed on each side (CUDA-synchronised host clock). A and H
launches per step on each rank: L/pipe · micro. Rank 0 prints each phase
and, last, one JSON line.

:func:`flagship`, :func:`pipelined_state`, :func:`train_batch` and
:func:`update_error` are also ``chip_smoke.py``'s, for phase 25.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import tempfile
import time
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from mm_s2ut_torch.config import Config, MeshConfig, ModelConfig, MultimodalConfig, TrainConfig
from mm_s2ut_torch.convert import flatten, to_flax, unflatten
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel, init_parameters_
from mm_s2ut_torch.ops import attention as A
from mm_s2ut_torch.parallel.mesh import init_distributed
from mm_s2ut_torch.parallel.pipeline import sequential_params
from mm_s2ut_torch.train.trainer import Trainer

UPDATE_TOL = 2e-2  # chip_smoke.py phase 20d's limit on the parameters' change
# A bf16 data-parallel step against one card's: bf16 matmuls round a row by
# the call's shape, which reorders every later sum (tests/test_torch_ddp_bf16.py
# holds the port to 3x JAX's own gap on the CPU; the card's was 6.34e-2).
BF16_DP_UPDATE_TOL = 1e-1
BF16_DP_LOSS_TOL = 1e-4  # and its losses, relative (the card's were 1.71e-5 apart)


def flagship(seed: int = 25):
    """Phase 11's flagship in bf16 (every dropout 0.1) with random weights
    from ``seed``: (ModelConfig, TrainConfig, the model)."""
    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    mcfg = ModelConfig(vocab_size=1004, dtype="bfloat16", multimodal=mm)
    tcfg = TrainConfig(update_freq=1, warmup_updates=10, label_smoothing=0.2)
    return mcfg, tcfg, init_parameters_(MMS2UTModel(mcfg), torch.Generator().manual_seed(seed))


def pipelined_state(state: Mapping) -> dict:
    """A sequential encoder's state dict with its ``encoder.layer{i}``
    renamed to the pipelined stack's ``encoder.pipe_stack.layers.{i}``."""
    return {re.sub(r"^encoder\.layer(\d+)\.", r"encoder.pipe_stack.layers.\1.", k): v
            for k, v in state.items()}


def train_batch(B, T, Tt, vocab=1004, img_tokens=577, seed=0):
    """A fixed training batch as ``bench.py``'s train bench makes one:
    random log-mels of T frames, full lengths, random prev tokens and
    targets, random 577x768 image features."""
    rng = np.random.RandomState(seed)
    return {
        "src_features": rng.randn(B, T, 80).astype(np.float32),
        "src_lengths": np.full((B,), T, np.int32),
        "prev_output_tokens": rng.randint(4, vocab, (B, Tt)).astype(np.int32),
        "target": rng.randint(4, vocab, (B, Tt)).astype(np.int32),
        "imgs_list": (rng.randn(B, img_tokens, 768).astype(np.float32),),
        "img_masks_list": (np.zeros((B, img_tokens), bool),),
    }


def update_error(got: Mapping, want: Mapping) -> float:
    """‖got − want‖ / ‖want‖ in L2 over every entry of two parameter
    changes (numpy arrays or tensors, matched by key)."""
    diff = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    return (diff / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def _steps(trainer, batch, n):
    """(losses, A and H launches of each step, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, launches = [], []
    for _ in range(n):
        A.flash_attention.launches = A.flash_attention_bwd.launches = 0
        losses.append(trainer.train_batch(batch)["loss"])
        launches.append((A.flash_attention.launches, A.flash_attention_bwd.launches))
    torch.cuda.synchronize()
    return losses, launches, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None, help="checkpoint dir (default: a temporary one)")
    args = ap.parse_args(argv)
    parallel, device = init_distributed("cuda")
    if parallel is None:
        raise SystemExit("run under torchrun: one process per card")
    pipe = parallel.world // args.data
    if pipe < 2:
        raise SystemExit(f"--data {args.data} of {parallel.world} ranks leaves no pipeline")
    parallel = dataclasses.replace(parallel, pipe=pipe)
    rank0 = parallel.rank == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    if rank0:
        say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip())
    base, tcfg, plain_model = flagship()
    state = plain_model.state_dict()
    start = to_flax(plain_model)
    host = train_batch(8, 1000, 100, seed=25)
    per_step = base.encoder_layers // pipe * args.micro
    name = f"data {args.data} x pipe {pipe}, {args.micro} microbatches"
    out = {"world": parallel.world, "data": args.data, "pipe": pipe, "micro": args.micro}

    def trainer(dtype, where):
        """``where``: "plain" (this card alone), "dp" (the data-parallel
        step, pipe ranks replicas) or "pp" (pipelined)."""
        piped = where == "pp"
        mcfg = dataclasses.replace(base, dtype=dtype, pipeline_stages=pipe if piped else 0,
                                   pipeline_microbatches=args.micro if piped else 0)
        model = MMS2UTModel(mcfg)
        model.load_state_dict(pipelined_state(state) if piped else state)
        cfg = Config(model=mcfg, train=dataclasses.replace(tcfg),
                     mesh=MeshConfig(data=args.data, pipe=pipe))
        return Trainer(cfg, model, device, parallel=None if where == "plain" else parallel)

    def run(dtype, where):
        """Three steps: (losses, the parameters' change in the sequential
        layout, the trainer); every rank of a distributed run calls."""
        t = trainer(dtype, where)
        losses, launches, _ = _steps(t, host, 3)
        if where == "pp":
            assert all(c == (per_step, per_step) for c in launches), launches
        full = t.full_params() if where != "plain" else to_flax(t.model)
        flat = flatten(sequential_params(unflatten(full)))
        return losses, {k: flat[k] - start[k] for k in start}, t

    for dtype in ("float32", "bfloat16"):
        torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
        torch.backends.cudnn.allow_tf32 = dtype != "float32"  # PyTorch's default in bf16
        runs = {}
        if rank0:
            plain_losses, plain_change, plain = run(dtype, "plain")
            runs["plain"] = (plain_losses, plain_change)
            plain_ms = (_steps(plain, host, args.steps)[2] * 1e3 / args.steps
                        if dtype == "bfloat16" else None)
            del plain
            torch.cuda.empty_cache()
        dist.barrier()
        if args.data > 1:
            dp_losses, dp_change, dp = run(dtype, "dp")
            runs["dp"] = (dp_losses, dp_change)
            del dp
            torch.cuda.empty_cache()
        losses, change, piped = run(dtype, "pp")
        ref = "dp" if dtype == "bfloat16" and "dp" in runs else "plain"
        if rank0:
            out[dtype] = {"losses": losses}
            for other, (want, want_change) in runs.items():
                rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
                upd = update_error(change, want_change)
                say(f"pipe_step: {dtype} {name}: losses {[round(x, 5) for x in losses]} against "
                    f"the {other} run's {[round(x, 5) for x in want]} (relative "
                    f"{[float(f'{x:.2e}') for x in rel]}), parameter change {upd:.2e} of the "
                    f"{other} run's" + ("; the check's reference" if other == ref else ""))
                out[dtype][other] = {"losses": want, "max_rel": max(rel), "update_err": upd}
            if "dp" in runs:
                upd = update_error(runs["dp"][1], runs["plain"][1])
                say(f"pipe_step: {dtype} data {args.data} x pipe 1 (the data-parallel step) "
                    f"against the plain run: parameter change {upd:.2e} of the plain run's")
                lrel = max(abs(a - b) / abs(b) for a, b in zip(runs["dp"][0], runs["plain"][0]))
                out[dtype]["dp_vs_plain_update_err"] = upd
                out[dtype]["dp_vs_plain_max_rel"] = lrel
                bf16 = dtype == "bfloat16"
                assert (upd <= (BF16_DP_UPDATE_TOL if bf16 else UPDATE_TOL)
                        and lrel <= (BF16_DP_LOSS_TOL if bf16 else 1e-5)), (upd, lrel)
            assert (out[dtype][ref]["max_rel"] <= 1e-5
                    and out[dtype][ref]["update_err"] <= UPDATE_TOL), (dtype, ref, out[dtype])
        say(f"pipe_step: {dtype}: A and H {per_step} launches per pipelined step on each rank")
        if dtype == "float32":
            save = [args.out or (tempfile.mkdtemp(prefix="pipe_step_") if rank0 else None)]
            dist.broadcast_object_list(save, src=0)  # rank 0 writes, every rank reads
            piped.cfg.train.save_dir = save[0]
            piped.save_checkpoint()
            dist.barrier()
            again = trainer(dtype, "pp")
            again.cfg.train.save_dir = save[0]
            assert again.restore_checkpoint() == 3
            mine = to_flax(again.model)
            for k, v in to_flax(piped.model).items():
                assert np.array_equal(mine[k], v), k
            dist.barrier()
            say(f"pipe_step: the checkpoint, gathered over {dist.get_backend()}, restores on "
                f"every rank bit for bit")
            del again
        else:
            secs = _steps(piped, host, args.steps)[2]
            ms = torch.tensor([secs * 1e3 / args.steps], device=device)
            dist.all_reduce(ms, op=dist.ReduceOp.MAX)
            if rank0:
                bubble = (pipe - 1) / (args.micro + pipe - 1)
                say(f"pipe_step: bf16 {ms.item():.3f} ms per step (slowest rank, {args.steps} "
                    f"steps, CUDA-synchronised host clock) against the plain step's "
                    f"{plain_ms:.3f} ms on one card ({ms.item() / plain_ms:.3f} x); the GPipe "
                    f"bubble is (S-1)/(M+S-1) = {bubble:.3f}; peak memory on rank 0 "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                out["bfloat16"].update(ms=ms.item(), plain_ms=plain_ms)
        del piped
        torch.cuda.empty_cache()
        dist.barrier()
    say(json.dumps(out))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
