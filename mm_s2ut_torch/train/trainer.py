"""Trainer of the port: train step, evaluation, checkpoints, the fit loop.

Port of ``mm_s2ut/train/trainer.py``, on one device or data-parallel over
``torch.distributed`` (below). A train step is the
reference's: the teacher-forced forward in training mode (dropouts on,
drawn from the run's :class:`~mm_s2ut_torch.ops.dropout.DropoutRng`),
the label-smoothed loss over ``ntokens`` (with the model's CTC and
multitask terms, ``ctc_weight`` and ``multitask``; the batch's
``multitask_prev_tokens`` go to the model), the backward (kernel H for the
encoder's attention on the card), then the global gradient norm — a
non-finite norm skips the update (parameters and optimizer state stay,
the step advances) — and the optimizer (clip → Adam → schedule, with
MultiSteps accumulation; ``train/optimizer.py``). R-Drop
(``rdrop_alpha`` > 0) runs the forward twice.

``train.freezing_updates`` = N freezes every parameter under a module
named ``speech_encoder`` (the flagship's wav2vec2/HuBERT branch; the XM
model's is ``wav2vec2``, which the reference never freezes) for the steps
before N: a zero gradient, so Adam's moments decay as optax's do on it,
and no update, so weight decay does not shrink it either.

Parameters stay fp32 (the model is cast with ``.float()``); with
``model.dtype: bfloat16`` the forward and backward run under
``torch.autocast`` in bf16, with no loss scaling, as the reference keeps
fp32 parameters and computes in bf16.

Data parallelism (``parallel/mesh.py``; a :class:`DataParallel` from
``init_distributed``): every process runs the same trainer on its
contiguous rows of each host batch, and one step computes what one
process computes over the whole batch, as JAX's jit over the global
batch does. The processes sum their loss statistics first, so each
normalises by the batch's ``ntokens`` (a mean of per-process means would
weigh the processes' tokens wrongly); they sum the gradients in one
all-reduce of the flat gradient (every parameter, zeros where a process
has none), then clip and skip on the norm of the sum and step alike.
Dropout keys on global rows (``DropoutRng.shard``), and every process
draws from the same seed stream. A process with no rows (fewer rows than
processes) joins the sums with zeros and takes rank 0's generators after
the forward. Only rank 0 writes checkpoints and metrics. Validation
splits its batches the same way and gathers the sums; with
``inference_metrics_fn`` (``train.eval_inference``) each process decodes
and vocodes its own rows, and the MCD statistics of all processes are
reduced together.

Tensor parallelism (``mesh.model`` > 1, the same :class:`DataParallel`
with ``model``): the ranks of one data-parallel place ``d`` share its rows
and split the parameters ``_TP_RULES`` matches (``parallel/tensor.py``);
the loss statistics and the gradients are summed over the ranks of one
``m`` (the data-parallel group), the partial gradients that sequence
parallelism leaves (``model.sequence_parallel``) over the ranks of one
``d`` first. The global gradient norm counts each cut parameter's
squares once over its group and each whole one once. A checkpoint holds
the whole parameters (and optimizer moments), gathered, as a plain run
writes them; a restore cuts them again, and validation decodes from the
gathered weights (:meth:`Trainer.full_params`).

Pipeline parallelism (``mesh.pipe`` = ``model.pipeline_stages`` = S > 1):
the S ranks of one (d, m) hold the stages of the pipelined encoder
(``parallel/pipeline.py``, a :class:`~mm_s2ut_torch.parallel.pipeline.DistributedTransport`
over their group), each its L/S layers, and every other parameter whole;
they take the same rows and compute the same loss. A stage's own
parameters get their gradients from its stage alone, the replicated ones
(subsampler, fusion, decoder) end equal on every pipe rank, so every
gradient is summed over the data-parallel group only, and the global norm
counts each stage's squares once over the pipe group. ``ntokens`` is
counted as before. A checkpoint gathers the stages into the whole
stacked tree (and the whole optimizer state, in the order of the whole
model's parameters), and a restore takes each stage's rows again. With
``mesh.pipe`` > 1 and an encoder that is not pipelined, the pipe ranks are
replicas, as JAX's mesh replicates such a model over ``pipe``. A model
whose stacks the caller has put on a ``Loopback`` (every stage in this
process: ``parallel.pipeline.pipe_model_``) trains in one process.

Checkpoints are the port's own, in ``train.save_dir``: ``config.yaml``
(the full config, what ``mm_s2ut_torch.inference`` reads), ``params.npz``
(the parameters in flax's layout, ``convert.to_flax``) and ``optim.pt``
(optimizer state, step and generator states, for ``--resume``). The
reference's orbax checkpoints are not read. :func:`load_pretrained_encoder`
copies the ``encoder`` of such a save_dir into a fresh model, as the
reference's ``load_component``.
"""
from __future__ import annotations

import contextlib
import logging
import os
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from mm_s2ut_torch.config import Config, save_yaml
from mm_s2ut_torch.convert import (flatten, from_flax, gather_state_dict, load_npz,
                                   shard_state_dict, to_flax, unflatten)
from mm_s2ut_torch.models.s2t_encoder import SpeechTransformerEncoder
from mm_s2ut_torch.ops.dropout import DropoutRng
from mm_s2ut_torch.parallel.mesh import (DataParallel, batch_rows, is_stacked, process_groups,
                                         shard_batch, shard_rows)
from mm_s2ut_torch.parallel.pipeline import (DistributedTransport, PipelinedEncoderStack,
                                             gather_stages, pipe_model_)
from mm_s2ut_torch.parallel.tensor import (TensorParallel, gather_param, shard_model_,
                                           shard_param)
from mm_s2ut_torch.train.criterion import CRITERIONS
from mm_s2ut_torch.train.metrics import MetricsAggregator
from mm_s2ut_torch.train.optimizer import Optimizer, global_norm

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN restricted to its deterministic algorithms. The weight
    gradient of the conv subsampler's first conv otherwise sums in an
    order that varies from call to call (1e-9 apart in fp32), and Adam
    turns such a difference in a near-zero gradient into one of about lr,
    so two runs of one config from one seed would part, where the
    reference's are equal."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def to_device(batch: Dict, device: torch.device) -> Dict:
    """numpy arrays and tensors of a batch on ``device`` (integers as int64)."""

    def move(x):
        if isinstance(x, (tuple, list)):
            return type(x)(move(v) for v in x)
        if isinstance(x, dict):  # multitask_targets, multitask_prev_tokens
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            if x.dtype in (torch.int32, torch.int16, torch.uint8):
                x = x.long()
            return x.to(device)
        return x

    return {k: move(v) for k, v in batch.items()}


def load_pretrained_encoder(model: torch.nn.Module, ckpt_dir,
                            tp: Optional[TensorParallel] = None) -> None:
    """Copy the ``encoder`` subtree of ``ckpt_dir/params.npz`` into
    ``model`` (cut to this rank's part first when ``tp`` says the model is
    tensor-parallel); every other parameter keeps its value. Strict, with
    the reference's ``load_component`` messages: an ``encoder`` missing
    from the checkpoint or the model raises ``KeyError``, other names or
    shapes under it raise ``ValueError``."""
    path = Path(ckpt_dir) / "params.npz"
    if not path.exists():
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = load_npz(path)
    if tp is not None:
        src = unflatten(shard_state_dict(flatten(src), tp.rank, tp.size))
    tgt = unflatten(to_flax(model))
    if "encoder" not in src:
        raise KeyError(f"component 'encoder' not in checkpoint ({sorted(src)})")
    if "encoder" not in tgt:
        raise KeyError("component 'encoder' not in target model")

    def shapes(tree):  # a pipelined stack's rows per layer: a stage holds L/S of them
        return {k: v.shape[1:] if is_stacked(k) else v.shape for k, v in flatten(tree).items()}

    if shapes(src["encoder"]) != shapes(tgt["encoder"]):
        raise ValueError("shape mismatch loading 'encoder'")
    tgt["encoder"] = src["encoder"]
    model.load_state_dict(from_flax(tgt, model))
    logger.info("loaded pretrained encoder from %s", ckpt_dir)


class Trainer:
    def __init__(self, cfg: Config, model, device, criterion_name: str = "speech_to_unit",
                 parallel: Optional[DataParallel] = None):
        self.cfg = cfg
        self.parallel = parallel
        self.device = torch.device(device)
        self.model = model.float().to(self.device)
        self.dp_group = self.tp = self.pipe = None
        stages = cfg.model.pipeline_stages
        piped = stages > 1 and parallel is not None and parallel.pipe == stages
        if stages > 1 and not piped and any(
                m.transport is None for m in self.model.modules()
                if isinstance(m, PipelinedEncoderStack)):
            raise ValueError(f"model.pipeline_stages={stages} needs a pipe group of {stages} ranks "
                             f"(mesh.pipe={stages} under torchrun), not "
                             f"{1 if parallel is None else parallel.pipe}")
        if parallel is not None and (parallel.model > 1 or parallel.pipe > 1):
            self.dp_group, pipe_group, tp_group = process_groups(parallel)
            if piped:
                self.pipe = DistributedTransport(pipe_group, parallel.pipe_ranks(),
                                                 parallel.pp_rank, self.device)
                pipe_model_(self.model, self.pipe)
            if parallel.model > 1:
                self.tp = TensorParallel(tp_group, parallel.tp_rank, parallel.model)
                shard_model_(self.model, self.tp)
                if cfg.model.sequence_parallel:
                    for mod in self.model.modules():
                        if isinstance(mod, SpeechTransformerEncoder):
                            mod.shard_sequence(self.tp)
        self.rng = DropoutRng(cfg.train.seed, self.device)
        self.model.set_dropout_rng(self.rng)
        if cfg.train.rdrop_alpha > 0 and criterion_name == "speech_to_unit":
            criterion_name = "speech_to_unit_v2"  # R-Drop needs the two-pass criterion
        self.criterion = CRITERIONS[criterion_name]
        self.criterion_kwargs = dict(label_smoothing=cfg.train.label_smoothing,
                                     ctc_weight=cfg.model.ctc_weight,
                                     multitask=tuple(cfg.model.multitask))
        names, self.params = zip(*self.model.named_parameters())
        self.params = list(self.params)
        # The parameters freezing_updates holds: those under a "speech_encoder".
        self.frozen = [i for i, n in enumerate(names) if "speech_encoder" in n.split(".")]
        self.optimizer = Optimizer(self.params, cfg.train, norm=self.grad_norm)
        # This stage's own parameters (a contiguous run of self.params).
        self.pipe_local = ([i for i, n in enumerate(names) if ".pipe_stack.layers." in n]
                           if self.pipe is not None else [])
        # Partial gradients of sequence parallelism, summed over the TP group.
        self.seq_partial = [i for i, p in enumerate(self.params)
                            if getattr(p, "sequence_parallel", False)]
        self.step = 0
        self.amp_dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else None
        self.metrics_history: list = []
        self.metric_names: Optional[list] = None
        # Set by the entry point when train.eval_inference is on
        # (task.build_inference_metrics_fn); used by fit()'s validations.
        self.inference_metrics_fn: Optional[Callable[[Dict], Dict[str, float]]] = None

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and metrics (rank 0)."""
        return self.parallel is None or self.parallel.rank == 0

    def _shard(self, batch: Dict) -> Dict:
        """This process's rows of ``batch`` (its data-parallel place's),
        the dropout generators told where they start."""
        if self.parallel is None:
            return batch
        n = batch_rows(batch)
        d, dp_world = self.parallel.dp_rank, self.parallel.dp_world
        self.rng.shard(shard_rows(n, d, dp_world)[0], n)
        return shard_batch(batch, d, dp_world)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data-parallel group."""
        if self.parallel is not None and self.parallel.dp_world > 1:
            torch.distributed.all_reduce(t, group=self.dp_group)
        return t

    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm of ``grads`` (one per parameter): under tensor
        parallelism the cut parameters' squares summed over the group, under
        pipeline parallelism each stage's own over the pipe group."""
        if self.tp is None and self.pipe is None:
            return global_norm(grads)
        cut = local = None
        if self.tp is not None:
            cut = [getattr(p, "tp_sharded", False) for p in self.params]
        if self.pipe is not None:
            own = set(self.pipe_local)
            local = [i in own for i in range(len(self.params))]
        return global_norm(grads, cut, self.tp and self.tp.group, local,
                           self.pipe and self.pipe.group)

    def full_params(self) -> Dict[str, np.ndarray]:
        """The whole parameters as flat flax leaves (``convert.to_flax``),
        gathered over the tensor-parallel group and the pipe group (every
        rank of them calls)."""
        flat = to_flax(self.model)
        if self.tp is not None:
            flat = gather_state_dict(flat, self.tp)
        return flat if self.pipe is None else gather_stages(flat, self.pipe)

    # -- steps ---------------------------------------------------------------

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=self.amp_dtype or torch.float32,
                              enabled=self.amp_dtype is not None)

    def _outputs(self, batch, multitask_prev_tokens=None):
        return self.model(batch["src_features"], batch["src_lengths"],
                          batch["prev_output_tokens"], batch.get("imgs_list", ()),
                          batch.get("img_masks_list", ()), batch.get("tgt_speaker"),
                          multitask_prev_tokens=multitask_prev_tokens)

    def _loss(self, batch):
        tcfg = self.cfg.train
        mt_prev = batch.get("multitask_prev_tokens")
        with self._autocast():
            outputs = self._outputs(batch, mt_prev)
            kw = {}
            if tcfg.rdrop_alpha > 0:
                kw = dict(outputs_b=self._outputs(batch, mt_prev), rdrop_alpha=tcfg.rdrop_alpha)
        return self.criterion(outputs, batch, **self.criterion_kwargs, **kw)

    def train_batch(self, batch: Dict) -> Dict[str, float]:
        """One update (one mini-step under ``update_freq`` > 1)."""
        n = batch_rows(batch)
        batch = to_device(self._shard(batch), self.device)
        has_rows = batch_rows(batch) > 0
        self.model.train()
        for p in self.params:
            p.grad = None
        if has_rows:
            with deterministic_convs():
                loss, metrics = self._loss(batch)
            self.metric_names = sorted(metrics)
        if self.parallel is not None and n < self.parallel.dp_world:
            # Processes past the rows ran no forward: they take rank 0's
            # generators (where every forward left them) and metric names.
            shared = [self.metric_names, self.rng.state_dict()]
            torch.distributed.broadcast_object_list(shared, src=0)
            self.metric_names = shared[0]
            if not has_rows:
                self.rng.load_state_dict(shared[1])
        names = self.metric_names
        sums = (torch.stack([metrics[k].detach().float() for k in names]) if has_rows
                else torch.zeros(len(names), device=self.device))
        sums = self._all_reduce(sums)
        ntokens = sums[names.index("ntokens")]
        if has_rows:
            with deterministic_convs():
                (loss / ntokens.clamp_min(1.0)).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.seq_partial:
            part = torch.cat([grads[i].reshape(-1) for i in self.seq_partial])
            torch.distributed.all_reduce(part, group=self.tp.group)
            for i, g in zip(self.seq_partial, part.split([grads[i].numel()
                                                          for i in self.seq_partial])):
                grads[i] = g.view_as(grads[i])
        if self.parallel is not None and self.parallel.dp_world > 1:
            flat = self._all_reduce(torch.cat([g.reshape(-1) for g in grads]))
            grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in self.params]),
                                                   self.params)]
        frozen = self.frozen if self.step < self.cfg.train.freezing_updates else []
        for i in frozen:
            grads[i] = torch.zeros_like(grads[i])
        grad_norm = self.grad_norm(grads)
        ok = bool(torch.isfinite(grad_norm))
        if ok:
            self.optimizer.step(grads, grad_norm if self.cfg.train.update_freq <= 1 else None,
                                frozen=frozen)
        self.step += 1
        out = dict(zip(names, sums.tolist()))
        out["grad_norm"] = float(grad_norm)
        out["skipped"] = 0.0 if ok else 1.0
        return out

    @torch.no_grad()
    def evaluate(self, batches: Iterator[Dict],
                 inference_metrics_fn: Optional[Callable[[Dict], Dict[str, float]]] = None,
                 ) -> Dict[str, float]:
        """Criterion metrics over the batches, normalised by ntokens; with
        ``inference_metrics_fn`` (``train.eval_inference``) each batch is
        also decoded and vocoded, and its MCD statistics reduced
        (``eval.mcd.reduce_inference_metrics``)."""
        totals: Dict[str, float] = {}
        infer_logs = []
        for batch in batches:
            batch = self._shard(batch)
            if batch_rows(batch) == 0:
                continue
            if inference_metrics_fn is not None:
                infer_logs.append(inference_metrics_fn(batch))
            batch = to_device(batch, self.device)
            self.model.eval()
            with self._autocast():
                _, m = self.criterion(self._outputs(batch), batch, **self.criterion_kwargs)
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)
        if self.parallel is not None and self.parallel.dp_world > 1:
            gathered = [None] * self.parallel.dp_world
            torch.distributed.all_gather_object(gathered, (totals, infer_logs),
                                                group=self.dp_group)
            totals = {}
            for part, logs in gathered:
                for k, v in part.items():
                    totals[k] = totals.get(k, 0.0) + v
            infer_logs = [lo for _, logs in gathered for lo in logs]
        ntok = max(totals.get("ntokens", 1.0), 1.0)
        out = {
            "loss": totals.get("loss", 0.0) / ntok,
            "nll_loss": totals.get("nll_loss", 0.0) / ntok,
            "accuracy": totals.get("n_correct", 0.0) / ntok,
            "ntokens": ntok,
        }
        if infer_logs:
            from mm_s2ut_torch.eval.mcd import reduce_inference_metrics

            out.update(reduce_inference_metrics(infer_logs))
        return out

    # -- checkpoints ---------------------------------------------------------

    @property
    def save_dir(self) -> Path:
        return Path(self.cfg.train.save_dir)

    def _optimizer_state(self) -> Dict:
        """The optimizer's state, its moments whole (cut ones gathered over
        the tensor-parallel group; under pipeline parallelism every stage's
        own, in the whole model's parameter order)."""
        state = self.optimizer.state_dict()
        for key in ("mu", "nu", "acc"):
            if self.tp is not None:
                state[key] = [gather_param(t, p, self.tp)
                              for t, p in zip(state[key], self.params)]
            if self.pipe is not None:
                a, n = self.pipe_local[0], len(self.pipe_local)
                parts = [None] * self.pipe.n_stages
                torch.distributed.all_gather_object(
                    parts, [t.cpu() for t in state[key][a:a + n]], group=self.pipe.group)
                stages = [t.to(self.device) for part in parts for t in part]
                state[key] = state[key][:a] + stages + state[key][a + n:]
        return state

    def _stage_state(self, state: Dict) -> Dict:
        """The inverse of the pipe gather of :meth:`_optimizer_state`: this
        stage's entries of a whole optimizer state."""
        if self.pipe is None:
            return state
        a, n, s = self.pipe_local[0], len(self.pipe_local), self.pipe.stages[0]
        for key in ("mu", "nu", "acc"):
            whole = state[key]
            tail = len(whole) - (len(self.params) - a - n)
            state[key] = whole[:a] + whole[a + s * n:a + (s + 1) * n] + whole[tail:]
        return state

    def save_checkpoint(self) -> None:
        """config.yaml (once), params.npz and optim.pt, each replaced
        atomically; on rank 0 only (under tensor and pipeline parallelism
        every rank takes part in gathering them)."""
        if self.tp is None and self.pipe is None and not self.is_writer:
            return
        params, optim = self.full_params(), self._optimizer_state()
        if not self.is_writer:
            return
        d = self.save_dir
        d.mkdir(parents=True, exist_ok=True)
        if not (d / "config.yaml").exists():
            save_yaml(self.cfg, d / "config.yaml")
        tmp = d / "params.tmp.npz"
        np.savez(tmp, **params)
        os.replace(tmp, d / "params.npz")
        state = {"step": self.step, "optimizer": optim, "rng": self.rng.state_dict()}
        torch.save(state, d / "optim.tmp.pt")
        os.replace(d / "optim.tmp.pt", d / "optim.pt")

    def restore_checkpoint(self) -> int:
        """Parameters, optimizer state, step and generators from save_dir."""
        d = self.save_dir
        if not ((d / "params.npz").exists() and (d / "optim.pt").exists()):
            raise FileNotFoundError(f"no checkpoint (params.npz + optim.pt) in {d}")
        params = load_npz(d / "params.npz")
        if self.tp is not None:
            params = unflatten(shard_state_dict(flatten(params), self.tp.rank, self.tp.size))
        self.model.load_state_dict(from_flax(params, self.model))
        state = torch.load(d / "optim.pt", map_location=self.device, weights_only=True)
        optim = self._stage_state(state["optimizer"])
        if self.tp is not None:
            for key in ("mu", "nu", "acc"):
                optim[key] = [shard_param(t, p, self.tp) for t, p in zip(optim[key], self.params)]
        self.optimizer.load_state_dict(optim)
        self.rng.load_state_dict(state["rng"])
        self.step = int(state["step"])
        return self.step

    # -- loop ----------------------------------------------------------------

    def fit(self, train_iter: Callable[[int], Iterator[Dict]],
            valid_iter: Optional[Callable[[], Iterator[Dict]]] = None,
            max_update: Optional[int] = None, metrics_writer=None) -> int:
        """Epoch loop: ``train_iter(epoch)`` yields batches, one update
        each, until ``max_update``; validation and a checkpoint every
        ``save_interval_updates`` and at the end. Returns the step."""
        cfg = self.cfg.train
        max_update = max_update or cfg.max_update
        agg = MetricsAggregator()
        epoch = 0
        while self.step < max_update:
            saw_batch = False
            for batch in train_iter(epoch):
                saw_batch = True
                agg.update(self.train_batch(batch))
                step = self.step
                if step % cfg.log_interval == 0:
                    snap = agg.flush()
                    logger.info("epoch %d step %d loss %.4f nll %.4f acc %.3f %.0f tok/s",
                                epoch, step, snap.get("loss", 0.0), snap.get("nll_loss", 0.0),
                                snap.get("n_correct", 0.0), snap.get("ntokens_per_sec", 0.0))
                    self.metrics_history.append({"step": step, **snap})
                    if metrics_writer is not None:
                        metrics_writer.write(step, snap, "train")
                if cfg.save_interval_updates and step % cfg.save_interval_updates == 0:
                    self._validate_and_save(valid_iter, metrics_writer)
                if step >= max_update:
                    break
            if not saw_batch:
                break
            epoch += 1
        self._validate_and_save(valid_iter, metrics_writer)
        return self.step

    def _validate_and_save(self, valid_iter, metrics_writer) -> None:
        if valid_iter is not None:
            metrics = self.evaluate(valid_iter(), self.inference_metrics_fn)
            logger.info("valid at %d: %s", self.step, metrics)
            if metrics_writer is not None:
                metrics_writer.write(self.step, metrics, "valid")
        self.save_checkpoint()
