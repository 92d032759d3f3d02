"""Training criterions: label-smoothed CE and its R-Drop variant.

Port of ``mm_s2ut/train/criterion.py`` (``label_smoothed_nll_loss``,
``kl_symmetric``, ``speech_to_unit`` and ``speech_to_unit_v2``). Each
criterion returns (loss summed over non-pad targets, metrics); the
trainer normalises by ``ntokens`` (fairseq's sample_size convention).
With n_frames_per_step = n > 1 the decoder puts out n sub-frame logits
per packed position, and the loss reads the first columns that the
unpacked target has, as the reference does. With ``ctc_weight`` > 0 the
encoder CTC term over ``batch["multitask_target"]`` is added, and per
``multitask`` task its CTC or label-smoothed CE term (the task's own
smoothing and ``loss_weight``) over ``batch["multitask_targets"][name]``;
the reference's data pipeline makes neither, so only batches the caller
builds carry them. A multitask task whose logits or targets are missing
is left out; the encoder CTC term is not: with ``ctc_weight`` > 0 a batch
without ``multitask_target`` raises ``KeyError``, as in the reference, so
``cli.train`` over the dataset's batches fails at its first step.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from mm_s2ut_torch.ops.ctc import ctc_loss


def label_smoothed_nll_loss(
    logits: torch.Tensor,  # (B, T, V)
    targets: torch.Tensor,  # (B, T) int
    epsilon: float = 0.0,
    pad_id: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum-reduced (1 − eps)·nll + eps·(mean over the vocabulary of −log p)
    over non-pad positions; (loss_sum, ntokens, metrics)."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    targets = targets.long()
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    mask = (targets != pad_id).float()
    nll = nll * mask
    smooth = smooth * mask
    loss = (1.0 - epsilon) * nll + epsilon * smooth
    ntokens = mask.sum()
    n_correct = (logits.argmax(-1) == targets).float() * mask
    metrics = {"nll_loss": nll.sum(), "n_correct": n_correct.sum(), "ntokens": ntokens}
    return loss.sum(), ntokens, metrics


def kl_symmetric(logits_p: torch.Tensor, logits_q: torch.Tensor, targets: torch.Tensor,
                 pad_id: int = 1) -> torch.Tensor:
    """R-Drop's term: half the sum over non-pad positions of
    KL(p‖q) + KL(q‖p)."""
    lp = torch.log_softmax(logits_p.float(), dim=-1)
    lq = torch.log_softmax(logits_q.float(), dim=-1)
    p, q = lp.exp(), lq.exp()
    kl_pq = (p * (lp - lq)).sum(-1)
    kl_qp = (q * (lq - lp)).sum(-1)
    mask = (targets != pad_id).float()
    return ((kl_pq + kl_qp) * mask).sum() / 2.0


def speech_to_unit_criterion(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    label_smoothing: float = 0.2,
    pad_id: int = 1,
    ctc_weight: float = 0.0,
    ctc_blank_id: int = 0,
    multitask: Sequence = (),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Label-smoothed CE over the unit logits (cut to the target's length,
    for n_frames_per_step > 1), plus the CTC and multitask terms;
    (loss_sum, metrics)."""
    target = batch["target"]
    logits = outputs["logits"][:, : target.shape[1]]
    loss, _, metrics = label_smoothed_nll_loss(logits, target, label_smoothing, pad_id)
    if ctc_weight > 0 and "ctc_logits" in outputs:
        ctc = _ctc_term(outputs, outputs["ctc_logits"], batch["multitask_target"], pad_id,
                        ctc_blank_id)
        loss = loss + ctc_weight * ctc
        metrics["ctc_loss"] = ctc
    mt_logits = outputs.get("multitask_logits") or {}
    mt_targets = batch.get("multitask_targets") or {}
    for task in multitask:
        name = task.task_name
        if name not in mt_logits or name not in mt_targets:
            continue
        if task.decoder_type == "ctc":
            aux = _ctc_term(outputs, mt_logits[name], mt_targets[name], pad_id, ctc_blank_id)
        else:
            aux, _, _ = label_smoothed_nll_loss(mt_logits[name], mt_targets[name],
                                                task.label_smoothing, pad_id)
        loss = loss + task.loss_weight * aux
        metrics[f"{name}_loss"] = aux
    metrics["loss"] = loss
    return loss, metrics


def _ctc_term(outputs, logits, targets, pad_id: int, blank_id: int) -> torch.Tensor:
    """The summed CTC loss of ``logits`` over the encoder's frames against
    ``targets`` (pad-padded)."""
    input_lengths = (~outputs["encoder_padding_mask"]).sum(-1)
    return ctc_loss(logits, input_lengths, targets, (targets != pad_id).sum(-1),
                    blank_id=blank_id).sum()


def speech_to_unit_rdrop_criterion(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    label_smoothing: float = 0.2,
    pad_id: int = 1,
    rdrop_alpha: float = 0.0,
    outputs_b: Optional[Dict[str, torch.Tensor]] = None,
    **kwargs,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """R-Drop: CE (and the auxiliary terms, ``kwargs``) on two stochastic
    passes + α·symmetric KL between them; without ``outputs_b``, one pass."""
    loss, metrics = speech_to_unit_criterion(outputs, batch, label_smoothing, pad_id, **kwargs)
    if outputs_b is not None and rdrop_alpha > 0:
        loss_b, _ = speech_to_unit_criterion(outputs_b, batch, label_smoothing, pad_id, **kwargs)
        Tt = batch["target"].shape[1]
        kl = kl_symmetric(outputs["logits"][:, :Tt], outputs_b["logits"][:, :Tt],
                          batch["target"], pad_id)
        loss = loss + loss_b + rdrop_alpha * kl
        metrics["kl_loss"] = kl
        metrics["loss"] = loss
    return loss, metrics


CRITERIONS = {
    "speech_to_unit": speech_to_unit_criterion,
    "speech_to_unit_v2": speech_to_unit_rdrop_criterion,
}
