"""The port's training forward and backward against the JAX package's,
on the small flagship (64-d, 2+2 layers, selective fusion, fp32) with
the same flax parameters (``convert.from_flax``):

* teacher-forced logits of ``MMS2UTModel.forward`` against JAX's
  ``model.apply(..., deterministic=True)``: atol 1e-4
  (``test_torch_model.py``'s fp32 tolerance);
* with every dropout rate at 0 and training on (JAX:
  ``deterministic=False``), the gradient of the ntokens-normalised
  label-smoothed loss for every parameter against ``jax.grad``'s, the
  port's gradients carried into flax's layout by ``convert.to_flax``:
  relative 1e-4 of each tensor's largest magnitude (the same arithmetic,
  summed in other orders through both passes), with that magnitude
  floored at 1e-4: the k-projection biases' gradients are 0 in exact
  arithmetic (softmax ignores a shift shared by a row) and both sides
  leave ~1e-9 of rounding there. The encoder's attention backward is H's
  plain twin here.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
from mm_s2ut.train.criterion import speech_to_unit_criterion as j_criterion
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.convert import from_flax, to_flax
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel as TModel
from mm_s2ut_torch.train.criterion import speech_to_unit_criterion as t_criterion

torch.set_num_threads(1)
B, T, TT, TI = 2, 72, 9, 40


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    target = rng.randint(4, 1004, (B, TT)).astype(np.int32)
    target[1, 6:] = 1  # pad
    masks = np.zeros((B, TI), bool)
    masks[1, TI - 5 :] = True
    return {
        "src_features": rng.randn(B, T, 80).astype(np.float32),
        "src_lengths": np.array([T, T - 23], np.int32),
        "prev_output_tokens": rng.randint(4, 1004, (B, TT)).astype(np.int32),
        "target": target,
        "imgs_list": (rng.randn(B, TI, 768).astype(np.float32),),
        "img_masks_list": (masks,),
    }


def _args(b, to_torch):
    conv = (lambda x: torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x)) \
        if to_torch else (lambda x: x)
    return (conv(b["src_features"]), conv(b["src_lengths"]), conv(b["prev_output_tokens"]),
            [conv(x) for x in b["imgs_list"]], [conv(x) for x in b["img_masks_list"]])


@pytest.fixture(scope="module")
def models():
    mm = dataclasses.replace(_flagship_cfg(small=True).multimodal, modality_dropout=0.0,
                             SA_image_dropout=0.0, SA_attention_dropout=0.0)
    jcfg = dataclasses.replace(_flagship_cfg(small=True), dtype="float32", dropout=0.0,
                               attention_dropout=0.0, activation_dropout=0.0, multimodal=mm)
    jmodel = JModel(jcfg)
    b = _batch()
    params = jmodel.init(jax.random.PRNGKey(3), *_args(b, False))
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = TModel(tconfig.from_dict(tconfig.ModelConfig, dataclasses.asdict(jcfg))).float()
    tmodel.load_state_dict(from_flax(params, tmodel))
    return jmodel, params, tmodel


def test_teacher_forced_logits_match_jax(models):
    jmodel, params, tmodel = models
    b = _batch()
    want = jmodel.apply(params, *_args(b, False), deterministic=True)
    with torch.no_grad():
        got = tmodel.eval()(*_args(b, True))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-4)
    np.testing.assert_array_equal(got["encoder_padding_mask"].numpy(),
                                  np.asarray(want["encoder_padding_mask"]))


def test_gradients_match_jax_grad(models):
    jmodel, params, tmodel = models
    b = _batch(seed=2)

    def j_loss(p):
        out = jmodel.apply(p, *_args(b, False), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0),
                                 "modality": jax.random.PRNGKey(1)})
        loss, m = j_criterion(out, b, label_smoothing=0.2)
        return loss / m["ntokens"]

    want = to_flat(jax.grad(j_loss)(params)["params"])
    tmodel.train()
    tmodel.zero_grad()
    out = tmodel(*_args(b, True))
    loss, m = t_criterion(out, {"target": torch.from_numpy(b["target"]).long()},
                          label_smoothing=0.2)
    (loss / m["ntokens"]).backward()
    grads = copy.deepcopy(tmodel)
    for g, p in zip(grads.parameters(), tmodel.parameters()):
        g.data = p.grad
    got = to_flax(grads)
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(np.abs(w).max(), 1e-4)
        np.testing.assert_allclose(got[key], w, atol=1e-4 * scale, rtol=0, err_msg=key)


def to_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(to_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out
