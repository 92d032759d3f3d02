"""Training through the port's other fusion types against the JAX
package's: on the six small models of ``tests/test_torch_fusion_types.py``
in training mode at every dropout rate 0, the ntokens-normalised
label-smoothed loss and every parameter's gradient against ``jax.grad``
(``tests/test_torch_train_model.py``'s rule)."""
import copy

import jax
import numpy as np
import pytest
import torch

from mm_s2ut.train.criterion import speech_to_unit_criterion as j_criterion
from mm_s2ut_torch.convert import to_flax
from mm_s2ut_torch.train.criterion import speech_to_unit_criterion as t_criterion
from tests.test_torch_fusion_types import (SETTINGS, _batch, _cfg, _j_args, _jmodel, _params, _t,
                                           _t_args, _tmodel)
from tests.test_torch_train_model import to_flat


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_loss_and_gradients_match_jax_grad(setting):
    """Training mode at every dropout rate 0: the ntokens-normalised
    label-smoothed loss (rtol 1e-5) and every parameter's gradient within
    1e-4 of its tensor's largest magnitude (floored at 1e-4); the
    attention k-projection biases, whose gradient is 0 in exact
    arithmetic, within 1e-7 of 0 on both sides."""
    jcfg = _cfg(setting)
    jmodel, params = _jmodel(jcfg), _params(setting)
    tmodel = _tmodel(jcfg, params).float()
    b = _batch(setting, seed=4)

    def j_loss(p):
        out = jmodel.apply(p, *_j_args(b), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0),
                                 "modality": jax.random.PRNGKey(1),
                                 "mask": jax.random.PRNGKey(2)})
        loss, m = j_criterion(out, b, label_smoothing=0.2)
        return loss / m["ntokens"]

    want_loss, want = jax.value_and_grad(j_loss)(params)
    want = to_flat(want["params"])
    tmodel.train()
    out = tmodel(*_t_args(b))
    loss, m = t_criterion(out, {"target": _t(b["target"])}, label_smoothing=0.2)
    loss = loss / m["ntokens"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = copy.deepcopy(tmodel)
    for g, p in zip(grads.parameters(), tmodel.parameters()):
        # a parameter the loss does not reach (the encoder's final norm under
        # a tower, HuBERT's mask embedding): JAX's gradient is 0 there
        g.data = torch.zeros_like(p) if p.grad is None else p.grad
    got = to_flax(grads)
    assert set(got) == set(want)
    for key, w in want.items():
        if key.endswith("k_proj/bias"):
            # 0 in exact arithmetic (softmax ignores a shift shared by a
            # row); both sides leave rounding of ~1e-9 there
            assert max(np.abs(got[key]).max(), np.abs(w).max()) <= 1e-7, key
            continue
        scale = max(np.abs(w).max(), 1e-4)
        np.testing.assert_allclose(got[key], w, atol=1e-4 * scale, rtol=0, err_msg=key)
