"""The port's CTC loss and greedy decode (``mm_s2ut_torch/ops/ctc.py``)
against the JAX package's (``mm_s2ut/ops/ctc.py``) on the same random
logits (numpy, seeded):

* the loss per row to a relative 1e-5, on rows with repeated labels, a
  row with no labels, rows shorter than their logits, and a row whose
  labels cannot fit in its frames (T < 2L+1 − repeats), where both give
  about 1e30 (held to a relative 1e-6) and ``F.ctc_loss`` gives inf;
* the gradient of the summed loss with respect to the logits against
  ``jax.grad``'s, the infeasible row's included: atol 1e-4 (the port's
  ``logaddexp`` takes JAX's derivative, which at -1e30 differs from
  ``torch.logaddexp``'s);
* the greedy decode equal, padding included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.ops.ctc import ctc_greedy_decode as j_greedy
from mm_s2ut.ops.ctc import ctc_loss as j_ctc
from mm_s2ut_torch.ops.ctc import ctc_greedy_decode, ctc_loss

B, T, V, L = 5, 13, 7, 5


def _inputs(seed):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(B, T, V)).astype(np.float32)
    labels = rng.randint(1, V, (B, L)).astype(np.int32)
    labels[0, 1] = labels[0, 2] = labels[0, 3]  # repeats need a blank between them
    logit_lens = np.array([13, 11, 9, 13, 4], np.int32)
    label_lens = np.array([5, 3, 0, 4, 3], np.int32)
    labels[4, :3] = [2, 2, 2]  # 3 repeats need 5 frames: row 4 (4 frames) is infeasible
    labels[1, 3:] = 1  # padding past the length is never read
    return logits, labels, logit_lens, label_lens


FEASIBLE = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_matches_jax(seed):
    logits, labels, logit_lens, label_lens = _inputs(seed)
    want = np.asarray(j_ctc(jnp.asarray(logits), jnp.asarray(logit_lens), jnp.asarray(labels),
                            jnp.asarray(label_lens)))
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(logit_lens),
                   torch.from_numpy(labels), torch.from_numpy(label_lens)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[FEASIBLE], want[FEASIBLE], rtol=1e-5)
    assert want[4] > 1e29 and np.isfinite(want[4])
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    # F.ctc_loss agrees on the feasible rows and gives inf on the other.
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.from_numpy(logit_lens).long(),
        torch.from_numpy(label_lens).long(), blank=0, reduction="none").numpy()
    np.testing.assert_allclose(got[FEASIBLE], ref[FEASIBLE], rtol=1e-4)
    assert np.isinf(ref[4])


@pytest.mark.parametrize("seed", [0, 3])
def test_ctc_loss_gradient_matches_jax_grad(seed):
    logits, labels, logit_lens, label_lens = _inputs(seed)

    def j_loss(x):
        return j_ctc(x, jnp.asarray(logit_lens), jnp.asarray(labels),
                     jnp.asarray(label_lens)).sum()

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    ctc_loss(x, torch.from_numpy(logit_lens), torch.from_numpy(labels),
             torch.from_numpy(label_lens)).sum().backward()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-4, rtol=0)
    # Frames past a row's length get no gradient.
    assert (x.grad.numpy()[1, 11:] == 0).all()


def test_ctc_loss_blank_id_matches_jax():
    logits, labels, logit_lens, label_lens = _inputs(5)
    labels = np.where(labels == 3, 1, labels)  # no label equals the blank
    want = np.asarray(j_ctc(jnp.asarray(logits), jnp.asarray(logit_lens), jnp.asarray(labels),
                            jnp.asarray(label_lens), blank_id=3))
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(logit_lens),
                   torch.from_numpy(labels), torch.from_numpy(label_lens), blank_id=3).numpy()
    np.testing.assert_allclose(got[FEASIBLE], want[FEASIBLE], rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_greedy_decode_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 4, (B, T))  # many blanks and repeats
    logits = np.full((B, T, V), -5.0, np.float32)
    np.put_along_axis(logits, ids[..., None], 5.0, axis=2)
    logits += 0.1 * rng.randn(B, T, V).astype(np.float32)
    lens = np.array([13, 10, 1, 0, 7], np.int32)
    want = np.asarray(j_greedy(jnp.asarray(logits), jnp.asarray(lens)))
    got = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(j_greedy(jnp.asarray(logits), jnp.asarray(lens), blank_id=2, pad_id=9))
    got = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens), 2, 9).numpy()
    np.testing.assert_array_equal(got, want)
