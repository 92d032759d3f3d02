"""The port's counter-hash dropout against the JAX package's, bit for bit.

* ``_mix`` and ``dropout_keep`` on random uint32 coordinates and on the
  edge seeds 0 and 2^32 - 1, at rates 0.1, 0.25 and 0.5 (the port computes
  on uint32 values held in int64; JAX on uint32);
* ``hash_dropout``'s forward and gradient against JAX's ``hash_dropout``
  and its VJP for a (B, T, F) input, fp32 and bf16: exact;
* the keep fraction of both within 3 sigma of 1 - rate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.ops.attention import _mix as j_mix
from mm_s2ut.ops.attention import dropout_keep as j_keep
from mm_s2ut.ops.dropout import hash_dropout as j_hash_dropout
from mm_s2ut_torch.ops import attention as TA
from mm_s2ut_torch.ops import dropout as TD

SEEDS = [0, 2**32 - 1, 123456789]
RATES = [0.1, 0.25, 0.5]


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def test_mix_bit_exact():
    rng = np.random.RandomState(0)
    x = np.concatenate([_u32(rng, (4096,)), np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])
    want = np.asarray(j_mix(jnp.asarray(x)))
    got = TA._mix(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_keep_bit_exact(seed, rate):
    rng = np.random.RandomState(seed % 1000)
    bh, qpos, kpos = (_u32(rng, (2048,)) for _ in range(3))
    want = np.asarray(j_keep(jnp.asarray(bh), jnp.asarray(qpos), jnp.asarray(kpos),
                             jnp.uint32(seed), rate))
    got = TA.dropout_keep(*(torch.from_numpy(x.astype(np.int64)) for x in (bh, qpos, kpos)),
                          seed, rate).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_hash_dropout_and_vjp_bit_exact(seed, dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 37, 24).astype(np.float32)
    g = rng.randn(2, 37, 24).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want, vjp = jax.vjp(lambda a: j_hash_dropout(a, jnp.uint32(seed), 0.25),
                        jnp.asarray(x, jdt))
    (want_g,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = TD.hash_dropout(xt, seed, 0.25)
    got.backward(torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want_g, np.float32))


@pytest.mark.parametrize("rate", RATES)
def test_keep_fraction(rate):
    n = 1 << 16
    keep = TD.keep_mask((n,), 7, rate, "cpu").numpy()
    want = np.asarray(j_keep(jnp.zeros(n, jnp.uint32), jnp.arange(n, dtype=jnp.uint32) // 256,
                             jnp.arange(n, dtype=jnp.uint32) % 256, jnp.uint32(7), rate))
    sigma = np.sqrt(rate * (1 - rate) / n)
    for k in (keep, want):
        assert abs(k.mean() - (1 - rate)) < 3 * sigma, (k.mean(), 1 - rate)
    attn = TA.attention_keep(1, 1, 256, 256, 7, rate, "cpu").numpy().reshape(-1)
    np.testing.assert_array_equal(attn, want)


def test_hash_dropout_module_needs_rng_in_training():
    drop = TD.HashDropout(0.1)
    x = torch.ones(4, 8)
    assert drop.eval()(x) is x
    with pytest.raises(RuntimeError, match="DropoutRng"):
        drop.train()(x)
    drop.rng = TD.DropoutRng(3, "cpu")
    y = drop(x)
    assert y.shape == x.shape and set(np.unique(y.numpy()).tolist()) <= {0.0, float(np.float32(1 / 0.9))}
