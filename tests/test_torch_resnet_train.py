"""``ResEncoder``/``SubModel`` in train mode against flax's, on the same
parameters and running statistics:

two steps on two seeded clips: the train-mode output (BatchNorm on the
batch's statistics) within fp32 1e-4 of its largest magnitude, the
``batch_stats`` flax's ``mutable=["batch_stats"]`` returns after each
step within 1e-4 of their largest magnitude (momentum 0.99, the biased
batch variance for the running variance too); between the steps both
sides take the same SGD step on JAX's gradient of a squared-output loss.
The port's gradients are held in
float64 (JAX's x64 mode), every parameter within 1e-6 of each tensor's
largest magnitude: in fp32 a BatchNorm's bias gradient is a sum whose
terms the next BatchNorm nearly cancels, and the two sides' rounding
differs there by up to 2% of the result (1e-5 of the terms; the float64
run shows the arithmetic is the same). ``num_layers`` is 0: the
transformer layers' training dropout keys on flax's rng, which the port
cannot reproduce (their dropout-free path is held in eval mode by
``test_torch_vit.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.models import resnet_encoder as JR
from mm_s2ut_torch.convert import flatten, from_flax, to_flax, unflatten
from mm_s2ut_torch.models import resnet_encoder as TR

torch.set_num_threads(1)
LR = 0.05


def _stats(model) -> dict:
    """The port's running statistics under flax's ``batch_stats`` names."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, TR.FlaxBatchNorm):
            out[f"{name.replace('.', '/')}/mean"] = mod.running_mean.numpy()
            out[f"{name.replace('.', '/')}/var"] = mod.running_var.numpy()
    return out


def _close(got, want, rel, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-4)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, rtol=0, err_msg=what)


# 64² frames leave 2×2 positions at the last stage. At 32² it is 1×1 and
# its BatchNorm sees only B·T values per channel, where flax's
# E[x²] − E[x]² cancels and the two sides differ by their fp32 rounding
# (0.1 of 3.0 at B·T = 2).
@pytest.mark.parametrize("shape", [(1, 4, 64, 64, 1), (2, 3, 64, 64, 1)])
def test_train_mode_output_stats_and_gradients_match_flax(shape):
    rng = np.random.RandomState(sum(shape))
    videos = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    jmodel = JR.SubModel(out_dim=32, num_layers=0)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(5),
                                                               video=videos[0]))
    stats = {k: v + (0.1 * rng.rand(*v.shape) if k.endswith("mean") else 0.5 * rng.rand(*v.shape))
             for k, v in flatten(variables["batch_stats"]).items()}
    params = variables["params"]
    batch_stats = unflatten({k: v.astype(np.float32) for k, v in stats.items()})
    tmodel = TR.SubModel(out_dim=32, num_layers=0)
    tmodel.load_state_dict(TR.from_flax_variables({"params": params,
                                                   "batch_stats": batch_stats}, tmodel))
    tmodel.train()

    def j_loss(p, bs, video):
        out, upd = jmodel.apply({"params": p, "batch_stats": bs}, video=video, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out * out), (out, upd["batch_stats"])

    for step, video in enumerate(videos):
        (_, (want, batch_stats)), grads = jax.value_and_grad(j_loss, has_aux=True)(
            params, batch_stats, video)
        tmodel.zero_grad()
        got = tmodel(video=torch.from_numpy(video))
        got.square().sum().backward()
        _close(got.detach().numpy(), want, 1e-4, f"step {step} output")
        want_stats = flatten(jax.tree_util.tree_map(np.asarray, batch_stats))
        got_stats = _stats(tmodel)
        assert set(got_stats) == set(want_stats)
        for k, v in want_stats.items():
            _close(got_stats[k], v, 1e-4, f"step {step} {k}")
        # The same SGD step on both sides (JAX's gradients; the port's are
        # held in float64 below), so step 2 compares forwards at equal weights.
        params = jax.tree_util.tree_map(lambda p, g: p - LR * g, params, grads)
        tmodel.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params), tmodel),
                               strict=False)
    assert all(int(m.num_batches_tracked) == 2 for m in tmodel.modules()
               if isinstance(m, TR.FlaxBatchNorm))


def test_train_mode_gradients_match_flax_in_float64():
    rng = np.random.RandomState(11)
    video = rng.randn(2, 3, 64, 64, 1)
    with jax.enable_x64(True):
        jmodel = JR.SubModel(out_dim=32, num_layers=0, dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jmodel.init(jax.random.PRNGKey(6), video=video))

        def j_loss(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                  video=video, train=True, mutable=["batch_stats"])
            return jnp.sum(out * out)

        want = flatten(jax.tree_util.tree_map(np.asarray, jax.grad(j_loss)(variables["params"])))
    tmodel = TR.SubModel(out_dim=32, num_layers=0)
    tmodel.load_state_dict(TR.from_flax_variables(variables, tmodel))
    tmodel = tmodel.double().train()
    tmodel(video=torch.from_numpy(video)).square().sum().backward()
    grad_model = TR.SubModel(out_dim=32, num_layers=0).double()
    for g, p in zip(grad_model.parameters(), tmodel.parameters()):
        g.data = p.grad
    got = to_flax(grad_model)
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, 1e-6, f"grad {k}")


def test_flax_batch_norm_eval_mode_is_torch_batch_norm():
    """In eval mode the layer is torch's BatchNorm on its running
    statistics, which from_flax_variables fills."""
    bn = TR.FlaxBatchNorm(4)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        bn.running_var.copy_(torch.tensor([1.5, 0.5, 2.0, 1.0]))
        bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5, -1.0]))
    x = torch.randn(3, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.BatchNorm2d(4, eps=TR.BN_EPS)
    ref.load_state_dict(bn.state_dict())
    torch.testing.assert_close(bn.eval()(x), ref.eval()(x))
