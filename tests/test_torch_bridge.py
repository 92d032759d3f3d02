"""convert.from_flax is strict in both directions, convert.to_flax is its
exact inverse, and the npz layout of scripts/export_jax_params.py
round-trips through convert.load_npz."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mm_s2ut_torch.convert import flatten, from_flax, load_npz, to_flax, unflatten
from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig
from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
from scripts.export_jax_params import flatten_params
from tests.test_torch_model import small_models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    _, params, tmodel = small_models("float32")
    return params, tmodel


def test_complete_tree_loads(small):
    params, tmodel = small
    sd = from_flax(params, tmodel)
    assert set(sd) == set(dict(tmodel.named_parameters()))
    # Dense (in, out) → Linear (out, in).
    k = params["params"]["encoder"]["layer0"]["ffn"]["fc1"]["kernel"]
    np.testing.assert_array_equal(sd["encoder.layer0.ffn.fc1.weight"].numpy(), k.T)


def test_unused_flax_leaf_raises(small):
    params, tmodel = small
    extra = jax.tree_util.tree_map(lambda x: x, params)
    extra["params"]["decoder"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="no torch parameter"):
        from_flax(extra, tmodel)


def test_missing_flax_leaf_raises(small):
    params, tmodel = small
    short = jax.tree_util.tree_map(lambda x: x, params)
    del short["params"]["fusion0"]["gated_fusion"]["gate"]["bias"]
    with pytest.raises(KeyError, match="no flax leaf"):
        from_flax(short, tmodel)


def test_shape_mismatch_raises(small):
    params, tmodel = small
    cfg = dataclasses.replace(tmodel.cfg, vocab_size=tmodel.cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="the model wants"):
        from_flax(params, MMS2UTModel(cfg))


def test_torch_parameter_without_flax_rule_raises():
    voc = CodeHiFiGAN(HiFiGANConfig(num_embeddings=4, embedding_dim=2, model_in_dim=2,
                                    upsample_initial_channel=4, upsample_rates=(2,),
                                    upsample_kernel_sizes=(4,), resblock_kernel_sizes=(3,),
                                    resblock_dilation_sizes=((1,),), dur_prediction=False))
    voc.extra = torch.nn.Parameter(torch.zeros(1))
    with pytest.raises(TypeError, match="no rule"):
        from_flax({}, voc)


def test_npz_round_trip(small, tmp_path):
    params, tmodel = small
    np.savez(tmp_path / "params.npz", **flatten_params(params["params"]))
    loaded = load_npz(tmp_path / "params.npz")
    assert set(flatten(loaded)) == set(flatten(params["params"]))
    a, b = from_flax(loaded, tmodel), from_flax(params, tmodel)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_to_flax_inverts_from_flax(small):
    """The JAX tree comes back leaf for leaf, and a vocoder (transposed
    convs) survives torch → flax → torch unchanged."""
    params, tmodel = small
    tmodel.load_state_dict(from_flax(params, tmodel))
    got, want = to_flax(tmodel), flatten(params["params"])
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    torch.manual_seed(0)
    voc = CodeHiFiGAN(HiFiGANConfig(num_embeddings=6, embedding_dim=4, model_in_dim=4,
                                    upsample_initial_channel=8, upsample_rates=(2, 2),
                                    upsample_kernel_sizes=(4, 4)))
    sd = from_flax(unflatten(to_flax(voc)), voc)
    assert all(torch.equal(sd[k], p) for k, p in voc.named_parameters())
