"""Beam search through the port's other fusion types against the JAX
package's: ``UnitGenerator.generate`` on the six small models of
``tests/test_torch_fusion_types.py`` (EOS's embedding row zeroed and the
decoder's final norm scaled x3 on both sides, so that hypotheses run to
the budget and argmaxes are not near-ties), on the float and the int8
cache: every beam's tokens equal, scores atol 1e-4. The merged type's
cross-attention reads [speech; image]."""
import numpy as np
import pytest

from mm_s2ut.config import GenerationConfig as JGenCfg
from mm_s2ut.infer.generator import UnitGenerator as JGenerator
from mm_s2ut_torch import config as tconfig
from mm_s2ut_torch.infer.generator import UnitGenerator as TGenerator
from tests.test_torch_fusion_types import B, SETTINGS, _batch, _cfg, _jmodel, _params, _tmodel


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_generate_matches_jax(setting, kv):
    jcfg = _cfg(setting)
    params = _params(setting, scale=3.0)
    tmodel = _tmodel(jcfg, params)
    b = _batch(setting, seed=5)
    gkw = dict(beam=3, max_len_a=0.0, max_len_b=9, kv_cache_dtype=kv or "bfloat16")
    args = (b["src_features"], b["src_lengths"], b["imgs_list"], b["img_masks_list"])
    want = JGenerator(_jmodel(jcfg), params, JGenCfg(**gkw)).generate(*args)
    got = TGenerator(tmodel, tconfig.GenerationConfig(**gkw)).generate(*args)
    assert all(got[i][0]["tokens"] for i in range(B))
    for i in range(B):
        assert [h["tokens"] for h in got[i]] == [h["tokens"] for h in want[i]]
        np.testing.assert_allclose([h["score"] for h in got[i]], [h["score"] for h in want[i]],
                                   atol=1e-4)
