"""The port's streaming vocoder (``infer/streaming_vocoder.py``): units fed
in chunks give the samples of one exact-length offline
``CodeHiFiGAN.forward`` over the whole sequence (the port's, atol 1e-5 as
in tests/test_streaming_vocoder.py: the same convs over other window
lengths), and of the JAX package's offline vocoder (atol 1e-4, the port
against JAX in tests/test_torch_vocoder.py), with the JAX parameters
carried across by ``convert.from_flax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.infer.streaming_vocoder import generator_halo_samples as j_halo
from mm_s2ut.models.hifigan import CodeHiFiGAN as JVocoder
from mm_s2ut_torch.convert import from_flax
from mm_s2ut_torch.infer.streaming_vocoder import StreamingVocoderSession, generator_halo_samples
from mm_s2ut_torch.models.hifigan import CodeHiFiGAN as TVocoder
from mm_s2ut_torch.models.hifigan import HiFiGANConfig as TCfg
from tests.test_streaming_vocoder import SMALL, _offline

torch.set_num_threads(1)


def _vocoders(dur_pred, units, seed=0):
    jcfg = SMALL.__class__(**{**SMALL.__dict__, "dur_prediction": dur_pred})
    params = JVocoder(jcfg, max_frames=8).init(
        jax.random.PRNGKey(seed), jnp.asarray([units[:4]], jnp.int32), jnp.asarray([4], jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    tvoc = TVocoder(TCfg(**jcfg.__dict__))
    tvoc.load_state_dict(from_flax(params, tvoc))
    return jcfg, params, tvoc.eval()


def _t_offline(tvoc, units):
    u = torch.tensor([units])
    tvoc.max_frames = int(tvoc.unit_durations(u).sum())
    wav, n = tvoc(u)
    assert int(n[0]) == tvoc.max_frames * tvoc.cfg.hop_length
    return wav[0].numpy()


def test_halo_matches_jax():
    assert generator_halo_samples(TCfg(**SMALL.__dict__)) == j_halo(SMALL)
    assert generator_halo_samples(TCfg()) == j_halo(SMALL.__class__())


@pytest.mark.parametrize("dur_pred", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 17])
def test_streamed_equals_offline(dur_pred, chunk):
    units = np.random.RandomState(0).randint(0, SMALL.num_embeddings, 40).tolist()
    jcfg, params, tvoc = _vocoders(dur_pred, units)
    want = _t_offline(tvoc, units)
    sess = StreamingVocoderSession(tvoc, emit_frames=8, max_units=64)
    got = [sess.feed(units[i : i + chunk]) for i in range(0, len(units), chunk)]
    got = np.concatenate(got + [sess.finalize()])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, _offline(jcfg, params, units), atol=1e-4)


def test_short_stream_single_window():
    """A stream shorter than one window takes the exact-length tail path."""
    units = np.random.RandomState(1).randint(0, SMALL.num_embeddings, 3).tolist()
    jcfg, params, tvoc = _vocoders(True, units + [0], seed=1)
    sess = StreamingVocoderSession(tvoc, emit_frames=64, max_units=16)
    got = np.concatenate([sess.feed(units), sess.finalize()])
    np.testing.assert_allclose(got, _t_offline(tvoc, units), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, _offline(jcfg, params, units), atol=1e-4)
