"""``python -m mm_s2ut_torch.cli.stream --device cpu`` end to end on an
exported causal-encoder model (``config.yaml`` + ``params.npz``, as
scripts/export_jax_params.py writes them): its ``.unit`` equals the JAX
package's offline decoding of the same audio (which the JAX streaming
CLI's finalize equals, tests/test_streaming.py) and the port's offline
CLI, and its ``_pred.wav``, synthesized incrementally from the committed
units, equals an exact-length offline vocode of the final units within
PCM16 write/read quantization (atol 2e-4, the reference test's bound)."""
import shutil

import numpy as np
import pytest
import torch

from mm_s2ut.config import Config, DataConfig, GenerationConfig, ModelConfig, MultimodalConfig
from mm_s2ut.config import save_yaml
from mm_s2ut.data.audio_io import get_waveform, write_wav
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
from mm_s2ut_torch.cli.stream import main
from mm_s2ut_torch.inference import main as offline_main
from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig, load_fairseq_checkpoint
from scripts.export_jax_params import flatten_params
from tests.test_torch_cli import _jax_units
from tests.test_torch_cli import corpus as vocoder_corpus  # noqa: F401  (fixture)

torch.set_num_threads(1)
GEN = dict(beam=2, max_len_a=0.0, max_len_b=10)


@pytest.fixture(scope="module")
def causal_model(tmp_path_factory):
    import jax

    root = tmp_path_factory.mktemp("torch_stream_cli")
    mcfg = ModelConfig(
        encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
        decoder_layers=1, decoder_attention_heads=2, conv_channels=16, vocab_size=40,
        dtype="float32", encoder_causal_attention=True, attention_dropout=0.0,
        multimodal=MultimodalConfig(multimodal_attention_type=None),
    )
    jmodel = JModel(mcfg)
    feats = np.zeros((1, 48, 80), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), feats, np.full((1,), 48, np.int32),
                         np.zeros((1, 3), np.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    model_dir = root / "model"
    model_dir.mkdir()
    save_yaml(Config(model=mcfg, data=DataConfig(standardize_audio=False),
                     generation=GenerationConfig(**GEN)), model_dir / "config.yaml")
    np.savez(model_dir / "params.npz", **flatten_params(params["params"]))
    # Not a multiple of the 160 ms chunk: the last feed is short.
    wav = (0.3 * np.random.RandomState(0).randn(16000 // 4 + 731 * 3)).astype(np.float32)
    write_wav(root / "2.wav", wav, 16000)
    return root, jmodel, params


def test_stream_cli_units_and_wav(causal_model, vocoder_corpus, tmp_path):
    root, jmodel, params = causal_model
    voc_root = vocoder_corpus[0]
    out = tmp_path / "stream"
    rc = main([
        "--model_path", str(root / "model"), "--audio_path", str(root / "2.wav"),
        "--output_dir", str(out), "--chunk-ms", "160", "--vocoder_path",
        str(voc_root / "vocoder.pt"), "--vocoder_cfg", str(voc_root / "vocoder.json"),
        "--device", "cpu",
    ])
    assert rc == 0
    streamed = (out / "2.unit").read_text().strip()
    assert streamed and streamed == _jax_units(jmodel, params, [root / "2.wav"], gen=GEN)[0]
    assert offline_main(["--model_path", str(root / "model"), "--audio_path",
                         str(root / "2.wav"), "--output_dir", str(tmp_path / "offline"),
                         "--device", "cpu"]) == 0
    assert (tmp_path / "offline" / "2.unit").read_text().strip() == streamed

    vcfg = HiFiGANConfig.from_json(voc_root / "vocoder.json")
    voc = CodeHiFiGAN(vcfg)
    voc.load_state_dict(load_fairseq_checkpoint(voc_root / "vocoder.pt", vcfg))
    u = torch.tensor([[int(x) for x in streamed.split()]])
    voc.max_frames = int(voc.unit_durations(u).sum())
    want, n = voc.eval()(u)
    got, sr = get_waveform(str(out / "2_pred.wav"))
    assert sr == 16000
    np.testing.assert_allclose(got, want[0, : int(n[0])].numpy(), atol=2e-4)


def test_full_redecode_and_offline_checkpoint_rules(causal_model, tmp_path):
    root, jmodel, params = causal_model
    rc = main(["--model_path", str(root / "model"), "--audio_path", str(root / "2.wav"),
               "--output_dir", str(tmp_path), "--full-redecode", "--decode-every", "2",
               "--device", "cpu"])
    assert rc == 0
    assert (tmp_path / "2.unit").read_text().strip() == \
        _jax_units(jmodel, params, [root / "2.wav"], gen=GEN)[0]
    # An offline (bidirectional) checkpoint cannot stream.
    offline = tmp_path / "offline_model"
    shutil.copytree(root / "model", offline)
    text = (offline / "config.yaml").read_text()
    assert "encoder_causal_attention: true" in text
    (offline / "config.yaml").write_text(
        text.replace("encoder_causal_attention: true", "encoder_causal_attention: false"))
    with pytest.raises(SystemExit):
        main(["--model_path", str(offline), "--audio_path", str(root / "2.wav"),
              "--output_dir", str(tmp_path / "x"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--model_path", str(root / "model"), "--audio_path", str(root / "2.wav"),
                  "--output_dir", str(tmp_path / "y")])
