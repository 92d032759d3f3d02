"""``python -m mm_s2ut_torch.inference --device cpu`` on a synthetic
wav + npy corpus: it writes the JAX CLI's three artifacts, and its
``.unit`` lines equal the JAX UnitGenerator's output on the same
features and parameters (exported the way scripts/export_jax_params.py
exports a Trainer checkpoint), also with ``generation.kv_cache_dtype:
int8`` in the model's ``config.yaml``."""
import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.config import Config, DataConfig, GenerationConfig, save_yaml
from mm_s2ut.data.audio_io import get_waveform, write_wav
from mm_s2ut.data.dictionary import UnitDictionary
from mm_s2ut.data.manifest import ManifestRow, write_manifest
from mm_s2ut.infer.generator import UnitGenerator
from mm_s2ut.ops.fbank import FbankConfig
from mm_s2ut.tasks.s2s_task import waveform_frontend
from mm_s2ut_torch.config import load_config
from mm_s2ut_torch.inference import main
from scripts.export_jax_params import flatten_params
from tests.test_hifigan import SMALL, _torch_generator
from tests.test_torch_model import small_models

torch.set_num_threads(1)
GEN = dict(beam=2, max_len_a=0.0, max_len_b=10)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    jmodel, params, _ = small_models("float32", seed=5, logit_scale=8.0)
    model_dir = root / "model"
    model_dir.mkdir()
    save_yaml(Config(model=jmodel.cfg, data=DataConfig(), generation=GenerationConfig(**GEN)),
              model_dir / "config.yaml")
    np.savez(model_dir / "params.npz", **flatten_params(params["params"]))
    rng = np.random.RandomState(6)
    rows = []
    for i, n in enumerate((8000, 5600)):
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), 16000)
        rows.append(ManifestRow(str(i), str(root / f"{i + 1}.wav"), n, "1 2 3", 3))
    write_manifest(root / "test.tsv", rows)
    np.save(root / "img.npy", rng.randn(7, 768).astype(np.float32))

    torch.manual_seed(0)
    sd = dict(_torch_generator(SMALL).state_dict())
    sd["dict.weight"] = torch.randn(1000, SMALL.embedding_dim)
    torch.save(sd, root / "vocoder.pt")
    vcfg = {k: (list(map(list, v)) if k == "resblock_dilation_sizes" else v)
            for k, v in dataclasses.asdict(SMALL).items()}
    vcfg.update(num_embeddings=1000, dur_prediction=False)
    (root / "vocoder.json").write_text(json.dumps(vcfg))
    return root, jmodel, params


def _jax_units(jmodel, params, wav_paths, img=None, gen=GEN):
    wavs = [get_waveform(str(p), use_sample_rate=16000)[0] for p in wav_paths]
    batch = np.zeros((len(wavs), max(map(len, wavs))), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    feats, lens = waveform_frontend(
        jnp.asarray(batch), jnp.asarray([len(w) for w in wavs], np.int32), FbankConfig()
    )
    imgs = (img[None],) if img is not None else ()
    masks = (np.zeros((1, img.shape[0]), bool),) if img is not None else ()
    hyps = UnitGenerator(jmodel, params, GenerationConfig(**gen)).generate(
        np.asarray(feats), np.asarray(lens), imgs, masks
    )
    d = UnitDictionary(1000)
    return [" ".join(str(u) for u in d.ids_to_units(np.asarray(h[0]["tokens"]))) for h in hyps]


def test_single_sample_with_image_and_vocoder(corpus, tmp_path):
    root, jmodel, params = corpus
    rc = main([
        "--model_path", str(root / "model"), "--audio_path", str(root / "1.wav"),
        "--image_path", str(root / "img.npy"), "--output_dir", str(tmp_path),
        "--vocoder_path", str(root / "vocoder.pt"), "--vocoder_cfg", str(root / "vocoder.json"),
        "--device", "cpu",
    ])
    assert rc == 0
    got = (tmp_path / "1.unit").read_text().strip()
    want = _jax_units(jmodel, params, [root / "1.wav"], np.load(root / "img.npy"))[0]
    assert got == want and got
    gen = (tmp_path / "generate-test.txt").read_text()
    assert "H-0" in gen and "D-0" in gen
    wav, sr = get_waveform(str(tmp_path / "1_pred.wav"))
    assert sr == 16000 and len(wav) == len(got.split()) * SMALL.hop_length


def test_int8_kv_cache_from_config_yaml(corpus, tmp_path):
    """The yaml key the JAX CLI reads (generation.kv_cache_dtype) reaches
    the port's decoder: int8 cache and cross slab, the JAX int8 units."""
    root, jmodel, params = corpus
    gen = dict(GEN, kv_cache_dtype="int8")
    model_dir = tmp_path / "model_int8"
    model_dir.mkdir()
    save_yaml(Config(model=jmodel.cfg, data=DataConfig(), generation=GenerationConfig(**gen)),
              model_dir / "config.yaml")
    assert load_config(model_dir / "config.yaml").generation.kv_cache_dtype == "int8"
    shutil.copy(root / "model" / "params.npz", model_dir / "params.npz")
    rc = main([
        "--model_path", str(model_dir), "--audio_path", str(root / "1.wav"),
        "--image_path", str(root / "img.npy"), "--output_dir", str(tmp_path / "out"),
        "--device", "cpu",
    ])
    assert rc == 0
    got = (tmp_path / "out" / "1.unit").read_text().strip()
    want = _jax_units(jmodel, params, [root / "1.wav"], np.load(root / "img.npy"), gen)[0]
    assert got == want and got


def test_batch_manifest(corpus, tmp_path):
    root, jmodel, params = corpus
    rc = main([
        "--model_path", str(root / "model"), "--manifest_file", str(root / "test.tsv"),
        "--output_dir", str(tmp_path), "--gen_subset", "dev", "--beam", "2", "--device", "cpu",
    ])
    assert rc == 0
    want = _jax_units(jmodel, params, [root / "1.wav", root / "2.wav"])
    assert all(want)
    assert [(tmp_path / f"{i}.unit").read_text().strip() for i in (1, 2)] == want
    assert "T-1" in (tmp_path / "generate-dev.txt").read_text()


def test_cuda_without_a_card_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    root, _, _ = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model_path", str(root / "model"), "--audio_path", str(root / "1.wav"),
              "--output_dir", str(tmp_path)])


def test_unported_flags_are_rejected(corpus, tmp_path):
    root, _, _ = corpus
    with pytest.raises(SystemExit):
        main(["--model_path", str(root / "model"), "--manifest_file", str(root / "test.tsv"),
              "--output_dir", str(tmp_path), "--continuous-batching", "--device", "cpu"])
