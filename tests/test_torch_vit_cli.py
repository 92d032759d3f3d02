"""The port's raw-image data path and entry points against the JAX
package's, on JPEGs and PNGs written by PIL (the port decodes them
without Pillow):

* ``RawImageStore`` items (path, preprocessed pixels, None) and the
  task's pixel batches equal JAX's exactly;
* the task fills the extractor from ``multimodal.load_visual_extractor``
  (a timm ``.pth``) and raises JAX's message on another geometry;
* ``python -m mm_s2ut_torch.inference --image_path x.jpg
  --vit_checkpoint vit.bin --device cpu`` writes JAX's CLI's units (JAX's
  checkpoint loader handed the same parameters), through
  ``vit_tiny_patch16_384`` (``image_feat_dim`` 192), and its features
  agree with JAX's within 1e-4;
* ``cli.extract_features`` (timm and CLIP) and ``cli.vit_rollout``: the
  ``.npy`` outputs against JAX's CLIs within 1e-4, the overlay PNG equal
  to JAX's but for ±1 where the mask's uint8 rounding flips.
"""
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mm_s2ut.config import Config as JConfig
from mm_s2ut.config import DataConfig as JData
from mm_s2ut.config import GenerationConfig as JGen
from mm_s2ut.config import MeshConfig
from mm_s2ut.config import ModelConfig as JModel
from mm_s2ut.config import MultimodalConfig as JMM
from mm_s2ut.config import TrainConfig as JTrain
from mm_s2ut.config import save_yaml
from mm_s2ut.data.audio_io import write_wav
from mm_s2ut.data.image_store import RawImageStore as JStore
from mm_s2ut.data.manifest import ManifestRow, write_manifest
from mm_s2ut.models.mm_s2ut import MMS2UTModel as JS2UT
from mm_s2ut.tasks.s2s_task import MultiModalSpeechToSpeechTask as JTask
from mm_s2ut_torch.config import load_config
from mm_s2ut_torch.convert import flatten, to_flax
from mm_s2ut_torch.data.image_store import RawImageStore
from mm_s2ut_torch.models.vit import VIT_VARIANTS
from mm_s2ut_torch.tasks.s2s_task import MultiModalSpeechToSpeechTask as TTask
from scripts.export_jax_params import flatten_params
from tests.test_torch_image_io import scene
from tests.test_torch_vit import _clip_state_dict, _timm_state_dict

torch.set_num_threads(1)
VIT_ARGS = {"embed_dim": 32, "depth": 1, "num_heads": 2, "patch_size": 16}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A flickr30k layout of four PIL images (two JPEG qualities and
    samplings, a PNG behind a .jpg-free name), 4 wavs, a train.tsv."""
    root = tmp_path_factory.mktemp("vit_corpus")
    img_dir = root / "flickr30k-images"
    img_dir.mkdir()
    names = []
    for i, (h, w) in enumerate([(48, 64), (37, 53), (60, 45), (33, 70)]):
        img = Image.fromarray(scene(h, w, seed=20 + i))
        name = f"img{i}.png" if i == 3 else f"img{i}.jpg"
        img.save(img_dir / name, **({} if i == 3 else dict(quality=70 + 10 * i,
                                                           subsampling=i % 3)))
        names.append(name)
    (root / "train.txt").write_text("\n".join(names) + "\n")
    (root / "test_2016_flickr.txt").write_text("\n".join(names[:3]) + "\n")
    rng = np.random.RandomState(0)
    rows = []
    for i in range(4):
        n = 4000 + 800 * i
        write_wav(root / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), 16000)
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, " ".join(map(str, range(3, 11))), 8))
    write_manifest(root / "train.tsv", rows)
    return root


def _task_cfg(root, kind="vit_timm", ckpt=None, **vit):
    return JConfig(
        model=JModel(
            encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
            encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
            decoder_layers=1, decoder_attention_heads=2, conv_channels=16, dtype="float32",
            multimodal=JMM(image_feat_dim=[32], multimodal_attention_type="selective_attention",
                           load_visual_extractor_type=kind, load_visual_extractor=ckpt,
                           flickr30k_root=str(root), image_input_size=32,
                           visual_extractor_args={**VIT_ARGS, **vit})),
        data=JData(data_root=str(root), audio_root=str(root), target_code_size=50,
                   max_tokens=400, num_buckets=1),
        train=JTrain(update_freq=1, warmup_updates=5, lr=1e-3, seed=3),
        mesh=MeshConfig(data=1),
    )


@pytest.mark.parametrize("mode,size", [("vit_timm", 32), ("vit_openai", 48),
                                       ("vit_huggingface", 40)])
def test_raw_image_store_items_equal_jax(corpus, mode, size):
    kw = dict(mode=mode, image_size=size)
    got, want = RawImageStore.for_split(corpus, "train", **kw), JStore.for_split(corpus, "train",
                                                                                **kw)
    assert len(got) == len(want) == 4
    for i in range(4):
        (gp, gx, gm), (wp, wx, wm) = got[i], want[i]
        assert gp == wp and gm is None and wm is None
        np.testing.assert_array_equal(gx, wx)


def test_task_pixel_batches_equal_jax(corpus, tmp_path):
    jcfg = _task_cfg(corpus)
    save_yaml(jcfg, tmp_path / "run.yaml")
    jb = next(iter(JTask(jcfg).batch_iterator("train", epoch=1)))
    tb = next(iter(TTask(load_config(tmp_path / "run.yaml"), "cpu").batch_iterator(
        "train", epoch=1)))
    assert tb["imgs_list"][0].shape == (len(jb["id"]), 32, 32, 3)
    for key in ("id", "target", "prev_output_tokens", "src_lengths"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]), err_msg=key)
    np.testing.assert_array_equal(tb["imgs_list"][0].numpy(), jb["imgs_list"][0])
    np.testing.assert_array_equal(tb["img_masks_list"][0].numpy(), jb["img_masks_list"][0])


def test_task_loads_the_pretrained_extractor(corpus, tmp_path):
    """A timm-format ``.pth`` for the configured graph fills the
    extractor with JAX's converted tree; another width raises JAX's
    message."""
    from mm_s2ut.models.vit import ViTConfig as JViT
    from mm_s2ut.models.vit import convert_timm_state_dict

    vcfg = JViT(image_size=32, **VIT_ARGS)
    sd = _timm_state_dict(vcfg, seed=4)
    torch.save(sd, tmp_path / "vit.pth")
    jcfg = _task_cfg(corpus, ckpt=str(tmp_path / "vit.pth"))
    save_yaml(jcfg, tmp_path / "run.yaml")
    model = TTask(load_config(tmp_path / "run.yaml"), "cpu").build_model()
    want = flatten(convert_timm_state_dict({k: v.numpy() for k, v in sd.items()}, vcfg)["params"])
    got = to_flax(model.visual_extractor)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    bad = _task_cfg(corpus, ckpt=str(tmp_path / "vit.pth"), embed_dim=24)
    save_yaml(bad, tmp_path / "bad.yaml")
    with pytest.raises(ValueError, match=r"does not match the configured graph "
                                         r"\(visual_extractor_args="):
        TTask(load_config(tmp_path / "bad.yaml"), "cpu").build_model()


@pytest.fixture(scope="module")
def vit_tiny(tmp_path_factory):
    """A random timm-layout ``vit_tiny_patch16_384`` checkpoint."""
    path = tmp_path_factory.mktemp("vit_tiny") / "vit.bin"
    torch.save(_timm_state_dict(VIT_VARIANTS["vit_tiny_patch16_384"], seed=5), path)
    return path


def test_inference_cli_on_a_raw_image_matches_jax(corpus, vit_tiny, tmp_path, monkeypatch):
    from mm_s2ut import inference as j_inference
    from mm_s2ut.inference import load_image_features as j_features
    from mm_s2ut_torch import inference as t_inference

    jcfg = JModel(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
                  encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                  decoder_layers=1, decoder_attention_heads=2, conv_channels=16, vocab_size=1004,
                  dtype="float32",
                  multimodal=JMM(image_feat_dim=[192],
                                 multimodal_attention_type="selective_attention"))
    jmodel = JS2UT(jcfg)
    params = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.PRNGKey(6), np.zeros((1, 40, 80), np.float32), np.array([40], np.int32),
        np.zeros((1, 3), np.int32), (np.zeros((1, 577, 192), np.float32),),
        (np.zeros((1, 577), bool),)))
    params["params"]["decoder"]["final_norm"]["scale"] *= 4.0
    conf = JConfig(model=jcfg, generation=JGen(beam=2, max_len_a=0.0, max_len_b=8))
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    save_yaml(conf, model_dir / "config.yaml")
    np.savez(model_dir / "params.npz", **flatten_params(params["params"]))
    monkeypatch.setattr(j_inference, "load_checkpoint", lambda path: (conf, jmodel, params))
    image = corpus / "flickr30k-images" / "img1.jpg"
    args = ["--model_path", str(model_dir), "--audio_path", str(corpus / "2.wav"),
            "--image_path", str(image), "--vit_checkpoint", str(vit_tiny)]
    assert j_inference.main([*args, "--output_dir", str(tmp_path / "jax")]) == 0
    assert t_inference.main([*args, "--output_dir", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    got, want = ((tmp_path / d / "2.unit").read_text() for d in ("port", "jax"))
    assert got == want and got.strip()
    feats = t_inference.load_image_features(str(image), str(vit_tiny), 192)
    assert feats.shape == (1, 577, 192)
    np.testing.assert_allclose(feats, j_features(str(image), str(vit_tiny), 192), atol=1e-4)
    with pytest.raises(ValueError, match="raw image input requires --vit_checkpoint"):
        t_inference.load_image_features(str(image), None, 192)


@pytest.mark.parametrize("kind", ["vit_timm", "vit_openai"])
def test_extract_features_matches_jax_cli(corpus, vit_tiny, tmp_path, kind):
    """Three test2016 images at batch size 2 (the last batch padded)."""
    from mm_s2ut.cli import extract_features as j_cli
    from mm_s2ut_torch.cli import extract_features as t_cli

    if kind == "vit_timm":
        ckpt = vit_tiny
    else:
        ckpt = tmp_path / "clip"
        ckpt.mkdir()
        from mm_s2ut_torch.models.vit import CLIPVisionConfig

        torch.save(_clip_state_dict(CLIPVisionConfig(image_size=48, embed_dim=64, depth=2,
                                                     num_heads=2), seed=6),
                   ckpt / "pytorch_model.bin")
        (ckpt / "config.json").write_text(json.dumps({"vision_config": {
            "image_size": 48, "patch_size": 16, "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": 256}}))
    args = ["--flickr30k-root", str(corpus), "--splits", "test2016", "--model",
            "vit_tiny_patch16_384", "--extractor-type", kind, "--checkpoint", str(ckpt),
            "--batch-size", "2"]
    assert j_cli.main([*args, "--output-dir", str(tmp_path / "jax")]) == 0
    assert t_cli.main([*args, "--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got, want = (np.load(tmp_path / d / "test2016.npy") for d in ("port", "jax"))
    assert got.shape == want.shape == ((3, 577, 192) if kind == "vit_timm" else (3, 10, 64))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_vit_rollout_matches_jax_cli(corpus, vit_tiny, tmp_path):
    from mm_s2ut.cli import vit_rollout as j_cli
    from mm_s2ut_torch.cli import vit_rollout as t_cli

    args = ["--image", str(corpus / "flickr30k-images" / "img2.jpg"), "--model",
            "vit_tiny_patch16_384", "--checkpoint", str(vit_tiny), "--head-fusion", "mean"]
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    assert j_cli.main([*args, "--output", str(tmp_path / "jax" / "mask")]) == 0
    assert t_cli.main([*args, "--output", str(tmp_path / "port" / "mask"),
                       "--device", "cpu"]) == 0
    got, want = (np.load(tmp_path / d / "mask.npy") for d in ("port", "jax"))
    assert got.shape == want.shape == (24, 24)
    np.testing.assert_allclose(got, want, atol=1e-4)
    gpng, wpng = (np.asarray(Image.open(tmp_path / d / "mask.png")) for d in ("port", "jax"))
    assert gpng.shape == wpng.shape == (60, 45, 3)
    assert np.abs(gpng.astype(int) - wpng).max() <= 1
