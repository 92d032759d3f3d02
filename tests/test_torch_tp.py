"""Tensor and sequence parallelism of the port (``parallel/tensor.py``,
``parallel/mesh.py`` and the trainer) with gloo processes on the CPU,
against one plain process over the whole batch:

* ``mesh.model`` = 2 and 4 (and data 2 × model 2), the small fp32
  flagship (64-d, 2 + 2 layers, selective fusion), a small XM model, one
  with timm's ViT or CLIP in its graph and one with multimodal attention,
  every dropout 0.1, ``model.sequence_parallel`` on and off: two Adam
  steps equal the plain run's within 1e-6 (losses, gradient norms and
  every statistic relative; the parameters, gathered, absolute, as
  ``test_torch_ddp.py`` holds data parallelism), each rank holds 1/model
  of every parameter ``_TP_RULES`` matches (by shape), the ranks' whole
  parameters agree bit for bit, and rank 0's ``params.npz`` (gathered)
  loads into a plain model and equals the plain run's; every rank
  restores it into its shards again;
* the TP forward's logits equal JAX's replicated forward within 1e-4;
* a matched dimension that does not divide by ``mesh.model`` raises
  ``ValueError`` naming the parameter;
* the plain ``attention_keep`` with (h_total, h0) and hash dropout with a
  column or sequence block equal that slice of the whole mask.

Each multi-process run has its own timeout (120 s at most), so a hung
rendezvous fails its test instead of the suite.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(kind: str, rate: float, sp: bool):
    from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig, TrainConfig

    if kind in ("vit_timm", "vit_openai", "mma"):
        mm = MultimodalConfig(
            image_feat_dim=[32], SA_image_dropout=rate, SA_attention_dropout=rate,
            multimodal_attention_type="multimodal_attention" if kind == "mma"
            else "selective_attention",
            **(dict(load_visual_extractor_type=kind, image_input_size=32,
                    visual_extractor_args={"embed_dim": 32, "depth": 2, "num_heads": 2,
                                           "patch_size": 16}) if kind != "mma" else {}))
        model = ModelConfig(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
                            encoder_attention_heads=2, decoder_embed_dim=32,
                            decoder_ffn_embed_dim=64, decoder_layers=2,
                            decoder_attention_heads=2, conv_channels=16, vocab_size=60,
                            dtype="float32", dropout=rate, attention_dropout=rate,
                            activation_dropout=rate, multimodal=mm, sequence_parallel=sp)
    elif kind == "xm":
        mm = MultimodalConfig(image_feat_dim=[16], multimodal_attention_type="selective_attention",
                              SA_image_dropout=rate, SA_attention_dropout=rate)
        model = ModelConfig(decoder_embed_dim=32, decoder_ffn_embed_dim=64, decoder_layers=2,
                            decoder_attention_heads=4, encoder_embed_dim=32,
                            encoder_ffn_embed_dim=64, encoder_layers=2,
                            encoder_attention_heads=4, conv_channels=16, vocab_size=40,
                            dtype="float32", dropout=rate, attention_dropout=rate,
                            activation_dropout=rate, multimodal=mm, sequence_parallel=sp)
    else:
        mm = MultimodalConfig(image_feat_dim=[48],
                              multimodal_attention_type="selective_attention",
                              modality_dropout=0.5 if rate else 0.0, audio_dropout=0.5,
                              SA_image_dropout=rate, SA_attention_dropout=rate)
        model = ModelConfig(encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=2,
                            encoder_attention_heads=4, decoder_embed_dim=64,
                            decoder_ffn_embed_dim=128, decoder_layers=2,
                            decoder_attention_heads=4, conv_channels=32, vocab_size=60,
                            dtype="float32", dropout=rate, attention_dropout=rate,
                            activation_dropout=rate, multimodal=mm, sequence_parallel=sp)
    return Config(model=model, train=TrainConfig(lr=LR, warmup_updates=1, seed=7))


# Adam moves an element by lr·g/(|g| + eps): an fp32 rounding δg of a
# gradient g of a few eps (the tensor-parallel sums round otherwise than
# one process's matmuls, ~1e-7 of a tensor's largest gradient) moves it by
# up to lr·eps·δg/g². At test_torch_ddp.py's lr 1e-3 that passes 1e-6 on
# elements whose g is far above eps too (a CLIP k_proj element: 1.3e-6);
# at 1e-4, only on elements of g < 10·eps, which the steps test leaves
# out by the plain run's gradients (``_assert_params``).
LR = 1e-4


W2V = dict(conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=48,
           num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _batches(kind: str, rows):
    """Host batches of ``rows`` each, padded to one shape per batch (odd T,
    so a sequence shard is ragged)."""
    out = []
    for i, n in enumerate(rows):
        rng = np.random.RandomState(10 + i)
        TT, TI, D, V = {"flagship": (9, 12, 48, 60), "xm": (5, 6, 16, 40),
                        "mma": (9, 12, 32, 60), "vit_timm": (9, 32, 32, 60),
                        "vit_openai": (9, 32, 32, 60)}[kind]
        target = rng.randint(4, V, (n, TT)).astype(np.int32)
        target[n - 1, TT - 3:] = 1
        masks = np.zeros((n, TI), bool)
        masks[n - 1, TI - 3:] = True
        if kind != "xm":
            T = 62
            feats = rng.randn(n, T, 80).astype(np.float32)
            lengths = np.array([T - 7 * j for j in range(n)], np.int32)
        else:
            S = 2400
            feats = (0.3 * rng.randn(n, S)).astype(np.float32)
            lengths = np.array([S - 330 * j for j in range(n)], np.int32)
            for j in range(n):
                feats[j, lengths[j]:] = 0.0
        imgs = (rng.randn(n, TI, TI, 3) if kind.startswith("vit") else rng.randn(n, TI, D))
        if kind.startswith("vit"):
            masks[:] = False
        out.append({"src_features": feats, "src_lengths": lengths,
                    "prev_output_tokens": rng.randint(4, V, (n, TT)).astype(np.int32),
                    "target": target, "imgs_list": (imgs.astype(np.float32),),
                    "img_masks_list": (masks,)})
    return out


def _model(kind: str, cfg):
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel, init_parameters_

    if kind == "xm":
        from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel
        from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config

        w2v = Wav2Vec2Config(**W2V, hidden_dropout=cfg.model.dropout,
                             attention_dropout=cfg.model.attention_dropout)
        model = MMXMTransformerModel(cfg.model, w2v_cfg=w2v)
    else:
        from mm_s2ut_torch.models import build_model_from_config

        model = build_model_from_config(cfg)  # with the visual extractor its config names
    return init_parameters_(model.float(), torch.Generator().manual_seed(3))


def _run(kind, cfg, batches, parallel=None, params=None, save_dir=None):
    """Steps of a Trainer on the CPU: (metrics per step, the whole
    parameters in flax's layout, this rank's leaf shapes)."""
    from mm_s2ut_torch.convert import from_flax, to_flax
    from mm_s2ut_torch.parallel.tensor import gather_param
    from mm_s2ut_torch.train.trainer import Trainer

    model = _model(kind, cfg)
    if params is not None:
        model.load_state_dict(from_flax(params, model))
    if save_dir is not None:
        cfg.train.save_dir = save_dir
    trainer = Trainer(cfg, model, "cpu", parallel=parallel)
    grads, step = {}, trainer.optimizer.step
    names = [n.replace(".", "/") for n, _ in trainer.model.named_parameters()]

    def keep_grads(gs, norm=None, frozen=()):  # the first step's, whole
        if not grads:
            for n, g, p in zip(names, gs, trainer.params):
                grads[n] = (g if trainer.tp is None else gather_param(g, p, trainer.tp)).numpy()
        return step(gs, norm, frozen=frozen)

    trainer.optimizer.step = keep_grads
    metrics = [trainer.train_batch(b) for b in batches]
    shapes = {k: list(v.shape) for k, v in to_flax(trainer.model).items()}
    full = trainer.full_params()
    if save_dir is not None:
        trainer.save_checkpoint()
        if parallel is not None:
            torch.distributed.barrier()
        again = Trainer(cfg, _model(kind, cfg), "cpu", parallel=parallel)
        assert again.restore_checkpoint() == len(batches)
        for k, v in to_flax(trainer.model).items():
            assert np.array_equal(to_flax(again.model)[k], v), k
        for a, b in zip(again.optimizer.mu, trainer.optimizer.mu):
            assert torch.equal(a, b)
    return metrics, full, shapes, grads


def _worker(rank, world, model, port, kind, rate, sp, rows, out, save_dir) -> None:
    """One process of a tensor-parallel run (started by ``_spawn``)."""
    from datetime import timedelta

    from mm_s2ut_torch.parallel.mesh import DataParallel

    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         rank=rank, world_size=world,
                                         timeout=timedelta(seconds=60))
    try:
        metrics, full, shapes, grads = _run(kind, _config(kind, rate, sp), _batches(kind, rows),
                                            DataParallel(rank, world, model), save_dir=save_dir)
        np.savez(out, metrics=json.dumps(metrics), shapes=json.dumps(shapes), **full,
                 **{"grad:" + k: v for k, v in grads.items()})
    finally:
        torch.distributed.destroy_process_group()


def _spawn(code, args_per_rank, world):
    procs = [subprocess.Popen([sys.executable, "-c", code, *args_per_rank(r)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def _spawn_train(kind, rate, sp, rows, data, model, tmp_path):
    world = data * model
    port = _free_port()
    code = ("import sys, json; sys.path[:0] = [{!r}, {!r}]; import test_torch_tp as t; "
            "a = sys.argv[1:]; t._worker(int(a[0]), int(a[1]), int(a[2]), int(a[3]), a[4], "
            "float(a[5]), a[6] == '1', json.loads(a[7]), a[8], a[9])"
            ).format(str(ROOT / "tests"), str(ROOT))
    _spawn(code, lambda r: [str(r), str(world), str(model), str(port), kind, str(rate),
                            "1" if sp else "0", json.dumps(rows), str(tmp_path / f"out{r}.npz"),
                            str(tmp_path / "ckpt")], world)
    results = []
    for r in range(world):
        z = np.load(tmp_path / f"out{r}.npz")
        results.append((json.loads(str(z["metrics"])), json.loads(str(z["shapes"])),
                        {k: z[k] for k in z.files if "/" in k and not k.startswith("grad:")},
                        {k[5:]: z[k] for k in z.files if k.startswith("grad:")}))
    return results


def _assert_grads(got, want, rel=1e-5):
    """The first step's gradients (summed, whole), each within ``rel`` of
    its tensor's largest (fp32 sums of a few hundred terms in another
    order); the k-projection biases, whose gradient is 0 in exact
    arithmetic, within ``rel`` of the largest gradient of all."""
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if k.endswith("k_proj/bias"):
            np.testing.assert_allclose(got[k], w, atol=rel * top, rtol=0, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], w, atol=rel * max(np.abs(w).max(), 1e-6), rtol=0,
                                   err_msg=k)


LAYOUT_LEAVES = ("kernel", "scale", "embedding")  # flax leaves a torch "weight" holds


def _assert_params(got, want, atol=1e-6, grads=None):
    """As ``test_torch_ddp._assert_params``: every parameter within
    ``atol`` but the attention k-projection biases, whose gradient is 0 in
    exact arithmetic (a softmax ignores a shift shared by a row), so both
    runs hold only rounding there, which Adam turns into ±lr steps (and
    the middle third of timm's fused ``qkv/bias``, its k bias). With
    ``grads`` (the plain run's first-step gradients, torch names), also
    leave out the elements whose gradient is below 10·eps, at most 1% of
    all: there Adam's step lr·g/(|g| + eps) turns the fp32 rounding δg of
    a sum (~1e-7 of a tensor's largest gradient: ``_assert_grads``) into
    up to lr·eps·δg/g² (an encoder fc2 element of the flagship moved
    2.7e-6; a CLIP patch-embedding element of g = 2.2e-8, δg = 4.4e-9,
    moved 5e-6). A gradient of exactly 0 (a frozen block) moves nothing
    and is held.
    Above 10·eps the bound is lr·δg·1e6 < 1e-6 at lr 1e-4."""
    assert set(got) == set(want)
    left_out = total = 0
    for k, w in want.items():
        if k.endswith("k_proj/bias"):
            continue
        keep = np.ones(w.shape, bool)
        if k.endswith("qkv/bias"):  # timm's fused projection: its middle third is the k bias
            keep[w.shape[0] // 3: 2 * w.shape[0] // 3] = False
        if grads is not None:
            path, leaf = k.rsplit("/", 1)
            g = np.abs(grads[f"{path}/{'weight' if leaf in LAYOUT_LEAVES else leaf}"])
            if leaf == "kernel":  # the torch layout → flax's (convert.py)
                g = g.transpose(*{2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[g.ndim])
            keep &= (g >= 10 * 1e-8) | (g == 0)  # a gradient of 0 (a frozen block) moves nothing
        left_out += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(got[k][keep], w[keep], atol=atol, rtol=0, err_msg=k)
    assert left_out <= 0.01 * max(total, 1), (left_out, total)


CASES = [  # (kind, data, model, sequence_parallel)
    ("flagship", 1, 2, False), ("flagship", 1, 2, True), ("flagship", 1, 4, False),
    ("flagship", 1, 4, True), ("flagship", 2, 2, False), ("flagship", 2, 2, True),
    ("xm", 1, 2, False), ("xm", 1, 4, False),
    # timm's ViT in the graph (its fc1/fc2 cut, called as modules; qkv/proj whole),
    # CLIP's (q/k/v/out_proj too), multimodal attention (one head: its projections gather)
    ("vit_timm", 1, 2, False), ("vit_openai", 1, 2, False), ("mma", 1, 2, True),
]


@pytest.mark.parametrize("kind,data,model,sp", CASES)
def test_tensor_parallel_steps_equal_one_plain_process(kind, data, model, sp, tmp_path):
    from mm_s2ut_torch.convert import flatten, load_npz
    from mm_s2ut_torch.parallel.mesh import tp_axis

    rows = [4, 3]
    results = _spawn_train(kind, 0.1, sp, rows, data, model, tmp_path)
    want_metrics, want, _, want_grads = _run(kind, _config(kind, 0.1, sp), _batches(kind, rows))
    for metrics, shapes, full, grads in results:
        _assert_grads(grads, want_grads)
        assert len(metrics) == len(want_metrics)
        for a, b in zip(metrics, want_metrics):
            assert set(a) == set(b)
            for k in b:
                assert abs(a[k] - b[k]) <= 1e-6 * max(abs(b[k]), 1e-6), (k, a[k], b[k])
        _assert_params(full, want, grads=want_grads)
        cut = 0
        for k, shape in shapes.items():
            axis = tp_axis(k)
            expect = list(want[k].shape)
            if axis is not None:
                expect[axis] //= model
                cut += 1
            assert shape == expect, (k, shape, expect)
        assert cut >= 8 * 2  # q/k/v kernel and bias, out_proj, fc1 kernel and bias, fc2
    if kind.startswith("vit"):
        assert any("visual_extractor" in k and k.endswith("fc1/kernel") for k in want)
    for k, v in results[0][2].items():  # every rank ends with the same whole parameters
        for other in results[1:]:
            assert np.array_equal(v, other[2][k]), k
    saved = flatten(load_npz(tmp_path / "ckpt" / "params.npz"))
    for k, v in results[0][2].items():
        assert np.array_equal(saved[k], v), k
    from mm_s2ut_torch.convert import from_flax, unflatten

    plain = _model(kind, _config(kind, 0.1, sp))
    plain.load_state_dict(from_flax(unflatten(saved), plain))  # a plain model takes it


def _logits_worker(rank, world, port, init, out) -> None:
    from datetime import timedelta

    from mm_s2ut_torch.convert import from_flax, shard_state_dict, unflatten
    from mm_s2ut_torch.parallel.mesh import DataParallel
    from mm_s2ut_torch.train.trainer import Trainer, to_device

    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         rank=rank, world_size=world,
                                         timeout=timedelta(seconds=60))
    try:
        cfg = _config("flagship", 0.0, True)
        data = np.load(init)
        full = {k: data[k] for k in data.files}
        trainer = Trainer(cfg, _model("flagship", cfg), "cpu",
                          parallel=DataParallel(rank, world, world))
        trainer.model.load_state_dict(from_flax(
            unflatten(shard_state_dict(full, rank, world)), trainer.model))
        trainer.model.eval()
        with torch.no_grad():
            logits = trainer._outputs(to_device(_batches("flagship", [3])[0], "cpu"))["logits"]
        np.save(out, logits.numpy())
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("model", [2, 4])
def test_tensor_parallel_logits_equal_jax(model, tmp_path):
    """The TP forward (sequence parallelism on) of parameters JAX made
    against JAX's replicated forward."""
    import jax

    from mm_s2ut.config import ModelConfig as JModelCfg
    from mm_s2ut.config import MultimodalConfig as JMM
    from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
    from mm_s2ut_torch.config import to_dict

    cfg = _config("flagship", 0.0, True)
    d = to_dict(cfg.model)
    d["multimodal"] = JMM(**d["multimodal"])
    d.pop("multitask")
    d["sequence_parallel"] = False
    jmodel = JModel(JModelCfg(**d))
    b = _batches("flagship", [3])[0]
    args = (b["src_features"], b["src_lengths"], b["prev_output_tokens"], b["imgs_list"],
            b["img_masks_list"])
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(4), *args))
    want = np.asarray(jmodel.apply(params, *args)["logits"])
    from mm_s2ut_torch.convert import flatten

    np.savez(tmp_path / "init.npz", **flatten(params["params"]))
    port = _free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import test_torch_tp as t; "
            "t._logits_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), "
            "sys.argv[4], sys.argv[5])").format(str(ROOT / "tests"), str(ROOT))
    _spawn(code, lambda r: [str(r), str(model), str(port), str(tmp_path / "init.npz"),
                            str(tmp_path / f"logits{r}.npy")], model)
    for r in range(model):
        np.testing.assert_allclose(np.load(tmp_path / f"logits{r}.npy"), want, atol=1e-4,
                                   rtol=1e-4)


def test_a_split_that_does_not_divide_raises():
    from mm_s2ut_torch.config import ModelConfig, MultimodalConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.parallel.tensor import TensorParallel, shard_model_

    model = MMS2UTModel(ModelConfig(
        encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=1,
        encoder_attention_heads=8, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
        decoder_layers=1, decoder_attention_heads=8, conv_channels=32, vocab_size=1004,
        multimodal=MultimodalConfig(image_feat_dim=[48])))
    with pytest.raises(ValueError, match=r"embed_tokens/embedding: .*1004.* mesh\.model=8"):
        shard_model_(model, TensorParallel(None, 0, 8))
    model = MMS2UTModel(ModelConfig(
        encoder_embed_dim=64, encoder_ffn_embed_dim=100, encoder_layers=1,
        encoder_attention_heads=4, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
        decoder_layers=1, decoder_attention_heads=4, conv_channels=32, vocab_size=1004,
        multimodal=MultimodalConfig(image_feat_dim=[48])))
    with pytest.raises(ValueError, match=r"encoder/layer0/ffn/fc1/kernel: .*100.* mesh\.model=8"):
        shard_model_(model, TensorParallel(None, 0, 8))


@pytest.mark.parametrize("h_total,model", [(8, 2), (12, 4), (16, 4)])
def test_head_and_column_masks_are_slices_of_the_whole(h_total, model):
    """The plain twins of what A, G, H and the FFN's dropout draw on one
    rank's slice: ``attention_keep`` over heads [h0, h0 + H) of h_total,
    from batch row 3, equals those heads of the whole layer's mask; hash
    dropout of a block of columns (or of T) equals that block of the
    whole activation's."""
    from mm_s2ut_torch.ops.attention import attention_keep, reference_attention
    from mm_s2ut_torch.ops.dropout import hash_dropout

    B, T, S, H = 2, 9, 11, h_total // model
    whole = attention_keep(B, h_total, T, S, 1234, 0.1, "cpu", row0=3)
    g = torch.Generator().manual_seed(h_total)
    q, k, v = (torch.randn(B, T if i == 0 else S, h_total, 16, generator=g) for i in range(3))
    want = reference_attention(q, k, v, None, dropout_rate=0.1, dropout_seed=99,
                               dropout_row0=3)
    for m in range(model):
        h0 = m * H
        part = attention_keep(B, H, T, S, 1234, 0.1, "cpu", row0=3, h_total=h_total, h0=h0)
        assert torch.equal(part, whole[:, h0:h0 + H])
        sl = slice(h0, h0 + H)
        got = reference_attention(q[:, :, sl], k[:, :, sl], v[:, :, sl], None, dropout_rate=0.1,
                                  dropout_seed=99, dropout_row0=3, h_total=h_total, h0=h0)
        torch.testing.assert_close(got, want[:, :, sl], rtol=0, atol=0)
    assert not torch.equal(attention_keep(B, H, T, S, 1234, 0.1, "cpu", row0=3),
                           whole[:, H:2 * H])
    x = torch.randn(3, 7, 4 * h_total, generator=g)
    full = hash_dropout(x, 77, 0.1, row0=2)
    F = x.shape[2] // model
    for m in range(model):
        cols = slice(m * F, (m + 1) * F)
        part = hash_dropout(x[:, :, cols], 77, 0.1, row0=2, at=((0, m * F), (7, x.shape[2])))
        assert torch.equal(part, full[:, :, cols])
        rows = slice(m * 2, m * 2 + 2)
        part = hash_dropout(x[:, rows], 77, 0.1, row0=2, at=((m * 2, 0), (7, x.shape[2])))
        assert torch.equal(part, full[:, rows])


@pytest.mark.parametrize("pretrained", [False, True])
def test_train_cli_tensor_parallel_under_torchrun(pretrained, tmp_path):
    """``cli.train`` in two processes with torchrun's variables and
    ``mesh.model=2 model.sequence_parallel=true``: rank 0 writes the whole
    checkpoint, rank 1 nothing, and the parameters equal a one-process
    run's; with ``--load-pretrained-encoder-from`` (a whole checkpoint, cut
    for each rank) too."""
    import os

    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import DataConfig as JData
    from mm_s2ut.config import MeshConfig as JMesh
    from mm_s2ut.config import ModelConfig as JModelCfg
    from mm_s2ut.config import MultimodalConfig as JMM
    from mm_s2ut.config import TrainConfig as JTrain
    from mm_s2ut.config import save_yaml
    from mm_s2ut.data.audio_io import write_wav
    from mm_s2ut.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.cli import train as train_cli
    from mm_s2ut_torch.convert import flatten, load_npz

    rng = np.random.RandomState(0)
    (tmp_path / "img").mkdir()
    np.save(tmp_path / "img" / "train.npy", rng.randn(5, 6, 16).astype(np.float32))
    rows = []
    for i in range(5):
        n = 4000 + 1500 * (i % 3)
        write_wav(tmp_path / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), 16000)
        units = " ".join(str(u) for u in rng.randint(0, 50, 6 + i % 3))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, units, 6 + i % 3))
    write_manifest(tmp_path / "train.tsv", rows)
    cfg = JConfig(
        model=JModelCfg(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
                        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                        decoder_layers=1, decoder_attention_heads=2, conv_channels=16,
                        dtype="float32", dropout=0.1, attention_dropout=0.1,
                        activation_dropout=0.1,
                        multimodal=JMM(image_feat_path=[str(tmp_path / "img")],
                                       image_feat_dim=[16],
                                       multimodal_attention_type="selective_attention")),
        data=JData(data_root=str(tmp_path), audio_root=str(tmp_path), target_code_size=50,
                   max_tokens=2000, num_buckets=1),
        train=JTrain(lr=LR, warmup_updates=1, seed=3, max_update=2, save_interval_updates=2,
                     log_interval=1),
        mesh=JMesh(data=-1))
    save_yaml(cfg, tmp_path / "run.yaml")
    extra = []
    if pretrained:  # another seed's encoder, whole
        assert train_cli.main(["--config", str(tmp_path / "run.yaml"), "--device", "cpu",
                               f"train.save_dir={tmp_path / 'pre'}", "train.seed=11"]) == 0
        extra = ["--load-pretrained-encoder-from", str(tmp_path / "pre")]
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mm_s2ut_torch.cli.train", "--config",
             str(tmp_path / "run.yaml"), "--device", "cpu", *extra, "mesh.model=2",
             "model.sequence_parallel=true", f"train.save_dir={tmp_path / f'r{r}'}"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for f in ("config.yaml", "params.npz", "optim.pt", "logs/metrics.csv"):
        assert (tmp_path / "r0" / f).exists(), f
    assert not (tmp_path / "r1").exists()
    assert train_cli.main(["--config", str(tmp_path / "run.yaml"), "--device", "cpu", *extra,
                           f"train.save_dir={tmp_path / 'one'}"]) == 0
    _assert_params(flatten(load_npz(tmp_path / "r0" / "params.npz")),
                   flatten(load_npz(tmp_path / "one" / "params.npz")))


def test_eval_inference_decodes_the_gathered_weights(tmp_path):
    """``cli.train`` with ``train.eval_inference`` under ``mesh.model=2``:
    validation decodes and vocodes from the weights gathered whole (kernels
    B-F see every head), and rank 0's MCD metrics equal a one-process
    run's."""
    import csv
    import json
    import os

    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import DataConfig as JData
    from mm_s2ut.config import MeshConfig as JMesh
    from mm_s2ut.config import ModelConfig as JModelCfg
    from mm_s2ut.config import MultimodalConfig as JMM
    from mm_s2ut.config import TrainConfig as JTrain
    from mm_s2ut.config import save_yaml
    from mm_s2ut.data.audio_io import write_wav
    from mm_s2ut.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.cli import train as train_cli

    sys.path.insert(0, str(ROOT / "tests"))
    from test_hifigan import SMALL, _torch_generator

    rng = np.random.RandomState(0)
    (tmp_path / "img").mkdir()
    for split in ("train", "valid"):
        np.save(tmp_path / "img" / f"{split}.npy", rng.randn(6, 6, 16).astype(np.float32))
    rows = []
    for i in range(6):
        n = 4000 + 2000 * (i % 3)
        write_wav(tmp_path / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), 16000)
        units = " ".join(str(u) for u in rng.randint(0, 50, 8 + i % 4))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, units, 8 + i % 4))
    write_manifest(tmp_path / "train.tsv", rows)
    write_manifest(tmp_path / "valid.tsv", rows[:4])
    torch.manual_seed(0)
    sd = dict(_torch_generator(SMALL).state_dict())
    sd["dict.weight"] = torch.randn(50, SMALL.embedding_dim)
    torch.save(sd, tmp_path / "vocoder.pt")
    vcfg = {k: getattr(SMALL, k) for k in ("embedding_dim", "model_in_dim",
                                           "upsample_initial_channel")}
    vcfg.update(num_embeddings=50, upsample_rates=list(SMALL.upsample_rates),
                upsample_kernel_sizes=list(SMALL.upsample_kernel_sizes),
                resblock_kernel_sizes=list(SMALL.resblock_kernel_sizes),
                resblock_dilation_sizes=[list(d) for d in SMALL.resblock_dilation_sizes],
                dur_prediction=False)
    (tmp_path / "vocoder.json").write_text(json.dumps(vcfg))
    cfg = JConfig(
        model=JModelCfg(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
                        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                        decoder_layers=1, decoder_attention_heads=2, conv_channels=16,
                        dtype="float32",
                        multimodal=JMM(image_feat_path=[str(tmp_path / "img")],
                                       image_feat_dim=[16],
                                       multimodal_attention_type="selective_attention")),
        data=JData(data_root=str(tmp_path), audio_root=str(tmp_path), target_code_size=50,
                   max_tokens=2000, num_buckets=1),
        train=JTrain(lr=LR, warmup_updates=1, seed=3, max_update=2, save_interval_updates=2,
                     log_interval=1, eval_inference=True,
                     eval_vocoder_path=str(tmp_path / "vocoder.pt"),
                     eval_vocoder_cfg=str(tmp_path / "vocoder.json")),
        mesh=JMesh(data=-1))
    cfg.generation.beam = 1
    cfg.generation.max_len_a = 0
    cfg.generation.max_len_b = 8
    save_yaml(cfg, tmp_path / "run.yaml")
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mm_s2ut_torch.cli.train", "--config",
             str(tmp_path / "run.yaml"), "--device", "cpu", "mesh.model=2",
             f"train.save_dir={tmp_path / f'r{r}'}"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert train_cli.main(["--config", str(tmp_path / "run.yaml"), "--device", "cpu",
                           f"train.save_dir={tmp_path / 'one'}"]) == 0

    def valid(d):
        with open(d / "logs" / "metrics.csv", newline="") as f:
            return [{k[6:]: float(v) for k, v in r.items() if k.startswith("valid/") and v}
                    for r in csv.DictReader(f) if r.get("valid/mcd_loss")]

    got, want = valid(tmp_path / "r0"), valid(tmp_path / "one")
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("mcd_loss", "pred_ratio", "ins_rate", "del_rate", "accuracy", "ntokens"):
            assert g[k] == w[k], (k, g, w)
        for k in ("loss", "nll_loss"):
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (k, g, w)
