"""Pipeline parallelism of the port (``parallel/pipeline.py``, the
pipelined speech encoder, the trainer and the checkpoints) on the CPU,
against the JAX package's ``parallel/pipeline.py`` (run on the 8 host
devices ``conftest.py`` makes) and against one plain process:

* ``gpipe`` on JAX's ``_toy_layer``: the forward and the gradients equal
  JAX's ``gpipe`` at pipe 4, at uneven (S, M) = (2, 6), with remat, and
  over gloo at data 2 × pipe 2 (``DistributedTransport``), each within
  1e-6 (forward) and 1e-6 of each gradient tensor's largest (terms of up
  to ~20 summed in another order than XLA's); the loopback forward equals a
  sequential run over the same microbatches bit for bit;
* ``stack_layer_params`` / ``unstack_layer_params`` equal JAX's;
* the pipelined encoder at pipe 2 (and with a causal window: the port's
  causal layers against JAX's folded dense bias) equals JAX's pipelined
  encoder on the same ``pipe_stack`` parameters within 1e-5 in fp32, and,
  with every dropout 0.1, the port's sequential encoder: the forward bit
  for bit, the gradients within 1e-5, the seed generator where the
  sequential run leaves it;
* ``cli.train`` under torchrun's variables with ``mesh.pipe=2`` and
  ``train.eval_inference``: the validation's MCD metrics equal a
  one-process plain run's, and the stacked ``params.npz`` it writes
  decodes through ``cli.generate`` to the same tokens as its unstacked
  copy;
* the errors JAX raises: L % S, B % M, a mesh that does not divide, the
  per-layer states, and no pipe group.

The pipelined flagship's train steps are ``test_torch_pipeline_train.py``
(two files, so that ``--dist loadfile`` spreads them).

Each multi-process run has its own deadline (gloo's timeout 60 s, a join
timeout of 120 s), so a hang fails its test instead of the suite.
"""
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn: str, args_per_rank, world: int, module: str = "test_torch_pipeline") -> None:
    """``<module>.<fn>(*argv)`` of a test file in ``world`` processes."""
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import {} as t; "
            "t.{}(*sys.argv[1:])").format(str(ROOT / "tests"), str(ROOT), module, fn)
    procs = [subprocess.Popen([sys.executable, "-c", code, *map(str, args_per_rank(r))],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def _init_gloo(rank: int, world: int, port: int) -> None:
    from datetime import timedelta

    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         rank=rank, world_size=world,
                                         timeout=timedelta(seconds=60))


# ------------------------------------------------------------------ gpipe (toy)

def _toy_torch(params):
    """JAX's ``_toy_setup`` stacked parameters as one ParameterDict per layer."""
    return [nn.ParameterDict({k: nn.Parameter(torch.tensor(np.asarray(v)[i]))
                              for k, v in params.items()}) for i in range(params["w"].shape[0])]


def _toy_fn(layer, idx, x, e, row):
    """JAX's ``_toy_layer`` in torch."""
    return torch.tanh(x @ layer["w"] + layer["b"]) + x * e["scale"][:, None]


def _toy_port(params, x, extras, n_stages, n_micro, remat=False):
    from mm_s2ut_torch.parallel.pipeline import Loopback, gpipe

    layers = _toy_torch(params)
    xt = torch.tensor(np.asarray(x))
    et = {k: torch.tensor(np.asarray(v)) for k, v in extras.items()}
    y = gpipe(_toy_fn, layers, xt, et, n_stages=n_stages, n_micro=n_micro,
              transport=Loopback(n_stages), remat=remat)
    y.square().sum().backward()
    grads = {k: np.stack([layer[k].grad.numpy() for layer in layers]) for k in params}
    return y.detach().numpy(), grads, (layers, xt, et)


def _toy_jax(params, x, extras, data, pipe, n_stages, n_micro, remat=False):
    import jax
    import jax.numpy as jnp
    from test_pipeline import _toy_layer

    from mm_s2ut.parallel import gpipe, make_mesh

    def loss(p):
        y = gpipe(_toy_layer, p, x, extras, n_stages=n_stages, n_micro=n_micro, remat=remat)
        return jnp.sum(y ** 2), y

    with jax.set_mesh(make_mesh(data=data, pipe=pipe)):
        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("L,B,data,pipe,n_micro,remat", [
    (8, 8, 2, 4, 4, False),   # JAX's test_gpipe_forward/grads_match_sequential
    (8, 12, 4, 2, 6, False),  # uneven: 2 stages x 4 layers, 6 microbatches of 2
    (8, 8, 2, 4, 4, True),    # remat
])
def test_gpipe_matches_jax(L, B, data, pipe, n_micro, remat):
    from test_pipeline import _toy_setup

    params, x, extras = _toy_setup(L=L, B=B)
    want_y, want_g = _toy_jax(params, x, extras, data, pipe, pipe, n_micro, remat)
    y, grads, (layers, xt, et) = _toy_port(params, x, extras, pipe, n_micro, remat)
    np.testing.assert_allclose(y, want_y, atol=1e-6, rtol=0)
    for k in want_g:
        np.testing.assert_allclose(grads[k], want_g[k], atol=1e-6 * np.abs(want_g[k]).max(),
                                   rtol=0, err_msg=k)
    # The forward is a sequential run over the same microbatches, bit for bit.
    with torch.no_grad():
        seq = []
        for rows in torch.arange(B).tensor_split(n_micro):
            h = xt[rows]
            for i, layer in enumerate(layers):
                h = _toy_fn(layer, i, h, {"scale": et["scale"][rows]}, 0)
            seq.append(h)
    assert np.array_equal(torch.cat(seq).numpy(), y)
    if remat:
        _, plain, _ = _toy_port(params, x, extras, pipe, n_micro)
        for k in plain:
            np.testing.assert_allclose(grads[k], plain[k], atol=1e-6, rtol=0, err_msg=k)


def _toy_worker(rank, world, port, out) -> None:
    """One process of a data 2 × pipe 2 toy run over gloo."""
    from test_pipeline import _toy_setup

    from mm_s2ut_torch.parallel.mesh import DataParallel, process_groups
    from mm_s2ut_torch.parallel.pipeline import DistributedTransport, gpipe

    rank, world, port = int(rank), int(world), int(port)
    _init_gloo(rank, world, port)
    try:
        grid = DataParallel(rank, world, model=1, pipe=2)
        dp, pp, _ = process_groups(grid)
        transport = DistributedTransport(pp, grid.pipe_ranks(), grid.pp_rank, torch.device("cpu"))
        params, x, extras = _toy_setup(L=8, B=8)
        layers = _toy_torch(params)
        for i in range(8):
            if i // 4 != grid.pp_rank:
                layers[i] = None
        rows = slice(4 * grid.dp_rank, 4 * grid.dp_rank + 4)
        xt = torch.tensor(np.asarray(x)[rows])
        et = {"scale": torch.tensor(np.asarray(extras["scale"])[rows])}
        y = gpipe(_toy_fn, layers, xt, et, n_stages=2, n_micro=4, transport=transport, rows=8)
        y.square().sum().backward()
        grads = {}
        for i, layer in enumerate(layers):
            if layer is not None:
                for k, p in layer.items():
                    torch.distributed.all_reduce(p.grad, group=dp)
                    grads[f"{k}{i}"] = p.grad.numpy()
        np.savez(out, y=y.detach().numpy(), **grads)
    finally:
        torch.distributed.destroy_process_group()


def test_gpipe_dp_pp_over_gloo(tmp_path):
    """Data 2 × pipe 2 over gloo: each data rank pipelines its rows, the
    output reaches both pipe ranks, and the gradients summed over the data
    ranks equal JAX's with the batch sharded over ``data``."""
    from test_pipeline import _toy_setup

    params, x, extras = _toy_setup(L=8, B=8)
    want_y, want_g = _toy_jax(params, x, extras, 2, 2, 2, 4)
    port = _free_port()
    _spawn("_toy_worker", lambda r: [r, 4, port, tmp_path / f"toy{r}.npz"], 4)
    for r in range(4):
        z = np.load(tmp_path / f"toy{r}.npz")
        d, p = r // 2, r % 2
        np.testing.assert_allclose(z["y"], want_y[4 * d:4 * d + 4], atol=1e-6, rtol=0)
        for i in range(4 * p, 4 * p + 4):
            for k in ("w", "b"):
                np.testing.assert_allclose(z[f"{k}{i}"], want_g[k][i], rtol=0,
                                           atol=1e-6 * np.abs(want_g[k]).max())


def test_stack_unstack_match_jax():
    import jax
    import jax.numpy as jnp

    from mm_s2ut.parallel import stack_layer_params as jstack
    from mm_s2ut.parallel import unstack_layer_params as junstack
    from mm_s2ut_torch.parallel.pipeline import stack_layer_params, unstack_layer_params

    rng = np.random.RandomState(1)
    layers = {f"layer{i}": {"w": rng.randn(3, 3).astype(np.float32),
                            "ln": {"scale": rng.randn(3).astype(np.float32)}} for i in range(4)}
    layers["subsampler"] = {"k": np.zeros((2,), np.float32)}  # ignored
    want = jax.tree_util.tree_map(np.asarray, jstack(jax.tree_util.tree_map(jnp.asarray, layers)))
    got = stack_layer_params(layers)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a, b)
    back, jback = unstack_layer_params(got), junstack(want)
    assert set(back) == set(jback) == {f"layer{i}" for i in range(4)}
    for k in back:
        assert np.array_equal(back[k]["w"], np.asarray(jback[k]["w"]))
        assert np.array_equal(back[k]["ln"]["scale"], layers[k]["ln"]["scale"])
    for bad in ({"layer0": layers["layer0"], "layer2": layers["layer2"]}, {"x": 1}):
        with pytest.raises(ValueError, match="non-contiguous or missing"):
            stack_layer_params(bad)


# ------------------------------------------------------------ the encoder

ENC = dict(embed_dim=32, ffn_dim=64, num_layers=4, num_heads=4, conv_channels=16)


def _port_encoder(pp, rate=0.0, causal=False, window=0, micro=0):
    from mm_s2ut_torch.models.s2t_encoder import SpeechTransformerEncoder
    from mm_s2ut_torch.parallel.pipeline import Loopback, pipe_model_

    enc = SpeechTransformerEncoder(**ENC, dropout=rate, attention_dropout=rate,
                                   activation_dropout=rate, causal_attention=causal,
                                   attention_window=window, pipeline_stages=pp,
                                   pipeline_microbatches=micro)
    return pipe_model_(enc, Loopback(pp)) if pp > 1 else enc


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 6)])
def test_pipelined_encoder_matches_jax(causal, window):
    """JAX's pipelined encoder (data 4 × pipe 2) and the port's over the
    loopback from the same stacked parameters, fp32. Causal, JAX's
    pipelined stack folds the mask into a dense bias, the port's layers
    run kernel G: the two agree on every row with a key in its window. A
    padding row with none (i ≥ length + W − 1) follows a convention: the
    port's is kernel G's, so every row is also held to JAX's sequential
    kernel path (``use_flash``, Pallas G in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from mm_s2ut.models.s2t_encoder import SpeechTransformerEncoder as JEncoder
    from mm_s2ut.parallel import make_mesh
    from mm_s2ut_torch.convert import from_flax

    rng = np.random.RandomState(2)
    feats = rng.randn(4, 64, 80).astype(np.float32)
    lengths = np.array([64, 50, 40, 33], np.int32)
    jenc = JEncoder(**ENC, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                    use_flash=False, pipeline_stages=2, causal_attention=causal,
                    attention_window=window, dtype=jnp.float32)
    with jax.set_mesh(make_mesh(data=4, pipe=2)):
        params = jenc.init(jax.random.PRNGKey(0), feats, lengths)
        want = jax.jit(lambda v, f, n: jenc.apply(v, f, n)["encoder_out"])(params, feats, lengths)
    params = jax.tree_util.tree_map(np.asarray, params)
    assert params["params"]["pipe_stack"]["layers"]["ffn"]["fc1"][
        "kernel"].shape[0] == 4
    enc = _port_encoder(2, causal=causal, window=window).eval()
    enc.load_state_dict(from_flax(params, enc))
    with torch.no_grad():
        got = enc(torch.tensor(feats), torch.tensor(lengths))["encoder_out"].numpy()
    if not causal:
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
        return
    from mm_s2ut_torch.parallel.pipeline import sequential_params

    n = ((lengths - 1) // 2) // 2 + 1  # the frames after the subsampler's two stride-2 convs
    has_key = np.arange(got.shape[1])[None] < n[:, None] + window - 1
    assert not has_key.all()
    np.testing.assert_allclose(got[has_key], np.asarray(want)[has_key], atol=1e-5, rtol=0)
    jflash = JEncoder(**ENC, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                      use_flash=True, causal_attention=True, attention_window=window,
                      dtype=jnp.float32)
    kernel = jflash.apply({"params": sequential_params(params["params"])}, feats, lengths)
    np.testing.assert_allclose(got, np.asarray(kernel["encoder_out"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal,micro,remat", [(False, 2, False), (False, 4, True),
                                                (True, 2, False)])
def test_pipelined_encoder_equals_sequential_with_dropout(causal, micro, remat):
    """Dropout 0.1 in training: the pipelined encoder over the loopback
    against the port's sequential one from the same parameters and seed:
    the output bit for bit (each layer the same call on a microbatch, its
    seeds replayed and its rows global), the gradients within 1e-5, the
    seed generator left where the sequential run leaves it."""
    from mm_s2ut_torch.convert import from_flax, to_flax, unflatten
    from mm_s2ut_torch.models.mm_s2ut import init_parameters_
    from mm_s2ut_torch.ops.dropout import DropoutRng
    from mm_s2ut_torch.parallel.pipeline import sequential_params

    window = 5 if causal else 0
    pp = _port_encoder(2, 0.1, causal, window, micro)
    pp.pipe_stack.remat = remat
    init_parameters_(pp, torch.Generator().manual_seed(5))
    seq = _port_encoder(0, 0.1, causal, window)
    seq.load_state_dict(from_flax(sequential_params(unflatten(to_flax(pp))), seq))
    rng = np.random.RandomState(3)
    feats = torch.tensor(rng.randn(4, 40, 80).astype(np.float32))
    lengths = torch.tensor([40, 33, 25, 18])
    runs = []
    for enc in (seq, pp):
        enc.train()
        dr = DropoutRng(11, "cpu")
        dr.shard(2, 8)  # this process's rows start at row 2 of 8 (a data-parallel shard)
        for mod in enc.modules():
            if hasattr(mod, "rng"):
                mod.rng = dr
        f = feats.clone().requires_grad_(True)
        y = enc(f, lengths)["encoder_out"]
        (y.square().sum() + y[:, 0].sum()).backward()
        grads = {re.sub(r"^pipe_stack\.layers\.(\d+)", r"layer\1", n): p.grad
                 for n, p in enc.named_parameters()}
        runs.append((y.detach(), f.grad, grads, dr.seeds.get_state(), dr.row0))
    (y0, g0, p0, s0, r0), (y1, g1, p1, s1, r1) = runs
    assert torch.equal(y1, y0)
    assert torch.equal(s1, s0) and r1 == r0 == 2
    torch.testing.assert_close(g1, g0, rtol=0, atol=1e-5)
    assert set(p1) == set(p0)
    for k, g in p0.items():
        torch.testing.assert_close(p1[k], g, rtol=0, atol=1e-5 * max(1.0, g.abs().max().item()),
                                   msg=k)


# ------------------------------------------------------------ the flagship

def _flagship(rate, stages=0, micro=0, model_axis=1, lr=1e-4):
    from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig, TrainConfig

    mm = MultimodalConfig(image_feat_dim=[48], multimodal_attention_type="selective_attention",
                          modality_dropout=0.5 if rate else 0.0, audio_dropout=0.5,
                          SA_image_dropout=rate, SA_attention_dropout=rate)
    model = ModelConfig(encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=4,
                        encoder_attention_heads=4, decoder_embed_dim=64,
                        decoder_ffn_embed_dim=128, decoder_layers=2,
                        decoder_attention_heads=4, conv_channels=32, vocab_size=60,
                        dtype="float32", dropout=rate, attention_dropout=rate,
                        activation_dropout=rate, multimodal=mm, pipeline_stages=stages,
                        pipeline_microbatches=micro)
    return Config(model=model, train=TrainConfig(lr=lr, warmup_updates=1, seed=7))


def test_pipelined_train_cli_checkpoint_decodes_through_generate(tmp_path):
    """``cli.train`` in two processes with torchrun's variables,
    ``mesh.pipe=2 model.pipeline_stages=2``, with ``train.eval_inference``:
    validation decodes and vocodes the gathered weights in a sequential
    twin, its MCD metrics equal to a one-process plain run's; rank 0
    writes a stacked ``params.npz``, and ``cli.generate`` decodes it to the
    tokens of its unstacked copy under a sequential config."""
    import csv
    import json

    from test_hifigan import SMALL, _torch_generator

    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import DataConfig as JData
    from mm_s2ut.config import MeshConfig as JMesh
    from mm_s2ut.config import ModelConfig as JModelCfg
    from mm_s2ut.config import MultimodalConfig as JMM
    from mm_s2ut.config import TrainConfig as JTrain
    from mm_s2ut.config import save_yaml
    from mm_s2ut.data.audio_io import write_wav
    from mm_s2ut.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.cli import generate
    from mm_s2ut_torch.cli import train as train_cli
    from mm_s2ut_torch.config import load_config
    from mm_s2ut_torch.config import save_yaml as save_port_yaml
    from mm_s2ut_torch.convert import flatten, load_npz
    from mm_s2ut_torch.parallel.pipeline import sequential_params

    rng = np.random.RandomState(0)
    (tmp_path / "img").mkdir()
    for split in ("train", "valid"):
        np.save(tmp_path / "img" / f"{split}.npy", rng.randn(4, 6, 16).astype(np.float32))
    rows = []
    for i in range(4):
        n = 4000 + 1500 * (i % 3)
        write_wav(tmp_path / f"{i + 1}.wav", (0.3 * rng.randn(n)).astype(np.float32), 16000)
        units = " ".join(str(u) for u in rng.randint(0, 50, 6 + i % 3))
        rows.append(ManifestRow(str(i), f"{i + 1}.wav", n, units, 6 + i % 3))
    write_manifest(tmp_path / "train.tsv", rows)
    write_manifest(tmp_path / "valid.tsv", rows)
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
        model=JModelCfg(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
                        encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                        decoder_layers=1, decoder_attention_heads=2, conv_channels=16,
                        dtype="float32",
                        multimodal=JMM(image_feat_path=[str(tmp_path / "img")],
                                       image_feat_dim=[16],
                                       multimodal_attention_type="selective_attention")),
        data=JData(data_root=str(tmp_path), audio_root=str(tmp_path), target_code_size=50,
                   max_tokens=40000, num_buckets=1),
        train=JTrain(lr=1e-3, warmup_updates=1, seed=3, max_update=2, save_interval_updates=2,
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
             str(tmp_path / "run.yaml"), "--device", "cpu", f"train.save_dir={tmp_path / 'pp'}",
             "mesh.pipe=2", "model.pipeline_stages=2", "model.pipeline_microbatches=2"],
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

    got, want = valid(tmp_path / "pp"), valid(tmp_path / "one")
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("mcd_loss", "pred_ratio", "ins_rate", "del_rate", "accuracy", "ntokens"):
            assert g[k] == w[k], (k, g, w)
        for k in ("loss", "nll_loss"):
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (k, g, w)
    params = load_npz(tmp_path / "pp" / "params.npz")
    assert params["encoder"]["pipe_stack"]["layers"]["ffn"]["fc1"][
        "kernel"].shape == (2, 32, 64)
    seq_dir = tmp_path / "seq"
    seq_dir.mkdir()
    np.savez(seq_dir / "params.npz", **flatten(sequential_params(params)))
    seq_cfg = load_config(tmp_path / "pp" / "config.yaml")
    assert seq_cfg.model.pipeline_stages == 2 and seq_cfg.mesh.pipe == 2
    seq_cfg.model.pipeline_stages = 0
    save_port_yaml(seq_cfg, seq_dir / "config.yaml")
    outs = []
    for d in ("pp", "seq"):
        args = ["--model_path", str(tmp_path / d), "--gen-subset", "train", "--results-path",
                str(tmp_path / f"gen_{d}"), "--beam", "2", "--max-len-b", "6", "--device", "cpu"]
        assert generate.main(args) == 0
        outs.append((tmp_path / f"gen_{d}" / "generate-train.txt").read_text())
    assert outs[0] == outs[1] and "D-" in outs[0]


# ------------------------------------------------------------------ errors

def test_pipeline_errors_raise_where_jax_raises(tmp_path):
    import test_torch_tp as tp

    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import save_yaml
    from mm_s2ut_torch.cli import train as train_cli
    from mm_s2ut_torch.config import MeshConfig
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.parallel.mesh import check_mesh
    from mm_s2ut_torch.parallel.pipeline import Loopback, gpipe, pipe_model_
    from mm_s2ut_torch.train.trainer import Trainer

    layers = [nn.Identity() for _ in range(6)]
    x = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="6 layers not divisible by 4 stages"):
        gpipe(lambda l, i, h, e, r: h, layers, x, n_stages=4, n_micro=2, transport=Loopback(4))
    with pytest.raises(ValueError, match="batch 8 not divisible by 3 microbatches"):
        gpipe(lambda l, i, h, e, r: h, layers, x, n_stages=2, n_micro=3, transport=Loopback(2))
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
        gpipe(lambda l, i, h, e, r: h, layers, x[:3], n_stages=2, n_micro=4,
              transport=Loopback(2), rows=6)  # a data rank's 3 of 6 rows
    assert check_mesh(MeshConfig(pipe=2, model=2), 8) == (2, 2)
    with pytest.raises(ValueError, match="6 devices not divisible by model=2 x pipe=2"):
        check_mesh(MeshConfig(pipe=2, model=2), 6)
    save_yaml(JConfig(), tmp_path / "run.yaml")
    with pytest.raises(ValueError, match="1 devices not divisible by model=1 x pipe=2"):
        train_cli.main(["--config", str(tmp_path / "run.yaml"), "--device", "cpu", "mesh.pipe=2"])

    cfg = _flagship(0.0, stages=2)
    with pytest.raises(ValueError, match="needs a pipe group of 2 ranks"):
        Trainer(cfg, MMS2UTModel(cfg.model), "cpu")
    b = tp._batches("flagship", [2])[0]
    feats, lengths, prev = (torch.tensor(b[k]) for k in ("src_features", "src_lengths",
                                                         "prev_output_tokens"))
    imgs, masks = [torch.tensor(b["imgs_list"][0])], [torch.tensor(b["img_masks_list"][0])]
    with pytest.raises(ValueError, match="needs a pipe group of 2 ranks"):
        MMS2UTModel(cfg.model).eval()(feats, lengths, prev, imgs, masks)
    towers = _flagship(0.0, stages=2)
    towers.model.multimodal.multimodal_attention_type = "external_multimodal_transformer"
    model = pipe_model_(MMS2UTModel(towers.model).eval(), Loopback(2))
    with pytest.raises(ValueError, match="cannot run pipelined"):
        model(feats, lengths, prev, imgs, masks)
    with pytest.raises(ValueError, match="over a pipe group of 4 ranks"):
        pipe_model_(MMS2UTModel(cfg.model), Loopback(4))
