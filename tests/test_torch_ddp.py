"""Data parallelism of the port (``parallel/mesh.py`` and the trainer)
with two gloo processes on the CPU, against one process over the whole
batch:

* two train steps of a small fp32 flagship (64-d, 2 + 2 layers, fusion)
  with every dropout 0.1 (hash, attention and Bernoulli sites, fusion and
  modality dropout too) equal the single-process full-batch run within
  1e-6: losses, gradient norms and every statistic relative, and each
  parameter within 1e-6 after the steps (all but the k-projection biases,
  whose gradient is only rounding: see ``_assert_params``), the
  processes' parameters equal bit for bit; with
  the dropouts at 0, both equal JAX's ``Trainer`` at ``mesh.data=1``
  within a relative 1e-4 (losses 1e-5);
* a ragged 3-row batch (2 + 1 rows) and a 1-row batch (the second process
  has none and joins the sums with zeros) give the same equality;
* ``cli.train`` under two processes started as ``torchrun`` starts them
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): rank 0
  writes the checkpoint and the metrics, rank 1 writes nothing, and the
  parameters equal a one-process run's;
* one process with ``mesh.model=2`` or ``mesh.pipe=2`` raises
  ``ValueError``, as JAX's ``make_mesh`` does on one device (tensor and
  pipeline parallelism themselves are ``test_torch_tp.py``'s and
  ``test_torch_pipeline*.py``'s); ``mesh.data`` other than -1 or the
  world size raises.

Each multi-process run has its own timeout (120 s at most), so a hung
rendezvous fails its test instead of the suite. ``shard_rows`` and
``shard_batch`` are checked directly too.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mm_s2ut_torch.parallel.mesh import shard_batch, shard_rows

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(rate: float):
    from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig, TrainConfig

    mm = MultimodalConfig(image_feat_dim=[48], multimodal_attention_type="selective_attention",
                          modality_dropout=0.5 if rate else 0.0, audio_dropout=0.5,
                          SA_image_dropout=rate, SA_attention_dropout=rate)
    model = ModelConfig(encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=2,
                        encoder_attention_heads=4, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
                        decoder_layers=2, decoder_attention_heads=4, conv_channels=32,
                        vocab_size=60, dtype="float32", dropout=rate, attention_dropout=rate,
                        activation_dropout=rate, multimodal=mm)
    return Config(model=model, train=TrainConfig(lr=1e-3, warmup_updates=1, seed=7))


def _batches(rows):
    """Host batches of ``rows`` each, padded to one shape per batch."""
    out = []
    for i, n in enumerate(rows):
        rng = np.random.RandomState(10 + i)
        T, TT, TI = 64, 9, 12
        target = rng.randint(4, 60, (n, TT)).astype(np.int32)
        target[n - 1, 6:] = 1
        masks = np.zeros((n, TI), bool)
        masks[n - 1, TI - 3:] = True
        out.append({"src_features": rng.randn(n, T, 80).astype(np.float32),
                    "src_lengths": np.array([T - 7 * j for j in range(n)], np.int32),
                    "prev_output_tokens": rng.randint(4, 60, (n, TT)).astype(np.int32),
                    "target": target, "imgs_list": (rng.randn(n, TI, 48).astype(np.float32),),
                    "img_masks_list": (masks,)})
    return out


def _model(cfg):
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel, init_parameters_

    return init_parameters_(MMS2UTModel(cfg.model).float(), torch.Generator().manual_seed(3))


def _run(cfg, batches, parallel=None, params=None):
    """Steps of a Trainer on the CPU: (metrics per step, flax-layout params)."""
    from mm_s2ut_torch.convert import from_flax, to_flax
    from mm_s2ut_torch.train.trainer import Trainer

    model = _model(cfg)
    if params is not None:
        model.load_state_dict(from_flax(params, model))
    trainer = Trainer(cfg, model, "cpu", parallel=parallel)
    metrics = [trainer.train_batch(b) for b in batches]
    return metrics, to_flax(trainer.model)


def _worker(rank: int, world: int, port: int, rate: float, rows: str, out: str) -> None:
    """One process of a data-parallel run (started by ``_spawn``)."""
    from datetime import timedelta

    from mm_s2ut_torch.parallel.mesh import DataParallel

    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         rank=rank, world_size=world,
                                         timeout=timedelta(seconds=60))
    try:
        metrics, params = _run(_config(rate), _batches(json.loads(rows)),
                               DataParallel(rank, world))
        np.savez(out, metrics=json.dumps(metrics), **params)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(rate, rows, tmp_path, world=2):
    """``_worker`` in ``world`` processes; rank r's results in out{r}.npz."""
    port = _free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import test_torch_ddp as t; "
            "t._worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), "
            "float(sys.argv[4]), sys.argv[5], sys.argv[6])"
            ).format(str(ROOT / "tests"), str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(port),
                               str(rate), json.dumps(rows), str(tmp_path / f"out{r}.npz")],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = []
    for r in range(world):
        data = np.load(tmp_path / f"out{r}.npz")
        results.append((json.loads(str(data["metrics"])),
                        {k: data[k] for k in data.files if k != "metrics"}))
    return results


def _assert_params(got, want, atol=1e-6):
    """Every parameter within ``atol`` (they are O(0.1); Adam moves each by
    ~lr = 1e-3 a step, and the gradients' other summation order moves
    that by < 1e-6). The attention k-projection biases are left out: their
    gradient is 0 in exact arithmetic (a softmax ignores a shift shared by
    a row), so both runs hold only rounding there, which Adam turns into
    ±lr steps of either sign; the loss never sees them (the step-2 loss,
    after step 1's update, is held)."""
    assert set(got) == set(want)
    for k, w in want.items():
        if not k.endswith("k_proj/bias"):
            np.testing.assert_allclose(got[k], w, atol=atol, rtol=0, err_msg=k)


def _assert_same(got, want, rel=1e-6):
    """Metrics within a relative ``rel``; parameters by ``_assert_params``."""
    (gm, gp), (wm, wp) = got, want
    assert len(gm) == len(wm)
    for a, b in zip(gm, wm):
        assert set(a) == set(b)
        for k in b:
            assert abs(a[k] - b[k]) <= rel * max(abs(b[k]), 1e-6), (k, a[k], b[k])
    _assert_params(gp, wp)


@pytest.mark.parametrize("rate,rows", [(0.1, [4, 4]), (0.1, [3, 1]), (0.0, [3, 4])])
def test_two_processes_equal_one_over_the_whole_batch(rate, rows, tmp_path):
    results = _spawn(rate, rows, tmp_path)
    want = _run(_config(rate), _batches(rows))
    for got in results:
        _assert_same(got, want)
    for k, v in results[0][1].items():  # every process ends with the same parameters
        assert np.array_equal(v, results[1][1][k]), k


def test_dropout_draws_on_a_shard_equal_those_rows_of_the_batch():
    """Hash dropout keys on the global flat index and a Bernoulli or
    uniform draw is made for all rows and sliced; without the offset a
    shard would draw another mask."""
    from mm_s2ut_torch.ops.dropout import DropoutRng, hash_dropout

    x = torch.randn(3, 5, 8, generator=torch.Generator().manual_seed(0))
    full = hash_dropout(x, 1234, 0.3)
    torch.testing.assert_close(hash_dropout(x[1:], 1234, 0.3, row0=1), full[1:], rtol=0, atol=0)
    assert not torch.equal(hash_dropout(x[1:], 1234, 0.3), full[1:])
    whole, part = DropoutRng(5, "cpu"), DropoutRng(5, "cpu")
    part.shard(1, 3)
    want = whole.uniform((3, 4), whole.bernoulli)
    torch.testing.assert_close(part.uniform((2, 4), part.bernoulli), want[1:], rtol=0, atol=0)
    assert whole.state_dict()["bernoulli"].equal(part.state_dict()["bernoulli"])


def test_data_parallel_equals_jax_trainer(tmp_path):
    """Dropouts at 0: the two processes' steps against JAX's Trainer at
    ``mesh.data=1`` from the same parameters."""
    import jax

    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import MeshConfig as JMesh
    from mm_s2ut.config import ModelConfig as JModelCfg
    from mm_s2ut.config import MultimodalConfig as JMM
    from mm_s2ut.config import TrainConfig as JTrain
    from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
    from mm_s2ut.train.trainer import Trainer as JTrainer
    from mm_s2ut_torch.config import to_dict

    cfg = _config(0.0)
    rows = [3, 4]
    batches = _batches(rows)
    d = to_dict(cfg.model)
    d["multimodal"] = JMM(**d["multimodal"])
    d.pop("multitask")
    jmodel_cfg = JModelCfg(**d)
    jcfg = JConfig(model=jmodel_cfg, train=JTrain(lr=1e-3, warmup_updates=1, seed=7),
                   mesh=JMesh(data=1))
    jmodel = JModel(jmodel_cfg)
    b = batches[0]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(4), b["src_features"], b["src_lengths"], b["prev_output_tokens"],
        b["imgs_list"], b["img_masks_list"]))
    jtrainer = JTrainer(jcfg, jmodel, params)
    want = [jax.device_get(jtrainer.train_batch(x)) for x in batches]

    # The two processes start from JAX's parameters, saved for them.
    np.savez(tmp_path / "init.npz", **_flat(params["params"]))
    port = _free_port()
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import test_torch_ddp as t; "
            "t._jax_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])"
            ).format(str(ROOT / "tests"), str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               str(tmp_path / "init.npz"), str(tmp_path / f"j{r}.json")],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = json.loads((tmp_path / "j0.json").read_text())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=1e-5)
        np.testing.assert_allclose(g["nll_loss"], float(w["nll_loss"]), rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], float(w["grad_norm"]), rtol=1e-4)
        assert g["ntokens"] == float(w["ntokens"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _jax_worker(rank: int, port: int, init: str, out: str) -> None:
    from datetime import timedelta

    from mm_s2ut_torch.convert import unflatten
    from mm_s2ut_torch.parallel.mesh import DataParallel

    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         rank=rank, world_size=2, timeout=timedelta(seconds=60))
    try:
        data = np.load(init)
        metrics, _ = _run(_config(0.0), _batches([3, 4]), DataParallel(rank, 2),
                          params=unflatten({k: data[k] for k in data.files}))
        Path(out).write_text(json.dumps(metrics))
    finally:
        torch.distributed.destroy_process_group()


def test_train_cli_under_two_processes_writes_on_rank_0_only(tmp_path):
    """``cli.train`` in two processes with torchrun's variables, each given
    its own ``save_dir``: rank 0's holds the checkpoint and metrics, rank
    1's is never made, and the parameters equal a one-process run's."""
    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import DataConfig as JData
    from mm_s2ut.config import MeshConfig as JMesh
    from mm_s2ut.config import ModelConfig as JModelCfg
    from mm_s2ut.config import MultimodalConfig as JMM
    from mm_s2ut.config import TrainConfig as JTrain
    from mm_s2ut.config import save_yaml
    from mm_s2ut.data.audio_io import write_wav
    from mm_s2ut.data.manifest import ManifestRow, write_manifest
    from mm_s2ut_torch.convert import load_npz
    from mm_s2ut_torch.cli import train as train_cli
    from mm_s2ut_torch.convert import flatten

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
                        dtype="float32",
                        multimodal=JMM(image_feat_path=[str(tmp_path / "img")],
                                       image_feat_dim=[16],
                                       multimodal_attention_type="selective_attention")),
        data=JData(data_root=str(tmp_path), audio_root=str(tmp_path), target_code_size=50,
                   max_tokens=2000, num_buckets=1),
        train=JTrain(lr=1e-3, warmup_updates=1, seed=3, max_update=2, save_interval_updates=2,
                     log_interval=1),
        mesh=JMesh(data=-1))
    save_yaml(cfg, tmp_path / "run.yaml")
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mm_s2ut_torch.cli.train", "--config",
             str(tmp_path / "run.yaml"), "--device", "cpu", f"train.save_dir={tmp_path / f'r{r}'}"],
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
    assert train_cli.main(["--config", str(tmp_path / "run.yaml"), "--device", "cpu",
                           f"train.save_dir={tmp_path / 'one'}"]) == 0
    _assert_params(flatten(load_npz(tmp_path / "r0" / "params.npz")),
                   flatten(load_npz(tmp_path / "one" / "params.npz")))


def test_mesh_axes_the_port_lacks_raise(tmp_path):
    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import save_yaml
    from mm_s2ut_torch.cli import train as train_cli

    save_yaml(JConfig(), tmp_path / "run.yaml")
    base = ["--config", str(tmp_path / "run.yaml"), "--device", "cpu"]
    with pytest.raises(ValueError, match=r"1 devices not divisible by model=2"):
        train_cli.main([*base, "mesh.model=2"])
    with pytest.raises(ValueError, match=r"1 devices not divisible by model=1 x pipe=2"):
        train_cli.main([*base, "mesh.pipe=2"])
    with pytest.raises(ValueError, match="must be -1 or the world size 1"):
        train_cli.main([*base, "mesh.data=2"])


def test_shard_rows_and_shard_batch():
    assert [shard_rows(3, r, 2) for r in range(2)] == [(0, 2), (2, 3)]
    assert [shard_rows(1, r, 2) for r in range(2)] == [(0, 1), (1, 1)]
    assert [shard_rows(8, r, 4) for r in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    b = _batches([3])[0]
    b["ntokens"] = np.float32(17)
    part = shard_batch(b, 1, 2)
    assert part["src_features"].shape[0] == 1 and part["imgs_list"][0].shape[0] == 1
    np.testing.assert_array_equal(part["target"], b["target"][2:])
    assert part["ntokens"] == 17
    t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
    assert shard_batch(t, 0, 2)["src_lengths"].tolist() == b["src_lengths"][:2].tolist()
