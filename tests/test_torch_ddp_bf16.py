"""bf16 data parallelism against one process, in the port and in JAX.

The flagship's widths at reduced depth (:func:`_config`: 512-d, FFN 2048,
8 heads, 1024 conv channels, selective fusion over 768-d image features,
2 encoder + 1 decoder layers, every dropout 0.1, modality and audio dropout
0.5, label smoothing 0.2) in bf16 take three Adam steps on one fixed batch
(phase 11's batch cut to 4 rows × 160 frames × 20 targets × 49 image
tokens):

* the port: ``train/trainer.py`` under bf16 autocast in two gloo processes
  at ``mesh.data`` = 2, against one process over the whole batch;
* JAX: its own bf16 ``Trainer`` at ``mesh.data`` = 2 (two of the eight host
  devices ``tests/conftest.py`` makes), against ``mesh.data`` = 1.

Each package's gap is the change of the parameters over the three steps
against the one-process run's change, ‖Δ₂ − Δ₁‖ / ‖Δ₁‖ in L2 (phase 20d's
measure, ``tools/pipe_step.update_error``), and the relative difference of
the step-3 loss. Both are bf16 rounding: XLA all-reduces the shards'
weight gradients in f32, as the port's flat all-reduce does. The port is
measured twice, each process on ``THREADS`` threads:

* with PyTorch's CPU matmuls through oneDNN (the default), whose bf16
  products round a row by the call's row count and thread count, so a
  half batch already differs from the whole one in the forward;
* with oneDNN off, where a row's product is the same in any batch, as in
  XLA's CPU dots, so that only the order of the sums remains.

Each time the parameter change is held within ``FACTOR`` of JAX's gap and
the step-3 loss within ``LOSS_TOL`` (both packages), the limits a bf16
data-parallel run is held to. ``python tests/test_torch_ddp_bf16.py``
prints every gap.
"""
import dataclasses
import functools
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
STEPS = 3
FACTOR = 3.0  # the port's parameter-change gap against JAX's
LOSS_TOL = 1e-4  # the step-3 loss, relative
THREADS = 2  # every process of the port, for the same oneDNN blocking in each run


def _config():
    from mm_s2ut_torch.config import Config, ModelConfig, MultimodalConfig

    mm = MultimodalConfig(image_feat_dim=[768], multimodal_attention_type="selective_attention",
                          use_selective_gate=True, modality_dropout=0.5, audio_dropout=0.5)
    model = ModelConfig(vocab_size=1004, dtype="bfloat16", encoder_layers=2, decoder_layers=1,
                        multimodal=mm)
    return Config(model=model, train=dataclasses.replace(
        Config().train, update_freq=1, warmup_updates=10, label_smoothing=0.2, seed=7))


def _batch():
    """Phase 11's batch (``tools/pipe_step.train_batch``) cut to size."""
    from mm_s2ut_torch.tools.pipe_step import train_batch

    return train_batch(4, 160, 20, img_tokens=49, seed=25)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v, np.float32)})
    return out


def _port_run(params, onednn: bool, parallel=None):
    """Three steps of the port's Trainer on the CPU from flax-layout
    ``params``: (losses, the parameters after, flattened)."""
    from mm_s2ut_torch.convert import from_flax, to_flax
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.train.trainer import Trainer

    cfg = _config()
    model = MMS2UTModel(cfg.model)
    model.load_state_dict(from_flax(params, model))
    trainer = Trainer(cfg, model, "cpu", parallel=parallel)
    batch = _batch()
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)  # oneDNN's rounding of a row depends on it too
    try:
        with torch.backends.mkldnn.flags(enabled=onednn):
            losses = [trainer.train_batch(batch)["loss"] for _ in range(STEPS)]
    finally:
        torch.set_num_threads(threads)
    return losses, {k: np.asarray(v, np.float32) for k, v in to_flax(trainer.model).items()}


def _worker(rank: int, port: int, onednn: int, init: str, out: str) -> None:
    """One of the two gloo processes (started by :func:`port_gap`)."""
    from datetime import timedelta

    from mm_s2ut_torch.convert import unflatten
    from mm_s2ut_torch.parallel.mesh import DataParallel

    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         rank=rank, world_size=2, timeout=timedelta(seconds=60))
    try:
        data = np.load(init)
        losses, params = _port_run(unflatten({k: data[k] for k in data.files}), bool(onednn),
                                   DataParallel(rank, 2))
        np.savez(out, losses=np.asarray(losses), **params)
    finally:
        torch.distributed.destroy_process_group()


def _gap(losses, after, want_losses, want_after, start):
    """(the parameter change's gap in L2, the step-3 loss's relative gap)."""
    from mm_s2ut_torch.tools.pipe_step import update_error

    got = {k: after[k] - start[k] for k in start}
    want = {k: want_after[k] - start[k] for k in start}
    return (update_error(got, want),
            abs(losses[-1] - want_losses[-1]) / abs(want_losses[-1]))


@functools.lru_cache(maxsize=1)
def jax_gap():
    """JAX's bf16 Trainer at ``mesh.data`` 2 against 1: (the gaps, the
    flax parameters both started from)."""
    import jax

    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import MeshConfig as JMesh
    from mm_s2ut.config import ModelConfig as JModelCfg
    from mm_s2ut.config import MultimodalConfig as JMM
    from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
    from mm_s2ut.train.trainer import Trainer as JTrainer
    from mm_s2ut_torch.config import to_dict

    cfg = _config()
    d = to_dict(cfg.model)
    d["multimodal"] = JMM(**d["multimodal"])
    d.pop("multitask")
    jmodel_cfg = JModelCfg(**d)
    jmodel = JModel(jmodel_cfg)
    b = _batch()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(4), b["src_features"], b["src_lengths"], b["prev_output_tokens"],
        b["imgs_list"], b["img_masks_list"]))
    runs = []
    for data in (1, 2):
        jtrain = type(JConfig().train)(**dataclasses.asdict(cfg.train))
        trainer = JTrainer(JConfig(model=jmodel_cfg, train=jtrain, mesh=JMesh(data=data)),
                           jmodel, params)
        losses = [float(jax.device_get(trainer.train_batch(b))["loss"]) for _ in range(STEPS)]
        runs.append((losses, _flat(jax.device_get(trainer.state.params)["params"])))
    return _gap(*runs[1], *runs[0], _flat(params["params"])), params["params"]


def port_gap(params, onednn: bool, tmp_path):
    """The port's two gloo processes against one process, both from the
    flax ``params``: the gaps."""
    start = _flat(params)
    np.savez(tmp_path / "init.npz", **start)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import test_torch_ddp_bf16 as t; "
            "t._worker(*map(int, sys.argv[1:4]), sys.argv[4], sys.argv[5])"
            ).format(str(ROOT / "tests"), str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(int(onednn)),
                               str(tmp_path / "init.npz"), str(tmp_path / f"out{r}.npz")],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        want_losses, want_after = _port_run(params, onednn)
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = np.load(tmp_path / "out0.npz")
    after = {k: got[k] for k in got.files if k != "losses"}
    return _gap(list(got["losses"]), after, want_losses, want_after, start)


@pytest.mark.parametrize("onednn", [False, True])
def test_bf16_data_parallel_gap_within_a_factor_of_jax(onednn, tmp_path):
    (j_upd, j_loss), params = jax_gap()
    p_upd, p_loss = port_gap(params, onednn, tmp_path)
    print(json.dumps({"onednn": onednn, "jax": {"update": j_upd, "loss": j_loss},
                      "port": {"update": p_upd, "loss": p_loss}}))
    assert j_upd > 0 and p_upd > 0  # both runs really part by rounding
    assert p_upd <= FACTOR * j_upd, (p_upd, j_upd)
    assert max(p_loss, j_loss) <= LOSS_TOL, (p_loss, j_loss)


if __name__ == "__main__":
    import tempfile

    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import conftest  # noqa: F401  (eight host devices, the CPU platform)

    for onednn in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            test_bf16_data_parallel_gap_within_a_factor_of_jax(onednn, Path(tmp))
