"""The pipelined small flagship (``parallel/pipeline.py`` under the
trainer) on the CPU:

* its first pipelined loss (the loopback, 2 stages, 2 microbatches)
  equals JAX's pipelined train step at dropout 0 within 1e-5, and built
  from a seed it starts where the plain model starts;
* dp2×pp2, pp2×tp2 and pp4 runs over gloo, every dropout 0.1, two Adam
  steps, equal one plain process over the whole batch (statistics within
  a relative 1e-5, the gathered parameters within 1e-6, as
  ``test_torch_tp.py`` holds them), and each restores its checkpoint.

Helpers come from ``test_torch_pipeline.py``; each multi-process run has
its own deadline (gloo's timeout 60 s, a join timeout of 120 s).
"""
import json

import numpy as np
import pytest
import torch

from test_torch_pipeline import _flagship, _free_port, _init_gloo, _spawn

torch.set_num_threads(1)


def test_pipelined_flagship_first_loss_matches_jax():
    """Dropouts 0: the port's pipelined flagship (loopback, 2 stages, 2
    microbatches) gives JAX's pipelined train step's first loss (data 4 ×
    pipe 2) from the same parameters within 1e-5; the same run from the
    seed starts where the plain model starts."""
    import dataclasses

    import jax
    import test_torch_tp as tp

    from mm_s2ut.config import Config as JConfig
    from mm_s2ut.config import MeshConfig as JMesh
    from mm_s2ut.config import ModelConfig as JModelCfg
    from mm_s2ut.config import MultimodalConfig as JMM
    from mm_s2ut.config import TrainConfig as JTrain
    from mm_s2ut.models.mm_s2ut import MMS2UTModel as JModel
    from mm_s2ut.parallel import make_mesh
    from mm_s2ut.train.trainer import Trainer as JTrainer
    from mm_s2ut_torch.config import to_dict
    from mm_s2ut_torch.convert import flatten, from_flax, to_flax, unflatten
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel, init_parameters_
    from mm_s2ut_torch.parallel.pipeline import Loopback, pipe_model_, sequential_params
    from mm_s2ut_torch.train.criterion import CRITERIONS
    from mm_s2ut_torch.train.trainer import to_device

    cfg = _flagship(0.0, stages=2, micro=2)
    d = to_dict(cfg.model)
    d["multimodal"] = JMM(**d["multimodal"])
    d.pop("multitask")
    jmodel_cfg = JModelCfg(**d)
    jcfg = JConfig(model=jmodel_cfg, train=JTrain(lr=1e-4, warmup_updates=1, seed=7),
                   mesh=JMesh(data=1, pipe=2))
    jmodel = JModel(jmodel_cfg)
    batch = tp._batches("flagship", [4])[0]
    with jax.set_mesh(make_mesh(data=1, pipe=2)):
        params = jax.tree_util.tree_map(np.asarray, jmodel.init(
            jax.random.PRNGKey(4), batch["src_features"], batch["src_lengths"],
            batch["prev_output_tokens"], batch["imgs_list"], batch["img_masks_list"]))
    assert "pipe_stack" in params["params"]["encoder"]
    jtrainer = JTrainer(jcfg, jmodel, params)
    with jax.set_mesh(jtrainer.mesh):  # its shard_map reads the context mesh
        want = jax.device_get(jtrainer.train_batch(batch))

    model = pipe_model_(MMS2UTModel(cfg.model).float(), Loopback(2))
    model.load_state_dict(from_flax(params, model))
    model.train()
    b = to_device(batch, torch.device("cpu"))
    with torch.no_grad():
        out = model(b["src_features"], b["src_lengths"], b["prev_output_tokens"],
                    b["imgs_list"], b["img_masks_list"])
        _, metrics = CRITERIONS["speech_to_unit"](out, b, label_smoothing=0.2)
    np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll_loss"]), float(want["nll_loss"]), rtol=1e-5)
    assert float(metrics["ntokens"]) == float(want["ntokens"])

    plain_cfg = dataclasses.replace(cfg.model, pipeline_stages=0)
    plain = init_parameters_(MMS2UTModel(plain_cfg).float(), torch.Generator().manual_seed(3))
    piped = init_parameters_(MMS2UTModel(cfg.model).float(), torch.Generator().manual_seed(3))
    got = flatten(sequential_params(unflatten(to_flax(piped))))
    assert set(got) == set(to_flax(plain))
    for k, v in to_flax(plain).items():
        assert np.array_equal(got[k], v), k


def _train_worker(rank, world, port, data, pipe, model, micro, rows, out, save_dir) -> None:
    """One process of a pipelined flagship run over gloo (``test_torch_tp._run``:
    two steps, then save and restore the checkpoint)."""
    import test_torch_tp as tp

    from mm_s2ut_torch.parallel.mesh import DataParallel

    rank, world, port = int(rank), int(world), int(port)
    _init_gloo(rank, world, port)
    try:
        cfg = _flagship(0.1, stages=int(pipe), micro=int(micro))
        metrics, full, _, _ = tp._run("flagship", cfg, tp._batches("flagship", json.loads(rows)),
                                      DataParallel(rank, world, int(model), int(pipe)),
                                      save_dir=save_dir)
        np.savez(out, metrics=json.dumps(metrics), **full)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("data,pipe,model,micro,rows", [
    (2, 2, 1, 2, [4, 6]),  # each data rank cuts its 2 or 3 rows into 2 microbatches
    (1, 2, 2, 2, [4, 6]),
    (1, 4, 1, 4, [4, 8]),  # one layer per stage, three hops
])
def test_pipelined_steps_equal_one_plain_process(data, pipe, model, micro, rows, tmp_path):
    import test_torch_tp as tp

    from mm_s2ut_torch.convert import flatten, unflatten
    from mm_s2ut_torch.parallel.pipeline import sequential_params

    world = data * pipe * model
    port = _free_port()
    _spawn("_train_worker", lambda r: [r, world, port, data, pipe, model, micro, json.dumps(rows),
                                       tmp_path / f"out{r}.npz", tmp_path / "ckpt"], world,
           module="test_torch_pipeline_train")
    want_metrics, want, _, want_grads = tp._run("flagship", _flagship(0.1),
                                                tp._batches("flagship", rows))
    for r in range(world):
        z = np.load(tmp_path / f"out{r}.npz")
        metrics = json.loads(str(z["metrics"]))
        full = {k: z[k] for k in z.files if "/" in k}
        assert any("pipe_stack/layers/" in k for k in full)
        assert len(metrics) == len(want_metrics)
        for a, b in zip(metrics, want_metrics):
            assert set(a) == set(b)
            for k in b:
                assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1e-6), (r, k, a[k], b[k])
        tp._assert_params(flatten(sequential_params(unflatten(full))), want, grads=want_grads)
