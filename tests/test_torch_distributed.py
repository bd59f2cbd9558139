"""The port's data parallelism over a real ``torch.distributed`` group:
two spawned processes on the CPU (gloo), as ``tests/test_distributed.py``
runs JAX's over two processes.

  * ``maybe_distributed_init`` from the config's coordinator fields, and
    every collective of ``parallel.mesh.Comm`` (the FSDP moves among
    them) against what one process computes;
  * ``main`` started as two ranks by its own launcher (``spawn_ranks``,
    torchrun's environment) against ``main`` in one process on the same
    config, with and without FSDP: the checkpoint, the epoch's loss and
    the metrics of the DP eval.

This file imports no JAX: the spawned ranks import it.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import traceback

import pytest
import torch
import torch.distributed as dist

from layoutdit_tpu_torch.config import MeshConfig
from layoutdit_tpu_torch.main import main, spawn_ranks
from layoutdit_tpu_torch.models.weights_io import tree_leaves
from layoutdit_tpu_torch.parallel import mesh as pmesh
from layoutdit_tpu_torch.parallel import sharding as psharding
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train.checkpoint import load_checkpoint

# the two ranks' first moment (the gradient) against one process's on
# the global batch, relative Frobenius a leaf, float32
DP_RTOL = 1e-4


def _collectives(rank: int, port: int, out: str) -> None:
    """One rank: the group from the coordinator fields, then each
    collective; its results (or its traceback) to ``out``."""
    try:
        torch.set_num_threads(1)
        cfg = MeshConfig(enable_distributed_init=True, coordinator_address=f"127.0.0.1:{port}",
                         num_processes=2, process_id=rank, heartbeat_timeout_s=60,
                         shutdown_timeout_s=90)
        assert pmesh.maybe_distributed_init(cfg, device="cpu")
        assert not pmesh.maybe_distributed_init(cfg, device="cpu")  # already up
        comm = pmesh.Comm()
        res = {"world": comm.world, "rank": comm.rank, "backend": comm.backend,
               "lead": pmesh.is_lead_host()}
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
        res["sum"] = comm.all_reduce_(x.clone()).tolist()
        res["bcast"] = comm.broadcast_(x.clone(), src=1).tolist()
        res["gather1"] = comm.all_gather(x, 1).tolist()
        res["gather_bf16"] = comm.all_gather(x.bfloat16() / 3, 0).float().tolist()
        res["scatter1"] = comm.reduce_scatter(torch.ones(2, 4) * (rank + 1), 1).tolist()
        res["objects"] = comm.all_gather_object({"r": rank})
        res["object"] = comm.broadcast_object("lead" if rank == 0 else None)
        res["any"] = [comm.any(rank == 1), comm.any(False)]
        mesh = pmesh.build_mesh_for_batch(MeshConfig(fsdp=True), 8)
        res["mesh"] = [mesh.degree, mesh.rank, mesh.fsdp, mesh.rows(8).tolist()]
        layout = psharding.FsdpLayout([(64, 256), (3,)], mesh)  # 2**14: sharded
        full = [torch.arange(64 * 256, dtype=torch.float32).reshape(64, 256), torch.ones(3)]
        shards = layout.shard(full)
        res["dims"] = layout.dims
        res["roundtrip"] = all(torch.equal(a, b) for a, b in zip(layout.gather(shards), full))
        grads = layout.reduce_grads([t * (rank + 1) for t in full])
        res["grad_shard"] = [list(grads[0].shape), float(grads[0].sum()), grads[1].tolist()]
        res["norm"] = float(layout.global_norm(grads))
        res["everywhere"] = bool(layout.everywhere(torch.tensor(rank == 0)))
        dist.destroy_process_group()
    except BaseException:  # reported to the test
        res = {"error": traceback.format_exc()}
    with open(out, "w") as f:
        json.dump(res, f)


def test_gloo_group_and_collectives(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    port = pmesh.free_port()
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=_collectives, args=(r, port, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    res = []
    for out in outs:
        with open(out) as f:
            res.append(json.load(f))
    for r, got in enumerate(res):
        assert "error" not in got, got.get("error")
        assert (got["world"], got["rank"], got["backend"], got["lead"]) == (2, r, "gloo", r == 0)
        assert got["sum"] == [[10.0, 12.0, 14.0], [16.0, 18.0, 20.0]]
        assert got["bcast"] == [[10.0, 11.0, 12.0], [13.0, 14.0, 15.0]]
        assert got["gather1"] == [[0.0, 1.0, 2.0, 10.0, 11.0, 12.0],
                                  [3.0, 4.0, 5.0, 13.0, 14.0, 15.0]]
        want_bf16 = torch.cat([(torch.arange(6.0).reshape(2, 3) + 10 * k).bfloat16() / 3
                               for k in range(2)]).float().tolist()
        assert got["gather_bf16"] == want_bf16
        assert got["scatter1"] == [[3.0, 3.0], [3.0, 3.0]]
        assert got["objects"] == [{"r": 0}, {"r": 1}] and got["object"] == "lead"
        assert got["any"] == [True, False]
        assert got["mesh"] == [2, r, True, [4 * r, 4 * r + 1, 4 * r + 2, 4 * r + 3]]
        assert got["dims"] == [1, None] and got["roundtrip"]
        # the shard of the sum (x1 + x2 = 3 x) of the full tensor's columns
        full = torch.arange(64 * 256, dtype=torch.float64).reshape(64, 256) * 3
        assert got["grad_shard"][0] == [64, 128]
        assert got["grad_shard"][1] == pytest.approx(float(full[:, 128 * r:128 * (r + 1)].sum()))
        assert got["grad_shard"][2] == [3.0, 3.0, 3.0]
        want_norm = float(torch.sqrt((full ** 2).sum() + 3 * 9.0))
        assert got["norm"] == pytest.approx(want_norm, rel=1e-6)
        assert got["everywhere"] is False


@pytest.fixture(scope="module")
def fixture_cfg(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_main"))
    make_fixture(root, n_images=4, split="samples", seed=2, image_size=64)
    path = write_fixture_config(root, epochs=1, batch_size=4, tiny_model=True)
    with open(path) as f:
        return root, json.load(f)


def _run_main(tmp_path, raw, name, ranks, **mesh):
    raw = json.loads(json.dumps(raw))
    raw["eval_config"]["eval_base_path"] = str(tmp_path / name)
    raw["mesh_config"] = {"data_parallel": -1, **mesh}
    cfg = tmp_path / f"{name}.json"
    cfg.write_text(json.dumps(raw))
    # one thread a process on both sides: the GEMMs of a random model's
    # RPN then round alike, and near-tied objectness scores pick the same
    # proposals in both runs
    env = {"LAYOUTDIT_CONFIG": str(cfg), "OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        argv = ["--device", "cpu"]
        if ranks > 1:
            spawn_ranks(argv, ranks)
        else:
            main(argv)
    finally:
        torch.set_num_threads(threads)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    run = tmp_path / name / raw["run_name"]
    state = load_checkpoint(str(run / "model_checkpoints" / "epoch_1.pt"), "cpu")
    with open(run / "metrics" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    with open(run / "predictions.json") as f:
        preds = json.load(f)
    return state, recs, preds


@pytest.mark.parametrize("fsdp", [False, True])
def test_main_two_ranks_matches_one_process(fixture_cfg, tmp_path, fsdp):
    """``main`` over two gloo ranks started by its launcher, one step and
    the final eval: rank 0's checkpoint (gathered under FSDP) and the
    epoch's loss are one process's on the same global batch; the DP eval
    scored the same pages. One step: the ranks' sums differ from one
    process's in the last bits, and a second step of this random 224 px
    model can turn such bits into other proposals (near-tied scores)."""
    _, raw = fixture_cfg
    one, one_recs, one_preds = _run_main(tmp_path, raw, "one", 1)
    two, two_recs, two_preds = _run_main(tmp_path, raw, "two", 2, fsdp=fsdp)
    # the first moment is the gradient: to DP_RTOL a leaf; Adam's first
    # update is about lr * sign(g), so where g is rounding noise around 0
    # a parameter may move the other way: within 2 lr
    for a, b in zip(two["opt_state"]["mu"], one["opt_state"]["mu"], strict=True):
        assert a.shape == b.shape
        assert float((a - b).norm()) <= DP_RTOL * float(b.norm()) + 1e-12
    lr = raw["train_config"].get("learning_rate", 1e-4)
    for a, b in zip(tree_leaves(two["params"]), tree_leaves(one["params"]), strict=True):
        assert float((a - b).abs().max()) <= 2 * lr * (1 + 1e-3)
    assert two["extra"]["updates"] == one["extra"]["updates"] == 1
    assert len(two_recs) == len(one_recs) == 1
    assert two_recs[0]["loss"] == pytest.approx(one_recs[0]["loss"], rel=DP_RTOL)
    assert {p["image_id"] for p in two_preds} == {p["image_id"] for p in one_preds}
