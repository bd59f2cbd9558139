"""FSDP over a tensor-parallel mesh (``parallel/sharding.py``'s
``fsdp_dim`` with the leaf's model-axis dim, ``FsdpLayout`` over a
``TpLayout``), on the CPU:

  * the shard dim of every leaf of the tiny detector on a dp x mp mesh
    equals JAX's ``_fsdp_spec`` (``tests/test_fsdp.py:102``): the data axis
    on the largest dim the model axis leaves unsharded;
  * a 2 x 2 ``Trainer`` (two data ranks, each a model group of two, the
    TP shards sharded again over the data group) takes two updates with
    clipping, skipping and EMA equal to one process's (``DP_RTOL``-style:
    the moments and EMA 1e-4, the parameters within 2 lr a step), and
    holds less at rest than TP alone; its checkpoint is the one-card file.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from layoutdit_tpu.config.constructs import MeshConfig as JaxMesh
from layoutdit_tpu.parallel import sharding as jax_sharding
from layoutdit_tpu.parallel.mesh import build_mesh
from layoutdit_tpu_torch.models.weights_io import tree_leaves
from layoutdit_tpu_torch.parallel import sharding as psharding
from layoutdit_tpu_torch.train import trainer as port_trainer
from test_torch_parallel import _rc, _rel, small_fsdp_threshold  # noqa: F401 (fixture)
from test_torch_pipeline import run_mesh3
from test_torch_tensor_parallel import _full_state, _model, _rcnn_family
from test_torch_train import fixture_dir  # noqa: F401 (fixture)

LR = 1e-3


def _axis_dim(spec, axis: str):
    return next((i for i, a in enumerate(spec) if a == axis), None)


@pytest.mark.parametrize("dp,mp", [(2, 2), (4, 2)])
def test_shard_dims_follow_jax_fsdp_spec(monkeypatch, small_fsdp_threshold, dp,  # noqa: F811
                                          mp):
    """Every leaf of JAX's tiny detector on a dp x mp mesh: ``fsdp_dim`` of
    its shape, skipping the dim JAX's TP spec shards, is the dim JAX's
    ``detector_param_specs(fsdp=True)`` puts the data axis on (both
    thresholds at the fixture's, so the tiny leaves shard)."""
    monkeypatch.setattr(jax_sharding, "_FSDP_MIN_ELEMENTS", psharding.FSDP_MIN_ELEMENTS)
    jparams, _, _ = _rcnn_family()
    mesh = build_mesh(JaxMesh(data_parallel=dp, model_parallel=mp),
                      devices=jax.devices()[:dp * mp], strict=True)
    tp_specs = jax_sharding.detector_param_specs(jparams, mesh, fsdp=False)
    fsdp_specs = jax_sharding.detector_param_specs(jparams, mesh, fsdp=True)
    leaves = jax.tree_util.tree_leaves(jparams)
    is_spec = lambda x: isinstance(x, P)  # noqa: E731
    tp = jax.tree_util.tree_leaves(tp_specs, is_leaf=is_spec)
    full = jax.tree_util.tree_leaves(fsdp_specs, is_leaf=is_spec)
    assert len(leaves) == len(tp) == len(full)
    both = 0
    for leaf, t, f in zip(leaves, tp, full):
        tp_dim = _axis_dim(t, "model")
        got = psharding.fsdp_dim(tuple(leaf.shape), dp, tp_dim)
        assert got == _axis_dim(f, "data"), (leaf.shape, t, f)
        both += got is not None and tp_dim is not None
    assert both > 0  # leaves sharded over both axes


def _steps(rc, mesh, n=2):
    trainer = port_trainer.Trainer(rc, _model(rc), device="cpu", mesh=mesh)
    losses, rest = [], None
    with trainer.sharded():
        if trainer._rest is not None:
            rest = sum(t.numel() for t in [*trainer._rest, *trainer.opt_state["mu"],
                                           *trainer.opt_state["nu"]])
        for _, batch in zip(range(n), trainer.dataloader):
            loss, _ = trainer.train_step(batch)
            if mesh is not None and mesh.degree > 1:
                loss = mesh.comm.all_reduce_(loss.clone()) / mesh.degree
            losses.append(float(loss))
        state = _full_state(trainer)
    tp_rest = sum(t.numel() for t in [*trainer._leaves, *trainer.opt_state["mu"],
                                      *trainer.opt_state["nu"]])
    trainer.dataloader.close()
    return losses, state, rest, tp_rest, trainer


def test_trainer_fsdp_x_tp_equals_one_process(fixture_dir, tmp_path,  # noqa: F811
                                              small_fsdp_threshold):  # noqa: F811
    rc = _rc(fixture_dir, tmp_path, grad_clip_norm=0.05, ema_decay=0.9,
             skip_nonfinite_updates=2, learning_rate=LR)
    one_losses, one_state, _, _, one = _steps(rc, None)
    n_params = len(tree_leaves(one.params))

    def rank(mesh):
        mesh = dataclasses.replace(mesh, fsdp=True)
        losses, state, rest, tp_rest, trainer = _steps(rc, mesh)
        dims, specs = trainer._layout.dims, trainer.tp_layout.specs
        assert any(d is not None and s is not None for d, s in zip(dims, specs))
        path = trainer.save_checkpoint(1, stem="fsdp_tp")
        return losses, state, rest, tp_rest, path

    got = run_mesh3(rank, 2, 2, 1)
    for losses, state, rest, tp_rest, _ in got:
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        assert rest < tp_rest
        for i, (a, b) in enumerate(zip(state, one_state, strict=True)):
            assert a.shape == b.shape, i
            if i < n_params:
                assert float((a - b).abs().max()) <= 2 * LR * 2 * (1 + 1e-3), i
            else:
                assert _rel(a.float(), b.float()) <= 1e-4 or float(b.abs().max()) < 1e-12, i
    # rank 0 wrote the one-card file: one process resumes it to the bits
    one2 = port_trainer.Trainer(rc, _model(rc, seed=3), device="cpu")
    one2.resume(got[0][4])
    assert all(torch.equal(a, b) for a, b in zip(_full_state(one2), got[0][1], strict=True))
    one2.dataloader.close()
