"""The pipelined detector and trainer of the port (``parallel/pipeline.py``
through ``detector_loss`` and ``train/trainer.py``) on the CPU, the ranks
threads over ``RingComm`` groups (``test_torch_pipeline.run_mesh3``):

  * dp 2 x pp 2 Faster R-CNN ``detector_loss`` against JAX's jitted on its
    4-device CPU mesh (``tests/test_pipeline.py:141``): the losses
    ``JAX_LOSS_RTOL``, every gradient leaf ``GRAD_RTOL``;
  * ``Trainer`` steps on dp x mp x pp and fsdp x pp meshes against one
    process (``DP_RTOL``-style: the moments and EMA 1e-4, the parameters
    within 2 lr a step);
  * JAX's guards and errors with its messages;
  * ``configs/train_pipeline.json`` in both packages.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu_torch.config import MeshConfig, load_run_config
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
    tree_paths,
)
from layoutdit_tpu_torch.parallel import mesh as pmesh
from layoutdit_tpu_torch.parallel import pipeline as ppipe
from layoutdit_tpu_torch.parallel import sharding as psharding
from test_torch_cascade import _jax_priorities
from test_torch_parallel import _batch, _rc, _rel, small_fsdp_threshold  # noqa: F401
from test_torch_pipeline import run_mesh3
from test_torch_tensor_parallel import (
    GRAD_RTOL,
    JAX_LOSS_RTOL,
    _full_state,
    _model,
    _rcnn_family,
)
from test_torch_train import fixture_dir  # noqa: F401 (fixture)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
LR = 1e-3


def _pp_step(jparams, pcfg, batch, priorities, mesh, microbatches=2):
    """The port's losses and gradients on a dp x pp mesh: this data
    index's rows, the encoder's stages over the pipe group, the gradients
    reduced over it and averaged over the data group -> (losses, leaves)."""
    params = params_from_jax(jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    k = batch[0].shape[0] // mesh.degree
    rows = slice(mesh.rank * k, (mesh.rank + 1) * k)
    xs = [torch.from_numpy(np.array(x[rows])) for x in batch]
    pri = port_det.SamplerPriorities(*(p[rows] for p in priorities))
    pipe = ppipe.PipelineConfig(mesh.pipe, microbatches)
    with pmesh.losses_over(mesh):
        losses = port_det.detector_loss(params, *xs, pcfg, pri, pipeline=pipe)
    sum(losses.values()).backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in tree_leaves(params)]
    ppipe.reduce_pipe_grads(grads, tree_paths(params), pipe)
    psharding.all_reduce_(grads, mesh.comm)
    torch._foreach_div_(grads, float(mesh.degree))
    out = {}
    for name, v in losses.items():
        out[name] = float(mesh.comm.all_reduce_(v.detach().clone()) / mesh.degree)
    return out, grads


def _jax_pp_step(jparams, jcfg, batch, rng):
    """JAX's losses and gradients with a dp 2 x pp 2 pipeline on 4 CPU
    devices (``tests/test_pipeline.py:141``)."""
    from layoutdit_tpu.config.constructs import MeshConfig as JaxMesh
    from layoutdit_tpu.parallel.mesh import build_mesh, pipeline_config

    mcfg = JaxMesh(data_parallel=2, model_parallel=1, pipeline_parallel=2,
                   pipeline_microbatches=2)
    mesh = build_mesh(mcfg, devices=jax.devices()[:4])
    assert mesh.shape == {"data": 2, "model": 1, "pipe": 2}
    pipe = pipeline_config(mesh, mcfg)

    def total(p):
        d = jax_det.detector_loss(p, rng, *batch, jcfg, pipeline=pipe)
        return sum(d.values()), d

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, grads)))


def test_dp2_pp2_detector_loss_matches_jax():
    jparams, jcfg, pcfg = _rcnn_family()
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    pri = _jax_priorities(rng, pcfg, *batch[2].shape)
    got = run_mesh3(lambda m: _pp_step(jparams, pcfg, batch, pri, m), dp=2, pp=2)
    want, jgrads = _jax_pp_step(jparams, jcfg, batch, rng)
    for losses, grads in got:
        assert set(losses) == set(want)
        for k in want:
            np.testing.assert_allclose(losses[k], want[k], rtol=JAX_LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        it = iter(grads)
        flat = jax.tree_util.tree_leaves(params_to_jax(tree_map(
            lambda _: next(it), params_from_jax(jparams))))
        assert len(flat) == len(jgrads)
        for g, w in zip(flat, jgrads):
            assert _rel(g, w) <= GRAD_RTOL, _rel(g, w)
    # every rank of the mesh holds the same reduced gradients
    assert all(torch.equal(a, b) for r in got[1:] for a, b in zip(r[1], got[0][1]))


# --------------------------------------------------------------- trainer


def _steps(rc, mesh, n=2):
    from layoutdit_tpu_torch.train import trainer as port_trainer

    trainer = port_trainer.Trainer(rc, _model(rc), device="cpu", mesh=mesh)
    losses = []
    with trainer.sharded():
        for _, batch in zip(range(n), trainer.dataloader):
            loss, _ = trainer.train_step(batch)
            if mesh is not None and mesh.degree > 1:
                loss = mesh.comm.all_reduce_(loss.clone()) / mesh.degree
            losses.append(float(loss))
        state = _full_state(trainer)
    trainer.dataloader.close()
    return losses, state, trainer


def _assert_steps_match(got, one_losses, one_state, n_params, steps=2):
    for losses, state in got:
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        for i, (a, b) in enumerate(zip(state, one_state, strict=True)):
            assert a.shape == b.shape, i
            if i < n_params:
                assert float((a - b).abs().max()) <= 2 * LR * steps * (1 + 1e-3), i
            else:
                assert _rel(a.float(), b.float()) <= 1e-4 or float(b.abs().max()) < 1e-12, i


def _pipeline_rc(fixture_dir, tmp_path, **train):  # noqa: F811
    rc = _rc(fixture_dir, tmp_path, grad_clip_norm=0.05, ema_decay=0.9,
             skip_nonfinite_updates=2, learning_rate=LR, **train)
    return dataclasses.replace(rc, mesh=MeshConfig(pipeline_microbatches=2))


@pytest.mark.parametrize("dp,mp,pp", [(2, 1, 2), (1, 2, 2), (2, 2, 2)])
def test_trainer_pipeline_equals_one_process(fixture_dir, tmp_path, dp, mp, pp):  # noqa: F811
    """Two updates (clipping, skipping, EMA) on a dp x mp x pp mesh: the
    encoder's two layers as two stages, whole on each model rank, the box
    head tensor-parallel, against one process."""
    rc = _pipeline_rc(fixture_dir, tmp_path)
    one_losses, one_state, one = _steps(rc, None)
    got = run_mesh3(lambda m: _steps(rc, m)[:2], dp, mp, pp)
    _assert_steps_match(got, one_losses, one_state, len(tree_leaves(one.params)))


def test_trainer_fsdp_x_pipeline_equals_one_process(fixture_dir, tmp_path,  # noqa: F811
                                                     small_fsdp_threshold):  # noqa: F811
    """FSDP over each (model, pipe) coordinate's data group with two stages:
    the state at rest is sharded, and two updates match one process."""
    rc = _pipeline_rc(fixture_dir, tmp_path)
    one_losses, one_state, one = _steps(rc, None)

    def rank(mesh):
        mesh = dataclasses.replace(mesh, fsdp=True)
        losses, state, trainer = _steps(rc, mesh)
        assert any(d is not None for d in trainer._layout.dims)
        return losses, state

    got = run_mesh3(rank, dp=2, pp=2)
    _assert_steps_match(got, one_losses, one_state, len(tree_leaves(one.params)))


# ---------------------------------------------------------------- guards


def _tiny(**kw):
    cfg = port_vit.ViTConfig(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
                             intermediate_size=48, patch_size=4, image_size=16, **kw)
    params = port_vit.init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


@pytest.mark.parametrize("case,match", [
    ("sp", "pipeline and seq_sharding are mutually exclusive"),
    ("windows", "windowed attention layers are heterogeneous"),
    ("moe", "does not support MoE layers"),
    ("layers", "num layers 4 not divisible by 3 stages"),
    ("batch", "not divisible by 4 microbatches"),
])
def test_jax_guards(case, match):
    """JAX's refusals (``vit.py:736-767``, ``pipeline.py:110-118``), its
    messages; raised before any rank sends."""
    kw = {"windows": dict(window_size=2), "moe": dict(num_experts=2)}.get(case, {})
    cfg, params = _tiny(**kw)
    stages = 3 if case == "layers" else 2
    microbatches = 4 if case == "batch" else 1

    class Solo:  # a comm no rank reaches: every guard raises first
        world, rank = stages, 0

    pipe = ppipe.PipelineConfig(pmesh.PipeGroup(stages, 0, Solo()), microbatches)
    tp = pmesh.ModelGroup(2, 0, Solo(), sequence_parallel=True) if case == "sp" else None
    with pytest.raises(ValueError, match=match):
        port_vit.vit_forward(params, torch.zeros(2, 3, 16, 16), cfg, pipeline=pipe, tp=tp)


def test_pad_tokens_to_is_off_under_a_pipeline():
    """``pad_tokens_to`` pads nothing in a pipelined encoder: the taps keep
    the real tokens, equal to the unpadded encoder's."""
    cfg, params = _tiny(pad_tokens_to=24)
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    want = port_vit.vit_forward(params, x, dataclasses.replace(cfg, pad_tokens_to=0),
                                taps=(2, 4))
    got = run_mesh3(lambda m: port_vit.vit_forward(
        params, x, cfg, taps=(2, 4), pipeline=ppipe.PipelineConfig(m.pipe, 2)), pp=2)
    for outs in got:
        for g, w in zip(outs, want):
            assert g.shape == w.shape == (2, 17, 32)
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_bubble():
    assert ppipe.bubble(2, 2) == pytest.approx(1 / 3)
    assert ppipe.bubble(4, 4) == pytest.approx(3 / 7)
    assert ppipe.bubble(1, 8) == 0.0


# ---------------------------------------------------------------- config


def test_train_pipeline_config_loads_in_both_packages():
    """``configs/train_pipeline.json``: JAX's ``build_mesh`` on 4 CPU devices
    gives {data 2, model 1, pipe 2}; the port's rank layout at world 4 puts
    each rank at the coordinate of JAX's device of the same index."""
    from layoutdit_tpu.config.constructs import LayoutDitConfig
    from layoutdit_tpu.parallel.mesh import build_mesh

    path = CONFIGS / "train_pipeline.json"
    raw = json.loads(path.read_text())
    jcfg = LayoutDitConfig(**raw)
    mesh = build_mesh(jcfg.mesh_config, devices=jax.devices()[:4], strict=True)
    assert dict(mesh.shape) == {"data": 2, "model": 1, "pipe": 2}
    rc = load_run_config(str(path))
    mc = rc.mesh
    assert (mc.pipeline_parallel, mc.pipeline_microbatches, mc.data_parallel) == (2, 2, -1)
    assert rc.model.backbone_type == "dit-large" and rc.model.image_size == 1024
    layout = pmesh.rank_layout(4, 2, max(1, mc.model_parallel), mc.pipeline_parallel)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    np.testing.assert_array_equal(layout, ids)
