"""GPipe pipeline stages of the port's encoder (``parallel/pipeline.py``,
``models/vit.py``'s ``pipeline``) on the CPU, the stages threads over
``RingComm`` groups (``test_torch_tensor_parallel``): the pipelined
encoder's taps and gradients against JAX's ``vit_forward(...,
pipeline=PipelineConfig(...))`` on the same weights on the CPU mesh, for
M in {1, 2, 4} microbatches over S in {2, 4} stages, with and without
remat, with a shared and a per-layer relative-position table, at JAX's own
tolerances (``tests/test_pipeline.py``: taps atol 1e-5, gradients atol
2e-4 / rtol 1e-4). ``run_mesh3`` runs any data x model x pipe mesh as
threads (``test_torch_pipeline_train.py``, ``test_torch_hybrid_mesh.py``).
"""

from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.parallel import pipeline as jax_pipeline
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models import weights_io
from layoutdit_tpu_torch.parallel import mesh as pmesh
from layoutdit_tpu_torch.parallel import pipeline as ppipe
from test_torch_parallel import _Hub
from test_torch_tensor_parallel import RingComm

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# JAX's own (tests/test_pipeline.py)
TAP_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL_ELEM = 2e-4, 1e-4

VIT = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=2, intermediate_size=48,
           patch_size=4, image_size=16)
TABLES = {"none": {},
          "shared": dict(use_shared_relative_position_bias=True,
                         use_absolute_position_embeddings=False),
          "layer": dict(use_relative_position_bias=True, use_absolute_position_embeddings=False)}


def run_mesh3(fn, dp: int = 1, mp: int = 1, pp: int = 2, layout=None) -> list:
    """``fn(mesh)`` on dp x mp x pp threads, rank (d mp + m) pp + p at
    (d, m, p) or as ``layout`` [dp, mp, pp] places them, each with a
    ``DataMesh`` whose pipe (pp > 1), model (mp > 1) and data groups and
    world are ``RingComm`` groups -> the results in rank order."""
    world = dp * mp * pp
    layout = np.arange(world).reshape(dp, mp, pp) if layout is None else layout
    hubs = {"world": _Hub(world)}
    for d in range(dp):
        for m in range(mp):
            hubs["pipe", d, m] = _Hub(pp)
        for p in range(pp):
            hubs["model", d, p] = _Hub(mp)
    for m in range(mp):
        for p in range(pp):
            hubs["data", m, p] = _Hub(dp)
    out, errors = [None] * world, []

    def body(rank):
        d, m, p = (int(i[0]) for i in np.nonzero(layout == rank))
        mesh = pmesh.DataMesh(
            degree=dp, rank=d, comm=RingComm(hubs["data", m, p], d),
            model=pmesh.ModelGroup(mp, m, RingComm(hubs["model", d, p], m)) if mp > 1 else None,
            pipe=pmesh.PipeGroup(pp, p, RingComm(hubs["pipe", d, m], p)) if pp > 1 else None,
            world=RingComm(hubs["world"], rank))
        try:
            out[rank] = fn(mesh)
        except BaseException as e:  # surfaced below
            errors.append(e)
            for h in hubs.values():
                h.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _jax_vit_params(cfg, seed: int):
    """JAX's init with the zero-initialised embeddings and tables drawn."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_vit.init_vit_params(jax.random.PRNGKey(seed), cfg))
    draw = lambda a, s: (s * rng.standard_normal(a.shape)).astype(np.float32)  # noqa: E731
    params["cls_token"] = draw(params["cls_token"], 0.02)
    for name, s in (("pos_embed", 0.02), ("shared_rel_pos_table", 0.5)):
        if name in params:
            params[name] = draw(params[name], s)
    for layer in params["layers"]:
        if "rel_pos_table" in layer:
            layer["rel_pos_table"] = draw(layer["rel_pos_table"], 0.5)
    return params


def _jax_pipelined(jparams, cfg, pixels, taps, cots, stages, microbatches, remat):
    """JAX's pipelined encoder on a 1 x S CPU mesh -> (taps, gradients)."""
    mesh = Mesh(np.asarray(jax.devices()[:stages]).reshape(1, stages), ("data", "pipe"))
    pcfg = jax_pipeline.PipelineConfig(mesh=mesh, n_microbatches=microbatches, remat=remat)

    def total(p):
        outs = jax_vit.vit_forward(p, jnp.asarray(pixels), cfg, taps=taps, pipeline=pcfg)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)
    return [np.asarray(o) for o in outs], jax.tree_util.tree_map(np.asarray, grads)


def _port_pipelined(jparams, cfg, pixels, taps, cots, stages, microbatches, remat):
    """The port's pipelined encoder on S thread stages -> (taps, the
    gradients summed over the stages as the trainer does, JAX layout)."""

    def rank(mesh):
        params = weights_io.vit_params_from_jax(jparams)
        leaves = weights_io.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        pcfg = ppipe.PipelineConfig(mesh.pipe, microbatches, remat)
        outs = port_vit.vit_forward(params, torch.from_numpy(pixels), cfg, taps=taps,
                                    pipeline=pcfg)
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
        ppipe.reduce_pipe_grads(grads, [f"vit/{p}" for p in weights_io.tree_paths(params)],
                                pcfg)
        it = iter(grads)
        return ([o.detach().numpy() for o in outs],
                weights_io.vit_params_to_jax(weights_io.tree_map(lambda _: next(it), params)))

    return run_mesh3(rank, pp=stages)


@pytest.mark.parametrize("stages,microbatches,remat", [
    (2, 1, False), (2, 2, True), (2, 4, False), (4, 1, True), (4, 2, False), (4, 4, False)])
def test_pipelined_encoder_matches_jax(stages, microbatches, remat):
    _check_encoder("none", stages, microbatches, remat)


@pytest.mark.parametrize("tables", ["shared", "layer"])
def test_pipelined_encoder_with_rel_pos_matches_jax(tables):
    _check_encoder(tables, 2, 2, False)


def _check_encoder(tables, stages, microbatches, remat):
    cfg_kw = dict(VIT, **TABLES[tables])
    jcfg, pcfg = jax_vit.ViTConfig(**cfg_kw), port_vit.ViTConfig(**cfg_kw)
    jparams = _jax_vit_params(jcfg, seed=stages + microbatches)
    rng = np.random.default_rng(7)
    pixels = rng.normal(size=(8, 3, 16, 16)).astype(np.float32)
    taps = (0, 1, 2, 3, 4)
    cots = [rng.standard_normal((8, 17, 32)).astype(np.float32) for _ in taps]
    want, jgrads = _jax_pipelined(jparams, jcfg, pixels, taps, cots, stages, microbatches,
                                  remat)
    results = _port_pipelined(jparams, pcfg, pixels, taps, cots, stages, microbatches, remat)
    flat_j = jax.tree_util.tree_leaves(jgrads)
    for outs, grads in results:  # every stage holds every tap and the same gradients
        for w, g in zip(want, outs):
            np.testing.assert_allclose(g, w, atol=TAP_ATOL)
        flat_p = jax.tree_util.tree_leaves(grads)
        assert len(flat_p) == len(flat_j)
        for w, g in zip(flat_j, flat_p):
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL_ELEM)
