"""The port's hybrid DCN mesh (``parallel/mesh.py``: ``rank_layout``,
``build_mesh_for_batch`` with ``dcn_data_parallel``) against JAX's
(``tests/test_hybrid_mesh.py``), case by case: under the same granule
function (JAX's device id is the port's rank), the port puts each rank at
the (data, model, pipe) coordinate of JAX's device, and raises JAX's
validation errors under the same conditions. Then a 2-granule dp x mp
trainer step, its ranks threads, equals the flat mesh's bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax

from layoutdit_tpu.config.constructs import MeshConfig as JaxMesh
from layoutdit_tpu.parallel.mesh import build_mesh, build_mesh_for_batch
from layoutdit_tpu_torch.config import MeshConfig, load_run_config
from layoutdit_tpu_torch.parallel import mesh as pmesh
from test_torch_parallel import _rc
from test_torch_pipeline import run_mesh3
from test_torch_tensor_parallel import _full_state, _model
from test_torch_train import fixture_dir  # noqa: F401 (fixture)


def _two_granules(d):
    # devices (ranks) 0-3 = granule 0, 4-7 = granule 1
    return getattr(d, "id", d) // 4


class World:
    """A comm of ``world`` ranks, this one ``rank``, that no collective reaches."""

    def __init__(self, world, rank=0):
        self.world, self.rank = world, rank


@pytest.fixture
def no_groups(monkeypatch):
    """``build_mesh_for_batch`` without process groups: each axis's group a
    ``World`` of its size."""
    def groups(layout, comm):
        dp, mp, pp = layout.shape
        return {"data": World(dp), "model": World(mp), "pipe": World(pp)}

    monkeypatch.setattr(pmesh, "mesh_groups", groups)


def _coords(cfg: MeshConfig, world: int, batch: int, granule_fn=_two_granules) -> np.ndarray:
    """The rank at each coordinate of the port's mesh, built rank by rank."""
    out = None
    for rank in range(world):
        m = pmesh.build_mesh_for_batch(cfg, batch, comm=World(world, rank),
                                       granule_fn=granule_fn)
        mp = m.model.size if m.model is not None else 1
        pp = m.pipe.size if m.pipe is not None else 1
        if out is None:
            out = np.full((m.degree, mp, pp), -1)
        out[m.rank, m.model.rank if m.model else 0, m.pipe.rank if m.pipe else 0] = rank
    assert (out >= 0).all()
    return out


def _ids(mesh) -> np.ndarray:
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    return ids if ids.ndim == 3 else ids[..., None]


@pytest.mark.parametrize("dp,mp,pp", [(4, 2, 1), (2, 2, 2)])
def test_layout_equals_jax_device_array(no_groups, dp, mp, pp):
    """``test_hybrid_granule_outermost_on_data_axis`` and
    ``test_hybrid_with_pipeline_axis``: the granule outermost on the data
    axis, every model and pipe group inside one granule."""
    kw = dict(data_parallel=dp, model_parallel=mp, pipeline_parallel=pp, dcn_data_parallel=2)
    want = _ids(build_mesh(JaxMesh(**kw), granule_fn=_two_granules))
    got = _coords(MeshConfig(**kw), 8, 8)
    np.testing.assert_array_equal(got, want)
    assert set(got[:dp // 2].ravel()) == {0, 1, 2, 3}
    assert set(got[dp // 2:].ravel()) == {4, 5, 6, 7}


def test_interleaved_granules_follow_jax(no_groups):
    """Granules that are not blocks of ranks (even and odd ranks): the
    port's layout is still JAX's device array."""
    def fn(d):
        return getattr(d, "id", d) % 2

    kw = dict(data_parallel=4, model_parallel=2, dcn_data_parallel=2)
    want = _ids(build_mesh(JaxMesh(**kw), granule_fn=fn))
    np.testing.assert_array_equal(_coords(MeshConfig(**kw), 8, 8, fn), want)


@pytest.mark.parametrize("case", ["divide", "granules", "uniform", "no_degree",
                                  "granule_mismatch"])
def test_validation_errors_match_jax(no_groups, case):
    """``test_hybrid_validation``, the no-degree case of
    ``test_hybrid_build_mesh_for_batch_clamps_in_granules`` and
    ``test_build_mesh_for_batch_granule_mismatch_raises``: the same
    conditions raise in both packages, with JAX's words."""
    kw, n, batch, match = {
        "divide": (dict(data_parallel=3, dcn_data_parallel=2), 3, 6, "must divide"),
        "granules": (dict(data_parallel=4, model_parallel=2, dcn_data_parallel=4), 8, 8,
                     "granules"),
        "uniform": (dict(data_parallel=6, dcn_data_parallel=2), 6, 6, "per granule"),
        "no_degree": (dict(data_parallel=-1, dcn_data_parallel=2), 8, 5,
                      "no data-parallel degree"),
        "granule_mismatch": (dict(data_parallel=4, dcn_data_parallel=4), 4, 4, "granules"),
    }[case]
    with pytest.raises(ValueError, match=match):
        if case in ("no_degree", "granule_mismatch"):
            build_mesh_for_batch(JaxMesh(**kw), batch_size=batch, granule_fn=_two_granules)
        else:
            build_mesh(JaxMesh(**kw), devices=jax.devices()[:n], granule_fn=_two_granules)
    with pytest.raises(ValueError, match=match):
        pmesh.build_mesh_for_batch(MeshConfig(**kw), batch, comm=World(n),
                                   granule_fn=_two_granules)


def test_clamp_goes_in_whole_granules(no_groups):
    """Batch 6 over two granules: the data degree is a multiple of the
    granule count dividing 6, here 6. JAX then takes 3 devices of each
    granule; the port starts exactly the ranks its mesh uses, so 8 ranks
    raise and 6 (3 a granule) give JAX's layout, device ids 0-2 and 4-6
    being ranks 0-5."""
    cfg = dict(data_parallel=-1, dcn_data_parallel=2)
    jmesh = build_mesh_for_batch(JaxMesh(**cfg), batch_size=6, granule_fn=_two_granules)
    want = _ids(jmesh)
    assert want.shape[0] == 6
    with pytest.raises(ValueError, match="needs 6 processes, but 8"):
        pmesh.build_mesh_for_batch(MeshConfig(**cfg), 6, comm=World(8),
                                   granule_fn=_two_granules)
    got = _coords(MeshConfig(**cfg), 6, 6, lambda r: r // 3)
    np.testing.assert_array_equal(np.where(got >= 3, got + 1, got), want)


def test_flat_layout_and_pipe_innermost(no_groups):
    """Without granules rank = (d mp + m) pp + p, as JAX reshapes its
    devices to (dp, mp, pp)."""
    kw = dict(data_parallel=2, model_parallel=2, pipeline_parallel=2)
    want = _ids(build_mesh(JaxMesh(**kw)))
    np.testing.assert_array_equal(_coords(MeshConfig(**kw), 8, 8), want)
    np.testing.assert_array_equal(want, np.arange(8).reshape(2, 2, 2))


def test_multislice_config_loads():
    """``configs/train_multislice.json`` loads, its 64 ranks laid out as
    JAX would lay out two hosts of 32."""
    rc = load_run_config("configs/train_multislice.json")
    mc = rc.mesh
    assert (mc.data_parallel, mc.model_parallel, mc.dcn_data_parallel) == (16, 4, 2)
    assert mc.enable_distributed_init
    layout = pmesh.rank_layout(64, 16, 4, 1, 2, [r // 32 for r in range(64)])
    assert set(layout[:8].ravel()) == set(range(32))
    assert all(len({r // 32 for r in layout[d].ravel()}) == 1 for d in range(16))


def test_two_granule_step_equals_flat(fixture_dir, tmp_path):  # noqa: F811
    """A dp 2 x mp 2 trainer step on the hybrid layout of two interleaved
    granules (ranks 0, 2 and 1, 3) equals the flat layout's, bit for bit:
    the layout moves ranks, never values."""
    import dataclasses

    rc = _rc(fixture_dir, tmp_path, grad_clip_norm=0.05, ema_decay=0.9)
    rc = dataclasses.replace(rc, mesh=MeshConfig())

    def steps(mesh):
        from layoutdit_tpu_torch.train import trainer as port_trainer

        trainer = port_trainer.Trainer(rc, _model(rc), device="cpu", mesh=mesh)
        for _, batch in zip(range(2), trainer.dataloader):
            trainer.train_step(batch)
        trainer.dataloader.close()
        return mesh.rank, mesh.model.rank, _full_state(trainer)

    hybrid = pmesh.rank_layout(4, 2, 2, 1, 2, [r % 2 for r in range(4)])
    assert hybrid[:, :, 0].tolist() == [[0, 2], [1, 3]]
    flat = run_mesh3(steps, 2, 2, 1)
    hyb = run_mesh3(steps, 2, 2, 1, layout=hybrid)
    by_coord = {(d, m): state for d, m, state in flat}
    for d, m, state in hyb:
        assert all(a.equal(b) for a, b in zip(state, by_coord[d, m], strict=True))
